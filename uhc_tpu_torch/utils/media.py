"""Frame and video utilities for the video pipelines (the port's own copy
of uhc_tpu.utils.media: host numpy, no torch).

Overlapped-window chunking for sliding-window video nets
(`get_chunk_with_overlap`: stitching every chunk's select range reproduces
the frame sequence exactly once), center / side crops, resizing (cv2's
cubic when OpenCV is present, else nearest-neighbor numpy) and cv2 video
IO, which raises a clear ImportError without OpenCV.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def get_chunk_with_overlap(num_frames: int, window_size: int = 80,
                           overlap: int = 10, return_idxes: bool = False):
    """Overlapped sliding windows + stitch selects.

    Returns (chunks, selects): `chunks[i]` indexes the frames of window i
    (or its [start, stop) boundary when return_idxes), and
    `selects[i] = (a, b)` slices each window's OUTPUT so that
    `concat(out[i][a:b])` covers every frame exactly once. The last
    window is right-aligned to the sequence end like the reference's
    chunk_supp row.
    """
    assert overlap % 2 == 0
    if num_frames <= window_size:
        idx = np.arange(num_frames)
        return [idx], [(0, num_frames)]
    step = window_size - overlap
    half = overlap // 2
    starts = list(range(0, num_frames - window_size + 1, step))
    if starts[-1] != num_frames - window_size:
        starts.append(num_frames - window_size)  # right-aligned tail
    chunks = [np.arange(s, s + window_size) for s in starts]
    # stitch ranges: first keeps its head, middles trim overlap/2 both
    # sides, the tail keeps exactly the frames nobody else covered.
    selects: List[Tuple[int, int]] = []
    for i, s in enumerate(starts):
        if i == 0:
            selects.append((0, window_size - half))
        elif i == len(starts) - 1:
            covered_end = starts[i - 1] + window_size - half
            selects.append((-(num_frames - covered_end), window_size))
        else:
            selects.append((half, window_size - half))
    if return_idxes:
        bounds = np.array([[s, s + window_size] for s in starts])
        return bounds, selects
    return chunks, selects


def crop_center(img: np.ndarray, cropx: int, cropy: int) -> np.ndarray:
    """Center crop (image_utils.py:76)."""
    y, x = img.shape[:2]
    sx = max((x - cropx) // 2, 0)
    sy = max((y - cropy) // 2, 0)
    return img[sy:sy + cropy, sx:sx + cropx]


def crop_side(img: np.ndarray, cropx: int, cropy: int) -> np.ndarray:
    """Fixed-offset side crop (image_utils.py:83 uses x/6, y/7)."""
    y, x = img.shape[:2]
    sx = x // 6
    sy = y // 7
    return img[sy:sy + cropy, sx:sx + cropx]


def resize_frames(frames: Sequence[np.ndarray], size_x: int = 224,
                  size_y: int = 224) -> List[np.ndarray]:
    """Resize with cv2 when present, else nearest-neighbor numpy
    (image_utils.py:131)."""
    try:
        import cv2
        return [cv2.resize(f, (size_x, size_y),
                           interpolation=cv2.INTER_CUBIC) for f in frames]
    except ImportError:
        out = []
        for f in frames:
            yi = (np.arange(size_y) * f.shape[0] / size_y).astype(int)
            xi = (np.arange(size_x) * f.shape[1] / size_x).astype(int)
            out.append(f[yi][:, xi])
        return out


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        raise ImportError("OpenCV is required for video IO "
                          "(uhc_tpu_torch.utils.media read/write helpers)")


def read_video_frames(vid_path: str) -> List[np.ndarray]:
    """Decode a video file to a list of BGR frames (image_utils.py:88)."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(vid_path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def read_img_dir(img_dir: str) -> List[np.ndarray]:
    """Read every image in a directory, sorted (image_utils.py:121)."""
    cv2 = _require_cv2()
    names = sorted(os.listdir(img_dir))
    return [cv2.imread(os.path.join(img_dir, n)) for n in names
            if n.lower().endswith((".png", ".jpg", ".jpeg"))]


def write_frames_to_video(frames: Sequence[np.ndarray],
                          out_file_name: str = "output.mp4",
                          frame_rate: int = 30, add_text: str = None,
                          text_color=(255, 255, 255)) -> None:
    """Encode frames to a video file (image_utils.py:105)."""
    cv2 = _require_cv2()
    h, w = frames[0].shape[:2]
    os.makedirs(os.path.dirname(out_file_name) or ".", exist_ok=True)
    out = cv2.VideoWriter(out_file_name, cv2.VideoWriter_fourcc(*"FMP4"),
                          frame_rate, (w, h))
    for f in frames:
        if add_text:
            f = f.copy()
            cv2.putText(f, add_text, (10, 20), 2, 0.5, text_color)
        out.write(f)
    out.release()


def write_individual_frames(frames: Sequence[np.ndarray],
                            output_dir: str) -> None:
    """Dump frames as numbered pngs (image_utils.py:99)."""
    cv2 = _require_cv2()
    os.makedirs(output_dir, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(output_dir, f"frame{i:06d}.png"), f)


def assemble_videos(videos: Sequence[Sequence[np.ndarray]],
                    grid_size: Tuple[int, int], description: Sequence[str],
                    out_file_name: str,
                    text_color=(255, 255, 255)) -> None:
    """Tile multiple same-size frame streams into one labeled grid video
    (image_utils.py:45)."""
    cv2 = _require_cv2()
    rows, cols = grid_size
    h, w = videos[0][0].shape[:2]
    canvas = np.zeros((h * rows, w * cols, 3), np.uint8)
    out = cv2.VideoWriter(out_file_name, cv2.VideoWriter_fourcc(*"FMP4"),
                          30, (canvas.shape[1], canvas.shape[0]))
    n_frames = min(len(v) for v in videos)
    for t in range(n_frames):
        k = 0
        for y in range(rows):
            for x in range(cols):
                if k < len(videos):
                    canvas[h * y:h * (y + 1), w * x:w * (x + 1)] = \
                        videos[k][t]
                    cv2.putText(canvas, description[k],
                                (w * x, h * y + 20), 2, 0.5, text_color)
                k += 1
        out.write(canvas)
    out.release()
