"""Interactive trajectory viewer (the port's own copy of
uhc_tpu.utils.interactive).

The playback logic is a pure, headless-testable state machine
(`PlaybackState`); the window layer (`InteractiveViewer`) is a thin shell
over it on matplotlib's event system, so it runs wherever matplotlib has a
GUI backend (TkAgg / QtAgg / macosx), with no OpenGL.

Key map:

  space  pause / unpause              w  jump to first frame
  s      reverse playback direction   e  jump to last frame
  right  step one frame forward       g  toggle repeat (loop)
  left   step one frame back          d  slow down  (cycle T up)
  q      next take (sequence)         f  speed up   (cycle T down)
  t      screenshot -> PNG            v  dump current take -> mp4/gif

`T` is the frames-per-pose-update divisor (T_ARR); the animation ticks at
a fixed rate and advances the pose every T ticks, so larger T = slower
playback.

Launch from the replay CLI:
    python -m uhc_tpu_torch.cli.replay --data eval_dump.pkl --interactive
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional

import numpy as np

T_ARR = (1, 2, 4, 6, 8, 10, 12, 15, 20, 30, 40, 50, 60)


@dataclasses.dataclass
class PlaybackState:
    """Pure playback state machine — the reference Visualizer's key
    semantics (visualizer.py:6) without any window system. `on_key`
    returns True when the key was handled; `tick` implements one
    render-loop iteration of show_animation (advance the frame every T
    ticks unless paused)."""

    num_fr: int
    num_takes: int = 1
    fr: int = 0
    take: int = 0
    T: int = 12
    t: int = 0
    paused: bool = False
    reverse: bool = False
    repeat: bool = False
    # one-shot requests the frontend consumes (then clears)
    want_screenshot: bool = False
    want_record: bool = False
    take_changed: bool = False

    def on_key(self, key: Optional[str]) -> bool:
        if not key:
            return False
        key = key.lower() if len(key) > 1 else key
        if key == " " or key == "space":
            self.paused = not self.paused
        elif key == "s":
            self.reverse = not self.reverse
        elif key == "right":
            self.fr = min(self.fr + 1, self.num_fr - 1)
        elif key == "left":
            self.fr = max(self.fr - 1, 0)
        elif key == "q":
            self.take = (self.take + 1) % self.num_takes
            self.fr = 0
            self.t = 0
            self.take_changed = True
        elif key == "w":
            self.fr = 0
        elif key == "e":
            self.fr = self.num_fr - 1
        elif key == "g":
            self.repeat = not self.repeat
        elif key == "d":       # next T (slower), wrapping like the reference
            self.T = T_ARR[(T_ARR.index(self.T) + 1) % len(T_ARR)]
        elif key == "f":       # previous T (faster)
            self.T = T_ARR[(T_ARR.index(self.T) - 1) % len(T_ARR)]
        elif key == "t":
            self.want_screenshot = True
        elif key == "v":
            self.want_record = True
        else:
            return False
        return True

    def tick(self) -> bool:
        """One render-loop iteration (visualizer.py:75 show_animation).
        Returns True when the displayed frame changed."""
        if self.paused:
            return False
        self.t += 1
        if self.t < math.floor(self.T):
            return False
        self.t = 0
        if not self.reverse:
            if self.fr < self.num_fr - 1:
                self.fr += 1
            elif self.repeat:
                self.fr = 0
            else:
                return False
        elif self.reverse:
            if self.fr > 0:
                self.fr -= 1
            elif self.repeat:
                self.fr = self.num_fr - 1
            else:
                return False
        return True


class InteractiveViewer:
    """Matplotlib window over `PlaybackState` for eval --dump takes.

    takes: {key: {"pred_jpos": (T, nb*3|nb,3) [, "gt_jpos": ...]}} — the
    replay-CLI pkl schema. Works headlessly under the Agg backend for
    tests (render() draws into the figure; show() needs a GUI backend)."""

    def __init__(self, takes: Dict[str, dict], fps: int = 30,
                 out_dir: str = ".", backend: Optional[str] = None):
        from uhc_tpu_torch.utils.visualizer import _require_matplotlib

        matplotlib = _require_matplotlib(agg=False)
        if backend:
            matplotlib.use(backend)
        import matplotlib.pyplot as plt

        self.keys: List[str] = list(takes)
        self.takes = takes
        self.fps = fps
        self.out_dir = out_dir
        self._shot_idx = 0
        self.state = PlaybackState(
            num_fr=len(takes[self.keys[0]]["pred_jpos"]),
            num_takes=len(self.keys))
        self.fig = plt.figure(figsize=(6, 6))
        self.ax = self.fig.add_subplot(projection="3d")
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.render()

    # -- data access ------------------------------------------------------
    def _seq(self, field: str) -> Optional[np.ndarray]:
        v = self.takes[self.keys[self.state.take]].get(field)
        if v is None:
            return None
        v = np.asarray(v)
        return v.reshape(len(v), -1, 3)

    # -- event plumbing ----------------------------------------------------
    def _on_key(self, event) -> None:
        if self.state.on_key(getattr(event, "key", event)):
            self._service_requests()
            self.render()

    def _service_requests(self) -> None:
        s = self.state
        if s.take_changed:
            s.take_changed = False
            s.num_fr = len(self.takes[self.keys[s.take]]["pred_jpos"])
            s.fr = min(s.fr, s.num_fr - 1)
        if s.want_screenshot:
            s.want_screenshot = False
            path = os.path.join(
                self.out_dir,
                f"frame_{self.keys[s.take]}_{self._shot_idx:04d}.png")
            self._shot_idx += 1
            self.fig.savefig(path, dpi=80)
            print(f"screenshot -> {path}")
        if s.want_record:
            s.want_record = False
            from uhc_tpu_torch.utils.visualizer import render_comparison

            key = self.keys[s.take]
            out = os.path.join(self.out_dir, f"take_{key}.mp4")
            path = render_comparison(self._seq("pred_jpos"),
                                     self._seq("gt_jpos"), out_path=out,
                                     fps=self.fps)
            print(f"recorded {key} -> {path}")

    # -- rendering ---------------------------------------------------------
    def render(self) -> None:
        from uhc_tpu_torch.utils.visualizer import render_frame

        s = self.state
        pred, gt = self._seq("pred_jpos"), self._seq("gt_jpos")
        render_frame(self.ax, pred[s.fr],
                     None if gt is None else gt[s.fr])
        self.ax.set_title(
            f"{self.keys[s.take]}  fr {s.fr + 1}/{s.num_fr}  T={s.T}"
            f"{'  paused' if s.paused else ''}"
            f"{'  rev' if s.reverse else ''}"
            f"{'  loop' if s.repeat else ''}")

    def step(self) -> None:
        """One animation tick (timer callback) — redraw when the frame
        advanced."""
        if self.state.tick():
            self.render()
            self.fig.canvas.draw_idle()

    def show(self) -> None:
        """Run the interactive loop (requires a GUI matplotlib backend)."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        self._anim = FuncAnimation(
            self.fig, lambda _i: self.step(),
            interval=1000 // (self.fps * 2), blit=False,
            cache_frame_data=False)
        plt.show()
