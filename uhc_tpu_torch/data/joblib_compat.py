"""Read joblib's uncompressed numpy pickles without joblib.

joblib pickles each numpy array as a `joblib.numpy_pickle.NumpyArrayWrapper`
object whose raw bytes follow its BUILD opcode in the stream, after one
byte giving the length of an alignment padding and the padding itself.
`load` maps that class to `_ArrayWrapper`, whose BUILD reads those bytes
back. Plain pickles (the checkpoints) load through the same reader; when
the installed numpy predates `numpy._core`, references to it are mapped
to `numpy.core`.
"""
from __future__ import annotations

import pickle

import numpy as np

_HAS_CORE = hasattr(np, "_core")


class _ArrayWrapper:
    """Stand-in for joblib's NumpyArrayWrapper (state set by BUILD)."""

    def read(self, raw) -> np.ndarray:
        dtype = np.dtype(self.dtype)
        if dtype.hasobject:
            return pickle.load(raw)
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            pad = int.from_bytes(raw.read(1), "little")
            if pad:
                raw.read(pad)
        count = int(np.prod(self.shape, dtype=np.int64)) if len(
            self.shape) else 1
        nbytes = count * dtype.itemsize
        buf = raw.read(nbytes)
        if len(buf) != nbytes:
            raise pickle.UnpicklingError("array data truncated")
        arr = np.frombuffer(buf, dtype=dtype).copy()
        order = "F" if self.order == "F" else "C"
        arr = arr.reshape(self.shape, order=order)
        return arr.astype(arr.dtype.newbyteorder("="), copy=False)


class _Unpickler(pickle._Unpickler):
    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, raw):
        super().__init__(raw)
        self._raw = raw

    def find_class(self, module, name):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _ArrayWrapper
        if module.startswith("numpy._core") and not _HAS_CORE:
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            wrapper = self.stack.pop()
            self.stack.append(wrapper.read(self._raw))

    dispatch[pickle.BUILD[0]] = load_build


def load(path_or_file):
    """joblib.load for uncompressed files, or pickle.load of a plain
    pickle, without joblib."""
    if isinstance(path_or_file, (str, bytes)) or hasattr(
            path_or_file, "__fspath__"):
        with open(path_or_file, "rb") as f:
            return _Unpickler(f).load()
    return _Unpickler(path_or_file).load()
