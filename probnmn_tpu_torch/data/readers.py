r"""
HDF5 readers (counterpart of ``probnmn_tpu/data/readers.py``; reference
``probnmn/data/readers.py``).

``ClevrTokensReader`` loads the whole token file into host memory
(questions, programs, answers, image_indices and a ``split`` attribute; the
test split has no programs or answers). ``ClevrImageFeaturesReader`` reads
the (N, 1024, 14, 14) image features, all into host memory or streamed from
the file. ``h5py`` is imported when a reader is built, not with the module,
so code that never opens a file (in-memory datasets on a machine without
``h5py``) does not need it.
"""
from __future__ import annotations

import threading

import numpy as np


class ClevrTokensReader:
    def __init__(self, tokens_h5path: str):
        import h5py

        with h5py.File(tokens_h5path, "r") as f:
            self._split = f.attrs["split"]
            if isinstance(self._split, bytes):
                self._split = self._split.decode()
            if self._split != "test":
                self.programs = f["programs"][:]
                self.answers = f["answers"][:]
            self.questions = f["questions"][:]
            self.image_indices = f["image_indices"][:]

    def __len__(self) -> int:
        return len(self.image_indices)

    @property
    def split(self) -> str:
        return self._split


class ClevrImageFeaturesReader:
    r"""Image features; ``__getitem__`` takes an int or an index array (any
    order, repeats allowed). ``in_memory=False`` streams: one ``h5py`` handle,
    opened lazily behind a lock (the batch pipeline reads from its gather
    thread), and each fancy read sorted and de-duplicated by ``np.unique``, as
    ``h5py`` requires, its inverse restoring the order."""

    def __init__(self, features_h5path: str, in_memory: bool = True):
        import h5py

        self.features_h5path = features_h5path
        self._in_memory = in_memory
        self._handle = None
        self._open_lock = threading.Lock()
        with h5py.File(features_h5path, "r") as f:
            self._split = f.attrs["split"]
            if isinstance(self._split, bytes):
                self._split = self._split.decode()
            self._num = f["features"].shape[0]
            self.features = f["features"][:] if in_memory else None

    def __len__(self) -> int:
        return self._num

    def _file(self):
        if self._handle is None:
            with self._open_lock:
                if self._handle is None:
                    import h5py

                    self._handle = h5py.File(self.features_h5path, "r")
        return self._handle

    def __getitem__(self, index):
        if self._in_memory:
            return self.features[index]
        if np.ndim(index) == 0:
            return self._file()["features"][int(index)]
        uniq, inverse = np.unique(np.asarray(index), return_inverse=True)
        return self._file()["features"][uniq.tolist()][inverse]

    @property
    def split(self) -> str:
        return self._split
