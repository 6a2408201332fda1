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

:class:`SharedFeatures` holds features in shared host memory, so that the
ranks of a data-parallel launch (``parallel/mesh.py``) gather from one copy:
CLEVR train's features are 70,000 x 1024 x 14 x 14 float32, 56.2 GB, which
would be 225 GB as four private copies.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


class SharedFeatures:
    r"""An array in shared host memory (a tensor after ``share_memory_()``):
    indexing gives numpy arrays, and a pickled copy handed to a spawned
    process maps the same pages, so every rank of a launch reads one copy.
    :meth:`from_h5` reads a file's ``features`` straight into it."""

    def __init__(self, tensor: torch.Tensor):
        if not tensor.is_shared():
            raise ValueError("SharedFeatures takes a tensor in shared memory")
        self.tensor = tensor
        self._array = tensor.numpy()

    @classmethod
    def from_array(cls, array) -> "SharedFeatures":
        r"""A shared copy of ``array``."""
        return cls(torch.from_numpy(np.ascontiguousarray(array)).clone().share_memory_())

    @classmethod
    def from_h5(cls, dataset) -> "SharedFeatures":
        r"""An h5py dataset read into shared memory in one pass (the private
        pages ``torch.empty`` reserves are never touched)."""
        dtype = torch.from_numpy(np.empty(0, dataset.dtype)).dtype
        tensor = torch.empty(dataset.shape, dtype=dtype).share_memory_()
        dataset.read_direct(tensor.numpy())
        return cls(tensor)

    def __reduce__(self):
        return SharedFeatures, (self.tensor,)

    def __len__(self) -> int:
        return len(self._array)

    def __getitem__(self, index):
        return self._array[index]

    @property
    def shape(self):
        return self._array.shape


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
    ``h5py`` requires, its inverse restoring the order. ``shared=True`` (in
    memory) reads the features into :class:`SharedFeatures`. A reader
    pickles without its file handle: a spawned rank streams through a handle
    of its own, and shares the in-memory features only when they are
    shared."""

    def __init__(self, features_h5path: str, in_memory: bool = True, shared: bool = False):
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
            if not in_memory:
                self.features = None
            elif shared:
                self.features = SharedFeatures.from_h5(f["features"])
            else:
                self.features = f["features"][:]

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_handle"] = None
        del state["_open_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_lock = threading.Lock()

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
