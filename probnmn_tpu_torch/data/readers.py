r"""
HDF5 token reader (counterpart of ``probnmn_tpu/data/readers.py``; reference
``probnmn/data/readers.py``).

``ClevrTokensReader`` loads the whole token file into host memory
(questions, programs, answers, image_indices and a ``split`` attribute; the
test split has no programs or answers). ``h5py`` is imported when a reader is
built, not with the module, so code that never opens a file (in-memory
datasets on a machine without ``h5py``) does not need it.
"""
from __future__ import annotations


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
