r"""
probnmn_tpu_torch: the PyTorch/CUDA port of ``probnmn_tpu`` for NVIDIA Hopper.

It mirrors the JAX package's module names, so each counterpart is easy to
find, and serves CLEVR questions (question tokens + ResNet features ->
answer) with hand-written CUDA kernels for the two hot paths: the
ProgramGenerator sampling decoder (``ops/kernels/seq2seq_decode.py``) and the
NMN program interpreter (``ops/kernels/nmn_interpreter.py``). Everything else
is plain PyTorch. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version. The package imports no JAX.
"""
__version__ = "0.1.0"

from probnmn_tpu_torch.config import Config  # noqa: F401
