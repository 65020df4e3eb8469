"""Helpers shared by the kernels' autograd Functions
(``ops/kernels/conv.py``, ``ops/kernels/gru.py``, ``ops/linear.py``):
the ``forward`` + ``setup_context`` form that ``torch.func`` needs, the
arguments of a ``vmap`` rule with the member axis first, and full-f32
library calls (TF32 off).
"""
import contextlib
import inspect

import torch


@contextlib.contextmanager
def full_f32(cudnn=True):
    """cuDNN's convs and cuBLAS's matmuls in full f32 inside (TF32 off,
    which would round each f32 operand to 10 mantissa bits), the previous
    settings restored after: the f32 tower's plain versions and matmuls
    (``compute_dtype='float32'``). ``cudnn=False`` also turns cuDNN off,
    so that a conv on the card runs PyTorch's own im2col and f32 cuBLAS
    GEMM: f32 products and sums, where cuDNN may take a Winograd or FFT
    algorithm (its f32 weight gradient at the shallow tower's L5 lay
    1.2e-4 of the largest entry from the f32 kernel's, whose other
    layers it met to 3e-6, on an NVIDIA H100 80GB HBM3 at 700 W)."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = enabled and cudnn
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.enabled = enabled


def cache_signature(function):
    """Class decorator for a ``torch.autograd.Function`` with
    ``setup_context`` (the form ``torch.func`` needs): its ``apply`` binds
    the arguments to ``forward``'s signature on every call, and
    ``inspect.signature`` of a function that carries ``__signature__``
    returns that at once instead of building it again (half the form's
    host cost a call)."""
    function.forward.__signature__ = inspect.signature(function.forward)
    return function


def members_first(info, in_dims, args):
    """The arguments of a Function's ``vmap`` rule with the member axis
    first: a batched tensor's vmapped dimension moved to the front, an
    unbatched one (``in_dim`` None, shared by every member) expanded to
    ``info.batch_size`` members; None stays None."""
    out = []
    for arg, dim in zip(args, in_dims):
        if arg is None:
            out.append(None)
        elif dim is None:
            out.append(arg.expand(info.batch_size, *arg.shape))
        else:
            out.append(arg.movedim(dim, 0))
    return out
