"""Helpers shared by the kernels' autograd Functions
(``ops/kernels/conv.py``, ``ops/kernels/gru.py``, ``ops/linear.py``):
the ``forward`` + ``setup_context`` form that ``torch.func`` needs, and
the arguments of a ``vmap`` rule with the member axis first.
"""
import inspect


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
