"""Named spans of the engines' steps, on the profiler's clock.

``span(name)`` marks a stretch of host code.  While a ``torch.profiler``
session records, it is a ``torch.profiler.record_function``: the span lands
in the profiler's trace as a ``user_annotation`` event, on the clock of the
device's kernels and copies, so an idle stretch of the device can be put
down to the step the host was in.  Otherwise it is one shared null context:
the step pays one flag check (a ``record_function`` built with no profiler
recording still costs some microseconds).
"""
import contextlib

import torch
import torch.autograd.profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` while a profiler records,
    and does nothing otherwise."""
    # read at every call: the profiler's start and stop set it
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL
