"""The hand-written CUDA kernels and their wrappers.

The card the launch plans assume where they are not told the card's
own figures, one place for the whole port:"""

import contextlib
import threading

import torch

#: the streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: the most shared memory one block may ask for on an H100 (227 KB)
H100_MAX_SMEM = 232448

# Launch counts. Each wrapper keeps a dict ``launches`` {kernel name:
# launches} and adds one with count_launch where it launches its kernel.
# While a graph is captured (capturing_launches; one capture at a time,
# core.graphs.CAPTURE_LOCK), a launch on a capturing stream goes to the
# capture's own tally: it ran nowhere yet, and each replay credits it
# (credit_launches). That holds on whatever thread the launch comes
# from: autograd runs a backward on a thread of its own, on the stream
# of its forward. A launch on a stream that is not capturing (another
# thread's eager work) goes to the dicts as usual and never into the
# tally. The lock is held only for one addition, so the counts are exact
# across threads and nothing waits on a capture.
_COUNT_LOCK = threading.Lock()
_tally = None


def count_launch(counter, name):
    """Add one launch of ``name`` to the wrapper's dict ``counter``, or
    to the running capture's tally where the current stream captures."""
    with _COUNT_LOCK:
        if _tally is not None and torch.cuda.is_current_stream_capturing():
            counts = _tally.setdefault(id(counter), (counter, {}))[1]
            counts[name] = counts.get(name, 0) + 1
        else:
            counter[name] += 1


@contextlib.contextmanager
def capturing_launches():
    """Keep the launches on capturing streams apart for the duration;
    yields a list that holds, at the exit, the ``(counter, {name:
    launches})`` pairs of what was launched."""
    global _tally
    with _COUNT_LOCK:
        if _tally is not None:
            raise RuntimeError("a capture already counts launches")
        _tally = tally = {}
    out = []
    try:
        yield out
    finally:
        with _COUNT_LOCK:
            _tally = None
        out.extend(tally.values())


def credit_launches(tally):
    """Add a captured tally (one replay's launches) to the counters."""
    with _COUNT_LOCK:
        for counter, counts in tally:
            for name, n in counts.items():
                counter[name] += n
