"""Work of the support-core burst (``kernels/support_core``): the bytes
of PERF.md's bound, each input word read once and each output word
written once -- the queue (4 words a slot), the free stack, owners and
refcounts of every class (``3 C N`` words in and out), six counters a
class, and a grant and a status word a slot -- against about twelve
integer operations a metadata word.  ``slots`` is the queue slots of the
launches summed; a grant of one block a slot is the least."""


def work(launches: int, classes: int, pages: int, slots: int
         ) -> tuple[float, float]:
    """``(integer ops, bytes)`` of ``launches`` bursts over ``classes``
    classes of up to ``pages`` blocks with ``slots`` queue slots in all."""
    meta_words = 3 * classes * pages + 6 * classes
    words = 2 * meta_words * launches + 6 * slots
    ops = 12.0 * classes * pages * launches + 4.0 * slots
    return ops, 4.0 * words
