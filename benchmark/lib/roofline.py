"""The count of a sparse product's work, the chip's peak, and a product's
device time from the profiler's trace of a chain of products.

A product ``Y = W X`` of ``W`` (n x n, ``nnz`` stored nonzeros) and ``X``
(n x d) needs at least, whatever implements it: each stored nonzero's
value and column index read once, the row pointers read once, ``X`` read
once and ``Y`` written once.  Values, indices and pointers take 4 bytes
(float32 and int32, the least a float32 CSR of under 2**31 nonzeros
holds); ``X`` and ``Y`` take the element size the configuration states.
Its least time is those bytes over the peak bandwidth; its FLOPs (2 nnz
d) are far below what bounds it."""

# NVIDIA H100 SXM5 80GB: HBM3 bandwidth, NVIDIA's data sheet.
PEAK_BYTES_S = 3.35e12


def w_bytes(n, nnz):
    return 8 * nnz + 4 * (n + 1)


def xy_bytes(n, d, elem=4):
    return 2 * n * d * elem


def least_s(n, nnz, d, elem=4):
    """Least seconds of one product at width ``d``."""
    return (w_bytes(n, nnz) + xy_bytes(n, d, elem)) / PEAK_BYTES_S


def device_s(product, X, reps=20):
    """Device seconds of one product: after a warm product, a chain of
    ``reps`` products back to back under the profiler, and the union of
    the intervals in which the card ran their kernels and copies
    (:func:`benchmark.lib.trace.summarize`) over ``reps``."""
    import torch

    from benchmark.lib import trace as tr

    product(X)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            for _ in range(reps):
                product(X)
            torch.cuda.synchronize()
    summary = tr.summarize(tr.events(prof))
    return None if summary is None else summary["busy_s"] / reps
