"""Device milliseconds per batch of the complex float32 GEMM kernels
(cuBLAS, by name): on the PUSCH, the front end's 1152-point DFT
de-spreading product and the DM-RS estimator's filters."""


def read(ctx):
    t = sum(b - a for name, a, b in ctx.trace.kernels
            if "gemm" in name.lower() and ("cf32" in name or "cgemm" in name.lower()))
    return t * 1e3 / ctx.trace.batches if t > 0 else None
