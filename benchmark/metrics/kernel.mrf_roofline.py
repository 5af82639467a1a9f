"""kernel.mrf_roofline (%): layer Kernel (ops/cuda/mrf_stage.py over
csrc/mrf_stage.cu and csrc/mrf_stage_bf16.cu); moves audio_s_per_s.  The
least time the chip could take for the MRF stage calls made in the traced
sub-window (benchmark.flops: max(operations / peak, bytes / HBM bandwidth)
per call, from the shapes the harness's recorder logged) over the device
time of the MRF kernels in the same sub-window (profiler events named
mrf_stage_kernel, the float32 mode, or mrf_bf16_kernel, the bfloat16 mode).
Peak: 989 TFLOP/s in bfloat16, 165 TFLOP/s (3xTF32) in float32.  Nothing to
read where no call was made or no kernel ran."""

from benchmark import flops

KERNELS = ("mrf_stage_kernel", "mrf_bf16_kernel")


def read(ctx):
    dev = sum(e.end - e.start for e in ctx.trace.device if any(k in e.name for k in KERNELS))
    if dev <= 0 or not ctx.mrf_calls:
        return None
    bound = sum(flops.bound_seconds(*flops.mrf_stage(*call), ctx.precision)
                for call in ctx.mrf_calls)
    return 100.0 * bound / (dev / 1e9)
