"""Time the bf16 attention block at d = 256, whole and by launch, with the
``dxmi_tpu_torch`` package found under a given directory.

K2 bf16 at (100, 256, 256), one head (E-bf16's blocks), and K7 bf16 at
(128, 256, 256), bb 4 (E4-levers' blocks under DXMI_FUSED_ATTN_BB=4): the
device time of 20 calls after 3 of warm-up (CUDA events, the card spinning
while the host queues them, as chip_smoke.time_ms), then each kernel's
device time a call over 5 calls (torch.profiler). Pointed at a parent
commit's tree (``git archive``), it times that commit's kernels, so that
two commits compare on one card in one call (one process for each tree:
the package is imported once a process):

    python3 attn_split.py <dir>
"""
import sys


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from dxmi_tpu_torch.ops import _lib
    from dxmi_tpu_torch.ops.attn_block import attn_block, attn_block_bb
    print("package", _lib.__file__, flush=True)
    _lib.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    def case(B, S, C):
        return (randn(B, S, C, scale=2.0, shift=0.5).bfloat16(),
                randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1),
                randn(C, 3 * C, scale=C ** -0.5).bfloat16(),
                randn(3 * C, scale=0.1).bfloat16(),
                randn(C, C, scale=C ** -0.5).bfloat16(),
                randn(C, scale=0.1).bfloat16())

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def by_launch(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("(")[0][:70]
                total.setdefault(name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        return {k: (len(v) / reps, sum(v) / reps) for k, v in total.items()}

    for label, B, bb in (("K2 bf16 d256", 100, 1), ("K7 bf16 bb 4", 128, 4)):
        a = case(B, 256, 256)
        if bb == 1:
            fn = lambda: attn_block(*a, num_heads=1, eps=1e-6)  # noqa: E731
        else:
            fn = lambda: attn_block_bb(*a, num_heads=1, eps=1e-6,  # noqa
                                       bb=bb)
        print(f"split {label}: {time_ms(fn):.4f} ms", flush=True)
        for k, (n, t) in by_launch(fn).items():
            print(f"split   {label} launch {k}: {n:g} a call, {t:.4f} ms a "
                  "call", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    main(sys.argv[1])
