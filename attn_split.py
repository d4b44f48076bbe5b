"""Time the bf16 attention block at d = 256, or K6's fp32 form, whole and by
launch, with the ``dxmi_tpu_torch`` package found under a given directory.

K2 bf16 at (100, 256, 256), one head (E-bf16's blocks), and K7 bf16 at
(128, 256, 256), bb 4 (E4-levers' blocks under DXMI_FUSED_ATTN_BB=4): the
device time of 20 calls after 3 of warm-up (CUDA events, the card spinning
while the host queues them, as chip_smoke.time_ms), then each kernel's
device time a call over 5 calls (torch.profiler). Pointed at a parent
commit's tree (``git archive``), it times that commit's kernels, so that
two commits compare on one card in one call (one process for each tree:
the package is imported once a process):

    python3 attn_split.py <dir>
    python3 attn_split.py <dir> k6

``k6``: K6 fp32 (the attention block's backward) at G3's (8, 64, 64) and
E5's (64, 64, 64) shapes, two heads, beside its library yardstick (the
backward alone of autograd through F.group_norm, the matmuls and SDPA in
fp32, TF32 off), whole and by launch.
"""
import sys


def main(root: str, what: str = "bf16") -> None:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from dxmi_tpu_torch.ops import _lib
    from dxmi_tpu_torch.ops.attn_block import (attn_block, attn_block_bb,
                                               attn_block_bwd)
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

    def split(label, fn):
        print(f"split {label}: {time_ms(fn):.4f} ms", flush=True)
        for k, (n, t) in by_launch(fn).items():
            print(f"split   {label} launch {k}: {n:g} a call, {t:.4f} ms a "
                  "call", flush=True)

    if what == "k6":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for B in (8, 64):
            S, C, nh = 64, 64, 2
            d = C // nh
            a = (randn(B, S, C, scale=2.0, shift=0.5),
                 randn(B, S, C, shift=0.5), randn(C, scale=0.1, shift=1.0),
                 randn(C, scale=0.1), randn(C, 3 * C, scale=C ** -0.5),
                 randn(3 * C, scale=0.1), randn(C, C, scale=C ** -0.5))
            x, ct, gs, gb, wq, bq, wp = a
            xl = x.clone().requires_grad_(True)
            pl = [t.clone().requires_grad_(True) for t in (gs, gb, wq, bq, wp)]
            g = F.group_norm(xl.transpose(1, 2), 32, pl[0], pl[1],
                             1e-5).transpose(1, 2)
            q, k, v = (g @ pl[2] + pl[3]).reshape(B, S, 3, nh, d).permute(
                2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            y = xl + o.transpose(1, 2).reshape(B, S, C) @ pl[4]
            lib_ms = time_ms(lambda: torch.autograd.grad(
                y, [xl, *pl], ct, retain_graph=True))
            print(f"split K6 fp32 {(B, S, C, nh)} library: {lib_ms:.4f} ms",
                  flush=True)
            split(f"K6 fp32 {(B, S, C, nh)}",
                  lambda: attn_block_bwd(*a, nh))  # noqa: B023
        return
    for label, B, bb in (("K2 bf16 d256", 100, 1), ("K7 bf16 bb 4", 128, 4)):
        a = case(B, 256, 256)
        if bb == 1:
            fn = lambda: attn_block(*a, num_heads=1, eps=1e-6)  # noqa: E731
        else:
            fn = lambda: attn_block_bb(*a, num_heads=1, eps=1e-6,  # noqa
                                       bb=bb)
        split(label, fn)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["k6"]):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    main(*sys.argv[1:])
