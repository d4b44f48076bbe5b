"""Where the time of E12's fp32 references goes (``chip_smoke.py``, phase
E12): one forward of the ImageNet64 T10 net (``configs/imagenet64/T10.yaml``,
seeded weights) through ``KarrasDenoiser.denoise`` under the kernels' plain
versions, in bf16 and in fp32, at 10 and 16 samples, with and without its
backward, with ``torch.backends.cudnn.benchmark`` off and on (three timed
calls each, the first including cuDNN's set-up); then a ``torch.profiler``
table of one fp32 forward at 10 samples.

    python3 tests/torch_fixtures/e12_fp32_route_report.py   # on a CUDA card

Needs the card; prints the times in seconds.
"""
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from dxmi_tpu_torch import train_image_large  # noqa: E402
from dxmi_tpu_torch.runtime import select_device  # noqa: E402


def forward_times(net, diff, B, grad=False, reps=3):
    x = torch.randn(B, 3, 64, 64, device="cuda")
    sig = torch.full((B,), 10.0, device="cuda")
    y = torch.randint(0, 1000, (B,), device="cuda")
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(grad):
            o = diff.denoise(net, x, sig, y)[1]
            if grad:
                o.float().square().mean().backward()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return [round(v, 4) for v in out]


def main():
    from torch.profiler import ProfilerActivity, profile
    select_device("cuda")
    s = train_image_large.build_sampler(cs.imagenet64_train_config(),
                                        torch.device("cuda"), 42)
    net, diff = s.net, s.diffusion
    net.eval()
    print("torch", torch.__version__, "tf32", torch.backends.cudnn.allow_tf32,
          flush=True)
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for mode in ("plain_bf16", "plain_fp32"):
            for B in (10, 16):
                for grad in (False, True):
                    ctx = (cs.plain_kernels_adm() if mode == "plain_bf16"
                           else cs.plain_fp32(net))
                    with ctx:
                        print(f"bench={bench} {mode} B={B} grad={grad}: "
                              f"{forward_times(net, diff, B, grad)}",
                              flush=True)
    torch.backends.cudnn.benchmark = False
    with cs.plain_fp32(net):
        forward_times(net, diff, 10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward_times(net, diff, 10, reps=1)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12),
          flush=True)


if __name__ == "__main__":
    main()
