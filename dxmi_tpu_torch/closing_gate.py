"""The Cond family's closing gate (CONVERGENCE.md §8's recipe) through the
port, run as resumed pieces: ``train_image_large`` on
``configs/imagenet64/conv16.yaml`` from ``runs_conv/pre_edm16.msgpack``
with fused_train attention, on the structured fake pool, with the proxy
FID (``fid/proxy.py``: synthetic Inception weights, statistics of the pool
as ``VIRTUAL_adm_conv16.npz``) every ``fid_every`` (250) iterations; each
piece a fresh process that resumes the last one's ``train_state.msgpack``.

    python -m dxmi_tpu_torch.closing_gate --workdir gate \
        [--steps 250,500,750] [--resume]

``--steps`` gives each piece's ``--max_steps``; ``--steps 750`` runs the
same steps as one process, the control for the resumed pieces. Runs on
the card. Everything is written under ``--workdir`` (the proxy files into
its ``datasets/``, the run into ``results/adm_conv16/conv16/gate``, each
piece's log as ``piece<k>.log``). The first piece starts from the
pretrained file unless ``--resume`` is given (a state carried over from an
earlier call). Prints, for each piece, its seconds, its FID lines, its
resume line and its seconds a step between its second and last logged
iterations (the entry's it/s, so FID and start-up are left out), then the
``sampler_best`` meta and a JSON summary as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "imagenet64", "conv16.yaml")
DATASET = os.path.join(REPO, "configs", "imagenet64", "imagenet64.yaml")
PRETRAINED = os.path.join(REPO, "runs_conv", "pre_edm16.msgpack")
DATA_NAME = "adm_conv16"
RUN = "gate"
PROXY_N = 4096  # the recipe's statistics images


def proxy_files(workdir: str) -> float:
    """Write the proxy FID files into ``workdir/datasets`` unless there;
    returns the seconds it took."""
    if os.path.exists(os.path.join(workdir, "datasets",
                                   f"VIRTUAL_{DATA_NAME}.npz")):
        return 0.0
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "dxmi_tpu_torch.fid.proxy",
                    "--out", "datasets", "--virtual_name", DATA_NAME,
                    "--image_size", "16", "--n_class", "4", "--data_seed",
                    "42", "--n", str(PROXY_N)], cwd=workdir,
                   check=True, env=dict(os.environ, PYTHONPATH=REPO))
    return time.perf_counter() - t0


def seconds_a_step(lines: List[str]) -> float:
    """Seconds a step between the second and the last logged iteration,
    from the entry's cumulative it/s (``iter I ... (R it/s)``): the first
    logged one carries the FID and the start."""
    pts = []
    for line in lines:
        if line.startswith("iter ") and "it/s)" in line:
            i = int(line.split()[1])
            rate = float(line.split("(")[-1].split()[0])
            pts.append((i, rate))
    if len(pts) < 3:
        return float("nan")
    start = pts[0][0]
    (i1, r1), (i2, r2) = pts[1], pts[-1]
    t1, t2 = (i1 + 1 - start) / r1, (i2 + 1 - start) / r2
    return (t2 - t1) / (i2 - i1)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="gate")
    p.add_argument("--steps", default="250,500,750")
    p.add_argument("--resume", action="store_true")
    args = p.parse_args()
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    proxy_s = proxy_files(workdir)
    print(f"proxy files: {proxy_s:.1f} s", flush=True)
    pieces: List[Dict[str, Any]] = []
    for k, n in enumerate(int(v) for v in args.steps.split(",")):
        cmd = [sys.executable, "-m", "dxmi_tpu_torch.train_image_large",
               "--config", CONFIG, "--dataset", DATASET, "--run", RUN,
               "--fake_data", "--fake_data_size", "1024", "--data.name",
               DATA_NAME, "--training.pretrained_path", PRETRAINED,
               "--attn_impl", "fused_train", "--max_steps", str(n)]
        if k or args.resume:
            cmd.append("--resume")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=workdir, capture_output=True,
                              text=True, env=dict(os.environ,
                                                  PYTHONPATH=REPO))
        secs = time.perf_counter() - t0
        with open(os.path.join(workdir, f"piece{k + 1}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise SystemExit(f"piece {k + 1} failed:\n{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        fids = [float(l.split()[1]) for l in lines if l.startswith("FID: ")]
        resumed = [l for l in lines if l.startswith("resumed")]
        rate = seconds_a_step(lines)
        piece = {"max_steps": n, "seconds": secs, "fid": fids,
                 "s_per_step": None if rate != rate else rate,
                 "resumed": resumed[0] if resumed else None}
        pieces.append(piece)
        print(f"piece {k + 1} (--max_steps {n}): {secs:.1f} s, "
              f"{rate:.3f} s/step, FID {fids}, "
              f"{piece['resumed'] or 'from the pretrained file'}",
              flush=True)
    run_dir = os.path.join(workdir, "results", DATA_NAME, "conv16", RUN)
    best_path = os.path.join(run_dir, "sampler_best.pth")
    best = None
    if os.path.exists(best_path):
        ckpt = torch.load(best_path, map_location="cpu", weights_only=True)
        best = {k: v for k, v in ckpt.items() if k != "state_dict"}
    print(f"sampler_best meta: {best}", flush=True)
    print(json.dumps({"proxy_seconds": proxy_s, "pieces": pieces,
                      "best": best}))


if __name__ == "__main__":
    main()
