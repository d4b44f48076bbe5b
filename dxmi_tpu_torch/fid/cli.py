"""The standalone FID command (``dxmi_tpu/fid/cli.py``, pytorch_fid's
``main()``):

    python -m dxmi_tpu_torch.fid.cli path1 path2 [--batch-size 50] \
        [--weights W] [--device cuda|cpu]
    python -m dxmi_tpu_torch.fid.cli --save-stats image_dir out_stats.npz

A path is a directory of PNG images or a statistics file (``.npz`` with
``mu``/``sigma`` or ``m2``/``s2``, or ``.pt``).
"""
from __future__ import annotations

import argparse

from dxmi_tpu_torch.fid import runner as fid_runner
from dxmi_tpu_torch.fid import stats as S
from dxmi_tpu_torch.fid.image_dir import compute_dir_statistics, save_stats
from dxmi_tpu_torch.fid.inception import (build_inception,
                                          load_fid_inception_params,
                                          pool3_host)
from dxmi_tpu_torch.runtime import select_device


def _stats_for(path, extract_fn, batch):
    if path.endswith((".npz", ".pt")):
        return fid_runner.load_dataset_stats(path)
    return compute_dir_statistics(path, extract_fn, batch)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="+")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--weights", default=None)
    p.add_argument("--save-stats", action="store_true",
                   help="paths = [image_dir, out.npz]: precompute stats")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    weights = args.weights or fid_runner._find(fid_runner.DEFAULT_WEIGHTS)
    if weights is None:
        raise SystemExit("FID Inception weights not found on disk")
    dev = select_device(args.device)
    model = build_inception(load_fid_inception_params(weights), dev)

    def extract(x01):
        return pool3_host(model, x01)

    if args.save_stats:
        src, dst = args.paths
        mu, sigma = compute_dir_statistics(src, extract, args.batch_size)
        save_stats(dst, mu, sigma)
        print(f"stats saved to {dst}")
        return

    (m1, s1), (m2, s2) = (_stats_for(p_, extract, args.batch_size)
                          for p_ in args.paths)
    print("FID:", S.frechet_distance(m1, s1, m2, s2))


if __name__ == "__main__":
    main()
