"""FID through the large-image entries on the CPU at a small width (the
shrunken ImageNet64 config of chip_smoke.SHRUNK_TRAIN_ARGS), with the proxy
weights and ``VIRTUAL_imagenet64.npz`` over the structured fake pool under
the working directory (tests/torch_fixtures/fid_files.py):
train_image_large computes FID every ``fid_every`` iterations and writes
sampler_best with fid and i_iter (the refusal is gone); generate_large on
that run computes FID in-process without writing PNGs."""
import os
import subprocess

import numpy as np
import torch

import chip_smoke
from torch_fixtures.fid_files import write_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO,
                                                OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_train_image_large_then_generate_with_fid(tmp_path):
    write_datasets(str(tmp_path), virtual="imagenet64", image_size=16,
                   n_class=4)
    train, gen, log_dir = chip_smoke.train_cli_commands("fid", "cpu")
    lines = _run(train + ["--training.fid_every", "2",
                          "--training.n_fid_samples", "6",
                          "--training.sampling_batchsize", "4"], tmp_path)
    fids = [float(l.split()[1]) for l in lines if l.startswith("FID: ")]
    assert len(fids) == 1 and np.isfinite(fids[0])  # at iter 0 of 2
    assert lines[-1] == "done"
    run = tmp_path / log_dir
    assert {"sampler_best.pth", "value_best.pth"} <= set(os.listdir(run))
    best = torch.load(run / "sampler_best.pth", weights_only=True)
    assert {k: v for k, v in best.items() if k != "state_dict"} == {
        "fid": fids[0], "i_iter": 0}

    lines = _run([*gen[:gen.index("last")], "best",
                  *gen[gen.index("last") + 1:]], tmp_path)
    assert f"checkpoint FID {fids[0]}" in lines
    fid = [float(l.split()[1]) for l in lines if l.startswith("FID: ")]
    assert len(fid) == 1 and np.isfinite(fid[0])
    assert any(l.startswith("FID time: ") for l in lines)
    assert not (run / "generated_best").exists()
    assert np.load(run / "samples.npz")["arr_0"].shape == (8, 16, 16, 3)
