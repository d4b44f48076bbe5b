"""The port's key-value logger (``dxmi_tpu_torch.utils.kvlogger``), misc
helpers (``utils/misc.py``) and profiling hooks (``utils/profiling.py``)
against the JAX package's: the same calls write the same files and print
the same lines."""
import io
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from dxmi_tpu.utils import kvlogger as jkv
from dxmi_tpu.utils import misc as jmisc
from dxmi_tpu_torch.utils import kvlogger, misc, profiling

FILES = ("progress.csv", "progress.json", "log.txt")


def _log_calls(mod, logdir, formats):
    """A fixed sequence of calls on ``mod``'s global logger; its stdout."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.configure(logdir, formats)
        mod.logkv("step", 0)
        mod.logkv_mean("loss", 1.5)
        mod.logkv_mean("loss", 0.25)
        mod.logkv("name", "run")
        mod.dumpkvs()
        mod.logkv("step", 1)
        mod.logkv("new_key", 3.25e-7)  # the CSV header is rewritten
        mod.logkv_mean("loss", 2)
        with mod.profile_kv("io"):
            pass
        mod.dumpkvs()
        mod.dumpkvs()  # nothing logged: nothing written
        mod.logkv("step", 2)
        mod.dumpkvs()
    return buf.getvalue()


def test_files_and_lines_equal_jax(tmp_path):
    formats = ("stdout", "csv", "json", "log")
    got = _log_calls(kvlogger, str(tmp_path / "port"), formats)
    want = _log_calls(jkv, str(tmp_path / "jax"), formats)
    # wait_io's value is a wall time: equal up to its digits
    strip = lambda s: "\n".join(ln for ln in s.splitlines() if "wait_io"
                                not in ln)
    assert strip(got) == strip(want)
    for name in FILES:
        a = (tmp_path / "port" / name).read_text().splitlines()
        b = (tmp_path / "jax" / name).read_text().splitlines()
        assert len(a) == len(b), name
        for la, lb in zip(a, b):
            if "wait_io" in lb and name != "progress.csv":
                continue
            if name == "progress.csv" and la != lb:
                # the wait_io column holds the wall time
                ra, rb = la.split(","), lb.split(",")
                header = b[0].split(",")
                i = header.index("wait_io")
                assert ra[:i] + ra[i + 1:] == rb[:i] + rb[i + 1:]
                continue
            assert la == lb, name


def test_tensorboard_without_tensorboardx(tmp_path, monkeypatch):
    """Without tensorboardX the format is dropped with JAX's message; a
    logger without a directory drops the file formats, as JAX's."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    msgs = []
    for mod, sub in ((kvlogger, "port"), (jkv, "jax")):
        err = io.StringIO()
        with redirect_stderr(err):
            mod.KVLogger(str(tmp_path / sub), ("tensorboard",))
            mod.KVLogger(None, ("csv",))
        msgs.append(err.getvalue())
    assert msgs[0] == msgs[1] and "tensorboardX not installed" in msgs[0]


def test_configure_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("DXMI_LOGDIR", str(tmp_path / "env"))
    monkeypatch.setenv("DXMI_LOG_FORMAT", "log,json")
    lg = kvlogger.configure()
    assert lg.logdir == str(tmp_path / "env") and not lg.stdout
    assert os.path.exists(tmp_path / "env" / "log.txt")
    assert kvlogger.get() is lg

    @kvlogger.profile("step")
    def work():
        return 7

    assert work() == 7 and "wait_step" in lg.name2val


def test_batch_run_and_weight_norm_match_jax(tmp_path, capsys):
    """batch_run pads the tail and drops the padding as JAX's does;
    batch_run_grad's per-sample input-gradient norms equal JAX's for the
    same function (sum of squares: 2 |x|); weight_norm is the global L2
    norm (``weight_norm_of``, which sums each tensor in fp32 in torch's
    order where numpy sums pairwise: 1e-6 relative) of a module, a state
    dict or numpy arrays; mkdir_p and print0 (one process: it prints)."""
    x = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    fn = lambda c: c.sum(axis=1) * 2.0
    np.testing.assert_array_equal(misc.batch_run(fn, x, 4),
                                  jmisc.batch_run(fn, x, 4))
    outs = misc.batch_run(fn, x, 4, to_numpy=False)
    assert [len(o) for o in outs] == [4, 4, 2]
    got = misc.batch_run_grad(lambda c: (c ** 2).sum(dim=1), x, 4)
    want = jmisc.batch_run_grad(lambda c: (c ** 2).sum(axis=1), x, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, 2 * np.linalg.norm(x, axis=1), rtol=1e-6)
    net = torch.nn.Linear(3, 2)
    want = jmisc.weight_norm({k: v.detach().numpy()
                              for k, v in net.state_dict().items()})
    state = net.state_dict()
    for params in (net, state, [v.numpy() for v in state.values()]):
        assert misc.weight_norm(params) == pytest.approx(want, rel=1e-6)
    misc.mkdir_p(str(tmp_path / "a" / "b"))
    misc.mkdir_p(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    misc.print0("hello", 3)
    assert capsys.readouterr().out == "hello 3\n"


def test_phase_timer_and_trace(tmp_path):
    """PhaseTimer's summary keys and means, as JAX's; trace_if writes a
    torch.profiler trace into its directory and does nothing without
    one."""
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("sample", block_on=torch.zeros(1)):
            pass
    with timer.phase("update"):
        pass
    summ = timer.summary()
    assert sorted(summ) == ["time/sample_ms_", "time/update_ms_"]
    assert timer.counts["sample"] == 3 and all(v >= 0 for v in summ.values())
    timer.reset()
    assert timer.summary() == {}
    with profiling.trace_if(None):
        pass
    with profiling.trace_if(str(tmp_path)):
        torch.ones(4).sum()
    assert any(n.endswith(".json") for n in os.listdir(tmp_path))
