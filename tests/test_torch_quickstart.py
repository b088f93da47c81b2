"""The port's quickstart and ``run_lm --zero``'s state breakdown on the
CPU, against the JAX package's analytic wire bytes and its example's
breakdown line; ``run_lm --fsdp`` on a small model."""
import re

import jax
import pytest
import torch

from repro.core.compressor import SyncConfig as JaxSyncConfig
from repro.core.compressor import wire_bytes_per_step
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import build_model as jax_build_model
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.train import quickstart, run_lm


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The models here are small: two threads do, and the other test
    workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart_prints_the_reference_wire_bytes(capsys):
    """Two steps of each run on the CPU: finite losses, and the printed
    bytes a rank a step equal the reference's ``wire_bytes_per_step`` of
    the example's config (the reference's sync pins impl="ref", which
    changes no shape)."""
    quickstart.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    finals = re.findall(r"final loss ([\d.]+) \| wire bytes/step: [\d.]+ MB "
                        r"\(([\d.]+) B", out)
    assert len(finals) == 2
    cfg = quickstart.CFG
    jcfg = JaxModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "max_seq_len")})
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    for (loss, wire), (_, sync) in zip(finals, quickstart.SYNCS):
        assert 0 < float(loss) < 20
        jsync = JaxSyncConfig(**{f: getattr(sync, f) for f in (
            "mode", "k_per_bucket", "bucket_size", "algorithm", "qsgd_bits",
            "min_sparse_size")})
        ref = wire_bytes_per_step(shapes, jsync, p=quickstart.DP)
        assert wire == f"{ref['sparcml_bytes']:.1f}"


def test_run_lm_zero_prints_the_state_breakdown(capsys):
    """``run_lm --fast --zero --device cpu --steps 2`` prints the example's
    per-device state line, with the reference's keys, before training."""
    run_lm.main(["--fast", "--zero", "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("zero: per-device state "))
    keys = re.findall(r"(\w+)=[\d.]+MB", line)
    assert keys == ["params", "opt_mu", "opt_nu", "ef_residual", "inflight",
                    "total"]
    vals = dict(re.findall(r"(\w+)=([\d.]+)MB", line))
    assert float(vals["total"]) == pytest.approx(
        sum(float(v) for k, v in vals.items() if k != "total"), abs=0.35)


def test_run_lm_fsdp_trains_and_prints_the_state_breakdown(capsys,
                                                          monkeypatch):
    """``run_lm --fsdp`` on a two-layer model (run_lm's lm_config
    replaced): dense sync with ZeRO-3 over run_lm's 4 stacked ranks
    prints its state line (the 4 ranks' shards: a params copy, f32
    moments of its size, no residuals) and trains two finite steps."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      max_seq_len=64, dtype=torch.float32,
                      param_dtype=torch.float32)
    data = DataConfig(global_batch=8, seq_len=16, vocab_size=256)
    monkeypatch.setattr(run_lm, "lm_config", lambda fast: (cfg, data))
    log = run_lm.main(["--fsdp", "--device", "cpu", "--steps", "2"])
    assert len(log.losses) == 2
    assert all(0 < x < 20 for x in log.losses)
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("fsdp: per-device state "))
    vals = dict(re.findall(r"(\w+)=([\d.]+)MB", line))
    assert list(vals) == ["params", "opt_mu", "opt_nu", "ef_residual",
                          "inflight", "total"]
    assert vals["params"] == vals["opt_mu"] == vals["opt_nu"]
    assert float(vals["ef_residual"]) == float(vals["inflight"]) == 0.0
