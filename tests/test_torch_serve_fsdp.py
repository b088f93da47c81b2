"""Serving with the params held as fsdp shards (``build_serve_step`` /
``build_prefill(fsdp=True)``) against the port's replicated serving and
the JAX package's ``fsdp=True`` forms, and the dry run's fsdp serve
cells, on the CPU.

* llama3-405b's and dbrx-132b's smoke configs (a dense model and a MoE
  one), the reference's weights through ``params_from_jax``: a prefill
  of 4 prompts of 8 tokens and 3 decode steps on fixed tokens over
  ``StackedCollectives(2)`` and ``(4)`` are bit-equal to ``fsdp=False``
  (logits and caches: the gathers are exact), and match the reference's
  ``fsdp=True`` forms on its 2 x 1 CPU mesh at the model parity
  tolerance (rtol 1e-5, a floor of 1e-5 of the largest magnitude).
* At most one layer is gathered at once: every tensor the gather hook
  (``train_step.gather_leaf``) returns is watched until it is freed, and
  the bytes alive at once never exceed the largest unit the step gathers
  (a layer, the shared block or the head), while every sharded leaf is
  gathered.
* The dry run counts llama3-405b's decode_32k under fsdp (a rank's
  shards, the cache of its rows, one gathered layer, the gathered bytes
  as the collective term) and internlm2-20b's replicated, as the
  reference's ``_fits_replicated`` splits them; ``--skip-existing``
  reuses a written cell, as the reference's does.

Two threads, as the other CPU-heavy files pin.
"""
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro import configs as jc
from repro.launch import dryrun as jax_dryrun
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import build_prefill as jax_build_prefill
from repro.serve.engine import build_serve_step as jax_build_serve_step
from repro_torch import configs as tc
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.launch import dryrun
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, init_params
from repro_torch.serve.engine import build_prefill, build_serve_step
from repro_torch.train import train_step as ts

ARCHS = ("llama3-405b", "dbrx-132b")
B, S, CACHE, STEPS = 4, 8, 16, 3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(vocab: int):
    rng = np.random.default_rng(0)
    return (rng.integers(0, vocab, (B, S), dtype=np.int32),
            rng.integers(0, vocab, (STEPS, B, 1), dtype=np.int32))


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """(arch, the reference's params as numpy, its logits: the prefill's,
    then each decode step's, (1 + STEPS, B, V)) under fsdp=True."""
    arch = request.param
    jcfg = jc.smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    mesh = compat.make_mesh((2, 1), ("data", "model"),
                            devices=jax.devices()[:2])
    prompts, toks = _inputs(jcfg.vocab_size)
    pre, _ = jax_build_prefill(jmodel, mesh, CACHE, batch_size=B, fsdp=True)
    step, _ = jax_build_serve_step(jmodel, mesh, batch_size=B,
                                   cache_len=CACHE, fsdp=True)
    with mesh:
        logits, state = pre(params, {"tokens": jnp.asarray(prompts)})
        seen = [np.asarray(logits)]
        for t in toks:
            logits, state = step(params, state, jnp.asarray(t))
            seen.append(np.asarray(logits))
    return arch, jax.tree.map(np.asarray, params), np.stack(seen)


def _serve(model, params, fsdp=False, coll=None):
    """(logits (1 + STEPS, B, V), k cache, v cache) of the port."""
    prompts, toks = _inputs(model.cfg.vocab_size)
    pre = build_prefill(model, CACHE, fsdp=fsdp, coll=coll)
    step = build_serve_step(model, CACHE, fsdp=fsdp, coll=coll)
    logits, state = pre(params, {"tokens": torch.from_numpy(prompts)})
    seen = [logits]
    for t in toks:
        logits, state = step(params, state, torch.from_numpy(t))
        seen.append(logits)
    return torch.stack(seen), state.kv.k, state.kv.v


def _shards(model, params, p: int):
    coll = StackedCollectives(p, device="cpu")
    return coll, ts.shard_params(params, ts.fsdp_layout_of(model, p),
                                 ts.held_ranks(coll, p))


def test_fsdp_serving_matches_replicated_and_reference(reference):
    arch, jparams, want = reference
    model = build_model(tc.smoke_config(arch))
    params = params_from_jax(jparams)
    logits, k, v = _serve(model, params)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    for p in (2, 4):
        coll, held = _shards(model, params, p)
        got = _serve(model, held, fsdp=True, coll=coll)
        for a, b in zip(got, (logits, k, v)):
            assert torch.equal(a, b), (arch, p)
    with pytest.raises(ValueError, match="needs coll"):
        build_serve_step(model, CACHE, fsdp=True)
    with pytest.raises(ValueError, match="fsdp=True"):
        build_prefill(model, CACHE, coll=coll)


def test_fsdp_serving_gathers_one_layer_at_a_time(monkeypatch):
    arch = "llama3-405b"
    cfg = tc.smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    layout = ts.fsdp_layout_of(model, 2)
    unit = dryrun.gathered_unit_bytes(params, layout, cfg)
    coll, held = _shards(model, params, 2)
    live, seen = [0], {"peak": 0, "total": 0}
    gather = ts.gather_leaf

    def watched(x, lay, coll, lead=0):
        out = gather(x, lay, coll, lead)
        if lay.dim is not None:
            n = out.numel() * out.element_size()
            live[0] += n
            seen["total"] += n
            seen["peak"] = max(seen["peak"], live[0])
            weakref.finalize(out, lambda: live.__setitem__(0, live[0] - n))
        return out

    monkeypatch.setattr(ts, "gather_leaf", watched)
    prompts, toks = _inputs(cfg.vocab_size)
    pre = build_prefill(model, CACHE, fsdp=True, coll=coll)
    _, state = pre(held, {"tokens": torch.from_numpy(prompts)})
    sharded = sum(x.numel() * x.element_size() for x, lay in zip(
        ts.tree_flatten(params)[0], ts.tree_flatten(layout)[0])
        if lay.dim is not None)
    assert seen["total"] == sharded        # each sharded leaf, once
    seen["total"] = 0
    step = build_serve_step(model, CACHE, fsdp=True, coll=coll)
    step(held, state, torch.from_numpy(toks[0]))
    assert seen["total"] == sharded
    # a layer is much less than the whole: the bound is not vacuous
    assert 0 < seen["peak"] <= unit < sharded / 4


def test_dry_run_counts_serving_under_fsdp_where_params_do_not_fit():
    for arch in ("llama3-405b", "internlm2-20b"):
        assert dryrun.fits_replicated(tc.get_config(arch)) == \
            jax_dryrun._fits_replicated(jc.get_config(arch)), arch
    rec = dryrun.run_cell("llama3-405b", "decode_32k", 2, layers=2)
    assert rec["status"] == "ok" and rec["fsdp"] is True
    cfg = dryrun._cfg_for("llama3-405b", "decode_32k", 2)
    model = build_model(cfg)
    meta = init_params(cfg, device="meta")
    layout = ts.fsdp_layout_of(model, 2)
    shards = dryrun._nbytes(ts.shard_params(meta, layout, [0]))
    assert rec["state_memory"]["params"] == shards < dryrun._nbytes(meta)
    assert rec["rows"] == 64
    state = model.init_decode_state(64, 32768, device="meta")
    assert rec["state_memory"]["cache"] == dryrun._nbytes(state)
    assert rec["gathered_layer"] == dryrun.gathered_unit_bytes(meta, layout,
                                                               cfg)
    assert rec["roofline"]["t_collective_s"] > 0
    rec = dryrun.run_cell("internlm2-20b", "decode_32k", 2, layers=1)
    assert rec["status"] == "ok" and rec["fsdp"] is False
    assert rec["roofline"]["t_collective_s"] == 0


def test_dry_run_skip_existing_reuses_a_written_cell(tmp_path, monkeypatch,
                                                     capsys):
    args = ["--arch", "internlm2-20b", "--shape", "decode_32k", "--layers",
            "1", "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    path = dryrun.cell_path(str(tmp_path), "internlm2-20b", "decode_32k", 2)
    with open(path) as f:
        written = json.load(f)

    def refuse(*a, **k):
        raise AssertionError("a cached cell ran again")

    monkeypatch.setattr(dryrun, "run_cell", refuse)
    capsys.readouterr()
    assert dryrun.main(args + ["--skip-existing"]) == 0
    assert "cached, skipping" in capsys.readouterr().out
    with open(path) as f:
        assert json.load(f) == written
