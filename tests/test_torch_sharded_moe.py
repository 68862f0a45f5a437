"""Expert parallelism of the port's sharded steps on CPU ranks over gloo,
fp32: both dispatches, both cuts of the expert banks, and capacity drops.

One world of 4 ranks (separate processes, joined through a ``FileStore``
under the test's temporary directory) runs each case of ``CASES``: a
smoke config of qwen2-moe (4 routed experts top-2 and a shared expert)
or qwen3-moe (4 routed top-2, no shared), with ``moe_impl`` "einsum" or
"gather", on

* 2 x 2, where the 4 experts divide "model": expert parallelism, the
  banks' spec ``("model", "data", None)``, 2 experts a rank;
* 1 x 4 with 6 experts, which "model" does not divide: the per-expert
  tensor-parallel fallback, ``(None, "data", "model")``, every expert
  over 16 of its 64 ff columns.

Every case runs at the capacity floor: ``capacity_factor`` 0.25 gives
64 x 2 x 0.25 / E < 32 slots, so ``_capacity`` = 32 at S = 64, and the
router's first two columns are set to +20 v and -20 v (v its first
column), so that every token's first choice is expert 0 or expert 1
and one of them overflows its 32 slots in every row. Each case trains
2 steps of ``make_train_step`` (batch 4 x 64), then prefills a 4 x 64
prompt (``max_len`` 72) and serves 4 steps fed the unsharded run's
greedy tokens. Held against the port's unsharded steps on the same
weights:

* loss, ce, aux and the gradient norm of each step to 1e-5 relative;
  every step-1 gradient leaf, the router's among them, to 1e-5 of the
  leaf's largest magnitude (``test_torch_sharded``'s limits);
* each rank's prefill and decode logits within 1e-5 of the largest
  logit, its greedy tokens equal;
* the dropped (token, choice) pairs: more than 0, and each rank's
  count, summed over the ranks, the unsharded count times the ranks
  that route the same rows to the same experts (1 by expert, "model"
  under the fallback);

and the two dispatches' sharded runs against each other, and the
fallback's spec taken.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as PT
from repro_torch.runtime import data as pdata
from repro_torch.runtime import optim as poptim
from repro_torch.runtime.trainstep import make_train_step
from repro_torch.weights import from_jax_params, seeded_flat, to_flat
from test_torch_sharded import _env, _leaf_err, _rel

WORLD = 4
BATCH, SEQ, STEPS, MAX_LEN, DECODE = 4, 64, 2, 72, 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
TOL = 1e-5
METRICS = ("loss", "ce", "aux", "grad_norm")
# (name, arch, experts, mesh); each runs under both dispatches
CUTS = (("ep", "qwen3_moe_235b_a22b", 4, (2, 2)),
        ("ep", "qwen2_moe_a2_7b", 4, (2, 2)),
        ("fallback", "qwen2_moe_a2_7b", 6, (1, 4)),
        ("fallback", "qwen3_moe_235b_a22b", 6, (1, 4)))
IMPLS = ("einsum", "gather")
CASES = [(f"{cut}-{arch}-{impl}", arch, n, mesh, impl)
         for cut, arch, n, mesh in CUTS for impl in IMPLS]


def case_config(arch: str, experts: int, impl: str):
    cfg = get_config(arch).smoke()
    return replace(cfg, moe_impl=impl, moe=replace(
        cfg.moe, n_experts=experts, capacity_factor=0.25))


def case_weights(cfg) -> dict:
    """``seeded_flat`` with every router's first two columns +20 v and
    -20 v: one of experts 0 and 1 is every token's first choice."""
    flat = seeded_flat(cfg, 0)
    for k, w in flat.items():
        if k.endswith("moe/router"):
            v = w[..., 0].copy()
            w[..., 0], w[..., 1] = 20 * v, -20 * v
    return flat


class DropTap:
    """Inside ``with``: the (token, choice) pairs each MoE call drops,
    counted over the experts it computes (``moe._assign`` wrapped)."""

    def __enter__(self):
        self.orig, self.drops = M._assign, 0

        def tapped(logits, cfg, capacity, experts=None):
            out = self.orig(logits, cfg, capacity, experts)
            lo, hi = experts or (0, logits.shape[-1])
            top_idx, keep = out[0], out[2]
            self.drops += int(((top_idx >= lo) & (top_idx < hi)
                               & ~keep).sum())
            return out
        M._assign = tapped
        return self

    def __exit__(self, *exc):
        M._assign = self.orig


# one rank of the world: every case's training and serving, its drops,
# its rows' logits; rank 0 writes the gathered gradients
RANK = textwrap.dedent('''
    import json, sys
    import numpy as np, torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import (make_prefill_step,
                                               make_serve_step,
                                               make_train_step)
    from repro_torch.sharding.rules import (ShardCtx, gather_params,
                                            shard_params)
    from repro_torch.weights import from_jax_params, to_flat
    from test_torch_sharded_moe import (CASES, DropTap, MAX_LEN,
                                        case_config)

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    mesh_lib.init_world(rank, world, f"{tmp}/store", device="cpu")
    oc = optim.AdamWConfig(**json.load(open(f"{tmp}/opt.json")))
    out = {}
    for name, arch, experts, (data, model), impl in CASES:
        mesh = mesh_lib.make_debug_mesh(data, model, device="cpu")
        cfg = case_config(arch, experts, impl)
        inp = np.load(f"{tmp}/{name}.npz")
        flat = {k[2:]: inp[k] for k in inp.files if k.startswith("p|")}
        full = from_jax_params(flat, cfg, device="cpu", dtype=torch.float32)
        local = shard_params(full, mesh)
        out[f"{name}/spec"] = list(map(str,
                                       local.layers[0].moe.w_gate.shard_spec))
        local.requires_grad_(True)
        opt = optim.init(local)
        step = make_train_step(cfg, oc, mesh)
        with DropTap() as tap:
            for i in range(2):
                batch = {k: inp[f"b{i}|{k}"] for k in ("tokens", "labels")}
                local, opt, m = step(local, opt, batch)
                out.update({f"{name}/m{i}/{k}": float(v)
                            for k, v in m.items()})
                if i == 0:
                    grads = to_flat(gather_params(local, grad=True))
        out[f"{name}/train_drops"] = tap.drops
        if rank == 0:
            np.savez(f"{tmp}/grads_{name}.npz", **grads)
        serving = shard_params(full, mesh)
        prompt = torch.from_numpy(inp["prompt"])
        b, s = prompt.shape
        with DropTap() as tap:
            logits, cache, clen = make_prefill_step(
                cfg, max_len=MAX_LEN, mesh=mesh)(serving, {"tokens": prompt})
            got = [logits.numpy()]
            srv = make_serve_step(cfg, mesh)
            for i, tok in enumerate(inp["fed"]):
                logits, cache, clen = srv(serving, cache, tok,
                                          np.full((b,), s + i, np.int32))
                got.append(logits.numpy())
        out[f"{name}/serve_drops"] = tap.drops
        rows = ShardCtx(mesh, batch=b).rows(torch.arange(b))
        np.savez(f"{tmp}/r{rank}_{name}.npz", rows=rows.numpy(),
                 logits=np.stack(got))
    torch.distributed.destroy_process_group()
    json.dump(out, open(f"{tmp}/out{rank}.json", "w"))
''')


def unsharded_case(cfg, flat, batches, prompt):
    """The port's unsharded steps on one case: (metrics per step, the
    step-1 gradients, train drops, fed tokens, logits (steps + 1, B, V),
    serve drops)."""
    model = from_jax_params(flat, cfg, device="cpu", dtype=torch.float32)
    serving = from_jax_params(flat, cfg, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    opt = poptim.init(model)
    step = make_train_step(cfg, poptim.AdamWConfig(**OPT))
    hist = []
    with DropTap() as tap:
        for i, b in enumerate(batches):
            model, opt, m = step(model, opt, b)
            hist.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads = to_flat(model, grad=True)
    train_drops = tap.drops
    with DropTap() as tap, torch.no_grad():
        logits, cache, clen = PT.prefill(serving, torch.from_numpy(prompt),
                                         max_len=MAX_LEN)
        fed, out = [], [logits.numpy()]
        for _ in range(DECODE):
            tok = logits.argmax(-1).to(torch.int32)
            fed.append(tok.numpy())
            logits, cache, clen = PT.decode_step(serving, tok, cache, clen)
            out.append(logits.numpy())
    return {"hist": hist, "grads": grads, "train_drops": train_drops,
            "fed": np.stack(fed), "logits": np.stack(out),
            "serve_drops": tap.drops}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write each case's weights, batches and fed tokens, run the world,
    and the unsharded cases here while it runs."""
    tmp = tmp_path_factory.mktemp("moe_world")
    (tmp / "opt.json").write_text(json.dumps(OPT))
    here = {}
    for name, arch, experts, _, impl in CASES:
        cfg = case_config(arch, experts, impl)
        flat = case_weights(cfg)
        gen = pdata.lm_batches(BATCH, SEQ, cfg.vocab_size, seed=0)
        batches = [next(gen) for _ in range(STEPS)]
        prompt = np.random.RandomState(5).randint(
            0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            here[name] = unsharded_case(cfg, flat, batches, prompt)
        finally:
            torch.use_deterministic_algorithms(det)
        arrays = {f"p|{k}": v for k, v in flat.items()}
        for i, b in enumerate(batches):
            arrays.update({f"b{i}|{k}": v for k, v in b.items()})
        np.savez(tmp / f"{name}.npz", prompt=prompt, fed=here[name]["fed"],
                 **arrays)
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([env["PYTHONPATH"],
                                         str(Path(__file__).parent)])
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(WORLD), str(tmp)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    out = [json.loads((tmp / f"out{r}.json").read_text())
           for r in range(WORLD)]
    return {"out": out, "tmp": tmp, "here": here}


def _rank_logits(world, name):
    for r in range(WORLD):
        got = np.load(world["tmp"] / f"r{r}_{name}.npz")
        yield got["rows"], got["logits"]


def _scaled_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name,arch,experts,mesh,impl", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_moe_matches_unsharded(world, name, arch, experts, mesh,
                                       impl):
    want, out = world["here"][name], world["out"]
    for i, m in enumerate(want["hist"]):
        for k in METRICS:
            assert _rel(out[0][f"{name}/m{i}/{k}"], m[k]) < TOL, (i, k)
    got = dict(np.load(world["tmp"] / f"grads_{name}.npz"))
    assert set(got) == set(want["grads"])
    assert _leaf_err(got, want["grads"]) < TOL
    routers = [k for k in got if k.endswith("moe/router")]
    assert routers and _leaf_err({k: got[k] for k in routers},
                                 {k: want["grads"][k] for k in routers}) < TOL
    seen = set()
    for rows, logits in _rank_logits(world, name):
        ref = want["logits"][:, rows]
        assert _scaled_err(logits, ref) < TOL
        assert np.array_equal(logits.argmax(-1), ref.argmax(-1))
        seen.update(rows.tolist())
    assert seen == set(range(BATCH))
    # every (row, choice) is routed on the ranks that hold its row and
    # its expert: one by expert, all "model" ranks under the fallback
    copies = mesh[1] if experts % mesh[1] else 1
    for kind in ("train_drops", "serve_drops"):
        assert want[kind] > 0, kind
        assert sum(o[f"{name}/{kind}"] for o in out) == copies * want[kind]
    spec = out[0][f"{name}/spec"]
    assert spec == (["None", "data", "model"] if experts % mesh[1]
                    else ["model", "data", "None"])


@pytest.mark.parametrize("cut", sorted({c[0].rsplit("-", 1)[0]
                                        for c in CASES}))
def test_dispatches_agree_under_the_mesh(world, cut):
    """The einsum and gather dispatches' sharded runs: the same metrics,
    logits and drops."""
    a, b = (f"{cut}-{impl}" for impl in IMPLS)
    for o in world["out"]:
        for k in ("train_drops", "serve_drops"):
            assert o[f"{a}/{k}"] == o[f"{b}/{k}"]
    for i in range(STEPS):
        for k in METRICS:
            assert _rel(world["out"][0][f"{a}/m{i}/{k}"],
                        world["out"][0][f"{b}/m{i}/{k}"]) < TOL, (i, k)
    for (_, la), (_, lb) in zip(_rank_logits(world, a),
                                _rank_logits(world, b)):
        assert _scaled_err(la, lb) < TOL
        assert np.array_equal(la.argmax(-1), lb.argmax(-1))


def test_the_fallback_spec_is_the_reference_rule():
    """The rules' own choice for the cases' banks on their meshes."""
    from repro_torch.sharding.rules import spec_for
    assert spec_for("scan/0/moe/w_gate", (1, 6, 256, 64),
                    {"data": 1, "model": 4}, stacked=True) == (
        None, None, "data", "model")
    assert spec_for("scan/0/moe/w_down", (1, 6, 64, 256),
                    {"data": 1, "model": 4}, stacked=True) == (
        None, None, "model", "data")
    assert spec_for("scan/0/moe/w_gate", (1, 4, 256, 64),
                    {"data": 2, "model": 2}, stacked=True) == (
        None, "model", "data", None)
    # the capacity floor the cases run at
    cfg = case_config("qwen2_moe_a2_7b", 4, "einsum")
    assert M._capacity(SEQ, cfg) == 32
    assert M._capacity(SEQ, get_config("qwen2_moe_a2_7b").smoke()) == 128
