"""Training parity of the port with the reference, on a tiny hybrid
RecurrentGemma config in fp32, and the golden training fixture the card
replays.

The config is ``recurrentgemma_9b.smoke()`` widened to the full period
(rglru, rglru, attn_local) at five layers (one scanned period and a
remainder of two rglru layers), d_model 64, 4 query heads over 1 KV
head, d_ff 128, vocabulary 512, window 8, attention blocks of 8, and
sequences of 16 (so the window masks and the flash backward walks two
blocks). The reference runs its XLA path: its Pallas kernels have no
gradient (``jax.grad`` through ``rglru_scan`` raises), so the port's
training, through its kernels' plain versions here and the kernels on
the card, is held against the associative scan and
``flash_attention_xla``'s custom-VJP backward.

Tolerances, each from the errors measured on the CPU (in brackets):

* forward logits (``train=False``) against both JAX paths (XLA, and the
  Pallas kernels in interpret mode): 2e-5 [1.5e-6 XLA, 9.1e-7 Pallas];
* per-step loss of ``make_train_step`` with 2 microbatches, relative:
  1e-6 [7.7e-8]; the gradient norm, relative: 1e-5 [1.1e-6];
* step-1 gradients: 1e-5 of each leaf's largest magnitude [2.6e-6];
* params after 2 AdamW steps: 1e-4 absolute, a tenth of lr = 1e-3
  [3.3e-5]. AdamW moves an element by m / (sqrt(v) + eps) * lr, so
  where a gradient is of the order of eps = 1e-8 (measured: gradients
  of 1e-9 to 4e-7 whose two computations differ in their second
  digit), rounding noise in the gradient moves the update by a
  fraction of lr; every other element agrees to 1e-6.

``src/repro_torch/testdata/golden_train.npz`` holds JAX's params, the
two ``lm_batches`` batches, the per-step losses and gradient norms, the
step-1 gradients, the params after 2 steps and the forward logits.
``test_golden_train_fixture_matches_jax`` recomputes it; the card has
no JAX, and ``chip_smoke.py`` replays it through the kernels.
Regenerate with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py
"""
from __future__ import annotations

import json
import math
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.recurrentgemma_9b import CONFIG as JRG
from repro.models import transformer as T
from repro.runtime import checkpoint as jckpt
from repro.runtime import data as jdata
from repro.runtime import optim as joptim
from repro.runtime.trainstep import make_train_step as jmake_train_step
from repro_torch.configs.recurrentgemma_9b import CONFIG as PRG
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as PT
from repro_torch.runtime import checkpoint as pckpt
from repro_torch.runtime import data as pdata
from repro_torch.runtime import optim as poptim
from repro_torch.runtime.trainstep import make_train_step
from repro_torch.weights import from_jax_params, to_flat
from test_torch_golden import flat_params, unflatten

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_train.npz")
TINY_KW = dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
               d_ff=128, vocab_size=512, window=8,
               layer_pattern=("rglru", "rglru", "attn_local"))
JCFG = replace(JRG.smoke(), **TINY_KW)
PCFG = replace(PRG.smoke(), **TINY_KW)
BATCH, SEQ, MICRO, STEPS, LR = 4, 16, 2, 2, 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=STEPS)
TOL_LOGITS, TOL_LOSS, TOL_GRAD, TOL_PARAMS = 2e-5, 1e-6, 1e-5, 1e-4


def batches():
    gen = jdata.lm_batches(BATCH, SEQ, JCFG.vocab_size, seed=0)
    return [next(gen) for _ in range(STEPS)]


def build_golden():
    """What the reference computes on the tiny config: everything the
    fixture holds, as {name: array} (one jit per function)."""
    params = T.init_params(JCFG, jax.random.PRNGKey(0))
    bs = batches()
    oc = joptim.AdamWConfig(**OPT)
    step = jax.jit(jmake_train_step(JCFG, oc, microbatches=MICRO))

    def grads_fn(p, batch):
        # make_train_step's accumulation: microbatch grads summed from
        # zeros under a scan, then scaled
        mb = jax.tree.map(lambda a: a.reshape((MICRO, -1) + a.shape[1:]),
                          batch)

        def acc(total, one):
            g = jax.grad(lambda q, b: T.loss_fn(q, JCFG, b)[0])(p, one)
            return jax.tree.map(jnp.add, total, g), None
        total, _ = jax.lax.scan(
            acc, jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p),
            mb)
        return jax.tree.map(lambda x: x * (1.0 / MICRO), total)

    arrays = {}
    for k, v in flat_params(params).items():
        arrays[f"params|{k}"] = v
    for i, b in enumerate(bs):
        arrays[f"batch{i}|tokens"] = b["tokens"]
        arrays[f"batch{i}|labels"] = b["labels"]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]
    for k, v in flat_params(jax.jit(grads_fn)(params, jb[0])).items():
        arrays[f"grads|{k}"] = v
    arrays["logits"] = np.asarray(jax.jit(
        lambda p, t: T.forward(p, JCFG, {"tokens": t}, train=False)[0])(
            params, jb[0]["tokens"]))
    opt = joptim.init(params)
    losses, norms = [], []
    p = params
    for b in jb:
        p, opt, m = step(p, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    arrays["losses"] = np.asarray(losses, np.float32)
    arrays["grad_norms"] = np.asarray(norms, np.float32)
    for k, v in flat_params(p).items():
        arrays[f"after|{k}"] = v
    arrays["meta"] = np.asarray(json.dumps({
        "config": {**TINY_KW, "layer_pattern": list(TINY_KW["layer_pattern"])},
        "opt": OPT, "microbatches": MICRO, "steps": STEPS, "batch": BATCH,
        "seq": SEQ}))
    return arrays


def section(arrays, name):
    n = len(name) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(name + "|")}


@pytest.fixture(scope="module")
def golden():
    """The reference's numbers, computed once for the module."""
    return build_golden()


def port_train(golden, cfg=PCFG):
    """The port's make_train_step (plain versions, CPU) from the
    fixture's params over its batches: (losses, grad norms, step-1
    grads, params after, model)."""
    model = from_jax_params(section(golden, "params"), cfg, device="cpu",
                            dtype=torch.float32).requires_grad_(True)
    opt = poptim.init(model)
    step = make_train_step(cfg, poptim.AdamWConfig(**OPT),
                           microbatches=MICRO)
    losses, norms, grads = [], [], None
    for i in range(STEPS):
        b = {k: golden[f"batch{i}|{k}"] for k in ("tokens", "labels")}
        model, opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None:
            grads = to_flat(model, grad=True)
    return losses, norms, grads, to_flat(model), model


def rel_leaf_err(got, want):
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want)


def test_data_batches_match_jax_package():
    for name in ("lm_batches", "copy_task_batches"):
        a = getattr(jdata, name)(3, 16, 97, seed=5)
        b = getattr(pdata, name)(3, 16, 97, seed=5)
        for _ in range(3):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
                assert x[k].dtype == y[k].dtype


def test_forward_logits_match_jax_xla_and_pallas(golden):
    """``forward(train=False)`` logits against the reference's XLA path
    (from the fixture's computation) and its Pallas kernels (the flash
    and scan kernels in interpret mode)."""
    model = from_jax_params(section(golden, "params"), PCFG, device="cpu",
                            dtype=torch.float32)
    tokens = golden["batch0|tokens"]
    with torch.no_grad():
        got = PT.forward(model, PCFG, {"tokens": torch.from_numpy(tokens)},
                         train=False)[0].numpy()
    params = unflatten(section(golden, "params"))
    pallas = jax.jit(lambda p, t: T.forward(
        p, replace(JCFG, attn_impl="pallas"), {"tokens": t},
        train=False)[0])(params, jnp.asarray(tokens))
    for want in (golden["logits"], np.asarray(pallas)):
        np.testing.assert_allclose(got, want, rtol=TOL_LOGITS,
                                   atol=TOL_LOGITS)


def test_train_step_matches_jax(golden):
    """Two steps of ``make_train_step`` with 2 microbatches: loss and
    gradient norm per step, every step-1 gradient leaf, and every param
    after the second AdamW step; the kernels' counters stay at 0 on
    CPU tensors."""
    before = (fa_ops.flash_attention.launches,
              scan_ops.rglru_scan_fwd.launches,
              scan_ops.rglru_scan_bwd.launches)
    losses, norms, grads, after, _ = port_train(golden)
    assert before == (fa_ops.flash_attention.launches,
                      scan_ops.rglru_scan_fwd.launches,
                      scan_ops.rglru_scan_bwd.launches)
    np.testing.assert_allclose(losses, golden["losses"], rtol=TOL_LOSS)
    np.testing.assert_allclose(norms, golden["grad_norms"], rtol=TOL_GRAD)
    want_g = section(golden, "grads")
    assert sorted(grads) == sorted(want_g)
    assert rel_leaf_err(grads, want_g) <= TOL_GRAD
    want_p = section(golden, "after")
    assert sorted(after) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(after[k], want_p[k], rtol=0,
                                   atol=TOL_PARAMS, err_msg=k)


def test_remat_gives_the_same_gradients(golden):
    """Each scanned period under ``torch.utils.checkpoint`` (remat on)
    gives the gradients of the plain stack (remat off)."""
    b = {k: torch.from_numpy(golden[f"batch0|{k}"])
         for k in ("tokens", "labels")}
    grads = {}
    for remat in (False, True):
        cfg = replace(PCFG, remat=remat)
        model = from_jax_params(section(golden, "params"), cfg,
                                device="cpu",
                                dtype=torch.float32).requires_grad_(True)
        PT.loss_fn(model, cfg, b)[0].backward()
        grads[remat] = to_flat(model, grad=True)
    assert rel_leaf_err(grads[True], grads[False]) <= 1e-6


def test_checkpoints_cross_between_packages(golden, tmp_path):
    """A checkpoint written by either package restores in the other."""
    flat = section(golden, "params")
    model = from_jax_params(flat, PCFG, device="cpu", dtype=torch.float32)
    pckpt.save(str(tmp_path / "port"), model, meta={"arch": PCFG.name})
    template = T.init_params(JCFG, jax.random.PRNGKey(1))
    got = flat_params(jckpt.restore(str(tmp_path / "port"), template))
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    assert jckpt.load_meta(str(tmp_path / "port")) == {"arch": PCFG.name}

    jckpt.save(str(tmp_path / "jax"), unflatten(flat), meta={"steps": 3})
    blank = PT.Transformer(PCFG, device="cpu", dtype=torch.float32)
    back = to_flat(pckpt.restore(str(tmp_path / "jax"), blank))
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert pckpt.load_meta(str(tmp_path / "jax")) == {"steps": 3}
    assert sorted(pckpt.load_flat(str(tmp_path / "jax"))) == sorted(flat)


def test_golden_train_fixture_matches_jax(golden):
    """The committed fixture is what the reference computes now (1e-6:
    XLA's CPU code may round the last bit differently on another CPU)."""
    data = np.load(GOLDEN)
    assert sorted(data.files) == sorted(golden)
    assert json.loads(str(data["meta"])) == json.loads(str(golden["meta"]))
    for k in golden:
        if k != "meta":
            np.testing.assert_allclose(data[k], golden[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert GOLDEN.stat().st_size < 4 << 20


def test_train_cli_runs_on_cpu_and_copy_loss_falls(capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` prints
    the reference's step lines; ``run`` on the copy task with one
    repeated batch (as the card's full-width run trains) lowers the
    loss at every step."""
    out = ptrain.main(["--arch", "recurrentgemma_9b", "--smoke", "--device",
                       "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                       "--log-every", "1"])
    assert len(out["metrics"]) == 3
    assert all(math.isfinite(m["loss"]) for m in out["metrics"])
    printed = capsys.readouterr().out
    assert printed.count("step ") == 3 and "gnorm" in printed
    run = ptrain.run(PCFG, steps=4, batch=2, seq=16, microbatches=2,
                     data_name="copy", repeat=True, device="cpu")
    losses = [m["loss"] for m in run["metrics"]]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **build_golden())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
