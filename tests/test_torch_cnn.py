"""The paper's CNN actor graphs in the port (``repro_torch.models.cnn``)
against the reference's (``repro.models.cnn``) on the CPU, in fp32.

Both graphs are built from the same seed, so they draw the same weights
and, at each Input firing, the same image from one numpy generator; the
Simulator fires both for two frames and every actor's every output is
compared: the vehicle classifier at 96 x 96, the dual-input graph at 32
and SSD-Mobilenet at 96 (the reference's own CPU size), within atol
1e-5 and rtol 1e-4 (fp32 convolutions summed in another order).

The one exception, stated up front: NMS keeps the 10 highest scores, and
where two candidates' scores lie within that tolerance of each other the
two frameworks may rank them either way. So the indices NMS picks, taken
from each side's own NMS input, must be equal, except at positions where
the two picks' scores are within the tolerance; at such a frame NMS's
and the Tracker's outputs are not compared value by value. Structure
(ports, token shapes and bytes, FIFOs, costs, pinned unit times) is
compared exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import Simulator as RefSimulator
from repro.models import cnn as RC
from repro_torch.core import Simulator
from repro_torch.models import cnn as TC

ATOL, RTOL = 1e-5, 1e-4
FRAMES = 2
CASES = {"vehicle": ("vehicle_graph", dict(input_hw=96)),
         "dual_input": ("dual_input_vehicle_graph", dict(input_hw=32)),
         "ssd": ("ssd_mobilenet_graph", dict(input_hw=96))}


def _record(g, to_np):
    """Wrap every actor's fire function to keep, per actor, each firing's
    outputs as numpy arrays."""
    rec = {}
    for a in g.actors.values():
        def fire(inputs, st, atr, _f=a.fire_fn, _n=a.name):
            out, st = _f(inputs, st, atr)
            rec.setdefault(_n, []).append(
                {p: [to_np(t) for t in ts] for p, ts in out.items()})
            return out, st
        a.fire_fn = fire
    return rec


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    name, kw = CASES[request.param]
    ref_g = getattr(RC, name)(**kw)
    port_g = getattr(TC, name)(**kw, device="cpu")
    ref = _record(ref_g, np.asarray)
    port = _record(port_g, lambda t: t.numpy())
    RefSimulator(ref_g).run(FRAMES)
    Simulator(port_g).run(FRAMES)
    return request.param, ref_g, port_g, ref, port


def _nms_top(conf: np.ndarray):
    """NMS's picks from its conf input: the stable top 10 of 1 - p0."""
    p = np.exp(conf - conf.max(-1, keepdims=True))
    score = 1.0 - p[:, 0] / p.sum(-1)
    return np.argsort(-score, kind="stable")[:10], score


def _nms_frames_to_compare(ref, port):
    """Per frame: whether NMS's picks agree (then NMS and the Tracker are
    compared by value); where they do not, each differing pick must be a
    near tie of the scores."""
    keep = []
    for fr, fp in zip(ref["ConcatConf"], port["ConcatConf"]):
        tr, score = _nms_top(fr["out"][0])
        tp, _ = _nms_top(fp["out"][0])
        same = np.array_equal(tr, tp)
        if not same:
            for i in np.nonzero(tr != tp)[0]:
                a, b = score[tr[i]], score[tp[i]]
                assert abs(a - b) <= ATOL + RTOL * abs(a), (i, a, b)
        keep.append(same)
    return keep


def test_every_actor_output_matches_jax(runs):
    case, _, _, ref, port = runs
    assert sorted(port) == sorted(ref)
    keep = _nms_frames_to_compare(ref, port) if case == "ssd" \
        else [True] * FRAMES
    for actor in ref:
        assert len(port[actor]) == len(ref[actor]) == FRAMES, actor
        for f, (fr, fp) in enumerate(zip(ref[actor], port[actor])):
            if actor in ("NMS", "Tracker") and not keep[f]:
                continue
            assert sorted(fp) == sorted(fr), actor
            for p in fr:
                for want, got in zip(fr[p], fp[p], strict=True):
                    assert got.shape == want.shape and \
                        got.dtype == np.float32, (actor, p)
                    np.testing.assert_allclose(got, want, atol=ATOL,
                                               rtol=RTOL,
                                               err_msg=f"{actor}.{p} #{f}")


def _ports(ps):
    return [(p.name, p.direction.name, p.lrl, p.url, tuple(p.token_shape),
             p.token_dtype, p.token_bytes) for p in ps]


def test_graph_structure_matches_jax(runs):
    """Actors, ports, token shapes and bytes, FIFOs, costs and pinned
    unit times exactly as the reference's: the Explorer prices both
    graphs alike."""
    _, ref_g, port_g, _, _ = runs
    assert list(port_g.actors) == list(ref_g.actors)
    for name, ra in ref_g.actors.items():
        pa = port_g.actors[name]
        assert (pa.actor_type.name, pa.cost_flops, pa.cost_mem_bytes) == \
            (ra.actor_type.name, ra.cost_flops, ra.cost_mem_bytes), name
        assert _ports(pa.in_ports) == _ports(ra.in_ports), name
        assert _ports(pa.out_ports) == _ports(ra.out_ports), name
        assert pa.meta == ra.meta, name
        assert (pa.init_fn is None) == (ra.init_fn is None), name
    assert [(f.name, f.capacity, f.delay_tokens, f.token_bytes)
            for f in port_g.fifos.values()] == \
        [(f.name, f.capacity, f.delay_tokens, f.token_bytes)
         for f in ref_g.fifos.values()]
    assert [a.name for a in port_g.topo_order()] == \
        [a.name for a in ref_g.topo_order()]


def test_paper_cut_and_token_sizes_full_size():
    """At the paper's sizes (SSD at 300, the vehicle graph at 96) the
    paper's cut and the Fig 2 token sizes are the reference's."""
    ssd = TC.ssd_mobilenet_graph(device="cpu")
    assert len(ssd.actors) == 35
    assert TC.partition_point_after(ssd, "DWCL9") == \
        RC.partition_point_after(RC.ssd_mobilenet_graph(), "DWCL9")
    vg = TC.vehicle_graph(device="cpu")
    assert [f.token_bytes for f in vg.fifos.values()] == \
        [110592, 294912, 73728, 400]


@pytest.mark.parametrize("hw,k,stride,groups", [
    (7, 3, 2, 1), (8, 3, 2, 1), (10, 3, 2, 4), (9, 5, 1, 1), (6, 1, 1, 1),
    (300, 3, 2, 1), (2, 3, 2, 1), (5, 3, 2, 2)])
def test_conv2d_same_padding_matches_lax(hw, k, stride, groups):
    """"SAME" at stride 2 pads the low side less than the high side when
    the total is odd, as XLA does; depthwise and grouped weights in
    HWIO."""
    rng = np.random.RandomState(hw + k + stride)
    cin, cout = 4, 8
    x = rng.standard_normal((hw, hw, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    want = np.asarray(RC.conv2d(x, w, b, stride=stride, groups=groups))
    got = TC.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride=stride, groups=groups)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw", [8, 9])
def test_maxpool_and_dense_match_jax(hw):
    rng = np.random.RandomState(hw)
    x = rng.standard_normal((hw, hw, 3)).astype(np.float32)
    np.testing.assert_array_equal(TC.maxpool2(torch.from_numpy(x)).numpy(),
                                  np.asarray(RC.maxpool2(x)))
    w = rng.standard_normal((hw * hw * 3, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    np.testing.assert_allclose(
        TC.dense(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(RC.dense(x, w, b)), atol=ATOL, rtol=RTOL)


def test_tracker_carries_its_state_on_the_device():
    """The Tracker smooths with the previous frame's track, kept as the
    actor's state tensor; a staged run fires it stateless."""
    g = TC.ssd_mobilenet_graph(input_hw=64, device="cpu")
    rec = _record(g, lambda t: t)
    out = Simulator(g).run(2).outputs["Tracker"]
    det = [f["out"][0] for f in rec["NMS"]]
    assert torch.equal(out[0], 0.7 * det[0] + 0.3 * det[0])
    assert torch.equal(out[1], 0.7 * det[1] + 0.3 * out[0])


def test_builders_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for build in (TC.vehicle_graph, TC.dual_input_vehicle_graph,
                  TC.ssd_mobilenet_graph):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_builders_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    TC.vehicle_graph(input_hw=16, device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.deterministic


def test_early_exit_example_decides_as_the_reference(capsys):
    """The port's early-exit offload example (torch fire functions, the
    reference example's numpy draws) offloads the same frames as the
    reference's: the same confidence range, decisions and traffic."""
    import runpy
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "examples"
    runpy.run_path(str(root / "early_exit_offload.py"), run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    runpy.run_path(str(root / "torch_early_exit_offload.py"),
                   run_name="example")["main"](["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    assert "analyzer: ok=True errors=[]" in port
    for prefix in ("frames:", "boundary traffic:", "every frame"):
        assert [ln for ln in port if ln.startswith(prefix)] == \
            [ln for ln in ref if ln.startswith(prefix)], prefix
    conf = [ln.split("confidence range: ")[1] for ln in ref + port
            if "confidence range" in ln]
    assert conf[0] == conf[1]
