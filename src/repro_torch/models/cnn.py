"""The paper's two experimental CNN applications as VR-PRUNE graphs, with
torch fire functions.

Counterpart of ``repro.models.cnn``: the same actors, ports, token
shapes, costs and pinned unit times, so the Explorer prices both
packages' graphs alike, and the same weights and default images.

1. **Vehicle image classification** (Fig 2, [Xie et al. 2016]): actors
   Input, L1, L2, L3, L4-L5. Input 96x96x3, two (conv 5x5x32 + ReLU +
   maxpool/2) stages, then dense 100 -> dense 100 -> dense n + softmax.
2. **SSD-Mobilenet object tracking** (Fig 3): Input, CL1, DWCL1..DWCL13,
   EL1..EL4, six (LOC, CONF) head pairs, ConcatLoc/ConcatConf, NMS,
   Tracker: 35 actors.

Layouts. Tokens are (H, W, C) tensors and weights are drawn in the
reference's HWIO shapes, as the reference's NHWC code has them; the
public ``conv2d`` takes HWIO. Inside, a (H, W, C) token is the
channels-last memory of a (1, C, H, W) tensor, so the convolution reads
it in place, with weights turned to (Cout, Cin/groups, kh, kw) once per
graph. Every conv output is handed on as a contiguous (H, W, C) token,
so ``dense`` flattens in the reference's (H, W, C) order.

``"SAME"`` padding is the reference's: a stride-2 conv over an even size
pads ``total // 2`` at the top and left and the rest at the bottom and
right, which torch's symmetric ``padding`` cannot express; such convs
pad explicitly first.

Weights and the default images come from one
``np.random.RandomState(seed)`` per graph, drawn in the reference's
order (weights while the graph is built, an image at each Input firing
without a feed), as float64 cast to float32, then moved to the device.

Each builder runs on ``device`` (default ``"cuda"``; without a card it
raises unless ``device="cpu"``) and sets TF32 off for convolutions and
products, with cuDNN's deterministic algorithms, so the fp32 graphs
compare with the reference and a partitioned run repeats a whole one bit
for bit. Convolutions may run in cuDNN: the reference leaves them to
XLA, outside any kernel of its own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import calibration as cal
from repro_torch.core.graph import Actor, ActorType, Graph, Port, PortDir
from repro_torch.models.transformer import resolve_device


def fp32_exact() -> None:
    """TF32 off for fp32 convolutions and products, and cuDNN's
    deterministic algorithms, for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


# ---------------------------------------------------------------------------
# primitive layer helpers ((H, W, C) tokens, fp32)
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights -> (Cout, Cin/groups, kh, kw), contiguous."""
    return w.permute(3, 2, 0, 1).contiguous()


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          *, stride: int = 1, padding: str = "SAME",
          groups: int = 1) -> torch.Tensor:
    """x: (H, W, Cin); w: (Cout, Cin/groups, kh, kw) -> (H', W', Cout)."""
    xn = x.permute(2, 0, 1)[None]           # channels-last (1, C, H, W)
    if padding == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[0], w.shape[2], stride),
                              _same_pads(x.shape[1], w.shape[3], stride))
    elif padding == "VALID":
        ht = hb = wl = wr = 0
    else:
        raise ValueError(f"padding {padding!r} is not 'SAME' or 'VALID'")
    if ht == hb and wl == wr:
        y = F.conv2d(xn, w, stride=stride, padding=(ht, wl), groups=groups)
    else:
        y = F.conv2d(F.pad(xn, (wl, wr, ht, hb)), w, stride=stride,
                     groups=groups)
    y = y[0].permute(1, 2, 0).contiguous()
    if b is not None:
        y = y + b
    return y


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: str = "SAME",
           groups: int = 1) -> torch.Tensor:
    """x: (H, W, Cin); w: (kh, kw, Cin/groups, Cout), the reference's
    HWIO."""
    return _conv(x, _oihw(w), b, stride=stride, padding=padding,
                 groups=groups)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, "VALID", of an (H, W, C) token."""
    return F.max_pool2d(x.permute(2, 0, 1)[None], 2, 2)[0] \
        .permute(1, 2, 0).contiguous()


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1) @ w + b


def conv_flops(h, w, cout, kh, kw, cin_per_group) -> float:
    return 2.0 * h * w * cout * kh * kw * cin_per_group


def _drawer(rng: np.random.RandomState, dev: torch.device):
    """The reference's ``jnp.asarray(draw, jnp.float32)`` of a float64
    numpy draw, on ``dev``."""
    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return f32


# ---------------------------------------------------------------------------
# Vehicle image classification CNN (Fig 2)
# ---------------------------------------------------------------------------

def vehicle_graph(num_classes: int = 4, *, seed: int = 0,
                  input_hw: int = 96, device="cuda") -> Graph:
    """Actors: Input -> L1 -> L2 -> L3 -> L4-L5 (sink). Token sizes for the
    default input_hw=96 match the paper's Fig 2 exactly."""
    dev = resolve_device(device)
    fp32_exact()
    rng = np.random.RandomState(seed)
    f32 = _drawer(rng, dev)
    hw = input_hw

    def pw(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(np.prod(shape[:-1]))
        return f32(rng.uniform(-scale, scale, shape))

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    w1, b1 = pw(5, 5, 3, 32), zeros(32)
    w2, b2 = pw(5, 5, 32, 32), zeros(32)
    h2 = hw // 4
    feat = h2 * h2 * 32
    w3, b3 = pw(feat, 100), zeros(100)
    w4, b4 = pw(100, 100), zeros(100)
    w5, b5 = pw(100, num_classes), zeros(num_classes)
    k1, k2 = _oihw(w1), _oihw(w2)

    g = Graph("vehicle_classification")

    # ---- Input (camera / file I/O source)
    def input_fire(inputs, state, atr):
        feed = inputs.get("__feed__")
        img = feed[0] if feed else f32(rng.rand(hw, hw, 3))
        return {"out": [img]}, state

    inp = g.add_actor(Actor(
        "Input", ActorType.SPA, [],
        [Port("out", PortDir.OUT, token_shape=(hw, hw, 3))],
        fire_fn=input_fire, cost_flops=0.0,
        meta={"layers": ["camera I/O"]}))

    # ---- L1: conv 5x5x32 + ReLU + maxpool/2
    def l1_fire(inputs, state, atr):
        (x,) = inputs["in"]
        return {"out": [maxpool2(F.relu(_conv(x, k1, b1)))]}, state

    l1 = g.add_actor(Actor(
        "L1", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(hw, hw, 3))],
        [Port("out", PortDir.OUT, token_shape=(hw // 2, hw // 2, 32))],
        fire_fn=l1_fire,
        cost_flops=conv_flops(hw, hw, 32, 5, 5, 3),
        cost_mem_bytes=w1.numel() * 4,
        meta={"layers": ["conv5x5x32", "relu", "maxpool2"]}))

    # ---- L2: conv 5x5x32 + ReLU + maxpool/2
    def l2_fire(inputs, state, atr):
        (x,) = inputs["in"]
        return {"out": [maxpool2(F.relu(_conv(x, k2, b2)))]}, state

    l2 = g.add_actor(Actor(
        "L2", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(hw // 2, hw // 2, 32))],
        [Port("out", PortDir.OUT, token_shape=(h2, h2, 32))],
        fire_fn=l2_fire,
        cost_flops=conv_flops(hw // 2, hw // 2, 32, 5, 5, 32),
        cost_mem_bytes=w2.numel() * 4,
        meta={"layers": ["conv5x5x32", "relu", "maxpool2"]}))

    # ---- L3: dense 100 + ReLU
    def l3_fire(inputs, state, atr):
        (x,) = inputs["in"]
        return {"out": [F.relu(dense(x, w3, b3))]}, state

    l3 = g.add_actor(Actor(
        "L3", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(h2, h2, 32))],
        [Port("out", PortDir.OUT, token_shape=(100,))],
        fire_fn=l3_fire, cost_flops=2.0 * feat * 100,
        cost_mem_bytes=(feat * 100 + 100) * 4,
        meta={"layers": ["dense100", "relu"]}))

    # ---- L4-L5: dense 100 + ReLU, dense n + softmax (sink)
    def l45_fire(inputs, state, atr):
        (x,) = inputs["in"]
        h = F.relu(dense(x, w4, b4))
        logits = dense(h, w5, b5)
        return {"result": [torch.softmax(logits, dim=-1)]}, state

    l45 = g.add_actor(Actor(
        "L4-L5", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(100,))], [],
        fire_fn=l45_fire,
        cost_flops=2.0 * (100 * 100 + 100 * num_classes),
        cost_mem_bytes=(100 * 100 + 100 + 100 * num_classes + num_classes) * 4,
        meta={"layers": ["dense100", "relu", f"dense{num_classes}", "softmax"]}))

    g.connect(inp.port("out"), l1.port("in"))
    g.connect(l1.port("out"), l2.port("in"))
    g.connect(l2.port("out"), l3.port("in"))
    g.connect(l3.port("out"), l45.port("in"))
    return g


def dual_input_vehicle_graph(num_classes: int = 4, *, seed: int = 0,
                             input_hw: int = 96, device="cuda") -> Graph:
    """Sec IV.C: Input..L3 replicated into two instances joining at a
    two-input L4L5 actor (the Fig 1 heterogeneous scenario)."""
    dev = resolve_device(device)
    g1 = vehicle_graph(num_classes, seed=seed, input_hw=input_hw, device=dev)
    g2 = vehicle_graph(num_classes, seed=seed + 1, input_hw=input_hw,
                       device=dev)
    g = Graph("dual_input_vehicle")
    for inst, src in ((1, g1), (2, g2)):
        for name in ("Input", "L1", "L2", "L3"):
            a = src.actors[name]
            clone = Actor(f"{name}.{inst}", a.actor_type,
                          [Port(p.name, p.direction, p.lrl, p.url,
                                p.token_shape, p.token_dtype)
                           for p in a.in_ports],
                          [Port(p.name, p.direction, p.lrl, p.url,
                                p.token_shape, p.token_dtype)
                           for p in a.out_ports],
                          fire_fn=a.fire_fn, cost_flops=a.cost_flops,
                          cost_mem_bytes=a.cost_mem_bytes, meta=dict(a.meta))
            g.add_actor(clone)
        g.connect(g.actors[f"Input.{inst}"].port("out"),
                  g.actors[f"L1.{inst}"].port("in"))
        g.connect(g.actors[f"L1.{inst}"].port("out"),
                  g.actors[f"L2.{inst}"].port("in"))
        g.connect(g.actors[f"L2.{inst}"].port("out"),
                  g.actors[f"L3.{inst}"].port("in"))

    rng = np.random.RandomState(seed + 99)
    f32 = _drawer(rng, dev)
    w4 = f32(rng.uniform(-0.1, 0.1, (200, 100)))
    b4 = torch.zeros((100,), dtype=torch.float32, device=dev)
    w5 = f32(rng.uniform(-0.1, 0.1, (100, num_classes)))
    b5 = torch.zeros((num_classes,), dtype=torch.float32, device=dev)

    def join_fire(inputs, state, atr):
        x = torch.cat([inputs["in0"][0], inputs["in1"][0]])
        h = F.relu(x @ w4 + b4)
        return {"result": [torch.softmax(h @ w5 + b5, dim=-1)]}, state

    l45 = g.add_actor(Actor(
        "L4L5", ActorType.SPA,
        [Port("in0", PortDir.IN, token_shape=(100,)),
         Port("in1", PortDir.IN, token_shape=(100,))], [],
        fire_fn=join_fire, cost_flops=2.0 * (200 * 100 + 100 * num_classes),
        cost_mem_bytes=(200 * 100 + 100 * num_classes) * 4))
    g.connect(g.actors["L3.1"].port("out"), l45.port("in0"))
    g.connect(g.actors["L3.2"].port("out"), l45.port("in1"))
    return g


# ---------------------------------------------------------------------------
# SSD-Mobilenet object tracking (Fig 3)
# ---------------------------------------------------------------------------

# Mobilenet-v1 body: (stride, cout) per depthwise-separable block.
_MOBILENET_BLOCKS: List[Tuple[int, int]] = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
]
# SSD extra feature blocks appended after the body: (cmid, cout, stride).
_SSD_EXTRAS: List[Tuple[int, int, int]] = [
    (256, 512, 2), (128, 256, 2), (128, 256, 2), (64, 128, 2),
]
# Detection heads tap these feature sources (actor name resolved later):
# DWCL11 (19x19x512), DWCL13 (10x10x1024), EL1..EL4.
_HEAD_SOURCES = ["DWCL11", "DWCL13", "EL1", "EL2", "EL3", "EL4"]
_HEAD_PRIORS = [3, 6, 6, 6, 6, 6]


def _pinned_times(name: str, flops_conv: float, flops_dw: float,
                  traffic_bytes: float = 0.0,
                  fixed_s: float = 0.0) -> Dict[str, float]:
    """Calibrated per-unit wall time for SSD actors on the paper's modeled
    N2 and i7 (see calibration.py): three-regime Mali OpenCL roofline +
    fixed plain-C costs."""
    n2 = (max(flops_conv / cal.N2_SSD_CONV_FLOPS,
              flops_dw / cal.N2_SSD_DW_FLOPS,
              traffic_bytes / cal.N2_SSD_MEM_BW)
          + fixed_s + cal.N2_FIRING_OVERHEAD_S)
    return {"endpoint": n2, "server": n2 / cal.I7_SSD_SPEEDUP}


def ssd_mobilenet_graph(num_classes: int = 21, *, seed: int = 0,
                        input_hw: int = 300, device="cuda") -> Graph:
    """SSD-Mobilenet grouped into 35 actors with SSD-head branches, NMS and
    tracking — real depthwise-separable compute in every fire function."""
    dev = resolve_device(device)
    fp32_exact()
    rng = np.random.RandomState(seed)
    f32 = _drawer(rng, dev)

    def pw(*shape):
        scale = 1.0 / math.sqrt(max(int(np.prod(shape[:-1])), 1))
        return f32(rng.uniform(-scale, scale, shape))

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    g = Graph("ssd_mobilenet_tracking")
    hw = input_hw

    def input_fire(inputs, state, atr):
        feed = inputs.get("__feed__")
        img = feed[0] if feed else f32(rng.rand(hw, hw, 3))
        return {"out": [img]}, state

    g.add_actor(Actor(
        "Input", ActorType.SPA, [],
        [Port("out", PortDir.OUT, token_shape=(hw, hw, 3))],
        fire_fn=input_fire,
        meta={"layers": ["camera I/O"],
              "unit_time_s": _pinned_times("Input", 0, 0)}))

    # --- CL1: standard conv 3x3 s2 -> 32 channels
    w_cl1, b_cl1 = pw(3, 3, 3, 32), zeros(32)
    h = (hw + 1) // 2

    def cl1_fire(inputs, state, atr, w=_oihw(w_cl1), b=b_cl1):
        (x,) = inputs["in"]
        return {"out": [F.relu(_conv(x, w, b, stride=2))]}, state

    fl = conv_flops(h, h, 32, 3, 3, 3)
    traffic = 4 * (hw * hw * 3 + h * h * 32) + w_cl1.numel() * 4
    g.add_actor(Actor(
        "CL1", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(hw, hw, 3))],
        [Port("out", PortDir.OUT, token_shape=(h, h, 32))],
        fire_fn=cl1_fire, cost_flops=fl, cost_mem_bytes=w_cl1.numel() * 4,
        meta={"layers": ["conv3x3s2x32", "relu"],
              "unit_time_s": _pinned_times("CL1", fl, 0, traffic)}))
    g.connect(g.actors["Input"].port("out"), g.actors["CL1"].port("in"))

    # --- DWCL1..13: depthwise 3x3 + pointwise 1x1 (+ReLUs), grouped
    cin = 32
    prev = "CL1"
    feat_shapes: Dict[str, Tuple[int, int, int]] = {}
    for i, (stride, cout) in enumerate(_MOBILENET_BLOCKS, start=1):
        name = f"DWCL{i}"
        w_dw = pw(3, 3, 1, cin)
        w_pt, b_pt = pw(1, 1, cin, cout), zeros(cout)
        h_out = (h + stride - 1) // stride

        def dwcl_fire(inputs, state, atr, w_dw=_oihw(w_dw), w_pt=_oihw(w_pt),
                      b_pt=b_pt, stride=stride, cin=cin):
            (x,) = inputs["in"]
            y = F.relu(_conv(x, w_dw, stride=stride, groups=cin))
            return {"out": [F.relu(_conv(y, w_pt, b_pt))]}, state

        fl_dw = conv_flops(h_out, h_out, cin, 3, 3, 1)
        fl_pt = conv_flops(h_out, h_out, cout, 1, 1, cin)
        # activation traffic: read in, write+read dw intermediate, write out
        traffic = 4 * (h * h * cin + 2 * h_out * h_out * cin
                       + h_out * h_out * cout) + (w_dw.numel() + w_pt.numel()) * 4
        g.add_actor(Actor(
            name, ActorType.SPA,
            [Port("in", PortDir.IN, token_shape=(h, h, cin))],
            [Port("out", PortDir.OUT, token_shape=(h_out, h_out, cout))],
            fire_fn=dwcl_fire, cost_flops=fl_dw + fl_pt,
            cost_mem_bytes=(w_dw.numel() + w_pt.numel()) * 4,
            meta={"layers": [f"dwconv3x3s{stride}", "relu",
                             f"conv1x1x{cout}", "relu"],
                  "unit_time_s": _pinned_times(name, fl_pt, fl_dw, traffic)}))
        g.connect(g.actors[prev].port("out"), g.actors[name].port("in"))
        feat_shapes[name] = (h_out, h_out, cout)
        prev, h, cin = name, h_out, cout

    # --- EL1..EL4: SSD extra feature blocks (1x1 reduce + 3x3 s2)
    for j, (cmid, cout, stride) in enumerate(_SSD_EXTRAS, start=1):
        name = f"EL{j}"
        w_a, b_a = pw(1, 1, cin, cmid), zeros(cmid)
        w_b, b_b = pw(3, 3, cmid, cout), zeros(cout)
        h_out = (h + stride - 1) // stride

        def el_fire(inputs, state, atr, w_a=_oihw(w_a), b_a=b_a,
                    w_b=_oihw(w_b), b_b=b_b, stride=stride):
            (x,) = inputs["in"]
            y = F.relu(_conv(x, w_a, b_a))
            return {"out": [F.relu(_conv(y, w_b, b_b, stride=stride))]}, state

        fl_el = (conv_flops(h, h, cmid, 1, 1, cin)
                 + conv_flops(h_out, h_out, cout, 3, 3, cmid))
        traffic = 4 * (h * h * (cin + 2 * cmid) + h_out * h_out * cout) \
            + (w_a.numel() + w_b.numel()) * 4
        g.add_actor(Actor(
            name, ActorType.SPA,
            [Port("in", PortDir.IN, token_shape=(h, h, cin))],
            [Port("out", PortDir.OUT, token_shape=(h_out, h_out, cout))],
            fire_fn=el_fire, cost_flops=fl_el,
            cost_mem_bytes=(w_a.numel() + w_b.numel()) * 4,
            meta={"layers": [f"conv1x1x{cmid}", "relu",
                             f"conv3x3s{stride}x{cout}", "relu"],
                  "unit_time_s": _pinned_times(name, fl_el, 0, traffic)}))
        g.connect(g.actors[prev].port("out"), g.actors[name].port("in"))
        feat_shapes[name] = (h_out, h_out, cout)
        prev, h, cin = name, h_out, cout

    # --- detection heads: (LOC_k, CONF_k) 3x3 convs on each source, fed
    # through a tap port added to the source actor
    total_priors = 0
    for k, (src_name, kpriors) in enumerate(zip(_HEAD_SOURCES, _HEAD_PRIORS),
                                            start=1):
        sh, sw, sc = feat_shapes[src_name]
        total_priors += sh * sw * kpriors
        src_actor = g.actors[src_name]
        for kind, cout_mult in (("LOC", 4), ("CONF", num_classes)):
            name = f"{kind}{k}"
            w_h = pw(3, 3, sc, kpriors * cout_mult)
            b_h = zeros(kpriors * cout_mult)

            def head_fire(inputs, state, atr, w_h=_oihw(w_h), b_h=b_h,
                          cout_mult=cout_mult):
                (x,) = inputs["in"]
                y = _conv(x, w_h, b_h)
                return {"out": [y.reshape(-1, cout_mult)]}, state

            fl_head = conv_flops(sh, sw, kpriors * cout_mult, 3, 3, sc)
            traffic_head = 4 * (sh * sw * (sc + kpriors * cout_mult)) \
                + w_h.numel() * 4
            out_shape = (sh * sw * kpriors, cout_mult)
            # add a tap port on the source actor
            tap = Port(f"tap_{name}", PortDir.OUT, token_shape=(sh, sw, sc))
            tap.actor = src_actor
            src_actor.out_ports.append(tap)
            _augment_fanout(src_actor)
            g.add_actor(Actor(
                name, ActorType.SPA,
                [Port("in", PortDir.IN, token_shape=(sh, sw, sc))],
                [Port("out", PortDir.OUT, token_shape=out_shape)],
                fire_fn=head_fire, cost_flops=fl_head,
                cost_mem_bytes=w_h.numel() * 4,
                meta={"layers": [f"conv3x3 head {kind.lower()}"],
                      "unit_time_s": _pinned_times(name, fl_head, 0,
                                                   traffic_head)}))
            g.connect(tap, g.actors[name].port("in"))

    # --- Concat + NMS + Tracker tail
    for kind, cols in (("LOC", 4), ("CONF", num_classes)):
        in_ports = [Port(f"in{k}", PortDir.IN,
                         token_shape=g.actors[f"{kind}{k + 1}"]
                         .port("out").token_shape)
                    for k in range(len(_HEAD_SOURCES))]

        def concat_fire(inputs, state, atr):
            toks = [inputs[k][0] for k in sorted(inputs)]
            return {"out": [torch.cat(toks, dim=0)]}, state

        g.add_actor(Actor(
            f"Concat{kind.title()}", ActorType.SPA, in_ports,
            [Port("out", PortDir.OUT, token_shape=(total_priors, cols))],
            fire_fn=concat_fire,
            meta={"unit_time_s": _pinned_times(f"Concat{kind}", 0, 0)}))
        for k in range(len(_HEAD_SOURCES)):
            g.connect(g.actors[f"{kind}{k + 1}"].port("out"),
                      g.actors[f"Concat{kind.title()}"].port(f"in{k}"))

    def nms_fire(inputs, state, atr):
        loc = inputs["loc"][0]
        conf = torch.softmax(inputs["conf"][0], dim=-1)
        # greedy top-k "NMS": keep the 10 highest-confidence non-background
        # (a stable sort, as the reference's argsort)
        score = 1.0 - conf[:, 0]
        top = torch.argsort(-score, stable=True)[:10]
        return {"out": [torch.cat([loc[top], score[top, None]],
                                  dim=-1)]}, state

    g.add_actor(Actor(
        "NMS", ActorType.SPA,
        [Port("loc", PortDir.IN, token_shape=(total_priors, 4)),
         Port("conf", PortDir.IN, token_shape=(total_priors, num_classes))],
        [Port("out", PortDir.OUT, token_shape=(10, 5))],
        fire_fn=nms_fire,
        meta={"unit_time_s": {"endpoint": cal.N2_SSD_NMS_S,
                              "server": cal.N2_SSD_NMS_S / cal.I7_SSD_SPEEDUP}}))
    g.connect(g.actors["ConcatLoc"].port("out"), g.actors["NMS"].port("loc"))
    g.connect(g.actors["ConcatConf"].port("out"), g.actors["NMS"].port("conf"))

    def tracker_fire(inputs, state, atr):
        det = inputs["in"][0]
        prev = state if state is not None else det
        # constant-velocity association stub: smooth boxes across frames;
        # the state stays a tensor on the device
        tracked = 0.7 * det + 0.3 * prev
        return {"result": [tracked]}, tracked

    g.add_actor(Actor(
        "Tracker", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(10, 5))], [],
        fire_fn=tracker_fire, init_fn=lambda: None,
        meta={"unit_time_s": {"endpoint": cal.N2_SSD_TRACKER_S,
                              "server": cal.N2_SSD_TRACKER_S / cal.I7_SSD_SPEEDUP}}))
    g.connect(g.actors["NMS"].port("out"), g.actors["Tracker"].port("in"))
    # EL4 is the last chain actor; its chain 'out' port is consumed only by
    # its head taps — drop the unused chain port so the graph is closed.
    el4 = g.actors["EL4"]
    el4.out_ports = [p for p in el4.out_ports
                     if not (p.name == "out" and p.fifo is None)]
    return g


def _augment_fanout(actor: Actor) -> None:
    """Wrap the actor's fire_fn so every out port receives the token that
    the original single-'out' implementation produced (fan-out taps)."""
    if actor.meta.get("_fanout_wrapped"):
        return
    base_fire = actor.fire_fn

    def fanout_fire(inputs, state, atr, _base=base_fire, _actor=actor):
        outputs, state = _base(inputs, state, atr)
        tok = outputs["out"][0]
        for p in _actor.out_ports:
            if p.name != "out":
                outputs[p.name] = [tok]
        return outputs, state

    actor.fire_fn = fanout_fire
    actor.meta["_fanout_wrapped"] = True


def partition_point_after(g: Graph, actor_name: str) -> int:
    """Partition point index such that ``actor_name`` is the last actor on
    the endpoint ('Input ... DWCL9' in Sec IV.B)."""
    prec = g.precedence_index()
    return prec[actor_name] + 1
