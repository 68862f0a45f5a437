"""Variable-rate conditional offload on the port: VR-PRUNE's dynamic
machinery (Sec III.A — CA/DA/DPA, token rates, DPGs) used for
confidence-gated collaborative inference, with torch fire functions.

Scenario: the endpoint runs Input..L2 plus a cheap shallow head (the CA).
Only frames the shallow head is UNSURE about are offloaded to the server
for the deep L3..L5 path — everything else exits early on-device. The
dynamic subgraph (entry DA -> deep DPA -> exit DA) has token rate 0 or 1
per frame, set by the CA at run time; the analyzer proves the graph
deadlock/overflow-free at design time, and the symmetric-token-rate rule
guarantees the entry/exit rates always agree.

The fraction of frames whose intermediate features ever leave the device
is a run-time quantity, and boundary traffic shrinks by the same factor
against always-offload. Weights and images are the reference example's
numpy draws, so the decisions are the reference's.

Run: PYTHONPATH=src python examples/torch_early_exit_offload.py [--device cpu]
"""
import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import Mapping, Simulator, analyze
from repro_torch.core.graph import Actor, ActorType, Dpg, Graph, Port, PortDir
from repro_torch.models.cnn import conv2d, dense, fp32_exact, maxpool2
from repro_torch.models.transformer import resolve_device

HW, NCLS = 32, 4
FRAMES = 30


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fp32_exact()
    rng = np.random.RandomState(0)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def pw(*shape):
        s = 1.0 / math.sqrt(np.prod(shape[:-1]))
        return f32(rng.uniform(-s, s, shape))

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    w1, w2 = pw(5, 5, 3, 16), pw(5, 5, 16, 16)
    feat = (HW // 4) ** 2 * 16
    w_sh, b_sh = pw(feat, NCLS), zeros(NCLS)                # shallow head
    w3, b3 = pw(feat, 64), zeros(64)
    w45, b45 = pw(64, NCLS), zeros(NCLS)                    # deep path

    g = Graph("early_exit_offload")
    state = {"decisions": [], "confidences": []}

    inp = g.add_actor(Actor(
        "Input", ActorType.SPA, [],
        [Port("out", PortDir.OUT, token_shape=(HW, HW, 3))],
        fire_fn=lambda i, st, r: ({"out": [f32(rng.rand(HW, HW, 3))]}, st)))

    backbone = g.add_actor(Actor(
        "L1L2", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(HW, HW, 3))],
        [Port("out", PortDir.OUT, token_shape=(HW // 4, HW // 4, 16))],
        fire_fn=lambda i, st, r: ({"out": [maxpool2(F.relu(conv2d(
            maxpool2(F.relu(conv2d(i["in"][0], w1))), w2)))]}, st)))

    def gate_fire(inputs, st, rates):
        """The CA: shallow classification + the offload decision."""
        (x,) = inputs["in"]
        probs = torch.softmax(dense(x, w_sh, b_sh), dim=-1)
        conf = float(probs.max())
        state["confidences"].append(conf)
        state["decisions"].append(1 if conf < 0.263 else 0)  # unsure -> offload
        return {"feat": [x], "shallow": [probs]}, st

    gate = g.add_actor(Actor(
        "Gate", ActorType.CA,
        [Port("in", PortDir.IN, token_shape=(HW // 4, HW // 4, 16))],
        [Port("feat", PortDir.OUT, token_shape=(HW // 4, HW // 4, 16)),
         Port("shallow", PortDir.OUT, token_shape=(NCLS,))],
        fire_fn=gate_fire))

    entry = g.add_actor(Actor(
        "EntryDA", ActorType.DA,
        [Port("in", PortDir.IN, token_shape=(HW // 4, HW // 4, 16))],
        [Port("out", PortDir.OUT, lrl=0, url=1,
              token_shape=(HW // 4, HW // 4, 16))],
        fire_fn=lambda i, st, r: ({"out": list(i["in"])[:r["out"]]}, st)))

    deep = g.add_actor(Actor(
        "DeepL3L5", ActorType.DPA,
        [Port("in", PortDir.IN, lrl=0, url=1,
              token_shape=(HW // 4, HW // 4, 16))],
        [Port("out", PortDir.OUT, lrl=0, url=1, token_shape=(NCLS,))],
        fire_fn=lambda i, st, r: (
            {"out": [torch.softmax(dense(F.relu(dense(x, w3, b3))
                                         .reshape(8, 8), w45, b45), dim=-1)
                     for x in i.get("in", [])]}, st)))

    exit_da = g.add_actor(Actor(
        "ExitDA", ActorType.DA,
        [Port("deep", PortDir.IN, lrl=0, url=1, token_shape=(NCLS,)),
         Port("shallow", PortDir.IN, token_shape=(NCLS,))],
        [Port("result", PortDir.OUT, token_shape=(NCLS,))],
        fire_fn=lambda i, st, r: (
            {"result": [i["deep"][0] if i.get("deep") else i["shallow"][0]]},
            st)))

    sink = g.add_actor(Actor(
        "Sink", ActorType.SPA,
        [Port("in", PortDir.IN, token_shape=(NCLS,))], [],
        fire_fn=lambda i, st, r: ({"result": i["in"]}, st)))

    g.connect(inp.port("out"), backbone.port("in"))
    g.connect(backbone.port("out"), gate.port("in"))
    g.connect(gate.port("feat"), entry.port("in"))
    g.connect(gate.port("shallow"), exit_da.port("shallow"), capacity=4)
    g.connect(entry.port("out"), deep.port("in"))
    g.connect(deep.port("out"), exit_da.port("deep"))
    g.connect(exit_da.port("result"), sink.port("in"))
    g.add_dpg(Dpg("offload", ca="Gate", entry_da="EntryDA", exit_da="ExitDA",
                  members=["Gate", "EntryDA", "DeepL3L5", "ExitDA"]))

    report = analyze(g)
    print(f"analyzer: ok={report.ok} errors={report.errors}")

    def atr_fn(actor, k):
        """The CA's run-time rate assignment: symmetric on every DPG edge."""
        d = state["decisions"][k] if k < len(state["decisions"]) else 1
        if actor.name == "EntryDA":
            return {"out": d}
        if actor.name == "DeepL3L5":
            return {"in": d, "out": d}
        if actor.name == "ExitDA":
            return {"deep": d}
        return {}

    mapping = Mapping("offload", {a: ("server" if a == "DeepL3L5"
                                      else "endpoint") for a in g.actors})
    res = Simulator(g, mapping=mapping, atr_fn=atr_fn).run(FRAMES)
    results = res.outputs["Sink"]
    offloaded = sum(state["decisions"][:FRAMES])
    print(f"device: {dev}; confidence range: "
          f"{min(state['confidences']):.3f}..{max(state['confidences']):.3f}")
    tok_bytes = g.fifos["Gate.feat->EntryDA.in"].token_bytes
    print(f"frames: {FRAMES}, offloaded (conf<0.263): {offloaded} "
          f"({100 * offloaded / FRAMES:.0f}%)")
    print(f"boundary traffic: {offloaded * tok_bytes} B vs always-offload "
          f"{FRAMES * tok_bytes} B -> {100 * (1 - offloaded / FRAMES):.0f}% "
          f"saved; {FRAMES - offloaded} frames never leave the device")
    assert len(results) == FRAMES
    for p in results:
        np.testing.assert_allclose(float(p.sum()), 1.0, rtol=1e-5)
    print("every frame produced a normalized classification — the variable-"
          "rate DPG is consistent (no deadlock, rates symmetric).")


if __name__ == "__main__":
    main()
