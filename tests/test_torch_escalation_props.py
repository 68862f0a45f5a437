"""Property-based escalation-journal tests of the port (hypothesis).

tests/test_escalation_props.py on ``repro_torch.runtime.escalation``:
for any interleaving of appends, link up/down flips, lost
acknowledgements, replay steps and crash-restarts (journal and replayer
rebuilt from disk, all in-memory state lost), once the link is up long
enough to drain:

* every appended request reaches the server tier at least once;
* every appended request is surfaced exactly once (the delivered-set
  de-dup absorbs resends whose first ack was lost);
* first deliveries happen in append order;
* the journal directory ends empty, and sequence numbers stay strictly
  monotone across restarts.

No engines or models: the replayer is synchronous and thread-free at
``window=1``, so the suite drives the protocol code the ``TieredEngine``
pump runs one operation at a time.
"""
from __future__ import annotations

import os

import numpy as np

from hypothesis import given, settings, strategies as st

from repro_torch.runtime.escalation import (EscalationJournal, JournalFull,
                                            JournalReplayer, LinkDown)
from repro_torch.runtime.scheduler import Completion, Request

CAPACITY = 8


class FakeServerTransport:
    """Server tier as a ledger. ``up`` models the link; ``drop_next_ack``
    models the nastiest failure: the server computes the completion but
    the link dies before the reply lands (at-least-once territory)."""

    tier = "server"

    def __init__(self):
        self.up = True
        self.drop_next_ack = False
        self.computed = []              # seqs the server actually ran

    def healthy(self):
        return self.up

    def send(self, req: Request, *, seq=None) -> Completion:
        if not self.up:
            raise LinkDown("link down")
        self.computed.append(seq)
        if self.drop_next_ack:
            self.drop_next_ack = False
            raise LinkDown("ack lost")
        return Completion(req.id, [int(t) for t in req.prompt], 0.0, 0.0,
                          finish_reason="eos")


OPS = st.lists(
    st.sampled_from(["append", "append", "step", "step", "link_down",
                     "link_up", "drop_ack", "crash"]),
    min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=OPS, window=st.sampled_from([1, 3]))
def test_property_exactly_once_in_order_no_leak(ops, window,
                                                tmp_path_factory):
    # window=1 is the thread-free serial protocol; window=3 pipelines
    # sends — the invariants must hold identically for both
    root = str(tmp_path_factory.mktemp("journal"))
    transport = FakeServerTransport()
    surfaced = []                       # (seq, completion) in surfacing order

    def on_complete(entry, c):
        surfaced.append((entry.seq, c))

    def boot():
        j = EscalationJournal(root, capacity=CAPACITY)
        return j, JournalReplayer(j, transport, on_complete=on_complete,
                                  window=window)

    journal, replayer = boot()
    appended = []                       # (seq, prompt) accepted by the journal
    n = 0
    for op in ops:
        if op == "append":
            prompt = np.arange(n, n + 3, dtype=np.int32)
            try:
                seq = journal.append(
                    Request(id=n, prompt=prompt, max_new_tokens=4))
            except JournalFull:
                assert journal.depth == CAPACITY
            else:
                appended.append((seq, prompt))
            n += 1
        elif op == "step":
            replayer.step()
        elif op == "link_down":
            transport.up = False
        elif op == "link_up":
            transport.up = True
        elif op == "drop_ack":
            transport.drop_next_ack = True
        elif op == "crash":
            # process dies between operations: journal + replayer state
            # (including the delivered set) is lost; disk survives
            journal, replayer = boot()

    # revive the link and drain
    transport.up = True
    transport.drop_next_ack = False
    for _ in range(len(appended) + 2):
        if journal.depth == 0:
            break
        replayer.step()
    assert journal.depth == 0, "journal did not drain on a healthy link"

    want = [seq for seq, _ in appended]
    got = [seq for seq, _ in surfaced]
    # exactly once, in append order (strictly increasing == in order +
    # no duplicates), nothing lost
    assert got == sorted(set(got)), f"reordered or duplicated: {got}"
    assert got == want, f"surfaced {got} != appended {want}"
    # durability: the server computed every journaled request >= once
    # (resends after a lost ack make it > once — that is the point)
    assert set(transport.computed) == set(want)
    assert len(transport.computed) >= len(want)
    # payload integrity through serialize -> replay -> completion
    prompts = dict(appended)
    for seq, c in surfaced:
        assert c.tokens == [int(t) for t in prompts[seq]], seq
    # seqs strictly monotone across crash-restarts (no reuse)
    assert all(a < b for a, b in zip(want, want[1:]))
    # no on-disk leak: acks deleted every record, only the seq-counter
    # state file remains
    leftovers = [f for f in os.listdir(root) if f != "journal.state.json"]
    assert leftovers == [], leftovers


@settings(max_examples=25, deadline=None)
@given(n_appends=st.integers(1, 6), crash_at=st.integers(0, 6))
def test_property_crash_preserves_pending_and_seq_monotone(
        n_appends, crash_at, tmp_path_factory):
    """A restart rebuilds exactly the unacked set, in order, and never
    reissues a sequence number — even when the journal drained to empty
    before the crash (the state file carries the counter)."""
    root = str(tmp_path_factory.mktemp("journal"))
    journal = EscalationJournal(root, capacity=64)
    seqs = [journal.append(Request(id=i, prompt=np.full(2, i, np.int32)))
            for i in range(n_appends)]
    acked = seqs[:min(crash_at, n_appends)]
    for s in acked:
        journal.ack(s)

    reborn = EscalationJournal(root, capacity=64)
    assert [e.seq for e in reborn.pending()] == seqs[len(acked):]
    fresh = reborn.append(Request(id=99, prompt=np.zeros(2, np.int32)))
    assert fresh > max(seqs), (fresh, seqs)
