#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--phases 1,2,3,...,16]

Phases, one status line each; any failure exits non-zero:

1. device and build: the card's name and power limit, the CUDA version,
   and the kernels built from ``src/repro_torch/csrc`` (timed);
2. each kernel against its plain PyTorch version on the card, over the
   reference's test shapes, ragged lengths and the shapes the serving
   runs give the kernels (tolerance 2e-5 fp32; in bf16 2e-2 prefill,
   3e-2 decode, 5e-3 flash with a per-sequence ``q_offset`` / ``kv_len``
   as prefix resume and chunked prefill call it, 2e-3 paged decode):
   flash attention, slotted decode, and paged decode over a block pool
   (null and repeated blocks, lengths 0 and 1; at the paged fifo shape
   also bit for bit equal to slotted decode over the gathered rows);
   the edges of the kernels' bodies (flash in bf16 at head dims 12 to
   256, lengths that are no multiple of a tile, g = 1, 16 and 128,
   windows and kv_len ending mid-tile; decode lengths 0, 1, 31, 33, one
   ending a split mid-tile and the full cache, block sizes 8 and 16,
   24-byte rows), and flash on B > 1 sequences bit for bit equal to
   each sequence run alone; then, at the serving shapes, the kernel's,
   the plain version's and the library's times (SDPA; for paged decode
   a page gather then SDPA, two calls; inputs rotated over twice the
   L2) and the card's bound at the peak rate of the input type;
3. the JAX golden fixture (``src/repro_torch/testdata/golden_cm.npz``):
   the port on the card in fp32 must give the reference's logits within
   1e-4 (prefill + decode, and a 5-token prefill extended by 4), and
   its Engine the reference's greedy tokens under batch and fifo
   admission, and on the paged, paged-chunked, paged-prefix and
   paged-chunked-prefix, paged-prefix-victim, disagg and pipelined-decode
   fifo cells and a 7-block pool without and with an admission watermark
   (which preempt) also JAX's counters; then the reference's prefix-cache
   service scenarios (a parked chain re-hit, eviction under pressure, a
   tenant quota breach, one prompt under two tenants) and a fresh engine
   restored from the JAX-saved ``golden_prefix.npz`` (``prefix-victim-v1``)
   replaying its wave: JAX's tokens, counters and parked bytes per tenant;
4. the serving path at full width and depth on qwen2-1.5b in bf16: the
   model's prefill and decode steps through the kernels against the same
   with the plain versions in their place (logits and caches within 5e-2
   of their largest magnitude, argmax equal on 90% of rows), and a
   512-token prompt prefilled 256 + extended 256 against its one-shot
   prefill (same tolerances, argmax equal); then
   ``repro_torch.launch.serve`` with 16 requests of 512 prompt tokens
   and 32 new tokens over 8 slots: slotted fifo, batch, paged fifo (a
   pool at slotted parity), a tight pool that must preempt, prefix
   sharing, and prefix sharing with 128-token chunks. Every request
   must finish by length; fifo must equal batch, paged fifo must equal
   slotted fifo, the tight pool must equal paged fifo; each run's
   launches must be 28 per prefill or extend call (flash) and 28 per
   decode step (the layout's decode kernel, the other 0). The slotted
   and the paged fifo runs are replayed under ``torch.profiler`` for the
   device's busy time and idle share; the prefix runs' agreement with a
   slotted run on their shared-preamble workload is reported;
5. training recurrentgemma-9b through the RG-LRU scan kernel (forward
   and reverse) and the flash kernel at head_dim 256: (a) the JAX golden
   training fixture (``src/repro_torch/testdata/golden_train.npz``, a
   tiny 5-layer hybrid in fp32) replayed through the kernels, two
   ``make_train_step`` steps with 2 microbatches: loss, every step-1
   gradient leaf and every param after the second AdamW step within the
   limits set from the CPU's errors; (b) the full-width model (d_model
   4096, 16/1 heads of 256, d_ff 12288, vocabulary 256000, depth cut to
   5 layers: one scanned period and two remainder rglru layers) trained
   4 steps on the copy task (S=4096, global batch 2 in 2 microbatches)
   by ``repro_torch.launch.train.run`` in bf16 over fp32 masters: loss
   finite and falling, launches exact per step, step time, peak memory
   and tokens/s printed, the last step traced under ``torch.profiler``
   (device busy time, idle share, the largest kernels); (c), run before
   (b), one microbatch of it at
   its initial weights through the kernels against the same with the
   plain versions in their place (loss within 1e-2 relative, each
   gradient leaf within 5e-2 of its largest magnitude);
6. the serving surface: qwen2-1.5b at full width and depth in bf16 behind
   ``repro_torch.runtime.server.EngineServer`` on 127.0.0.1 (ephemeral
   port), its ``Engine`` background-drained on the paged pool (281 blocks
   of 16 rows, 8 slots) with prefix sharing, the victim cache and tenant
   byte quotas (b's below one 256-token chain), decode in 2 stages over 2
   units, deadline shedding and observability: (a) 16 requests of 512
   prompt tokens and 32 new, 8 per tenant sharing a 256-token preamble,
   half streamed as NDJSON, sent in order by one client, must end by
   length with the tokens of the same requests through a caller-pumped
   engine with the same pool and one decode stage, bit for bit; (b) their
   agreement with slice 1's slotted fifo engine is reported; (c) 4
   concurrent clients resend them: all complete, agreement reported; (d)
   two requests with 1 ms deadlines shed as timeout and the pool's books
   balance; (e) ``/metrics`` parses with counters equal to the requests
   sent and a TTFT histogram, ``/trace`` validates with its ``units``
   tracks, ``/status`` shows more victim hits in the second wave and
   quota evictions of tenant b only; (f) the prefix cache saved, the
   server shut down, a fresh engine restored from the file serves tenant
   a's prompts again from the restored blocks with (a)'s tokens; (g) every
   run launches flash 28 times per prefill or extend call and paged decode
   28 times per decode step (slotted decode none; the slotted run the
   other way round); (h) wall time, output tok/s and TTFT p50 over HTTP
   against the in-process run, beside the card's name and power limit.
7. Edge-PRUNE on the card: (a) the paper's CNNs at the paper's sizes
   (the vehicle classifier at 96 x 96 x 3, the dual-input graph at its
   default, SSD-Mobilenet at 300 x 300 x 3), each built on the card and
   on the CPU from one seed and fed the same two frames, held actor by
   actor in fp32 with TF32 off (atol 1e-5 + rtol 1e-4; NMS's picks equal
   but for near ties); on the card the Simulator's firings equal, bit
   for bit, those of the Simulator at every partition point of
   ``Explorer.evaluate_simulated`` and of each point's ``run_local`` and
   ``run_pipelined`` (the paper's cut after DWCL9 among them), and each
   actor's device time from CUDA events (a synchronized fire alone, and
   fires back to back with the device held); (b) the modeled Fig 4-6
   rows of ``benchmarks/torch_paper.py`` equal to the reference's,
   written here as constants; (c) qwen2-1.5b's actor graph at full width
   (bf16, B = 1, a 512-token prompt, one actor a layer) cut after 1, 15
   and 30 of its 31 actors: ``PartitionedServeEngine.infer`` logits equal
   to ``forward``'s bit for bit, boundary bytes 2,048 / 1,572,864 /
   1,572,864, 28 flash launches a frame, and 28 a frame over a pipelined
   stream, each frame equal to ``forward``; a partitioned and a
   monolithic frame timed (wall, device span, traced busy time); (d)
   recurrentgemma-9b at full width cut to 5 layers at S = 4096: the cut's
   logits equal ``forward``'s bit for bit, 1 flash and 4 scan forward
   launches a frame.
8. hierarchical serving on the card: qwen2-1.5b at full width and depth
   in bf16, one model object shared by both tiers: (a) ``step_delay_s``
   leaves a 1-slot engine's tokens as they are and lengthens every
   step past its model work by at least the delay, so the run by at
   least steps x delay (each step's model work, whose run-to-run spread
   is as large as steps x delay, timed and set aside); (b) a ``TieredEngine`` over an endpoint ``Engine`` of 1 slot
   with a ``step_delay_s`` handicap and a background-drained server
   ``Engine`` of 8 slots behind ``InProcessTransport`` (the reference
   bench's wiring: replay window 8, 16 sends a pump round), both slotted
   at ``max_len`` 552, fed one open-loop Poisson trace of 16 requests
   (prompts of 128/256/384/512 tokens, 16 new tokens, one deadline)
   under ``never``, ``always`` and ``confidence`` + ``overload`` (the
   threshold the median of the port's probe over the trace); the
   handicap, rate and deadline follow from the step time measured in
   (a) (``ESC_HANDICAP``, ``ESC_LOAD``, ``ESC_DEADLINE``), and the gated
   mode must beat ``never`` on answered-within-deadline while escalating
   strictly between 0 and 16. Every request ends by length with the
   tokens of the tier that answered it run alone, bit for bit (the two
   tiers' agreement is reported: M = 1 and M = 8 products may round
   apart in bf16); ``repro_escalated_total`` equals the handles' count;
   flash launches 28 times per prefill call of either engine and per
   confidence probe, slotted decode 28 times per decode step of either;
   (c) ``FlakyTransport`` cuts the link for 2 s after warm-up while 8
   deadline-free ``always`` requests are in flight: none lost, each
   surfaced once in journal order with the server's tokens alone, one
   fail-back, recovery within 10 s; a deadline-tight request, handed
   to the endpoint while the link is down, ends ``local_fallback`` with
   the endpoint's tokens, an expired one ``timeout``; (d) the server tier behind ``EngineServer`` on
   127.0.0.1 (ephemeral port) on phase 6's paged pool, reached by a
   ``TieredEngine`` with ``HttpTransport`` and ``always``: (b)'s server
   tokens, ``/status`` of a server fronting the tiered engine reports
   ``tier: "endpoint"``, paged decode launches exact; (e) qwen2-1.5b's
   actor graph (B = 1, S = 512, two layers an actor) on the N270
   platform with Ethernet under ``FailoverController`` over
   ``Explorer.rank_fallbacks``: 8 frames, 4 checkpointed, the server
   killed mid-stream; every frame's logits equal the failure-free run's
   and ``forward``'s bit for bit, frames replayed, 28 flash launches a
   frame fired, recovery as modeled detection + wall re-synthesis, a
   fallback frame traced, peak memory of both runs; the Simulator's kill
   and revival on the same graph re-fires frames bit-exact; a
   ``SlotFailure`` mid-decode in the server engine keeps the failure-free
   tokens.
9. the local-attention and hybrid families served on the card: (a) the
   JAX hybrid fixture (``src/repro_torch/testdata/golden_hybrid.npz``,
   gemma3-1b's and recurrentgemma-9b's smoke configs) replayed in fp32
   through the kernels: prefill + 4 decode-step logits within 1e-4 of
   JAX's, and the Engine's tokens, finish reasons, counters and
   ``kv_stats`` equal to JAX's engine's in every cell (batch, slotted
   fifo, chunked prefill and prefix sharing served one-shot, 2 decode
   stages, a ``SlotFailure``, and for gemma3 the paged pool, a pool that
   preempts); (b) gemma3-1b at full width and depth in bf16 (26 layers,
   4/1 heads of 256, window 512): its prefill and 8 decode steps through
   the kernels against the plain versions (logits within 5e-2 of their
   largest magnitude, a greedy choice moved only where the plain run's
   top-2 gap is within 1e-2 of the largest logit, the K/V rings within
   5e-2 at the end of the runs), then the serve CLI with 16 requests of 1,024-token
   prompts (the rings wrap inside the prefill) and 8 new tokens over 8
   slots: slotted fifo, batch, paged fifo (blocks of 16), ``--prefix-
   cache`` and ``--prefill-chunk 128``; every request ends by length,
   fifo equals batch, the paged runs equal slotted fifo (the prefix run a
   slotted run of its shared-preamble workload), the last two are served
   one-shot (no extend call, no prefix hit), and the launches are exact:
   flash 26 a prefill call, per decode step slotted decode 26 (slotted)
   or 22 slotted + 4 paged (paged); (c) recurrentgemma-9b at full width
   and depth (38 layers: 26 RG-LRU, 12 local attention of 16/1 heads of
   256, window 2,048): against its plain versions (4 prompts of 2,080
   tokens, 8 decode steps; ``conv`` within 5e-2, ``h`` reported), then 14
   requests of 512 tokens and 2 of 2,080 (whose rings wrap), 8 new, 8
   slots: fifo replayed from a JSONL trace through the CLI's ``--trace``,
   batch on the same requests, equal; the paged layout refused in the
   reference's words; launches exact: 12 flash and 26 scan-forward a
   prefill call, 12 slotted decode and no scan a decode step; then the
   same model in fp32 against its plain versions (4 prompts of 1,040
   tokens, 8 decode steps), ``h`` at
   the end of the runs within ``STATE_TOL``, and a control (the plain
   versions with the scan's inputs and state in bf16) outside it; (d)
   llama3.2-3b and chatglm3-6b at full width and depth: one slotted fifo
   run each (8 requests of 256 tokens, 16 new), launches exact, and their
   prefill and 2 decode steps against the plain versions; (e) each
   model's fifo run's wall, output tok/s, TTFT p50 and decode ms a step
   beside the card's name and power limit, and the run replayed under
   ``torch.profiler`` for the device's busy time and idle share (the
   kernels read from the profiler's raw results). Each part of phases 9
   and 10 prints its seconds (``# part``).
   Phase 2 adds the scan on the reference's test shapes,
   the chunked body's edges (a partial last chunk with B > 1, D = 37,
   S = 1) and at B=1 S=4096 D=4096 (tol 1e-5, forward and reverse; two
   calls there bitwise equal; back-to-back calls on rotated inputs each
   within 1e-5) and flash at
   head_dim 256 with its lse (16 query heads over 1, window 2048 at
   S=4096, bf16 and fp32), and times both at the training shapes; and
   slotted and paged decode at head_dim 256 (bf16 and fp32, g = 1, 4 and
   16, lengths 0, 1, 31, 33, 511, 512 and 2,048 over rings of 512 and
   2,048 rows and 128 pages of 16), timed with flash and the scan at
   phase 9's shapes (gemma3-1b's local and global prefill, rings, global
   layers and paged pool; RecurrentGemma's rings and its 512- and
   2,080-token prefills), each of which is also a gated case; a timed
   shape whose kernel disagrees with its plain version fails the phase.
10. the MoE and xLSTM families on the card: (a) the JAX fixture
   (``src/repro_torch/testdata/golden_moe_xlstm.npz``: qwen2-moe's smoke
   config, a tight-capacity variant whose 128-token prefills drop
   choices, xlstm-350m's smoke config; weights regenerated from the
   fixture's numpy seeds and checked against its checksums) in fp32
   through the kernels: ``forward`` logits and aux and prefill + 4
   decode-step logits within 1e-4 of JAX's, the Engine's tokens, finish
   reasons, counters and ``kv_stats`` equal to JAX's engine's (batch,
   fifo, paged, paged + prefix cache, chunked prefill; xLSTM's paged
   layout refused in the reference's words), and one training step of
   the tight variant: loss, ce, aux and every gradient leaf within 1e-4;
   (b) qwen2-moe-a2.7b at full width and depth in bf16 (24 layers, 16
   heads of 128, 60 routed experts top-4 + 4 shared, the einsum
   dispatch): 16 requests of 512 tokens, 8 new, 8 slots, fifo through
   the serve CLI, then batch, paged, a slotted fifo run of the
   shared-preamble workload, paged + prefix cache on it, prefill chunks
   of 256 and a fifo run on the gather dispatch; every request ends by
   length, launches exact (24 flash a prefill or extend call, 24 of the
   layout's decode kernel a step), paged == slotted token for token, fifo
   == batch or, where they part, the cause shown (a prompt's first layer
   alone and in the 16-row batch: the router's input bitwise equal, its
   bf16 logits at most 2 ulps apart, every moved routing decision at a
   top-5 logit gap of at most 2 ulps; fifo == batch then held in fp32 in
   (c)), the prefix run hits and the chunk run extends (their
   tokens, and the gather run's, reported against their slotted fifo
   runs: a resumed or chunked prefill routes other capacity groups, and
   the gather combine sums in another order); the fifo run traced; the
   model through the kernels against the plain versions (routing
   decisions, logits, greedy choices) reported; (c) the same width cut
   to 4 layers in fp32 on 8 prompts of 512 and 8 decode steps: every
   layer's routing decisions (top-k experts and kept choices) equal,
   logits within 1e-4 of the largest logit and greedy choices equal
   between the kernels' and the plain versions' runs, the gather and
   the einsum dispatch, and a batch prefill and the same prompts
   prefilled one at a time; a control (the plain run's router logits
   rounded to bf16) must move a routing decision; (b)'s workload through
   the Engine under fifo and batch admission with equal tokens; (d)
   qwen3-moe-235b-a22b at full width (d 4,096, 64/4 heads of 128, 128 experts top-8)
   cut to 4 layers, bf16: 8 prompts of 256 tokens, 16 new, fifo,
   launches exact, traced; (e) xlstm-350m at full width and depth (21
   mLSTM, 3 sLSTM) in bf16: 16 requests of 128 tokens, 8 new, fifo
   through the CLI and batch, no kernel launched, fifo == batch or,
   where they part, the cause shown (the first mLSTM layer's gate
   product, fp32 with 8 columns, rounding apart alone and in the batch
   on bitwise-equal input), the paged layout refused, one sLSTM layer's
   prefill kernels counted; then in fp32 the same workload fifo ==
   batch, and 8 greedy decode steps' logits within 1e-4 of the largest
   logit of ``forward``
   over the prompts and those tokens; (f) training through
   ``repro_torch.launch.train.run`` on the copy task, 3 steps:
   qwen2-moe-a2.7b at full width cut to 2 layers (2 x 2,048 tokens) and
   xlstm-350m whole (2 x 128); loss, ce and aux finite, peak memory under
   80 GB, launches exact; each fifo run's wall, tok/s, TTFT p50, decode
   ms a step and idle share beside the card's name and power limit.
   Phase 2 adds the MoE configs' shapes as gated and timed cases:
   qwen2-moe's prefill (16/16 heads of 128), fifo decode, paged decode
   and training flash with its lse (S = 2,048), qwen3-moe's prefill and
   decode (64/4 heads).
11. the encoder-decoder and the vision frontend on the card: (a) phase 2
   holds and times their shapes: flash over every key at head_dim 64
   (the 128 class) with Sq = Sk = 512 (seamless-m4t-medium's encoder
   and its cross-attention prefill) and Sq != Sk (300 over 512), with
   its lse at the training shape (1,024 over 1,024), the decoder's
   causal prefill at head_dim 64, llava-next-mistral-7b's causal
   prefill of 3,392 rows (2,880 patch rows + 512 tokens, 32/8 heads),
   slotted and paged decode at seamless's g = 1 / D = 64 and llava's g =
   4 over 3,432 rows, and decode over the cross cache (512 source rows
   of 552); (b) the JAX fixture (``src/repro_torch/testdata/
   golden_encdec.npz``: both smoke configs, weights named by numpy
   seeds) in fp32 through the kernels: ``forward``, prefill and decode
   logits within 1e-4 of JAX's, the Engine's batch, slotted fifo and
   paged fifo tokens equal to the greedy tokens of JAX's ``forward``
   loop and its batch engine, llava's slotted fifo record equal to
   JAX's, and one training step of a narrow variant of each: loss and
   every gradient leaf within 1e-4; (c) seamless-m4t-medium at full
   width and depth in bf16 (12 encoder + 12 decoder layers, 16 heads of
   64): 16 requests of 512 tokens over 512 stub frames, 32 new, 8
   slots: fifo through the serve CLI, batch and paged; every request by
   length, paged == slotted, fifo == batch or, where bf16 parts them,
   each parted request's first differing token at a tie (the two
   choices within 1e-2 of the largest logit of a B=1 ``forward`` over
   the agreed tokens) and the same runs at 4 decoder layers in fp32
   equal; launches exact:
   flash 36 a prefill call (12 encoder, 12 self, 12 cross), 24 decode
   launches a step (12 self + 12 cross; paged 12 paged + 12 slotted);
   (d) llava-next-mistral-7b at full width and depth in bf16: 8
   requests of 2,880 stub patch rows + 512 tokens, 32 new, 8 slots,
   ``max_len`` 3,432 (the CLI counts the patch rows): the same runs and
   gates, flash 32 a prefill call, 32 decode launches a step, and a
   request of 2,880 + 522 + 32 rows refused; (e) each model through the
   kernels against its plain versions (phase 9's ``model_vs_plain``:
   logits 5e-2, a moved argmax only at a top-2 gap within 1e-2 of the
   largest logit, cache leaves, the cross K/V among them, 5e-2); (f)
   training through ``repro_torch.launch.train.run`` with the CLI's
   stub inputs, 3 steps on the copy task: seamless-m4t-medium whole (2
   x 1,024 tokens over 1,024 frames) and llava-next-mistral-7b cut to 4
   layers (2 x (2,880 + 512) positions): loss finite, launches exact,
   step time and peak memory printed, under 80 GB; (g) each fifo run's
   wall, tok/s, TTFT p50, decode ms a step, traced busy time and idle
   share beside the card's name and power limit.
12. the dry run and the last two examples: (a) ``repro_torch.launch.
   dryrun`` over all 33 applicable arch x shape combinations on the
   one-card, 16 x 16 and 2 x 16 x 16 meshes, counted on the meta device
   in a pool of worker processes, and its roofline table; no FAIL, no
   launch counter moved and the card never reached in a worker, and
   each tree count equal to the parameters of every registry config
   that phases 4-11 built on the card; (b) the dry run's resident bytes
   of qwen2-1.5b (B = 8, ``max_len`` 552) and llava-next-mistral-7b (B =
   8, ``max_len`` 3,432) within 1% of the growth of ``memory_allocated``
   across building that model and its cache on the card; (c)
   qwen2-1.5b's prefill (B = 1, 512 tokens) and decode step (B = 8, 552
   rows each) timed behind the spin kernel and traced for their device
   busy time, each at or above the dry run's bound for the same call,
   printed as a share beside the card's name and power limit; (d)
   ``examples/torch_quickstart.py`` (the paper's pp3 chosen, 8 tokens
   served) and ``examples/torch_train_small.py`` (300 steps; loss below
   0.8x its first, the checkpoint restored bit for bit, 12 tokens
   sampled) at their default sizes on the card; the 16 x 16 and 2 x 16 x
   16 records of every shape the sharded steps run (train_4k and, since
   phase 14, the serving shapes) print their collective bytes a device
   by kind and ``t_collective_s``.
13. the sharded training step (ZeRO-3 over "data" x tensor parallel
   over "model", ``make_train_step(cfg, opt, mesh)``): (a) a 1 x 1 NCCL
   mesh (a world of one rank through a ``FileStore`` in a temporary
   directory) and recurrentgemma-9b at full width cut to phase 5's 5
   layers, 2 sharded steps (global batch 2 x 4,096 on the copy task, 2
   microbatches) against 2 steps of ``make_train_step`` without a mesh
   on a deep copy of the same masters and batches, under
   ``torch.use_deterministic_algorithms``: losses, gradient norms and
   every updated master equal bit for bit, or else the first leaf that
   parts and by how much, within ``SHARD_TOL``; flash and scan
   launches per step equal the unsharded step's (``train_launches``),
   counted from 0 just before the sharded run; the comm counters at 0;
   the masters, gradients and moments the sharded model holds after
   its steps (``memory_allocated`` grown across cutting and training
   it) within 1% of the dry run's resident bytes on that mesh, the
   activations' peak printed beside them; (b) with 4 or more cards, a 2
   x 2 NCCL mesh of 4 processes trains recurrentgemma-9b at all 38
   layers 2 steps: losses finite, each card's peak and held memory
   against the dry run's bytes a device, step times; with fewer cards
   it prints ``mesh 2x2: not run (<n> card)``.
14. the sharded prefill and serve steps (``make_prefill_step(cfg, *,
   max_len, mesh)``, ``make_serve_step(cfg, mesh)``: ZeRO-3 gathers over
   "data", tensor parallel over "model", the decode cache placed by the
   cache rules): (a) on a 1 x 1 NCCL mesh, qwen2-1.5b at full width and
   depth and recurrentgemma-9b at phase 5's 5-layer cut, 8 prompts of
   512 tokens (``max_len`` 552), prefill + 31 greedy steps, against
   ``T.prefill`` / ``T.decode_step`` on the compute copy of the same
   masters under ``torch.use_deterministic_algorithms``: logits, tokens
   and the last cache bit for bit, the flash, decode and scan launches
   equal (counted from 0 just before the sharded run) and no
   ``return_lse`` call (one rank holds every row), no collective,
   the held masters and cache within 1% of the dry run's resident bytes
   a device; (b) the decode kernel with ``return_lse`` over 2 and 4 row
   ranges of one cache at qwen2-1.5b's heads (12/2, D = 128, B = 8, S =
   32,768, lengths that leave ranges empty), merged by
   ``sharding.combine_partials``, against the kernel over the whole
   cache and the plain version (2e-3 bf16, 2e-5 fp32), and the lse call
   timed against the default call at that shape; (c) with 4 or more
   cards a 2 x 2 NCCL mesh of 4 processes serves qwen2-1.5b at 8 x 512
   (its cache by kv heads) and at one 4,096-token prompt in a
   32,768-row cache (by sequence over ("data", "model")), and
   recurrentgemma-9b whole (38 layers; its rings by sequence over
   "model"), prefill + 8 steps fed the one-card unsharded run's greedy
   tokens, and in fp32 fed the same tokens: the bf16 logits' distance
   from the one-card fp32 run at most 1.25x the one-card bf16 run's own
   distance from it (``MESH_BF16_FACTOR``), the fp32 logits within 1e-4
   of the one-card fp32 run's largest logit with every greedy choice
   equal, bf16 greedy choices equal or parted only at a top-2 gap within
   1e-2, each rank's
   collectives of every call equal to the dry run's count, each rank's
   launches in each run (counted from 0 just before it) those of the
   code, the decode kernel's ``return_lse`` calls (counted apart) one
   per sequence-sharded attention layer a step and not zero over the
   runs; with fewer cards it prints ``mesh 2x2: not run (<n> card)``. Phase 2 adds the
   decode kernel's ``return_lse`` output on every decode case (the fp32
   ``o`` and ``lse`` against the plain version's, ``o`` rounded bit for
   bit the default call's); phase 12's records add the serving shapes'
   collective terms (prefill_32k, decode_32k, long_500k of the five
   shardable configs on 16 x 16 and 2 x 16 x 16).
15. MoE expert parallelism through the sharded steps (``models.moe``
   under ``ShardCtx``: every rank routes its rows over all experts, runs
   its own, and the partial outputs are summed over "model" once a
   layer): (a) on a 1 x 1 NCCL mesh under
   ``torch.use_deterministic_algorithms``, 2 sharded train steps (global
   batch 2 x 1,024 on the copy task) of qwen3-moe-235b-a22b at full
   width cut to 1 layer (the most whose training state fits one card)
   and of qwen2-moe-a2.7b at full width cut to 6 layers under the einsum
   and the gather dispatch, each against 2 steps of ``make_train_step``
   without a mesh from the same masters: metrics and every master bit
   for bit, flash launches the code's, no collective, the held masters,
   gradients and moments within 0.05% of the dry run's resident bytes;
   then the sharded prefill and 8 serve steps of qwen3-moe at phase 10's
   4 layers and of qwen2-moe at 6 under both dispatches (8 prompts of
   512 tokens) against ``T.prefill`` / ``T.decode_step`` on the compute
   copy: logits, tokens and cache bit for bit, flash and decode
   launches the code's, no collective, held bytes within 0.05% of the
   dry run's; (b) with 4 or more cards, qwen3-moe on 1 x 4 (32 experts
   a card) and 2 x 2, qwen2-moe on 2 x 2 (30 experts a card, by expert:
   the per-expert tensor-parallel fallback needs a "model" axis that 60
   does not divide, which the CPU tests and the dry run hold): served as
   phase 14 (c) serves (bf16 by the fp32 control, its parted greedy
   choices reported: a bf16 routing decision turns on a rounding that
   depends on a rank's rows; fp32 within 1e-4, every choice equal;
   collectives the dry run's) and trained 2 steps in bf16 (within 1e-2
   of (a)'s unsharded run) and in fp32 (within 1e-4 of the one-card
   fp32 run), each rank's last-step collectives the dry run's; with
   fewer cards it prints ``not run``.
16. the xLSTM, encoder-decoder and vision-frontend families through the
   sharded steps (``models.ssm`` on the rank's heads, the encoder, the
   cross attention and its cache and the projector under ``ShardCtx``):
   (a) on a 1 x 1 NCCL mesh under ``torch.use_deterministic_algorithms``,
   2 sharded train steps on the copy task of xlstm-350m whole (2 x 256),
   seamless-m4t-medium whole (2 x 256 over a source of 256 frames) and
   llava-next-mistral-7b cut to 4 layers (2 x (2,880 patch rows + 256)),
   each against 2 steps of ``make_train_step`` without a mesh from the
   same masters: metrics and every master bit for bit, flash launches
   the code's (none for xLSTM), no collective, held bytes within 1% of
   the dry run's; then the sharded prefill and 8 serve steps of the three
   whole (xlstm 8 x 128, seamless 8 x 512 over 512 frames, llava 4 x
   (2,880 + 256)) against ``T.prefill`` / ``T.decode_step`` on the
   compute copy: logits, tokens and cache bit for bit, flash and decode
   launches the code's (seamless: 36 a prefill, 12 encoder + 12 self + 12
   cross; 24 decode a step), no collective, held bytes within 1%; (b)
   with 4 or more cards, the three served on 2 x 2 as phase 14 (c)
   serves; with fewer cards it prints ``not run``.

``--phases`` runs a subset and prints no result line (``--phases 8``
runs phase 8 after the build). With all phases, the line before the
last holds the kernels' summary as JSON (an entry per kernel and main
path, with its timed shape and path: qwen2-1.5b's, the training run's,
phase 9's at head_dim 256, phase 10's MoE shapes, phase 11's
encoder-decoder and vision shapes, phase 13's sharded step, phase
14's sharded serving steps, phase 15's sharded MoE serving steps,
phase 16's encoder-decoder and vision serving steps and, with 4 cards,
the decode kernel's lse
call with phase 14 (c)'s launches), after a line with phase 8's
launches by path; the last line is ``{"ok": true, "device": {...}}``.
Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = SRC / "repro_torch" / "testdata" / "golden_cm.npz"
GOLDEN_TRAIN = SRC / "repro_torch" / "testdata" / "golden_train.npz"
GOLDEN_PREFIX = SRC / "repro_torch" / "testdata" / "golden_prefix.npz"
L2_BYTES = 50e6
SM_HZ = 1.98e9                  # H100 SXM boost clock: spin cycles per s
TOL = {("prefill", "float32"): 2e-5, ("prefill", "bfloat16"): 2e-2,
       ("decode", "float32"): 2e-5, ("decode", "bfloat16"): 3e-2,
       # this slice's kernels in bf16: set from the errors measured on the
       # H100 (extend 9.8e-4, paged 1.2e-4), so a mask or a page off by
       # one row shows; typical outputs are about 0.07 here
       ("extend", "float32"): 2e-5, ("extend", "bfloat16"): 5e-3,
       ("paged", "float32"): 2e-5, ("paged", "bfloat16"): 2e-3}
SERVE_ARGS = ["--arch", "qwen2_1_5b", "--no-smoke", "--slots", "8",
              "--requests", "16", "--prompt-len", "512", "--max-new", "32",
              "--device", "cuda"]
# the phase 4 runs, in order: label -> serve CLI arguments after SERVE_ARGS
SERVE_RUNS = {
    "fifo": ["--policy", "fifo"],
    "batch": ["--policy", "batch"],
    "paged": ["--policy", "fifo", "--paged", "--block-size", "16"],
    # 264 usable blocks: 8 prompts take 256, growth at row 512 the
    # rest, so growth at row 528 must preempt
    "paged-tight": ["--policy", "fifo", "--paged", "--block-size", "16",
                    "--num-blocks", "265"],
    "prefix": ["--policy", "fifo", "--prefix-cache", "--block-size", "16"],
    "prefix-chunked": ["--policy", "fifo", "--prefix-cache", "--block-size",
                       "16", "--prefill-chunk", "128"],
}


class PhaseFailed(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


# seconds of each timed part of a phase (``part``), by label
PART_S: dict = {}


@contextlib.contextmanager
def part(label: str):
    """Time one part of a phase: its seconds printed when it ends and
    kept in ``PART_S`` (the ``--out`` record's ``part_s``)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PART_S[label] = round(time.perf_counter() - t0, 2)
        say(f"  # part {label}: {PART_S[label]:.1f} s")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    times = build.build_all()
    build_s = time.perf_counter() - t0
    for stem in build.sources():
        log = build.lib_path(stem).with_suffix(".log").read_text()
        if shutil.which("c++filt"):
            log = subprocess.run(["c++filt"], input=log, capture_output=True,
                                 text=True).stdout
        for line in log.splitlines():
            if "Compiling entry" in line:
                say(f"  ptxas {stem}: {line.split('function')[-1].strip()}")
            elif "registers" in line or "spill" in line:
                say(f"  ptxas {stem}:   {line.replace('ptxas info    :', '').strip()}")
    say(f"[1/16] device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; kernels built in "
        f"{build_s:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in times.items()) or 'cached'})")
    return {"nvidia_smi": smi, "build_s": build_s}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

FA_CASES = [
    # (b, sq, sk, h, hk, d, causal, window, dtype): tests/test_kernels.py
    # FA_CASES, then ragged and odd shapes, then the serving prefills
    (2, 64, 64, 4, 2, 32, True, 0, "float32"),
    (2, 128, 128, 4, 1, 64, True, 24, "float32"),
    (2, 32, 32, 2, 2, 16, False, 0, "float32"),
    (2, 64, 64, 8, 4, 128, True, 0, "bfloat16"),
    (2, 96, 96, 4, 4, 64, True, 32, "float32"),
    (2, 256, 256, 2, 1, 128, True, 0, "bfloat16"),
    (2, 37, 37, 4, 2, 16, True, 0, "float32"),
    (1, 37, 37, 12, 2, 128, True, 0, "bfloat16"),
    (2, 37, 37, 4, 2, 12, True, 0, "float32"),
    (2, 20, 45, 4, 1, 64, False, 0, "float32"),
    (1, 512, 512, 12, 2, 128, True, 0, "bfloat16"),    # fifo: one request
    (16, 512, 512, 12, 2, 128, True, 0, "bfloat16"),   # batch: the bucket
    # the tensor-core body's edges, bf16: head dims 16, 64, 96, 192 and
    # 12 (not a multiple of 8: element-wise loads), lengths that are no
    # multiple of the 64-position q-tile or the 64- (32- at D > 128) row
    # KV tile, Sq != Sk, g = 1, 16 and 128, windows that cut a KV tile
    (2, 100, 100, 4, 2, 16, True, 0, "bfloat16"),
    (1, 130, 130, 8, 2, 64, True, 0, "bfloat16"),
    (2, 77, 77, 6, 3, 96, True, 40, "bfloat16"),
    (1, 150, 150, 4, 1, 192, True, 0, "bfloat16"),
    (2, 37, 37, 4, 2, 12, True, 0, "bfloat16"),
    (1, 70, 133, 4, 2, 128, False, 0, "bfloat16"),
    (2, 90, 90, 4, 4, 128, True, 0, "bfloat16"),
    (1, 200, 200, 16, 1, 128, True, 0, "bfloat16"),
    (1, 40, 40, 128, 1, 64, True, 0, "bfloat16"),
    (1, 300, 300, 16, 1, 256, True, 50, "bfloat16"),
]
# the serving runs' cache: --prompt-len 512 + --max-new 32 + 8 rows
SERVE_S = 512 + 32 + 8
FIFO_LENS = [1, 513, 518, 523, 528, 533, 538, 544]  # one free slot
EDGE_LENS = [0, 1, 31, 33, 80, 300, 551, SERVE_S]
DEC_CASES = [
    # (b, h, hk, d, s, dtype, lengths or None = random in [1, s]):
    # tests/test_kernels.py DEC_CASES, ragged lengths, the serving decodes
    (2, 4, 2, 32, 64, "float32", None),
    (3, 8, 1, 64, 128, "float32", None),
    (1, 4, 4, 128, 256, "bfloat16", None),
    (4, 16, 2, 64, 96, "float32", None),
    (5, 4, 2, 12, 45, "float32", [0, 1, 45, 17, 33]),
    (4, 12, 2, 128, 300, "bfloat16", [1, 0, 300, 129]),
    (8, 12, 2, 128, 1024, "bfloat16",
     [520, 544, 1, 1024, 700, 512, 33, 600]),
    (8, 12, 2, 128, SERVE_S, "bfloat16", FIFO_LENS),   # fifo decode step
    (16, 12, 2, 128, SERVE_S, "bfloat16", [528] * 16),  # batch decode step
    # the redesigned body's edges: lengths 0, 1, 31, 33, 80 (ends the
    # second 64-row split mid-tile), the full S; rows of 24 bytes (D=12
    # in bf16) take the element-wise loads
    (8, 12, 2, 128, SERVE_S, "bfloat16", EDGE_LENS),
    (8, 12, 2, 128, SERVE_S, "float32", EDGE_LENS),
    (5, 4, 2, 12, 45, "bfloat16", [0, 1, 45, 17, 33]),
]
# head_dim 256 (the kernel's second head-dim class), bf16 and fp32: g = 4
# over gemma3-1b's rings of 512 rows, g = 16 (RecurrentGemma) and g = 1
# over rings of 2,048, at lengths 0, 1, 31, 33 (a tile's edges), 511,
# 512 and 2,048 (a full ring)
RING_LENS = [0, 1, 31, 33, 511, 512, 2048]
# chatglm3-6b's decode: 32 query heads over 2 KV heads (g = 16, the
# largest group) at head_dim 128, and llama3.2-3b's g = 3
DEC_CASES += [(8, 32, 2, 128, 280, dtn, [0, 1, 31, 33, 200, 257, 271, 280])
              for dtn in ("bfloat16", "float32")]
DEC_CASES += [(8, 24, 8, 128, 280, "bfloat16",
               [0, 1, 31, 33, 200, 257, 271, 280])]
DEC_CASES += [case for dtn in ("bfloat16", "float32") for case in (
    (6, 4, 1, 256, 512, dtn, RING_LENS[:-1]),
    (7, 16, 1, 256, 2048, dtn, RING_LENS),
    (7, 1, 1, 256, 2048, dtn, RING_LENS))]
# the paged runs: max_len 552 rounds up to 35 pages of 16 rows, and a
# pool at slotted parity holds 8 * 35 blocks + the null block
BS, PAGES = 16, 35
PARITY_BLOCKS = 8 * PAGES + 1
# phase 10's qwen3-moe prompts
Q3_PROMPT = 256
# phase 9's serving shapes at head_dim 256, 8 slots: gemma3-1b's rows a
# slot (1,024-token prompts + 32 new + 8), 67 pages of 16 when paged;
# RecurrentGemma's local window
G3_S = 1024 + 32 + 8
G3_PAGES = -(-G3_S // BS)
RG_WINDOW = 2048
# the shapes the serving runs give the kernels, timed below; "fifo" (the
# main path) and phase 9's shapes go into the kernels line, "batch" into
# the --out record; phase 9's (head_dim 256) are gated cases as well.
# Flash: (B, S, H, Hk, D, window), causal;
SERVE_FA = {"fifo": (1, 512, 12, 2, 128, 0), "batch": (16, 512, 12, 2, 128, 0),
            # phase 10: qwen2-moe-a2.7b's MHA (g = 1) and qwen3-moe's 64
            # query heads over 4 (g = 16) on their prompts
            "qwen2-moe": (1, 512, 16, 16, 128, 0),
            "qwen3-moe": (1, Q3_PROMPT, 64, 4, 128, 0),
            # gemma3-1b's local and global layers on a 1,024-token prompt
            "gemma3-local": (1, 1024, 4, 1, 256, 512),
            "gemma3-global": (1, 1024, 4, 1, 256, 0),
            # RecurrentGemma's local layers on its 512- and 2,080-token
            # prompts
            "recurrentgemma-local": (1, 512, 16, 1, 256, RG_WINDOW),
            "recurrentgemma-long": (1, 2080, 16, 1, 256, RG_WINDOW)}
# slotted decode: (H, Hk, D, S, slot lengths)
SERVE_DEC = {"fifo": (12, 2, 128, SERVE_S, FIFO_LENS),
             "batch": (12, 2, 128, SERVE_S, [528] * 16),
             # phase 10: qwen2-moe-a2.7b's fifo step, and qwen3-moe's 8
             # slots 1 to 15 tokens past their prompts
             "qwen2-moe": (16, 16, 128, SERVE_S, FIFO_LENS),
             "qwen3-moe": (64, 4, 128, Q3_PROMPT + 24,
                           [Q3_PROMPT + 1 + 2 * i for i in range(8)]),
             # gemma3-1b's full rings of 512, and its global layers
             "gemma3-local": (4, 1, 256, 512, [512] * 8),
             "gemma3-global": (4, 1, 256, G3_S, [1040] * 8),
             # RecurrentGemma's rings: 6 slots near 528 rows, 2 wrapped
             "recurrentgemma-local": (16, 1, 256, RG_WINDOW,
                                      [528] * 6 + [RG_WINDOW] * 2)}
# paged decode: (H, Hk, D, pool blocks, block size, pages, slot lengths)
SERVE_PAGED = {"fifo": (12, 2, 128, PARITY_BLOCKS, BS, PAGES, FIFO_LENS),
               "qwen2-moe": (16, 16, 128, PARITY_BLOCKS, BS, PAGES,
                             FIFO_LENS),
               # gemma3-1b's 4 global layers at slotted parity
               "gemma3-global": (4, 1, 256, 8 * G3_PAGES + 1, BS, G3_PAGES,
                                 [1040] * 8)}
# phase 11's serving shapes: seamless-m4t-medium (16/16 heads of 64, g =
# 1): the decoder's causal prefill of 512 tokens, slotted and paged
# decode at phase 4's slot lengths, and decode over the cross cache (512
# source rows of 552; the free slot holds none); llava-next-mistral-7b
# (32/8 heads of 128, g = 4): 2,880 patch rows + 512 prompt tokens
# prefilled, 3,432 rows a slot (215 pages of 16)
LL_PREFILL = 2880 + 512
LL_S = LL_PREFILL + 32 + 8
LL_PAGES = -(-LL_S // BS)
LL_LENS = [1] + [LL_PREFILL + 1 + 5 * i for i in range(7)]  # one free slot
CROSS_LENS = [0] + [512] * 7
SERVE_FA.update({"seamless-decoder": (1, 512, 16, 16, 64, 0),
                 "llava": (1, LL_PREFILL, 32, 8, 128, 0)})
SERVE_DEC.update({"seamless": (16, 16, 64, SERVE_S, FIFO_LENS),
                  "seamless-cross": (16, 16, 64, SERVE_S, CROSS_LENS),
                  "llava": (32, 8, 128, LL_S, LL_LENS)})
SERVE_PAGED.update({"seamless": (16, 16, 64, PARITY_BLOCKS, BS, PAGES,
                                 FIFO_LENS),
                    "llava": (32, 8, 128, 8 * LL_PAGES + 1, BS, LL_PAGES,
                              LL_LENS)})
# flash over every key (``causal=False``), timed: (B, Sq, Sk, H, Hk, D):
# seamless's encoder (its cross-attention prefill has the same shape:
# 512 prompt rows over 512 source rows) and a cross-attention with Sq !=
# Sk
SERVE_FA_BIDIR = {"seamless-encoder": (1, 512, 512, 16, 16, 64),
                  "seamless-cross": (1, 300, 512, 16, 16, 64)}
ENCDEC_SHAPES = ("seamless", "seamless-cross", "seamless-decoder", "llava")
# phase 16's serving shapes, as its sharded steps run them on the 1 x 1
# mesh (``FAM16``): seamless-m4t-medium's 8 prompts of 512 tokens over
# 512 frames (the encoder and the cross-attention prefill over every
# key, the decoder's causal self-attention; decode at the run's middle
# step, 516 rows of 528, and over the cross cache's 512 source rows),
# llava-next-mistral-7b's 4 prompts of 2,880 patch rows + 256 tokens
# (decode at 3,140 rows of 3,152)
LL16 = 2880 + 256
SERVE_FA.update({"seamless16-decoder": (8, 512, 16, 16, 64, 0),
                 "llava16": (4, LL16, 32, 8, 128, 0)})
SERVE_FA_BIDIR["seamless16-encoder"] = (8, 512, 512, 16, 16, 64)
SERVE_DEC.update({"seamless16": (16, 16, 64, 528, [516] * 8),
                  "seamless16-cross": (16, 16, 64, 528, [512] * 8),
                  "llava16": (32, 8, 128, LL16 + 16, [LL16 + 4] * 4)})
# phase 9's (head_dim 256), phase 10's (the MoE configs) and phase 11's
# serving shapes are gated cases as well
MOE_SHAPES = ("qwen2-moe", "qwen3-moe")
FA_CASES += [(b, s, s, h, hk, d, True, w, "bfloat16")
             for p, (b, s, h, hk, d, w) in SERVE_FA.items()
             if d == 256 or p in MOE_SHAPES + ENCDEC_SHAPES]
FA_CASES += [(b, sq, sk, h, hk, d, False, 0, "bfloat16")
             for b, sq, sk, h, hk, d in SERVE_FA_BIDIR.values()]
# every key at head_dim 64 (the 128 class, half of each tile idle): fp32,
# Sq > Sk, lengths that end mid-tile, g = 2 and B > 1
FA_CASES += [(2, 300, 512, 16, 16, 64, False, 0, "float32"),
             (2, 200, 77, 4, 2, 64, False, 0, "bfloat16"),
             (3, 65, 130, 16, 16, 64, False, 0, "bfloat16")]
DEC_CASES += [(len(lens), h, hk, d, s, "bfloat16", lens)
              for p, (h, hk, d, s, lens) in SERVE_DEC.items()
              if d == 256 or p in MOE_SHAPES + ENCDEC_SHAPES]
# seamless's g = 1 at head_dim 64 in fp32, at the decode edge lengths
DEC_CASES += [(8, 16, 16, 64, SERVE_S, "float32", EDGE_LENS)]
# flash over every key with its lse, as the encoder-decoder's training
# backward reads it: (b, sq, sk, h, hk, d, dtype); seamless's training
# shape (1,024 positions over 1,024 frames), Sq != Sk in fp32, g = 2
BIDIR_LSE_CASES = [(1, 1024, 1024, 16, 16, 64, "bfloat16"),
                   (2, 300, 512, 16, 16, 64, "float32"),
                   (1, 77, 200, 4, 2, 64, "bfloat16")]
PAGED_CASES = [
    # (b, h, hk, d, num_blocks, block_size, pages, dtype, lengths or None
    # = random in [1, pages * bs]); tables random over [0, N), so they
    # name the null block and repeat blocks: tests/test_kernels.py
    # PAGED_CASES, then lengths 0 and 1, then the paged fifo decode step
    (2, 4, 2, 32, 9, 8, 4, "float32", None),
    (3, 8, 1, 64, 5, 16, 2, "float32", None),
    (1, 4, 4, 128, 17, 8, 8, "bfloat16", None),
    (4, 8, 2, 64, 13, 16, 3, "float32", None),
    (4, 12, 2, 128, 40, 16, 5, "bfloat16", [0, 1, 80, 33]),
    (5, 4, 2, 12, 11, 8, 3, "float32", [1, 0, 24, 9, 17]),
    (8, 12, 2, 128, PARITY_BLOCKS, BS, PAGES, "bfloat16", FIFO_LENS),
    # the redesigned body's edges over random tables (null and repeated
    # blocks): the decode edge lengths at bs = 8 and 16, and D=12 in bf16
    (8, 12, 2, 128, 100, 8, 69, "bfloat16", EDGE_LENS),
    (8, 12, 2, 128, 60, 16, 35, "bfloat16", EDGE_LENS),
    (5, 4, 2, 12, 11, 8, 3, "bfloat16", [1, 0, 24, 9, 17]),
]
# head_dim 256 over random tables of 128 pages of 16 rows (2,048 rows)
PAGED_CASES += [(7, g, 1, 256, 300, 16, 128, dtn, RING_LENS)
                for dtn in ("bfloat16", "float32") for g in (1, 4, 16)]
PAGED_CASES += [(8, 32, 2, 128, 200, 16, 18, "bfloat16",
                 [0, 1, 31, 33, 200, 257, 271, 280])]
PAGED_CASES += [(len(lens), h, hk, d, n, bs, nb, "bfloat16", lens)
                for p, (h, hk, d, n, bs, nb, lens) in SERVE_PAGED.items()
                if d == 256 or p in MOE_SHAPES + ENCDEC_SHAPES]
# the serving pools get the serving runs' tables (fifo_tables)
SERVE_POOLS = {shape[3] for shape in SERVE_PAGED.values()}
OFFSET_CASES = [
    # (b, sq, sk, h, hk, d, q_offset, kv_len, dtype): flash with the
    # ragged mask of chunked prefill and prefix resume; small fp32 cases
    # (a chunk padded past kv_len, B=2 at different offsets), then the
    # serving runs' extend calls
    (1, 8, 24, 4, 2, 16, [5], [13], "float32"),
    (2, 6, 20, 6, 2, 16, [3, 11], [9, 17], "float32"),
    (2, 5, 40, 4, 2, 12, [0, 21], [5, 26], "float32"),
    (1, 256, 560, 12, 2, 128, [256], [512], "bfloat16"),
    (1, 128, 640, 12, 2, 128, [384], [512], "bfloat16"),
    (2, 128, 640, 12, 2, 128, [128, 384], [256, 512], "bfloat16"),
    # kv_len ending mid-tile, and a chunk padded past kv_len, bf16
    (2, 70, 200, 8, 2, 128, [30, 100], [100, 170], "bfloat16"),
    (1, 48, 160, 4, 1, 64, [77], [101], "bfloat16"),
]
# flash on B sequences at once against each sequence alone, bit for bit
# (fifo = batch tokens rest on it): (b, sq, sk, h, hk, d, window,
# q_offset, kv_len or None), bf16, causal
BATCH_CASES = [
    (3, 150, 150, 12, 2, 128, 0, None, None),
    (3, 70, 200, 8, 2, 128, 0, [0, 30, 100], [70, 100, 170]),
    (2, 100, 100, 16, 1, 256, 50, None, None),
]
# the extend calls timed below: prefix resume (a 256-token tail over a
# 560-row scratch), a 128-token chunk over a 640-row scratch, and a
# ragged batch of two chunks
SERVE_EXT = {"prefix": OFFSET_CASES[3], "chunk": OFFSET_CASES[4],
             "ragged": OFFSET_CASES[5]}
# the training run: recurrentgemma-9b at full width, sequences of 4096
TRAIN_S, TRAIN_D, TRAIN_WINDOW = 4096, 4096, 2048
SCAN_CASES = [
    # (B, S, D): tests/test_kernels.py SCAN_CASES (S=17/100 and D=40/96
    # tails), then the full-width training shape; fp32, tol 1e-5
    (2, 64, 128), (3, 100, 96), (1, 256, 512), (2, 17, 40),
    (1, TRAIN_S, TRAIN_D),
    # the chunked body's edges: several chunks with a partial last one
    # and B > 1, D not a multiple of 4 (the scalar path), S = 1
    (2, 1000, 512), (2, 300, 37), (3, 1, 64),
]
SCAN_ROTATED = (2, 1000, 512, 3)    # back-to-back calls on 3 input copies
FA256_CASES = [
    # (b, s, h, hk, d, window, dtype): head_dim 256 (and a ragged 192 in
    # the same instantiation), causal, with the log-sum-exp; small
    # ragged cases, then the training shape in bf16 and fp32
    (2, 37, 16, 1, 256, 8, "float32"),
    (1, 100, 4, 2, 256, 0, "bfloat16"),
    (2, 50, 4, 1, 192, 16, "float32"),
    (1, 300, 16, 1, 256, 50, "bfloat16"),
    (1, TRAIN_S, 16, 1, 256, TRAIN_WINDOW, "bfloat16"),
    (1, TRAIN_S, 16, 1, 256, TRAIN_WINDOW, "float32"),
    # phase 10's training shape: qwen2-moe-a2.7b's 16 heads of 128 (MHA)
    # over 2,048 positions, no window
    (1, 2048, 16, 16, 128, 0, "bfloat16"),
]
# flash with its lse at the training shapes, timed: (B, S, H, Hk, D,
# window), causal
TRAIN_FA = {"train": (1, TRAIN_S, 16, 1, 256, TRAIN_WINDOW),
            "qwen2-moe-train": (1, 2048, 16, 16, 128, 0)}
# lse tolerance: fp32 as the output; bf16 inputs meet the same fp32
# arithmetic on both sides, so the rows' lse agree far closer than o
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}
SCAN_TOL = 1e-5


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``. The device is held by a spin kernel
    while the host enqueues the timed loop, so the events time the
    kernels and not the host's launch rate (a slow host would otherwise
    set the figure)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * host_s * SM_HZ) + 10 ** 6)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(nbytes: int) -> int:
    """Copies of a call's inputs to take in turn so that together they
    touch twice the L2, and each timed call reads its inputs from HBM.
    Decode finds its caches so in serving (a layer's cache was last
    touched a step ago); prefill's q, k and v, just written by RoPE, may
    still be in the L2 there, so its time here is an upper estimate."""
    return max(2, -(-int(2 * L2_BYTES) // nbytes))


def cycle(items):
    """A callable that returns the next of ``items`` on each call."""
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]
    return nxt


def sdpa(q, k, v, causal=False, mask=None):
    """The library's attention over (B, H, S, D) inputs with Hk <= H
    key/value heads: the yardstick of ``library_ms`` only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, enable_gqa=True)


def bound(cost, dtn: str) -> dict:
    """The least time the card could take for a call of the kernel's
    ``cost`` (its cost function's operations and bytes): the larger of
    the bytes over HBM's rate and the operations over the peak rate of
    the input type."""
    from repro_torch.launch import mesh
    flops, nbytes = cost.flops, cost.bytes
    t_ops, t_bytes = flops / mesh.PEAK_FLOPS[dtn], nbytes / mesh.HBM_BW
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "fp32_fma_ms": flops / mesh.PEAK_FLOPS_FP32 * 1e3}


def err_vs(torch, out, ref, tol):
    a, b = out.float(), ref.float()
    bad = ((a - b).abs() > tol + tol * b.abs()).any().item()
    finite = torch.isfinite(a).all().item()
    return (a - b).abs().max().item(), bool(finite and not bad)


def held(torch, what: str, out, ref, tol) -> float:
    """``err_vs`` at a timed shape: the max |err|, or PhaseFailed when
    the kernel disagrees with its plain version there."""
    err, ok = err_vs(torch, out, ref, tol)
    if not ok:
        raise PhaseFailed(f"{what} at a timed shape: max |err| {err:.3g} "
                          f"outside tol {tol:g}")
    return err


def time_flash(torch, fa_ops, fa_ref, rnd, shape) -> dict:
    b, sq, h, hk, d, w = shape
    dtn = "bfloat16"
    dt = getattr(torch, dtn)
    cost = fa_ops.flash_attention_cost((b, sq, h, d), (b, sq, hk, d),
                                       window=w)
    copies = [(rnd((b, sq, h, d), dt), rnd((b, sq, hk, d), dt),
               rnd((b, sq, hk, d), dt)) for _ in range(n_copies(cost.bytes))]
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in c) for c in copies]
    nxt, nxt_l = cycle(copies), cycle(bhsd)
    pos = torch.arange(sq, device="cuda")
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < w) \
        if w else None
    q, k, v = copies[0]
    err = held(torch, "flash", fa_ops.flash_attention(q, k, v, window=w),
               fa_ref.attention_ref(q, k, v, window=w),
               TOL[("prefill", dtn)])
    return {"shape": f"B={b} Sq=Sk={sq} H={h}/{hk} D={d} {dtn} causal"
                     f"{f' window {w}' if w else ''}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                *nxt(), window=w)),
            "plain_ms": cuda_ms(torch, lambda: fa_ref.attention_ref(
                *nxt(), window=w)),
            "library_ms": cuda_ms(torch, lambda: sdpa(
                *nxt_l(), causal=mask is None, mask=mask)),
            "copies": len(copies), **bound(cost, dtn)}


def time_flash_bidir(torch, fa_ops, fa_ref, rnd, shape) -> dict:
    """Flash over every key (``causal=False``, Sq and Sk free) in bf16,
    as the encoder's self-attention and cross-attention call it."""
    b, sq, sk, h, hk, d = shape
    dtn = "bfloat16"
    dt = getattr(torch, dtn)
    cost = fa_ops.flash_attention_cost((b, sq, h, d), (b, sk, hk, d),
                                       causal=False)
    copies = [(rnd((b, sq, h, d), dt), rnd((b, sk, hk, d), dt),
               rnd((b, sk, hk, d), dt)) for _ in range(n_copies(cost.bytes))]
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in c) for c in copies]
    nxt, nxt_l = cycle(copies), cycle(bhsd)
    q, k, v = copies[0]
    err = held(torch, "flash over every key",
               fa_ops.flash_attention(q, k, v, causal=False),
               fa_ref.attention_ref(q, k, v, causal=False),
               TOL[("prefill", dtn)])
    return {"shape": f"B={b} Sq={sq} Sk={sk} H={h}/{hk} D={d} {dtn}, "
                     f"every key",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                *nxt(), causal=False)),
            "plain_ms": cuda_ms(torch, lambda: fa_ref.attention_ref(
                *nxt(), causal=False)),
            "library_ms": cuda_ms(torch, lambda: sdpa(*nxt_l())),
            "copies": len(copies), **bound(cost, dtn)}


def lse_err(torch, got, want, tol):
    """``err_vs`` of two log-sum-exps whose -inf (rows with no live key)
    must fall at the same places: the max |err| over the finite rest."""
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf) or (got[inf] > 0).any() \
            or torch.isnan(got).any():
        return float("inf"), False
    return err_vs(torch, got[~inf], want[~inf], tol) if (~inf).any() \
        else (0.0, True)


def decode_lse_rows(torch, da_ops, da_ref, q, kc, vc, lengths, out, tag):
    """The decode kernel with ``return_lse`` on one case: its fp32 ``o``
    and ``lse`` against the plain version's, and its ``o`` rounded to the
    input type bit for bit the default call's ``out``: (tag, err, tol,
    ok) rows."""
    dtn = str(q.dtype).split(".")[-1]
    o, lse = da_ops.decode_attention(q, kc, vc, lengths, return_lse=True)
    ro, rlse = da_ref.decode_attention_ref(q, kc, vc, lengths,
                                           return_lse=True)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[("decode", dtn)], LSE_TOL[dtn]
    err_o, ok_o = err_vs(torch, o, ro, tol_o)
    err_l, ok_l = lse_err(torch, lse, rlse, tol_lse)
    rounded = o.to(q.dtype)
    return [(f"{tag} lse: o", err_o, tol_o, ok_o),
            (f"{tag} lse: lse", err_l, tol_lse, ok_l),
            (f"{tag} lse: o rounded == the default call",
             float((rounded.float() - out.float()).abs().max()), 0.0,
             torch.equal(rounded, out))]


def time_decode(torch, da_ops, da_ref, rnd, shape, lse: bool = False
                ) -> dict:
    """Slotted decode at ``shape`` (h, hk, d, s, lens) in bf16, timed
    against its plain version and SDPA; with ``lse`` the call that also
    returns the fp32 output and the log-sum-exp (the flash-decode
    partial)."""
    h, hk, d, s, lens = shape
    b, dtn = len(lens), "bfloat16"
    dt = getattr(torch, dtn)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = sum(lens)
    cost = da_ops.decode_attention_cost(b, h, hk, d, live_rows=live,
                                        return_lse=lse)
    copies = [(rnd((b, h, d), dt), rnd((b, s, hk, d), dt),
               rnd((b, s, hk, d), dt), lengths)
              for _ in range(n_copies(cost.bytes))]
    mask = (torch.arange(s, device="cuda")[None]
            < lengths[:, None])[:, None, None]
    sdpa_in = [(c[0][:, :, None], c[1].transpose(1, 2).contiguous(),
                c[2].transpose(1, 2).contiguous()) for c in copies]
    nxt, nxt_l = cycle(copies), cycle(sdpa_in)
    q, kc, vc, _ = copies[0]
    kw = {"return_lse": True} if lse else {}

    def first(out):
        return out[0] if lse else out
    err = held(torch, "decode", first(da_ops.decode_attention(
        q, kc, vc, lengths, **kw)), first(da_ref.decode_attention_ref(
            q, kc, vc, lengths, **kw)), TOL[("decode", dtn)])
    return {"shape": f"B={b} S={s} H={h}/{hk} D={d} {dtn}, {live} live rows"
                     f"{', return_lse (fp32 o + lse)' if lse else ''}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: da_ops.decode_attention(*nxt(),
                                                                 **kw)),
            "plain_ms": cuda_ms(torch, lambda: da_ref.decode_attention_ref(
                *nxt(), **kw)),
            "library_ms": cuda_ms(torch, lambda: sdpa(*nxt_l(), mask=mask)),
            "copies": len(copies), **bound(cost, dtn)}


def offset_mask(torch, b, sq, sk, q_offset, kv_len):
    """The live (query, key) pairs of a causal extend: (B, Sq, Sk)."""
    qp = torch.tensor(q_offset, device="cuda")[:, None] + torch.arange(
        sq, device="cuda")[None]
    kp = torch.arange(sk, device="cuda")
    kl = torch.tensor(kv_len, device="cuda")
    return (kp[None, None] < kl[:, None, None]) & (kp[None, None]
                                                    <= qp[:, :, None])


def time_flash_extend(torch, fa_ops, fa_ref, rnd, case) -> dict:
    b, sq, sk, h, hk, d, qo, kl, dtn = case
    dt = getattr(torch, dtn)
    mask = offset_mask(torch, b, sq, sk, qo, kl)
    cost = fa_ops.flash_attention_cost((b, sq, h, d), (b, sk, hk, d),
                                       q_offset=qo, kv_len=kl,
                                       itemsize=dt.itemsize)
    kw = dict(q_offset=torch.tensor(qo, dtype=torch.int32, device="cuda"),
              kv_len=torch.tensor(kl, dtype=torch.int32, device="cuda"))
    copies = [(rnd((b, sq, h, d), dt), rnd((b, sk, hk, d), dt),
               rnd((b, sk, hk, d), dt)) for _ in range(n_copies(cost.bytes))]
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in c) for c in copies]
    nxt, nxt_l = cycle(copies), cycle(bhsd)
    q, k, v = copies[0]
    err = held(torch, "flash extend", fa_ops.flash_attention(q, k, v, **kw),
               fa_ref.attention_ref(q, k, v, **kw), TOL[("extend", dtn)])
    lmask = mask[:, None]
    return {"shape": f"B={b} Sq={sq} Sk={sk} H={h}/{hk} D={d} {dtn}, "
                     f"q_offset={qo} kv_len={kl}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(*nxt(), **kw)),
            "plain_ms": cuda_ms(torch, lambda: fa_ref.attention_ref(
                *nxt(), **kw)),
            "library_ms": cuda_ms(torch, lambda: sdpa(*nxt_l(), mask=lmask)),
            "copies": len(copies), **bound(cost, dtn)}


def fifo_tables(torch, np, lens, n_blocks, pages, bs, seed=0):
    """Block tables as the paged fifo run holds them: each slot's live
    pages on distinct blocks scattered over the pool, the rest (and a
    free slot, length 1) on the null block 0."""
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((len(lens), pages), np.int32)
    for i, n in enumerate(lens):
        if n > 1:
            for p in range(-(-n // bs)):
                tables[i, p] = free.pop()
    return torch.as_tensor(tables, device="cuda")


def time_paged(torch, np, da_ops, da_ref, rnd, shape) -> dict:
    h, hk, d, n, bs, nb, lens = shape
    b, dtn = len(lens), "bfloat16"
    dt = getattr(torch, dtn)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tables = fifo_tables(torch, np, lens, n, nb, bs)
    live = sum(lens)
    cost = da_ops.decode_attention_cost(b, h, hk, d, live_rows=live,
                                        pages=nb)
    copies = [(rnd((b, h, d), dt), rnd((n, bs, hk, d), dt),
               rnd((n, bs, hk, d), dt), tables, lengths)
              for _ in range(n_copies(cost.bytes))]
    nxt = cycle(copies)
    tl = tables.long()
    mask = (torch.arange(nb * bs, device="cuda")[None]
            < lengths[:, None])[:, None, None]

    def gather_sdpa():
        q, kp, vp, _, _ = nxt()
        k = kp[tl].view(b, nb * bs, hk, d).transpose(1, 2)
        v = vp[tl].view(b, nb * bs, hk, d).transpose(1, 2)
        return sdpa(q[:, :, None], k, v, mask=mask)
    q, kp, vp, _, _ = copies[0]
    err = held(torch, "paged decode",
               da_ops.paged_decode_attention(q, kp, vp, tables, lengths),
               da_ref.paged_decode_attention_ref(q, kp, vp, tables, lengths),
               TOL[("paged", dtn)])
    return {"shape": f"B={b} pool {n}x{bs} pages {nb} H={h}/{hk} D={d} "
                     f"{dtn}, {live} live rows",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: da_ops.paged_decode_attention(
                *nxt())),
            "plain_ms": cuda_ms(torch, lambda: da_ref
                                .paged_decode_attention_ref(*nxt())),
            "library_ms": cuda_ms(torch, gather_sdpa),
            "library": "page gather + SDPA (two calls)",
            "copies": len(copies), **bound(cost, dtn)}


def time_flash_train(torch, fa_ops, fa_ref, rnd,
                     shape=TRAIN_FA["train"]) -> dict:
    """Flash at a training shape (by default recurrentgemma-9b's
    attn_local: B=1, S=4096, 16 query heads over 1 KV head, head_dim
    256, window 2048), bf16, with the log-sum-exp the backward reads."""
    b, s, h, hk, d, w = shape
    dtn = "bfloat16"
    dt = getattr(torch, dtn)
    cost = fa_ops.flash_attention_cost((b, s, h, d), (b, s, hk, d),
                                       window=w, return_lse=True)
    copies = [(rnd((b, s, h, d), dt), rnd((b, s, hk, d), dt),
               rnd((b, s, hk, d), dt)) for _ in range(n_copies(cost.bytes))]
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in c) for c in copies]
    nxt, nxt_l = cycle(copies), cycle(bhsd)
    pos = torch.arange(s, device="cuda")
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < w) \
        if w else None
    kw = dict(window=w, return_lse=True)
    q, k, v = copies[0]
    (o, lse), (ro, rlse) = (fa_ops.flash_attention(q, k, v, **kw),
                            fa_ref.attention_ref(q, k, v, **kw))
    err = held(torch, "flash train", o, ro, TOL[("prefill", dtn)])
    return {"shape": f"B={b} S={s} H={h}/{hk} D={d} {dtn} causal"
                     f"{f' window {w}' if w else ''}, with lse",
            "max_abs_err": err,
            "lse_max_abs_err": (lse - rlse).abs().max().item(),
            "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(*nxt(), **kw)),
            "plain_ms": cuda_ms(torch, lambda: fa_ref.attention_ref(
                *nxt(), **kw), iters=5, warmup=1),
            "library_ms": cuda_ms(torch, lambda: sdpa(
                *nxt_l(), causal=mask is None, mask=mask)),
            "library": "SDPA + window mask" if w else "SDPA",
            "copies": len(copies), **bound(cost, dtn)}


def time_scan(torch, scan_ops, scan_ref, rnd, reverse: bool,
              shape=(1, TRAIN_S, TRAIN_D)) -> dict:
    """The RG-LRU scan at ``shape`` (B, S, D), fp32, by default the
    training shape: forward (a, b read, y written) or reverse (a, dy, y
    read, db, da written, dh0 too). No single PyTorch call computes the
    scan."""
    b, s, d = shape
    cost = scan_ops.rglru_scan_cost(b, s, d, reverse=reverse)

    def inputs():
        a = torch.rand((b, s, d), device="cuda") * 0.499 + 0.5
        return a, rnd((b, s, d), torch.float32) * 0.1, \
            rnd((b, d), torch.float32)
    copies = [inputs() for _ in range(n_copies(cost.bytes))]
    if reverse:
        copies = [(a, x, scan_ref.rglru_scan_seq_ref(a, x, h0), h0)
                  for a, x, h0 in copies]
        kern, plain = scan_ops.rglru_scan_bwd, scan_ref.rglru_scan_reverse_ref
    else:
        kern, plain = scan_ops.rglru_scan_fwd, scan_ref.rglru_scan_seq_ref
    nxt = cycle(copies)
    got, want = kern(*copies[0]), plain(*copies[0])
    if not reverse:
        got, want = (got,), (want,)
    err = max(held(torch, "scan", g, w, SCAN_TOL) for g, w in zip(got, want))
    return {"shape": f"B={b} S={s} D={d} float32"
                     f"{', reverse' if reverse else ''}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: kern(*nxt())),
            "plain_ms": cuda_ms(torch, lambda: plain(*nxt()), iters=3,
                                warmup=1),
            "library_ms": None, "library": "no single call",
            "copies": len(copies), **bound(cost, "float32")}


def scan_repeats(torch, gen, scan_ops, scan_ref):
    """The chunked scan's carries are one chain whatever order its CTAs
    ran in, and its flags are zeroed per call: two calls at the training
    shape must give bitwise equal y, da, db and dh0, and calls back to
    back on rotated inputs must each agree with the plain version.
    Returns [(tag, max |err|, ok)]."""
    def inputs(b, s, d):
        a = torch.rand((b, s, d), generator=gen, device="cuda") * 0.499 + 0.5
        return a, *(torch.randn(shape, generator=gen, device="cuda")
                    for shape in ((b, s, d), (b, d), (b, s, d)))

    def both(a, x, h0, dy):
        y = scan_ops.rglru_scan_fwd(a, x * 0.1, h0)
        return (y,) + scan_ops.rglru_scan_bwd(a, dy, y, h0)

    out = []
    train = inputs(1, TRAIN_S, TRAIN_D)
    first, second = both(*train), both(*train)
    torch.cuda.synchronize()
    for part, g, h in zip(("y", "da", "db", "dh0"), first, second):
        out.append((f"rglru bitwise repeat {part} b1 s{TRAIN_S} d{TRAIN_D}",
                    (g - h).abs().max().item(), bool(torch.equal(g, h))))
    del train, first, second
    b, s, d, n = SCAN_ROTATED
    copies = [inputs(b, s, d) for _ in range(n)]
    got = [both(*c) for c in copies * 2]      # no sync between calls
    for i, (c, g) in enumerate(zip(copies * 2, got)):
        a, x, h0, dy = c
        want = (scan_ref.rglru_scan_seq_ref(a, x * 0.1, h0),) + \
            scan_ref.rglru_scan_reverse_ref(a, dy, g[0], h0)
        errs = [err_vs(torch, gg, w, SCAN_TOL) for gg, w in zip(g, want)]
        out.append((f"rglru back-to-back call {i} (copy {i % n}) b{b} s{s} "
                    f"d{d}", max(e for e, _ in errs), all(k for _, k in errs)))
    return out


def phase_kernels(torch, np, fa_ops, fa_ref, da_ops, da_ref, scan_ops,
                  scan_ref) -> dict:
    """Every case held against the plain version; then the serving shapes
    timed. Returns {"flash_attention": {"fifo": ..., "batch": ...},
    "decode_attention": {...}, "paged_decode_attention": {"fifo": ...},
    "flash_attention_extend": {"prefix": ..., "chunk": ..., "ragged":
    ...}, "flash_attention_train": {"train": ...}, "rglru_scan_fwd":
    {"train": ...}, "rglru_scan_bwd": {"train": ...}}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    rows, failures = [], []

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for (b, sq, sk, h, hk, d, causal, window, dtn) in FA_CASES:
        dt = getattr(torch, dtn)
        q, k, v = rnd((b, sq, h, d), dt), rnd((b, sk, hk, d), dt), \
            rnd((b, sk, hk, d), dt)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = TOL[("prefill", dtn)]
        err, ok = err_vs(torch, out, ref, tol)
        tag = f"flash b{b} sq{sq} sk{sk} h{h}/{hk} d{d} c{int(causal)} w{window} {dtn}"
        rows.append((tag, err, tol, ok))
        if not ok:
            failures.append(tag)
    for (b, h, hk, d, s, dtn, lens) in DEC_CASES:
        dt = getattr(torch, dtn)
        q, kc, vc = rnd((b, h, d), dt), rnd((b, s, hk, d), dt), \
            rnd((b, s, hk, d), dt)
        if lens is None:
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
        else:
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = da_ops.decode_attention(q, kc, vc, lengths)
        ref = da_ref.decode_attention_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        tol = TOL[("decode", dtn)]
        err, ok = err_vs(torch, out, ref, tol)
        zero_rows = (lengths == 0)
        if zero_rows.any() and out[zero_rows].abs().max().item() != 0.0:
            ok = False
        tag = f"decode b{b} h{h}/{hk} d{d} s{s} {dtn} lens={lens or 'random'}"
        rows.append((tag, err, tol, ok))
        if not ok:
            failures.append(tag)
        for tag, err, tol, ok in decode_lse_rows(torch, da_ops, da_ref, q, kc,
                                                 vc, lengths, out, tag):
            rows.append((tag, err, tol, ok))
            if not ok:
                failures.append(tag)
    for (b, h, hk, d, n, bs, nb, dtn, lens) in PAGED_CASES:
        dt = getattr(torch, dtn)
        q, kp, vp = rnd((b, h, d), dt), rnd((n, bs, hk, d), dt), \
            rnd((n, bs, hk, d), dt)
        if lens is None:
            lengths = torch.randint(1, nb * bs + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
        else:
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        if n in SERVE_POOLS:
            tables = fifo_tables(torch, np, lens, n, nb, bs)
        else:
            tables = torch.randint(0, n, (b, nb), generator=gen, device=dev,
                                   dtype=torch.int32)
        out = da_ops.paged_decode_attention(q, kp, vp, tables, lengths)
        ref = da_ref.paged_decode_attention_ref(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        tol = TOL[("paged", dtn)]
        err, ok = err_vs(torch, out, ref, tol)
        zero_rows = (lengths == 0)
        if zero_rows.any() and out[zero_rows].abs().max().item() != 0.0:
            ok = False
        if n == PARITY_BLOCKS:
            # the slotted kernel over the same rows gathered into the
            # serving runs' 552-row cache: the same splits, so the same
            # fp32 operations in the same order, bit for bit
            tl = tables.long()
            kg = kp[tl].reshape(b, nb * bs, hk, d)[:, :SERVE_S].contiguous()
            vg = vp[tl].reshape(b, nb * bs, hk, d)[:, :SERVE_S].contiguous()
            slot = da_ops.decode_attention(q, kg, vg, lengths)
            same = torch.equal(out, slot)
            tag = (f"paged b{b} pool {n}x{bs} pages {nb} {dtn} == slotted "
                   f"s{SERVE_S} on the gathered rows")
            rows.append((tag, (out.float() - slot.float()).abs().max()
                         .item(), 0.0, same))
            if not same:
                failures.append(tag)
        tag = (f"paged b{b} h{h}/{hk} d{d} pool {n}x{bs} pages {nb} {dtn} "
               f"lens={lens or 'random'}")
        rows.append((tag, err, tol, ok))
        if not ok:
            failures.append(tag)
    for (b, sq, sk, h, hk, d, qo, kl, dtn) in OFFSET_CASES:
        dt = getattr(torch, dtn)
        q, k, v = rnd((b, sq, h, d), dt), rnd((b, sk, hk, d), dt), \
            rnd((b, sk, hk, d), dt)
        kw = dict(q_offset=torch.tensor(qo, dtype=torch.int32, device=dev),
                  kv_len=torch.tensor(kl, dtype=torch.int32, device=dev))
        out = fa_ops.flash_attention(q, k, v, **kw)
        ref = fa_ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = TOL[("extend", dtn)]
        err, ok = err_vs(torch, out, ref, tol)
        tag = (f"flash b{b} sq{sq} sk{sk} h{h}/{hk} d{d} q_offset={qo} "
               f"kv_len={kl} {dtn}")
        rows.append((tag, err, tol, ok))
        if not ok:
            failures.append(tag)
    for (b, sq, sk, h, hk, d, w, qo, kl) in BATCH_CASES:
        q, k, v = rnd((b, sq, h, d), torch.bfloat16), \
            rnd((b, sk, hk, d), torch.bfloat16), \
            rnd((b, sk, hk, d), torch.bfloat16)

        def ragged(i, j):
            return {} if qo is None else dict(
                q_offset=torch.tensor(qo[i:j], dtype=torch.int32, device=dev),
                kv_len=torch.tensor(kl[i:j], dtype=torch.int32, device=dev))
        out = fa_ops.flash_attention(q, k, v, window=w, **ragged(0, b))
        same = all(torch.equal(out[i:i + 1], fa_ops.flash_attention(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], window=w, **ragged(i, i + 1)))
            for i in range(b))
        tag = (f"flash b{b} sq{sq} sk{sk} h{h}/{hk} d{d} w{w} q_offset={qo} "
               f"kv_len={kl} bfloat16: each row == its B=1 run")
        rows.append((tag, 0.0, 0.0, same))
        if not same:
            failures.append(tag)
    for (b, s, h, hk, d, w, dtn) in FA256_CASES:
        dt = getattr(torch, dtn)
        q, k, v = rnd((b, s, h, d), dt), rnd((b, s, hk, d), dt), \
            rnd((b, s, hk, d), dt)
        o, lse = fa_ops.flash_attention(q, k, v, window=w, return_lse=True)
        ro, rlse = fa_ref.attention_ref(q, k, v, window=w, return_lse=True)
        torch.cuda.synchronize()
        for part, got, want, tol in (("o", o, ro, TOL[("prefill", dtn)]),
                                     ("lse", lse, rlse, LSE_TOL[dtn])):
            err, ok = err_vs(torch, got, want, tol)
            tag = f"flash {part} b{b} s{s} h{h}/{hk} d{d} w{w} {dtn}"
            rows.append((tag, err, tol, ok))
            if not ok:
                failures.append(tag)
        del q, k, v, o, lse, ro, rlse
    for (b, sq, sk, h, hk, d, dtn) in BIDIR_LSE_CASES:
        dt = getattr(torch, dtn)
        q, k, v = rnd((b, sq, h, d), dt), rnd((b, sk, hk, d), dt), \
            rnd((b, sk, hk, d), dt)
        o, lse = fa_ops.flash_attention(q, k, v, causal=False,
                                        return_lse=True)
        ro, rlse = fa_ref.attention_ref(q, k, v, causal=False,
                                        return_lse=True)
        torch.cuda.synchronize()
        for part, got, want, tol in (("o", o, ro, TOL[("prefill", dtn)]),
                                     ("lse", lse, rlse, LSE_TOL[dtn])):
            err, ok = err_vs(torch, got, want, tol)
            tag = (f"flash {part} b{b} sq{sq} sk{sk} h{h}/{hk} d{d} every "
                   f"key {dtn}")
            rows.append((tag, err, tol, ok))
            if not ok:
                failures.append(tag)
    for (b, s, d) in SCAN_CASES:
        a = torch.rand((b, s, d), generator=gen, device=dev) * 0.499 + 0.5
        x = rnd((b, s, d), torch.float32) * 0.1
        h0, dy = rnd((b, d), torch.float32), rnd((b, s, d), torch.float32)
        y = scan_ops.rglru_scan_fwd(a, x, h0)
        got = (y,) + scan_ops.rglru_scan_bwd(a, dy, y, h0)
        want = (scan_ref.rglru_scan_seq_ref(a, x, h0),) + \
            scan_ref.rglru_scan_reverse_ref(a, dy, y, h0)
        torch.cuda.synchronize()
        for part, g, w in zip(("y", "da", "db", "dh0"), got, want):
            err, ok = err_vs(torch, g, w, SCAN_TOL)
            tag = f"rglru {'forward' if part == 'y' else 'reverse'} {part} " \
                  f"b{b} s{s} d{d} float32"
            rows.append((tag, err, SCAN_TOL, ok))
            if not ok:
                failures.append(tag)
    for tag, err, ok in scan_repeats(torch, gen, scan_ops, scan_ref):
        rows.append((tag, err, 0.0 if "bitwise" in tag else SCAN_TOL, ok))
        if not ok:
            failures.append(tag)
    for tag, err, tol, ok in rows:
        say(f"  {'ok  ' if ok else 'FAIL'} {tag}: max |err| {err:.3g} "
            f"(tol {tol:g})")
    if failures:
        raise PhaseFailed(f"kernels disagree with the plain version: "
                          f"{failures}")
    main = {"flash_attention": {p: time_flash(torch, fa_ops, fa_ref, rnd,
                                              shape)
                                for p, shape in SERVE_FA.items()},
            "decode_attention": {p: time_decode(torch, da_ops, da_ref, rnd,
                                                shape)
                                 for p, shape in SERVE_DEC.items()},
            "paged_decode_attention": {p: time_paged(
                torch, np, da_ops, da_ref, rnd, shape)
                for p, shape in SERVE_PAGED.items()},
            "flash_attention_bidir": {
                p: time_flash_bidir(torch, fa_ops, fa_ref, rnd, shape)
                for p, shape in SERVE_FA_BIDIR.items()},
            "flash_attention_extend": {
                p: time_flash_extend(torch, fa_ops, fa_ref, rnd, case)
                for p, case in SERVE_EXT.items()},
            "flash_attention_train": {
                p: time_flash_train(torch, fa_ops, fa_ref, rnd, shape)
                for p, shape in TRAIN_FA.items()},
            "rglru_scan_fwd": {
                "train": time_scan(torch, scan_ops, scan_ref, rnd,
                                   reverse=False),
                # recurrentgemma-9b's prefills of 512 and 2,080 tokens
                # (phase 9)
                "recurrentgemma": time_scan(torch, scan_ops, scan_ref, rnd,
                                            reverse=False,
                                            shape=(1, 512, TRAIN_D)),
                "recurrentgemma-long": time_scan(
                    torch, scan_ops, scan_ref, rnd, reverse=False,
                    shape=(1, max(RG_LENS), TRAIN_D))},
            "rglru_scan_bwd": {"train": time_scan(torch, scan_ops, scan_ref,
                                                  rnd, reverse=True)}}
    for name, per in main.items():
        for policy, m in per.items():
            lib = "no single library call" if m["library_ms"] is None \
                else f"{m['library_ms']:.4f} ms {m.get('library', 'SDPA')}"
            say(f"  {name} @ {policy} shape ({m['shape']}): {m['ms']:.4f} ms "
                f"kernel, {m['plain_ms']:.4f} ms plain, {lib}, bound "
                f"{m['bound_ms']:.4f} ms ({m['bound_by']}; "
                f"fp32 FMA {m['fp32_fma_ms']:.4f} ms), max |err| "
                f"{m['max_abs_err']:.3g}, {m['copies']} input copies")
    say(f"[2/16] kernels: {len(rows)} cases agree with the plain versions "
        f"(flash, flash with q_offset/kv_len, decode and paged decode at "
        f"head_dims to 256, flash at head_dim 256 with its lse, flash over "
        f"every key at head_dim 64 with Sq != Sk, the RG-LRU scan forward "
        f"and reverse)")
    return main


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_golden(torch, np) -> dict:
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler import Request
    from repro_torch.weights import from_jax_params
    data = np.load(GOLDEN)
    meta = json.loads(str(data["meta"]))
    worst = worst_ext = 0.0
    cell_counters = {}
    for name, kw in meta["configs"].items():
        cfg = ModelConfig(**{**kw, "layer_pattern": tuple(kw["layer_pattern"])})
        prefix = f"{name}|params|"
        flat = {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}
        model = from_jax_params(flat, cfg, device="cuda")
        tokens = torch.as_tensor(data[f"{name}|logits_prompt"],
                                 device="cuda")
        logits, cache, clen = T.prefill(model, tokens,
                                        max_len=meta["logits_max_len"])
        steps = [logits]
        for tok in data[f"{name}|logits_fed"]:
            logits, cache, clen = T.decode_step(
                model, torch.as_tensor(tok, device="cuda"), cache, clen)
            steps.append(logits)
        got = torch.stack(steps).cpu().numpy()
        want = data[f"{name}|logits"]
        if not np.isfinite(got).all():
            raise PhaseFailed(f"{name}: non-finite logits")
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        if err > 1e-4:
            raise PhaseFailed(f"{name}: logits differ from JAX by {err:.3g}")
        split = meta["extend_split"]
        _, cache, clen = T.prefill(model, tokens[:, :split],
                                   max_len=meta["logits_max_len"])
        ext, _, _ = T.prefill_extend(model, tokens[:, split:], cache, clen)
        ext_err = float(np.abs(ext.cpu().numpy()
                               - data[f"{name}|extend_logits"]).max())
        worst_ext = max(worst_ext, ext_err)
        if not np.isfinite(ext_err) or ext_err > 1e-4:
            raise PhaseFailed(f"{name}: {split} + {tokens.shape[1] - split} "
                              f"extend logits differ from JAX by "
                              f"{ext_err:.3g}")
        want_tokens = json.loads(str(data[f"{name}|oracle_tokens"]))
        counters = json.loads(str(data[f"{name}|counters"]))
        cells = [("batch", {}), ("fifo", {})] + [
            ("fifo", lay) for lay in meta["counter_cells"]]
        for adm, lay in cells:
            reqs = [Request(i, np.asarray(r["prompt"], np.int32),
                            max_new_tokens=r["max_new"],
                            priority=r["priority"],
                            deadline_s=r["deadline_s"])
                    for i, r in enumerate(meta["workload"][name])]
            kw = meta["counter_cells"][lay] if lay else {}
            eng = Engine(cfg, model, EngineConfig(
                max_len=meta["engine_max_len"], max_slots=3, admission=adm,
                debug=adm != "batch", **kw), device="cuda")
            got_tokens = [c.tokens for c in eng.generate(reqs)]
            if got_tokens != want_tokens:
                raise PhaseFailed(f"{name}/{adm}/{lay or 'slotted'}: tokens "
                                  f"differ from JAX's batch oracle")
            if lay:
                st = eng.stats()
                got_c = {k: st[k] for k in counters[lay]}
                if got_c != counters[lay]:
                    raise PhaseFailed(f"{name}/{lay}: counters {got_c}, "
                                      f"JAX's {counters[lay]}")
                if eng.config.kv_layout == "paged":
                    home_whole(eng, f"{name}/{lay}")
                cell_counters[f"{name}/{lay}"] = got_c
    service = golden_service(torch, np, data, meta)
    say(f"[3/16] JAX golden: tokens identical on {sorted(meta['configs'])} "
        f"(batch, fifo, and fifo on {', '.join(meta['counter_cells'])}, "
        f"whose counters equal JAX's); logits max |err| {worst:.3g}, "
        f"extend logits {worst_ext:.3g} (tol 1e-4); the prefix-cache "
        f"scenarios {sorted(service['scenarios'])} and the JAX-saved "
        f"prefix-victim-v1 file restored and replayed with JAX's tokens and "
        f"counters")
    return {"golden_max_abs_err": worst, "extend_max_abs_err": worst_ext,
            "counters": cell_counters, "service": service}


def home_whole(eng, label: str) -> None:
    """At drain every pool block is back, less the victim cache's parked
    chains, and the pool's books balance (``PagedLayout.check``)."""
    lay = eng.scheduler.layout
    parked = len(lay.victim) if lay.victim is not None else 0
    if eng.scheduler.alloc.in_use != parked:
        raise PhaseFailed(f"{label}: {eng.scheduler.alloc.in_use} blocks "
                          f"held at drain, {parked} parked")
    try:
        lay.check(set(), eng.scheduler.sched.max_slots)
    except AssertionError as exc:
        raise PhaseFailed(f"{label}: the pool's books do not balance: "
                          f"{exc}") from None


def golden_service(torch, np, data, meta) -> dict:
    """The fixture's prefix-cache scenarios on the card in fp32 (a parked
    chain re-hit, eviction under pressure, a tenant quota breach, one
    prompt under two tenants), and a fresh engine restored from the
    JAX-saved ``golden_prefix.npz`` replaying its wave: tokens, counters
    and the parked bytes per tenant must be JAX's."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler import Request
    from repro_torch.weights import from_jax_params
    svc = meta["service"]
    name = svc["config"]
    kw = meta["configs"][name]
    cfg = ModelConfig(**{**kw, "layer_pattern": tuple(kw["layer_pattern"])})
    prefix = f"{name}|params|"
    model = from_jax_params({k[len(prefix):]: data[k] for k in data.files
                             if k.startswith(prefix)}, cfg, device="cuda")
    want = json.loads(str(data[f"{name}|service"]))
    keys = ("prefix_hits", "prefill_tokens_saved", "preemptions",
            "victim_hits", "victim_evictions")

    def engine(override):
        return Engine(cfg, model, EngineConfig(**{**svc["engine"],
                                                  **override}),
                      device="cuda")

    def wave(w):
        return [Request(i, ((np.arange(n, dtype=np.int32) * (seed + 3)
                             + seed) % cfg.vocab_size).astype(np.int32),
                        max_new_tokens=m, tenant=t)
                for i, (seed, n, t, m) in enumerate(w)]

    def record(eng):
        st = eng.stats()
        pc = eng.snapshot()["prefix_cache"]
        home_whole(eng, f"service/{name}")
        return {**{k: int(st[k]) for k in keys},
                "victim_blocks": int(pc["victim_blocks"]),
                "per_tenant_bytes": {k: int(v) for k, v in
                                     sorted(pc["per_tenant_bytes"].items())}}

    got = {}
    for label, (override, waves) in svc["scenarios"].items():
        eng = engine(override)
        tokens = [[c.tokens for c in eng.generate(wave(w))] for w in waves]
        got[label] = {"tokens": tokens, **record(eng)}
    eng = engine({})
    blocks = eng.restore_prefix_cache(str(GOLDEN_PREFIX))
    outs = eng.generate(wave(svc["restore_wave"]))
    got["restore"] = {"blocks": blocks, "tokens": [c.tokens for c in outs],
                      **record(eng)}
    for label, rec in got.items():
        if rec != want[label]:
            raise PhaseFailed(f"prefix-cache scenario {label}: "
                              f"{without_tokens(rec)}, JAX's "
                              f"{without_tokens(want[label])}"
                              + ("" if rec["tokens"] == want[label]["tokens"]
                                 else " (tokens differ)"))
    if got["restore"]["victim_hits"] <= 0:
        raise PhaseFailed("the restored prefix cache was never hit")
    return {"scenarios": {k: without_tokens(v) for k, v in got.items()}}


def without_tokens(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "tokens"}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

class Calls:
    """Counts the model's prefill and extend calls: each wrapped entry
    point adds one per call (the engine reaches both through the
    ``transformer`` module), so a run's flash launches can be held to 28
    per call. Safe across threads: a drain thread makes the calls while
    the main thread reads and resets the counts."""

    def __init__(self, T):
        self.T = T
        self.orig = {"prefill": T.prefill, "prefill_extend": T.prefill_extend}
        self.n = dict.fromkeys(self.orig, 0)
        self.lock = threading.Lock()
        for name, fn in self.orig.items():
            setattr(T, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            with self.lock:
                self.n[name] += 1
            return fn(*a, **kw)
        return counted

    def take(self) -> dict:
        """The counts so far, set back to 0."""
        with self.lock:
            n, self.n = dict(self.n), dict.fromkeys(self.orig, 0)
        return n

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.T, name, fn)


KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention")


# the kernels a serving run launches (KERNELS) and the scan's forward,
# which every RG-LRU layer's prefill launches
RUN_KERNELS = KERNELS + ("rglru_scan_fwd",)


def kind_counts(cfg) -> dict:
    kinds = cfg.layer_kinds
    return {k: kinds.count(k) for k in ("attn", "attn_local", "rglru")}


def want_launches(cfg, n_calls: dict, steps: int, paged: bool) -> dict:
    """A serving run's launches, from the code: flash once a prefill or
    extend call per attention layer (and an encoder-decoder's per encoder
    layer and per cross-attention), the scan's forward once a prefill
    call per rglru layer; per decode step the slotted kernel once per
    ring layer (and per global layer when slotted, and per
    cross-attention on both layouts), the paged kernel once per global
    layer when paged, and the scan never."""
    n = kind_counts(cfg)
    att = n["attn"] + n["attn_local"]
    cross = att if cfg.n_encoder_layers else 0
    return {"flash_attention": (att + cross + cfg.n_encoder_layers)
            * sum(n_calls.values()),
            "decode_attention": ((n["attn_local"] if paged else att) + cross)
            * steps,
            "paged_decode_attention": n["attn"] * steps if paged else 0,
            "rglru_scan_fwd": n["rglru"] * n_calls["prefill"]}


def checked_run(torch, ops, calls, cfg, label: str, drive, n_new: int,
                n_requests: int, expect_flash: bool = True) -> dict:
    """One serving run (``drive()`` returns the serve CLI's summary),
    with the launch counts and the prefill/extend calls set to 0 just
    before it and read just after: every request ends by length with
    ``n_new`` tokens inside the vocabulary, and the launches are exactly
    ``want_launches`` (at qwen2-1.5b 28 flash launches a prefill or
    extend call and 28 of the layout's decode kernel a step), at least
    one flash launch among them unless ``expect_flash`` is False (a
    config without attention layers launches none)."""
    from repro_torch.kernels import _build
    _build.reset_launches(*(ops[k] for k in RUN_KERNELS))
    calls.take()
    summary = drive()
    torch.cuda.synchronize()
    launches = {k: ops[k].launches for k in RUN_KERNELS}
    n_calls = calls.take()
    comps = summary["completions"]
    if len(comps) != n_requests or any(
            c.finish_reason != "length" or len(c.tokens) != n_new
            for c in comps):
        raise PhaseFailed(f"{label}: not every request finished by length "
                          f"with {n_new} tokens")
    if any(not 0 <= t < cfg.vocab_size for c in comps for t in c.tokens):
        raise PhaseFailed(f"{label}: token outside the vocabulary")
    paged = summary["kv_layout"] == "paged"
    steps = summary["decode_steps"]
    want = want_launches(cfg, n_calls, steps, paged)
    if launches != want or (expect_flash
                            and not launches["flash_attention"]):
        raise PhaseFailed(f"{label}: launches {launches}, want {want} "
                          f"({n_calls} prefill/extend calls, {steps} decode "
                          f"steps)")
    st = summary["stats"]
    line = (f"  {label}: {summary['wall_s']:.3f} s wall, "
            f"{summary['tok_per_s']:.1f} tok/s, TTFT p50 "
            f"{summary['ttft_p50_ms']:.1f} ms, decode "
            f"{summary['decode_ms_per_step']:.2f} ms/step over {steps} "
            f"steps; calls {n_calls}; launches {launches}")
    if paged:
        line += (f"; {st['preemptions']} preemptions, {st['prefix_hits']} "
                 f"prefix hits, {st['prefill_tokens_saved']} prompt tokens "
                 f"saved, pool high-water "
                 f"{summary['kv_stats']['paged_kv_hwm_blocks']:.0f} blocks")
    say(line)
    return {"launches": launches, "calls": n_calls, "summary": summary}


def vs_plain(torch, model, fa_ref, da_ref) -> dict:
    """The full-width model in bf16 run twice on the same inputs: through
    the kernels, then with the plain versions in their place. A batch of
    8 prompts of 512 tokens is prefilled into caches of the serving
    runs' size; 4 decode steps follow with the slots at mixed lengths as
    in a fifo step (slot 0 free, at length 0). Compares the 40 rows of
    logits and every layer's cache."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen,
                        device="cuda")
    # positions below a slot's length hold what a prefill of that length
    # gives (causal), so this is the state of slots at these lengths
    clen0 = torch.tensor([0, 505, 507, 509, 510, 511, 512, 512],
                         dtype=torch.int32, device="cuda")

    def drive():
        logits, cache, _ = T.prefill(model, tokens, max_len=SERVE_S)
        steps, clen = [logits.float()], clen0.clone()
        for tok in fed:
            logits, cache, clen = T.decode_step(model, tok, cache, clen)
            steps.append(logits.float())
        return torch.cat(steps), cache

    got, got_cache = drive()
    kernels = (L.flash_attention, L.decode_attention)
    L.flash_attention, L.decode_attention = (fa_ref.attention_ref,
                                             da_ref.decode_attention_ref)
    try:
        want, want_cache = drive()
    finally:
        L.flash_attention, L.decode_attention = kernels

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
    out = {"logits_rel_err": rel(got, want),
           "cache_rel_err": max(rel(g[n], w[n]) for g, w in
                                zip(got_cache, want_cache) for n in "kv"),
           "argmax_agree": (got.argmax(-1) == want.argmax(-1)).float()
           .mean().item(),
           "rows": got.shape[0], "finite": bool(torch.isfinite(got).all())}
    say(f"  kernels vs plain on the full-width model: logits max |err| "
        f"{out['logits_rel_err']:.3g} of max |logit| (tol 5e-2), caches "
        f"{out['cache_rel_err']:.3g} (tol 5e-2), argmax agrees on "
        f"{out['argmax_agree']:.3f} of {out['rows']} rows (want >= 0.9)")
    if not (out["finite"] and out["logits_rel_err"] <= 5e-2
            and out["cache_rel_err"] <= 5e-2 and out["argmax_agree"] >= 0.9):
        raise PhaseFailed("the full-width model through the kernels "
                          "disagrees with its plain-version run")
    return out


def extend_vs_one_shot(torch, model) -> dict:
    """One 512-token prompt through the kernels twice: prefilled at once,
    and prefilled 256 then extended by 256 (the prefix-resume call).
    Last-position logits and the 28 layers' caches within 5e-2 of their
    largest magnitude, argmax equal."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    max_len = PAGES * BS
    one, one_cache, _ = T.prefill(model, tokens, max_len=max_len)
    _, cache, clen = T.prefill(model, tokens[:, :256], max_len=max_len)
    ext, cache, clen = T.prefill_extend(model, tokens[:, 256:], cache, clen)
    last = ext[:, -1].float()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
    out = {"logits_rel_err": rel(last, one),
           "cache_rel_err": max(rel(e[n], o[n]) for e, o in
                                zip(cache, one_cache) for n in "kv"),
           "argmax_equal": bool(last.argmax(-1).item()
                                == one.float().argmax(-1).item()),
           "cache_len": int(clen[0]),
           "finite": bool(torch.isfinite(ext).all())}
    say(f"  256 + 256 extend vs one-shot 512 prefill: last logits max |err| "
        f"{out['logits_rel_err']:.3g} of max |logit| (tol 5e-2), caches "
        f"{out['cache_rel_err']:.3g} (tol 5e-2), argmax equal "
        f"{out['argmax_equal']}")
    if not (out["finite"] and out["logits_rel_err"] <= 5e-2
            and out["cache_rel_err"] <= 5e-2 and out["argmax_equal"]
            and out["cache_len"] == 512):
        raise PhaseFailed("the prefix-resume extend disagrees with the "
                          "one-shot prefill")
    return out


def traced_engine(torch, model, reqs, want_tokens, label: str,
                  max_len: int, top: int = 8, **engine_kw) -> dict:
    """A fifo run over 8 slots once more, on the same weights and
    requests, under ``torch.profiler`` (device activity only): its
    tokens those of the untraced run, the device's busy time (the union
    of the kernels' intervals), the wall time of the same run, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.engine import Engine, EngineConfig
    eng = Engine(model.cfg, model, EngineConfig(
        max_slots=8, max_len=max_len, admission="fifo", **engine_kw),
        device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = eng.generate(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if [o.tokens for o in outs] != want_tokens:
        raise PhaseFailed(f"the traced {label} run's tokens differ from "
                          f"the untraced run's")
    return trace_summary(torch, prof, wall_s, f"{label} run", top)


# the port's own kernels, by name, reported from every trace
PORT_KERNELS = ("fa_fwd", "decode_partial_kernel", "decode_combine_kernel",
                "rglru_fwd_kernel", "rglru_bwd_kernel")


def trace_summary(torch, prof, wall_s: float, label: str, top: int) -> dict:
    """The device's busy time in a ``torch.profiler`` trace (the union of
    the kernels' intervals), its idle share of ``wall_s``, and the
    kernels that take the most device time. The kernels are read from
    the profiler's raw results (``kineto_results``): building its event
    tree (``prof.events()``) costs ~0.3 ms a kernel on the host, 50 s for
    a serving run's 160,000 kernels."""
    from collections import defaultdict
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                e.name()) for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
    if not kernels:
        raise PhaseFailed("the trace holds no device kernels")
    by_name = defaultdict(lambda: [0.0, 0])
    busy_us, end = 0.0, float("-inf")
    for s, t, name in sorted(kernels):
        by_name[name][0] += t - s
        by_name[name][1] += 1
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy_s = busy_us / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    def rows(items):
        return [{"kernel": n[:90], "ms": v[0] / 1e3, "calls": v[1]}
                for n, v in items]
    out = {"wall_s": wall_s, "device_busy_s": busy_s,
           "idle_share": 1.0 - busy_s / wall_s, "kernels": len(kernels),
           "top": rows(ranked[:top]),
           "port": rows((n, v) for n, v in ranked
                        if any(k in n for k in PORT_KERNELS))}
    say(f"  traced {label}: wall {wall_s:.4f} s, device busy "
        f"{busy_s:.4f} s, idle share {out['idle_share']:.4f}, "
        f"{len(kernels)} kernels")
    for k in out["top"]:
        say(f"    {k['ms']:10.4f} ms  x{k['calls']:6d}  {k['kernel']}")
    say("    the port's kernels:")
    for k in out["port"]:
        say(f"    {k['ms']:10.4f} ms  x{k['calls']:6d}  {k['kernel']}")
    return out


def agreement(torch, serve, model, runs) -> dict:
    """The share of requests of each prefix run whose tokens equal a
    slotted fifo run's on the same shared-preamble workload (reported,
    not gated: the extend path tiles the tail differently from a
    one-shot prefill, so bf16 rounding may move a greedy choice)."""
    from repro_torch.runtime.engine import Engine, EngineConfig
    eng = Engine(model.cfg, model, EngineConfig(
        max_slots=8, max_len=SERVE_S, admission="fifo"), device="cuda")
    reqs = serve.synthetic_requests(model.cfg, 16, 512, 32, 0,
                                    shared_prefix=True)
    ref = [o.tokens for o in eng.generate(reqs)]
    out = {}
    for label, run in runs.items():
        got = [c.tokens for c in run["summary"]["completions"]]
        out[label] = sum(a == b for a, b in zip(got, ref)) / len(ref)
    say(f"  agreement with a slotted fifo run on the shared-preamble "
        f"workload: {out}")
    return out


def phase_serve(torch, np, ops, fa_ref, da_ref) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    # the serving CLI's weights: the same config and seed
    model = T.init_params(get_config("qwen2_1_5b"), 0, device="cuda")
    out = {"vs_plain": vs_plain(torch, model, fa_ref, da_ref),
           "extend_vs_one_shot": extend_vs_one_shot(torch, model)}
    calls = Calls(T)
    try:
        for label, argv in SERVE_RUNS.items():
            out[label] = checked_run(
                torch, ops, calls, model.cfg, label,
                lambda: serve.main(SERVE_ARGS + argv), 32, 16)
    finally:
        calls.restore()
    tokens = {label: [c.tokens for c in out[label]["summary"]["completions"]]
              for label in SERVE_RUNS}
    if tokens["fifo"] != tokens["batch"]:
        raise PhaseFailed("fifo and batch greedy tokens differ")
    if tokens["paged"] != tokens["fifo"]:
        raise PhaseFailed("paged fifo tokens differ from slotted fifo "
                          "tokens")
    if out["paged-tight"]["summary"]["stats"]["preemptions"] <= 0:
        raise PhaseFailed("the tight pool never preempted")
    if tokens["paged-tight"] != tokens["paged"]:
        raise PhaseFailed("the tight pool's tokens differ from the paged "
                          "fifo run's")
    for label in ("prefix", "prefix-chunked"):
        st = out[label]["summary"]["stats"]
        if st["prefix_hits"] <= 0 or st["prefill_tokens_saved"] <= 0:
            raise PhaseFailed(f"{label}: no prefix hits on a shared-"
                              f"preamble workload")
    reqs = serve.synthetic_requests(model.cfg, 16, 512, 32, 0)
    out["trace"] = traced_engine(torch, model, reqs, tokens["fifo"], "fifo",
                                 SERVE_S)
    out["trace"]["untraced_wall_s"] = out["fifo"]["summary"]["wall_s"]
    out["trace_paged"] = traced_engine(torch, model, reqs, tokens["paged"],
                                       "paged fifo", SERVE_S,
                                       kv_layout="paged", block_size=BS)
    out["trace_paged"]["untraced_wall_s"] = out["paged"]["summary"]["wall_s"]
    out["agreement"] = agreement(torch, serve, model,
                                 {k: out[k] for k in ("prefix",
                                                      "prefix-chunked")})
    say("[4/16] serving qwen2-1.5b full width/depth bf16: 16 requests, all "
        "'length' in every run; fifo == batch == paged == tight pool "
        "(preempting) tokens; prefix hits in both prefix runs")
    return out


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_attention", "rglru_scan_fwd", "rglru_scan_bwd",
                 "decode_attention", "paged_decode_attention")
# the golden replay's limits: those of tests/test_torch_train.py, set
# from the errors measured on the CPU (logits 1.5e-6, loss 7.7e-8 rel,
# gradients 2.6e-6 of each leaf's largest magnitude, params after two
# AdamW steps 3.3e-5 abs where lr = 1e-3)
GOLDEN_TRAIN_TOL = {"logits": 2e-5, "loss": 1e-6, "grad": 1e-5,
                    "params": 1e-4}
# the full-width run: recurrentgemma-9b cut to 5 layers (one scanned
# period of rglru, rglru, attn_local, then two remainder rglru layers),
# the copy task at S=4096 > the 2048 window, global batch 2 in 2
# microbatches, 4 steps on one repeated batch
TRAIN_RUN = dict(steps=4, batch=2, seq=TRAIN_S, microbatches=2, lr=1e-3,
                 data_name="copy", repeat=True)
# one microbatch of that model through the kernels and through the plain
# versions, bf16: the loss (relative) and each gradient leaf (of its
# largest magnitude), as phase 4 holds the serving model
TRAIN_VS_PLAIN_TOL = {"loss": 1e-2, "grad": 5e-2}


def train_launches(cfg, microbatches: int) -> dict:
    """Launches of one training step, from the code: per microbatch each
    rglru layer launches the forward scan once and the reverse once and
    each attention layer the flash kernel once; with ``cfg.remat`` every
    scanned period's forward runs again in the backward."""
    again = cfg.layer_pattern * cfg.n_periods if cfg.remat else ()
    kinds = cfg.layer_kinds
    rg = kinds.count("rglru") + again.count("rglru")
    att = sum(k != "rglru" for k in kinds) + sum(k != "rglru" for k in again)
    return {"flash_attention": att * microbatches,
            "rglru_scan_fwd": rg * microbatches,
            "rglru_scan_bwd": kinds.count("rglru") * microbatches,
            "decode_attention": 0, "paged_decode_attention": 0}


def counts(ops) -> dict:
    return {k: ops[k].launches for k in TRAIN_KERNELS}


def golden_train(torch, np, ops) -> dict:
    """(a) The JAX golden training fixture replayed through the kernels in
    fp32: forward logits, the loss of each of two ``make_train_step``
    steps with 2 microbatches, every step-1 gradient leaf, and every
    param after the second AdamW step; launches exact per step."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    from repro_torch.weights import from_jax_params, to_flat
    data = np.load(GOLDEN_TRAIN)
    meta = json.loads(str(data["meta"]))
    kw = {**meta["config"],
          "layer_pattern": tuple(meta["config"]["layer_pattern"])}
    cfg = replace(get_config("recurrentgemma_9b").smoke(), **kw)

    def part(name):
        return {k[len(name) + 1:]: data[k] for k in data.files
                if k.startswith(name + "|")}
    model = from_jax_params(part("params"), cfg, device="cuda",
                            dtype=torch.float32).requires_grad_(True)
    tokens = torch.as_tensor(data["batch0|tokens"], device="cuda")
    with torch.no_grad():
        logits = T.forward(model, cfg, {"tokens": tokens},
                           train=False)[0].cpu().numpy()
    step = make_train_step(cfg, optim.AdamWConfig(**meta["opt"]),
                           microbatches=meta["microbatches"])
    opt = optim.init(model)
    want_n = train_launches(cfg, meta["microbatches"])
    losses, grads, per_step = [], None, []
    for i in range(meta["steps"]):
        for k in TRAIN_KERNELS:
            ops[k].launches = 0
        batch = {k: data[f"batch{i}|{k}"] for k in ("tokens", "labels")}
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        per_step.append(counts(ops))
        if grads is None:
            grads = to_flat(model, grad=True)
    after = to_flat(model)

    def leaf_rel(got, want):
        return max(float(np.abs(got[k] - want[k]).max()
                         / max(np.abs(want[k]).max(), 1e-30)) for k in want)
    want_g, want_p = part("grads"), part("after")
    out = {"logits_max_abs_err": float(np.abs(logits - data["logits"]).max()),
           "loss_rel_err": float(np.max(np.abs(np.asarray(losses)
                                              - data["losses"])
                                       / np.abs(data["losses"]))),
           "grad_rel_err": leaf_rel(grads, want_g),
           "params_max_abs_err": max(float(np.abs(after[k] - want_p[k]).max())
                                     for k in want_p),
           "losses": losses, "launches_per_step": per_step}
    say(f"  (a) JAX golden training fixture ({cfg.n_layers} layers "
        f"{'/'.join(cfg.layer_pattern)}, d {cfg.d_model}, fp32, "
        f"{meta['steps']} steps x {meta['microbatches']} microbatches) "
        f"through the kernels: logits {out['logits_max_abs_err']:.3g} (tol "
        f"{GOLDEN_TRAIN_TOL['logits']:g}), loss {out['loss_rel_err']:.3g} "
        f"rel (tol {GOLDEN_TRAIN_TOL['loss']:g}), step-1 gradients "
        f"{out['grad_rel_err']:.3g} of each leaf's max (tol "
        f"{GOLDEN_TRAIN_TOL['grad']:g}), params after "
        f"{out['params_max_abs_err']:.3g} (tol "
        f"{GOLDEN_TRAIN_TOL['params']:g}); launches per step {per_step[0]}")
    if sorted(grads) != sorted(want_g) or sorted(after) != sorted(want_p):
        raise PhaseFailed("golden training replay: the leaves differ from "
                          "the fixture's")
    if any(n != want_n for n in per_step):
        raise PhaseFailed(f"golden training replay: launches {per_step}, "
                          f"want {want_n} per step")
    if not (out["logits_max_abs_err"] <= GOLDEN_TRAIN_TOL["logits"]
            and out["loss_rel_err"] <= GOLDEN_TRAIN_TOL["loss"]
            and out["grad_rel_err"] <= GOLDEN_TRAIN_TOL["grad"]
            and out["params_max_abs_err"] <= GOLDEN_TRAIN_TOL["params"]):
        raise PhaseFailed("golden training replay disagrees with JAX")
    return out


def full_width_config():
    from dataclasses import replace

    from repro_torch.configs import get_config
    return replace(get_config("recurrentgemma_9b"), n_layers=5)


def full_width_train(torch, ops, cfg) -> dict:
    """(b) recurrentgemma-9b at full width, depth cut to 5 layers, trained
    4 steps through ``repro_torch.launch.train.run`` with the launch
    counts set to 0 just before the run: the loss finite at every step
    and lower at the last than at the first; each step's launches
    exactly ``train_launches``."""
    from repro_torch.launch import train
    want_n = train_launches(cfg, TRAIN_RUN["microbatches"])
    from torch.profiler import ProfilerActivity, profile
    per_step = []
    last = TRAIN_RUN["steps"] - 1
    prof = profile(activities=[ProfilerActivity.CUDA])
    for k in TRAIN_KERNELS:
        ops[k].launches = 0
    prev = counts(ops)

    def on_step(i, m):
        # the last step runs under the profiler: started after the one
        # before it, stopped after it
        nonlocal prev
        now = counts(ops)
        per_step.append({k: now[k] - prev[k] for k in now})
        prev = now
        if i == last - 1:
            prof.start()
        elif i == last:
            prof.stop()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train.run(cfg, device="cuda", on_step=on_step, log_every=1,
                    **TRAIN_RUN)
    torch.cuda.synchronize()
    launches = counts(ops)
    losses = [m["loss"] for m in out["metrics"]]
    tokens = TRAIN_RUN["batch"] * TRAIN_RUN["seq"]
    steady = out["step_s"][1:last]      # after the first, untraced
    rec = {"config": f"{cfg.name} n_layers={cfg.n_layers} "
                     f"({'/'.join(cfg.layer_kinds)}) d={cfg.d_model} "
                     f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} bf16 over "
                     f"fp32 masters, remat={cfg.remat}",
           "params": sum(p.numel() for p in out["model"].parameters()),
           "losses": losses, "grad_norms": [m["grad_norm"]
                                            for m in out["metrics"]],
           "step_s": out["step_s"],
           "steady_step_s": sum(steady) / len(steady),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_step": per_step}
    rec["tokens_per_s"] = tokens / rec["steady_step_s"]
    rec["trace"] = trace_summary(torch, prof, out["step_s"][last],
                                 f"training step {last + 1}", top=12)
    say(f"  (b) {rec['config']}, {rec['params'] / 1e9:.3f} B params: "
        f"losses {[round(x, 4) for x in losses]}; step times "
        f"{[round(x, 4) for x in out['step_s']]} s, steady "
        f"{rec['steady_step_s']:.4f} s/step, {rec['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {rec['peak_mem_gb']:.2f} GB; launches per "
        f"step {per_step[0]}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise PhaseFailed(f"full-width training: losses {losses} are not "
                          f"finite and falling")
    if any(n != want_n for n in per_step):
        raise PhaseFailed(f"full-width training: launches {per_step}, want "
                          f"{want_n} per step")
    del out
    torch.cuda.empty_cache()
    return rec


def train_vs_plain(torch, cfg) -> dict:
    """(c) One microbatch of the full-width model at the training run's
    initial weights (``init_params`` seed 0, fp32 masters), loss and
    gradients, through the kernels and then with the plain versions in
    their place (flash with its lse, the scan forward and reverse)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.runtime import data
    model = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
    model.requires_grad_(True)
    batch = next(data.copy_task_batches(TRAIN_RUN["batch"], TRAIN_RUN["seq"],
                                        cfg.vocab_size))
    one = {k: torch.as_tensor(v[:1], device="cuda") for k, v in batch.items()}

    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss, _ = T.loss_fn(model, cfg, one)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}
    lk, gk = loss_and_grads()
    kernels = (L.flash_attention, scan_ops.rglru_scan_fwd,
               scan_ops.rglru_scan_bwd)
    L.flash_attention, scan_ops.rglru_scan_fwd, scan_ops.rglru_scan_bwd = (
        fa_ref.attention_ref, scan_ref.rglru_scan_seq_ref,
        scan_ref.rglru_scan_reverse_ref)
    try:
        lp, gp = loss_and_grads()
    finally:
        L.flash_attention, scan_ops.rglru_scan_fwd, \
            scan_ops.rglru_scan_bwd = kernels
    rel = {n: ((gk[n] - gp[n]).abs().max() / gp[n].abs().max()).item()
           for n in gk}
    worst = max(rel, key=rel.get)
    out = {"loss_kernels": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_rel_err": rel[worst], "worst_leaf": worst,
           "finite": all(bool(torch.isfinite(g).all()) for g in gk.values())}
    del model, gk, gp
    torch.cuda.empty_cache()
    say(f"  (c) one microbatch at the initial weights through the kernels vs "
        f"the plain versions: "
        f"loss {lk:.6f} vs {lp:.6f} ({out['loss_rel_err']:.3g} rel, tol "
        f"{TRAIN_VS_PLAIN_TOL['loss']:g}); largest gradient difference "
        f"{out['grad_rel_err']:.3g} of the leaf's max, at {worst} (tol "
        f"{TRAIN_VS_PLAIN_TOL['grad']:g})")
    if not (out["finite"] and out["loss_rel_err"] <= TRAIN_VS_PLAIN_TOL["loss"]
            and out["grad_rel_err"] <= TRAIN_VS_PLAIN_TOL["grad"]):
        raise PhaseFailed("the full-width training step through the kernels "
                          "disagrees with its plain-version run")
    return out


def phase_train(torch, np, ops) -> dict:
    torch.cuda.empty_cache()
    cfg = full_width_config()
    out = {"golden": golden_train(torch, np, ops),
           "vs_plain": train_vs_plain(torch, cfg)}
    out["full_width"] = full = full_width_train(torch, ops, cfg)
    say(f"[5/16] training recurrentgemma-9b through the kernels: the JAX "
        f"golden fixture reproduced; full width, 5 layers, 4 steps, loss "
        f"{full['losses'][0]:.4f} -> {full['losses'][-1]:.4f}, launches "
        f"exact; kernels vs plain within the bf16 limits")
    return out


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

# the served engine: qwen2-1.5b's paged pool at slotted parity, prefix
# sharing with the victim cache, decode in 2 stages over 2 units, deadline
# shedding and observability on; tenant quotas are set in http_config
HTTP_ENGINE = dict(kv_layout="paged", block_size=BS, num_blocks=PARITY_BLOCKS,
                   max_slots=8, max_len=SERVE_S, prefix_cache=True,
                   victim_cache=True, units=2, decode_stages=2,
                   enforce_deadlines=True, observability=True)
HTTP_PROMPT, HTTP_SHARED, HTTP_NEW = 512, 256, 32
HTTP_TENANTS = ("a", "b")
HTTP_QUOTA_B_BLOCKS = 8     # b's budget: half of its 16-block shared preamble
HTTP_CLIENTS = 4
HTTP_TIMEOUT_S = 300


def http_config(cfg):
    """``HTTP_ENGINE`` with the tenants' byte budgets: a's holds its whole
    parked population, b's less than one 256-token chain."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import EngineConfig
    block = BS * T.kv_row_bytes(cfg)
    return EngineConfig(**HTTP_ENGINE, prefix_cache_tenants={
        "a": 4 * PARITY_BLOCKS * block, "b": HTTP_QUOTA_B_BLOCKS * block})


def http_workload(cfg, np) -> list:
    """16 requests of 512 prompt tokens, 8 per tenant in turns; each
    tenant's prompts share their first 256 tokens; requests 0, 1, 4, 5,
    ... stream NDJSON. Returns dicts of (prompt, tenant, stream)."""
    rng = np.random.RandomState(6)
    shared = {t: rng.randint(0, cfg.vocab_size, HTTP_SHARED)
              for t in HTTP_TENANTS}
    out = []
    for i in range(16):
        tenant = HTTP_TENANTS[i % 2]
        prompt = np.concatenate([shared[tenant], rng.randint(
            0, cfg.vocab_size, HTTP_PROMPT - HTTP_SHARED)]).astype(np.int32)
        out.append({"prompt": prompt, "tenant": tenant,
                    "stream": (i // 2) % 2 == 0})
    return out


def post(port: int, body: dict, stream: bool = False) -> dict:
    """One request over HTTP; returns the completion JSON (for a stream,
    its final line, checked against the streamed tokens)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/generate", json.dumps({**body,
                                                      "stream": stream}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise PhaseFailed(f"/generate -> {r.status}: {raw[:200]!r}")
    if not stream:
        return json.loads(raw)
    lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
    final = lines[-1]
    if not final.get("done") or final["tokens"] != [
            ln["token"] for ln in lines[:-1]]:
        raise PhaseFailed("an NDJSON stream disagrees with its final line")
    return final


def get(port: int, path: str):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        raw = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise PhaseFailed(f"GET {path} -> {r.status}")
    return raw


def body_of(req: dict) -> dict:
    return {"prompt": [int(t) for t in req["prompt"]],
            "max_new_tokens": HTTP_NEW, "tenant": req["tenant"]}


class LaunchRun:
    """One run's kernel launches, prefill/extend calls and decode steps:
    the counts set to 0 (and the engine's step counter read) just before
    the run, read just after it, once the engine is idle; 28 flash
    launches per prefill or extend call and 28 launches of the layout's
    decode kernel per decode step, the other decode kernel none."""

    def __init__(self, torch, ops, calls, eng, label: str):
        from repro_torch.kernels import _build
        self.torch, self.ops, self.calls = torch, ops, calls
        self.eng, self.label = eng, label
        _build.reset_launches(*(ops[k] for k in KERNELS))
        calls.take()
        self.steps0 = eng.stats()["steps"]

    def check(self) -> dict:
        self.eng.snapshot()             # under the engine lock: idle
        self.torch.cuda.synchronize()
        launches = {k: self.ops[k].launches for k in KERNELS}
        n_calls = self.calls.take()
        steps = self.eng.stats()["steps"] - self.steps0
        n = self.eng.cfg.n_layers
        paged = self.eng.config.kv_layout == "paged"
        want = {"flash_attention": n * sum(n_calls.values()),
                "decode_attention": 0 if paged else n * steps,
                "paged_decode_attention": n * steps if paged else 0}
        if launches != want or not launches["flash_attention"] or not steps:
            raise PhaseFailed(f"{self.label}: launches {launches}, want "
                              f"{want} ({n_calls} prefill/extend calls, "
                              f"{steps} decode steps)")
        return {"launches": launches, "calls": n_calls, "steps": steps}


def check_lengths(label: str, comps: list, vocab: int) -> None:
    for c in comps:
        if c["finish_reason"] != "length" or len(c["tokens"]) != HTTP_NEW:
            raise PhaseFailed(f"{label}: a request ended {c['finish_reason']} "
                              f"with {len(c['tokens'])} tokens")
        if any(not 0 <= t < vocab for t in c["tokens"]):
            raise PhaseFailed(f"{label}: token outside the vocabulary")


def timing(comps: list, wall_s: float) -> dict:
    toks = sum(len(c["tokens"]) for c in comps)
    ttft = sorted(c["ttft_s"] for c in comps)
    return {"wall_s": wall_s, "tok_per_s": toks / wall_s,
            "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3}


def inprocess_run(eng, reqs, warm_prompt) -> tuple:
    """The ordered run through a caller-pumped engine: the server's
    warmup request, then each request submitted after the previous one
    completed, as the single HTTP client sends them."""
    from repro_torch.runtime.scheduler import Request
    eng.submit(Request(10 ** 6, warm_prompt, max_new_tokens=2)).result()
    out, t0 = [], time.perf_counter()
    for i, r in enumerate(reqs):
        c = eng.submit(Request(i, r["prompt"], max_new_tokens=HTTP_NEW,
                               tenant=r["tenant"])).result()
        out.append({"tokens": c.tokens, "finish_reason": c.finish_reason,
                    "ttft_s": c.ttft_s})
    return out, time.perf_counter() - t0


def agree(a: list, b: list) -> float:
    return sum(x["tokens"] == y["tokens"] for x, y in zip(a, b)) / len(a)


def phase_http(torch, np, ops, smi: str) -> dict:
    """qwen2-1.5b at full width and depth in bf16 served over HTTP by an
    ``EngineServer`` whose ``Engine`` is background-drained on the paged
    pool with the victim cache, tenant quotas, decode in 2 stages over 2
    units, deadline shedding and observability; see the module
    docstring for (a)-(h)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.observability import (parse_prometheus,
                                                   validate_chrome_trace)
    from repro_torch.runtime.server import EngineServer, ServerConfig
    from repro_torch.runtime.scheduler import Request
    torch.cuda.empty_cache()
    model = T.init_params(get_config("qwen2_1_5b"), 0, device="cuda")
    cfg = model.cfg
    ec = http_config(cfg)
    reqs = http_workload(cfg, np)
    block = BS * T.kv_row_bytes(cfg)
    warm_prompt = np.ones(8, np.int32)      # EngineServer's warmup request
    out = {}
    calls = Calls(T)
    try:
        # (a) the in-process reference: decode in one stage, same pool,
        # same order, caller-pumped
        ref_eng = Engine(cfg, model, dataclasses.replace(
            ec, units=1, decode_stages=1), device="cuda")
        run = LaunchRun(torch, ops, calls, ref_eng, "in-process ordered run")
        inproc, inproc_s = inprocess_run(ref_eng, reqs, warm_prompt)
        out["inprocess"] = {**run.check(), **timing(inproc, inproc_s)}
        check_lengths("in-process ordered run", inproc, cfg.vocab_size)
        del ref_eng
        # (b) slice 1's path: the same requests through a slotted fifo
        # engine, all submitted at once
        slot_eng = Engine(cfg, model, EngineConfig(
            max_slots=8, max_len=SERVE_S, admission="fifo"), device="cuda")
        run = LaunchRun(torch, ops, calls, slot_eng, "slotted fifo run")
        slotted = [{"tokens": c.tokens} for c in slot_eng.generate(
            [Request(i, r["prompt"], max_new_tokens=HTTP_NEW)
             for i, r in enumerate(reqs)])]
        out["slotted"] = run.check()
        del slot_eng
        eng = Engine(cfg, model, ec, device="cuda")
        srv = EngineServer(eng, ServerConfig(port=0, max_inflight=32))
        t0 = time.perf_counter()
        srv.start()
        out["start_s"] = time.perf_counter() - t0
        try:
            if get(srv.port, "/health/ready") != b'{"status": "ready"}':
                raise PhaseFailed("/health/ready is not ready after start")
            # (a) the ordered run over HTTP, one client
            run = LaunchRun(torch, ops, calls, eng, "HTTP ordered run")
            t0 = time.perf_counter()
            http = [post(srv.port, body_of(r), r["stream"]) for r in reqs]
            http_s = time.perf_counter() - t0
            out["http"] = {**run.check(), **timing(http, http_s)}
            check_lengths("HTTP ordered run", http, cfg.vocab_size)
            if [c["tokens"] for c in http] != [c["tokens"] for c in inproc]:
                raise PhaseFailed(
                    "the HTTP run's tokens (2 decode stages, drain thread) "
                    "differ from the in-process run's (1 stage, pumped): "
                    f"{agree(http, inproc):.3f} of requests agree")
            pc_a = json.loads(get(srv.port, "/status"))["prefix_cache"]
            out["agreement_slotted"] = agree(http, slotted)
            # (c) the same requests from concurrent clients
            run = LaunchRun(torch, ops, calls, eng, "concurrent HTTP run")
            conc, errs = [None] * len(reqs), []

            def client(k):
                try:
                    for i in range(k, len(reqs), HTTP_CLIENTS):
                        conc[i] = post(srv.port, body_of(reqs[i]),
                                       reqs[i]["stream"])
                except Exception as exc:    # noqa: BLE001 — reported below
                    errs.append(exc)
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(HTTP_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=HTTP_TIMEOUT_S)
            conc_s = time.perf_counter() - t0
            if errs or any(t.is_alive() for t in threads) or None in conc:
                raise PhaseFailed(f"concurrent clients: not every request "
                                  f"completed ({errs[:1]})")
            out["concurrent"] = {**run.check(), **timing(conc, conc_s)}
            check_lengths("concurrent HTTP run", conc, cfg.vocab_size)
            out["agreement_concurrent"] = agree(conc, http)
            # (d) deadlines of 1 ms: shed as timeout, books balanced
            rng = np.random.RandomState(7)
            shed = [post(srv.port, {"prompt": [int(t) for t in rng.randint(
                0, cfg.vocab_size, HTTP_PROMPT)], "max_new_tokens": HTTP_NEW,
                "deadline_s": 0.001}) for _ in range(2)]
            if any(c["finish_reason"] != "timeout" for c in shed):
                raise PhaseFailed(f"1 ms deadlines: "
                                  f"{[c['finish_reason'] for c in shed]}")
            with eng._entry_lock():
                home_whole(eng, "after the deadline sheds")
            # (e) metrics, trace and status
            st = json.loads(get(srv.port, "/status"))
            metrics = parse_prometheus(get(srv.port, "/metrics").decode())
            sent = 1 + 2 * len(reqs) + len(shed)    # the warmup included
            never = sum(not c["tokens"] for c in shed)
            mc = metrics["counters"]
            if (mc["repro_requests_submitted_total"] != sent
                    or mc["repro_admissions_total"] != sent - never
                    or mc["repro_sheds_total"] != len(shed)
                    or metrics["histograms"]["repro_ttft_seconds"]["count"]
                    != sent - never):
                raise PhaseFailed(f"/metrics counters {mc} and TTFT "
                                  f"histogram do not match {sent} requests "
                                  f"sent ({never} shed before admission)")
            trace = json.loads(get(srv.port, "/trace"))
            n_events = validate_chrome_trace(trace)
            meta = [m for m in trace["traceEvents"] if m.get("ph") == "M"]
            unit_pids = {m["pid"] for m in meta if m["name"] == "process_name"
                         and m["args"]["name"] == "units"}
            units = {m["args"]["name"] for m in meta
                     if m["name"] == "thread_name" and m["pid"] in unit_pids}
            if units != {"decode0", "decode1"}:
                raise PhaseFailed(f"/trace: units tracks {units}")
            pc = st["prefix_cache"]
            per = pc["per_tenant_bytes"]
            a_blocks = (HTTP_SHARED + 8 * (HTTP_PROMPT - HTTP_SHARED)) // BS
            if not (pc["victim_hits"] > pc_a["victim_hits"]
                    and pc["victim_evictions"] > 0
                    and per["a"] == a_blocks * block
                    and per["b"] <= HTTP_QUOTA_B_BLOCKS * block):
                raise PhaseFailed(f"/status prefix cache {pc}: want more "
                                  f"victim hits in the second wave than "
                                  f"{pc_a['victim_hits']}, tenant a whole "
                                  f"({a_blocks} blocks), b evicted to its "
                                  f"quota")
            out["status"] = {"prefix_cache": pc, "counters": st["counters"],
                             "units": st["units"], "trace_events": n_events,
                             "victim_hits_after_a": pc_a["victim_hits"]}
            # (f) save, shut down, restore into a fresh engine, resend a
            with tempfile.TemporaryDirectory() as tmp:
                path = str(Path(tmp) / "prefix.npz")
                chains = eng.save_prefix_cache(path)
                parked = len(eng.scheduler.layout.victim)
                srv.close()
                srv = None
                eng = Engine(cfg, model, ec, device="cuda")
                t0 = time.perf_counter()
                restored = eng.restore_prefix_cache(path)
                restore_s = time.perf_counter() - t0
            if restored != parked:
                raise PhaseFailed(f"restored {restored} blocks of "
                                  f"{parked} parked")
            srv = EngineServer(eng, ServerConfig(port=0, max_inflight=32))
            srv.start()
            run = LaunchRun(torch, ops, calls, eng, "restored run")
            mine = [i for i, r in enumerate(reqs) if r["tenant"] == "a"]
            again = [post(srv.port, body_of(reqs[i])) for i in mine]
            out["restored"] = run.check()
            check_lengths("restored run", again, cfg.vocab_size)
            st2 = eng.stats()
            out["restore"] = {
                "chains": chains, "blocks": restored, "restore_s": restore_s,
                "victim_hits": st2["victim_hits"],
                "prefill_tokens_saved": st2["prefill_tokens_saved"],
                "agreement_ordered": agree(again, [http[i] for i in mine]),
                "agreement_concurrent": agree(again, [conc[i] for i in mine])}
            if st2["victim_hits"] < len(mine) \
                    or st2["prefill_tokens_saved"] <= 0:
                raise PhaseFailed(f"the restored engine's hits: {st2}")
            if out["restore"]["agreement_ordered"] != 1.0:
                raise PhaseFailed(
                    f"tenant a's tokens after the restore differ from the "
                    f"ordered run's: {out['restore']}")
        finally:
            if srv is not None:
                srv.close()
    finally:
        calls.restore()
    h, ip = out["http"], out["inprocess"]
    say(f"  {smi}")
    for label, m in (("in-process ordered", ip), ("HTTP ordered", h),
                     ("HTTP 4 clients", out["concurrent"])):
        say(f"  {label} run: wall {m['wall_s']:.3f} s, {m['tok_per_s']:.1f} "
            f"output tok/s, TTFT p50 {m['ttft_p50_ms']:.1f} ms; "
            f"{m['steps']} decode steps, launches {m['launches']}")
    say(f"  HTTP against in-process (ordered, one request at a time): wall "
        f"x{h['wall_s'] / ip['wall_s']:.4f}, TTFT p50 "
        f"{h['ttft_p50_ms'] - ip['ttft_p50_ms']:+.1f} ms; server start with "
        f"warmup {out['start_s']:.2f} s")
    say(f"  agreement with the slotted fifo run {out['agreement_slotted']:.3f}"
        f", concurrent with ordered {out['agreement_concurrent']:.3f}; "
        f"deadlines: 2 shed as timeout; victim hits "
        f"{out['status']['victim_hits_after_a']} -> "
        f"{out['status']['prefix_cache']['victim_hits']}, evictions "
        f"{out['status']['prefix_cache']['victim_evictions']} (tenant b), "
        f"{out['status']['trace_events']} trace events")
    r = out["restore"]
    say(f"  restore: {r['chains']} chains, {r['blocks']} blocks in "
        f"{r['restore_s']:.3f} s; tenant a resent: {r['victim_hits']} victim "
        f"hits, {r['prefill_tokens_saved']} prompt tokens saved, tokens "
        f"equal to the ordered run's on {r['agreement_ordered']:.3f} (to the "
        f"concurrent run's {r['agreement_concurrent']:.3f})")
    say("[6/16] serving qwen2-1.5b over HTTP (background drain, paged pool, "
        "victim cache, tenant quotas, 2 decode stages, deadlines, "
        "observability): tokens equal the in-process run, the restored "
        "cache's and launches exact in every run")
    return out


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

# the paper's CNNs at the paper's sizes (the dual-input graph at its
# default 96 x 96): graph builder and its keyword arguments
CNN_GRAPHS = {"vehicle": ("vehicle_graph", {}),
              "dual_input": ("dual_input_vehicle_graph", {}),
              "ssd": ("ssd_mobilenet_graph", {})}
CNN_FRAMES = 2
# a CNN actor on the card (cuDNN, TF32 off) against the same graph on the
# CPU, fp32: the CPU tests' limit against JAX, |a - b| <= atol + rtol|b|
CNN_TOL = {"atol": 1e-5, "rtol": 1e-4}
# per-actor times: a synchronized fire timed alone, and fires back to back
# with the device held (``cuda_ms``)
ACTOR_REPS = 10
# the modeled rows of the paper benches (name, value), taken on the CPU
# from the reference (``benchmarks/fig4_vehicle_n2.py``,
# ``fig5_vehicle_n270.py``, ``fig6_ssd_n2.py``, run with JAX): the paper's
# N2 / N270 / i7 devices, not this card
PAPER_ROWS = {
    "fig4": [
        ('n2_ethernet_pp1', 10.124285714285714), ('n2_ethernet_pp2',
        29.099982417582417), ('n2_ethernet_pp3', 15.65088791208791),
        ('n2_ethernet_pp4', 18.92932947052947), ('n2_ethernet_pp5',
        19.198181418581417), ('n2_ethernet_best_pp', 3), ('n2_ethernet_best_ms',
        15.65088791208791), ('n2_wifi_pp1', 25.65939675174014), ('n2_wifi_pp2',
        68.42505800464036), ('n2_wifi_pp3', 17.10626450116009), ('n2_wifi_pp4',
        18.893615184815186), ('n2_wifi_pp5', 19.198181418581417),
        ('n2_wifi_best_pp', 3), ('n2_wifi_best_ms', 17.10626450116009),
        ('n2_full_endpoint_ms', 19.198181418581417),
        ('n2_raw_offload_ethernet_ms', 10.124285714285714)
    ],
    "fig5": [
        ('n270_ethernet_pp1', 9.974285714285713), ('n270_ethernet_pp2',
        142.33456993268513), ('n270_ethernet_pp3', 431.4943754674645),
        ('n270_ethernet_pp4', 449.62456594365494), ('n270_ethernet_pp5',
        449.828904991274), ('n270_ethernet_best_pp', 2), ('n270_ethernet_best_ms',
        142.33456993268513), ('n270_wifi_pp1', 23.63021276595745),
        ('n270_wifi_pp2', 178.75037540380976), ('n270_wifi_pp3',
        440.59832683524564), ('n270_wifi_pp4', 449.6739580409194),
        ('n270_wifi_pp5', 449.828904991274), ('n270_wifi_best_pp', 2),
        ('n270_wifi_best_ms', 178.75037540380976), ('n270_full_endpoint_ms',
        449.828904991274)
    ],
    "fig6": [
        ('ssd_ethernet_pp1', 157.15857142857143), ('ssd_ethernet_pp2',
        434.16691868131863), ('ssd_ethernet_pp3', 908.2603296703295),
        ('ssd_ethernet_pp4', 534.5300571428571), ('ssd_ethernet_pp5',
        579.357534065934), ('ssd_ethernet_pp6', 398.9853162197802),
        ('ssd_ethernet_pp7', 423.0275623736264), ('ssd_ethernet_pp8',
        329.28998118681324), ('ssd_ethernet_pp9', 349.4629251868132),
        ('ssd_ethernet_pp10', 369.6358691868132), ('ssd_ethernet_pp11',
        389.8088131868132), ('ssd_ethernet_pp12', 409.98175718681324),
        ('ssd_ethernet_pp13', 644.9822943296704), ('ssd_ethernet_pp14',
        573.0985337582418), ('ssd_ethernet_pp15', 539.5749657582418),
        ('ssd_ethernet_pp16', 681.4182844395605), ('ssd_ethernet_pp17',
        653.9283084997109), ('ssd_ethernet_pp18', 641.7265810271833),
        ('ssd_ethernet_pp19', 645.5463678403702), ('ssd_ethernet_pp20',
        648.2507833128976), ('ssd_ethernet_pp21', 652.3399538623481),
        ('ssd_ethernet_pp22', 658.1641484997108), ('ssd_ethernet_pp23',
        662.6016772909197), ('ssd_ethernet_pp24', 663.8172980381723),
        ('ssd_ethernet_pp25', 666.3031511370735), ('ssd_ethernet_pp26',
        666.5531511370734), ('ssd_ethernet_pp27', 566.1093614227876),
        ('ssd_ethernet_pp28', 513.2602141700405), ('ssd_ethernet_pp29',
        508.32784054366687), ('ssd_ethernet_pp30', 508.2538911810295),
        ('ssd_ethernet_pp31', 508.8325290711394), ('ssd_ethernet_pp32',
        509.4497825216888), ('ssd_ethernet_pp33', 509.6997825216889),
        ('ssd_ethernet_pp34', 741.8775682359746), ('ssd_ethernet_pp35',
        2361.8485110931174), ('ssd_wifi_pp1', 311.31004640371225),
        ('ssd_wifi_pp2', 845.2375186150276), ('ssd_wifi_pp3', 1730.4015295377476),
        ('ssd_wifi_pp4', 945.600657076566), ('ssd_wifi_pp5', 990.428133999643),
        ('ssd_wifi_pp6', 610.0380971279671), ('ssd_wifi_pp7', 634.0803432818134),
        ('ssd_wifi_pp8', 434.8163716409067), ('ssd_wifi_pp9', 454.9893156409067),
        ('ssd_wifi_pp10', 475.1622596409067), ('ssd_wifi_pp11',
        495.33520364090674), ('ssd_wifi_pp12', 515.5081476409067),
        ('ssd_wifi_pp13', 961.5614656919507), ('ssd_wifi_pp14',
        797.1360072418347), ('ssd_wifi_pp15', 716.5494230005355),
        ('ssd_wifi_pp16', 975.3194901074424), ('ssd_wifi_pp17',
        896.5598754536386), ('ssd_wifi_pp18', 847.8185390981148),
        ('ssd_wifi_pp19', 846.1288380094122), ('ssd_wifi_pp20',
        845.4716094647041), ('ssd_wifi_pp21', 848.8927902892624),
        ('ssd_wifi_pp22', 855.155460233221), ('ssd_wifi_pp23', 859.2961047022554),
        ('ssd_wifi_pp24', 860.0732501429121), ('ssd_wifi_pp25',
        862.5579613790356), ('ssd_wifi_pp26', 862.8079613790358),
        ('ssd_wifi_pp27', 659.3110559869243), ('ssd_wifi_pp28',
        549.3687698544952), ('ssd_wifi_pp29', 537.4710332848005),
        ('ssd_wifi_pp30', 536.2049791823554), ('ssd_wifi_pp31',
        536.2537927436618), ('ssd_wifi_pp32', 536.8116693297765),
        ('ssd_wifi_pp33', 537.0616693297762), ('ssd_wifi_pp34',
        741.9061148054145), ('ssd_wifi_pp35', 2361.8485110931174),
        ('ssd_full_endpoint_ms', 2361.8485110931174), ('ssd_at_paper_cut_ms',
        389.8088131868132), ('ssd_speedup_at_paper_cut', 6.058992078152983),
        ('ssd_model_best_ms', 329.28998118681324),
        ('ssd_model_best_boundary_bytes', 739328), ('ssd_wifi_at_paper_region_ms',
        495.33520364090674)
    ],
}
# the LLM actor graph: qwen2-1.5b at full width and depth, bf16, B = 1 and
# a 512-token prompt, one actor a layer; cuts after 1, 15 and 30 of its
# 31 actors, with the bytes that cross each (the int32 prompt, then the
# (1, 512, 1536) bf16 activation)
LLM_S = 512
LLM_CUTS = {1: 2048, 15: 1572864, 30: 1572864}
PIPE_CUT = 15           # the cut a pipelined stream and a timed frame take
LLM_PIPE_FRAMES = 3
# recurrentgemma-9b at full width cut to 5 layers (rglru, rglru,
# attn_local, rglru, rglru) at S = 4096, cut after 4 of its 8 actors
HYBRID_S = 4096
HYBRID_CUT = 4
EDGE_KERNELS = ("flash_attention", "rglru_scan_fwd", "rglru_scan_bwd",
                "decode_attention", "paged_decode_attention")


class ActorLog:
    """Every actor's fire function of a graph, wrapped. ``keep()`` then
    keeps each firing's outputs (and each actor's first inputs); after
    ``check(stateless)`` each firing's outputs are compared bit for bit
    with the kept firing of the same index (modulo the kept frames, so
    runs of the same frames may follow each other). A staged run
    (``run_local``, ``run_pipelined``) fires every actor with no state,
    so there an actor with state is compared at its first frame only."""

    def __init__(self, torch, g):
        self.torch, self.g = torch, g
        self.fire = {}
        self.kept, self.first_inputs = {}, {}
        self.mode, self.stateless, self.n = "keep", False, {}
        self.compared, self.differ = 0, []
        for a in g.actors.values():
            self.fire[a.name] = a.fire_fn
            a.fire_fn = self._wrap(a)

    def _wrap(self, actor):
        def fire(inputs, st, atr):
            i = self.n.get(actor.name, 0)
            self.n[actor.name] = i + 1
            out, st = self.fire[actor.name](inputs, st, atr)
            if self.mode == "keep":
                self.kept.setdefault(actor.name, []).append(out)
                if i == 0:
                    self.first_inputs[actor.name] = inputs
            else:
                kept = self.kept[actor.name]
                j = i % len(kept)
                if not (self.stateless and actor.init_fn and j > 0):
                    self._compare(actor.name, j, out, kept[j])
            return out, st
        return fire

    def _compare(self, name, j, out, want):
        same = sorted(out) == sorted(want) and all(
            len(out[p]) == len(want[p]) and all(
                self.torch.equal(a, b) for a, b in zip(out[p], want[p]))
            for p in want)
        self.compared += 1
        if not same:
            self.differ.append(f"{name}#{j}")

    def keep(self):
        self.mode, self.n = "keep", {}

    def check(self, stateless: bool):
        self.mode, self.stateless, self.n = "check", stateless, {}


def cnn_frames(torch, np, g, dev, seed: int = 7):
    """``CNN_FRAMES`` images per source actor from a numpy generator, as
    float32 tensors on ``dev``: ``Simulator`` source inputs."""
    rng = np.random.RandomState(seed)
    return {a.name: [torch.from_numpy(rng.rand(*a.out_ports[0].token_shape)
                                      .astype(np.float32)).to(dev)
                     for _ in range(CNN_FRAMES)]
            for a in g.actors.values() if a.is_source}


def nms_picks(torch, conf):
    """NMS's picks from its conf input, as the actor makes them."""
    score = 1.0 - torch.softmax(conf, dim=-1)[:, 0]
    return torch.argsort(-score, stable=True)[:10], score


def cnn_vs_cpu(torch, card: ActorLog, host: ActorLog) -> dict:
    """Every actor's every output on the card against the CPU's, within
    ``CNN_TOL``. NMS's picks must be equal, except where two picks'
    scores lie within the limit of each other; a frame where they differ
    leaves NMS's and the Tracker's outputs uncompared."""
    atol, rtol = CNN_TOL["atol"], CNN_TOL["rtol"]
    skip, worst, worst_at, bad = set(), 0.0, "", []
    for f, (fc, fh) in enumerate(zip(card.kept.get("ConcatConf", []),
                                     host.kept.get("ConcatConf", []))):
        pc, _ = nms_picks(torch, fc["out"][0].cpu())
        ph, score = nms_picks(torch, fh["out"][0])
        if not torch.equal(pc, ph):
            skip.add(f)
            for i in (pc != ph).nonzero().flatten().tolist():
                a, b = score[ph[i]].item(), score[pc[i]].item()
                if abs(a - b) > atol + rtol * abs(a):
                    bad.append(f"NMS pick {i} of frame {f}: {a} vs {b}")
    for name, frames in host.kept.items():
        for f, (oh, oc) in enumerate(zip(frames, card.kept[name])):
            if name in ("NMS", "Tracker") and f in skip:
                continue
            for p in oh:
                for h, c in zip(oh[p], oc[p]):
                    c = c.cpu()
                    err = (c - h).abs()
                    if c.shape != h.shape or not bool(
                            (err <= atol + rtol * h.abs()).all()):
                        bad.append(f"{name}.{p} frame {f}")
                    e = err.max().item() if err.numel() else 0.0
                    if e > worst:
                        worst, worst_at = e, f"{name}.{p}"
    return {"max_abs_err": worst, "at": worst_at, "nms_frames_skipped":
            sorted(skip), "outside": bad}


def actor_times(torch, log: ActorLog) -> dict:
    """Each actor fired alone on its first frame's inputs: the device
    span of one synchronized fire between two CUDA events (the median of
    ``ACTOR_REPS``; host launch gaps included), and ``cuda_ms`` of fires
    back to back with the device held (the kernels' own time)."""
    out = {}
    for a in log.g.topo_order():
        inputs = log.first_inputs[a.name]
        rates = {p.name: 1 for p in a.in_ports + a.out_ports}
        state = a.init_fn() if a.init_fn else None

        def fire(fn=log.fire[a.name], inputs=inputs, rates=rates,
                 state=state):
            return fn(inputs, state, rates)
        spans = []
        for _ in range(ACTOR_REPS + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fire()
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        spans = sorted(spans[2:])
        out[a.name] = {"span_ms": spans[len(spans) // 2],
                       "busy_ms": cuda_ms(torch, fire, iters=ACTOR_REPS)}
    return out


def cnn_graph(torch, np, label: str, smi: str) -> dict:
    """One CNN at the paper's size: built on the card and on the CPU from
    the same seed and fed the same frames, held actor by actor; then on
    the card the Simulator's run against the Simulator at every partition
    point of ``Explorer.evaluate_simulated`` and against ``run_local``
    and ``run_pipelined`` of each point's staged program, bit for bit;
    then each actor's device time."""
    from repro_torch.core import (Explorer, Simulator, paper_platform,
                                  synthesize)
    from repro_torch.models import cnn
    name, kw = CNN_GRAPHS[label]
    g = getattr(cnn, name)(**kw, device="cuda")
    host = getattr(cnn, name)(**kw, device="cpu")
    feeds = cnn_frames(torch, np, g, "cuda")
    card_log, host_log = ActorLog(torch, g), ActorLog(torch, host)
    Simulator(host).run(CNN_FRAMES, source_inputs={
        k: [t.cpu() for t in v] for k, v in feeds.items()})
    Simulator(g).run(CNN_FRAMES, source_inputs=feeds)
    torch.cuda.synchronize()
    vs_cpu = cnn_vs_cpu(torch, card_log, host_log)
    del host, host_log

    plat = paper_platform("N2", "ethernet",
                          **({"workload": "ssd"} if label == "ssd" else {}))
    explorer = Explorer(g, plat)
    card_log.check(stateless=False)
    explorer.evaluate_simulated(CNN_FRAMES, source_inputs=feeds)
    points = len(explorer.mappings())
    card_log.check(stateless=True)
    frames = [{k: v[f] for k, v in feeds.items()} for f in range(CNN_FRAMES)]
    for m in explorer.mappings():
        prog = synthesize(g, m)
        for frame in frames:
            prog.run_local(frame)
        prog.run_pipelined(frames)
    torch.cuda.synchronize()
    rec = {"actors": len(g.actors), "partition_points": points,
           "vs_cpu": vs_cpu, "compared": card_log.compared,
           "differ": card_log.differ[:10]}
    if label == "ssd":
        rec["paper_cut"] = cnn.partition_point_after(g, "DWCL9")
    rec["times"] = actor_times(torch, card_log)
    span = sum(t["span_ms"] for t in rec["times"].values())
    busy = sum(t["busy_ms"] for t in rec["times"].values())
    rec["frame_span_ms"], rec["frame_busy_ms"] = span, busy
    say(f"  {label}: {len(g.actors)} actors, {CNN_FRAMES} frames; card vs "
        f"CPU max |err| {vs_cpu['max_abs_err']:.3g} at {vs_cpu['at']} "
        f"(limit {CNN_TOL['atol']:g} + {CNN_TOL['rtol']:g}|ref|), "
        f"{len(vs_cpu['outside'])} outside; Simulator vs the Simulator at "
        f"{points} partition points and run_local / run_pipelined at each: "
        f"{card_log.compared} firings compared, {len(card_log.differ)} "
        f"differ; actors summed {span:.4f} ms a frame fired alone "
        f"({busy:.4f} ms busy) ({smi})")
    for a, t in rec["times"].items():
        say(f"    {a:12s} {t['span_ms']:9.4f} ms alone, "
            f"{t['busy_ms']:9.4f} ms busy")
    if vs_cpu["outside"]:
        raise PhaseFailed(f"{label}: card vs CPU outside the limit at "
                          f"{vs_cpu['outside'][:5]}")
    if card_log.differ or not card_log.compared:
        raise PhaseFailed(f"{label}: partitioned runs differ from the "
                          f"Simulator's at {card_log.differ[:5]}")
    return rec


def paper_rows(torch) -> dict:
    """The modeled Fig 4-6 rows of ``benchmarks/torch_paper.py`` with the
    graphs on the card: equal to the reference's, row for row."""
    from benchmarks import torch_paper
    out = {}
    for key, want in PAPER_ROWS.items():
        got = [(r.name, r.value) for r in torch_paper.BENCHES[key]("cuda")]
        out[key] = len(got)
        if got != want:
            diff = [(a, b) for a, b in zip(got, want) if a != b][:3]
            raise PhaseFailed(f"{key}: modeled rows differ from the "
                              f"reference's: {diff} ({len(got)} rows, want "
                              f"{len(want)})")
    say(f"  modeled paper rows equal the reference's: {out} (the paper's "
        f"N2 / N270 / i7 devices, modeled)")
    return out


def edge_counts(ops) -> dict:
    return {k: ops[k].launches for k in EDGE_KERNELS}


def edge_reset(ops) -> None:
    from repro_torch.kernels import _build
    _build.reset_launches(*(ops[k] for k in EDGE_KERNELS))


def timed_frame(torch, fn, label: str) -> tuple:
    """``fn()`` once, synchronized: its wall time on the host clock, its
    device span between two CUDA events, and a second call under
    ``torch.profiler`` for the device's busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    rec = {"wall_s": wall_s, "span_ms": start.elapsed_time(end),
           "trace": trace_summary(torch, prof, traced_s, label, top=6)}
    return out, rec


def llm_partitioned(torch, np, ops, smi: str) -> dict:
    """qwen2-1.5b's actor graph at full width: each cut's logits equal the
    monolithic ``forward``'s bit for bit, its boundary bytes the
    reference graph's, 28 flash launches a frame; a pipelined stream of
    ``LLM_PIPE_FRAMES`` frames launches 28 a frame and equals ``forward``
    frame by frame; one partitioned frame and one monolithic frame
    timed."""
    from repro_torch.configs import get_config
    from repro_torch.core import Mapping
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import PartitionedServeEngine
    cfg = get_config("qwen2_1_5b")
    model = T.init_params(cfg, 0, device="cuda")
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, (1, LLM_S)).astype(np.int32)
    names = list(T.to_actor_graph(cfg, batch=1, seq=LLM_S).actors)
    want = {k: 0 for k in EDGE_KERNELS}

    def mono(tokens):
        with torch.no_grad():
            return T.forward(model, cfg, {"tokens": torch.as_tensor(
                tokens, device="cuda")}, train=False)[0]
    edge_reset(ops)
    ref = mono(prompt)
    torch.cuda.synchronize()
    rec = {"actors": len(names), "forward_launches": edge_counts(ops),
           "cuts": {}}
    want["flash_attention"] = cfg.n_layers
    if rec["forward_launches"] != want:
        raise PhaseFailed(f"qwen2 forward: launches "
                          f"{rec['forward_launches']}, want {want}")
    engines = {}
    for pp, bytes_want in LLM_CUTS.items():
        mapping = Mapping(f"pp{pp}", {n: ("endpoint" if i < pp else "server")
                                      for i, n in enumerate(names)})
        pse = engines[pp] = PartitionedServeEngine(cfg, model, mapping,
                                                   batch=1, seq=LLM_S)
        edge_reset(ops)
        logits = pse.infer(prompt)
        torch.cuda.synchronize()
        cut = {"boundary_bytes": pse.comm_bytes(),
               "equal": torch.equal(logits, ref),
               "launches": edge_counts(ops)}
        rec["cuts"][pp] = cut
        say(f"  qwen2-1.5b actor graph cut after {names[pp - 1]} (pp={pp} "
            f"of {len(names)}): boundary {cut['boundary_bytes']} B, logits "
            f"equal forward bit for bit: {cut['equal']}, launches "
            f"{cut['launches']}")
        if not cut["equal"] or cut["boundary_bytes"] != bytes_want \
                or cut["launches"] != want:
            raise PhaseFailed(f"qwen2 cut pp={pp}: {cut}, want "
                              f"{bytes_want} B and launches {want}")
    pse = engines[PIPE_CUT]
    frames = [rng.randint(0, cfg.vocab_size, (1, LLM_S)).astype(np.int32)
              for _ in range(LLM_PIPE_FRAMES)]
    edge_reset(ops)
    outs, _ = pse.infer_pipelined(frames)
    torch.cuda.synchronize()
    piped = edge_counts(ops)
    same = [torch.equal(o, mono(f)) for o, f in zip(outs, frames)]
    rec["pipelined"] = {"frames": len(frames), "launches": piped,
                        "equal": same}
    want_n = dict(want, flash_attention=cfg.n_layers * len(frames))
    say(f"  infer_pipelined over {len(frames)} frames at pp={PIPE_CUT}: launches "
        f"{piped}, each frame equal to forward: {same}")
    if piped != want_n or not all(same):
        raise PhaseFailed(f"qwen2 pipelined: launches {piped} (want "
                          f"{want_n}), equal {same}")
    _, rec["frame_partitioned"] = timed_frame(
        torch, lambda: pse.infer(prompt), f"partitioned frame (pp={PIPE_CUT})")
    _, rec["frame_forward"] = timed_frame(
        torch, lambda: mono(prompt), "monolithic forward")
    for k in ("frame_partitioned", "frame_forward"):
        t = rec[k]
        say(f"  {k}: wall {t['wall_s'] * 1e3:.3f} ms, device span "
            f"{t['span_ms']:.3f} ms, busy {t['trace']['device_busy_s'] * 1e3:.3f}"
            f" ms, idle share {t['trace']['idle_share']:.4f} ({smi})")
    del model, engines, pse, ref, outs
    torch.cuda.empty_cache()
    return rec


def hybrid_partitioned(torch, np, ops) -> dict:
    """recurrentgemma-9b at full width cut to 5 layers, fp32 masters cast
    once at export: the cut's logits equal ``forward``'s (which casts at
    every call) bit for bit, with 1 flash and 4 scan forward launches a
    frame on both."""
    from repro_torch.core import Mapping
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import PartitionedServeEngine
    cfg = full_width_config()
    model = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, HYBRID_S)).astype(np.int32)
    kinds = cfg.layer_kinds
    want = {k: 0 for k in EDGE_KERNELS}
    want["flash_attention"] = sum(k != "rglru" for k in kinds)
    want["rglru_scan_fwd"] = kinds.count("rglru")
    edge_reset(ops)
    with torch.no_grad():
        ref = T.forward(model, cfg, {"tokens": torch.as_tensor(
            tokens, device="cuda")}, train=False)[0]
    torch.cuda.synchronize()
    mono_n = edge_counts(ops)
    names = list(T.to_actor_graph(cfg, batch=1, seq=HYBRID_S).actors)
    mapping = Mapping("cut", {n: ("endpoint" if i < HYBRID_CUT else "server")
                              for i, n in enumerate(names)})
    pse = PartitionedServeEngine(cfg, model, mapping, batch=1, seq=HYBRID_S)
    edge_reset(ops)
    logits = pse.infer(tokens)
    torch.cuda.synchronize()
    rec = {"config": f"{cfg.name} n_layers={cfg.n_layers} "
                     f"({'/'.join(kinds)}) S={HYBRID_S}",
           "forward_launches": mono_n, "launches": edge_counts(ops),
           "boundary_bytes": pse.comm_bytes(),
           "equal": torch.equal(logits, ref)}
    say(f"  {rec['config']} cut after {names[HYBRID_CUT - 1]}: boundary "
        f"{rec['boundary_bytes']} B, logits equal forward bit for bit: "
        f"{rec['equal']}, launches {rec['launches']} (forward "
        f"{mono_n})")
    del model, pse, ref, logits
    torch.cuda.empty_cache()
    if not rec["equal"] or rec["launches"] != want or mono_n != want:
        raise PhaseFailed(f"hybrid cut: {rec}, want launches {want}")
    return rec


def phase_edge(torch, np, ops, smi: str) -> dict:
    torch.cuda.empty_cache()
    out = {"cnn": {k: cnn_graph(torch, np, k, smi) for k in CNN_GRAPHS},
           "paper_rows": paper_rows(torch),
           "llm": llm_partitioned(torch, np, ops, smi),
           "hybrid": hybrid_partitioned(torch, np, ops)}
    say("[7/16] Edge-PRUNE on the card: the paper's CNNs at the paper's sizes "
        "within the CPU limit, every partition point equal to the "
        "Simulator bit for bit, the modeled Fig 4-6 rows the reference's; "
        "qwen2-1.5b and recurrentgemma-9b actor graphs partitioned equal "
        "to forward bit for bit, launches exact")
    return out


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

# hierarchical serving: qwen2-1.5b on both tiers (one model object), an
# endpoint of 1 slot with a step_delay_s handicap and a server of 8 slots,
# both slotted at phase 4's max_len, fed one open-loop Poisson trace
ESC_N = 16
ESC_LENS = (128, 256, 384, 512)
ESC_NEW = 16
ESC_DELAY_A = 0.05      # (a): the delay each step must add past its work
# the endpoint's handicap, the arrival rate and the deadline, from the
# step measured in (a): an endpoint a quarter slower a step than the
# server (the tiers' capacity gap is mostly 1 slot against 8), arrivals
# at the rate the endpoint alone can serve (so its queue grows without
# bound in ``never``), and a deadline of 3 endpoint service times, which
# falls between the modes as this phase measures them on an H100
# (``never`` 5, gated 12 and ``always`` 16 of 16 within it; PERF.md)
ESC_HANDICAP = 0.25     # the endpoint's delay: this share of its step
ESC_LOAD = 1.0          # arrivals per endpoint service time
ESC_DEADLINE = 3.0      # the deadline, in endpoint service times
ESC_TIMEOUT_S = 300
LINK_N = 8              # (c): requests in flight across the link cut
LINK_DOWN_S = 2.0
LINK_WINDOW_S = 10.0    # the journal must drain this soon after revival
FO_S = 512              # (e): the failover's actor graph, as phase 7's
FO_FRAMES = 8
FO_CHECKPOINT = 4
FO_FAIL_FRAC = 0.4      # the server dies at this share of the nominal run
SIM_FRAMES = 4
SLOT_FAIL_STEP = 4


def esc_prompts(cfg, np) -> list:
    """ESC_N prompts of 128, 256, 384 and 512 tokens in turn (seed 7)."""
    rng = np.random.RandomState(7)
    return [rng.randint(0, cfg.vocab_size, ESC_LENS[i % len(ESC_LENS)])
            .astype(np.int32) for i in range(ESC_N)]


def esc_arrivals(np, rate: float) -> list:
    """Poisson arrival instants at ``rate`` per second (seed 8)."""
    return list(np.cumsum(np.random.RandomState(8).exponential(
        1.0, ESC_N) / rate))


def esc_engine(cfg, model, slots: int, delay_s: float = 0.0, *,
               failures=None, **kw):
    from repro_torch.runtime.engine import Engine, EngineConfig
    return Engine(cfg, model, EngineConfig(
        max_slots=slots, max_len=SERVE_S, step_delay_s=delay_s, **kw),
        failures=failures, device="cuda")


def solo_tokens(cfg, model, prompts, slots: int) -> list:
    """Each prompt alone through a caller-pumped engine of ``slots``
    slots: the tokens the tier answers it with when nothing else runs."""
    from repro_torch.runtime.scheduler import Request
    eng = esc_engine(cfg, model, slots)
    return [eng.submit(Request(i, p, max_new_tokens=ESC_NEW)).result().tokens
            for i, p in enumerate(prompts)]


def timed_steps(torch, eng, req) -> tuple:
    """Pump ``req`` alone through a caller-pumped engine one step at a
    time; returns its completion, the wall time of each (non-idle) step,
    the time of each step's model work (the scheduler's ``_step_work``,
    which ends once the step's tokens are on the host; a step's
    ``step_delay_s`` sleep and its delivery come after it) and the
    engine's decode steps."""
    sched = eng.scheduler
    step_work, work = sched._step_work, []

    def timed_work():
        t0 = time.perf_counter()
        out = step_work()
        work.append(time.perf_counter() - t0)
        return out
    sched._step_work = timed_work
    handle = eng.submit(req)
    times, works = [], []
    try:
        while not handle.done:
            n = len(work)
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            works.append(sum(work[n:]))
    finally:
        del sched._step_work
    return handle.completion, times, works, eng.stats()["steps"]


def step_delay_check(torch, cfg, model, prompt) -> dict:
    """(a) One request through a 1-slot engine, after a warm-up: twice
    without a delay and once with ``ESC_DELAY_A``. The tokens and steps
    are the same, and every step of the delayed run outlasts its own
    model work by at least the delay, so the run is longer than its
    model work by at least steps x delay. The model work is what varies
    between identical runs here (host-bound dispatch; the undelayed
    runs' walls have differed by up to 0.4 s, against steps x delay of
    0.75 s), so it is timed in each step and set aside rather than
    taken from another run; the plain wall growth is reported."""
    from repro_torch.runtime.scheduler import Request
    runs = []
    for delay in (0.0, 0.0, 0.0, ESC_DELAY_A):
        eng = esc_engine(cfg, model, 1, delay)
        runs.append(timed_steps(torch, eng, Request(
            0, prompt, max_new_tokens=ESC_NEW)))
    (c0, t0, k0, steps), (c1, t1, k1, _), (cd, td, kd, steps_d) = runs[1:]
    w0, w1, wd = sum(t0), sum(t1), sum(td)
    # each step's wall past its model work: the sleep, the delivery and
    # the loop around them
    rest = [t - k for t, k in zip(td, kd)]
    rest_u = [sum(t) - sum(k) for t, k in ((t0, k0), (t1, k1))]
    rec = {"steps": steps, "engine_steps": len(t0), "wall_s": [w0, w1],
           "delayed_wall_s": wd, "delay_s": ESC_DELAY_A,
           "growth_s": wd - (w0 + w1) / 2, "spread_s": abs(w1 - w0),
           "work_s": [sum(k0), sum(k1)], "delayed_work_s": sum(kd),
           "rest_s": rest_u, "delayed_rest_s": sum(rest),
           "step_s": (w0 + w1) / 2 / len(t0),
           "warmup_wall_s": sum(runs[0][1]),
           "shortest_delayed_step_s": min(td),
           "shortest_delayed_rest_s": min(rest)}
    say(f"  (a) step_delay_s={ESC_DELAY_A}: {len(t0)} engine steps "
        f"({steps} decode), wall {w0:.4f} / {w1:.4f} s undelayed (model "
        f"work {sum(k0):.4f} / {sum(k1):.4f} s; warm-up "
        f"{rec['warmup_wall_s']:.4f} s), {wd:.4f} s delayed (model work "
        f"{sum(kd):.4f} s): past the model work {sum(rest):.4f} s delayed "
        f"against {rest_u[0]:.4f} / {rest_u[1]:.4f} s undelayed and "
        f"steps x delay {len(td) * ESC_DELAY_A:.4f} s, shortest step past "
        f"its work {min(rest) * 1e3:.2f} ms; plain wall growth "
        f"{rec['growth_s']:.4f} s; tokens equal "
        f"{c0.tokens == c1.tokens == cd.tokens}")
    if not c0.tokens == c1.tokens == cd.tokens or steps_d != steps \
            or len(td) != len(t0) or len(c0.tokens) != ESC_NEW:
        raise PhaseFailed(f"step_delay_s changed the tokens or the steps: "
                          f"{steps} vs {steps_d}")
    if min(rest) < ESC_DELAY_A:
        raise PhaseFailed(f"step_delay_s: a delayed step outlasted its "
                          f"model work by {min(rest):.4f} s, for a delay "
                          f"of {ESC_DELAY_A} s ({len(td)} steps, "
                          f"{sum(rest):.4f} s in all)")
    return rec


class EscLaunches:
    """The kernels' launches, the model's prefill/extend calls and both
    tiers' admissions and decode steps over one run: set to 0 (or read)
    just before it and read just after it, once both engines are idle.
    Flash must launch 28 times per prefill call (both engines' and the
    confidence probes'), the layout's decode kernel 28 times per decode
    step of either engine, the other decode kernel not at all."""

    def __init__(self, torch, ops, calls, engines, label: str):
        from repro_torch.kernels import _build
        self.torch, self.ops, self.calls = torch, ops, calls
        self.engines, self.label = engines, label
        _build.reset_launches(*(ops[k] for k in KERNELS))
        calls.take()
        self.base = [e.stats() for e in engines]

    def check(self, probes: int = 0) -> dict:
        for e in self.engines:
            e.snapshot()                # under each engine's lock: idle
        self.torch.cuda.synchronize()
        launches = {k: self.ops[k].launches for k in KERNELS}
        n_calls = self.calls.take()
        delta = [{k: e.stats()[k] - b[k] for k in ("admissions", "steps")}
                 for e, b in zip(self.engines, self.base)]
        n = self.engines[0].cfg.n_layers
        steps = {"slotted": 0, "paged": 0}
        for e, d in zip(self.engines, delta):
            steps[e.config.kv_layout] += d["steps"]
        want = {"flash_attention": n * sum(n_calls.values()),
                "decode_attention": n * steps["slotted"],
                "paged_decode_attention": n * steps["paged"]}
        prefills = sum(d["admissions"] for d in delta) + probes
        if launches != want or n_calls["prefill"] != prefills \
                or n_calls["prefill_extend"]:
            raise PhaseFailed(f"{self.label}: launches {launches}, want "
                              f"{want}; calls {n_calls}, want {prefills} "
                              f"prefills ({delta} admissions and steps, "
                              f"{probes} probes)")
        return {"launches": launches, "calls": n_calls, "engines": delta,
                "probes": probes}


def make_tiered(cfg, model, policies, root: str, delay_s: float, *,
                wrap=None, server=None):
    """The reference bench's wiring: an endpoint of 1 slot with the
    handicap and observability, a background-drained server of 8 slots
    behind ``InProcessTransport`` (or ``server``, a transport), replay
    window = the server's slots, twice that sends per pump round."""
    from repro_torch.runtime.escalation import (InProcessTransport,
                                                TieredConfig, TieredEngine)
    endpoint = esc_engine(cfg, model, 1, delay_s, observability=True)
    engine = None
    if server is None:
        engine = esc_engine(cfg, model, 8).start()
        server = InProcessTransport(engine, timeout_s=ESC_TIMEOUT_S)
    transport = wrap(server) if wrap is not None else server
    tiered = TieredEngine(endpoint, transport, TieredConfig(
        policies=policies, journal_dir=root, replay_window=8,
        max_sends_per_pump=16))
    return tiered, engine


def timed_probes(tiered) -> list:
    """Wrap the tiered engine's confidence probe: each call's wall time
    on the caller's thread lands in the returned list."""
    fn, times = tiered._confidence, []

    def probe(req):
        t0 = time.perf_counter()
        v = fn(req)
        times.append(time.perf_counter() - t0)
        return v
    tiered._confidence = probe
    return times


def drive_trace(tiered, prompts, arrivals, deadline_s) -> list:
    """Submit the trace open-loop on its arrival schedule, each handle
    waited on by a thread of its own from its submission on, so each
    latency ends when its request completes. Returns (handle, latency_s,
    submit_s) triples."""
    from repro_torch.runtime.scheduler import Request
    n = len(prompts)
    sent, done, threads = [None] * n, [None] * n, []

    def wait(i):
        sent[i][0].result(ESC_TIMEOUT_S)
        done[i] = time.perf_counter()
    t0 = time.perf_counter()
    for i, (prompt, at) in enumerate(zip(prompts, arrivals)):
        delay = t0 + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        ts = time.perf_counter()
        h = tiered.submit(Request(i, prompt, max_new_tokens=ESC_NEW,
                                  deadline_s=deadline_s))
        sent[i] = (h, ts, time.perf_counter() - ts)
        threads.append(threading.Thread(target=wait, args=(i,), daemon=True))
        threads[-1].start()
    for t in threads:
        t.join(timeout=ESC_TIMEOUT_S)
    if None in done:
        raise PhaseFailed("tiered serving: a request did not complete")
    return [(h, d - ts, sub) for (h, ts, sub), d in zip(sent, done)]


def tiered_mode(torch, np, ops, calls, cfg, model, name, policies, prompts,
                arrivals, deadline_s, delay_s, solo, root) -> dict:
    """(b) One mode over the trace: warm both tiers directly, count over
    the drive, then hold every request to the solo run of the tier that
    answered it and the counters to the handles."""
    from repro_torch.runtime.observability import parse_prometheus
    from repro_torch.runtime.policies import ConfidenceEscalation
    from repro_torch.runtime.scheduler import Request
    tiered, server = make_tiered(cfg, model, policies, f"{root}/{name}",
                                 delay_s)
    tiered.start()
    try:
        warm = np.ones(8, np.int32)
        tiered.local.submit(Request(-1, warm, max_new_tokens=2)).result(
            ESC_TIMEOUT_S)
        server.submit(Request(-2, warm, max_new_tokens=2)).result(
            ESC_TIMEOUT_S)
        rec = {"policies": [p.name for p in tiered.policies]}
        gate = [p for p in tiered.policies
                if isinstance(p, ConfidenceEscalation)]
        if gate:
            # the threshold: the median of the port's probe over the
            # trace, as the reference bench calibrates it
            t0 = time.perf_counter()
            confs = sorted(tiered._confidence(Request(-3, p))
                           for p in prompts)
            rec["calibration_s"] = time.perf_counter() - t0
            gate[0].threshold = confs[len(confs) // 2]
            rec["threshold"] = gate[0].threshold
            rec["confidence_range"] = [confs[0], confs[-1]]
        probe_s = timed_probes(tiered)
        tiered.local.obs.registry.reset_histograms()
        run = EscLaunches(torch, ops, calls, [tiered.local, server], name)
        t0 = time.perf_counter()
        got = drive_trace(tiered, prompts, arrivals, deadline_s)
        rec["wall_s"] = time.perf_counter() - t0
        rec.update(run.check(probes=len(probe_s)))
        metrics = parse_prometheus(tiered.metrics_text())
    finally:
        tiered.shutdown()
        server.shutdown()
    tiers, lat, in_deadline, rows = [], [], 0, []
    for i, (h, latency, submit_s) in enumerate(got):
        c = h.completion
        tier = "endpoint" if h.tier == tiered.config.tier else "server"
        tiers.append(tier)
        lat.append(latency)
        if c.finish_reason != "length" or len(c.tokens) != ESC_NEW:
            raise PhaseFailed(f"{name}: request {i} ended "
                              f"{c.finish_reason} with {len(c.tokens)} "
                              f"tokens")
        if c.tokens != solo[tier][i]:
            raise PhaseFailed(f"{name}: request {i}'s tokens differ from "
                              f"the {tier} tier's alone")
        in_deadline += latency <= deadline_s
        rows.append({"arrival_s": arrivals[i], "tier": tier,
                     "reason": h.reason, "latency_s": latency,
                     "submit_ms": submit_s * 1e3})
    escalated = tiers.count("server")
    if metrics["counters"]["repro_escalated_total"] != escalated \
            or sum(h.escalated for h, _, _ in got) != escalated:
        raise PhaseFailed(f"{name}: repro_escalated_total "
                          f"{metrics['counters']['repro_escalated_total']}, "
                          f"{escalated} answered by the server")
    lat_sorted = sorted(lat)
    rec.update({
        "answered_within_deadline": in_deadline,
        "escalated": escalated, "escalated_fraction": escalated / len(got),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "latency_max_s": lat_sorted[-1],
        "submit_p50_ms": float(np.percentile([s for _, _, s in got], 50))
        * 1e3,
        "probe_ms": [t * 1e3 for t in probe_s], "requests": rows})
    say(f"  (b) {name:16s}: in deadline {in_deadline}/{len(got)}, escalated "
        f"{escalated}/{len(got)}, latency p50 {rec['latency_p50_s']:.3f} s "
        f"p99 {rec['latency_p99_s']:.3f} s, wall {rec['wall_s']:.2f} s; "
        f"calls {rec['calls']}, launches {rec['launches']}"
        + (f"; probe p50 {float(np.percentile(probe_s, 50)) * 1e3:.2f} ms "
           f"on the caller's thread ({rec['calibration_s'] / ESC_N * 1e3:.2f}"
           f" ms with the engines idle), threshold {rec['threshold']:.6g}"
           if probe_s else ""))
    say(f"      by request (tier, latency s): " + " ".join(
        f"{r['tier'][0].upper()}{r['latency_s']:.2f}"
        + ("" if r["latency_s"] <= deadline_s else "*") for r in rows)
        + " (* past the deadline)")
    return rec


def link_cut(torch, np, cfg, model, prompts, solo, root, delay_s) -> dict:
    """(c) Deadline-free ``always`` requests journaled across a link cut
    (``FlakyTransport`` over a ``FailureTrace`` scheduled after warm-up),
    plus a deadline-tight request handed to the endpoint while the link
    is down (not held for the revival) and answered there as
    ``local_fallback``, and an expired one shed, then the revival:
    nothing lost, each completion surfaced once in journal order with
    the server's tokens alone. When the tight request is handed over is
    gated; when it finishes is reported (it takes one endpoint service
    time, 0.8-1.3 s, and the link is down 2 s)."""
    from repro_torch.runtime.escalation import FlakyTransport
    from repro_torch.runtime.observability import parse_prometheus
    from repro_torch.runtime.resilience import FailureTrace
    from repro_torch.runtime.scheduler import Request
    cut = FailureTrace()
    tiered, server = make_tiered(cfg, model, ("always",), f"{root}/linkcut",
                                 delay_s,
                                 wrap=lambda t: FlakyTransport(t, cut))
    surfaced = []
    deliver = tiered.replayer.on_complete

    def on_complete(entry, c):
        surfaced.append(entry.seq)
        deliver(entry, c)
    tiered.replayer.on_complete = on_complete
    routed, submit_local = {}, tiered._submit_local

    def on_local(handle, *, fallback):
        if fallback:        # when a journaled request goes to the endpoint
            routed[handle.request.id] = tiered.now()
        submit_local(handle, fallback=fallback)
    tiered._submit_local = on_local
    tiered.start()
    try:
        warm = tiered.submit(Request(-1, np.ones(8, np.int32),
                                     max_new_tokens=2))
        warm.result(ESC_TIMEOUT_S)
        kill_at = tiered.now() + 0.2
        revive_at = kill_at + LINK_DOWN_S
        cut.kill_link("endpoint", "server", at=kill_at) \
           .revive_link("endpoint", "server", at=revive_at)
        while tiered.now() < kill_at:
            time.sleep(0.005)
        hs = [tiered.submit(Request(i, prompts[i], max_new_tokens=ESC_NEW))
              for i in range(LINK_N)]
        stranded = tiered.journal.depth
        slack = tiered.config.fallback_slack_s
        tight = tiered.submit(Request(100, prompts[0], max_new_tokens=ESC_NEW,
                                      deadline_s=0.8 * slack))
        expired = tiered.submit(
            Request(101, prompts[1], max_new_tokens=ESC_NEW,
                    deadline_s=0.5), arrival_s=tiered.now() - 1.0)
        c_exp = expired.result(ESC_TIMEOUT_S)
        c_tight = tight.result(ESC_TIMEOUT_S)
        tight_done = tiered.now()
        tight_routed = routed.get(100, math.inf)
        during = tight_routed < revive_at
        results = [h.result(ESC_TIMEOUT_S + LINK_WINDOW_S) for h in hs]
        drained_at = tiered.now()
        stats = tiered.escalation_stats()
        metrics = parse_prometheus(tiered.metrics_text())
    finally:
        tiered.shutdown()
        server.shutdown()
    rec = {"requests": LINK_N, "stranded": stranded,
           "recovery_s": max(drained_at - revive_at, 0.0),
           "window_s": LINK_WINDOW_S, "down_s": LINK_DOWN_S,
           "failback_total": metrics["counters"]["repro_failback_total"],
           "stats": stats, "surfaced": surfaced,
           "tight": c_tight.finish_reason, "expired": c_exp.finish_reason,
           "tight_routed_s": tight_routed - kill_at,
           "tight_done_s": tight_done - kill_at}
    lost = [i for i, c in enumerate(results) if c.finish_reason != "length"]
    want_order = [warm.seq] + [h.seq for h in hs]
    say(f"  (c) link cut for {LINK_DOWN_S} s: {stranded} journaled, "
        f"{len(lost)} lost, surfaced in journal order "
        f"{surfaced == want_order}, recovery {rec['recovery_s']:.3f} s "
        f"(window {LINK_WINDOW_S} s), failbacks {rec['failback_total']:g}; "
        f"tight deadline -> {c_tight.finish_reason} (handed to the endpoint "
        f"{rec['tight_routed_s']:.3f} s into the outage, before the revival:"
        f" {during}; answered {rec['tight_done_s']:.3f} s in), expired -> "
        f"{c_exp.finish_reason}")
    if lost or stranded != LINK_N or surfaced != want_order:
        raise PhaseFailed(f"link cut: lost {lost}, {stranded} journaled, "
                          f"surfaced {surfaced}, want {want_order}")
    if any(c.tokens != solo["server"][i] for i, c in enumerate(results)) \
            or any(h.tier != "server" for h in hs):
        raise PhaseFailed("link cut: a replayed request's tokens differ "
                          "from the server's alone")
    if rec["failback_total"] != 1 or rec["recovery_s"] > LINK_WINDOW_S \
            or stats["queue_depth"] or not stats["link_up"]:
        raise PhaseFailed(f"link cut: {rec}")
    if c_tight.finish_reason != "local_fallback" or not during \
            or c_tight.tokens != solo["endpoint"][0] \
            or c_exp.finish_reason != "timeout" or c_exp.tokens:
        raise PhaseFailed(f"link cut: the tight request ended "
                          f"{c_tight.finish_reason} (handed to the endpoint "
                          f"{rec['tight_routed_s']:.3f} s into the "
                          f"{LINK_DOWN_S} s outage), the expired one "
                          f"{c_exp.finish_reason}")
    return rec


def over_http(torch, np, ops, calls, cfg, model, prompts, solo, root,
              delay_s) -> dict:
    """(d) The server tier behind ``EngineServer`` on 127.0.0.1
    (ephemeral port) on phase 6's paged pool, a ``TieredEngine`` with
    ``HttpTransport`` and ``always`` sending the trace, and a second
    ``EngineServer`` fronting the tiered engine for ``/status``."""
    from repro_torch.runtime.escalation import HttpTransport
    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.server import EngineServer, ServerConfig
    srv_eng = esc_engine(cfg, model, 8, kv_layout="paged", block_size=BS,
                         num_blocks=PARITY_BLOCKS)
    srv = EngineServer(srv_eng, ServerConfig(port=0, max_inflight=32)).start()
    front = None
    try:
        tiered, _ = make_tiered(
            cfg, model, ("always",), f"{root}/http", delay_s,
            server=HttpTransport(srv.url, timeout_s=ESC_TIMEOUT_S))
        front = EngineServer(tiered, ServerConfig(port=0)).start()
        run = EscLaunches(torch, ops, calls, [tiered.local, srv_eng],
                          "over HTTP")
        t0 = time.perf_counter()
        hs = [tiered.submit(Request(i, p, max_new_tokens=ESC_NEW))
              for i, p in enumerate(prompts)]
        results = [h.result(ESC_TIMEOUT_S) for h in hs]
        wall = time.perf_counter() - t0
        rec = run.check()
        st = json.loads(get(front.port, "/status"))
        st_srv = json.loads(get(srv.port, "/status"))
    finally:
        if front is not None:
            front.close()
        srv.close()
    rec.update({"wall_s": wall, "tier": st["tier"],
                "escalation": st["escalation"],
                "escalations_received": st_srv["escalations_received"]})
    agree_b = sum(c.tokens == solo["server"][i]
                  for i, c in enumerate(results)) / len(results)
    say(f"  (d) over HTTP (paged pool behind EngineServer): {len(hs)} "
        f"requests in {wall:.3f} s, tokens equal (b)'s server answers on "
        f"{agree_b:.3f}; /status tier {st['tier']!r}, escalated "
        f"{st['escalation']['escalated']}, received "
        f"{st_srv['escalations_received']}; launches {rec['launches']}")
    if any(c.finish_reason != "length" for c in results) or agree_b != 1.0 \
            or any(h.tier != "server" for h in hs):
        raise PhaseFailed(f"over HTTP: tokens equal (b)'s server answers "
                          f"on {agree_b:.3f}")
    if st["tier"] != "endpoint" \
            or st["escalation"]["escalated"] < len(hs) \
            or st["escalation"]["queue_depth"] \
            or st_srv["escalations_received"] < len(hs):
        raise PhaseFailed(f"over HTTP: /status {st['tier']} "
                          f"{st['escalation']}, server received "
                          f"{st_srv['escalations_received']}")
    if not rec["launches"]["paged_decode_attention"]:
        raise PhaseFailed("over HTTP: no paged decode launch")
    return rec


def failover(torch, np, ops, cfg, model, prompts, smi: str) -> dict:
    """(e) qwen2-1.5b's actor graph at full width (B = 1, S = 512, two
    layers an actor) on the N270 platform with Ethernet, served by
    ``FailoverController`` over ``Explorer.rank_fallbacks``: 8 frames, 4
    checkpointed, the server killed mid-stream; then the Simulator's kill
    and revival on the same graph, and a ``SlotFailure`` mid-decode in
    the server engine."""
    from repro_torch.core import (Explorer, Mapping, PlatformModel,
                                  Simulator, paper_platform)
    from repro_torch.models import transformer as T
    from repro_torch.runtime.resilience import (FailoverController,
                                                FailureTrace,
                                                HeartbeatConfig)
    from repro_torch.runtime.scheduler import Request, SlotFailure
    rng = np.random.RandomState(9)
    tokens = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, FO_S))
                              .astype(np.int32), device="cuda")
              for _ in range(FO_FRAMES)]
    frames = [{"Input": t} for t in tokens]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    g = T.to_actor_graph(cfg, model, batch=1, seq=FO_S, group_size=2)
    pg = paper_platform("N270", "ethernet")
    pm = PlatformModel(pg)
    ranked = Explorer(g, pg).rank_fallbacks()
    primary = next(m for m in ranked if len(m.units_used()) == 2)

    def controller(hb=None):
        return FailoverController(g, primary, ranked, platform=pm,
                                  heartbeat=hb,
                                  checkpoint_frames=FO_CHECKPOINT)
    with torch.no_grad():
        ref = [T.forward(model, cfg, {"tokens": t}, train=False)[0]
               for t in tokens]
    edge_reset(ops)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nominal, nom = controller().serve(frames)
    torch.cuda.synchronize()
    nom_wall = time.perf_counter() - t0
    nom_launches = edge_counts(ops)
    peak_nominal = torch.cuda.max_memory_allocated()
    gap = nom.makespan_s / FO_FRAMES
    hb = HeartbeatConfig(interval_s=gap / 2, timeout_s=gap)
    trace = FailureTrace().kill_unit("server",
                                     at=FO_FAIL_FRAC * nom.makespan_s)
    ctl = controller(hb)
    edge_reset(ops)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, rep = ctl.serve(frames, failures=trace)
    torch.cuda.synchronize()
    fail_wall = time.perf_counter() - t0
    fail_launches = edge_counts(ops)
    peak_failover = torch.cuda.max_memory_allocated()
    fired = FO_FRAMES + len(rep.frames_replayed)
    equal = [o is not None and torch.equal(o["Head"], n["Head"])
             and torch.equal(o["Head"], r)
             for o, n, r in zip(outs, nominal, ref)]
    ev = rep.events[0] if rep.events else None
    n = cfg.n_layers
    rec = {"actors": len(g.actors), "primary": primary.name,
           "mapping_history": rep.mapping_history,
           "frames_replayed": rep.frames_replayed,
           "frames_unserved": rep.frames_unserved, "equal": equal,
           "launches": {"nominal": nom_launches, "failover": fail_launches},
           "fired": fired, "nominal_wall_s": nom_wall,
           "failover_wall_s": fail_wall,
           "frame_wall_ms": fail_wall / fired * 1e3,
           "detection_ms": (ev.t_detect_s - ev.t_fail_s) * 1e3 if ev else None,
           "resynthesis_ms": ev.resynth_s * 1e3 if ev else None,
           "recovery_ms": rep.recovery_latency_s * 1e3,
           "modeled_makespan_s": {"nominal": nom.makespan_s,
                                  "failover": rep.makespan_s},
           "memory_gb": {"before_graph": mem0 / 1e9,
                         "peak_nominal": peak_nominal / 1e9,
                         "peak_failover": peak_failover / 1e9}}
    _, rec["frame"] = timed_frame(
        torch, lambda: ctl.program.run_local(frames[0]),
        f"a frame on the fallback mapping {ctl.mapping.name}")
    say(f"  (e) failover: {len(g.actors)} actors, {primary.name} -> "
        f"{' -> '.join(rep.mapping_history[1:])}; {fired} frames fired "
        f"({len(rep.frames_replayed)} replayed: {rep.frames_replayed}), "
        f"every frame equal to the failure-free run's and forward's: "
        f"{all(equal)}; recovery {rec['recovery_ms']:.3f} ms = detection "
        f"{rec['detection_ms']:.3f} ms (modeled) + re-synthesis "
        f"{rec['resynthesis_ms']:.3f} ms (wall); {rec['frame_wall_ms']:.2f} "
        f"ms a frame fired (wall), fallback frame busy "
        f"{rec['frame']['trace']['device_busy_s'] * 1e3:.3f} ms, idle share "
        f"{rec['frame']['trace']['idle_share']:.4f}; launches {fail_launches};"
        f" peak memory {peak_nominal / 1e9:.3f} / {peak_failover / 1e9:.3f}"
        f" GB (nominal / failover; {mem0 / 1e9:.3f} GB before the graph) "
        f"({smi})")
    want = {k: 0 for k in EDGE_KERNELS}
    if rep.num_failovers < 1 or rep.exhausted or rep.frames_unserved \
            or not rep.frames_replayed or "server" in ctl.mapping.units_used() \
            or not all(equal):
        raise PhaseFailed(f"failover: {rec}")
    if nom_launches != dict(want, flash_attention=n * FO_FRAMES) \
            or fail_launches != dict(want, flash_attention=n * fired):
        raise PhaseFailed(f"failover launches {nom_launches} / "
                          f"{fail_launches}, want 28 x {FO_FRAMES} / "
                          f"28 x {fired}")
    # the Simulator kills and revives the server on the same graph
    names = list(g.actors)
    half = Mapping("half", {a: ("endpoint" if i < len(names) // 2
                                else "server")
                            for i, a in enumerate(names)}, pg)
    feed = {"Input": tokens[:SIM_FRAMES]}
    sim_nom = Simulator(g, mapping=half, platform=pm).run(
        SIM_FRAMES, source_inputs=feed)
    sv = [f for f in sim_nom.firings if f.unit == "server"]
    sim_trace = FailureTrace().kill_unit(
        "server", at=(sv[0].start_s + sv[-1].finish_s) / 2) \
        .revive_unit("server", at=sv[-1].finish_s)
    sim = Simulator(g, mapping=half, platform=pm).run(
        SIM_FRAMES, source_inputs=feed, failures=sim_trace)
    sim_equal = len(sim.outputs["Head"]) == SIM_FRAMES and all(
        torch.equal(a, b) for a, b in zip(sim_nom.outputs["Head"],
                                          sim.outputs["Head"]))
    rec["simulator"] = {"frames_replayed": sim.frames_replayed,
                        "frames_lost": sim.frames_lost, "equal": sim_equal,
                        "downtime_overhead": sim.modeled_makespan_s
                        / sim_nom.modeled_makespan_s}
    # one SlotFailure mid-decode: the server engine re-queues and decodes
    # the failure-free run's tokens
    reqs = [Request(i, p, max_new_tokens=ESC_NEW)
            for i, p in enumerate(prompts[:8])]
    clean = esc_engine(cfg, model, 8).generate(reqs)
    failing = esc_engine(cfg, model, 8, failures=[
        SlotFailure(step=SLOT_FAIL_STEP, slots=None)])
    hit = failing.generate(reqs)
    fails = [e for e in failing.scheduler.events if e.kind == "fail"]
    rec["slot_failure"] = {"requeued": len(fails),
                           "equal": [a.tokens == b.tokens
                                     for a, b in zip(clean, hit)]}
    say(f"  (e) Simulator kill + revival: {len(sim.frames_replayed)} frames "
        f"re-fired, {len(sim.frames_lost)} lost, outputs equal bit for bit "
        f"{sim_equal}, modeled downtime x"
        f"{rec['simulator']['downtime_overhead']:.4f}; SlotFailure at step "
        f"{SLOT_FAIL_STEP}: {len(fails)} requests re-queued, tokens equal "
        f"the failure-free run's {all(rec['slot_failure']['equal'])}")
    if not sim.frames_replayed or sim.frames_lost or not sim_equal:
        raise PhaseFailed(f"simulator kill + revival: {rec['simulator']}")
    if not fails or not all(rec["slot_failure"]["equal"]):
        raise PhaseFailed(f"SlotFailure: {rec['slot_failure']}")
    return rec


def phase_tiered(torch, np, ops, smi: str) -> dict:
    """qwen2-1.5b at full width and depth in bf16 on both tiers of
    hierarchical serving (one model object), then the failover; see the
    module docstring for (a)-(e)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.runtime.policies import (ConfidenceEscalation,
                                              LocalOverloadEscalation)
    torch.cuda.empty_cache()
    model = T.init_params(get_config("qwen2_1_5b"), 0, device="cuda")
    cfg = model.cfg
    prompts = esc_prompts(cfg, np)
    out = {}
    calls = Calls(T)
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as root:
            out["step_delay"] = a = step_delay_check(torch, cfg, model,
                                                     prompts[0])
            t0 = time.perf_counter()
            solo = {"endpoint": solo_tokens(cfg, model, prompts, 1),
                    "server": solo_tokens(cfg, model, prompts, 8)}
            out["solo_s"] = time.perf_counter() - t0
            out["cross_tier_agreement"] = sum(
                a_ == b_ for a_, b_ in zip(solo["endpoint"], solo["server"])
            ) / ESC_N
            # the handicap, rate and deadline from the measured step
            delay = round(ESC_HANDICAP * a["step_s"], 4)
            service = sum(a["wall_s"]) / 2 + a["engine_steps"] * delay
            rate, deadline = ESC_LOAD / service, ESC_DEADLINE * service
            arrivals = esc_arrivals(np, rate)
            out["choice"] = {"step_s": a["step_s"], "delay_s": delay,
                             "service_s": service, "rate_per_s": rate,
                             "deadline_s": deadline}
            say(f"  (b) measured step {a['step_s'] * 1e3:.2f} ms -> endpoint "
                f"handicap {delay * 1e3:.1f} ms a step, service "
                f"{service:.3f} s a request, Poisson rate {rate:.3f}/s, "
                f"deadline {deadline:.3f} s; cross-tier agreement (1 vs 8 "
                f"slots, each alone) {out['cross_tier_agreement']:.3f}")
            modes = {"never": ("never",), "always": ("always",),
                     "gated": (ConfidenceEscalation(1.0),
                               LocalOverloadEscalation(max_queue_depth=1))}
            out["modes"] = {
                name: tiered_mode(torch, np, ops, calls, cfg, model, name,
                                  pol, prompts, arrivals, deadline, delay,
                                  solo, root)
                for name, pol in modes.items()}
            never, gated = out["modes"]["never"], out["modes"]["gated"]
            if never["escalated"] or out["modes"]["always"]["escalated"] \
                    != ESC_N or not 0 < gated["escalated"] < ESC_N \
                    or (gated["answered_within_deadline"]
                        <= never["answered_within_deadline"]
                        and gated["answered_within_deadline"] < ESC_N):
                raise PhaseFailed(
                    f"tiered serving: gated {gated['answered_within_deadline']}"
                    f" in deadline with {gated['escalated']} escalated, never "
                    f"{never['answered_within_deadline']}")
            out["link_cut"] = link_cut(torch, np, cfg, model, prompts, solo,
                                       root, delay)
            out["http"] = over_http(torch, np, ops, calls, cfg, model,
                                    prompts, solo, root, delay)
        out["failover"] = failover(torch, np, ops, cfg, model, prompts, smi)
    finally:
        calls.restore()
    out["phase_s"] = time.perf_counter() - t_phase
    del model
    torch.cuda.empty_cache()
    say(f"  {smi}; phase 8 took {out['phase_s']:.1f} s")
    say("[8/16] hierarchical serving of qwen2-1.5b on the card: step_delay_s "
        "content-neutral, the gated tier beats the endpoint alone, every "
        "request equal to its tier alone, nothing lost across a link cut, "
        "the server over HTTP, failover frames equal to forward; launches "
        "exact")
    return out


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

GOLDEN_HYBRID = SRC / "repro_torch" / "testdata" / "golden_hybrid.npz"
# gemma3-1b: 16 requests of 1,024-token prompts, past the window of 512,
# so every local ring wraps inside the prefill; 8 new tokens, 8 slots
# (the serve CLI's max_len: G3_RUN_S)
G3_NEW = 8
G3_RUN_S = 1024 + G3_NEW + 8
G3_ARGS = ["--arch", "gemma3_1b", "--no-smoke", "--slots", "8",
           "--requests", "16", "--prompt-len", "1024", "--max-new",
           str(G3_NEW), "--device", "cuda"]
G3_RUNS = {
    "fifo": ["--policy", "fifo"],
    "batch": ["--policy", "batch"],
    "paged": ["--policy", "fifo", "--paged", "--block-size", "16"],
    # outside supports_chunked_prefill: served one-shot, no sharing
    "paged-prefix": ["--policy", "fifo", "--prefix-cache", "--block-size",
                     "16"],
    "paged-chunked": ["--policy", "fifo", "--paged", "--block-size", "16",
                      "--prefill-chunk", "128"],
}
# recurrentgemma-9b: 14 prompts of 512 tokens and 2 of 2,080, whose
# rings of 2,048 wrap; 8 new tokens, 8 slots; fifo replays this trace
# through the CLI's --trace, batch serves the same requests
RG_LENS = [512] * 14 + [2080] * 2
RG_NEW = 8
RG_ARGS = ["--arch", "recurrentgemma_9b", "--no-smoke", "--slots", "8",
           "--device", "cuda"]
# llama3.2-3b and chatglm3-6b: one slotted fifo run each
DENSE_ARGS = ["--no-smoke", "--slots", "8", "--requests", "8",
              "--prompt-len", "256", "--max-new", "16", "--policy", "fifo",
              "--device", "cuda"]
DENSE_ARCHS = ("llama3_2_3b", "chatglm3_6b")
# each model against itself with the plain versions in place of the
# kernels: (batch, prompt length, decode steps)
HYBRID_VS_PLAIN = {"gemma3_1b": (8, 1024, 8),
                   "recurrentgemma_9b": (4, 2080, 8),
                   "llama3_2_3b": (8, 256, 2), "chatglm3_6b": (8, 256, 2)}
# recurrentgemma-9b's state in fp32 (``state_vs_plain``): 4 prompts of
# 1,040 tokens, 8 decode steps (the plain scans loop over the positions)
STATE_VS_PLAIN = (4, 1040, 8)
GOLDEN_HYBRID_TOL = 1e-4


class PlainVersions:
    """Inside ``with``: the plain PyTorch versions in the kernels' places
    (flash, slotted and paged decode where the layers look them up, the
    scan's forward where its autograd function does); ``scan`` in place
    of the plain scan for a control run."""

    def __init__(self, fa_ref, da_ref, scan_ref, scan=None):
        from repro_torch.kernels.rglru_scan import ops as scan_ops
        from repro_torch.models import layers as L
        self.slots = [(L, "flash_attention", fa_ref.attention_ref),
                      (L, "decode_attention", da_ref.decode_attention_ref),
                      (L, "paged_decode_attention",
                       da_ref.paged_decode_attention_ref),
                      (scan_ops, "rglru_scan_fwd",
                       scan or scan_ref.rglru_scan_seq_ref)]

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.slots]
        for mod, name, plain in self.slots:
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.slots, self.saved):
            setattr(mod, name, fn)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


# model_vs_plain's limit besides phase 4's 5e-2: a row's greedy choice
# may move only where the plain run's top-2 gap is within TIE_GAP of the
# largest logit (a tie; the moved rows' gaps read 0-0.0062 on the card).
# state_vs_plain's: recurrentgemma-9b's ``h`` at the end of the fp32
# runs within STATE_TOL of its largest magnitude, between the kernels'
# readings and the bf16-state control's (PERF.md, PR 19)
TIE_GAP = 1e-2
STATE_TOL = 2e-5


def scan_in(torch, dtype):
    """The plain scan with its inputs and its state rounded to ``dtype``
    at every step (output in fp32): a control run's scan, as a kernel
    that did not keep the RG-LRU state in fp32 would compute it."""
    def scan(a, b, h0):
        def rnd(t):
            return t.to(dtype).float()
        h, ys = rnd(h0), []
        for t in range(a.shape[1]):
            h = rnd(rnd(a[:, t]) * h + rnd(b[:, t]))
            ys.append(h)
        return torch.stack(ys, dim=1)
    return scan


def vs_plain_readings(torch, got, want) -> dict:
    """One run held against the plain-version run: ``got`` and ``want``
    are (the logits of every step, the cache at the end)."""
    (logits, cache), (wlogits, wcache) = got, want
    leaves = {}
    for g, w in zip(cache, wcache):
        for n in g:
            leaves[n] = max(leaves.get(n, 0.0), rel_err(g[n], w[n]))
    top2 = wlogits.topk(2, dim=-1).values
    gaps = ((top2[:, 0] - top2[:, 1]) / wlogits.abs().max()).tolist()
    moved = (logits.argmax(-1) != wlogits.argmax(-1)).nonzero()[:, 0].tolist()
    return {"logits_rel_err": rel_err(logits, wlogits),
            "argmax_agree": 1.0 - len(moved) / len(gaps),
            "moved_rows_gap": [gaps[i] for i in moved],
            "moved_outside_ties": sum(gaps[i] > TIE_GAP for i in moved),
            "median_gap": sorted(gaps)[len(gaps) // 2],
            "ring_rel_err": max(v for k, v in leaves.items() if k != "h"),
            "state_rel_err": leaves.get("h"), "leaves": leaves,
            "rows": len(gaps), "finite": bool(torch.isfinite(logits).all())}


def vs_plain_inputs(torch, cfg, batch: int, prompt_len: int, steps: int,
                    seed: int) -> tuple:
    """``batch`` random prompts of ``prompt_len`` tokens, the tokens fed
    to ``steps`` decode steps, and the cache length."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (steps, batch), generator=gen,
                        device="cuda")
    return tokens, fed, prompt_len + steps + 8


def drive_model(torch, model, tokens, fed, max_len: int,
                embeds=None) -> tuple:
    """Prefill ``tokens`` (with a frontend config's ``embeds``) and decode
    one step per row of ``fed``: (the logits of every step in fp32 over
    the unpadded vocabulary, the cache at the end)."""
    from repro_torch.models import transformer as T
    logits, cache, clen = T.prefill(model, tokens, max_len=max_len,
                                    embeds=embeds)
    out = [logits.float()]
    for tok in fed:
        logits, cache, clen = T.decode_step(model, tok, cache, clen)
        out.append(logits.float())
    # the vocabulary's padding (-1e30) is no logit to compare
    return torch.cat(out)[:, :model.cfg.vocab_size], cache


def model_vs_plain(torch, model, batch: int, prompt_len: int, steps: int,
                   fa_ref, da_ref, scan_ref, seed: int = 1,
                   embeds=None) -> dict:
    """Phase 4's ``vs_plain`` for any served config: the model run on the
    same inputs through the kernels, then with the plain versions in
    their place (flash, slotted and paged decode, the scan's forward).
    A batch of ``prompt_len``-token prompts is prefilled and decoded
    ``steps`` steps. Gates: the logits of every step within 5e-2 of
    their largest magnitude; a row's argmax equal unless the plain run's
    top-2 gap there is within ``TIE_GAP`` of the largest logit; the ring
    leaves (K/V, the conv's tail) within 5e-2 of their largest magnitude
    at the end of the runs. The RG-LRU state ``h`` is reported here and
    held by ``state_vs_plain`` in fp32: in bf16 over recurrentgemma-9b's
    38 layers it parts from the plain run by 3.6-5.9% of its largest
    magnitude, and by as much when the plain scan keeps its state in
    bf16 or even float8 (``tools/vs_plain_control.py``), so no limit on
    it tells a sound scan from a wrong one. A frontend config's prompts
    go with ``embeds`` (batch, F, frontend_dim)."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    tokens, fed, max_len = vs_plain_inputs(torch, cfg, batch, prompt_len,
                                           steps, seed)
    inputs = (tokens, fed, max_len + T.frontend_rows(cfg, embeds), embeds)
    got = drive_model(torch, model, *inputs)
    with PlainVersions(fa_ref, da_ref, scan_ref):
        want = drive_model(torch, model, *inputs)
    out = vs_plain_readings(torch, got, want)
    say(f"  {cfg.name} through the kernels vs plain ({batch} x "
        f"{prompt_len} prompts, {steps} decode steps): logits max |err| "
        f"{out['logits_rel_err']:.3g} of max |logit| (tol 5e-2); argmax "
        f"agrees on {out['argmax_agree']:.3f} of {out['rows']} rows, moved "
        f"rows' top-2 gaps {[float(f'{g:.3g}') for g in out['moved_rows_gap']]}"
        f" (a tie <= {TIE_GAP:g}; median gap {out['median_gap']:.3g}); "
        f"leaves at the end of the runs {_fmt(out['leaves'])} (ring leaves "
        f"tol 5e-2; h reported, held in fp32)")
    if not (out["finite"] and out["logits_rel_err"] <= 5e-2
            and not out["moved_outside_ties"] and out["ring_rel_err"] <= 5e-2):
        raise PhaseFailed(f"{cfg.name} through the kernels disagrees with "
                          f"its plain-version run")
    return out


def state_vs_plain(torch, arch: str, fa_ref, da_ref, scan_ref,
                   seed: int = 1) -> dict:
    """The RG-LRU state end to end: ``arch`` at full width and depth in
    fp32 (the serving CLI's weights), prefilled and decoded at
    ``STATE_VS_PLAIN``'s sizes through the kernels, through the plain
    versions, and through the plain versions with the scan keeping its
    inputs and state in bf16 (``scan_in``, the control). Gates: ``h`` at
    the end of the kernels' run within ``STATE_TOL`` of its largest
    magnitude, and the control's outside it; the logits and ring leaves
    are reported."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = T.init_params(cfg, 0, device="cuda")
    batch, prompt_len, steps = STATE_VS_PLAIN
    inputs = vs_plain_inputs(torch, cfg, batch, prompt_len, steps, seed)
    got = drive_model(torch, model, *inputs)
    with PlainVersions(fa_ref, da_ref, scan_ref):
        want = drive_model(torch, model, *inputs)
    with PlainVersions(fa_ref, da_ref, scan_ref,
                       scan=scan_in(torch, torch.bfloat16)):
        ctl = drive_model(torch, model, *inputs)
    del model
    free(torch)
    out = {"kernels": vs_plain_readings(torch, got, want),
           "control_bf16_state": vs_plain_readings(torch, ctl, want)}
    h, h_ctl = (out[k]["state_rel_err"] for k in out)
    say(f"  {cfg.name} in fp32 ({batch} x {prompt_len} prompts, {steps} "
        f"decode steps): h at the end of the runs {h:.3g} of its largest "
        f"magnitude through the kernels (tol {STATE_TOL:g}), {h_ctl:.3g} "
        f"with the scan's state in bf16 (must exceed {STATE_TOL:g}); "
        f"logits {out['kernels']['logits_rel_err']:.3g} / "
        f"{out['control_bf16_state']['logits_rel_err']:.3g}, leaves "
        f"{_fmt(out['kernels']['leaves'])} / "
        f"{_fmt(out['control_bf16_state']['leaves'])} (reported)")
    if not (out["kernels"]["finite"] and h <= STATE_TOL):
        raise PhaseFailed(f"{cfg.name} in fp32: h through the kernels "
                          f"parts from the plain run by {h:.3g}")
    if h_ctl <= STATE_TOL:
        raise PhaseFailed(f"{cfg.name} in fp32: the bf16-state control's h "
                          f"({h_ctl:.3g}) is within {STATE_TOL:g}; the limit "
                          f"cannot tell it from the kernels' fp32 state")
    return out


def _fmt(d: dict) -> dict:
    return {k: float(f"{v:.3g}") for k, v in d.items()}


def golden_hybrid(torch, np) -> dict:
    """The JAX fixture of the hybrid smoke configs on the card in fp32:
    prefill + 4 decode-step logits within 1e-4 of JAX's, and the Engine's
    tokens, finish reasons, counters and ``kv_stats`` in every cell equal
    to what JAX's engine recorded (batch: its tokens)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler import Request, SlotFailure
    from repro_torch.weights import from_jax_params
    data = np.load(GOLDEN_HYBRID)
    meta = json.loads(str(data["meta"]))
    out = {}
    for name, kw in meta["configs"].items():
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in kw.items()})
        prefix = f"{name}|params|"
        flat = {k[len(prefix):]: (data[k].astype(np.uint32) << 16)
                .view(np.float32) for k in data.files if k.startswith(prefix)}
        model = from_jax_params(flat, cfg, device="cuda")
        tokens = torch.as_tensor(data[f"{name}|logits_prompt"], device="cuda")
        logits, cache, clen = T.prefill(model, tokens,
                                        max_len=meta["max_len"])
        steps = [logits]
        for tok in data[f"{name}|logits_fed"]:
            logits, cache, clen = T.decode_step(
                model, torch.as_tensor(tok, device="cuda"), cache, clen)
            steps.append(logits)
        got = torch.stack(steps).cpu().numpy()
        err = float(np.abs(got - data[f"{name}|logits"]).max())
        if not np.isfinite(got).all() or err > GOLDEN_HYBRID_TOL:
            raise PhaseFailed(f"{name}: logits differ from JAX by {err:.3g}")
        cells = json.loads(str(data[f"{name}|cells"]))
        for cell, want in cells.items():
            cell_kw = meta["cells"][name].get(cell, {})
            reqs = [Request(i, np.asarray(r["prompt"], np.int32),
                            max_new_tokens=r["max_new"],
                            priority=r["priority"],
                            deadline_s=r["deadline_s"])
                    for i, r in enumerate(meta["workload"][name])]
            batch = cell == "batch"
            eng = Engine(cfg, model, EngineConfig(
                max_len=meta["engine_max_len"], max_slots=3,
                admission="batch" if batch else "fifo", debug=not batch,
                **cell_kw), failures=[SlotFailure(**meta["failure"])]
                if cell == "slot-failure" else None, device="cuda")
            outs = eng.generate(reqs)
            rec = {"tokens": [[int(t) for t in c.tokens] for c in outs],
                   "reasons": [c.finish_reason for c in outs]}
            if not batch:
                rec["stats"] = {k: int(v) for k, v in eng.stats().items()}
                rec["kv_stats"] = {k: float(v)
                                   for k, v in eng.kv_stats().items()}
            if rec != want:
                raise PhaseFailed(f"{name}/{cell}: the engine's record "
                                  f"differs from JAX's")
        out[name] = {"logits_max_abs_err": err, "cells": sorted(cells)}
        del model, cache
    say(f"  JAX hybrid golden (fp32): logits max |err| "
        f"{max(v['logits_max_abs_err'] for v in out.values()):.3g} (tol "
        f"{GOLDEN_HYBRID_TOL:g}); tokens, counters and kv_stats equal to "
        f"JAX's in {', '.join(f'{k}: {v}' for k, v in out.items())}")
    return out


def same_tokens(label: str, a: list, b: list, gate: bool = True) -> float:
    share = sum(x == y for x, y in zip(a, b)) / len(a)
    if gate and a != b:
        raise PhaseFailed(f"{label}: tokens differ (agreement {share:.3f})")
    return share


def gemma3_runs(torch, np, ops, calls, fa_ref, da_ref, scan_ref) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = get_config("gemma3_1b")
    with part("9 gemma3-1b init + vs_plain"):
        model = T.init_params(cfg, 0, device="cuda")    # the CLI's weights
        out = {"vs_plain": model_vs_plain(torch, model, *HYBRID_VS_PLAIN[
            "gemma3_1b"], fa_ref, da_ref, scan_ref)}
    for label, argv in G3_RUNS.items():
        with part(f"9 gemma3-1b {label}"):
            out[label] = checked_run(
                torch, ops, calls, cfg, f"gemma3-1b {label}",
                lambda: serve.main(G3_ARGS + argv), G3_NEW, 16)
    tokens = {k: [c.tokens for c in out[k]["summary"]["completions"]]
              for k in G3_RUNS}
    same_tokens("gemma3-1b fifo vs batch", tokens["fifo"], tokens["batch"])
    same_tokens("gemma3-1b paged vs slotted fifo", tokens["paged"],
                tokens["fifo"])
    # the prefix run serves the shared-preamble workload: held to a
    # slotted fifo run of it
    shared = serve.synthetic_requests(cfg, 16, 1024, G3_NEW, 0,
                                      shared_prefix=True)
    with part("9 gemma3-1b prefix-ref"):
        ref = [c.tokens for c in Engine(cfg, model, EngineConfig(
            max_slots=8, max_len=G3_RUN_S, admission="fifo"),
            device="cuda").generate(shared)]
    same_tokens("gemma3-1b paged prefix-cache vs slotted fifo",
                tokens["paged-prefix"], ref)
    same_tokens("gemma3-1b paged prefill-chunk vs slotted fifo",
                tokens["paged-chunked"], tokens["fifo"])
    for label in ("paged-prefix", "paged-chunked"):
        st, n = out[label]["summary"]["stats"], out[label]["calls"]
        if st["prefix_hits"] or st["prefill_tokens_saved"] \
                or n["prefill_extend"]:
            raise PhaseFailed(f"gemma3-1b {label}: not served one-shot "
                              f"({st['prefix_hits']} prefix hits, "
                              f"{n['prefill_extend']} extend calls)")
    reqs = serve.synthetic_requests(cfg, 16, 1024, G3_NEW, 0)
    with part("9 gemma3-1b trace"):
        out["trace"] = traced_engine(torch, model, reqs, tokens["fifo"],
                                     "gemma3-1b fifo", G3_RUN_S)
    out["trace"]["untraced_wall_s"] = out["fifo"]["summary"]["wall_s"]
    del model
    free(torch)
    return out


def recurrentgemma_runs(torch, np, ops, calls, fa_ref, da_ref,
                        scan_ref) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = get_config("recurrentgemma_9b")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.jsonl")
        Path(path).write_text("".join(
            json.dumps({"arrival_s": 0.0, "prompt_len": n,
                        "max_new": RG_NEW}) + "\n" for n in RG_LENS))
        with part("9 recurrentgemma-9b fifo"):
            fifo = checked_run(
                torch, ops, calls, cfg, "recurrentgemma-9b fifo",
                lambda: serve.main(RG_ARGS + ["--trace", path]), RG_NEW,
                len(RG_LENS))
        reqs, _ = serve.load_trace(path, cfg, np.random.RandomState(0))
    max_len = max(RG_LENS) + RG_NEW + 8
    with part("9 recurrentgemma-9b init + vs_plain"):
        model = T.init_params(cfg, 0, device="cuda")  # the CLI's weights
        out = {"fifo": fifo, "vs_plain": model_vs_plain(
            torch, model, *HYBRID_VS_PLAIN["recurrentgemma_9b"], fa_ref,
            da_ref, scan_ref)}
    with part("9 recurrentgemma-9b batch"):
        out["batch"] = checked_run(
            torch, ops, calls, cfg, "recurrentgemma-9b batch",
            lambda: serve.run(Engine(cfg, model, EngineConfig(
                max_slots=8, max_len=max_len, admission="batch"),
                device="cuda"), reqs), RG_NEW, len(RG_LENS))
    tokens = {k: [c.tokens for c in out[k]["summary"]["completions"]]
              for k in ("fifo", "batch")}
    out["fifo_batch_agreement"] = same_tokens(
        "recurrentgemma-9b fifo vs batch", tokens["fifo"], tokens["batch"])
    try:
        Engine(cfg, model, EngineConfig(max_slots=8, max_len=max_len,
                                        kv_layout="paged"), device="cuda")
    except ValueError as exc:
        if "use the slotted layout" not in str(exc):
            raise
        out["paged_refused"] = str(exc)
    else:
        raise PhaseFailed("recurrentgemma-9b: the paged layout took a "
                          "config with no global-attention layer")
    with part("9 recurrentgemma-9b trace"):
        out["trace"] = traced_engine(torch, model, reqs, tokens["fifo"],
                                     "recurrentgemma-9b fifo", max_len)
    out["trace"]["untraced_wall_s"] = out["fifo"]["summary"]["wall_s"]
    del model
    free(torch)
    with part("9 recurrentgemma-9b state_vs_plain (fp32)"):
        out["state_vs_plain"] = state_vs_plain(torch, "recurrentgemma_9b",
                                               fa_ref, da_ref, scan_ref)
    return out


def dense_runs(torch, np, ops, calls, arch, fa_ref, da_ref,
               scan_ref) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    with part(f"9 {arch} fifo"):
        out = {"fifo": checked_run(torch, ops, calls, cfg, f"{cfg.name} fifo",
                                   lambda: serve.main(["--arch", arch]
                                                      + DENSE_ARGS), 16, 8)}
    with part(f"9 {arch} init + vs_plain"):
        model = T.init_params(cfg, 0, device="cuda")
        out["vs_plain"] = model_vs_plain(torch, model, *HYBRID_VS_PLAIN[arch],
                                         fa_ref, da_ref, scan_ref)
    reqs = serve.synthetic_requests(cfg, 8, 256, 16, 0)
    with part(f"9 {arch} trace"):
        out["trace"] = traced_engine(
            torch, model, reqs, [c.tokens for c in
                                 out["fifo"]["summary"]["completions"]],
            f"{cfg.name} fifo", 256 + 16 + 8)
    del model
    free(torch)
    return out


def phase_hybrid(torch, np, ops, fa_ref, da_ref, scan_ref, smi: str) -> dict:
    """The local-attention and hybrid families served on the card: the
    JAX hybrid fixture in fp32, then gemma3-1b and recurrentgemma-9b at
    full width and depth in bf16, then llama3.2-3b and chatglm3-6b; see
    the module docstring."""
    from repro_torch.models import transformer as T
    free(torch)
    with part("9 golden"):
        out = {"golden": golden_hybrid(torch, np)}
    calls = Calls(T)
    try:
        out["gemma3-1b"] = gemma3_runs(torch, np, ops, calls, fa_ref, da_ref,
                                       scan_ref)
        out["recurrentgemma-9b"] = recurrentgemma_runs(
            torch, np, ops, calls, fa_ref, da_ref, scan_ref)
        for arch in DENSE_ARCHS:
            out[arch] = dense_runs(torch, np, ops, calls, arch, fa_ref,
                                   da_ref, scan_ref)
    finally:
        calls.restore()
    for name in ("gemma3-1b", "recurrentgemma-9b", *DENSE_ARCHS):
        s, t = out[name]["fifo"]["summary"], out[name]["trace"]
        say(f"  {name} fifo on {smi}: wall {s['wall_s']:.4f} s, "
            f"{s['tok_per_s']:.2f} tok/s, TTFT p50 {s['ttft_p50_ms']:.2f} "
            f"ms, decode {s['decode_ms_per_step']:.3f} ms/step; traced "
            f"busy {t['device_busy_s']:.4f} s of {t['wall_s']:.4f} s, idle "
            f"share {t['idle_share']:.4f}")
    say("[9/16] serving gemma3-1b and recurrentgemma-9b full width/depth "
        "bf16 (rings wrapped in prefill, RG-LRU state): every request "
        "'length', fifo == batch, paged == slotted, prefix-cache and "
        "prefill-chunk served one-shot, launches exact; llama3.2-3b and "
        "chatglm3-6b served; every model within its limits of its "
        "plain-version run; the JAX hybrid fixture within 1e-4")
    return out


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

GOLDEN_MOE_XLSTM = SRC / "repro_torch" / "testdata" / "golden_moe_xlstm.npz"
GOLDEN_MOE_XLSTM_TOL = 1e-4
# (b) qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed
# experts top-4 + 4 shared) on phase 4's prompts: 16 requests of 512
# tokens, 8 new, 8 slots. fifo through the serve CLI; the other runs
# through ``serve.run`` on the CLI's weights, each an EngineConfig of 8
# slots at max_len 528 (fifo unless it says batch), all on the einsum
# dispatch (the config's) but "gather"; "prefix" serves the shared-
# preamble workload (the first 256 tokens of every prompt alike), and
# "prefix-ref" is a slotted fifo run of that workload to hold it to
MOE_N, MOE_LEN, MOE_NEW = 16, 512, 8
MOE_S = MOE_LEN + MOE_NEW + 8
MOE_ARGS = ["--arch", "qwen2_moe_a2_7b", "--no-smoke", "--slots", "8",
            "--requests", str(MOE_N), "--prompt-len", str(MOE_LEN),
            "--max-new", str(MOE_NEW), "--policy", "fifo", "--device", "cuda"]
MOE_RUNS = {"batch": dict(admission="batch"),
            "paged": dict(kv_layout="paged", block_size=BS),
            "prefix-ref": {},
            "prefix": dict(kv_layout="paged", block_size=BS,
                           prefix_cache=True),
            "chunk": dict(prefill_chunk=256),
            "gather": {}}
MOE_VS_PLAIN = (8, 512, 4)      # the bf16 readings: prompts, length, steps
# (c) qwen2-moe-a2.7b at full width cut to 4 layers, fp32: 8 prompts of
# 512 tokens and 8 decode steps
MOE_FP32_LAYERS = 4
MOE_FP32 = (8, 512, 8)
MOE_FP32_TOL = 1e-4
# (d) qwen3-moe-235b-a22b at full width (d 4,096, 64/4 heads of 128, 128
# experts top-8) cut from 94 to 4 layers, bf16: 8 prompts of 256, 16 new
Q3_LAYERS = 4
Q3_N, Q3_LEN, Q3_NEW = 8, Q3_PROMPT, 16
Q3_S = Q3_LEN + Q3_NEW + 8
# (e) xlstm-350m at full width and depth (21 mLSTM, 3 sLSTM): 16
# requests of 128 tokens (its sLSTM loop runs one position at a time),
# 8 new, 8 slots; then in fp32 4 prompts of 512 and 8 greedy tokens,
# decode against forward
XL_LEN = 128
XL_S = XL_LEN + MOE_NEW + 8
XL_ARGS = ["--arch", "xlstm_350m", "--no-smoke", "--slots", "8",
           "--requests", str(MOE_N), "--prompt-len", str(XL_LEN),
           "--max-new", str(MOE_NEW), "--policy", "fifo", "--device", "cuda"]
XL_FP32 = (4, 512, 8)
# of the largest logit, as (c) holds its logits: the chunkwise prompt and
# the step-by-step decode are the same function in other orders of fp32
# operations (each held to JAX's within 1e-5 on the smoke config)
XL_FP32_TOL = 1e-4
# like qwen2-moe's router, xlstm-350m's bf16 fifo and batch runs may part
# at a product whose cuBLAS kernel depends on the rows it is given: the
# mLSTM gates (fp32, 8 columns) of one row must then differ by no more
# than fp32 rounding (of a sum over 2,048 terms) between a 1-row and a
# 16-row prefill
XL_GATE_ROUNDING = 1e-5
# (f) training on the copy task, one batch repeated: qwen2-moe-a2.7b at
# full width cut to 2 layers (2 x 2,048 tokens), xlstm-350m whole (2 x
# 128); 3 steps each
FAMILY_TRAIN = {
    "qwen2-moe-a2.7b": ("qwen2_moe_a2_7b", 2, dict(batch=2, seq=2048)),
    "xlstm-350m": ("xlstm_350m", None, dict(batch=2, seq=128))}
FAMILY_TRAIN_RUN = dict(steps=3, lr=1e-3, data_name="copy", repeat=True)
PEAK_MEM_GB = 80.0


def free(torch) -> None:
    """Drop unreachable models (an engine holds reference cycles) and
    hand their memory back to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


class RoutingTap:
    """Inside ``with``: every routing decision of the MoE layers, in call
    order, as (top_idx, keep) on the host (``moe._assign``, which both
    dispatches call, wrapped); with ``round_bf16`` the router logits are
    first rounded to bf16, the control's change."""

    def __init__(self, round_bf16: bool = False):
        self.round_bf16 = round_bf16
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe as M
        self.M, self.orig = M, M._assign

        def tapped(logits, cfg, capacity, *experts):
            if self.round_bf16:
                logits = logits.to(torch.bfloat16).float()
            out = self.orig(logits, cfg, capacity, *experts)
            self.calls.append((out[0].cpu(), out[2].cpu()))
            return out
        M._assign = tapped
        return self

    def __exit__(self, *exc):
        self.M._assign = self.orig


def routing_readings(torch, got: list, want: list) -> dict:
    """Two runs' routing decisions: how many (layer call, token, choice)
    entries of ``top_idx`` or ``keep`` differ, of how many."""
    if len(got) != len(want):
        raise PhaseFailed(f"routing: {len(got)} MoE calls against "
                          f"{len(want)}")
    diff = total = 0
    for (gi, gk), (wi, wk) in zip(got, want):
        diff += int(((gi != wi) | (gk != wk)).sum())
        total += gi.numel()
    return {"decisions": total, "differ": diff}


def readings(torch, got, want) -> dict:
    """Two runs' (logits of every step (rows, V), routing calls): the
    routing, the logits' max |err| over the largest |logit| and the
    greedy choices."""
    (logits, calls), (wlogits, wcalls) = got, want
    return {**routing_readings(torch, calls, wcalls),
            "logits_rel_err": rel_err(logits, wlogits),
            "argmax_differ": int((logits.argmax(-1)
                                  != wlogits.argmax(-1)).sum()),
            "rows": logits.shape[0],
            "finite": bool(torch.isfinite(logits).all())}


def tapped_drive(torch, model, inputs, plain=None, round_bf16=False,
                 impl=None) -> tuple:
    """``drive_model`` under a ``RoutingTap``: through the kernels, or
    with ``plain`` (fa_ref, da_ref, scan_ref) in their places; ``impl``
    names the MoE dispatch for this run."""
    import contextlib
    import dataclasses
    cfg = model.cfg
    if impl is not None:
        model.cfg = dataclasses.replace(cfg, moe_impl=impl)
    try:
        with RoutingTap(round_bf16) as tap, (
                PlainVersions(*plain) if plain else contextlib.nullcontext()):
            logits, _ = drive_model(torch, model, *inputs)
    finally:
        model.cfg = cfg
    return logits, tap.calls


def golden_moe_xlstm(torch, np) -> dict:
    """(a) The JAX fixture of the MoE and xLSTM smoke configs on the card
    in fp32: the weights regenerated from the fixture's seeds (their
    checksums the fixture's), ``forward``'s logits and aux and the
    prefill + decode logits within 1e-4 of JAX's, the Engine's records
    in every cell equal to JAX's, and the training part (one step of the
    tight variant): loss, ce, aux and every gradient leaf within 1e-4 of
    JAX's (less the fixture's rounding of the gradients)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler import Request
    from repro_torch.weights import from_jax_params, seeded_flat, to_flat
    data = np.load(GOLDEN_MOE_XLSTM)
    meta = json.loads(str(data["meta"]))
    tol = GOLDEN_MOE_XLSTM_TOL
    cfgs, out = {}, {}
    for name, kw in meta["configs"].items():
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
        kw["moe"] = MoEConfig(**kw["moe"]) if kw["moe"] else None
        cfg = cfgs[name] = ModelConfig(**kw)
        flat = seeded_flat(cfg, meta["seeds"][name])
        if {k: float(np.asarray(v, np.float64).sum())
                for k, v in flat.items()} != meta["checksums"][name]:
            raise PhaseFailed(f"{name}: the seeded weights are not the "
                              f"fixture's")
        model = from_jax_params(flat, cfg, device="cuda")
        prompt = torch.as_tensor(data[f"{name}|logits_prompt"], device="cuda")
        fwd, aux = T.forward(model, cfg, {"tokens": prompt}, train=False)
        logits, cache, clen = T.prefill(
            model, prompt, max_len=prompt.shape[1] + meta["decode_steps"] + 3)
        steps = [logits]
        for tok in data[f"{name}|logits_fed"]:
            logits, cache, clen = T.decode_step(
                model, torch.as_tensor(tok, device="cuda"), cache, clen)
            steps.append(logits)
        errs = {"forward": np.abs(fwd.float().cpu().numpy()
                                  - data[f"{name}|forward_logits"]).max(),
                "aux": abs(float(aux) - float(data[f"{name}|forward_aux"])),
                "steps": np.abs(torch.stack(steps).cpu().numpy()
                                - data[f"{name}|logits"]).max()}
        errs = {k: float(v) for k, v in errs.items()}
        if not all(np.isfinite(v) and v <= tol for v in errs.values()):
            raise PhaseFailed(f"{name}: logits differ from JAX's: {errs}")
        cells = json.loads(str(data[f"{name}|cells"]))
        specs = meta["workload"][name]
        max_len = meta["engine_max_len"][name]

        def reqs():
            return [Request(i, np.asarray(r["prompt"], np.int32),
                            max_new_tokens=r["max_new"],
                            priority=r["priority"],
                            deadline_s=r["deadline_s"])
                    for i, r in enumerate(specs)]
        got = {}
        outs = Engine(cfg, model, EngineConfig(
            max_len=max_len, admission="batch"), device="cuda").generate(
                reqs())
        got["batch"] = {"tokens": [[int(t) for t in c.tokens] for c in outs],
                        "reasons": [c.finish_reason for c in outs]}
        for cell, cell_kw in meta["cells"][name].items():
            eng = Engine(cfg, model, EngineConfig(
                max_len=max_len, max_slots=3, admission="fifo", debug=True,
                **cell_kw), device="cuda")
            outs = eng.generate(reqs())
            got[cell] = {
                "tokens": [[int(t) for t in c.tokens] for c in outs],
                "reasons": [c.finish_reason for c in outs],
                "stats": {k: int(v) for k, v in eng.stats().items()},
                "kv_stats": {k: float(v) for k, v in eng.kv_stats().items()}}
        if "paged" in cells and "refused" in cells["paged"]:
            try:
                Engine(cfg, model, EngineConfig(
                    max_len=max_len, max_slots=3, kv_layout="paged"),
                    device="cuda")
            except ValueError as exc:
                got["paged"] = {"refused": str(exc)}
        for cell in cells:
            if got.get(cell) != cells[cell]:
                raise PhaseFailed(f"{name}/{cell}: the engine's record "
                                  f"differs from JAX's")
        out[name] = {**errs, "cells": sorted(cells)}
        del model, cache
    tr = meta["train"]
    cfg = cfgs[tr["config"]]
    model = from_jax_params(seeded_flat(cfg, meta["seeds"][tr["config"]]),
                            cfg, device="cuda", dtype=torch.float32)
    model.requires_grad_(True)
    b, s = tr["batch"]
    tokens = np.random.RandomState(tr["seed"]).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = tokens.copy()
    labels[0, :3] = -1
    loss, m = T.loss_fn(model, cfg, {
        "tokens": torch.as_tensor(tokens, device="cuda"),
        "labels": torch.as_tensor(labels, device="cuda")})
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = to_flat(model, grad=True)
    want = {k[len("train|grads|"):]: data[k] for k in data.files
            if k.startswith("train|grads|")}
    if sorted(grads) != sorted(want):
        raise PhaseFailed("the training part's gradient leaves differ from "
                          "the fixture's")
    train = {k: abs(float(v) - float(data[f"train|{k}"]))
             for k, v in (("loss", loss.detach()), ("ce", m["ce"]),
                          ("aux", m["aux"]))}
    # each leaf's limit: 1e-4 less the fixture's rounding of it
    margin = {k: tol - np.abs(w).max() * 2.0 ** -meta["grad_bits"]
              - float(np.abs(grads[k] - w).max()) for k, w in want.items()}
    train["grad_max_abs_err"] = max(float(np.abs(grads[k] - w).max())
                                    for k, w in want.items())
    out["train"] = train
    del model
    free(torch)
    shown = "; ".join(f"{k}: forward {v['forward']:.3g}, steps "
                      f"{v['steps']:.3g}, aux {v['aux']:.3g}, cells "
                      f"{v['cells']}" for k, v in out.items() if k != "train")
    say(f"  (a) JAX MoE/xLSTM golden (fp32), logits max |err| (tol {tol:g}) "
        f"and engine records equal to JAX's: {shown}; training part "
        f"({tr['config']}): loss {train['loss']:.3g}, ce "
        f"{train['ce']:.3g}, aux {train['aux']:.3g}, gradients "
        f"{train['grad_max_abs_err']:.3g} (tol {tol:g} less rounding)")
    if not (all(v <= tol for k, v in train.items() if k != "grad_max_abs_err")
            and min(margin.values()) >= 0):
        raise PhaseFailed(f"the training part differs from JAX's: {train}")
    return out


def moe_vs_plain_bf16(torch, model, fa_ref, da_ref, scan_ref) -> dict:
    """qwen2-moe-a2.7b in bf16 at full depth through the kernels and
    through the plain versions, on ``MOE_VS_PLAIN``'s inputs: the
    routing decisions that differ, the logits and the greedy choices,
    reported (no limit: in bf16 over 24 layers a routing decision turns
    on one rounding, and the fp32 run (c) is held instead)."""
    inputs = vs_plain_inputs(torch, model.cfg, *MOE_VS_PLAIN, seed=1)
    out = readings(torch, tapped_drive(torch, model, inputs),
                   tapped_drive(torch, model, inputs,
                                plain=(fa_ref, da_ref, scan_ref)))
    say(f"  qwen2-moe bf16 ({model.cfg.n_layers} layers) through the kernels "
        f"vs plain "
        f"({MOE_VS_PLAIN[0]} x {MOE_VS_PLAIN[1]} prompts, {MOE_VS_PLAIN[2]} "
        f"steps), reported: {out['differ']} of {out['decisions']} routing "
        f"decisions differ, logits {out['logits_rel_err']:.3g} of max "
        f"|logit|, {out['argmax_differ']} of {out['rows']} greedy choices "
        f"moved")
    return out


# qwen2-moe's bf16 fifo and batch runs may part: the router product h @
# router (bf16, as the reference computes it) of one row rounds apart in
# a 1-row and a 16-row prefill, cuBLAS taking another kernel for other
# row counts, and a tie between two router logits then breaks the other
# way. fifo_batch_cause must find that cause (each moved decision at a
# gap of at most BF16_TIE_ULPS bf16 ulps); (c) holds fifo = batch in fp32
BF16_TIE_ULPS = 2


def bf16_ulps(torch, gap, value):
    """``gap`` in units of the bf16 spacing of ``value`` (8 bits)."""
    exp = torch.floor(torch.log2(value.abs().clamp(min=1e-30)))
    return gap / torch.pow(2.0, exp - 7)


def fifo_batch_cause(torch, np, model, reqs, fifo, batch) -> dict:
    """Why qwen2-moe's bf16 fifo and batch runs part. Reported: each
    request's first differing token. Shown: the first prompt whose first
    layer routes apart alone (as fifo prefills it) and as its row of the
    16-row batch (as batch prefills it): the router's input ``h`` must
    be bitwise equal, the router logits may then differ only by bf16
    rounding (at most ``BF16_TIE_ULPS`` ulps of the position's largest
    logit), and every routing decision that differs must sit at a
    top-(k+1) logit gap of at most ``BF16_TIE_ULPS`` ulps in the alone
    run. That prompt's whole prefill, routed under a
    ``RoutingTap`` both ways, is reported layer by layer beside it."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = model.cfg
    first = [next((i for i, (a, b) in enumerate(zip(f, g)) if a != b),
                  min(len(f), len(g))) for f, g in zip(fifo, batch)]
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda").long()
    layer = model.layers[0]
    cap = M._capacity(tokens.shape[1], cfg)

    def first_layer(toks):
        x = T._embed_inputs(model, toks)
        pos = torch.arange(toks.shape[1], dtype=torch.int32,
                           device="cuda").expand(*toks.shape)
        a, _ = L.attn_prefill_cache(layer.block, x, cfg, kind="attn",
                                    positions=pos, cache_size=toks.shape[1])
        h = L.rms_norm(a, layer.moe.ln, cfg.norm_eps)
        return h, M._router_logits(layer.moe, h)
    with torch.no_grad():
        h_all, lg_all = first_layer(tokens)
        top_all = M._assign(lg_all, cfg, cap)[0]
        for r in range(tokens.shape[0]):
            h_one, lg_one = first_layer(tokens[r:r + 1])
            top_one = M._assign(lg_one, cfg, cap)[0]
            moved = (top_all[r:r + 1] != top_one).any(-1)[0].nonzero()[
                :, 0].tolist()
            if moved:
                break
        h_all, lg_all = h_all[r:r + 1], lg_all[r:r + 1]
        with RoutingTap() as tb:
            T.prefill(model, tokens, max_len=tokens.shape[1])
        with RoutingTap() as to:
            T.prefill(model, tokens[r:r + 1], max_len=tokens.shape[1])
    k = cfg.moe.top_k
    gaps = []
    for t in moved:
        top = torch.sort(lg_one[0, t], descending=True).values[:k + 1]
        gaps.append(float(bf16_ulps(torch, top[:-1] - top[1:],
                                    top[:-1]).min()))
    # in ulps of each position's largest logit: the rounding scale of
    # the product (a split-K kernel rounds partial sums at that scale)
    logit_ulps = float(bf16_ulps(torch, (lg_all - lg_one).abs(),
                                 torch.maximum(lg_all.abs(), lg_one.abs())
                                 .amax(-1, keepdim=True)).max())
    per_layer = [int(((bi[r:r + 1] != oi) | (bk[r:r + 1] != ok)).any(-1)
                     .sum()) for (bi, bk), (oi, ok) in zip(tb.calls,
                                                           to.calls)]
    out = {"first_differing_token": first, "request": r,
           "h_equal": bool(torch.equal(h_all, h_one)),
           "router_logits_equal": bool(torch.equal(lg_all, lg_one)),
           "router_logits_max_ulps": logit_ulps,
           "layer0_moved_positions": len(moved),
           "layer0_moved_gap_ulps": gaps,
           "prefill_positions_routed_apart_by_layer": per_layer}
    say(f"  qwen2-moe bf16 fifo vs batch part: first differing token of "
        f"each request {first}; request {r}'s first layer alone vs in the "
        f"16-row batch: h equal {out['h_equal']}, router logits equal "
        f"{out['router_logits_equal']} (at most {logit_ulps:.3g} bf16 ulps "
        f"of the position's largest logit apart), {len(moved)} of "
        f"{tokens.shape[1]} positions routed apart, at top-{k + 1} logit "
        f"gaps of {sorted(set(round(g, 3) for g in gaps))} ulps (must be "
        f"<= {BF16_TIE_ULPS}); positions routed apart in the whole prefill, "
        f"by layer: {per_layer}")
    if not (out["h_equal"] and logit_ulps <= BF16_TIE_ULPS and moved
            and max(gaps) <= BF16_TIE_ULPS):
        raise PhaseFailed("qwen2-moe fifo vs batch: the split is not bf16 "
                          "rounding of the router product at a tie")
    return out


def qwen2_moe_runs(torch, np, ops, calls, fa_ref, da_ref, scan_ref) -> dict:
    """(b) qwen2-moe-a2.7b at full width and depth in bf16: the serve
    CLI's fifo run, then ``MOE_RUNS`` on the CLI's weights; every
    request ends by length, launches exact (24 flash a prefill or extend
    call, 24 of the layout's decode kernel a step); fifo = batch, paged
    = slotted fifo; the prefix run hits and the chunk run extends, their
    tokens (and the gather run's) reported against fifo's; the fifo run
    traced; the bf16 readings against the plain versions."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = get_config("qwen2_moe_a2_7b")
    with part("10 qwen2-moe fifo"):
        out = {"fifo": checked_run(torch, ops, calls, cfg, "qwen2-moe fifo",
                                   lambda: serve.main(MOE_ARGS), MOE_NEW,
                                   MOE_N)}
    free(torch)
    with part("10 qwen2-moe init"):
        model = T.init_params(cfg, 0, device="cuda")  # the CLI's weights
    reqs = serve.synthetic_requests(cfg, MOE_N, MOE_LEN, MOE_NEW, 0)
    shared = serve.synthetic_requests(cfg, MOE_N, MOE_LEN, MOE_NEW, 0,
                                      shared_prefix=True)
    for label, kw in MOE_RUNS.items():
        run_cfg = dataclasses.replace(cfg, moe_impl="gather") \
            if label == "gather" else cfg

        def drive(kw=kw, run_cfg=run_cfg, label=label):
            model.cfg = run_cfg
            try:
                return serve.run(Engine(run_cfg, model, EngineConfig(
                    max_slots=8, max_len=MOE_S, **{"admission": "fifo",
                                                   **kw}), device="cuda"),
                    shared if label.startswith("prefix") else reqs)
            finally:
                model.cfg = cfg
        with part(f"10 qwen2-moe {label}"):
            out[label] = checked_run(torch, ops, calls, cfg,
                                     f"qwen2-moe {label}", drive, MOE_NEW,
                                     MOE_N)
    tokens = {k: [c.tokens for c in out[k]["summary"]["completions"]]
              for k in out}
    out["fifo_batch_agreement"] = same_tokens(
        "qwen2-moe fifo vs batch", tokens["fifo"], tokens["batch"],
        gate=False)
    if tokens["fifo"] != tokens["batch"]:
        # held in fp32 by (c); here the split must be shown to be bf16
        # rounding of the router product, or the phase fails
        with part("10 qwen2-moe fifo_batch_cause"):
            out["fifo_batch_split"] = fifo_batch_cause(
                torch, np, model, reqs, tokens["fifo"], tokens["batch"])
    same_tokens("qwen2-moe paged vs slotted fifo", tokens["paged"],
                tokens["fifo"])
    st, n = out["prefix"]["summary"]["stats"], out["prefix"]["calls"]
    if st["prefix_hits"] <= 0 or n["prefill_extend"] <= 0:
        raise PhaseFailed(f"qwen2-moe prefix: {st['prefix_hits']} hits, "
                          f"{n['prefill_extend']} extend calls")
    if out["chunk"]["calls"]["prefill_extend"] <= 0:
        raise PhaseFailed("qwen2-moe chunk: no extend call")
    # reported: the capacity groups of a resumed or chunked prefill are
    # its extend calls' rows, and the gather combine sums in another order
    out["agreement"] = {
        "prefix vs prefix-ref": same_tokens("", tokens["prefix"],
                                            tokens["prefix-ref"], gate=False),
        "chunk vs fifo": same_tokens("", tokens["chunk"], tokens["fifo"],
                                     gate=False),
        "gather vs fifo": same_tokens("", tokens["gather"], tokens["fifo"],
                                      gate=False)}
    say(f"  qwen2-moe agreement (reported): {out['agreement']}")
    with part("10 qwen2-moe trace"):
        out["trace"] = traced_engine(torch, model, reqs, tokens["fifo"],
                                     "qwen2-moe fifo", MOE_S)
    out["trace"]["untraced_wall_s"] = out["fifo"]["summary"]["wall_s"]
    with part("10 qwen2-moe vs_plain_bf16"):
        out["vs_plain_bf16"] = moe_vs_plain_bf16(torch, model, fa_ref,
                                                 da_ref, scan_ref)
    del model
    free(torch)
    return out


def moe_fp32(torch, fa_ref, da_ref, scan_ref) -> dict:
    """(c) qwen2-moe-a2.7b at full width cut to 4 layers in fp32 on
    ``MOE_FP32``'s inputs (the serve CLI's init, seed 0): the kernels'
    run against the plain versions', the gather dispatch against the
    einsum one (both through the kernels), and a batch prefill against
    the same prompts prefilled one at a time. Each pair: every routing
    decision equal, logits within ``MOE_FP32_TOL`` of the largest
    logit, greedy choices equal. The control, the plain run with its
    router logits rounded to bf16, must move a routing decision. Then
    (b)'s workload through the Engine under fifo and batch admission:
    tokens equal (fifo = batch, held in fp32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"),
                              n_layers=MOE_FP32_LAYERS, dtype="float32")
    with part("10 (c) fp32 init + tapped drives"):
        model = T.init_params(cfg, 0, device="cuda")
        inputs = vs_plain_inputs(torch, cfg, *MOE_FP32, seed=1)
        plain = (fa_ref, da_ref, scan_ref)
        kern = tapped_drive(torch, model, inputs)
        ref = tapped_drive(torch, model, inputs, plain=plain)
        out = {"kernels vs plain": readings(torch, kern, ref),
               "gather vs einsum": readings(
                   torch, tapped_drive(torch, model, inputs, impl="gather"),
                   kern),
               "control (bf16 router logits) vs plain": readings(
                   torch, tapped_drive(torch, model, inputs, plain=plain,
                                       round_bf16=True), ref)}
    tokens, _, max_len = inputs
    with part("10 (c) fp32 batch vs fifo prefill"):
        with RoutingTap() as tb:
            batch = T.prefill(model, tokens, max_len=max_len)[0].float()
        with RoutingTap() as tf:
            fifo = torch.cat([T.prefill(model, tokens[i:i + 1],
                                        max_len=max_len)[0].float()
                              for i in range(tokens.shape[0])])
    layers = cfg.n_layers       # fifo's calls: prompt-major, then layer
    rows = [(torch.cat([tf.calls[r * layers + li][0]
                        for r in range(tokens.shape[0])]),
             torch.cat([tf.calls[r * layers + li][1]
                        for r in range(tokens.shape[0])]))
            for li in range(layers)]
    out["batch vs fifo prefill"] = readings(torch, (batch, tb.calls),
                                            (fifo, rows))
    # (b)'s fifo = batch, held here in fp32: its workload through the
    # Engine under both admissions
    reqs = serve.synthetic_requests(cfg, MOE_N, MOE_LEN, MOE_NEW, 0)
    with part("10 (c) fp32 engine fifo + batch"):
        served = {adm: [c.tokens for c in Engine(cfg, model, EngineConfig(
            max_slots=8, max_len=MOE_S, admission=adm),
            device="cuda").generate(reqs)] for adm in ("fifo", "batch")}
    engine_share = same_tokens("", served["fifo"], served["batch"],
                               gate=False)
    del model
    free(torch)
    for label, r in list(out.items()):
        say(f"  (c) qwen2-moe fp32 ({MOE_FP32_LAYERS} layers, "
            f"{MOE_FP32[0]} x {MOE_FP32[1]} prompts, {MOE_FP32[2]} steps) "
            f"{label}: {r['differ']} of {r['decisions']} routing decisions "
            f"differ, logits {r['logits_rel_err']:.3g} of max |logit| (tol "
            f"{MOE_FP32_TOL:g}), {r['argmax_differ']} of {r['rows']} greedy "
            f"choices moved")
    say(f"  (c) qwen2-moe fp32 Engine fifo vs batch ({MOE_N} x {MOE_LEN}, "
        f"{MOE_NEW} new, 8 slots): tokens agree on {engine_share:.3f} of "
        f"the requests (must be 1)")
    for label, r in out.items():
        held_ok = (r["finite"] and not r["differ"] and not r["argmax_differ"]
                   and r["logits_rel_err"] <= MOE_FP32_TOL)
        if label.startswith("control"):
            if not r["differ"]:
                raise PhaseFailed("qwen2-moe fp32: the bf16-router control "
                                  "moved no routing decision; the gate "
                                  "cannot tell it from the kernels' run")
        elif not held_ok:
            raise PhaseFailed(f"qwen2-moe fp32 {label}: outside the limits")
    if engine_share != 1.0:
        raise PhaseFailed("qwen2-moe fp32: fifo and batch tokens differ")
    out["engine fifo vs batch"] = engine_share
    return out


def qwen3_moe_run(torch, ops, calls) -> dict:
    """(d) qwen3-moe-235b-a22b at full width cut to ``Q3_LAYERS`` layers
    in bf16: a fifo run through ``serve.run`` (seed 0), every request by
    length, launches exact, traced."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = dataclasses.replace(get_config("qwen3_moe_235b_a22b"),
                              n_layers=Q3_LAYERS)
    model = T.init_params(cfg, 0, device="cuda")
    reqs = serve.synthetic_requests(cfg, Q3_N, Q3_LEN, Q3_NEW, 0)
    out = {"fifo": checked_run(
        torch, ops, calls, cfg, f"qwen3-moe ({Q3_LAYERS} layers) fifo",
        lambda: serve.run(Engine(cfg, model, EngineConfig(
            max_slots=8, max_len=Q3_S, admission="fifo"), device="cuda"),
            reqs), Q3_NEW, Q3_N)}
    out["trace"] = traced_engine(
        torch, model, reqs, [c.tokens for c in
                             out["fifo"]["summary"]["completions"]],
        "qwen3-moe fifo", Q3_S)
    out["trace"]["untraced_wall_s"] = out["fifo"]["summary"]["wall_s"]
    del model
    free(torch)
    return out


def slstm_prefill_launches(torch, model, tokens) -> int:
    """The device kernels one sLSTM layer's prefill of ``tokens`` runs
    (its time loop and the projections around it), counted in a
    ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    layer = next(lay for lay in model.layers if lay.kind == "slstm")
    with torch.no_grad():
        x = T._embed_inputs(model, tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            S.slstm_prefill_cache(layer.block, x, model.cfg)
            torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def xlstm_fifo_batch_cause(torch, np, model, reqs, fifo, batch) -> dict:
    """Why xlstm-350m's bf16 fifo and batch runs part. Reported: each
    request's first differing token. Shown: the first prompt through the
    first mLSTM layer alone (as fifo prefills it) and as row 0 of the
    16-row batch (as batch prefills it): the input of the gate product,
    the conv's output ``xc``, must be bitwise equal, and the gates (xc @
    w_if in fp32, 2H = 8 columns) must differ by fp32 rounding only
    (within ``XL_GATE_ROUNDING`` of their largest magnitude): a product
    whose cuBLAS kernel depends on the rows it is given, whose rounding
    the bf16 layers then carry to the logits."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.rglru import _causal_conv
    first = [next((i for i, (a, b) in enumerate(zip(f, g)) if a != b),
                  min(len(f), len(g))) for f, g in zip(fifo, batch)]
    p = model.layers[0].block
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda").long()

    def gates(toks):
        x = T._embed_inputs(model, toks)
        h = L.rms_norm(x, p.ln, model.cfg.norm_eps)
        xm = (h @ p.w_up).chunk(2, dim=-1)[0]
        xc = F.silu(_causal_conv(xm, p.conv_w, p.conv_b))
        return xc, torch.cat(S._gates(p, xc), dim=-1)
    with torch.no_grad():
        xc_all, g_all = gates(tokens)
        xc_one, g_one = gates(tokens[:1])
    g_all = g_all[:1]
    out = {"first_differing_token": first,
           "xc_equal": bool(torch.equal(xc_all[:1], xc_one)),
           "gates_equal": bool(torch.equal(g_all, g_one)),
           "gates_rel_diff": rel_err(g_all, g_one)}
    say(f"  xlstm-350m bf16 fifo vs batch part: first differing token of "
        f"each request {first}; prompt 0's first mLSTM layer alone vs in "
        f"the 16-row batch: gate input xc equal {out['xc_equal']}, gates "
        f"(fp32) equal {out['gates_equal']}, apart by "
        f"{out['gates_rel_diff']:.3g} of their largest magnitude (fp32 "
        f"rounding: <= {XL_GATE_ROUNDING:g})")
    if not (out["xc_equal"] and not out["gates_equal"]
            and out["gates_rel_diff"] <= XL_GATE_ROUNDING):
        raise PhaseFailed("xlstm-350m fifo vs batch: the split is not the "
                          "gate product's rounding")
    return out


def xlstm_runs(torch, np, ops, calls) -> dict:
    """(e) xlstm-350m at full width and depth in bf16: the serve CLI's
    fifo run and a batch run on its weights, every request by length,
    no kernel launched, fifo = batch or their split shown to start at a
    batch-dependent rounding (``xlstm_fifo_batch_cause``), the paged
    layout refused in the reference's words, one sLSTM layer's prefill
    counted; then in fp32 the same workload fifo = batch, and the decode
    steps' logits of 8 greedy tokens against ``forward`` over the
    prompts and those tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = get_config("xlstm_350m")
    with part("10 xlstm-350m fifo"):
        out = {"fifo": checked_run(torch, ops, calls, cfg, "xlstm-350m fifo",
                                   lambda: serve.main(XL_ARGS), MOE_NEW,
                                   MOE_N, expect_flash=False)}
    free(torch)
    model = T.init_params(cfg, 0, device="cuda")    # the CLI's weights
    reqs = serve.synthetic_requests(cfg, MOE_N, XL_LEN, MOE_NEW, 0)
    with part("10 xlstm-350m batch"):
        out["batch"] = checked_run(
            torch, ops, calls, cfg, "xlstm-350m batch",
            lambda: serve.run(Engine(cfg, model, EngineConfig(
                max_slots=8, max_len=XL_S, admission="batch"),
                device="cuda"), reqs), MOE_NEW, MOE_N, expect_flash=False)
    tokens = {k: [c.tokens for c in out[k]["summary"]["completions"]]
              for k in ("fifo", "batch")}
    out["fifo_batch_agreement"] = same_tokens(
        "xlstm-350m fifo vs batch", tokens["fifo"], tokens["batch"],
        gate=False)
    if tokens["fifo"] != tokens["batch"]:
        # held in fp32 below; here the split must start at a rounding
        with part("10 xlstm-350m fifo_batch_cause"):
            out["fifo_batch_split"] = xlstm_fifo_batch_cause(
                torch, np, model, reqs, tokens["fifo"], tokens["batch"])
    try:
        Engine(cfg, model, EngineConfig(max_slots=8, max_len=XL_S,
                                        kv_layout="paged"), device="cuda")
    except ValueError as exc:
        if "use the slotted layout" not in str(exc):
            raise
        out["paged_refused"] = str(exc)
    else:
        raise PhaseFailed("xlstm-350m: the paged layout took a config with "
                          "no global-attention layer")
    one = torch.as_tensor(reqs[0].prompt[None], device="cuda")
    with part("10 xlstm-350m slstm launches"):
        out["slstm_layer_prefill_kernels"] = slstm_prefill_launches(
            torch, model, one)
    n_slstm = cfg.layer_kinds.count("slstm")
    say(f"  xlstm-350m: one sLSTM layer's prefill of {one.shape[1]} tokens "
        f"runs {out['slstm_layer_prefill_kernels']} device kernels "
        f"(x {n_slstm} layers a prefill)")
    del model
    free(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = T.init_params(cfg32, 0, device="cuda")
    with part("10 xlstm-350m fp32 engine fifo + batch"):
        served = {adm: [c.tokens for c in Engine(cfg32, model, EngineConfig(
            max_slots=8, max_len=XL_S, admission=adm),
            device="cuda").generate(reqs)] for adm in ("fifo", "batch")}
    out["fp32_fifo_batch_agreement"] = share = same_tokens(
        "", served["fifo"], served["batch"], gate=False)
    say(f"  (e) xlstm-350m fp32 Engine fifo vs batch ({MOE_N} x {XL_LEN}, "
        f"{MOE_NEW} new, 8 slots): tokens agree on {share:.3f} of the "
        f"requests (must be 1)")
    if share != 1.0:
        raise PhaseFailed("xlstm-350m fp32: fifo and batch tokens differ")
    b, s, n = XL_FP32
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    with part("10 xlstm-350m fp32 decode vs forward"):
        logits, cache, clen = T.prefill(model, prompt, max_len=s + n + 8)
        seq, steps = [prompt], []
        for _ in range(n):
            tok = logits.float().argmax(-1)
            seq.append(tok[:, None])
            logits, cache, clen = T.decode_step(model, tok, cache, clen)
            steps.append(logits.float())
        with torch.no_grad():
            full = T.forward(model, cfg32, {"tokens": torch.cat(seq, 1)},
                             train=False)[0][:, s:].float()
    got = torch.stack(steps, 1)
    err = (got - full).abs().max().item()
    out["fp32_decode_vs_forward"] = {"max_abs_err": err,
                                     "rel_err": rel_err(got, full)}
    del model, cache
    free(torch)
    rel = out["fp32_decode_vs_forward"]["rel_err"]
    say(f"  (e) xlstm-350m fp32: {n} decode steps' logits against forward "
        f"over {b} x ({s} + {n}) tokens: max |err| {rel:.3g} of max |logit| "
        f"(tol {XL_FP32_TOL:g}; {err:.3g} absolute)")
    if not (math.isfinite(err) and rel <= XL_FP32_TOL):
        raise PhaseFailed("xlstm-350m fp32: decode parts from forward")
    return out


def family_training(torch, ops) -> dict:
    """(f) ``repro_torch.launch.train.run`` on the copy task, bf16 over
    fp32 masters: ``FAMILY_TRAIN``'s models, ``FAMILY_TRAIN_RUN``'s
    steps. Gates: loss, ce and aux finite at every step, peak memory
    under ``PEAK_MEM_GB``, launches exact (flash per attention layer
    and remat period, none for xLSTM)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    out = {}
    for label, (arch, layers, shape) in FAMILY_TRAIN.items():
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for k in TRAIN_KERNELS:
            ops[k].launches = 0
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        with part(f"10 (f) training {label}"):
            run = train.run(cfg, device="cuda", log_every=1, **shape,
                            **FAMILY_TRAIN_RUN)
        torch.cuda.synchronize()
        steps = FAMILY_TRAIN_RUN["steps"]
        want = {k: v * steps for k, v in train_launches(cfg, 1).items()} \
            if cfg.moe is not None else dict.fromkeys(TRAIN_KERNELS, 0)
        rec = {"config": f"{cfg.name} n_layers={cfg.n_layers} "
                         f"{shape['batch']} x {shape['seq']}",
               "params": sum(p.numel() for p in run["model"].parameters()),
               "metrics": [{k: m[k] for k in ("loss", "ce", "aux")}
                           for m in run["metrics"]],
               "step_s": run["step_s"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts(ops), "want_launches": want}
        del run
        free(torch)
        out[label] = rec
        say(f"  (f) training {rec['config']} ({rec['params'] / 1e9:.3f} B "
            f"params): {rec['metrics']}; step times "
            f"{[round(x, 4) for x in rec['step_s']]} s; peak memory "
            f"{rec['peak_mem_gb']:.2f} GB; launches {rec['launches']}")
        if not all(math.isfinite(v) for m in rec["metrics"]
                   for v in m.values()):
            raise PhaseFailed(f"training {label}: a non-finite loss")
        if rec["peak_mem_gb"] >= PEAK_MEM_GB:
            raise PhaseFailed(f"training {label}: peak memory "
                              f"{rec['peak_mem_gb']:.2f} GB")
        if rec["launches"] != want:
            raise PhaseFailed(f"training {label}: launches "
                              f"{rec['launches']}, want {want}")
    return out


def phase_families(torch, np, ops, fa_ref, da_ref, scan_ref,
                   smi: str) -> dict:
    """The MoE and xLSTM families on the card; see the module docstring."""
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    free(torch)
    with part("10 golden"):
        out = {"golden": golden_moe_xlstm(torch, np)}
    calls = Calls(T)
    try:
        out["qwen2-moe"] = qwen2_moe_runs(torch, np, ops, calls, fa_ref,
                                          da_ref, scan_ref)
        out["fp32"] = moe_fp32(torch, fa_ref, da_ref, scan_ref)
        with part("10 qwen3-moe"):
            out["qwen3-moe"] = qwen3_moe_run(torch, ops, calls)
        out["xlstm-350m"] = xlstm_runs(torch, np, ops, calls)
    finally:
        calls.restore()
    out["train"] = family_training(torch, ops)
    for name in ("qwen2-moe", "qwen3-moe", "xlstm-350m"):
        s, t = out[name]["fifo"]["summary"], out[name].get("trace")
        say(f"  {name} fifo on {smi}: wall {s['wall_s']:.4f} s, "
            f"{s['tok_per_s']:.2f} tok/s, TTFT p50 {s['ttft_p50_ms']:.2f} "
            f"ms, decode {s['decode_ms_per_step']:.3f} ms/step"
            + (f"; traced busy {t['device_busy_s']:.4f} s of "
               f"{t['wall_s']:.4f} s, idle share {t['idle_share']:.4f}"
               if t else ""))
    out["phase_s"] = time.perf_counter() - t0
    say(f"  phase 10 took {out['phase_s']:.1f} s")
    say("[10/16] the MoE and xLSTM families on the card: the JAX fixture "
        "within 1e-4 with JAX's engine records; qwen2-moe-a2.7b full "
        "width/depth bf16 served fifo, batch, paged, prefix-cache, chunked "
        "and on the gather dispatch, launches exact, paged == slotted, "
        "fifo == batch (in bf16 equal or parted at router-logit ties, held "
        "in fp32); routing equal in fp32 (kernels vs plain, gather "
        "vs einsum, batch vs fifo) with the bf16-router control outside; "
        "qwen3-moe-235b-a22b's width at 4 layers and xlstm-350m served "
        "(its fifo == batch held the same way); "
        "both families trained, losses finite, under 80 GB")
    return out


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

GOLDEN_ENCDEC = SRC / "repro_torch" / "testdata" / "golden_encdec.npz"
GOLDEN_ENCDEC_TOL = 1e-4
# (c), (d): the serve CLI's workloads at full width and depth, 32 new
# tokens over 8 slots: seamless-m4t-medium 16 requests of 512 tokens
# over 512 stub frames, llava-next-mistral-7b 8 of 2,880 stub patch rows
# + 512 tokens (the CLI's max_len counts the patch rows: 3,432)
ENCDEC_SERVE = {"seamless": ("seamless_m4t_medium", 16),
                "llava": ("llava_next_mistral_7b", 8)}
ED_LEN, ED_NEW = 512, 32
# (e): each model against its plain versions: (batch, prompt length,
# decode steps); llava's plain attention over 3,392 rows holds (B, H,
# 3,392, 3,392) fp32 scores, so 2 prompts
ENCDEC_VS_PLAIN = {"seamless": (8, 512, 4), "llava": (2, 512, 4)}
# where a bf16 fifo run parts from its batch run, both are run again in
# fp32 with the decoder cut to this many layers, and must agree
ENCDEC_FP32_LAYERS = 4
# (f): 3 steps on the copy task: seamless-m4t-medium whole (2 x 1,024
# tokens over 1,024 zero frames), llava-next-mistral-7b cut 32 -> 4
# layers (2 x (2,880 zero patch rows + 512 tokens)); whole it needs
# ~116 GB of fp32 masters, gradients and moments
ENCDEC_TRAIN = {
    "seamless-m4t-medium": ("seamless_m4t_medium", None,
                            dict(batch=2, seq=1024)),
    "llava-next-mistral-7b": ("llava_next_mistral_7b", 4,
                              dict(batch=2, seq=512))}


def golden_encdec(torch, np) -> dict:
    """(b) The JAX fixture of seamless-m4t-medium's and
    llava-next-mistral-7b's smoke configs on the card in fp32: the
    weights regenerated from the fixture's seeds (their checksums the
    fixture's), ``forward``'s and the prefill + decode logits within
    1e-4 of JAX's; the Engine on the fixture's workload: batch records
    equal to JAX's, batch, slotted fifo and paged fifo tokens equal to
    the greedy tokens of JAX's ``forward`` loop, llava's slotted fifo
    record (counters and ``kv_stats``) equal to JAX's; the narrow
    variants' loss and every gradient leaf within 1e-4 of JAX's (less
    the fixture's rounding of the gradients)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler import Request
    from repro_torch.weights import from_jax_params, seeded_flat, to_flat
    data = np.load(GOLDEN_ENCDEC)
    meta = json.loads(str(data["meta"]))
    tol = GOLDEN_ENCDEC_TOL

    def weights(name, kw, checksums, dtype=None):
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in kw.items()})
        flat = seeded_flat(cfg, meta["seeds"][name])
        if {k: float(np.asarray(v, np.float64).sum())
                for k, v in flat.items()} != checksums:
            raise PhaseFailed(f"{name}: the seeded weights are not the "
                              f"fixture's")
        return cfg, from_jax_params(flat, cfg, device="cuda", dtype=dtype)

    def record(eng, outs, whole):
        rec = {"tokens": [[int(t) for t in c.tokens] for c in outs],
               "reasons": [c.finish_reason for c in outs]}
        if whole:
            rec["stats"] = {k: int(v) for k, v in eng.stats().items()}
            rec["kv_stats"] = {k: float(v)
                               for k, v in eng.kv_stats().items()}
        return rec
    out = {}
    for name, kw in meta["configs"].items():
        cfg, model = weights(name, kw, meta["checksums"][name])
        prompt = torch.as_tensor(data[f"{name}|prompt"], device="cuda")
        embeds = torch.as_tensor(data[f"{name}|embeds"], device="cuda")
        with torch.no_grad():
            fwd, _ = T.forward(model, cfg, {"tokens": prompt,
                                            "embeds": embeds}, train=False)
        max_len = prompt.shape[1] + cfg.frontend_tokens \
            + meta["decode_steps"] + 3
        logits, cache, clen = T.prefill(model, prompt, max_len=max_len,
                                        embeds=embeds)
        steps = [logits]
        for tok in data[f"{name}|fed"]:
            logits, cache, clen = T.decode_step(
                model, torch.as_tensor(tok, device="cuda"), cache, clen)
            steps.append(logits)
        errs = {"forward": np.abs(fwd.float().cpu().numpy()
                                  - data[f"{name}|forward_logits"]).max(),
                "steps": np.abs(torch.stack(steps).cpu().numpy()
                                - data[f"{name}|logits"]).max()}
        errs = {k: float(v) for k, v in errs.items()}
        if not all(np.isfinite(v) and v <= tol for v in errs.values()):
            raise PhaseFailed(f"{name}: logits differ from JAX's: {errs}")
        specs = meta["workload"][name]

        def reqs():
            return [Request(i, np.asarray(r["prompt"], np.int32),
                            max_new_tokens=r["max_new"],
                            embeds=data[f"{name}|workload|embeds|{i}"])
                    for i, r in enumerate(specs)]
        want = json.loads(str(data[f"{name}|records"]))
        ml = meta["engine_max_len"]
        eng = Engine(cfg, model, EngineConfig(max_len=ml, admission="batch"),
                     device="cuda")
        got = {"batch": record(eng, eng.generate(reqs()), False)}
        for run, run_kw in (("slotted", {}), ("paged", dict(
                kv_layout="paged", block_size=meta["block_size"]))):
            eng = Engine(cfg, model, EngineConfig(
                max_len=ml, max_slots=3, admission="fifo", debug=True,
                **run_kw), device="cuda")
            got[run] = record(eng, eng.generate(reqs()), True)
        greedy = want["forward"]["tokens"]
        if got["batch"] != want["batch"] or any(
                got[run]["tokens"] != greedy
                or set(got[run]["reasons"]) != {"length"}
                for run in ("slotted", "paged")):
            raise PhaseFailed(f"{name}: the engine's tokens differ from "
                              f"JAX's forward loop and batch engine")
        if "slotted" in want and got["slotted"] != want["slotted"]:
            raise PhaseFailed(f"{name}: the slotted fifo record differs "
                              f"from JAX's")
        del model, cache
        cfg, model = weights(name, meta["narrow"][name],
                             meta["narrow_checksums"][name],
                             dtype=torch.float32)
        model.requires_grad_(True)
        pre = f"{name}|train|batch|"
        loss, _ = T.loss_fn(model, cfg, {
            k[len(pre):]: torch.as_tensor(data[k], device="cuda")
            for k in data.files if k.startswith(pre)})
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = to_flat(model, grad=True)
        pre = f"{name}|train|grads|"
        wg = {k[len(pre):]: data[k] for k in data.files if k.startswith(pre)}
        if sorted(grads) != sorted(wg):
            raise PhaseFailed(f"{name}: the gradient leaves differ from the "
                              f"fixture's")
        margin = min(tol - np.abs(w).max() * 2.0 ** -meta["grad_bits"]
                     - float(np.abs(grads[k] - w).max())
                     for k, w in wg.items())
        errs["loss"] = abs(float(loss.detach())
                           - float(data[f"{name}|train|loss"]))
        errs["grad"] = max(float(np.abs(grads[k] - w).max())
                           for k, w in wg.items())
        if errs["loss"] > tol or margin < 0:
            raise PhaseFailed(f"{name}: the training step differs from "
                              f"JAX's: {errs}")
        out[name] = {**errs, "runs": sorted(got)}
        del model
    free(torch)
    say(f"  (b) JAX enc-dec/VLM golden (fp32): {_fmt_err(out)} (tol {tol:g}; "
        f"gradients less the fixture's rounding); batch, slotted fifo and "
        f"paged fifo tokens equal JAX's forward loop and batch engine, "
        f"llava's slotted fifo record JAX's")
    return out


def _fmt_err(out: dict) -> str:
    return "; ".join(f"{k}: " + ", ".join(f"{n} {v:.3g}" for n, v in
                                          r.items() if n != "runs")
                     for k, r in out.items())


def encdec_fp32(torch, arch: str, n: int) -> dict:
    """fifo = batch held in fp32: ``arch`` with its decoder cut to
    ``ENCDEC_FP32_LAYERS`` layers in fp32 (the serve CLI's init, seed 0)
    on the serving workload under fifo and batch admission; the tokens
    must be equal. Run where the bf16 runs part, to show that they part
    at a rounding that depends on the batch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler.types import cache_rows
    cfg = dataclasses.replace(get_config(arch), n_layers=ENCDEC_FP32_LAYERS,
                              dtype="float32")
    model = T.init_params(cfg, 0, device="cuda")
    reqs = serve.synthetic_requests(cfg, n, ED_LEN, ED_NEW, 0)
    max_len = max(cache_rows(cfg, r) + r.max_new_tokens for r in reqs) + 8
    served = {adm: [c.tokens for c in Engine(cfg, model, EngineConfig(
        max_slots=8, max_len=max_len, admission=adm), device="cuda")
        .generate(reqs)] for adm in ("fifo", "batch")}
    del model
    free(torch)
    share = same_tokens("", served["fifo"], served["batch"], gate=False)
    say(f"  {cfg.name} fp32 ({ENCDEC_FP32_LAYERS} decoder layers) fifo vs "
        f"batch: tokens agree on {share:.3f} of the requests (must be 1)")
    if share != 1.0:
        raise PhaseFailed(f"{cfg.name}: fifo and batch differ in fp32")
    return {"agreement": share}


def split_at_ties(torch, np, model, reqs, fifo, batch) -> dict:
    """Where a bf16 fifo run parts from its batch run: for each parted
    request its first differing token, and there the two runs' choices'
    logit gap in a B=1 ``forward`` over the prompt (with its embeds) and
    the tokens both runs agree on, over the largest logit. Gate: every
    gap within ``TIE_GAP``, so the runs part where the two choices tie
    but for bf16 rounding that depends on the rows around them (cuBLAS
    picks its kernels by the row count); ``encdec_fp32`` then holds fifo
    = batch where nothing rounds to bf16."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    out = []
    for r, f, b in zip(reqs, fifo, batch):
        if f == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(f, b)) if x != y)
        toks = torch.as_tensor(np.concatenate([r.prompt, f[:t]])[None],
                               dtype=torch.int64, device="cuda")
        emb = None if r.embeds is None else torch.as_tensor(
            r.embeds[None], device="cuda")
        with torch.no_grad():
            logits, _ = T.forward(model, cfg, {"tokens": toks,
                                               "embeds": emb}, train=False)
        last = logits[0, -1, :cfg.vocab_size].float()
        out.append({"request": r.id, "first_differing_token": t,
                    "gap": (last[f[t]] - last[b[t]]).abs().item()
                    / last.abs().max().item(),
                    "forward_picks": int(last.argmax())})
    gaps = [o["gap"] for o in out]
    say(f"  {cfg.name} fifo vs batch (bf16) part in {len(out)} requests: "
        f"first differing tokens "
        f"{[o['first_differing_token'] for o in out]}, the two choices' "
        f"gaps there {[float(f'{g:.3g}') for g in gaps]} of the largest "
        f"logit (a tie <= {TIE_GAP:g})")
    if max(gaps) > TIE_GAP:
        raise PhaseFailed(f"{cfg.name}: fifo and batch part outside a tie")
    return {"parted": out}


def encdec_runs(torch, np, ops, calls, name, fa_ref, da_ref,
                scan_ref) -> dict:
    """(c) / (d): ``name``'s serve CLI fifo run at full width and depth,
    then batch and paged fifo on the CLI's weights and requests; every
    request by length, launches exact, paged = slotted, fifo = batch or
    (``encdec_fp32``) equal in fp32; the fifo run traced; (e) the model
    through the kernels against the plain versions; llava: a request
    whose frontend + prompt + new rows exceed ``max_len`` refused. Where
    fifo and batch part in bf16, ``split_at_ties`` shows where and
    ``encdec_fp32`` holds them equal in fp32."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.scheduler.types import cache_rows
    arch, n = ENCDEC_SERVE[name]
    cfg = get_config(arch)
    argv = ["--arch", arch, "--no-smoke", "--slots", "8", "--requests",
            str(n), "--prompt-len", str(ED_LEN), "--max-new", str(ED_NEW),
            "--policy", "fifo", "--device", "cuda"]
    out = {"fifo": checked_run(torch, ops, calls, cfg, f"{cfg.name} fifo",
                               lambda: serve.main(argv), ED_NEW, n)}
    free(torch)
    model = T.init_params(cfg, 0, device="cuda")    # the CLI's weights
    reqs = serve.synthetic_requests(cfg, n, ED_LEN, ED_NEW, 0)
    max_len = max(cache_rows(cfg, r) + r.max_new_tokens for r in reqs) + 8
    for label, kw in (("batch", dict(admission="batch")),
                      ("paged", dict(kv_layout="paged", block_size=BS))):
        out[label] = checked_run(
            torch, ops, calls, cfg, f"{cfg.name} {label}",
            lambda kw=kw: serve.run(Engine(cfg, model, EngineConfig(
                max_slots=8, max_len=max_len, **{"admission": "fifo", **kw}),
                device="cuda"), reqs), ED_NEW, n)
    tokens = {k: [c.tokens for c in out[k]["summary"]["completions"]]
              for k in ("fifo", "batch", "paged")}
    same_tokens(f"{cfg.name} paged vs slotted fifo", tokens["paged"],
                tokens["fifo"])
    out["fifo_batch_agreement"] = same_tokens("", tokens["fifo"],
                                              tokens["batch"], gate=False)
    say(f"  {cfg.name} fifo vs batch (bf16): tokens agree on "
        f"{out['fifo_batch_agreement']:.3f} of the requests")
    if tokens["fifo"] != tokens["batch"]:
        out["fifo_batch_split"] = split_at_ties(
            torch, np, model, reqs, tokens["fifo"], tokens["batch"])
    out["trace"] = traced_engine(torch, model, reqs, tokens["fifo"],
                                 f"{cfg.name} fifo", max_len)
    out["trace"]["untraced_wall_s"] = out["fifo"]["summary"]["wall_s"]
    b, plen, steps = ENCDEC_VS_PLAIN[name]
    embeds = torch.as_tensor(np.stack([r.embeds for r in reqs[:b]]),
                             device="cuda")
    out["vs_plain"] = model_vs_plain(torch, model, b, plen, steps, fa_ref,
                                     da_ref, scan_ref, embeds=embeds)
    if name == "llava":
        big = serve.synthetic_requests(cfg, 1, max_len - cfg.frontend_tokens
                                       - ED_NEW + 2, ED_NEW, 1)
        try:
            Engine(cfg, model, EngineConfig(max_slots=1, max_len=max_len),
                   device="cuda").generate(big)
        except ValueError as exc:
            if f"frontend ({cfg.frontend_tokens}) + prompt" not in str(exc):
                raise
            out["refused"] = str(exc)
            say(f"  {cfg.name}: refused, as it must be: {exc}")
        else:
            raise PhaseFailed(f"{cfg.name}: a request of {cfg.frontend_tokens}"
                              f" + {len(big[0].prompt)} + {ED_NEW} rows was "
                              f"served at max_len {max_len}")
    del model
    free(torch)
    if tokens["fifo"] != tokens["batch"]:
        out["fifo_batch_fp32"] = encdec_fp32(torch, arch, n)
    return out


def encdec_train_launches(cfg) -> int:
    """Flash launches of one training step, from the code: the forward
    once per encoder layer, decoder attention layer and cross-attention;
    with ``cfg.remat`` the encoder layers and the scanned periods (all
    the layers of these configs) again in the backward."""
    att = sum(k in ("attn", "attn_local") for k in cfg.layer_kinds)
    once = cfg.n_encoder_layers + att * (2 if cfg.n_encoder_layers else 1)
    assert not cfg.remainder_kinds
    return once * (2 if cfg.remat else 1)


def encdec_training(torch, ops) -> dict:
    """(f) ``repro_torch.launch.train.run`` on the copy task with the CLI's
    stub inputs, bf16 over fp32 masters, ``ENCDEC_TRAIN``'s models, 3
    steps. Gates: loss finite at every step, peak memory under
    ``PEAK_MEM_GB``, launches exact (``encdec_train_launches``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    out = {}
    for label, (arch, layers, shape) in ENCDEC_TRAIN.items():
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for k in TRAIN_KERNELS:
            ops[k].launches = 0
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        run = train.run(cfg, device="cuda", log_every=1, **shape,
                        **FAMILY_TRAIN_RUN)
        torch.cuda.synchronize()
        steps = FAMILY_TRAIN_RUN["steps"]
        want = dict.fromkeys(TRAIN_KERNELS, 0)
        want["flash_attention"] = encdec_train_launches(cfg) * steps
        front = cfg.frontend_tokens if cfg.arch_type == "vlm" else 0
        rec = {"config": f"{cfg.name} n_layers={cfg.n_layers} "
                         f"{shape['batch']} x ({front} + {shape['seq']})",
               "params": sum(p.numel() for p in run["model"].parameters()),
               "losses": [m["loss"] for m in run["metrics"]],
               "step_s": run["step_s"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts(ops), "want_launches": want}
        del run
        free(torch)
        out[label] = rec
        say(f"  (f) training {rec['config']} ({rec['params'] / 1e9:.3f} B "
            f"params): losses {[round(x, 4) for x in rec['losses']]}; step "
            f"times {[round(x, 4) for x in rec['step_s']]} s; peak memory "
            f"{rec['peak_mem_gb']:.2f} GB; launches {rec['launches']}")
        if not all(math.isfinite(v) for v in rec["losses"]):
            raise PhaseFailed(f"training {label}: a non-finite loss")
        if rec["peak_mem_gb"] >= PEAK_MEM_GB:
            raise PhaseFailed(f"training {label}: peak memory "
                              f"{rec['peak_mem_gb']:.2f} GB")
        if rec["launches"] != want:
            raise PhaseFailed(f"training {label}: launches "
                              f"{rec['launches']}, want {want}")
    return out


def phase_encdec(torch, np, ops, fa_ref, da_ref, scan_ref,
                 smi: str) -> dict:
    """The encoder-decoder and the vision frontend on the card; see the
    module docstring."""
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    free(torch)
    out = {"golden": golden_encdec(torch, np)}
    calls = Calls(T)
    try:
        for name in ENCDEC_SERVE:
            out[name] = encdec_runs(torch, np, ops, calls, name, fa_ref,
                                    da_ref, scan_ref)
    finally:
        calls.restore()
    out["train"] = encdec_training(torch, ops)
    for name in ENCDEC_SERVE:
        s, t = out[name]["fifo"]["summary"], out[name]["trace"]
        say(f"  {s['arch']} fifo on {smi}: wall {s['wall_s']:.4f} s, "
            f"{s['tok_per_s']:.2f} tok/s, TTFT p50 {s['ttft_p50_ms']:.2f} "
            f"ms, decode {s['decode_ms_per_step']:.3f} ms/step; traced busy "
            f"{t['device_busy_s']:.4f} s of {t['wall_s']:.4f} s, idle share "
            f"{t['idle_share']:.4f}")
    out["phase_s"] = time.perf_counter() - t0
    say(f"  phase 11 took {out['phase_s']:.1f} s")
    say("[11/16] the encoder-decoder and the vision frontend on the card: "
        "the JAX fixture within 1e-4 with JAX's tokens and records; "
        "seamless-m4t-medium and llava-next-mistral-7b full width/depth "
        "bf16 served fifo, batch and paged, launches exact, paged == "
        "slotted, fifo == batch (or equal in fp32), each within its limits "
        "of its plain-version run, an oversized vision request refused; "
        "both trained, losses finite, under 80 GB")
    return out


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

# (b): serving geometries whose dry-run resident bytes are held against
# the card: (arch, batch, max_len): phase 4's and phase 11's
RESIDENT_CASES = (("qwen2_1_5b", 8, SERVE_S), ("llava_next_mistral_7b", 8,
                                                LL_S))
RESIDENT_TOL = 0.01
# (c): qwen2-1.5b's prefill (B = 1, 512 tokens) and decode step (B = 8,
# every row at cache length SERVE_S - 1 of SERVE_S) timed against their
# dry-run bounds
FLOOR_PREFILL = (1, 512)
FLOOR_DECODE = (8, SERVE_S)
DRY_WORKERS = 8


class Built:
    """Records the configs and parameter counts of the models built on
    the card through ``init_params`` (the CLIs' and the phases' way)
    while installed, for phase 12's count gate."""

    def __init__(self, T):
        self.T, self.orig = T, T.init_params
        self.models = {}
        T.init_params = self._wrap

    def _wrap(self, cfg, *a, **kw):
        model = self.orig(cfg, *a, **kw)
        if model.device.type == "cuda":
            self.models[cfg] = sum(p.numel() for p in model.parameters())
        return model

    def restore(self):
        self.T.init_params = self.orig


def dry_combo(job) -> dict:
    """One arch x shape of the dry run on every mesh, in a worker
    process: its records, and whether it moved a launch counter or
    reached the card (it must do neither)."""
    arch, shape = job
    import torch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as sc
    from repro_torch.launch import dryrun
    wrappers = (fa.flash_attention, da.decode_attention,
                da.paged_decode_attention, sc.rglru_scan_fwd,
                sc.rglru_scan_bwd)
    before = [w.launches for w in wrappers]
    try:
        recs = dryrun.run_combo(arch, shape, meshes=tuple(dryrun.MESHES))
        err = None
    except Exception as exc:    # noqa: BLE001 — reported as FAIL
        recs, err = {}, repr(exc)
    return {"arch": arch, "shape": shape, "records": recs, "error": err,
            "launches_moved": [w.launches for w in wrappers] != before,
            "cuda_initialized": torch.cuda.is_initialized()}


def dry_run_all(built: dict) -> dict:
    """(a): every applicable arch x shape on every mesh, counted on the
    meta device in a pool of worker processes (the heaviest first)."""
    import multiprocessing as mp
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.shapes import SHAPES, shape_applicable
    from repro_torch.launch import dryrun, roofline
    jobs = [(a, s) for s in SHAPES for a in ARCH_IDS
            if shape_applicable(get_config(a), s)]
    jobs.sort(key=lambda j: (SHAPES[j[1]].kind != "train",
                             j[0] != "qwen3_moe_235b_a22b"))
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(DRY_WORKERS) as pool:
        results = pool.map(dry_combo, jobs, chunksize=1)
    wall = time.perf_counter() - t0
    data, fails = {}, []
    for r in results:
        tag = f"{r['arch']} x {r['shape']}"
        why = [w for w, bad in ((r["error"], r["error"]),
                                ("moved a launch counter",
                                 r["launches_moved"]),
                                ("reached the card", r["cuda_initialized"]))
               if bad]
        if why:
            fails.append(f"{tag}: {'; '.join(why)}")
            say(f"  FAIL {fails[-1]}")
            continue
        for rec in r["records"].values():
            data[(rec["arch"], rec["shape"], rec["mesh"])] = rec
        h = r["records"]["h100"]
        say(f"  OK   {tag}: flops {h['flops']:.4e}, bytes {h['bytes']:.4e}, "
            f"resident {h['resident_bytes'] / 1e9:.2f} GB, "
            f"{h['bottleneck']} [{h['count_s']:.1f} s]")
    if fails:
        raise PhaseFailed(f"phase 12: {len(fails)} dry-run failures: {fails}")
    say(roofline.table(data))
    for (arch, shape, mesh), rec in sorted(data.items()):
        c = rec.get("collectives")
        if c:
            say(f"  collectives {arch} x {shape} x {mesh}: "
                f"{rec['collective_bytes_per_device']:,} B a device "
                f"(all-gather {c['all-gather']:,}, reduce-scatter "
                f"{c['reduce-scatter']:,}, all-reduce {c['all-reduce']:,}; "
                f"{c['count']} calls), t_collective_s "
                f"{rec['t_collective_s']:.4f} (a bound at the links' "
                f"peaks), held {rec['resident_bytes_per_device']:,} B a "
                f"device")
    compared = {}
    for cfg, n in built.items():
        arch = next((a for a in ARCH_IDS if get_config(a) == cfg), None)
        if arch is None:
            continue            # a cut or retyped config: not in the run
        want = data[(arch, "decode_32k", "h100")]["tree_param_count"]
        if want != n:
            raise PhaseFailed(f"phase 12: {arch}'s dry-run tree counts "
                              f"{want:,} parameters, the card's model {n:,}")
        compared[arch] = n
    say(f"  dry run: {len(jobs)} combinations x {len(dryrun.MESHES)} meshes "
        f"in {wall:.1f} s ({DRY_WORKERS} workers), no launch counter moved; "
        f"tree counts equal the card's models: {compared}")
    return {"records": {"/".join(k): v for k, v in data.items()},
            "wall_s": wall, "tree_counts": compared}


def resident_vs_card(torch, arch: str, batch: int, max_len: int) -> dict:
    """(b): the dry run's resident bytes of a serving geometry against
    the growth of ``memory_allocated`` across building that model
    (``init_params``) and its cache on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    rec = dryrun.lower_combo(arch, InputShape(f"serve_{max_len}", max_len,
                                              batch, "decode"))
    free(torch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = T.init_params(get_config(arch), 0, device="cuda")
    cache = T.init_cache(model.cfg, batch, max_len, device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    del model, cache
    free(torch)
    rel = rec["resident_bytes"] / grown - 1
    say(f"  resident {arch} B={batch} max_len {max_len}: dry run "
        f"{rec['resident_bytes']:,} B, card {grown:,} B ({rel:+.4%})")
    if abs(rel) > RESIDENT_TOL:
        raise PhaseFailed(f"phase 12: {arch}'s resident bytes "
                          f"{rec['resident_bytes']:,} differ from the card's "
                          f"{grown:,} by {rel:+.2%} (limit "
                          f"{RESIDENT_TOL:.0%})")
    return {"dry_run_bytes": rec["resident_bytes"], "card_bytes": grown,
            "rel": rel}


def bound_floor(torch, smi: str) -> dict:
    """(c): qwen2-1.5b's prefill and decode step timed behind the spin
    kernel, and their device busy time in a trace of one call, against
    the dry run's bound for the same call; a time under its bound is an
    impossible reading. A step issues more kernels than the card's
    launch queue holds, so the events time the host's enqueue of the
    step once the queue fills; the trace's busy time is the card's
    alone."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2_1_5b")
    model = T.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    (pb, ps), (db, ds) = FLOOR_PREFILL, FLOOR_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (pb, ps), generator=gen,
                           device="cuda", dtype=torch.int32)
    cache = T.init_cache(cfg, db, ds, device="cuda")
    token = torch.randint(0, cfg.vocab_size, (db,), generator=gen,
                          device="cuda", dtype=torch.int32)
    cache_len = torch.full((db,), ds - 1, dtype=torch.int32, device="cuda")
    calls = {
        "prefill": (InputShape(f"prefill_{ps}", ps, pb, "prefill"),
                    lambda: T.prefill(model, tokens, max_len=ps)),
        "decode": (InputShape(f"decode_{ds}", ds, db, "decode"),
                   lambda: T.decode_step(model, token, cache, cache_len))}
    out = {}
    for name, (shape, fn) in calls.items():
        rec = dryrun.lower_combo("qwen2_1_5b", shape)
        floor_ms = max(rec["t_compute_s"], rec["t_memory_s"]) * 1e3
        ms = cuda_ms(torch, fn, iters=10, warmup=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_ms = trace_summary(torch, prof, wall, f"{name} qwen2-1.5b",
                                3)["device_busy_s"] * 1e3
        say(f"  {name} qwen2-1.5b {shape.global_batch} x {shape.seq_len}: "
            f"{ms:.4f} ms by events, {busy_ms:.4f} ms busy in the trace; "
            f"bound {floor_ms:.4f} ms ({rec['bottleneck'][2:-2]}: "
            f"{rec['flops']:.4e} FLOP, {rec['bytes']:.4e} B): "
            f"{floor_ms / ms:.4f} / {floor_ms / busy_ms:.4f} of the bound "
            f"({smi})")
        for what, t in (("took", ms), ("kept the card busy", busy_ms)):
            if t < floor_ms:
                raise PhaseFailed(f"phase 12: qwen2-1.5b's {name} {what} "
                                  f"{t:.4f} ms, under its bound "
                                  f"{floor_ms:.4f} ms: an impossible "
                                  f"reading")
        out[name] = {"ms": ms, "busy_ms": busy_ms, "bound_ms": floor_ms,
                     "share": floor_ms / ms, "busy_share": floor_ms / busy_ms,
                     "bottleneck": rec["bottleneck"], "flops": rec["flops"],
                     "bytes": rec["bytes"]}
    del model, cache
    free(torch)
    return out


def examples_on_card(torch) -> dict:
    """(d): the last two examples at their default sizes on the card."""
    import runpy
    out = {}
    for name in ("torch_quickstart", "torch_train_small"):
        t0 = time.perf_counter()
        out[name] = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                                   run_name="example")["main"]([])
        out[name]["wall_s"] = time.perf_counter() - t0
    q, t = out["torch_quickstart"], out["torch_train_small"]
    if q["best_pp"] != 3 or len(q["tokens"]) != 8 \
            or q["finish_reason"] != "length":
        raise PhaseFailed(f"phase 12: quickstart chose pp{q['best_pp']} "
                          f"(the paper's pp3) and served {len(q['tokens'])} "
                          f"tokens ({q['finish_reason']})")
    if not (t["learned"] and t["restored_exact"] and len(t["tokens"]) == 12):
        raise PhaseFailed(f"phase 12: train-small loss {t['first']:.4f} -> "
                          f"{t['last']:.4f} (LEARNED below 0.8x: "
                          f"{t['learned']}), restore exact "
                          f"{t['restored_exact']}, {len(t['tokens'])} tokens")
    say(f"  examples: quickstart pp{q['best_pp']}, {len(q['tokens'])} tokens "
        f"({q['wall_s']:.1f} s); train-small loss {t['first']:.4f} -> "
        f"{t['last']:.4f} (LEARNED), restore bit for bit, "
        f"{len(t['tokens'])} tokens sampled ({t['wall_s']:.1f} s)")
    for rec in out.values():
        rec.pop("probs", None)
    return out


def phase_dryrun(torch, built: dict, smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"dry_run": dry_run_all(built)}
    out["resident"] = {arch: resident_vs_card(torch, arch, b, s)
                       for arch, b, s in RESIDENT_CASES}
    out["floor"] = bound_floor(torch, smi)
    out["examples"] = examples_on_card(torch)
    out["wall_s"] = time.perf_counter() - t0
    say(f"[12/16] dry run: {len(out['dry_run']['records'])} records, no "
        f"FAIL, the collective terms of the train and serving shapes the "
        f"sharded steps run; resident bytes within {RESIDENT_TOL:.0%} of "
        f"the card; "
        f"prefill and decode at or above their bounds; both examples pass "
        f"({out['wall_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

# the sharded run's geometry: phase 5's (global batch 2 x 4,096 on the
# copy task in 2 microbatches, so that each kernel call has phase 2's
# training shape), 2 steps
SHARD_RUN = dict(steps=2, batch=2, seq=TRAIN_S, microbatches=2, lr=1e-3)
# where the 1 x 1 sharded step parts from the unsharded one (it should
# not: the same kernels and operations): losses and gradient norms
# relative, masters absolute (a quarter of lr, as the CPU tests hold
# AdamW's eps regime)
SHARD_TOL = {"loss": 1e-6, "grad_norm": 1e-6, "masters": 2.5e-4}
RESIDENT_SHARD_TOL = 0.01
# the 4-card run on a 2 x 2 mesh: recurrentgemma-9b cut to (a)'s 5
# layers on (a)'s batches (in one microbatch: each row holds the same
# number of labelled tokens, so the loss is (a)'s), then whole
MESH4 = dict(data=2, model=2, steps=SHARD_RUN["steps"],
             batch=SHARD_RUN["batch"], seq=SHARD_RUN["seq"],
             microbatches=1, lr=SHARD_RUN["lr"], timeout_s=900)
# the cut model on 2 x 2 against (a)'s unsharded run, relative: bf16
# products and sums over other splits (phase 5's kernels-vs-plain loss
# limit)
MESH4_TOL = 1e-2


def shard_batches(cfg, np, n: int, batch: int, seq: int) -> list:
    from repro_torch.runtime import data
    gen = data.copy_task_batches(batch, seq, cfg.vocab_size, seed=0)
    return [next(gen) for _ in range(n)]


def train_steps(torch, step, model, opt, batches) -> tuple:
    """Run ``step`` over ``batches``: (model, opt, metrics as floats per
    step, seconds per step, launches per step)."""
    hist, secs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        hist.append({k: float(v) for k, v in m.items()})
        secs.append(time.perf_counter() - t0)
    return model, opt, hist, secs


def one_rank_sharded(torch, np, ops, smi: str) -> dict:
    """(a): the 1 x 1 NCCL mesh against the unsharded step."""
    import copy

    import torch.distributed as dist
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    from repro_torch.sharding.rules import shard_params
    cfg = full_width_config()
    oc = optim.AdamWConfig(lr=SHARD_RUN["lr"], warmup_steps=1,
                           total_steps=SHARD_RUN["steps"])
    batches = shard_batches(cfg, np, SHARD_RUN["steps"], SHARD_RUN["batch"],
                            SHARD_RUN["seq"])
    want_n = train_launches(cfg, SHARD_RUN["microbatches"])
    tmp = tempfile.mkdtemp(prefix="shard")
    mesh_lib.init_world(0, 1, str(Path(tmp) / "store"), device="cuda")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device="cuda")
        free(torch)
        full = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
        twin = copy.deepcopy(full)
        full.requires_grad_(True)
        step = make_train_step(cfg, oc,
                               microbatches=SHARD_RUN["microbatches"])
        before = counts(ops)
        full, opt, plain_hist, plain_s = train_steps(
            torch, step, full, optim.init(full), batches)
        plain_n = {k: (counts(ops)[k] - before[k]) // SHARD_RUN["steps"]
                   for k in before}
        plain_after = {n: p.detach().to("cpu", copy=True)
                       for n, p in full.named_parameters()}
        del full, opt, step
        free(torch)
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = shard_params(twin, mesh)
        model.requires_grad_(True)
        step = make_train_step(cfg, oc, mesh,
                               microbatches=SHARD_RUN["microbatches"])
        mesh.counts.reset()
        for k in TRAIN_KERNELS:
            ops[k].launches = 0
        model, opt, hist, secs = train_steps(torch, step, model,
                                             optim.init(model), batches)
        torch.cuda.synchronize()
        launches = counts(ops)
        comm = mesh.counts.record()
        held = torch.cuda.memory_allocated() - held0
        peak = torch.cuda.max_memory_allocated() - held0
        parts = first_parting(torch, plain_hist, hist, plain_after, model)
        del model, opt, twin, plain_after
        free(torch)
    finally:
        torch.use_deterministic_algorithms(det)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rec = dryrun.count_sharded(cfg, InputShape(
        "shard13", SHARD_RUN["seq"], SHARD_RUN["batch"], "train"),
        {"data": 1, "model": 1}, microbatches=SHARD_RUN["microbatches"])
    dry = rec["resident_bytes_per_device"]
    rel = held / dry - 1
    per_step = {k: launches[k] // SHARD_RUN["steps"] for k in launches}
    out = {"config": f"{cfg.name} n_layers={cfg.n_layers} bf16 over fp32 "
                     f"masters, 1x1 NCCL mesh",
           "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "plain_losses": [m["loss"] for m in plain_hist],
           "plain_grad_norms": [m["grad_norm"] for m in plain_hist],
           "step_s": secs, "plain_step_s": plain_s,
           "launches": launches, "launches_per_step": per_step,
           "plain_launches_per_step": plain_n, "comm": comm,
           "held_bytes": held, "dry_run_bytes": dry, "resident_rel": rel,
           "activation_peak_bytes": peak - held, "parts": parts,
           "nvidia_smi": smi}
    say(f"  (a) {out['config']}: losses {out['losses']} (unsharded "
        f"{out['plain_losses']}), grad norms {out['grad_norms']}; "
        f"{'bit for bit' if parts is None else f'first parting {parts}'}; "
        f"step {[round(x, 3) for x in secs]} s (unsharded "
        f"{[round(x, 3) for x in plain_s]} s); launches a step {per_step} "
        f"(unsharded {plain_n}); collectives {comm['count']} calls, "
        f"{comm['total']} B; held {held:,} B against the dry run's "
        f"{dry:,} B ({rel:+.4%}), activations' peak {peak - held:,} B "
        f"[{smi}]")
    if parts is not None and not parts["within"]:
        raise PhaseFailed(f"phase 13: the 1x1 sharded step parts from the "
                          f"unsharded one beyond SHARD_TOL: {parts}")
    if per_step != plain_n or per_step != want_n or any(
            launches[k] != per_step[k] * SHARD_RUN["steps"]
            for k in launches):
        raise PhaseFailed(f"phase 13: sharded launches {launches}, unsharded "
                          f"{plain_n} a step, want {want_n} a step")
    if comm["count"] or comm["total"]:
        raise PhaseFailed(f"phase 13: a 1x1 mesh issued collectives: {comm}")
    if abs(rel) > RESIDENT_SHARD_TOL:
        raise PhaseFailed(f"phase 13: held {held:,} B vs the dry run's "
                          f"{dry:,} B ({rel:+.2%})")
    if not all(map(math.isfinite, out["losses"])):
        raise PhaseFailed(f"phase 13: losses {out['losses']}")
    return out


def first_parting(torch, plain_hist, hist, plain_after, model):
    """None when the sharded run equals the unsharded one bit for bit;
    else the first metric or master leaf that parts, by how much, and
    whether every difference is within ``SHARD_TOL``."""
    first, within = None, True
    for i, (a, b) in enumerate(zip(plain_hist, hist)):
        for k in ("loss", "grad_norm"):
            if a[k] != b[k]:
                rel = abs(a[k] - b[k]) / abs(a[k])
                first = first or f"step {i} {k}: rel {rel:.3e}"
                within &= rel <= SHARD_TOL[k]
    for name, p in model.named_parameters():
        # one leaf at a time onto the card: no second host copy
        w = plain_after[name].to(p.device)
        got = p.detach()
        if not torch.equal(got, w):
            d = float((got - w).abs().max())
            first = first or f"{name}: max |diff| {d:.3e}"
            within &= d <= SHARD_TOL["masters"]
    return None if first is None else {"first": first, "within": within}


def mesh_rank(rank: int, world: int, store: str, queue) -> None:
    """One rank of (b)'s 2 x 2 NCCL mesh: recurrentgemma-9b cut to (a)'s
    5 layers on (a)'s batches, then whole (38 layers), each cut into its
    shards and trained 2 steps; each rank puts its record on ``queue``:
    metrics, step times, memory and the last step's collectives."""
    import numpy as np
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    from repro_torch.sharding.rules import shard_params
    out = {"rank": rank}
    try:
        mesh_lib.init_world(rank, world, store, device="cuda")
        mesh = mesh_lib.make_debug_mesh(MESH4["data"], MESH4["model"])
        for name, cfg in (("cut", full_width_config()),
                          ("whole", get_config("recurrentgemma_9b"))):
            full = T.init_params(cfg, 0, device=mesh.device,
                                 dtype=torch.float32)
            model = shard_params(full, mesh)
            del full
            torch.cuda.empty_cache()
            model.requires_grad_(True)
            torch.cuda.synchronize()
            held0 = torch.cuda.memory_allocated() - sum(
                p.numel() * 4 for p in model.parameters())
            torch.cuda.reset_peak_memory_stats()
            oc = optim.AdamWConfig(lr=MESH4["lr"], warmup_steps=1,
                                   total_steps=MESH4["steps"])
            step = make_train_step(cfg, oc, mesh,
                                   microbatches=MESH4["microbatches"])
            batches = shard_batches(cfg, np, MESH4["steps"], MESH4["batch"],
                                    MESH4["seq"])
            opt = optim.init(model)
            model, opt, hist, secs = train_steps(torch, step, model, opt,
                                                 batches[:-1])
            mesh.counts.reset()
            model, opt, last, last_s = train_steps(torch, step, model, opt,
                                                   batches[-1:])
            torch.cuda.synchronize()
            out[name] = {"losses": [m["loss"] for m in hist + last],
                         "grad_norms": [m["grad_norm"] for m in hist + last],
                         "step_s": secs + last_s,
                         "held": torch.cuda.memory_allocated() - held0,
                         "peak": torch.cuda.max_memory_allocated() - held0,
                         "comm": mesh.counts.record()}
            del model, opt, step
            torch.cuda.empty_cache()
        torch.distributed.destroy_process_group()
    except Exception as exc:     # noqa: BLE001 — reported by the parent
        out["error"] = repr(exc)
    queue.put(out)


def four_card_sharded(torch, smi: str, plain: dict) -> dict:
    """(b): the 2 x 2 NCCL mesh over 4 cards, when there are 4: the cut
    model against (a)'s unsharded run (``MESH4_TOL``), each model's
    collectives against the dry run's count of the same step kind by
    kind, memory against its bytes a device."""
    n = torch.cuda.device_count()
    if n < MESH4["data"] * MESH4["model"]:
        say(f"  (b) mesh 2x2: not run ({n} card)")
        return {"run": False, "cards": n}
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    recs, wall = spawn_ranks(mesh_rank, (), MESH4["data"] * MESH4["model"],
                             MESH4["timeout_s"], "phase 13 (b)")
    out = {"run": True, "cards": n, "wall_s": wall, "ranks": recs}
    axes = {"data": MESH4["data"], "model": MESH4["model"]}
    for name, cfg in (("cut", full_width_config()),
                      ("whole", get_config("recurrentgemma_9b"))):
        dry = dryrun.count_sharded(cfg, InputShape(
            "mesh4", MESH4["seq"], MESH4["batch"], "train"), axes,
            microbatches=MESH4["microbatches"])
        r0 = recs[0][name]
        out[name] = {"dry_run": {k: dry[k] for k in (
            "resident_bytes_per_device", "collective_bytes_per_device",
            "t_collective_s", "collectives")}}
        say(f"  (b) {name} recurrentgemma-9b ({cfg.n_layers} layers) on a "
            f"2x2 NCCL mesh: losses {r0['losses']}, grad norms "
            f"{r0['grad_norms']}, step {[round(x, 3) for x in r0['step_s']]}"
            f" s; per card held {[r[name]['held'] for r in recs]} B and "
            f"peak {[r[name]['peak'] for r in recs]} B against the dry "
            f"run's {dry['resident_bytes_per_device']:,} B a device; a "
            f"step's collectives {r0['comm']['total']:,} B a card (dry run "
            f"{dry['collective_bytes_per_device']:,} B, t_collective_s "
            f"{dry['t_collective_s']:.4f} bound) [{smi}]")
        for r in recs:
            if r[name]["comm"] != dry["collectives"]:
                raise PhaseFailed(f"phase 13 (b) {name}: rank {r['rank']}'s "
                                  f"collectives {r[name]['comm']} differ "
                                  f"from the dry run's "
                                  f"{dry['collectives']}")
            if not all(map(math.isfinite, r[name]["losses"])):
                raise PhaseFailed(f"phase 13 (b) {name}: losses "
                                  f"{r[name]['losses']}")
    for k in ("losses", "grad_norms"):
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(recs[0]["cut"][k], plain[k]))
        out["cut"][f"{k}_rel"] = rel
        if rel > MESH4_TOL:
            raise PhaseFailed(f"phase 13 (b): the 2x2 cut model's {k} "
                              f"{recs[0]['cut'][k]} part from the unsharded "
                              f"{plain[k]} by {rel:.3e} (limit {MESH4_TOL})")
    say(f"  (b) the cut model against (a)'s unsharded run: losses within "
        f"{out['cut']['losses_rel']:.3e}, grad norms within "
        f"{out['cut']['grad_norms_rel']:.3e} relative ({wall:.1f} s in "
        f"all)")
    return out


def phase_sharded(torch, np, ops, smi: str) -> dict:
    t0 = time.perf_counter()
    one = one_rank_sharded(torch, np, ops, smi)
    out = {"one_rank": one, "mesh4": four_card_sharded(
        torch, smi, {"losses": one["plain_losses"],
                     "grad_norms": one["plain_grad_norms"]})}
    out["wall_s"] = time.perf_counter() - t0
    agree = "equals" if one["parts"] is None else "is within SHARD_TOL of"
    say(f"[13/16] sharded training: the 1x1 NCCL mesh {agree} "
        f"the unsharded step, launches equal, held bytes within "
        f"{RESIDENT_SHARD_TOL:.0%} of the dry run's, no collective; "
        f"2x2 {'run' if out['mesh4']['run'] else 'not run'} "
        f"({out['wall_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------

# (a): the sharded serving steps on a 1 x 1 NCCL mesh against the
# unsharded ones, at phase 4's geometry: (name, prompts, prompt length,
# max_len, decode steps); recurrentgemma-9b at phase 5's cut
SERVE14 = (("qwen2-1.5b", 8, 512, SERVE_S, 31),
           ("recurrentgemma-9b", 8, 512, SERVE_S, 31))
SERVE14_KERNELS = ("flash_attention", "decode_attention", "rglru_scan_fwd")
RESIDENT_SERVE_TOL = 0.01
# (b): the decode kernel's partials over 2 and 4 row ranges of one cache
# at qwen2-1.5b's heads, merged by combine_partials, against the kernel
# over the whole cache and the plain version: lengths that leave the
# last ranges of most sequences empty, one sequence empty throughout
SPLIT_S = 32768
SPLIT_LENS = [0, 1, 4095, 8192, 8193, 16384, 30000, 32768]
SPLIT_SHAPE = (12, 2, 128, SPLIT_S, SPLIT_LENS)
SPLIT_TOL = {"bfloat16": 2e-3, "float32": 2e-5}
# (c): with 4 cards, a 2 x 2 mesh: qwen2-1.5b at (a)'s batch (its cache by
# kv heads), at one 4,096-token prompt in a 32,768-row cache (the
# sequence over ("data", "model"): long_500k's layout), and
# recurrentgemma-9b whole (38 layers; its rings by sequence over
# "model"), each fed the greedy tokens of the one-card unsharded run;
# the same run in fp32 on one card, fed those tokens, is the control
# that says how far bf16 alone moves the logits
MESH14 = dict(steps=8, timeout_s=900)
MESH14_RUNS = (("qwen2-1.5b", 8, 512, SERVE_S),
               ("qwen2-1.5b-long", 1, 4096, 32768),
               ("recurrentgemma-9b-whole", 8, 512, SERVE_S))
# a mesh's bf16 run against the fp32 control: its logits' distance from
# the one-card fp32 run at most this factor times the one-card bf16
# run's own distance from it (PR 24's three 2 x 2 runs read 1.094,
# 1.026 and 1.027 of it; bf16 alone moves the one-card logits by
# 1.0-2.2e-2 of the largest, beyond the 1e-2 limit it replaces)
MESH_BF16_FACTOR = 1.25
# an mLSTM config's bf16 greedy choices on a mesh: at most this many
# times those its one-card run parts at a data rank's rows
# (``rows_witness``)
WITNESS_FACTOR = 2.0
# the same runs computed in fp32 on the mesh against the one-card fp32
# run: only the order of the sums over "model" and the ranks' rows
# differs (the JAX fixtures' fp32 limit)
MESH14_FP32_TOL = 1e-4


def serve_config(name: str):
    """A sharded serving run's config by its name (phases 14 to 16)."""
    from repro_torch.configs import get_config
    if name in FAM16:
        return get_config(FAM16[name][0])
    if name.startswith("qwen2-1.5b"):
        return get_config("qwen2_1_5b")
    if name == "recurrentgemma-9b":
        return full_width_config()
    if name.startswith("recurrentgemma"):
        return get_config("recurrentgemma_9b")
    return moe15_config(name)


def serve14_prompts(torch, cfg, b: int, s: int, device):
    """The run's prompts, drawn on the host from one seed: equal on every
    card."""
    gen = torch.Generator().manual_seed(14)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32).to(device)


def frontend_embeds(torch, cfg, b: int, s: int, device):
    """A frontend config's ``embeds`` for ``b`` prompts of ``s`` tokens,
    N(0, 1) drawn on the host from one seed: the vision frontend's rows,
    or an audio source of one frame a token; None without a frontend."""
    from repro_torch.models import transformer as T
    if not cfg.frontend:
        return None
    gen = torch.Generator().manual_seed(16)
    return torch.randn((b, T.frontend_prefix(cfg) or s, cfg.frontend_dim),
                       generator=gen).to(device)


def with_embeds(tokens, embeds) -> dict:
    return {"tokens": tokens} if embeds is None else \
        {"tokens": tokens, "embeds": embeds}


def serve_launches(cfg, cache, mesh, steps: int) -> dict:
    """A sharded prefill and ``steps`` serve steps' launches, from the
    code: flash once a prefill per attention layer (an encoder-decoder's
    also per encoder layer and per cross-attention), the decode kernel
    once a step per attention layer (and cross-attention), of them with
    ``return_lse`` those whose cache the prefill placed with the sequence
    cut over more than one rank, and the scan's forward once per rglru
    layer."""
    from repro_torch.sharding.rules import seq_axes
    n = kind_counts(cfg)
    att = n["attn"] + n["attn_local"]
    att += att if cfg.n_encoder_layers else 0
    seq = sum(1 for c in cache for k in ("k", "cross_k") if k in c and
              mesh.size(seq_axes(c[k].shard_spec)) > 1)
    return {"flash_attention": att + cfg.n_encoder_layers,
            "decode_attention": att * steps,
            "rglru_scan_fwd": n["rglru"],
            "decode_attention_lse": seq * steps}


def serve_drive(torch, prefill, step, prompts, steps: int, fed=None,
                front: int = 0) -> dict:
    """``prefill(prompts)`` then ``steps`` calls of ``step(token, cache,
    cache_len)`` with the global batch's tokens and lengths (``front``
    rows of a vision frontend ahead of each prompt): the greedy token of
    the last logits, or ``fed[i]``. Returns the logits of every call and
    the tokens fed (on the host), the last cache and the seconds of the
    prefill and of each step."""
    b, s = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, _ = prefill(prompts)
    torch.cuda.synchronize()
    out = {"logits": [logits.cpu()], "tokens": [],
           "prefill_s": time.perf_counter() - t0, "step_s": []}
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32) if fed is None \
            else fed[i].to(prompts.device)
        out["tokens"].append(tok.cpu())
        clen = torch.full((b,), front + s + i, dtype=torch.int32,
                          device=prompts.device)
        t0 = time.perf_counter()
        logits, cache, _ = step(tok, cache, clen)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["logits"].append(logits.cpu())
    out["cache"] = cache
    return out


def host_cache(cache) -> list:
    return [{k: t.cpu() for k, t in c.items()} for c in cache]


def one_rank_serving(torch, ops, smi: str) -> dict:
    """(a): each model's sharded prefill and serve steps on the 1 x 1
    NCCL mesh against ``T.prefill`` / ``T.decode_step`` on its compute
    copy."""
    import copy

    import torch.distributed as dist
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainstep import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.kernels import _build
    from repro_torch.sharding.rules import shard_params
    tmp = tempfile.mkdtemp(prefix="serve14")
    mesh_lib.init_world(0, 1, str(Path(tmp) / "store"), device="cuda")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device="cuda")
        for name, b, s, max_len, steps in SERVE14:
            cfg = serve_config(name)
            prompts = serve14_prompts(torch, cfg, b, s, "cuda")
            free(torch)
            full = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
            twin = T.to_compute_dtype_(copy.deepcopy(full), cfg)
            before = {k: ops[k].launches for k in SERVE14_KERNELS}
            plain = serve_drive(
                torch, lambda t: T.prefill(twin, t, max_len=max_len),
                lambda tok, c, n: T.decode_step(twin, tok, c, n), prompts,
                steps)
            plain_n = {k: ops[k].launches - before[k]
                       for k in SERVE14_KERNELS}
            plain_cache = host_cache(plain.pop("cache"))
            del twin
            free(torch)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() - sum(
                p.numel() * 4 for p in full.parameters())
            local = shard_params(full, mesh)
            del full
            free(torch)
            pre = make_prefill_step(cfg, max_len=max_len, mesh=mesh)
            srv = make_serve_step(cfg, mesh)
            mesh.counts.reset()
            _build.reset_launches(*(ops[k] for k in SERVE14_KERNELS))
            run = serve_drive(torch, lambda t: pre(local, {"tokens": t}),
                              lambda tok, c, n: srv(local, c, tok, n),
                              prompts, steps)
            torch.cuda.synchronize()
            launches = {k: ops[k].launches for k in SERVE14_KERNELS}
            lse_n = ops["decode_attention"].lse_launches
            comm = mesh.counts.record()
            held = torch.cuda.memory_allocated() - base
            cache = host_cache(run.pop("cache"))
            del local
            free(torch)
            dry = dryrun.count_sharded(cfg, InputShape(
                "serve14", max_len, b, "decode"), {"data": 1, "model": 1})
            rel = held / dry["resident_bytes_per_device"] - 1
            same = {"logits": all(torch.equal(a, w) for a, w in
                                  zip(run["logits"], plain["logits"])),
                    "tokens": all(torch.equal(a, w) for a, w in
                                  zip(run["tokens"], plain["tokens"])),
                    "cache": all(torch.equal(c[k], w[k]) for c, w in
                                 zip(cache, plain_cache) for k in w)}
            rec = {"config": f"{cfg.name} n_layers={cfg.n_layers} bf16 over "
                             f"fp32 masters, 1x1 NCCL mesh",
                   "batch": b, "prompt": s, "max_len": max_len,
                   "steps": steps, "same": same, "launches": launches,
                   "plain_launches": plain_n, "lse_launches": lse_n,
                   "comm": comm, "held_bytes": held,
                   "dry_run_bytes": dry["resident_bytes_per_device"],
                   "resident_rel": rel, "prefill_s": run["prefill_s"],
                   "step_s": run["step_s"], "plain_prefill_s":
                   plain["prefill_s"], "plain_step_s": plain["step_s"],
                   "nvidia_smi": smi}
            out[name] = rec
            say(f"  (a) {rec['config']}, {b} x {s} tokens, max_len "
                f"{max_len}, prefill + {steps} steps: logits, tokens and "
                f"cache {same} bit for bit against the unsharded steps; "
                f"return_lse launches {lse_n} (every row on one rank); "
                f"prefill {run['prefill_s']:.3f} s (unsharded "
                f"{plain['prefill_s']:.3f} s), step median "
                f"{sorted(run['step_s'])[steps // 2] * 1e3:.2f} ms "
                f"(unsharded {sorted(plain['step_s'])[steps // 2] * 1e3:.2f}"
                f" ms); launches {launches} (unsharded {plain_n}); "
                f"collectives {comm['count']} calls, {comm['total']} B; held "
                f"{held:,} B against the dry run's "
                f"{dry['resident_bytes_per_device']:,} B ({rel:+.4%}) [{smi}]")
            if not all(same.values()):
                raise PhaseFailed(f"phase 14 (a) {name}: the 1x1 sharded "
                                  f"serving steps part from the unsharded "
                                  f"ones: {same}")
            if launches != plain_n or not launches["flash_attention"] \
                    or not launches["decode_attention"] or lse_n \
                    or (cfg.layer_kinds.count("rglru") > 0) \
                    != (launches["rglru_scan_fwd"] > 0):
                raise PhaseFailed(f"phase 14 (a) {name}: sharded launches "
                                  f"{launches}, unsharded {plain_n}")
            if comm["count"] or comm["total"]:
                raise PhaseFailed(f"phase 14 (a): a 1x1 mesh issued "
                                  f"collectives: {comm}")
            if abs(rel) > RESIDENT_SERVE_TOL:
                raise PhaseFailed(f"phase 14 (a) {name}: held {held:,} B vs "
                                  f"the dry run's "
                                  f"{dry['resident_bytes_per_device']:,} B "
                                  f"({rel:+.2%})")
            del run, plain, cache, plain_cache
    finally:
        torch.use_deterministic_algorithms(det)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def split_by_hand(torch, da_ops, da_ref, smi: str) -> dict:
    """(b): the flash-decode combine on one card: the decode kernel with
    ``return_lse`` over 2 and 4 row ranges of a cache, each range with
    its local lengths (0 where a sequence does not reach it), merged by
    ``sharding.combine_partials``, against the kernel over the whole
    cache and against the plain version; then the lse call and the
    default call timed at that shape."""
    from repro_torch.sharding import combine_partials
    h, hk, d, s, lens = SPLIT_SHAPE
    b = len(lens)
    gen = torch.Generator(device="cuda").manual_seed(14)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = {}
    for dtn, tol in SPLIT_TOL.items():
        dt = getattr(torch, dtn)
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dt)
        kc = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
        whole, whole_lse = da_ops.decode_attention(q, kc, vc, lengths,
                                                   return_lse=True)
        plain, _ = da_ref.decode_attention_ref(q, kc, vc, lengths,
                                               return_lse=True)
        for parts in (2, 4):
            rows = s // parts
            o_parts, lse_parts, empty = [], [], 0
            for r in range(parts):
                local = (lengths - r * rows).clamp(0, rows).to(torch.int32)
                empty += int((local == 0).sum())
                o, lse = da_ops.decode_attention(
                    q, kc[:, r * rows:(r + 1) * rows].contiguous(),
                    vc[:, r * rows:(r + 1) * rows].contiguous(), local,
                    return_lse=True)
                o_parts.append(o)
                lse_parts.append(lse)
            got = combine_partials(torch.stack(o_parts),
                                   torch.stack(lse_parts))
            err_k, ok_k = err_vs(torch, got, whole, tol)
            err_p, ok_p = err_vs(torch, got, plain, tol)
            lse = torch.logsumexp(torch.stack(lse_parts), dim=0)
            err_l, ok_l = lse_err(torch, lse, whole_lse, LSE_TOL[dtn])
            out[f"{dtn}/{parts}"] = {"vs_kernel": err_k, "vs_plain": err_p,
                                     "lse": err_l, "empty_ranges": empty}
            say(f"  (b) {parts} row ranges of B={b} S={s} H={h}/{hk} D={d} "
                f"{dtn} ({empty} empty (sequence, range) pairs) combined: "
                f"max |err| {err_k:.3g} against the kernel over the whole "
                f"cache, {err_p:.3g} against the plain version (tol {tol:g}); "
                f"the ranges' log-sum-exp {err_l:.3g} from the whole's")
            if not (ok_k and ok_p and ok_l) or torch.isnan(got).any():
                raise PhaseFailed(f"phase 14 (b): the combine of {parts} "
                                  f"ranges in {dtn} parts from the whole "
                                  f"cache: {out[f'{dtn}/{parts}']}")
        del q, kc, vc, whole, plain, o_parts
        free(torch)
    gen_t = torch.Generator(device="cuda").manual_seed(15)

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen_t, device="cuda").to(dt)
    out["timed"] = {"default": time_decode(torch, da_ops, da_ref, rnd,
                                           SPLIT_SHAPE),
                    "lse": time_decode(torch, da_ops, da_ref, rnd,
                                       SPLIT_SHAPE, lse=True)}
    for k, m in out["timed"].items():
        say(f"  (b) decode {k} call ({m['shape']}): {m['ms']:.4f} ms kernel, "
            f"{m['plain_ms']:.4f} ms plain, {m['library_ms']:.4f} ms SDPA, "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}) [{smi}]")
    free(torch)
    return out


def mesh_variants(name: str):
    """A mesh run's two runs of a model: (tag, config, the one-card run
    it is held against): the config's bf16 compute against the one-card
    bf16 run, and the same weights computed in fp32 against the one-card
    fp32 run."""
    from dataclasses import replace
    cfg = serve_config(name)
    return ((name, cfg, "logits"),
            (f"{name}-fp32", replace(cfg, dtype="float32"), "fp32"))


def mesh_serving_rank(rank: int, world: int, store: str, refs: str,
                      shape: tuple, runs: tuple, queue) -> None:
    """One rank of a ``shape`` (data, model) NCCL mesh serving ``runs``:
    each run's model (each of its ``mesh_variants``) cut into its
    shards, prefilled and stepped with the one-card run's tokens; each
    rank puts on ``queue`` its logits' largest error against the
    one-card run it is held against and against the one-card fp32 run
    (over the largest logit), its greedy choices that part from the
    first with that run's top-2 gap there, its collectives per call, its
    times, and its kernel launches in the run (the counters set to 0
    just before it) beside those the code gives: flash once per
    attention layer, the decode kernel once per attention layer a step,
    of them with ``return_lse`` those whose cache the prefill placed
    with the sequence cut over more than one rank, and the scan's
    forward once per rglru layer."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainstep import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.sharding.rules import ShardCtx, shard_params
    wrappers = {"flash_attention": fa_ops.flash_attention,
                "decode_attention": da_ops.decode_attention,
                "rglru_scan_fwd": scan_ops.rglru_scan_fwd}
    out = {"rank": rank}
    try:
        mesh_lib.init_world(rank, world, store, device="cuda")
        mesh = mesh_lib.make_debug_mesh(*shape)
        for name, b, s, max_len in runs:
            ref = torch.load(str(Path(refs) / f"{name}.pt"))
            rows = ShardCtx(mesh, batch=b).rows(torch.arange(b))
            embeds = None if ref["embeds"] is None else \
                ref["embeds"].to(mesh.device)
            for tag, cfg, against in mesh_variants(name):
                full = T.init_params(cfg, 0, device=mesh.device,
                                     dtype=torch.float32)
                local = shard_params(full, mesh)
                del full
                torch.cuda.empty_cache()
                pre = make_prefill_step(cfg, max_len=max_len, mesh=mesh)
                srv = make_serve_step(cfg, mesh)
                calls = []

                def counted(fn):
                    def call(*a):
                        mesh.counts.reset()
                        res = fn(*a)
                        calls.append(mesh.counts.record())
                        return res
                    return call
                steps = len(ref["fed"])
                _build.reset_launches(*wrappers.values())
                run = serve_drive(
                    torch, counted(lambda t: pre(local,
                                                 with_embeds(t, embeds))),
                    counted(lambda tok, c, n: srv(local, c, tok, n)),
                    ref["prompts"].to(mesh.device), steps, fed=ref["fed"],
                    front=T.frontend_prefix(cfg))
                torch.cuda.synchronize()
                launches = {k: w.launches for k, w in wrappers.items()}
                launches["decode_attention_lse"] = \
                    da_ops.decode_attention.lse_launches
                want_n = serve_launches(cfg, run["cache"], mesh, steps)
                errs, errs32, parted, off32 = [], [], [], []
                # over the real vocabulary: the padded columns' -1e30
                # would stand for the largest logit
                v = cfg.vocab_size
                for i, got in enumerate(run["logits"]):
                    want = ref[against][i][rows, :v].float()
                    exact = ref["fp32"][i][rows, :v]
                    got = got[:, :v].float()
                    errs.append(float((got - want).abs().max()
                                      / want.abs().max()))
                    errs32.append(float((got - exact).abs().max()
                                        / exact.abs().max()))
                    off32 += [(i, int(rows[j])) for j in torch.nonzero(
                        got.argmax(-1) != exact.argmax(-1))[:, 0]]
                    top = want.topk(2, dim=-1).values
                    for j in torch.nonzero(got.argmax(-1)
                                           != want.argmax(-1)):
                        j = int(j)
                        parted.append({"call": i, "row": int(rows[j]),
                                       "gap": float((top[j, 0] - top[j, 1])
                                                    / want[j].abs().max())})
                out[tag] = {"err": max(errs), "err_fp32": max(errs32),
                            "parted": parted, "off_fp32": off32,
                            "comm": calls,
                            "launches": launches, "want_launches": want_n,
                            "prefill_s": run["prefill_s"],
                            "step_s": run["step_s"],
                            "peak": torch.cuda.max_memory_allocated()}
                del local, run
                torch.cuda.empty_cache()
        torch.distributed.destroy_process_group()
    except Exception as exc:     # noqa: BLE001 — reported by the parent
        out["error"] = repr(exc)
    queue.put(out)


def spawn_ranks(target, args: tuple, world: int, timeout_s: float,
                label: str) -> tuple:
    """Run ``target(rank, world, store, *args, queue)`` in ``world``
    spawned processes, one a card: (their records by rank, the wall
    seconds). Raises with every rank's error."""
    import multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ranks")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world,
                                              str(Path(tmp) / "store"),
                                              *args, queue))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    recs = []
    try:
        for _ in range(world):
            recs.append(queue.get(timeout=timeout_s))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    errors = [r for r in recs if "error" in r]
    if errors:
        raise PhaseFailed(f"{label}: {errors}")
    return sorted(recs, key=lambda r: r["rank"]), time.perf_counter() - t0


def mesh_serving(torch, smi: str, cells, steps: int, timeout_s: float,
                 label: str, need_lse: bool, witness=None) -> dict:
    """Serving over 4 cards, when there are 4: each cell (a (data, model)
    mesh and its runs) in bf16 and in fp32, fed the one-card bf16 run's
    greedy tokens. Each run's bf16 logits held by ``MESH_BF16_FACTOR``:
    their distance from the one-card fp32 run at most that factor times
    the one-card bf16 run's own distance from it; its fp32 logits within
    ``MESH14_FP32_TOL`` of the one-card fp32 run, every greedy choice
    equal; a bf16 greedy choice may part only at a tie (``TIE_GAP``; an
    MoE config's are reported, an mLSTM config's held to its ``witness``
    by name, ``mesh_serving_readings``); each rank's collectives of every
    call those of the dry run's count, its launches the code's; with
    ``need_lse`` some rank's decode kernel calls ``return_lse``. Every
    run is reported before a failure is raised."""
    n = torch.cuda.device_count()
    if n < 4:
        say(f"  {label} {' and '.join(f'{d}x{m}' for (d, m), _ in cells)}: "
            f"not run ({n} card)")
        return {"run": False, "cards": n}
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    tmp = tempfile.mkdtemp(prefix="mesh")
    out = {"run": True, "cards": n, "wall_s": {}}
    failed, lse = [], []
    try:
        for name, b, s, max_len in dict.fromkeys(
                r for _, runs in cells for r in runs):
            cfg = serve_config(name)
            prompts = serve14_prompts(torch, cfg, b, s, "cuda")
            embeds = frontend_embeds(torch, cfg, b, s, "cuda")
            free(torch)
            # the bf16 compute copy drawn as such: the fp32 draw cast
            model = T.init_params(cfg, 0, device="cuda")
            plain = serve_drive(
                torch, lambda t: T.prefill(model, t, max_len=max_len,
                                           embeds=embeds),
                lambda tok, c, nn: T.decode_step(model, tok, c, nn),
                prompts, steps, front=T.frontend_prefix(cfg))
            del model, plain["cache"]
            free(torch)
            # the control computes in fp32 throughout, caches included,
            # as the mesh's fp32 runs do (``mesh_variants``)
            fp32 = T.init_params(mesh_variants(name)[1][1], 0, device="cuda",
                                 dtype=torch.float32)
            exact = serve_drive(
                torch, lambda t: T.prefill(fp32, t, max_len=max_len,
                                           embeds=embeds),
                lambda tok, c, nn: T.decode_step(fp32, tok, c, nn),
                prompts, steps, fed=plain["tokens"],
                front=T.frontend_prefix(cfg))
            v = cfg.vocab_size
            out[f"{name}-bf16-vs-fp32"] = max(
                float((a[:, :v].float() - w[:, :v]).abs().max()
                      / w[:, :v].abs().max())
                for a, w in zip(plain["logits"], exact["logits"]))
            out[f"{name}-bf16-off-fp32"] = sum(
                int((a.float().argmax(-1) != w.argmax(-1)).sum())
                for a, w in zip(plain["logits"], exact["logits"]))
            torch.save({"prompts": prompts.cpu(), "fed": plain["tokens"],
                        "embeds": None if embeds is None else embeds.cpu(),
                        "logits": plain["logits"],
                        "fp32": exact["logits"]},
                       str(Path(tmp) / f"{name}.pt"))
            del fp32, plain, exact, embeds
            free(torch)
        for shape, runs in cells:
            axes = {"data": shape[0], "model": shape[1]}
            where = f"{shape[0]}x{shape[1]}"
            recs, out["wall_s"][where] = spawn_ranks(
                mesh_serving_rank, (tmp, shape, runs), 4, timeout_s, label)
            out[where] = {"ranks": recs}
            for name, b, s, max_len in runs:
                for tag, cfg, against in mesh_variants(name):
                    # the dry run's prompt counts a vision frontend's rows
                    want = [dryrun.count_sharded(cfg, InputShape(
                        "p", s + T.frontend_prefix(cfg), b, "prefill"), axes,
                        max_len=max_len)["collectives"]]
                    want += [dryrun.count_sharded(cfg, InputShape(
                        "d", max_len, b, "decode"), axes)["collectives"]] \
                        * steps
                    failed += mesh_serving_readings(
                        out, where, recs, name, tag, cfg, against, want,
                        (b, s, max_len, steps), label, smi,
                        (witness or {}).get(name))
            lse += [sum(r[tag]["launches"]["decode_attention_lse"]
                        for tag in r if isinstance(r[tag], dict))
                    for r in recs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["lse"] = {"launches": {"decode_attention": lse[0]}, "ranks": lse}
    say(f"  {label} decode_attention return_lse launches a rank over every "
        f"run: {lse}")
    if need_lse and not all(lse):
        failed.append(f"no sequence-sharded decode with return_lse: {lse}")
    if failed:
        raise PhaseFailed(f"{label}: {failed}")
    return out


def mesh_serving_readings(out, where, recs, name, tag, cfg, against, want,
                          geom, label, smi, witness=None) -> list:
    """Report one mesh run of ``mesh_serving`` and return its failures.
    An MoE config's bf16 greedy choices that part from the one-card bf16
    run's are reported and not held to ``TIE_GAP``: a bf16 routing
    decision turns on a rounding that depends on a rank's rows (cuBLAS
    picks its kernel by row count), and a moved expert moves the logits
    further than a tie. An mLSTM config's are held to its ``witness``
    (``rows_witness``): where the one-card bf16 run at each data rank's
    rows parts W choices beyond a tie from the whole batch's run, with
    no mesh, the mesh may part at most ``WITNESS_FACTOR`` x W. Its fp32
    run holds every choice."""
    b, s, max_len, steps = geom
    r0 = recs[0][tag]
    err = max(r[tag]["err"] for r in recs)
    err32 = max(r[tag]["err_fp32"] for r in recs)
    parted = [p for r in recs for p in r[tag]["parted"]]
    off32 = len({p for r in recs for p in r[tag]["off_fp32"]})
    control = out[f"{name}-bf16-vs-fp32"]
    if against == "logits":
        ok, limit = err32 <= MESH_BF16_FACTOR * control, (
            f"fp32 distance within {MESH_BF16_FACTOR:g} x the one-card "
            f"bf16 run's {control:.3e}")
    else:
        ok, limit = err <= MESH14_FP32_TOL, f"limit {MESH14_FP32_TOL:g}"
    out[where][tag] = {"err": err, "err_fp32": err32, "parted": parted,
                       "off_fp32": off32, "bf16_control": control,
                       "bf16_control_off_fp32": out[f"{name}-bf16-off-fp32"],
                       "against": against,
                       "collectives_prefill": want[0],
                       "collectives_step": want[1]}
    say(f"  {label} {tag} ({cfg.n_layers} layers, {cfg.dtype}) B={b} prompt "
        f"{s} max_len {max_len} on a {where} NCCL mesh, prefill + {steps} "
        f"steps: logits within {err:.3e} of the largest logit of the "
        f"one-card {cfg.dtype} run and {err32:.3e} of the one-card fp32 "
        f"run's ({limit}), {len(parted)} greedy choices parted "
        f"{parted[:4]}, {off32} apart from the fp32 run's (the one-card "
        f"bf16 run's {out[f'{name}-bf16-off-fp32']}); prefill "
        f"{r0['prefill_s']:.3f} s, step median "
        f"{sorted(r0['step_s'])[len(r0['step_s']) // 2] * 1e3:.2f} ms; "
        f"collectives a card: prefill {want[0]['total']:,} B, step "
        f"{want[1]['total']:,} B (the dry run's, every rank); peak "
        f"{[r[tag]['peak'] for r in recs]} B [{smi}]")
    say(f"  {label} {tag} launches a rank: "
        f"{[r[tag]['launches'] for r in recs]} (the code's "
        f"{r0['want_launches']})")
    failed = []
    att = kind_counts(cfg)["attn"] + kind_counts(cfg)["attn_local"]
    for r in recs:
        if r[tag]["comm"] != want:
            failed.append(f"{where} {tag}: rank {r['rank']}'s collectives "
                          f"{r[tag]['comm'][:2]} differ from the dry run's "
                          f"{want[:2]}")
        got = r[tag]["launches"]
        if got != r[tag]["want_launches"] or att and not (
                got["flash_attention"] and got["decode_attention"]):
            failed.append(f"{where} {tag}: rank {r['rank']}'s launches "
                          f"{r[tag]['launches']}, the code's "
                          f"{r[tag]['want_launches']}")
    beyond = {(p["call"], p["row"]) for p in parted if p["gap"] > TIE_GAP}
    if against == "fp32":
        held = parted
    elif cfg.moe is not None:
        held = []
    elif witness is not None and "mlstm" in cfg.layer_kinds:
        limit += (f"; {len(beyond)} choices parted beyond a tie, at most "
                  f"{WITNESS_FACTOR:g} x the {len(witness['parted'])} of "
                  f"the one-card run at a data rank's rows")
        say(f"  {label} {tag}: {len(beyond)} distinct greedy choices "
            f"parted beyond a tie; the one-card run at a data rank's rows "
            f"parts {len(witness['parted'])} (limit {WITNESS_FACTOR:g} x)")
        held = [] if len(beyond) <= WITNESS_FACTOR * len(
            witness["parted"]) else sorted(beyond)
        out[where][tag]["parted_beyond_tie"] = len(beyond)
    else:
        held = sorted(beyond)
    if not ok or held:
        failed.append(f"{where} {tag}: logits within {err:.3e} / {err32:.3e}"
                      f" ({limit}), parted choices {parted}")
    return failed


def phase_sharded_serving(torch, np, ops, da_ops, da_ref, smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"one_rank": one_rank_serving(torch, ops, smi),
           "split": split_by_hand(torch, da_ops, da_ref, smi),
           "mesh4": mesh_serving(torch, smi, [((2, 2), MESH14_RUNS)],
                                 MESH14["steps"], MESH14["timeout_s"],
                                 "(c)", need_lse=True)}
    out["wall_s"] = time.perf_counter() - t0
    say(f"[14/16] sharded serving: the 1x1 NCCL mesh's prefill and serve "
        f"steps equal the unsharded ones bit for bit, launches equal, no "
        f"collective, held bytes within {RESIDENT_SERVE_TOL:.0%} of the dry "
        f"run's; the decode kernel's partials over 2 and 4 row ranges "
        f"combine to the whole cache's; 2x2 "
        f"{'run' if out['mesh4']['run'] else 'not run'} "
        f"({out['wall_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------

# the MoE families through the sharded steps. qwen3-moe-235b-a22b at full
# width serves at phase 10's 4 layers (11.2 B parameters: 44.8 GB of
# fp32 masters) and trains at 1 (3.73 B: 59.7 GB of masters, gradients
# and moments, a 75.8 GB peak on the card; 2 layers hold 99.5 GB);
# qwen2-moe-a2.7b at full width at 6 of its 24 layers (4.05 B: at the
# 18.0 B a parameter of training peak that 5 layers read on the card,
# 72.8 GB; 7 layers reckon to 83.1 GB of the card's 85.5 GB), under both
# dispatches
MOE15_LAYERS = {"qwen3-moe": 4, "qwen3-moe-train": 1, "qwen2-moe": 6,
                "qwen2-moe-gather": 6}
# training: 2 steps of a global batch of 2 x 1,024 on the copy task, one
# microbatch (the 2 x 2 mesh takes a row a data rank); serving: 8 prompts
# of 512 tokens, prefill and 8 steps
MOE15_TRAIN = dict(steps=2, batch=2, seq=1024, microbatches=1, lr=1e-3)
MOE15_TRAIN_RUNS = ("qwen3-moe-train", "qwen2-moe", "qwen2-moe-gather")
MOE15_SERVE = (8, 512, 512 + 8 + 8, 8)      # batch, prompt, max_len, steps
MOE15_SERVE_RUNS = ("qwen3-moe", "qwen2-moe", "qwen2-moe-gather")
# held bytes against the dry run's resident bytes, relative
RESIDENT_MOE_TOL = 5e-4
# (b) with 4 cards: qwen3-moe on 1 x 4 (32 experts a card) and 2 x 2 (64),
# qwen2-moe on 2 x 2 (30 experts a card)
MOE15_MESH_SERVE = (((1, 4), ("qwen3-moe",)),
                    ((2, 2), ("qwen3-moe", "qwen2-moe")))
MOE15_MESH_TRAIN = (((1, 4), ("qwen3-moe-train",)),
                    ((2, 2), ("qwen3-moe-train", "qwen2-moe")))
MOE15_TIMEOUT_S = 900


def moe15_config(name: str):
    """A phase-15 run's config: its model at ``MOE15_LAYERS`` layers, the
    gather dispatch where its name says so."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    arch = "qwen3_moe_235b_a22b" if name.startswith("qwen3") \
        else "qwen2_moe_a2_7b"
    cfg = replace(get_config(arch), n_layers=MOE15_LAYERS[
        name.removesuffix("-fp32")])
    return replace(cfg, moe_impl="gather") if "gather" in name else cfg


def resident_check(label: str, held: int, dry: int,
                   tol: float = RESIDENT_MOE_TOL) -> float:
    rel = held / dry - 1
    if abs(rel) > tol:
        raise PhaseFailed(f"{label}: held {held:,} B vs the dry run's "
                          f"{dry:,} B ({rel:+.4%}, limit {tol:.2%})")
    return rel


def one_rank_config(cfg) -> str:
    moe = f" moe_impl={cfg.moe_impl}" if cfg.moe is not None else ""
    return (f"{cfg.name} n_layers={cfg.n_layers}{moe} bf16 over fp32 "
            f"masters, 1x1 NCCL mesh")


def train_one_rank(torch, ops, mesh, cfg, run: dict, batches, want_n: dict,
                   smi: str, label: str, tol: float) -> dict:
    """One model's sharded train steps (``run``) on the 1 x 1 mesh against
    the unsharded step from the same masters (both drawn from seed 0):
    the metrics and every master after the steps bit for bit, the
    launches the code's (``want_n``), no collective, held bytes within
    ``tol`` of the dry run's."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    from repro_torch.sharding.rules import shard_params
    oc = optim.AdamWConfig(lr=run["lr"], warmup_steps=1,
                           total_steps=run["steps"])
    free(torch)
    full = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
    full.requires_grad_(True)
    step = make_train_step(cfg, oc, microbatches=run["microbatches"])
    for k in TRAIN_KERNELS:
        ops[k].launches = 0
    full, opt, plain_hist, plain_s = train_steps(
        torch, step, full, optim.init(full), batches)
    plain_n = counts(ops)
    plain_after = {n: p.detach().to("cpu", copy=True)
                   for n, p in full.named_parameters()}
    del full, opt, step
    free(torch)
    full = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - sum(
        p.numel() * 4 for p in full.parameters())
    torch.cuda.reset_peak_memory_stats()
    model = shard_params(full, mesh)
    del full
    free(torch)
    model.requires_grad_(True)
    step = make_train_step(cfg, oc, mesh, microbatches=run["microbatches"])
    mesh.counts.reset()
    for k in TRAIN_KERNELS:
        ops[k].launches = 0
    model, opt, hist, secs = train_steps(torch, step, model,
                                         optim.init(model), batches)
    torch.cuda.synchronize()
    launches = counts(ops)
    comm = mesh.counts.record()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    parts = first_parting(torch, plain_hist, hist, plain_after, model)
    same = parts is None and hist == plain_hist
    del model, opt, plain_after
    free(torch)
    dry = dryrun.count_sharded(cfg, InputShape(
        "train", run["seq"], run["batch"], "train"), {"data": 1, "model": 1},
        microbatches=run["microbatches"])["resident_bytes_per_device"]
    rec = {"config": f"{one_rank_config(cfg)}, {run['batch']} x "
                     f"{run['seq']}",
           "hist": hist, "plain_hist": plain_hist, "step_s": secs,
           "plain_step_s": plain_s, "launches": launches,
           "plain_launches": plain_n, "want_launches": want_n, "comm": comm,
           "held_bytes": held, "peak_bytes": peak, "dry_run_bytes": dry,
           "parts": parts, "nvidia_smi": smi}
    say(f"  (a) train {rec['config']}: losses "
        f"{[m['loss'] for m in hist]}, aux {[m['aux'] for m in hist]}, "
        f"grad norms {[m['grad_norm'] for m in hist]}; "
        f"{'bit for bit' if same else f'parts {parts}'} against the "
        f"unsharded step; step {[round(x, 3) for x in secs]} s "
        f"(unsharded {[round(x, 3) for x in plain_s]} s); launches "
        f"{launches} (unsharded {plain_n}, the code's {want_n}); "
        f"collectives {comm['count']} calls; held {held:,} B against the dry "
        f"run's {dry:,} B ({held / dry - 1:+.4%}), peak {peak:,} B [{smi}]")
    if not same:
        raise PhaseFailed(f"{label}: the 1x1 sharded step parts from the "
                          f"unsharded one: {parts}")
    if launches != plain_n or launches != want_n:
        raise PhaseFailed(f"{label}: launches {launches}, unsharded "
                          f"{plain_n}, the code's {want_n}")
    if comm["count"] or comm["total"]:
        raise PhaseFailed(f"{label}: a 1x1 mesh issued collectives: {comm}")
    rec["resident_rel"] = resident_check(label, held, dry, tol)
    return rec


def serve_one_rank(torch, ops, mesh, cfg, geom: tuple, smi: str,
                   label: str, tol: float) -> dict:
    """One model's sharded prefill and serve steps on the 1 x 1 mesh at
    ``geom`` (batch, prompt tokens, max_len, steps; a frontend config's
    ``frontend_embeds`` beside the prompts) against ``T.prefill`` /
    ``T.decode_step`` on its compute copy: logits, greedy tokens and
    cache bit for bit, the launches the code's (``serve_launches``), no
    collective, held bytes within ``tol`` of the dry run's. The fp32
    masters are drawn on the card and, where it cannot hold them twice
    (qwen3-moe's 44.8 GB), staged through the host before they are
    cut."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainstep import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.sharding.rules import shard_params
    b, s, max_len, steps = geom
    prompts = serve14_prompts(torch, cfg, b, s, "cuda")
    embeds = frontend_embeds(torch, cfg, b, s, "cuda")
    front = T.frontend_prefix(cfg)
    kernels = ("flash_attention", "decode_attention")
    free(torch)
    twin = T.init_params(cfg, 0, device="cuda")     # the compute copy
    _build.reset_launches(*(ops[k] for k in kernels))
    plain = serve_drive(
        torch, lambda t: T.prefill(twin, t, max_len=max_len, embeds=embeds),
        lambda tok, c, n: T.decode_step(twin, tok, c, n), prompts, steps,
        front=front)
    plain_n = {k: ops[k].launches for k in kernels}
    plain_cache = host_cache(plain.pop("cache"))
    del twin
    free(torch)
    full = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
    masters = sum(p.numel() * 4 for p in full.parameters())
    if masters > torch.cuda.mem_get_info()[0]:
        full = full.to("cpu")
        free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - (
        masters if full.device.type == "cuda" else 0)
    local = shard_params(full, mesh)
    del full
    pre = make_prefill_step(cfg, max_len=max_len, mesh=mesh)
    srv = make_serve_step(cfg, mesh)
    mesh.counts.reset()
    _build.reset_launches(*(ops[k] for k in kernels))
    run = serve_drive(torch, lambda t: pre(local, with_embeds(t, embeds)),
                      lambda tok, c, n: srv(local, c, tok, n), prompts, steps,
                      front=front)
    torch.cuda.synchronize()
    launches = {k: ops[k].launches for k in kernels}
    comm = mesh.counts.record()
    held = torch.cuda.memory_allocated() - base
    want_n = {k: v for k, v in serve_launches(cfg, run["cache"], mesh,
                                               steps).items() if k in kernels}
    cache = host_cache(run.pop("cache"))
    del local
    free(torch)
    dry = dryrun.count_sharded(cfg, InputShape(
        "serve", max_len, b, "decode"), {"data": 1, "model": 1})[
            "resident_bytes_per_device"]
    same = {"logits": all(torch.equal(a, w) for a, w in
                          zip(run["logits"], plain["logits"])),
            "tokens": all(torch.equal(a, w) for a, w in
                          zip(run["tokens"], plain["tokens"])),
            "cache": all(torch.equal(c[k], w[k]) for c, w in
                         zip(cache, plain_cache) for k in w)}
    rec = {"config": one_rank_config(cfg),
           "batch": b, "prompt": s, "front": front, "max_len": max_len,
           "steps": steps, "same": same, "launches": launches,
           "plain_launches": plain_n, "want_launches": want_n, "comm": comm,
           "held_bytes": held, "dry_run_bytes": dry,
           "prefill_s": run["prefill_s"], "step_s": run["step_s"],
           "plain_prefill_s": plain["prefill_s"],
           "plain_step_s": plain["step_s"], "nvidia_smi": smi}
    rows = f"{front} + {s}" if front else f"{s}"
    source = f" over {embeds.shape[1]} frames" \
        if cfg.n_encoder_layers else ""
    say(f"  (a) serve {rec['config']}, {b} x {rows} tokens{source}, max_len "
        f"{max_len}, prefill + {steps} steps: logits, tokens and cache "
        f"{same} bit for bit against the unsharded steps; prefill "
        f"{run['prefill_s']:.3f} s (unsharded {plain['prefill_s']:.3f} s), "
        f"step median {sorted(run['step_s'])[steps // 2] * 1e3:.2f} ms "
        f"(unsharded {sorted(plain['step_s'])[steps // 2] * 1e3:.2f} ms); "
        f"launches {launches} (unsharded {plain_n}, the code's {want_n}); "
        f"collectives {comm['count']} calls; held {held:,} B against the "
        f"dry run's {dry:,} B ({held / dry - 1:+.4%}) [{smi}]")
    if not all(same.values()):
        raise PhaseFailed(f"{label}: the 1x1 sharded serving steps part "
                          f"from the unsharded ones: {same}")
    if launches != plain_n or launches != want_n:
        raise PhaseFailed(f"{label}: launches {launches}, unsharded "
                          f"{plain_n}, the code's {want_n}")
    if comm["count"] or comm["total"]:
        raise PhaseFailed(f"{label}: a 1x1 mesh issued collectives: {comm}")
    rec["resident_rel"] = resident_check(label, held, dry, tol)
    return rec


@contextlib.contextmanager
def one_rank_mesh(torch, prefix: str):
    """A 1 x 1 NCCL mesh (a world of one rank through a ``FileStore`` in a
    temporary directory) under ``torch.use_deterministic_algorithms``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    tmp = tempfile.mkdtemp(prefix=prefix)
    mesh_lib.init_world(0, 1, str(Path(tmp) / "store"), device="cuda")
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield mesh_lib.make_debug_mesh(1, 1, device="cuda")
    finally:
        torch.use_deterministic_algorithms(det)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def one_rank_moe(torch, np, ops, smi: str) -> dict:
    """(a): the MoE models through the sharded steps on a 1 x 1 NCCL
    mesh, each against the unsharded steps."""
    out = {"train": {}, "serve": {}}
    run = MOE15_TRAIN
    with one_rank_mesh(torch, "moe15") as mesh:
        for name in MOE15_TRAIN_RUNS:
            cfg = moe15_config(name)
            with part(f"15 (a) train {name}"):
                out["train"][name] = train_one_rank(
                    torch, ops, mesh, cfg, run,
                    shard_batches(cfg, np, run["steps"], run["batch"],
                                  run["seq"]),
                    {k: v * run["steps"] for k, v in train_launches(
                        cfg, run["microbatches"]).items()},
                    smi, f"phase 15 (a) train {name}", RESIDENT_MOE_TOL)
        for name in MOE15_SERVE_RUNS:
            with part(f"15 (a) serve {name}"):
                out["serve"][name] = serve_one_rank(
                    torch, ops, mesh, moe15_config(name), MOE15_SERVE, smi,
                    f"phase 15 (a) serve {name}", RESIDENT_MOE_TOL)
    return out


def moe15_train_rank(rank: int, world: int, store: str, shape: tuple,
                     runs: tuple, queue) -> None:
    """One rank of (b)'s training on a ``shape`` NCCL mesh: each run's
    model, in bf16 over fp32 masters and computed in fp32, cut into its
    shards and trained (a)'s 2 steps; the rank puts on ``queue`` the
    metrics, step times, memory and the last step's collectives."""
    import dataclasses

    import numpy as np
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    from repro_torch.sharding.rules import shard_params
    out = {"rank": rank}
    run = MOE15_TRAIN
    try:
        mesh_lib.init_world(rank, world, store, device="cuda")
        mesh = mesh_lib.make_debug_mesh(*shape)
        for name in runs:
            for tag, cfg in ((name, moe15_config(name)),
                             (f"{name}-fp32", dataclasses.replace(
                                 moe15_config(name), dtype="float32"))):
                full = T.init_params(cfg, 0, device=mesh.device,
                                     dtype=torch.float32)
                model = shard_params(full, mesh)
                del full
                torch.cuda.empty_cache()
                model.requires_grad_(True)
                torch.cuda.reset_peak_memory_stats()
                oc = optim.AdamWConfig(lr=run["lr"], warmup_steps=1,
                                       total_steps=run["steps"])
                step = make_train_step(cfg, oc, mesh,
                                       microbatches=run["microbatches"])
                batches = shard_batches(cfg, np, run["steps"], run["batch"],
                                        run["seq"])
                model, opt, hist, secs = train_steps(
                    torch, step, model, optim.init(model), batches[:-1])
                mesh.counts.reset()
                model, opt, last, last_s = train_steps(
                    torch, step, model, opt, batches[-1:])
                torch.cuda.synchronize()
                out[tag] = {"hist": hist + last, "step_s": secs + last_s,
                            "peak": torch.cuda.max_memory_allocated(),
                            "comm": mesh.counts.record()}
                del model, opt, step
                torch.cuda.empty_cache()
        torch.distributed.destroy_process_group()
    except Exception as exc:     # noqa: BLE001 — reported by the parent
        out["error"] = repr(exc)
    queue.put(out)


def mesh_moe_training(torch, np, smi: str, bf16: dict) -> dict:
    """(b)'s training over 4 cards, when there are 4: each cell's models
    in bf16 against (a)'s unsharded run (``bf16``, losses and gradient
    norms within ``MESH4_TOL`` relative, phase 13 (b)'s limit) and
    computed in fp32 against the one-card fp32 run (within
    ``MESH14_FP32_TOL``), each rank's last-step collectives the dry
    run's count."""
    import dataclasses
    n = torch.cuda.device_count()
    if n < 4:
        say(f"  (b) training on 1x4 and 2x2: not run ({n} card)")
        return {"run": False, "cards": n}
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.runtime import optim
    from repro_torch.runtime.trainstep import make_train_step
    run = MOE15_TRAIN
    exact = {}
    for name in dict.fromkeys(r for _, runs in MOE15_MESH_TRAIN
                              for r in runs):
        cfg = dataclasses.replace(moe15_config(name), dtype="float32")
        free(torch)
        model = T.init_params(cfg, 0, device="cuda", dtype=torch.float32)
        model.requires_grad_(True)
        oc = optim.AdamWConfig(lr=run["lr"], warmup_steps=1,
                               total_steps=run["steps"])
        _, _, exact[name], _ = train_steps(
            torch, make_train_step(cfg, oc), model, optim.init(model),
            shard_batches(cfg, np, run["steps"], run["batch"], run["seq"]))
        del model
        free(torch)
    out, failed = {"run": True, "cards": n, "fp32": exact}, []
    for shape, runs in MOE15_MESH_TRAIN:
        where = f"{shape[0]}x{shape[1]}"
        recs, wall = spawn_ranks(moe15_train_rank, (shape, runs), 4,
                                 MOE15_TIMEOUT_S, "phase 15 (b) training")
        out[where] = {"ranks": recs, "wall_s": wall}
        axes = {"data": shape[0], "model": shape[1]}
        for name in runs:
            for tag, want, tol in ((name, bf16[name], MESH4_TOL),
                                   (f"{name}-fp32", exact[name],
                                    MESH14_FP32_TOL)):
                cfg = moe15_config(name) if tag == name else \
                    dataclasses.replace(moe15_config(name), dtype="float32")
                dry = dryrun.count_sharded(cfg, InputShape(
                    "moe15", run["seq"], run["batch"], "train"), axes,
                    microbatches=run["microbatches"])
                rel = max(abs(r[tag]["hist"][i][k] - m[k]) / abs(m[k])
                          for r in recs for i, m in enumerate(want)
                          for k in ("loss", "grad_norm"))
                out[where][tag] = {"rel": rel, "limit": tol,
                                   "dry_run": dry["collectives"]}
                r0 = recs[0][tag]
                say(f"  (b) train {tag} ({cfg.n_layers} layers) on a {where} "
                    f"NCCL mesh: losses "
                    f"{[m['loss'] for m in r0['hist']]}, grad norms "
                    f"{[m['grad_norm'] for m in r0['hist']]}, within "
                    f"{rel:.3e} of the one-card run (limit {tol:g}); step "
                    f"{[round(x, 3) for x in r0['step_s']]} s; peak "
                    f"{[r[tag]['peak'] for r in recs]} B; a step's "
                    f"collectives {r0['comm']['total']:,} B a card (the dry "
                    f"run's {dry['collective_bytes_per_device']:,} B) [{smi}]")
                if rel > tol:
                    failed.append(f"{where} {tag}: {rel:.3e} > {tol:g}")
                failed += [f"{where} {tag}: rank {r['rank']}'s collectives "
                           f"differ from the dry run's" for r in recs
                           if r[tag]["comm"] != dry["collectives"]]
    if failed:
        raise PhaseFailed(f"phase 15 (b) training: {failed}")
    return out


def phase_moe_sharded(torch, np, ops, smi: str) -> dict:
    t0 = time.perf_counter()
    one = one_rank_moe(torch, np, ops, smi)
    with part("15 (b) serving"):
        serve4 = mesh_serving(
            torch, smi, [(shape, tuple((name,) + MOE15_SERVE[:3]
                                       for name in runs))
                         for shape, runs in MOE15_MESH_SERVE],
            MOE15_SERVE[3], MOE15_TIMEOUT_S, "(b)", need_lse=False)
    with part("15 (b) training"):
        train4 = mesh_moe_training(torch, np, smi, {
            k: v["plain_hist"] for k, v in one["train"].items()})
    out = {"one_rank": one, "mesh4_serve": serve4, "mesh4_train": train4,
           "wall_s": time.perf_counter() - t0}
    say(f"[15/16] MoE expert parallelism through the sharded steps: "
        f"qwen3-moe (experts by expert) and qwen2-moe under both "
        f"dispatches on the 1x1 NCCL mesh equal the unsharded train, "
        f"prefill and serve steps bit for bit, launches the code's, no "
        f"collective, held bytes within {RESIDENT_MOE_TOL:.2%} of the dry "
        f"run's; 1x4 and 2x2 {'run' if serve4['run'] else 'not run'} "
        f"({out['wall_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

# the xLSTM, encoder-decoder and vision-frontend families through the
# sharded steps, at full width: name -> (arch, layers to train (None:
# whole), the training run, the serving geometry (batch, prompt tokens,
# max_len, steps)). xlstm-350m whole (its sLSTM loop runs a position at a
# time: prompts of 128, training 2 x 256, as phase 10); seamless-m4t-
# medium whole (12 + 12 layers; a source of one frame a token);
# llava-next-mistral-7b served whole (4 prompts of 2,880 patch rows + 256
# tokens) and trained cut 32 -> 4 layers, as phase 11 (2 x (2,880 +
# 256) positions)
FAM16_TRAIN_RUN = dict(steps=2, batch=2, microbatches=1, lr=1e-3)
FAM16 = {
    "xlstm-350m": ("xlstm_350m", None, 256, (8, 128, 128 + 16, 8)),
    "seamless-m4t-medium": ("seamless_m4t_medium", None, 256,
                            (8, 512, 512 + 16, 8)),
    "llava-next-mistral-7b": ("llava_next_mistral_7b", 4, 2880 + 256,
                              (4, 256, 2880 + 256 + 16, 8))}
RESIDENT16_TOL = 0.01
# (b) with 4 cards: the three served on a 2 x 2 mesh (seamless's 16 and
# llava's 8 kv heads by heads over "model", xlstm's 4 heads 2 a card)
FAM16_MESH = (((2, 2), tuple((name,) + geom[:3]
                             for name, (_, _, _, geom) in FAM16.items())),)
FAM16_TIMEOUT_S = 900


def rows_witness(torch, name: str, geom: tuple, parts: int) -> dict:
    """The bf16 rounding's dependence on the row count, with no mesh:
    ``name``'s one-card bf16 serving run at ``geom`` (``mesh_serving``'s
    control: the same prompts and weights) and again as ``parts`` runs of
    its consecutive rows (a data rank's rows on a mesh of ``parts`` data
    ranks), fed the whole batch's tokens: the greedy choices that part
    beyond a tie (``TIE_GAP``; (call, row)) and the largest distance
    over the largest logit."""
    from repro_torch.models import transformer as T
    b, s, max_len, steps = geom
    cfg = serve_config(name)
    prompts = serve14_prompts(torch, cfg, b, s, "cuda")
    embeds = frontend_embeds(torch, cfg, b, s, "cuda")
    free(torch)
    model = T.init_params(cfg, 0, device="cuda")

    def drive(rows, fed=None):
        e = None if embeds is None else embeds[rows]
        return serve_drive(
            torch, lambda t: T.prefill(model, t, max_len=max_len, embeds=e),
            lambda tok, c, n: T.decode_step(model, tok, c, n),
            prompts[rows], steps, fed=fed, front=T.frontend_prefix(cfg))
    whole = drive(slice(None))
    k, v = b // parts, cfg.vocab_size
    parted, err = set(), 0.0
    for i in range(parts):
        rows = slice(i * k, (i + 1) * k)
        run = drive(rows, fed=[t[rows] for t in whole["tokens"]])
        for c, (got, want) in enumerate(zip(run["logits"],
                                            whole["logits"])):
            want, got = want[rows, :v].float(), got[:, :v].float()
            err = max(err, float((got - want).abs().max()
                                 / want.abs().max()))
            top = want.topk(2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]) / want.abs().amax(-1)
            for j in torch.nonzero(got.argmax(-1) != want.argmax(-1))[:, 0]:
                if gap[j] > TIE_GAP:
                    parted.add((c, i * k + int(j)))
    del model, whole
    free(torch)
    return {"parts": parts, "rows": k, "calls": steps + 1,
            "parted": sorted(parted), "err": err}


def family_batches(cfg, np, n: int, batch: int, seq: int) -> list:
    """``shard_batches`` on the copy task with a frontend config's inputs
    as the dry run shapes them, ``embeds`` N(0, 1) from a numpy seed: a
    vision frontend's rows ahead of ``seq`` less as many tokens (their
    labels -1), an audio source of one frame a token."""
    from repro_torch.models import transformer as T
    rows = T.frontend_prefix(cfg)
    out = []
    for i, b in enumerate(shard_batches(cfg, np, n, batch, seq - rows)):
        if cfg.frontend:
            b["embeds"] = np.random.RandomState(16 + i).standard_normal(
                (batch, rows or seq, cfg.frontend_dim)).astype(np.float32)
        if rows:
            b["labels"] = np.concatenate(
                [np.full((batch, rows), -1, np.int32), b["labels"]], 1)
        out.append(b)
    return out


def fam16_config(name: str, train: bool):
    from dataclasses import replace

    from repro_torch.configs import get_config
    arch, layers, _, _ = FAM16[name]
    cfg = get_config(arch)
    return replace(cfg, n_layers=layers) if train and layers else cfg


def one_rank_families(torch, np, ops, smi: str) -> dict:
    """(a): each family's sharded train, prefill and serve steps on a
    1 x 1 NCCL mesh against the unsharded steps, bit for bit."""
    out = {"train": {}, "serve": {}}
    with one_rank_mesh(torch, "fam16") as mesh:
        for name, (_, _, seq, geom) in FAM16.items():
            cfg = fam16_config(name, train=True)
            run = dict(FAM16_TRAIN_RUN, seq=seq)
            want = dict.fromkeys(TRAIN_KERNELS, 0)
            if cfg.arch_type != "ssm":
                want["flash_attention"] = encdec_train_launches(cfg) \
                    * run["steps"]
            with part(f"16 (a) train {name}"):
                out["train"][name] = train_one_rank(
                    torch, ops, mesh, cfg, run,
                    family_batches(cfg, np, run["steps"], run["batch"], seq),
                    want, smi, f"phase 16 (a) train {name}", RESIDENT16_TOL)
            with part(f"16 (a) serve {name}"):
                out["serve"][name] = serve_one_rank(
                    torch, ops, mesh, fam16_config(name, train=False), geom,
                    smi, f"phase 16 (a) serve {name}", RESIDENT16_TOL)
    return out


def phase_families_sharded(torch, np, ops, smi: str) -> dict:
    t0 = time.perf_counter()
    one = one_rank_families(torch, np, ops, smi)
    witness = {}
    with part("16 rows witness"):
        for (data, _), runs in FAM16_MESH:
            for name, b, s, max_len in runs:
                if "mlstm" not in serve_config(name).layer_kinds:
                    continue
                geom = FAM16[name][3]
                w = witness[name] = rows_witness(torch, name, geom, data)
                say(f"  16 rows witness {name} (bf16, one card, no mesh): "
                    f"B={b} prompt {s} + {geom[3]} steps run whole and as "
                    f"{data} runs of {w['rows']} rows: "
                    f"{len(w['parted'])} of {b * w['calls']} greedy "
                    f"choices part beyond a tie ({TIE_GAP:g}) "
                    f"{w['parted'][:6]}, logits within {w['err']:.3e} of "
                    f"the largest [{smi}]")
    with part("16 (b) serving"):
        serve4 = mesh_serving(torch, smi, FAM16_MESH, FAM16["xlstm-350m"][3][3],
                              FAM16_TIMEOUT_S, "(b)", need_lse=False,
                              witness=witness)
    out = {"one_rank": one, "witness": witness, "mesh4_serve": serve4,
           "wall_s": time.perf_counter() - t0}
    say(f"[16/16] the xLSTM, encoder-decoder and vision-frontend families "
        f"through the sharded steps: xlstm-350m, seamless-m4t-medium and "
        f"llava-next-mistral-7b (trained at 4 layers) on the 1x1 NCCL mesh "
        f"equal the unsharded train, prefill and serve steps bit for bit, "
        f"launches the code's, no collective, held bytes within "
        f"{RESIDENT16_TOL:.0%} of the dry run's; 2x2 "
        f"{'run' if serve4['run'] else 'not run'} ({out['wall_s']:.1f} s)")
    return out


def without_completions(node):
    """The record for ``--out``: every per-request completion list
    dropped (the tokens are checked above; the record keeps numbers)."""
    if isinstance(node, dict):
        return {k: without_completions(v) for k, v in node.items()
                if k != "completions"}
    return node


# the kernels line: one entry per kernel and main path: the kernel's
# source, the TPU kernel it replaces, its timed shape (phase 2's record)
# and the run whose launches it reports (keys into the phase records)
FA_SRC = "src/repro_torch/csrc/flash_attention.cu"
DA_SRC = "src/repro_torch/csrc/decode_attention.cu"
SCAN_SRC = "src/repro_torch/csrc/rglru_scan.cu"
FA_TPU = "src/repro/kernels/flash_attention/kernel.py:88"
DA_TPU = "src/repro/kernels/decode_attention/kernel.py:173"
PAGED_TPU = "src/repro/kernels/decode_attention/kernel.py:117"
SCAN_TPU = "src/repro/kernels/rglru_scan/kernel.py:41"
KERNEL_LINE = [
    # (name, source, replaces, timed shape, launches from[, what else
    # the launches count])
    ("flash_attention", FA_SRC, FA_TPU, "fifo", ("serve", "fifo")),
    ("decode_attention", DA_SRC, DA_TPU, "fifo", ("serve", "fifo")),
    ("paged_decode_attention", DA_SRC, PAGED_TPU, "fifo",
     ("serve", "paged")),
    ("rglru_scan_fwd", SCAN_SRC, SCAN_TPU, "train", ("train", "full_width")),
    ("rglru_scan_bwd", SCAN_SRC, SCAN_TPU, "train", ("train", "full_width")),
    # phase 9: head_dim 256
    ("flash_attention", FA_SRC, FA_TPU, "gemma3-local",
     ("hybrid", "gemma3-1b", "fifo"), "the launches count the 22 local "
     "layers (this shape) and the 4 global ones (timed as gemma3-global)"),
    ("decode_attention", DA_SRC, DA_TPU, "gemma3-local",
     ("hybrid", "gemma3-1b", "fifo"), "the launches count the 22 local "
     "layers' rings (this shape) and the 4 global layers (timed as "
     "gemma3-global)"),
    ("paged_decode_attention", DA_SRC, PAGED_TPU, "gemma3-global",
     ("hybrid", "gemma3-1b", "paged")),
    ("flash_attention", FA_SRC, FA_TPU, "recurrentgemma-local",
     ("hybrid", "recurrentgemma-9b", "fifo"), "the launches count 14 "
     "prefills of 512 tokens (this shape) and 2 of 2,080 (timed as "
     "recurrentgemma-long)"),
    ("decode_attention", DA_SRC, DA_TPU, "recurrentgemma-local",
     ("hybrid", "recurrentgemma-9b", "fifo")),
    ("rglru_scan_fwd", SCAN_SRC, SCAN_TPU, "recurrentgemma",
     ("hybrid", "recurrentgemma-9b", "fifo"), "the launches count 14 "
     "prefills of 512 tokens (this shape) and 2 of 2,080 (timed as "
     "recurrentgemma-long)"),
    # phase 10: qwen2-moe-a2.7b (g = 1) and qwen3-moe-235b-a22b (g = 16)
    ("flash_attention", FA_SRC, FA_TPU, "qwen2-moe",
     ("moe", "qwen2-moe", "fifo"), "the launches count 24 layers x 16 "
     "prefills of 512 tokens"),
    ("decode_attention", DA_SRC, DA_TPU, "qwen2-moe",
     ("moe", "qwen2-moe", "fifo"), "the launches count 24 layers x the "
     "fifo run's decode steps"),
    ("paged_decode_attention", DA_SRC, PAGED_TPU, "qwen2-moe",
     ("moe", "qwen2-moe", "paged"), "the launches count 24 layers x the "
     "paged run's decode steps"),
    ("flash_attention", FA_SRC, FA_TPU, "qwen2-moe-train",
     ("moe", "train", "qwen2-moe-a2.7b"), "the launches count 2 layers x "
     "(forward + the remat recompute) x 3 steps"),
    ("flash_attention", FA_SRC, FA_TPU, "qwen3-moe",
     ("moe", "qwen3-moe", "fifo"), "the launches count 4 layers x 8 "
     "prefills of 256 tokens"),
    ("decode_attention", DA_SRC, DA_TPU, "qwen3-moe",
     ("moe", "qwen3-moe", "fifo"), "the launches count 4 layers x the "
     "fifo run's decode steps"),
    # phase 11: seamless-m4t-medium (D = 64, g = 1) and
    # llava-next-mistral-7b (2,880 patch rows + 512 tokens, g = 4)
    ("flash_attention", FA_SRC, FA_TPU, "seamless-encoder",
     ("encdec", "seamless", "fifo"), "the launches count 16 prefills x (12 "
     "encoder layers and 12 cross-attentions at this shape, 12 causal "
     "self-attentions timed as seamless-decoder)"),
    ("decode_attention", DA_SRC, DA_TPU, "seamless",
     ("encdec", "seamless", "fifo"), "the launches count the fifo run's "
     "decode steps x (12 self-attention layers at this shape, 12 "
     "cross-attentions timed as seamless-cross)"),
    ("decode_attention", DA_SRC, DA_TPU, "seamless-cross",
     ("encdec", "seamless", "paged"), "over the cross cache; the paged "
     "run's launches: 12 cross-attentions x its decode steps (its 12 "
     "self-attention layers launch the paged kernel)"),
    ("paged_decode_attention", DA_SRC, PAGED_TPU, "seamless",
     ("encdec", "seamless", "paged"), "the launches count 12 layers x the "
     "paged run's decode steps"),
    ("flash_attention", FA_SRC, FA_TPU, "llava",
     ("encdec", "llava", "fifo"), "the launches count 32 layers x 8 "
     "prefills of 2,880 patch rows + 512 tokens"),
    ("decode_attention", DA_SRC, DA_TPU, "llava",
     ("encdec", "llava", "fifo"), "the launches count 32 layers x the fifo "
     "run's decode steps"),
    ("paged_decode_attention", DA_SRC, PAGED_TPU, "llava",
     ("encdec", "llava", "paged"), "the launches count 32 layers x the "
     "paged run's decode steps"),
    # phase 13: the sharded step on the 1 x 1 NCCL mesh
    ("flash_attention", FA_SRC, FA_TPU, "train",
     ("sharded", "one_rank"), "the sharded train step (1x1 mesh), 1 "
     "attn_local layer x 2 microbatches x 2 steps"),
    ("rglru_scan_fwd", SCAN_SRC, SCAN_TPU, "train",
     ("sharded", "one_rank"), "the sharded train step (1x1 mesh)"),
    ("rglru_scan_bwd", SCAN_SRC, SCAN_TPU, "train",
     ("sharded", "one_rank"), "the sharded train step (1x1 mesh)"),
    # phase 14: the sharded prefill and serve steps on the 1 x 1 NCCL mesh
    ("flash_attention", FA_SRC, FA_TPU, "fifo",
     ("serve_sharded", "one_rank", "qwen2-1.5b"), "the sharded prefill "
     "step (1x1 mesh): 28 layers x 1 prefill of 8 x 512 tokens"),
    ("decode_attention", DA_SRC, DA_TPU, "fifo",
     ("serve_sharded", "one_rank", "qwen2-1.5b"), "the sharded serve step "
     "(1x1 mesh): 28 layers x 31 steps of 8 rows"),
    # only with 4 cards: a 1 x 1 mesh holds every row (the default output)
    ("decode_attention", DA_SRC, DA_TPU,
     ("serve_sharded", "split", "timed", "lse"),
     ("serve_sharded", "mesh4", "lse"), "return_lse=True, the flash-decode "
     "partial of a sequence-sharded cache; the launches count rank 0's "
     "return_lse calls over phase 14 (c)'s runs on the 2x2 mesh"),
    ("flash_attention", FA_SRC, FA_TPU, "recurrentgemma-local",
     ("serve_sharded", "one_rank", "recurrentgemma-9b"), "the sharded "
     "prefill step (1x1 mesh, 5 layers): 1 attn_local layer x 1 prefill "
     "of 8 x 512 tokens"),
    ("decode_attention", DA_SRC, DA_TPU, "recurrentgemma-local",
     ("serve_sharded", "one_rank", "recurrentgemma-9b"), "the sharded serve "
     "step (1x1 mesh, 5 layers): 1 ring x 31 steps of 8 rows"),
    ("rglru_scan_fwd", SCAN_SRC, SCAN_TPU, "recurrentgemma",
     ("serve_sharded", "one_rank", "recurrentgemma-9b"), "the sharded "
     "prefill step (1x1 mesh, 5 layers): 4 rglru layers x 1 prefill of 8 "
     "x 512 tokens"),
    # phase 15: the sharded MoE serving steps on the 1 x 1 NCCL mesh
    ("flash_attention", FA_SRC, FA_TPU, "qwen3-moe",
     ("moe_sharded", "one_rank", "serve", "qwen3-moe"), "the sharded "
     "prefill step (1x1 mesh, qwen3-moe's 4 layers): 4 layers x 1 prefill "
     "of 8 x 512 tokens"),
    ("decode_attention", DA_SRC, DA_TPU, "qwen3-moe",
     ("moe_sharded", "one_rank", "serve", "qwen3-moe"), "the sharded serve "
     "step (1x1 mesh, qwen3-moe's 4 layers): 4 layers x 8 steps of 8 rows"),
    # phase 16: the encoder-decoder and the vision frontend through the
    # sharded prefill and serve steps on the 1 x 1 NCCL mesh (xLSTM runs
    # no kernel)
    ("flash_attention", FA_SRC, FA_TPU, "seamless16-encoder",
     ("families_sharded", "one_rank", "serve", "seamless-m4t-medium"),
     "the sharded prefill step (1x1 mesh): 1 prefill of 8 x 512 tokens "
     "over 512 frames x (12 encoder layers and 12 cross-attentions at this "
     "shape, 12 causal self-attentions timed as seamless16-decoder)"),
    ("decode_attention", DA_SRC, DA_TPU, "seamless16",
     ("families_sharded", "one_rank", "serve", "seamless-m4t-medium"),
     "the sharded serve step (1x1 mesh): 8 steps of 8 rows x (12 "
     "self-attention layers at this shape, 12 cross-attentions timed as "
     "seamless16-cross)"),
    ("flash_attention", FA_SRC, FA_TPU, "llava16",
     ("families_sharded", "one_rank", "serve", "llava-next-mistral-7b"),
     "the sharded prefill step (1x1 mesh): 32 layers x 1 prefill of 4 x "
     "(2,880 patch rows + 256 tokens)"),
    ("decode_attention", DA_SRC, DA_TPU, "llava16",
     ("families_sharded", "one_rank", "serve", "llava-next-mistral-7b"),
     "the sharded serve step (1x1 mesh): 32 layers x 8 steps of 4 rows"),
]
# a KERNEL_LINE shape timed under another phase-2 record than its name's
TIMED_AS = {"qwen2-moe-train": "flash_attention_train",
            "seamless-encoder": "flash_attention_bidir",
            "seamless16-encoder": "flash_attention_bidir",
            ("flash_attention", "train"): "flash_attention_train"}
ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16}


def tiered_launches(rec: dict) -> dict:
    """Phase 8's launches by path: the three modes, over HTTP and the
    failover's failure run."""
    out = {name: m["launches"] for name, m in rec["modes"].items()}
    out["http"] = rec["http"]["launches"]
    out["failover"] = rec["failover"]["launches"]["failover"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    ap.add_argument("--out", default=None,
                    help="also write every measurement here as JSON")
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16",
                    help="comma-separated phases to run; a subset prints "
                         "no result line (phase 1 always runs)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")} | {1}
    if not (SRC / "repro_torch").is_dir():
        say(f"FAIL: no src/repro_torch beside {Path(__file__).name}; run "
            f"from a checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False; this smoke run needs "
            "an NVIDIA GPU")
        return 2
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    ops = {"flash_attention": fa_ops.flash_attention,
           "decode_attention": da_ops.decode_attention,
           "paged_decode_attention": da_ops.paged_decode_attention,
           "rglru_scan_fwd": scan_ops.rglru_scan_fwd,
           "rglru_scan_bwd": scan_ops.rglru_scan_bwd}
    from repro_torch.models import transformer as T
    built = Built(T)
    t0 = time.perf_counter()
    record = {}
    try:
        smi = None
        steps = [
            (1, "device", lambda: phase_device(torch, build)),
            (2, "kernels", lambda: phase_kernels(
                torch, np, fa_ops, fa_ref, da_ops, da_ref, scan_ops,
                scan_ref)),
            (3, "golden", lambda: phase_golden(torch, np)),
            (4, "serve", lambda: phase_serve(torch, np, ops, fa_ref, da_ref)),
            (5, "train", lambda: phase_train(torch, np, ops)),
            (6, "http", lambda: phase_http(torch, np, ops, smi)),
            (7, "edge", lambda: phase_edge(torch, np, ops, smi)),
            (8, "tiered", lambda: phase_tiered(torch, np, ops, smi)),
            (9, "hybrid", lambda: phase_hybrid(torch, np, ops, fa_ref, da_ref,
                                               scan_ref, smi)),
            (10, "moe", lambda: phase_families(torch, np, ops, fa_ref, da_ref,
                                               scan_ref, smi)),
            (11, "encdec", lambda: phase_encdec(torch, np, ops, fa_ref,
                                                da_ref, scan_ref, smi)),
            (12, "dryrun", lambda: phase_dryrun(torch, built.models, smi)),
            (13, "sharded", lambda: phase_sharded(torch, np, ops, smi)),
            (14, "serve_sharded", lambda: phase_sharded_serving(
                torch, np, ops, da_ops, da_ref, smi)),
            (15, "moe_sharded", lambda: phase_moe_sharded(torch, np, ops,
                                                          smi)),
            (16, "families_sharded", lambda: phase_families_sharded(
                torch, np, ops, smi))]
        record["phase_s"] = {}
        for k, key, run in steps:
            if k in phases:
                t1 = time.perf_counter()
                record[key] = run()
                record["phase_s"][k] = time.perf_counter() - t1
                smi = record["device"]["nvidia_smi"]
    except PhaseFailed as exc:
        say(f"FAIL: {exc}")
        return 1
    finally:
        built.restore()
    record["total_s"] = time.perf_counter() - t0
    record["part_s"] = PART_S
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(without_completions(record),
                                             indent=1, default=str,
                                             sort_keys=True))
    say(f"# total {record['total_s']:.1f} s; by phase "
        f"{json.dumps({k: round(v, 1) for k, v in record['phase_s'].items()})}")
    if 8 in phases:
        say(f"# phase 8 launches by path: "
            f"{json.dumps(tiered_launches(record['tiered']))}")
    if phases != ALL_PHASES:
        say(f"# partial run (phases {sorted(phases)}): no result line")
        return 0
    kernels = []
    for name, source, replaces, shape, path, *also in KERNEL_LINE:
        if isinstance(shape, tuple):     # timed outside phase 2
            m = record
            for key in shape:
                m = m[key]
        else:
            m = record["kernels"][TIMED_AS.get((name, shape),
                                               TIMED_AS.get(shape, name))][
                                                   shape]
        if path[:2] == ("serve_sharded", "mesh4") \
                and not record["serve_sharded"]["mesh4"]["run"]:
            say(f"# {name} ({m['shape']}): not on the main path with "
                f"{torch.cuda.device_count()} card; timed in phase 14 (b)")
            continue
        run = record
        for key in path:
            run = run[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": "; ".join([m["shape"], *also]),
            "path": " ".join(path[1:])})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
