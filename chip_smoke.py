#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``infinistore_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``g++``, and builds everything it runs
from the checkout: the store's native library (``g++``) and the Hopper
kernels (``nvcc``, one process per source), in parallel. Then:

1. Kernel phase. Each kernel (K1 gather, K2 scatter, K3 paged decode
   attention, K4 flash prefill, K5 paged decode statistics, K6 ragged paged
   decode attention, K7 ragged statistics, K8 int8 paged decode) runs
   against its plain PyTorch version on the card, on its path's shapes at
   Llama-3-8B widths, in bf16 and in f32: K1/K2 must be bitwise equal,
   K3/K4/K6/K8 within 1e-5 (f32) and 2e-2 (bf16; K4 rounds probabilities to
   bf16 before PV, the plain version does not). K6 runs a skewed ragged
   wave (1 to 1,152 tokens, a 4-row verification chunk sharing its pages, a
   zero-length row, power-of-two pad pages) and must also be bitwise equal
   to K3 on each row's rebuilt table, and each row bitwise equal to a solo
   launch of that row. K8 (its own int8 fold) is held to the JAX package's
   contract, the same tolerances against its plain version, and against K3
   run on q.float() over the f32-dequantised cache to 1e-5 plus, with bf16
   q, the two results' rounding to bf16 (2^-7 of the value); two launches
   bitwise equal, each row bitwise its solo launch, a zero-length row
   zeros. K5 (at K3's wave) and K7 (at K6's wave) are held against their
   plain statistics; their one-shard combine must be bitwise K3/K6, and the
   combine of 4 disjoint slices of each row's pages within 1e-5 of K3/K6 in
   f32. K4 takes bf16 on its tensor-core kernel (at the main path's 2,048
   tokens and the engine's 1,024) and f32 on its CUDA-core kernel, and each
   launch must have moved its kernel's counter. Each kernel is timed with
   CUDA events (the median of 11 launches, each behind an L2 flush and a
   device-side spin that keeps the wrapper's host work out of the
   interval) beside its plain version, one PyTorch library call where one
   computes the same function, and its bound (bytes over 3.35 TB/s or
   operations over the card's peak rate for the inputs' type, from this
   run's inputs), at the shapes of the path that runs it (K5 at the sharded
   decode's 32,768-token request, also timed without its cross-split merge,
   ``fold_ms``: its source built with ``-DITS_DECODE_NOMERGE`` into
   ``_build/probe`` as ``cuda/decode_probe.py`` builds it, whose ``k5`` mode
   also gives the CTAs, the CTAs an SM holds and the waves; K7 at the skewed
   wave also through that build, ``fold_ms``, and at the wave's first
   quarter-shard, ``quarter_shard_ms``, which ``decode_probe.py k7`` breaks
   down into launch, prologue, stages and merge). K3 is also
   held (f32 1e-5, bf16 2e-2) and timed at the engine's ``prefill_continue``
   shape (256 rows at contexts 769-1,024 sharing one table), K6 at the
   engine's own wave (4 x 8-token verification chunks at 1,024 tokens, each
   chunk's rows sharing their pages; bitwise K3 per row; its bound counts the distinct pages);
   two launches of K3 and K6 on the same inputs must be bitwise equal.
   K3's, K4's and K6's wrapper host time per call is logged. K1/K2 are
   also held bitwise (bf16 and f32, every launch on the TMA bulk ring) and
   timed through their batched entries at the paths' shapes: the writer's
   and the reader's layer ([K, V] x 128 blocks), the engine's save snapshot
   (64 caches x 64 blocks), the install span (64 caches x 48 blocks) and the
   int8 round trip's 16 KiB data and 512 B scale blocks, beside their bound
   and the unfused sequence the paths ran before (one launch a cache, plus
   the writer's ``torch.cat``), with K1/K2's wrapper host time.
2. Main path at Llama-3-8B width (random weights from seed 0): engine A
   prefills 4 prompts of 2048 tokens and saves them through
   ``KVConnector.save`` to an in-process store; engine B looks each prompt up
   (all 128 blocks must hit), loads it into different block ids, must hold
   the same bytes, and both engines decode 16 steps as one wave of 4 with
   bitwise-equal logits. Launch counts are zeroed just before this phase
   and every kernel must have launched in it; here and in both engine
   phases every K4 launch must have taken the bf16 tensor-core kernel, and
   here, in the int8 round trip and in both engine phases every K1/K2
   launch the TMA bulk ring.
3. A small f32 model through the same round trip twice, on the card (the
   kernels) and on the CPU (the plain versions): logits agree to 2e-4.
3b. The round trip of phase 2 at other widths, each on a store of its own
   (``ROUND_TRIPS``): Phi-3-mini's at full depth (32 layers, 32 heads over
   32 KV heads, head_dim 96; 3 GiB of KV each way, 96 KiB blocks in 32 KiB
   units on a 4 GiB store), and Phi-2's (head_dim 80, 80 KiB blocks in 16
   KiB units) and Gemma-2B's (8 heads over 1 KV head, head_dim 256, 8 KiB
   blocks in 8 KiB units) attention widths in a Llama block cut to 2
   layers: loaded blocks byte-equal, decode logits bitwise equal across the
   engines, each block taking whole store units; K1-K4 must launch on each,
   every K4 on the tensor cores and every K1/K2 on the bulk ring. Each
   one's prefill ms a prompt, save and load GB/s, decode ms a step and
   store bytes a key are logged beside the Llama-3-8B round trip's.
4. int8 round trip at Llama-3-8B width: engine A's 4 x 2,048-token bf16
   prefixes are quantised (``quantize_kv``) and saved through
   ``QuantizedKVConnector`` to a fresh store (2 GiB in 16 KiB units, see
   ``INT8_STORE_UNIT``); engine B looks them up (all 128 blocks hit) and
   loads them into its own int8 caches at other block ids; data and scales
   must be byte-equal. K8 then decodes a seeded bf16 query wave [4, 32,
   128] over the 2,048-token contexts for all 32 layers, held to K8's
   contract as in phase 1 (within 2e-2 of its plain version, within one
   bf16 rounding of K3 over the dequantised cache, two launches and solo
   rows bitwise); its largest difference from K3 over the
   original bf16 cache (the int8 scheme's error, at most 2e-2), save/load
   GB/s and the store's bytes per key are logged beside the bf16 main
   path's.
5. Engine phase at Llama-3-8B width (bf16, the main path's weights; a fresh
   store with a 2 GiB pool): one ``ContinuousBatchingHarness`` (1,024
   blocks = 2 GiB of KV, 72 blocks per request, n-gram drafts of up to 7)
   serves two rounds of 4 concurrent requests. Round 1: 1,024-token prompts
   (a shared 512-token prefix, a tail in which a 64-token span occurs
   twice), 64 generated tokens each: misses, prefilled (K4, K2) and saved
   (K1). Round 2: each round-1 prompt's first 768 tokens plus 256 new ones:
   48-block prefix hits fetched and installed (K2), the suffix resumed with
   ``prefill_continue`` (K3). Every generation wave is one
   ``verify_step_ragged`` (K6). Every request's prompt blocks must match the
   model's own prefill within the bf16 tolerance ``ENGINE_VERIFY_TOL``, and
   K1, K2, K3, K4 and K6 must each have launched in the phase.
6. int8 engine phase: the same two rounds through ``QuantizingKVAdapter``
   (the engine keeps its bf16 cache, the store holds int8 + scales) on a
   fresh 2 GiB store with the same 32 KiB unit; round 2's requests are
   verified within a tolerance derived from the int8 scheme
   (``_int8_verify_tol``). TTFT, prefix-ready, tokens/s and the store's
   bytes are logged beside the bf16 engine phase's.
7. The engine's two rounds scaled down on a small f32 model (head_dim 64)
   on the card and on the CPU, through the plain adapter and through the
   quantizing one: every request verified on both devices; the plain
   adapter's tokens must be identical on the card and the CPU, and so must
   the int8 adapter's first round (its second reads int8 prefixes
   quantised from values that may differ in the last place between the two
   devices; the share of identical tokens is logged).
8. Sharded decode on a process group of world size 1 (NCCL, FileStore):
   ``paged_decode_attention_sharded`` over a 32,768-token bf16 context of
   one layer (128 MiB of K+V) and ``paged_decode_attention_ragged_sharded``
   over the kernel phase's skewed wave; both must be bitwise K3/K6 (the
   one-shard combine) and K5/K7 must have launched. One card has no second
   rank: the multi-rank combine is held on the CPU (4 gloo ranks,
   ``tests/test_torch_sharded_decode.py``) and, over 4 slices stacked in
   one process, by the kernel phase.
9. The overlapped prefill -> decode handoff (``disagg``) at Llama-3-8B
   width (bf16, the main path's weights, block size 16; a fresh 2 GiB store
   in 32 KiB units, one K or V block of a layer): one ``DisaggHarness``,
   its prefill and decode connectors on two connections with disjoint block
   layouts, one 2,048-token prompt (128 blocks, 256 MiB of KV a handoff), 4
   greedy tokens a leg. Three rounds (``DISAGG_ROUNDS``; the first pays
   every first use) of five legs, in order, the prompt's keys dropped
   between legs that ship: the local recompute (the byte oracle), the
   overlapped handoff (watermark 1), the blocking fetch-all, the cold
   store-and-forward leg, and the fallback leg (a prompt nobody ships,
   ``prefill=False``, ``retry_missing_s`` 0.05); then one more overlapped
   leg under ``torch.profiler`` (the device's busy time and idle share).
   In every round, every leg's first logits and tokens must be
   bitwise the local leg's (the fallback leg's, a local leg on its own
   prompt); the local leg's must be bitwise the round trip's ``prefill`` +
   ``decode_step_batched`` on the same prompt and layout. The overlapped
   leg must not fall back, every layer's install must precede its compute
   and layer 0's compute must precede layer 31's install; the blocking leg
   installs every layer before any compute; the fallback leg recomputes
   once (``disagg_fallback_recomputes``, a ``disagg_fallback`` journal
   event) and ``disagg_wrong_bytes`` stays 0. K1 (the ships' gathers), K2
   (prefill's scatters and the per-layer installs), K3 (the decode layers)
   and K4 (prefill) must launch on the path, every K4 launch on the tensor
   cores and every K1/K2 launch on the bulk ring. K3 is also held against
   its plain version at the path's own inputs (one row, q [1, 32, 128]
   bf16, the decode side's 129-block table row, seq_len 2,049-2,052, over
   the first and the last layer's caches of an overlapped leg), within
   2e-2, two launches bitwise equal. Each leg's TTFT, the overlap counters
   and the bytes shipped are logged, round by round.
9b. The same path at ``disagg.demo_config()``'s defaults (the module's
   CLI model and ``DisaggHarness()``'s: f32, 6 layers, dim 64, 4 heads over
   2 KV heads, head_dim 16, block 8) with its seed-0 demo weights, one
   64-token prompt, a 256 MiB store of its own: the same legs, rounds and
   checks (K3 held at its inputs within 1e-5); K1-K4 must launch.
10. The multi-server KV pool (``cluster``) at Llama-3-8B width (bf16, the
   main path's weights): four in-process servers (2 GiB each, 32 KiB
   units), a ``ClusterKVConnector`` over three of them (R=2, strict,
   a durable journal, breakers that open on one transport error) and 4 x
   2,048-token prompts chosen so that every member owns a root and prompt
   0's owner owns a second once the fourth server is in the placement.
   Legs: engine A prefills the prompts (K4, K2); three are saved through
   ``save`` (mirrored to owner and runner-up, K1 on each; ``mirror_writes``
   must be 3) and the last through ``stage_layer_save`` layer by layer to
   its owner alone (layer 0 last); engine B looks up and loads all four
   (routed, K2); the fourth server joins (``add_member``, ``wait=True``),
   after which every prompt, the layer-streamed one included, must have two
   complete holders in the catalog, and engine B loads them again; prompt
   0's owner stops and engine C loads all four (failover: its breaker must
   open and ``replica_serves`` cover its roots); ``mark_dead`` re-replicates
   its roots (two live holders a root again) and engine C loads them again;
   every prompt is dropped, after which no member holds a key and the
   catalog is empty. Each load leg: ``lookup`` hits all 128 blocks, the
   loaded blocks equal engine A's, and 16 greedy decode steps at B=4 (K3)
   are bitwise engine A's own decode. K1-K4 must launch on the path, every
   K4 on the tensor cores and every K1/K2 on the bulk ring. The save and
   load GB/s of each leg (logical bytes, one copy), the join's and the
   death's reshard (roots, bytes, seconds), ``replica_serves``,
   ``mirror_writes``, breaker trips and each member's ``used_bytes`` are
   logged.
11. The vLLM v1 connector (``InfiniStoreKVConnectorV1``) at Llama-3-8B
   width (bf16, the main path's weights, block 16; a fresh 2 GiB store in
   32 KiB units) under a vLLM-shaped scheduler and runner written here:
   duck-typed ``Request`` / ``NewRequestData`` / ``CachedRequestData`` /
   ``SchedulerOutput`` objects, and each engine's scheduler half and worker
   half as separate instances over separate connectors and connections.
   Every runner step is ``bind_connector_metadata``, ``start_load_kv``, per
   layer ``wait_for_layer_load`` -> the layer's forward -> ``save_kv_layer``,
   then ``wait_for_save`` and ``clear_connector_metadata``. Engine A: 4
   2,048-token prompts, all misses, in two chunked-prefill steps of 1,024
   scheduled tokens (the second through ``scheduled_cached_reqs``, with no
   prompt tokens and the next 64 blocks); the first chunk's layers run
   ``prefill_layer`` (K4, K2), the second's ``decode_wave_layer`` (K3 over
   the first chunk's blocks); each step saves its blocks layer by layer
   (K1). After it every prompt's lookup must hit all 128 blocks. Engine B
   (fresh caches, other block ids): the 4 prompts plus a 16-token suffix;
   the scheduler must promise 2,048 tokens each; ``start_load_kv`` runs
   the concurrent ``start_fetch_async`` phase and the sequential installs
   (K2) on the connector's load stream, and each layer's suffix
   (``decode_wave_layer``, K3) runs behind its ``wait_for_layer_load`` and
   saves the suffix block (K1). Before ``wait_for_save`` a third
   connector's lookup of prompt + suffix must read 128 blocks, after it 129
   (the layer-0 sentinel commits last). Then 16 greedy decode steps at B=4
   (K3). Oracle: engine A runs the same suffix through the same layer
   functions and the same 16 steps on its own caches, with no store;
   engine B's loaded blocks must be byte-equal to A's, and its suffix and
   decode logits bitwise A's. Each step's wall, the host time of its loads
   (``load_GBps``) and saves (``save_GBps``, from the first
   ``save_kv_layer`` to ``wait_for_save``'s return), the load against the
   sum of the runner's layer waits, and the time from B's first probe to
   its first decode logits are logged. K1-K4 must launch, every K4 on the
   tensor cores and every K1/K2 on the bulk ring. The kernel phase also
   times K3 at this path's suffix launch (4 requests x 16 rows, 130-block
   tables, contexts 2,049-2,064) and at the disagg path's decode step (one
   row, a 129-block table).
12. The serving surface's command-line entry points, short: the port's
   benchmark CLI (``benchmark.main``) in this process against an
   in-process server, ``--wave 8`` (the store legs, read coalescing, and
   the decode-wave leg: K6 against K3, f32) and ``--trace skewed`` (a
   loadgen trace through the continuous-batching engine on a small f32
   model, the JAX package's trace model: f32, dim 64, 4 heads over 2 KV
   heads, head_dim 16; every request verified: K4 f32, K1, K2, K3, K6), both
   ``verified``; ``python -m infinistore_tpu_torch.benchmark --type tcp``
   once as a subprocess; and a fleet client (``python -m
   infinistore_tpu_torch.fleet_client``, 4 roots, a journal) seeded over
   two in-process store servers, stopped with SIGTERM once its catalog
   holds every root, then its ``--verify`` run in this process (journal
   replay, four loads through K2, the comparison through K1) must read 4
   roots, 0 wrong, 0 missed. K1, K2, K3 and K6 must launch in this
   process. The kernel phase holds K6 and K3 on the decode-wave leg's own
   inputs (``benchmark.decode_wave_inputs``: f32, 8 query heads over 2 KV
   heads, head_dim 64, block 16, 8 rows over 16-page tables, K6 over its
   pow2-padded page list) against their plain versions (1e-5), two
   launches bitwise equal, and times each with its wrapper host time.
   The kernel phase ends with the shapes beyond the main path's
   (``SHAPES_TAKEN``, at the round trip's wave of 4 x 2,048 tokens): head
   dim 16 (the trace model's 4 heads over 2, f32, block 8), head_dim 32 (8
   over 2, bf16), 7 query heads a KV head (Qwen2.5-7B's 28 over 4, head
   dim 128, bf16), head_dim 8 (the JAX model tests' 4 heads over 2, f32,
   block 8), and Phi-2's, Phi-3-mini's and Gemma-2B's heads (head_dim 80,
   32 over 32; 96, 32 over 32; 256, 8 over 1; bf16), beside Llama-2-7B's
   (head_dim 128, 32 over 32, bf16: the same CTAs as 80 and 96 with every
   lane of a token busy), and the main path's heads at head_dim 64 (32
   over 8, f32). K3, K5, K6, K7 and K8 at each, K4 in f32 and bf16 at
   every one (so every head_dim has an f32 and a bf16 row), and in bf16 at
   Gemma-2B's heads also over 4 prompts (each prompt bitwise its solo
   launch), each against its
   plain version with the tolerances above (K6 bitwise K3, K5 / K7's
   combines bitwise K3 / K6, K8 held to its contract) and timed beside its
   plain version and its bound, K4 also beside one SDPA call whose CUDA
   kernels (``torch.profiler``) are logged, its backend and longest kernel
   on the row (``library_backend``, ``library_kernel``; ``shapes_taken``
   on the ``kernels`` line, which
   also lists each kernel's ``head_dims`` and ``groups``).

13-15 run after phase 11, on the main path's weights, before phase 12:
13. The same-mesh block handoff (``cuda/ici.py``) at Llama-3-8B width
   (bf16; a fresh 2 GiB store in 32 KiB units): engine A prefills 4 x
   2,048-token prompts (1 GiB of KV, 256 MiB a request; K4, K2), and
   ``KVConnector(None, ..., ici=IciBlockTransfer([cuda:0, cuda:0], ...))
   .handoff(..., src=0, dst=1)`` moves each into engine B's cache: a mesh
   that names the card twice, so the move is a device-to-device copy on
   one card (a peer copy over NVLink needs two cards, which this script
   does not have). Each handoff must be one transfer launch, one K1 and one
   K2 launch (all 64 caches in one launch each, on the bulk ring); B's
   blocks must equal A's byte for byte, A's caches must be unchanged and
   B's other blocks zero. Then the store branch (``handoff`` without
   ``src``/``dst``, through the store) moves the same prompts to the same
   block ids inside A's caches, and 16 greedy steps at B=4 (K3) from B
   must be bitwise those from A after the store handoff. Each handoff's
   wall and GB/s are logged beside the store branch's.
14. The long-context prefill (``models/long_context.py prefill_ring``,
   ring attention inside) at Llama-3-8B width on one 4,096-token prompt,
   on a process group of world size 1 over NCCL (NCCL refuses two ranks
   on one card: the multi-rank ring is held on the CPU at 2, 4 and 8 gloo
   ranks by the tests). The shard's K/V are scattered into a paged cache
   (K2) and saved through ``KVConnector.save`` under the full token list
   (K1, a fresh 2 GiB store); a fresh cache loads the prefix (K2) and must
   be byte-equal to a cache filled directly with the ring's K/V, and 16
   decode steps (K3) from the two must be bitwise equal. The ring's logits
   and every layer's K/V must be within ``LONG_CONTEXT_TOL`` of the dense
   masked forward (``_kv_proj`` + ``_block`` with an explicit mask), and
   ``ulysses_attention`` on layer 0's inputs within ``ULYSSES_TOL`` of
   ``ring_attention``.
15. The soft mixture of experts at Llama-3-8B widths with 8 experts, cut
   to 4 layers (``MOE_LAYERS``): a 2,048-token prefill (K4, K2) and 16
   greedy decode steps (K3), whose last logits must be within ``MOE_TOL``
   of a one-shot prefill of all 2,064 tokens (the same reading is logged
   at each depth, for the dense model on the same prompt and for the
   mixture with uniform gates); layer 0's bf16 mixture must be within
   ``MOE_LAYER_TOL`` of the reference's contraction in f32, and planted
   gate faults outside it. Then ``speculative_verify`` on the dense
   main-path model (K3 through ``prefill_continue``): a greedy draft of 8
   tokens is accepted whole with greedy's next token, a draft corrupted at
   index 5 is cut there with greedy's token, decoding on from the accepted
   point reproduces greedy, and the verify rows' logits are bitwise the
   greedy decode steps'.
16. Training (``llama.loss_fn`` / ``train_step``) at Llama-3-8B widths cut to
   8 layers (``TRAIN_LAYERS``; 2.80 B parameters), a batch of 2 x 2,048
   tokens, random weights (seed 0). The bf16 gradients are held against an
   f32 step's on the same weights, upcast, as the largest relative error
   over the parameters, within ``TRAIN_GRAD_TOL``; the same reading with a
   planted fault (``TRAIN_FAULTS``: the causal mask dropped, the targets
   shifted by one) must land outside it; the bf16 loss within
   ``TRAIN_LOSS_TOL`` of the f32 one. Two f32 steps on the same batch: the
   second's loss must be lower. Two bf16 steps, and a third under
   ``torch.profiler`` (the device's busy time by kind). Each step's wall
   (forward, backward and update, synced), tokens/s and the peak device
   memory of each stage are logged. A small f32 model's gradients and step
   on the card must agree with the CPU's within 1e-4; K4 called with CUDA
   inputs that require grad must raise (its output would carry no
   gradient). The path launches none of K1-K8.
17. The parallel training paths on a process group of world size 1 over
   NCCL (NCCL refuses two ranks on one card): ring and Ulysses gradients on
   layer 0's q/k/v of 4,096 tokens (f32) against the dense oracle's
   (``dense_attention_reference``), within ``SP_GRAD_TOL``; the GPipe
   pipeline (``models/pipeline.py``, 1 stage, 4 microbatches, 4 f32 layers
   at Llama-3-8B widths, 4 x 512 tokens) against ``loss_fn``'s loss and
   gradients; the expert-parallel step (``models/expert_parallel.py``,
   Mixtral-8x7B's 8 experts at Llama-3-8B widths cut to 2 layers, bf16, one
   1,024-token sequence) against the single-device gradients, each rank
   holding only its slices before and after a step. No K1-K8 launch.
18. The tensor-parallel train step (``models/tensor_parallel.py``: heads,
   FFN hidden columns and vocabulary over tp, activations sharded over the
   sequence, a vocabulary-parallel cross entropy) at Llama-3-8B widths on a
   process group of world size 1 over NCCL, (dp, tp, ep) = (1, 1, 1): in
   f32 at 2 layers (``TP_CHECK_LAYERS``) on 2 x 2,048 tokens against the
   one-device ``llama._loss_and_grads`` on the same card, the loss within
   ``TP_LOSS_TOL`` and each parameter's gradient slice within
   ``TP_GRAD_TOL`` of the largest magnitude of the reference's gradient,
   the planted fault (the loss shift flipped) outside that bound; then two
   timed bf16 steps at ``TRAIN_LAYERS`` layers (``step_s``,
   ``tokens_per_s``, ``peak_GiB``). No K1-K8 launch. Then the multi-chip
   dryrun, ``dryrun.dryrun_multichip(1)`` (its own rank process: the
   tp/ep step, the pipeline, ring and Ulysses attention, the sharded and
   ragged sharded decode with K5 and K7 at the dryrun's head_dim 16, the
   connector's interconnect handoff with K1 and K2), every leg's check.

Prints the card's name and power limit, a line with the script's total
wall, a ``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero, with no result line, on any failure or
when no CUDA device is present.

    python3 chip_smoke.py --cards N

runs instead, on N >= 2 cards of one host, the legs that one card cannot
show: the ICI handoff (phase 13, every check) over the mesh ``[cuda:0,
cuda:1]``, so that K1 runs on one card, the packed blocks cross to the
other as a peer copy and K2 and engine B's decode run there; the
long-context path (phase 14, every check) at world size N over NCCL, one
process a card (``--long-context-rank``, spawned by the script itself); and
the parallel training path (phase 17, every check) at world size N, one
process a card (``--parallel-train-rank``): the ring and Ulysses gradients
across N ranks, the pipeline at N stages and the expert-parallel step at
(dp, tp, ep) = (1, 2, N / 2); and phase 18 at world size N: the
tensor-parallel step at (1, N, 1), one process a card
(``--tensor-parallel-rank``; the planted fault there is the norms'
gradients left unsummed over tp), and ``dryrun_multichip(N)`` (at 4 cards
the dryrun's mesh (2, 2, 1); its decode legs launch K5 and K7 at N NCCL
ranks).
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field, replace

HERE = os.path.dirname(os.path.abspath(__file__))


# Main-path geometry: Meta-Llama-3-8B's published config.json widths.
LLAMA3_8B = dict(
    vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, block_tokens=16, rope_theta=500000.0,
)
PROMPTS = 4
PROMPT_TOKENS = 2048
DECODE_STEPS = 16
# The round trip at head_dim 96: microsoft/Phi-3-mini-4k-instruct's
# config.json (hidden 3072, 32 layers, 32 heads and 32 KV heads, intermediate
# 8192, vocab 32064, rope_theta 10000), a Llama block (RMSNorm, RoPE,
# SwiGLU) at full depth; a token's KV is 384 KiB, three times Llama-3-8B's.
PHI3_MINI = dict(
    vocab=32064, dim=3072, n_layers=32, n_heads=32, n_kv_heads=32,
    ffn_dim=8192, block_tokens=16, rope_theta=10000.0,
)
# Two shorter round trips at other models' attention and KV widths in a Llama
# block, cut to 2 layers (neither model is a Llama block): Phi-2's
# (microsoft/phi-2 config.json: hidden 2560, 32 heads and KV heads, head_dim
# 80, intermediate 10240, vocab 51200) and Gemma-2B's (google/gemma-2b
# config.json: hidden 2048, 8 heads over 1 KV head, head_dim 256,
# intermediate 16384, vocab 256000).
PHI2_ATTENTION = dict(
    vocab=51200, dim=2560, n_layers=2, n_heads=32, n_kv_heads=32,
    ffn_dim=10240, block_tokens=16, rope_theta=10000.0,
)
GEMMA_2B_ATTENTION = dict(
    vocab=256000, dim=2048, n_layers=2, n_heads=8, n_kv_heads=1,
    ffn_dim=16384, block_tokens=16, rope_theta=10000.0,
)
# Each runs the main path (prefill -> save -> lookup/load -> 16 decode steps
# on two engines) on a store of its own: (path, geometry, model id, store
# bytes, store unit). Phi-3's 4 x 2,048-token prompts hold 3 GiB of KV in
# 96 KiB blocks (3 units a key), Phi-2's 2-layer ones 160 MiB in 80 KiB
# blocks (5 units), Gemma-2B's 16 MiB in 8 KiB blocks (1 unit).
ROUND_TRIPS = (
    ("prefill_store_decode_phi3", PHI3_MINI, "phi-3-mini", 4 << 30, 32 << 10),
    ("prefill_store_decode_phi2", PHI2_ATTENTION, "phi-2-attention", 512 << 20, 16 << 10),
    ("prefill_store_decode_gemma2b", GEMMA_2B_ATTENTION, "gemma-2b-attention", 256 << 20,
     8 << 10),
)

# Engine phase: round 1 prompts of SHARED + TAIL tokens (a SPAN-token stretch
# of the tail occurs twice, so the n-gram drafter proposes), round 2 keeps
# KEEP tokens of each and appends NEW; GEN tokens generated per request.
ENGINE = dict(shared=512, tail=512, span=64, keep=768, new=256, gen=64)
ENGINE_BLOCKS = 1024  # 2 GiB of bf16 KV at Llama-3-8B width
ENGINE_REQ_BLOCKS = 72
# bf16 prompt blocks against the model's own one-shot prefill: a prefix hit
# resumes its suffix through K3 (f32 softmax, output rounded to bf16) where
# the oracle runs K4 (p rounded to bf16 before PV), so values differ by a few
# bf16 ulps, compounded over 32 layers; a wrong or stale block differs by
# O(1). allclose(rtol=atol=0.1).
ENGINE_VERIFY_TOL = 0.1
SMALL_ENGINE = dict(shared=32, tail=32, span=8, keep=48, new=16, gen=16)
# The int8 round trip's store unit: the smallest ServerConfig allows. An int8
# data block (16 tokens x 8 KV heads x 128) is 16 KiB and a scale block 512
# B, and the store allocates whole units, so each takes one: 65,536 keys x
# 16 KiB = 1 GiB for the 4 x 2,048-token prefixes, half of a 2 GiB pool (at
# the main path's 32 KiB unit they would take the whole pool).
INT8_STORE_UNIT = 16 << 10
SHARDED_CONTEXT = 32768  # tokens of the sharded decode's one request

# What each kernel's design is now (the ``kernels`` line's ``design``).
DESIGNS = {
    "gather_blocks": "TMA bulk-copy ring over up to 64 caches a launch",
    "scatter_blocks": "TMA bulk-copy ring over up to 64 caches a launch",
    "paged_decode_attention": "split-KV fold, cp.async ring, in-order split merge",
    "flash_prefill": "bf16: wgmma fed by a TMA/mbarrier ring; f32: CUDA cores",
    "paged_decode_attention_ragged": "K3's split-KV fold over a flat page list",
    "paged_decode_attention_stats": "K3's split-KV fold; rows of more than 16 splits merge "
                                    "in a two-level tree across the card",
    "paged_decode_attention_ragged_stats": "K6's fold, raw statistics; its splits merged by "
                                           "the last CTA (a thread-block cluster merge "
                                           "measured slower)",
    "paged_decode_attention_quantized": "int8-native split-KV fold: 16-byte lanes, exact "
                                        "byte-permute widening, scales once per token",
}
TPU_KERNELS = {
    "gather_blocks": ("infinistore_tpu/tpu/paged.py:115", "paged_copy.cu"),
    "scatter_blocks": ("infinistore_tpu/tpu/paged.py:135", "paged_copy.cu"),
    "paged_decode_attention": ("infinistore_tpu/tpu/paged_attention.py:209", "paged_attention.cu"),
    # bf16 on the tensor cores (timed below), f32 on the CUDA cores.
    "flash_prefill": ("infinistore_tpu/tpu/flash_prefill.py:152", "flash_prefill_wgmma.cu",
                      "flash_prefill.cu"),
    "paged_decode_attention_ragged": ("infinistore_tpu/tpu/paged_attention.py:555",
                                      "paged_attention_ragged.cu"),
    "paged_decode_attention_stats": ("infinistore_tpu/tpu/paged_attention.py:250",
                                     "paged_attention_stats.cu"),
    "paged_decode_attention_ragged_stats": ("infinistore_tpu/tpu/paged_attention.py:575",
                                            "paged_attention_ragged_stats.cu"),
    "paged_decode_attention_quantized": ("infinistore_tpu/tpu/kv_quant.py:107", "kv_quant.cu"),
}
ENGINE_KERNELS = ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill",
                  "paged_decode_attention_ragged")
# The kernels each path must run (its launch counts are zeroed just before it).
PATH_KERNELS = {
    "prefill_store_decode": ("gather_blocks", "scatter_blocks", "paged_decode_attention",
                             "flash_prefill"),
    # The round trip at head_dim 96, 80 and 256 (``ROUND_TRIPS``).
    **{path: ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill")
       for path, *_ in ROUND_TRIPS},
    "int8_round_trip": ("gather_blocks", "scatter_blocks", "paged_decode_attention_quantized"),
    "engine": ENGINE_KERNELS,
    "int8_engine": ENGINE_KERNELS,
    "sharded_decode": ("paged_decode_attention_stats", "paged_decode_attention_ragged_stats"),
    "disagg": ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill"),
    # The disagg demo's defaults (``disagg.demo_config()``: f32, head_dim 16).
    "disagg_demo": ("gather_blocks", "scatter_blocks", "paged_decode_attention",
                    "flash_prefill"),
    "cluster": ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill"),
    "vllm_v1": ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill"),
    "serving_cli": ("gather_blocks", "scatter_blocks", "paged_decode_attention",
                    "paged_decode_attention_ragged"),
    "ici_handoff": ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill"),
    "long_context": ("gather_blocks", "scatter_blocks", "paged_decode_attention"),
    "moe_spec": ("scatter_blocks", "paged_decode_attention", "flash_prefill"),
    # The training paths run no kernel: their attention is the dense,
    # differentiable one (every launch count must stay 0, checked in main).
    "train": (),
    "parallel_train": (),
    "tensor_parallel": (),
    # The dryrun's sharded and ragged sharded decode legs (K5, K7) and its
    # handoff (K1, K2); its training and attention legs launch none.
    "dryrun": ("paged_decode_attention_stats", "paged_decode_attention_ragged_stats",
               "gather_blocks", "scatter_blocks"),
}
# Paths whose every K4 launch is bf16, so must take the tensor-core kernel.
BF16_K4_PATHS = ("prefill_store_decode", "engine", "int8_engine", "disagg", "cluster", "vllm_v1",
                 "ici_handoff", "moe_spec", *(path for path, *_ in ROUND_TRIPS))
# Paths whose every K1/K2 launch moves 16-byte aligned blocks, so must take
# the TMA bulk ring.
BULK_COPY_PATHS = ("prefill_store_decode", "int8_round_trip", "engine", "int8_engine", "disagg",
                   "cluster", "vllm_v1", "ici_handoff", "long_context", "moe_spec",
                   *(path for path, *_ in ROUND_TRIPS))
# The disagg path: greedy tokens a leg, the fallback leg's retry deadline, and
# rounds of its five legs (the first pays every first use: pinned staging,
# the prefetch arena's page locking, the store pool's first touch).
DISAGG_GEN_TOKENS = 4
DISAGG_FALLBACK_RETRY_S = 0.05
DISAGG_ROUNDS = 3
# The cluster path: serving members at start (a fourth server joins), each a
# 2 GiB store in 32 KiB units (one K or V block of a layer), R=2.
CLUSTER_MEMBERS = 3
CLUSTER_STORE_BYTES = 2 << 30
CLUSTER_BLOCK_BYTES = 32 << 10
CLUSTER_RESHARD_TIMEOUT_S = 600.0
# The vllm_v1 path: engine A's prompts arrive in chunked-prefill steps of
# V1_CHUNK_TOKENS scheduled tokens; engine B's requests are the prompts plus
# V1_SUFFIX_TOKENS new tokens. Its store: 2 GiB in 32 KiB units.
V1_CHUNK_TOKENS = 1024
V1_SUFFIX_TOKENS = 16
# The serving_cli path: the benchmark's decode-wave rows (``--wave``), the
# fleet client's roots, and how long to wait for its catalog.
SERVING_WAVE = 8
FLEET_ROOTS = 4
FLEET_READY_S = 180.0
# The long-context path: one prompt's tokens through prefill_ring. The
# ring's online softmax divides by its denominator after PV, the dense
# oracle before, both in f32, so an attention output may round to a
# neighbouring bf16 value; such flips compound over 32 layers of bf16
# activations (the engine's ENGINE_VERIFY_TOL has the same source), while a
# wrong chunk order, position or mask moves values by O(1):
# allclose(rtol=atol=0.1). Ulysses and the ring on the same inputs differ by
# one bf16 rounding of the output (the kernel phase's bf16 tolerance, as
# rtol=atol).
LONG_CONTEXT_TOKENS = 4096
LONG_CONTEXT_TOL = 0.1
ULYSSES_TOL = 2e-2
# The moe_spec path: Mixtral-8x7B's expert count (its published
# config.json) at Llama-3-8B widths, cut to 4 layers: the dense soft mixture
# holds every expert, 2.8 GB of bf16 weights a layer, so 32 layers (90 GB)
# would not fit the card. Its decode (K3, f32 softmax, bf16 output) and its
# one-shot prefill (K4, probabilities rounded to bf16 before PV; other GEMM
# shapes) differ by one bf16 ulp of a layer's output. The expert weights are
# drawn as the JAX package draws them (scaled by 1/sqrt of the first axis,
# E), so a mixture layer's output is about 10^4 times a dense FFN's and is
# the whole residual stream: the ulps add up layer by layer, where a dense
# model's stay level. On an H100 the last logits (up to 4.5) read 0.039,
# 0.047, 0.064 and 0.109 from the one-shot prefill at depths 1-4, the
# dense model 0.031-0.033 at each (logged by depth every run):
# allclose(rtol=atol=0.1) holds both.
MOE_EXPERTS = 8
MOE_LAYERS = 4
MOE_TOL = 0.1
# The mixture itself: layer 0's bf16 _moe on MOE_LAYER_TOKENS tokens
# against the reference's contraction einsum("bse,bsef,efd->bsd") in plain
# f32 over the same weights, as max abs error over the reference's max
# magnitude. bf16 rounds gate_up, the SwiGLU product, the gates, the gated
# product and the output, each 2^-9 relative; the planted faults
# (MOE_FAULTS, in the f32 gates: the expert order reversed, the top expert
# alone) move the output by more than its range. On an H100 the sound
# mixture reads 0.0070, the faults 1.29 and 1.44; MOE_LAYER_TOL sits
# between, and the check raises if a fault reads inside it.
MOE_LAYER_TOKENS = 256
MOE_LAYER_TOL = 0.03
SPEC_DRAFT = 8
# The train path: Llama-3-8B widths cut to TRAIN_LAYERS layers (2.80 B
# parameters: 1.74 B in the layers, 1.05 B in embed and lm_head), a batch of
# TRAIN_BATCH x TRAIN_TOKENS tokens, random weights (seed 0). At 4 layers
# the peak was 32.4 GiB (the bf16 gradients computed while the f32 weights
# and gradients are held), about 4.5 GiB a layer on top of the vocabulary's
# and the f32 copies' share: 8 layers leave 25 GiB of the card free, 16
# would not fit. The bf16
# gradients are held against an f32 step on the same weights, upcast: for
# each parameter ||g_bf16 - g_f32|| / ||g_f32||, the largest over the
# parameters. bf16 rounds every activation, the weights and the gradients
# (2^-9 relative each), and the error compounds through 4 layers and back.
# Planted faults (TRAIN_FAULTS, in the bf16 loss: the causal mask dropped,
# the targets shifted by one position) must read outside TRAIN_GRAD_TOL. On
# an H100 at 4 layers the sound reading was 0.0166, the faults 2.31 (mask
# dropped) and 0.931 (targets shifted); TRAIN_GRAD_TOL sits between.
# The bf16 loss against the f32 one: TRAIN_LOSS_TOL, the CPU tests' bf16
# bound. In f32, lr * g clears the weights' spacing, so the f32 step is the
# one whose loss must fall.
TRAIN_LAYERS = 8
TRAIN_BATCH = 2
TRAIN_TOKENS = 2048
TRAIN_STEPS = 2
TRAIN_GRAD_TOL = 0.1
TRAIN_LOSS_TOL = 2e-2
TRAIN_FAULTS = ("mask_dropped", "targets_shifted")
# The small f32 model's step on the card against the CPU's (loss, every
# gradient and new parameter): sums in another order, within 1e-4.
SMALL_TRAIN = dict(vocab=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
                   block_tokens=16)
SMALL_TRAIN_TOL = 1e-4
# The parallel_train path: ring and Ulysses gradients on layer 0's q/k/v of
# SP_TOKENS tokens, in f32, against the dense oracle's (relative norm; f32
# sums in another order); the pipeline over PP_LAYERS f32 layers (PP_BATCH
# x PP_TOKENS tokens, PP_MICROBATCHES microbatches) against loss_fn's loss
# and gradients; the expert-parallel step with MOE_EXPERTS experts at
# Llama-3-8B widths cut to EP_LAYERS layers, bf16 (4 B parameters: 8 GB,
# and as much again for the gradients), one sequence of EP_TOKENS tokens a
# dp shard, against the single-device gradients (two bf16 computations of
# one gradient, their sums split differently across the ranks: held to the
# bf16-against-f32 bound).
SP_TOKENS = 4096
SP_GRAD_TOL = 1e-4
PP_LAYERS = 4
PP_BATCH = 4
PP_TOKENS = 512
PP_MICROBATCHES = 4
PP_GRAD_TOL = 1e-4
PARALLEL_LOSS_TOL = 1e-4
EP_LAYERS = 2
EP_TOKENS = 1024
EP_GRAD_TOL = TRAIN_GRAD_TOL
EP_LOSS_TOL = TRAIN_LOSS_TOL
# The tensor_parallel path: the tp step (models/tensor_parallel.py) at
# (dp, tp, ep) = (1, N, 1) on N ranks. Its check, in f32 at TP_CHECK_LAYERS
# layers on TP_BATCH x TP_TOKENS tokens, against the one-device
# llama._loss_and_grads on the same card: the loss within TP_LOSS_TOL; each
# parameter's gradient slice within TP_GRAD_TOL of the largest magnitude of
# the reference's gradient for that parameter (the split sums round in
# another order); the planted fault outside that bound (at tp > 1 the norms'
# gradients left unsummed over tp, at tp = 1, where that changes nothing,
# the loss shift flipped). Then TP_STEPS timed bf16 steps at TRAIN_LAYERS
# layers, beside the train path's one-card step.
TP_CHECK_LAYERS = 2
TP_BATCH = 2
TP_TOKENS = 2048
TP_LOSS_TOL = 1e-5
TP_GRAD_TOL = 1e-4
TP_STEPS = 2


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _timing():
    """The package's timing helpers (``cuda/timing.py``), imported at first
    use: a probe may load this file for its shapes beside another tree's
    package."""
    from infinistore_tpu_torch.cuda import timing

    return timing


def host_us(torch, fn, calls: int = 50) -> float:
    return _timing().host_us(torch, fn, calls)


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    return _timing().bound_ms(nbytes, flops, dtype_name)


def max_err(a, b) -> float:
    return _timing().max_err(a, b)


def peak_dtype(t) -> str:
    """The key of ``PEAK_FLOPS`` for work on ``t``'s dtype: the card's peak
    rate for that input type (bf16 products are exact in f32, so a bf16
    kernel that accumulates in f32 is held to the bf16 rate)."""
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_phase(torch, timer, nomerge):
    import torch.nn.functional as F

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp
    from infinistore_tpu_torch.cuda import paged
    from infinistore_tpu_torch.cuda import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(1234)
    cfg = LLAMA3_8B
    bt, kvh, d, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["dim"] // cfg["n_heads"], cfg["n_heads"]
    nb = PROMPT_TOKENS // bt  # blocks per request
    results = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)

    # K1 / K2: one request's blocks out of (into) a 1024-block layer cache.
    num_blocks = 1024
    ids = torch.randperm(num_blocks, generator=g, device="cuda")[:nb].to(torch.int32)
    ids_long = ids.long()
    for dtype in (torch.float32, torch.bfloat16):
        cache = randn((num_blocks, bt, kvh, d), dtype)
        got = paged.gather_blocks(cache, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, paged.gather_blocks_plain(cache, ids)):
            raise AssertionError(f"gather_blocks != index_select ({dtype})")
        blocks = randn((nb, bt, kvh, d), dtype)
        got = paged.scatter_blocks(cache.clone(), ids, blocks)
        torch.cuda.synchronize()
        if not torch.equal(got, paged.scatter_blocks_plain(cache.clone(), ids, blocks)):
            raise AssertionError(f"scatter_blocks != index_copy_ ({dtype})")
        log(f"K1/K2 {dtype}: bitwise equal to the plain versions")
        if dtype is torch.bfloat16:
            nbytes = 2 * nb * blocks[0].numel() * blocks.element_size() + ids.numel() * 4
            bms, by = bound_ms(nbytes, 0.0, "bfloat16")
            results["gather_blocks"] = dict(
                max_abs_err=0.0,
                ms=timer.ms(lambda: paged.gather_blocks(cache, ids)),
                plain_ms=timer.ms(lambda: paged.gather_blocks_plain(cache, ids)),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: cache.index_select(0, ids_long)),
            )
            results["scatter_blocks"] = dict(
                max_abs_err=0.0,
                ms=timer.ms(lambda: paged.scatter_blocks(cache, ids, blocks)),
                plain_ms=timer.ms(lambda: paged.scatter_blocks_plain(cache, ids, blocks)),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: cache.index_copy_(0, ids_long, blocks)),
            )
            results["gather_blocks"]["host_us"] = host_us(
                torch, lambda: paged.gather_blocks(cache, ids))
            results["scatter_blocks"]["host_us"] = host_us(
                torch, lambda: paged.scatter_blocks(cache, ids, blocks))
    for name, shapes in _copy_kernel_check(torch, timer, g, paged, _ext).items():
        results[name]["shapes"] = shapes

    # K3: a wave of 4 requests at 2048 tokens of context.
    bsz = PROMPTS
    n_cache = bsz * nb + 16
    tables = torch.randperm(n_cache, generator=g, device="cuda")[: bsz * nb].to(torch.int32).reshape(bsz, nb)
    full = torch.full((bsz,), PROMPT_TOKENS, dtype=torch.int32, device="cuda")
    ragged = torch.tensor([PROMPT_TOKENS, PROMPT_TOKENS - 1, 1000, 0], dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = randn((bsz, h, d), dtype)
        kc = randn((n_cache, bt, kvh, d), dtype)
        vc = randn((n_cache, bt, kvh, d), dtype)
        err = 0.0
        for lens in (full, ragged):
            got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
            again = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
            want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens)
            torch.cuda.synchronize()
            err = max(err, max_err(got, want))
            if not torch.equal(got, again):
                raise AssertionError(f"paged_decode_attention {dtype}: two launches differ")
        if not err <= tol:
            raise AssertionError(f"paged_decode_attention {dtype}: max abs err {err} > {tol}")
        if float(got[3].float().abs().max()) != 0.0:
            raise AssertionError("paged_decode_attention: seq_len 0 must give zeros")
        log(f"K3 {dtype}: max abs err {err:.3e} (tol {tol}); two launches bitwise equal")
        if dtype is torch.bfloat16:
            tokens = int(full.sum())
            nbytes = (2 * tokens * kvh * d + 2 * bsz * h * d) * kc.element_size() + tables.numel() * 4 + bsz * 4
            bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, peak_dtype(q))
            results["paged_decode_attention"] = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: pa.paged_decode_attention_batched(q, kc, vc, tables, full)),
                plain_ms=timer.ms(lambda: pa.paged_decode_attention_plain_batched(q, kc, vc, tables, full)),
                bound_ms=bms, bound_by=by, library_ms=None,
                host_us=host_us(torch, lambda: pa.paged_decode_attention_batched(
                    q, kc, vc, tables, full)),
            )
            log(f"K3 bf16: {bms / results['paged_decode_attention']['ms']:.3f} of its bound; "
                f"wrapper host time {results['paged_decode_attention']['host_us']:.1f} us "
                "per call")

    # K4: one 2048-token prompt, all 32 heads (one layer of prefill); in bf16
    # also the engine's 1,024-token prompts. bf16 runs on the tensor cores,
    # f32 on the CUDA cores; each launch must take its dtype's kernel.
    for dtype, tol, s in ((torch.float32, 1e-5, PROMPT_TOKENS),
                          (torch.bfloat16, 2e-2, ENGINE["shared"] + ENGINE["tail"]),
                          (torch.bfloat16, 2e-2, PROMPT_TOKENS)):
        q = randn((1, s, h, d), dtype)
        k = randn((1, s, kvh, d), dtype)
        v = randn((1, s, kvh, d), dtype)
        before = dict(_ext.LAUNCHES)
        got = fp.flash_prefill_attention(q, k, v, causal=True)
        wgmma = _ext.LAUNCHES["flash_prefill_wgmma"] - before["flash_prefill_wgmma"]
        if _ext.LAUNCHES["flash_prefill"] - before["flash_prefill"] != 1 or \
                wgmma != int(dtype is torch.bfloat16):
            raise AssertionError(f"flash_prefill {dtype}: took the wrong kernel")
        want = fp.flash_prefill_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"flash_prefill {dtype} S={s}: max abs err {err} > {tol}")
        log(f"K4 {dtype} S={s}: max abs err {err:.3e} (tol {tol})")
        if dtype is torch.bfloat16:
            pairs = s * (s + 1) // 2  # causal (query, key) pairs per head
            flops = 4.0 * d * h * pairs
            nbytes = (2 * s * h * d + 2 * s * kvh * d) * q.element_size()
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: fp.flash_prefill_attention(q, k, v, causal=True)),
                plain_ms=timer.ms(lambda: fp.flash_prefill_plain(q, k, v, causal=True)),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
            )
            log(f"K4 bf16 S={s}: {json.dumps(row)}; {bms / row['ms']:.3f} of its bound")
            if s == PROMPT_TOKENS:
                results["flash_prefill"] = row
                us = host_us(torch, lambda: fp.flash_prefill_attention(q, k, v, causal=True))
                log(f"K4 bf16 S={s}: wrapper host time {us:.1f} us per call")

    results["paged_decode_attention"]["prefill_continue"] = _prefill_continue_check(
        torch, timer, g, pa)
    results["paged_decode_attention"].update(_k3_serving_shapes_check(torch, timer, g, pa))
    (results["paged_decode_attention_ragged"],
     results["paged_decode_attention_ragged_stats"]) = _ragged_kernel_check(torch, timer, g, pa,
                                                                            nomerge)
    results["paged_decode_attention_ragged"]["engine_wave"] = _engine_wave_check(
        torch, timer, g, pa)
    for name, row in _decode_wave_leg_check(torch, timer).items():
        results[name]["decode_wave_leg"] = row
    # K8 and K5 at K3's wave (drawn last, so the earlier kernels keep their inputs).
    results["paged_decode_attention_quantized"] = _quant_kernel_check(
        torch, timer, g, tables, (full, ragged), n_cache)
    results["paged_decode_attention_stats"] = _stats_kernel_check(
        torch, timer, g, tables, (full, ragged), n_cache, nomerge)
    # The shapes beyond the main path's: head_dim 8, 16, 32, 64, 80, 96 and
    # 256, 7 query heads a KV head. Each kernel's row lists the head_dims
    # and groups it ran here.
    taken = _shapes_taken_check(torch, timer, g)
    for name, row in results.items():
        if name not in taken:
            continue
        row["shapes_taken"] = taken[name]
        main = {(d, h // kvh)}
        if name in ("paged_decode_attention", "paged_decode_attention_ragged"):
            main.add((64, 4))  # the decode-wave leg's (benchmark.decode_wave_inputs)
        runs = main | {(r["head_dim"], r["group"]) for r in taken[name].values()}
        row["head_dims"] = sorted({hd for hd, _ in runs})
        row["groups"] = sorted({gr for _, gr in runs})
    return results


# K1/K2 at the shapes of the paths' batched calls: the writer's and the
# reader's layer ([K, V] x 128 blocks), the engine's save snapshot (every
# layer's K and V, 64 caches x 64 blocks), the install span's scatter (64
# caches x the engine's 48-block hit) and the int8 round trip's layer (16 KiB
# int8 data blocks, 512 B f32 scale blocks).
COPY_NUM_BLOCKS = 1024
COPY_SHAPES = {
    "gather_blocks": {"a_writer_layer": (2, 128), "b_engine_snapshot": (64, 64),
                      "e_ici_handoff": (64, 128)},
    "scatter_blocks": {"a_reader_layer": (2, 128), "c_install_span": (64, 48),
                       "e_ici_handoff": (64, 128), "f_long_context": (64, 256)},
}


def copy_inputs(torch, g, dtype, block_shape, caches, device="cuda"):
    """``caches`` caches of ``COPY_NUM_BLOCKS`` blocks, random ids for every
    block count of ``COPY_SHAPES`` (and the table's 128) and a pool of
    source blocks, all drawn from ``g`` on ``device``."""
    def draw(shape):
        if dtype is torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=device, dtype=dtype)
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return dict(
        caches=[draw((COPY_NUM_BLOCKS, *block_shape)) for _ in range(caches)],
        ids={n: torch.randperm(COPY_NUM_BLOCKS, generator=g, device=device)[:n].to(torch.int32)
             for n in (256, 128, 64, 48)},
        src=draw((max(c * n for shapes in COPY_SHAPES.values() for c, n in shapes.values()),
                  *block_shape)),
    )


def copy_calls(inp, gather, scatter, gather_many=None, scatter_many=None):
    """(kernel, shape) -> a call at that shape: through ``gather_many`` /
    ``scatter_many`` when given (one call for every cache), else the
    sequence the paths ran before the batched entries existed (one
    ``gather`` / ``scatter`` a cache, and the ``torch.cat`` the writer put
    around its layer's two gathers; the snapshot and the install span kept
    their per-cache results as they were). The table's single-cache shape
    always takes ``gather`` / ``scatter``."""
    import torch

    cs, ids, src = inp["caches"], inp["ids"], inp["src"]
    calls = {
        ("gather_blocks", "table"): lambda: gather(cs[0], ids[128]),
        ("scatter_blocks", "table"): lambda: scatter(cs[0], ids[128], src[:128]),
    }
    for kind, shapes in COPY_SHAPES.items():
        for name, (count, n) in shapes.items():
            if count > len(cs):
                continue
            sub, b = cs[:count], ids[n]
            if kind == "gather_blocks":
                if gather_many is not None:
                    fn = (lambda sub=sub, b=b: gather_many(sub, b))
                elif name == "a_writer_layer":
                    fn = (lambda sub=sub, b=b: torch.cat([gather(c, b) for c in sub]))
                else:
                    fn = (lambda sub=sub, b=b: [gather(c, b) for c in sub])
            else:
                packed = src[: count * n]
                if scatter_many is not None:
                    fn = (lambda sub=sub, b=b, p=packed: scatter_many(sub, b, p))
                else:
                    fn = (lambda sub=sub, b=b, p=packed, n=n:
                          [scatter(c, b, p[i * n:(i + 1) * n]) for i, c in enumerate(sub)])
            calls[(kind, name)] = fn
    return calls


def copy_matches(torch, inp, key, mine, theirs) -> bool:
    """Whether ``copy_calls(inp, *mine)[key]`` gives bitwise what
    ``copy_calls(inp, *theirs)[key]`` gives: the gathered blocks, or every
    cache after the scatter (each side scatters into its own clones)."""
    if key[0] == "gather_blocks":
        got = copy_calls(inp, *mine)[key]()
        return torch.equal(got, copy_calls(inp, *theirs)[key]())
    sides = []
    for calls in (mine, theirs):
        cloned = dict(inp, caches=[c.clone() for c in inp["caches"]])
        copy_calls(cloned, *calls)[key]()
        sides.append(cloned["caches"])
    return all(torch.equal(a, b) for a, b in zip(*sides))


def _copy_kernel_check(torch, timer, g, paged, _ext):
    """K1/K2 at ``COPY_SHAPES`` in bf16 and f32 and at the int8 round trip's
    data and scale blocks: bitwise the plain versions, every launch on the
    bulk route; timed (bf16, int8) beside their bound and, at the bf16
    shapes, the unfused sequence (``copy_calls`` without the batched
    entries). Returns kernel -> shape -> numbers."""
    bt, kvh = LLAMA3_8B["block_tokens"], LLAMA3_8B["n_kv_heads"]
    d = LLAMA3_8B["dim"] // LLAMA3_8B["n_heads"]
    singles = (paged.gather_blocks, paged.scatter_blocks)
    fused = (*singles, paged.gather_blocks_many, paged.scatter_blocks_many)
    plain = (paged.gather_blocks_plain, paged.scatter_blocks_plain,
             paged.gather_blocks_many_plain, paged.scatter_blocks_many_plain)
    cases = (("bf16", torch.bfloat16, (bt, kvh, d), 64),
             ("f32", torch.float32, (bt, kvh, d), 64),
             ("d_int8_data", torch.int8, (bt, kvh, d), 2),
             ("d_int8_scales", torch.float32, (bt, kvh, 1), 2))
    out = {"gather_blocks": {}, "scatter_blocks": {}}
    for label, dtype, block_shape, count in cases:
        inp = copy_inputs(torch, g, dtype, block_shape, count)
        calls = copy_calls(inp, *fused)
        for (kind, shape), fn in calls.items():
            before = dict(_ext.LAUNCHES)
            equal = copy_matches(torch, inp, (kind, shape), fused, plain)
            torch.cuda.synchronize()
            moved = _ext.LAUNCHES[kind] - before[kind]
            if moved < 1 or _ext.LAUNCHES[f"{kind}_bulk"] - before[f"{kind}_bulk"] != moved:
                raise AssertionError(
                    f"{kind} {shape} {label}: not every launch took the bulk route")
            if not equal:
                raise AssertionError(f"{kind} {shape} {label}: differs from the plain version")
            # Timed: bf16 at the batched shapes (the table's row is timed
            # above), int8 data and scales at the layer's.
            if not (shape != "table" and label == "bf16" or shape.startswith("a_")
                    and label.startswith("d_")):
                continue
            count_, n = COPY_SHAPES[kind][shape]
            block = inp["caches"][0][0]
            nbytes = 2 * count_ * n * block.numel() * block.element_size() + 4 * n
            bms, by = bound_ms(nbytes, 0.0, "bfloat16")
            ms = timer.ms(fn)
            row = dict(ms=ms, bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
                       caches=count_, blocks=n, block_bytes=block.numel() * block.element_size())
            if label == "bf16":
                unfused = copy_calls(inp, *singles)[(kind, shape)]
                row["unfused_ms"] = timer.ms(unfused, spin=count_)
            name = shape if label == "bf16" else f"{label}_{shape[2:]}"
            out[kind][name] = row
            log(f"{kind} {name}: {json.dumps(row)}")
        log(f"K1/K2 {label}: bitwise equal to the plain versions at every shape, "
            "every launch on the bulk route")
        del inp, calls
        torch.cuda.empty_cache()
    return out


def _slices(n_parts, width):
    """``n_parts`` disjoint, contiguous slices of ``width`` table entries."""
    part = width // n_parts
    return [slice(s * part, (s + 1) * part) for s in range(n_parts)]


def _slice_lens(lens, sl, bt):
    """The tokens of each row that fall in table slice ``sl``."""
    return [min(max(n - sl.start * bt, 0), (sl.stop - sl.start) * bt) for n in lens]


def _decode_bound(torch, q, distinct_pages, lens, bt, kvh, meta_bytes):
    """K3/K6's bound over the distinct pages its rows read (each read once),
    q and the output, and the page metadata; its operations at the card's
    peak for q's dtype."""
    d = q.shape[-1]
    nbytes = 2 * distinct_pages * bt * kvh * d * q.element_size() + \
        2 * q.numel() * q.element_size() + meta_bytes
    return bound_ms(nbytes, 4.0 * q.shape[1] * d * sum(lens), peak_dtype(q))


def _prefill_continue_check(torch, timer, g, pa):
    """K3 at the engine's prefill_continue shape: one request's 256-token
    suffix resumed over its 768-token prefix (``verify_step_batched``'s
    rows: 256 rows at contexts 769-1,024, all over one 72-block table, so
    the rows share their pages). Against its plain version in f32 (1e-5) and
    bf16 (2e-2), two launches bitwise equal; in bf16 timed, with its bound
    over the 64 distinct pages."""
    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    width, rows = ENGINE_REQ_BLOCKS, ENGINE["new"]
    n_cache = width + 16
    table = torch.randperm(n_cache, generator=g, device="cuda")[:width].to(torch.int32)
    tables = table[None].expand(rows, width).contiguous()
    lens_list = list(range(ENGINE["keep"] + 1, ENGINE["keep"] + rows + 1))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((rows, h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        args = (q, kc, vc, tables, lens)
        got = pa.paged_decode_attention_batched(*args)
        again = pa.paged_decode_attention_batched(*args)
        err = max_err(got, pa.paged_decode_attention_plain_batched(*args))
        torch.cuda.synchronize()
        if not err <= tol or not torch.equal(got, again):
            raise AssertionError(f"K3 {dtype} at prefill_continue's shape: max abs err {err} "
                                 f"(tol {tol}), two launches equal {torch.equal(got, again)}")
        log(f"K3 {dtype} at prefill_continue's shape: max abs err {err:.3e} (tol {tol}); two "
            "launches bitwise equal")
    bms, by = _decode_bound(torch, q, -(-lens_list[-1] // bt), lens_list, bt, kvh,
                            tables.numel() * 4 + rows * 4)
    row = dict(max_abs_err=err, ms=timer.ms(lambda: pa.paged_decode_attention_batched(*args)),
               plain_ms=timer.ms(lambda: pa.paged_decode_attention_plain_batched(*args),
                                 iters=3),
               bound_ms=bms, bound_by=by)
    log(f"K3 bf16 at prefill_continue's shape ({rows} rows sharing one {width}-block table, "
        f"contexts {lens_list[0]}-{lens_list[-1]}): {json.dumps(row)}; "
        f"{bms / row['ms']:.3f} of its bound")
    return row


def _k3_serving_shapes_check(torch, timer, g, pa):
    """K3 at launches that paths make and no other check times: the
    vllm_v1 path's suffix (``PROMPTS`` requests x ``V1_SUFFIX_TOKENS`` rows,
    each request's rows over its own table of the path's width, contexts
    2,049-2,064), the disagg path's decode step (one row over a 129-block
    table, context 2,049; the moe_spec path's decode steps have this
    shape), the long-context path's decode step (one row over a 257-block
    table, context 4,097) and ``speculative_verify``'s draft (``SPEC_DRAFT``
    rows over one 129-block table, contexts 2,049-2,056). bf16 against the
    plain version (2e-2), two launches bitwise equal; timed, with the bound
    over the distinct pages."""
    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    shapes = {
        "vllm_v1_suffix": (PROMPTS, -(-(PROMPT_TOKENS + V1_SUFFIX_TOKENS + DECODE_STEPS) // bt),
                           [PROMPT_TOKENS + 1 + j for j in range(V1_SUFFIX_TOKENS)]),
        "disagg_step": (1, -(-(PROMPT_TOKENS + DISAGG_GEN_TOKENS) // bt), [PROMPT_TOKENS + 1]),
        "long_context_step": (1, -(-(LONG_CONTEXT_TOKENS + DECODE_STEPS) // bt),
                              [LONG_CONTEXT_TOKENS + 1]),
        "spec_verify": (1, -(-(PROMPT_TOKENS + DECODE_STEPS) // bt),
                        [PROMPT_TOKENS + 1 + j for j in range(SPEC_DRAFT)]),
    }
    out = {}
    for name, (reqs, width, req_lens) in shapes.items():
        n_cache = reqs * width + 16
        tables = (torch.randperm(n_cache, generator=g, device="cuda")[: reqs * width]
                  .to(torch.int32).reshape(reqs, width)
                  .repeat_interleave(len(req_lens), dim=0).contiguous())
        lens_list = req_lens * reqs
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        q = torch.randn((len(lens_list), h, d), generator=g, device="cuda").to(torch.bfloat16)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(torch.bfloat16)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(torch.bfloat16)
        args = (q, kc, vc, tables, lens)
        got = pa.paged_decode_attention_batched(*args)
        again = pa.paged_decode_attention_batched(*args)
        err = max_err(got, pa.paged_decode_attention_plain_batched(*args))
        torch.cuda.synchronize()
        if not err <= 2e-2 or not torch.equal(got, again):
            raise AssertionError(f"K3 bf16 at the {name} shape: max abs err {err} (tol 2e-2), "
                                 f"two launches equal {torch.equal(got, again)}")
        bms, by = _decode_bound(torch, q, reqs * -(-max(req_lens) // bt), lens_list, bt, kvh,
                                tables.numel() * 4 + len(lens_list) * 4)
        row = dict(max_abs_err=err,
                   ms=timer.ms(lambda: pa.paged_decode_attention_batched(*args)),
                   plain_ms=timer.ms(lambda: pa.paged_decode_attention_plain_batched(*args),
                                     iters=3),
                   bound_ms=bms, bound_by=by, rows=len(lens_list), table_blocks=width)
        log(f"K3 bf16 at the {name} shape ({reqs} x {len(req_lens)} rows, {width}-block "
            f"tables, contexts {lens_list[0]}-{lens_list[-1]}): {json.dumps(row)}; "
            f"{bms / row['ms']:.3f} of its bound; two launches bitwise equal")
        out[name] = row
    return out


def _decode_wave_leg_check(torch, timer, wave=SERVING_WAVE, device="cuda"):
    """K6 and K3 on the serving_cli path's decode-wave leg's own inputs
    (``benchmark.decode_wave_inputs``: seed 0, f32, 8 query heads over 2 KV
    heads, head_dim 64, block 16, ``wave`` rows over 16-page tables, 8:1
    skewed, K6 over the pow2-padded page list). Each against its plain
    version (1e-5), two launches bitwise equal. With a ``timer`` (on the
    card) each is also timed: device time, its bound over the distinct pages
    the rows read, its wrapper host time a call, and its device time a call
    over ``benchmark.WAVE_REPS`` chained calls (``chained_ms``), as the leg's samples
    chain them (host wall over the chain). Returns {kernel: row}."""
    from infinistore_tpu_torch import benchmark
    from infinistore_tpu_torch.cuda import paged_attention as pa

    ragged, padded, x = benchmark.decode_wave_inputs(wave, device)
    m, bt, kvh = x.meta, x.k_cache.shape[1], x.k_cache.shape[2]
    rows = len(x.lens)
    distinct = len({int(m.pages[m.page_starts[r] + j]) for r, n in enumerate(x.lens)
                    for j in range(-(-n // bt))})
    kernels = {
        "paged_decode_attention_ragged": (
            ragged, lambda q: pa.paged_decode_attention_ragged_plain(
                q, x.k_cache, x.v_cache, x.pages, x.page_starts, x.seq_lens, x.table_width),
            (m.num_pages + 3 * rows + 1) * 4),
        "paged_decode_attention": (
            padded, lambda q: pa.paged_decode_attention_plain_batched(
                q, x.k_cache, x.v_cache, x.tables, x.seq_lens),
            x.tables.numel() * 4 + rows * 4),
    }
    out = {}
    for name, (run, plain, meta_bytes) in kernels.items():
        got, again = run(x.q), run(x.q)
        err = max_err(got, plain(x.q))
        if not err <= 1e-5 or not torch.equal(got, again):
            raise AssertionError(f"{name} f32 at the decode-wave leg: max abs err {err} (tol "
                                 f"1e-5), two launches equal {torch.equal(got, again)}")
        row = dict(max_abs_err=err, rows=rows, pages=m.num_pages, distinct_pages=distinct)
        if timer is not None:
            reps = benchmark.WAVE_REPS

            def chain(run=run):
                qc = x.q
                for _ in range(reps):
                    qc = run(qc)

            bms, by = _decode_bound(torch, x.q, distinct, x.lens, bt, kvh, meta_bytes)
            row.update(ms=timer.ms(lambda: run(x.q)),
                       plain_ms=timer.ms(lambda: plain(x.q), iters=3), bound_ms=bms,
                       bound_by=by, host_us=host_us(torch, lambda: run(x.q)),
                       chained_ms=timer.ms(chain, spin=reps) / reps)
        log(f"{name} f32 at the decode-wave leg ({rows} rows, contexts {x.lens[0]} and "
            f"{x.lens[-1]}, {m.num_pages} pages listed, {distinct} distinct): "
            f"{json.dumps(row)}; two launches bitwise equal")
        out[name] = row
    return out


def _engine_wave_check(torch, timer, g, pa):
    """K6 at the engine's own wave (the one ``_profile_wave`` profiles): 4
    requests, each an 8-token verification chunk at 1,024 tokens of
    context, the rows of a chunk sharing their pages. Against its plain
    version in f32 (1e-5) and bf16 (2e-2), bitwise K3 per row, two launches
    bitwise equal; in bf16 timed, with its wrapper host time and its bound
    over the distinct pages."""
    import numpy as np

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    width = ENGINE_REQ_BLOCKS
    n_cache = 4 * width + 16
    req_tables = np.random.default_rng(6).permutation(n_cache)[: 4 * width].astype(
        np.int32).reshape(4, width)
    ctx = ENGINE["shared"] + ENGINE["tail"]
    lens = [ctx + j for _ in range(4) for j in range(8)]
    row_tables = [req_tables[r // 8] for r in range(len(lens))]
    m = pa.build_ragged_wave(row_tables, lens, bt, pad_to_pow2=True)
    meta = [torch.from_numpy(x).cuda() for x in (m.pages, m.page_rows, m.page_starts,
                                                   m.seq_lens)]
    rows_k3 = pa._ragged_row_tables(meta[0], meta[2], width).contiguous()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((len(lens), h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)

        def run():
            return pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=width)

        def plain():
            return pa.paged_decode_attention_ragged_plain(q, kc, vc, meta[0], meta[2],
                                                          meta[3], width)

        got, again = run(), run()
        k3 = pa.paged_decode_attention_batched(q, kc, vc, rows_k3, meta[3])
        err = max_err(got, plain())
        torch.cuda.synchronize()
        if not err <= tol or not torch.equal(got, again) or not torch.equal(got, k3):
            raise AssertionError(f"K6 {dtype} at the engine's wave: max abs err {err} (tol "
                                 f"{tol}), two launches equal {torch.equal(got, again)}, "
                                 f"bitwise K3 {torch.equal(got, k3)}")
        log(f"K6 {dtype} at the engine's wave: max abs err {err:.3e} (tol {tol}); bitwise K3 "
            "per row, two launches bitwise equal")
    distinct = len({int(m.pages[m.page_starts[r] + j]) for r, n in enumerate(lens)
                    for j in range(-(-n // bt))})
    bms, by = _decode_bound(torch, q, distinct, lens, bt, kvh,
                            (m.num_pages + 3 * len(lens) + 1) * 4)
    row = dict(max_abs_err=err, ms=timer.ms(run), plain_ms=timer.ms(plain), bound_ms=bms,
               bound_by=by, host_us=host_us(torch, run))
    log(f"K6 bf16 at the engine's wave (4 x 8-token chunks at {ctx} tokens, {distinct} "
        f"distinct pages): {json.dumps(row)}; {bms / row['ms']:.3f} of its bound")
    return row


# K8's tolerances by q's dtype: against its plain version, the JAX package's
# contract (its kernel against the dequantise-then-decode reference); against
# K3 on q.float() over the f32-dequantised cache, 1e-5 plus, with bf16 q, the
# rounding of each f32 result to bf16 (2^-7 of the value).
K8_PLAIN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K8_K3_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _k8_contract(torch, kq, pa, q, kd, ks, vd, vs, tables, lens, got, what):
    """K8's contract on its output ``got``: within ``K8_PLAIN_TOL`` of its
    plain version, within 1e-5 + ``K8_K3_RTOL`` x |K3| of K3 run on q.float()
    over the f32-dequantised cache, a second launch bitwise equal, each row
    bitwise its solo launch. Returns (the largest difference from the plain
    version, from K3)."""
    args = (q, kd, ks, vd, vs, tables, lens)
    plain = kq._quant_decode_plain(*args)
    k3 = pa.paged_decode_attention_batched(
        q.float(), kq.dequantize_kv(kd, ks), kq.dequantize_kv(vd, vs), tables, lens).to(q.dtype)
    again = kq.paged_decode_attention_quantized(*args)
    solo = [kq.paged_decode_attention_quantized(q[r:r + 1], kd, ks, vd, vs, tables[r:r + 1],
                                                lens[r:r + 1]) for r in range(q.shape[0])]
    _sync(torch, q.device)
    name = peak_dtype(q)
    err = max_err(got, plain)
    if not err <= K8_PLAIN_TOL[name]:
        raise AssertionError(f"{what}: K8 is {err} from its plain version "
                             f"(tol {K8_PLAIN_TOL[name]})")
    diff = (got.float() - k3.float()).abs()
    if not bool((diff <= 1e-5 + K8_K3_RTOL[name] * k3.float().abs()).all()):
        raise AssertionError(f"{what}: K8 is up to {float(diff.max())} from K3 over the "
                             f"dequantised cache (tol 1e-5 + {K8_K3_RTOL[name]} x |K3|)")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two K8 launches differ")
    for r, one in enumerate(solo):
        if not torch.equal(one[0], got[r]):
            raise AssertionError(f"{what}: K8 row {r} differs from its solo launch")
    return err, float(diff.max())


def _quant_kernel_check(torch, timer, g, tables, waves, n_cache):
    """K8 at the int8 round trip's wave (4 requests at 2,048 tokens), each
    wave in f32 and bf16 q, held to ``_k8_contract``; a zero-length row
    gives zeros."""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    bsz = tables.shape[0]
    kd, ks = kq.quantize_kv(torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda"))
    vd, vs = kq.quantize_kv(torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda"))
    full = waves[0]
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((bsz, h, d), generator=g, device="cuda").to(dtype)
        err = err3 = 0.0
        for lens in waves:
            got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
            e, e3 = _k8_contract(torch, kq, pa, q, kd, ks, vd, vs, tables, lens, got,
                                 f"quantized decode {dtype}")
            err, err3 = max(err, e), max(err3, e3)
        if float(got[-1].float().abs().max()) != 0.0:
            raise AssertionError("quantized decode: seq_len 0 must give zeros")
        name = peak_dtype(q)
        log(f"K8 {dtype}: max abs err {err:.3e} from its plain version (tol "
            f"{K8_PLAIN_TOL[name]}), {err3:.3e} from K3 over the dequantised cache (tol 1e-5 + "
            f"{K8_K3_RTOL[name]} x |K3|); two launches and solo rows bitwise equal")
        if dtype is torch.bfloat16:
            tokens = int(full.sum())
            nbytes = 2 * tokens * kvh * (d + 4) + 2 * q.numel() * q.element_size() + \
                tables.numel() * 4 + bsz * 4  # int8 data + f32 scales, q and out
            bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, peak_dtype(q))
            args = (q, kd, ks, vd, vs, tables, full)
            out = dict(max_abs_err=err,
                       ms=timer.ms(lambda: kq.paged_decode_attention_quantized(*args)),
                       plain_ms=timer.ms(lambda: kq._quant_decode_plain(*args)),
                       bound_ms=bms, bound_by=by, library_ms=None)
    return out


def _stats_kernel_check(torch, timer, g, tables, waves, n_cache, nomerge):
    """K5 at K3's wave: against its plain statistics, its one-shard combine
    bitwise K3, the combine of 4 disjoint slices of each row's pages within
    1e-5 of K3 (f32). Timed at the sharded decode's one request of
    ``SHARDED_CONTEXT`` tokens (one-shard combine bitwise K3 there too), and
    there also through ``nomerge`` (K5's entry built with its cross-split
    merge compiled out, swapped in under the wrapper): the fold's time,
    ``fold_ms``."""
    from infinistore_tpu_torch.cuda import decode_probe
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    bsz = tables.shape[0]
    ident = lambda t: t  # noqa: E731
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((bsz, h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        err = err4 = 0.0
        for lens in waves:
            stats = pa._decode_attention_stats(q, kc, vc, tables, lens)
            err = max(err, _stats_err(torch, stats, pa.decode_attention_stats_plain(
                q, kc, vc, tables, lens)))
            k3 = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
            if not torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k3):
                raise AssertionError(f"decode stats {dtype}: one-shard combine is not K3")
            if dtype is torch.float32:
                parts = [pa._decode_attention_stats(
                    q, kc, vc, tables[:, sl].contiguous(),
                    torch.tensor(_slice_lens(lens.tolist(), sl, bt), dtype=torch.int32,
                                 device="cuda"))
                    for sl in _slices(4, tables.shape[1])]
                acc4, m4, l4 = (torch.stack(x) for x in zip(*parts))
                combined = pa.combine_stats(acc4, m4, l4, dtype, lambda t: t.amax(0),
                                            lambda t: t.sum(0))
                err4 = max(err4, max_err(combined, k3))
            torch.cuda.synchronize()
        if not err <= tol or not err4 <= 1e-5:
            raise AssertionError(f"decode stats {dtype}: err {err} (tol {tol}), 4-slice "
                                 f"combine err {err4} (tol 1e-5)")
        log(f"K5 {dtype}: normalised max abs err {err:.3e} (tol {tol}); one-shard combine "
            f"bitwise K3" + (f"; 4-slice combine {err4:.3e} from K3" if dtype is torch.float32 else ""))

    # Timing at the sharded decode's shape: one request, SHARDED_CONTEXT tokens.
    tokens = SHARDED_CONTEXT
    q = torch.randn((1, h, d), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((tokens // bt, bt, kvh, d), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((tokens // bt, bt, kvh, d), generator=g, device="cuda").to(torch.bfloat16)
    table = torch.randperm(tokens // bt, generator=g, device="cuda").to(torch.int32)[None]
    lens = torch.tensor([tokens], dtype=torch.int32, device="cuda")
    args = (q, kc, vc, table, lens)
    stats = pa._decode_attention_stats(*args)
    err = _stats_err(torch, stats, pa.decode_attention_stats_plain(*args))
    if not err <= 2e-2:
        raise AssertionError(f"decode stats at {tokens} tokens: max abs err {err}")
    if not torch.equal(pa.combine_stats(*stats, q.dtype, ident, ident),
                       pa.paged_decode_attention_batched(*args)):
        raise AssertionError(f"decode stats at {tokens} tokens: one-shard combine is not K3")
    nbytes = 2 * tokens * kvh * d * 2 + q.numel() * 2 + (h * d + 2 * h) * 4 + table.numel() * 4 + 4
    bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, peak_dtype(q))
    row = dict(max_abs_err=err, ms=timer.ms(lambda: pa._decode_attention_stats(*args)),
               plain_ms=timer.ms(lambda: pa.decode_attention_stats_plain(*args), iters=3),
               bound_ms=bms, bound_by=by, library_ms=None)
    with decode_probe.using(nomerge):
        row["fold_ms"] = timer.ms(lambda: pa._decode_attention_stats(*args))
    log(f"K5 bf16 at {tokens} tokens: {row['ms']:.5f} ms; the fold alone (its merge compiled "
        f"out) {row['fold_ms']:.5f} ms, so about {row['ms'] - row['fold_ms']:.5f} ms (the "
        "difference) is the merge; one-shard combine bitwise K3")
    return row


def _stats_err(torch, stats, plain):
    """Largest difference of two sets of raw statistics, normalised (acc /
    l, the function they compute); m and l themselves must agree to 1e-5
    relative (f32 sums in another order)."""
    (acc, m, l), (acc_p, m_p, l_p) = stats, plain
    for a, b in ((m, m_p), (l, l_p)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"decode stats: m or l differ by {max_err(a, b)}")
    return max_err(acc / torch.clamp(l, min=1e-30), acc_p / torch.clamp(l_p, min=1e-30))


# The shapes beyond the main path's that the attention kernels take, each at
# the round trip's wave (``PROMPTS`` rows of ``PROMPT_TOKENS`` tokens; K4 one
# ``PROMPT_TOKENS``-token prompt): (dtype, query heads, KV heads, head_dim,
# block tokens). d16: the JAX package's trace model's heads (4 over 2, head
# dim 16, f32, block 8); d32: tests/test_paged_attention.py's second case's
# heads (8 over 2, head_dim 32), bf16; g7: Qwen2.5-7B's published heads (28
# over 4 KV heads, head_dim 128: 7 query heads a KV head), bf16; d8: the JAX
# package's model tests' config (LlamaConfig(dim=32, n_heads=4,
# n_kv_heads=2): head_dim 8, f32, block 8); d80, d96 and d256: Phi-2's (32
# over 32), Phi-3-mini's (32 over 32) and Gemma-2B's (8 over 1) heads, bf16
# (``ROUND_TRIPS``; d96 is the Phi-3 round trip's decode step); mha128:
# Llama-2-7B's heads (32 over 32, head_dim 128), bf16, whose tokens fill
# the 16 lanes that d80 and d96 fill 10 and 12 of at the same CTA count:
# the yardstick of their idle lanes; d64: the main path's heads (32 over 8)
# at head_dim 64, f32.
SHAPES_TAKEN = {
    "d16": ("float32", 4, 2, 16, 8),
    "d32": ("bfloat16", 8, 2, 32, 16),
    "g7": ("bfloat16", 28, 4, 128, 16),
    "d8": ("float32", 4, 2, 8, 8),
    "d80": ("bfloat16", 32, 32, 80, 16),
    "d96": ("bfloat16", 32, 32, 96, 16),
    "d256": ("bfloat16", 8, 1, 256, 16),
    "mha128": ("bfloat16", 32, 32, 128, 16),
    "d64": ("float32", 32, 8, 64, 16),
}
# K4 at every one of those shapes in both dtypes (so every head_dim has an
# f32 and a bf16 row beside SDPA); at d256 in bf16 also at ``PROMPTS``
# prompts (K4_BATCHED), where a prompt's output must be bitwise its solo
# launch's.
SHAPES_TAKEN_K4 = {label: ("float32", "bfloat16") for label in SHAPES_TAKEN}
K4_BATCHED = ("d256", "bfloat16")


def _sdpa_backend(torch, fn):
    """Which SDPA backend one call of ``fn`` ran, from the CUDA kernels
    ``torch.profiler`` saw: (backend, its longest kernel's name cut to 120
    characters, the three longest kernels' names so cut)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {evt.key: getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0))
             for evt in prof.key_averages()}
    names = sorted((name for name, us in times.items() if us > 0), key=times.get, reverse=True)
    joined = " ".join(names)
    backend = ("cudnn" if "cudnn" in joined else "flash" if "flash_fwd" in joined else
               "efficient" if "fmha_cutlass" in joined else "math")
    return backend, (names[0] if names else "")[:120], [name[:120] for name in names[:3]]


def _k4_shape_row(torch, timer, g, label, h, kvh, d, dname, prompts):
    """K4 at one ``SHAPES_TAKEN`` shape: ``prompts`` prompts of
    ``PROMPT_TOKENS`` tokens, held against its plain version (1e-5 f32,
    2e-2 bf16) on its dtype's kernel; at several prompts each prompt bitwise
    its solo launch. Timed beside its plain version, its bound (operations)
    and one SDPA call (causal, GQA), whose backend and kernels are logged
    (``_sdpa_backend``)."""
    import torch.nn.functional as F

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp

    dtype = getattr(torch, dname)
    tol = 1e-5 if dtype is torch.float32 else 2e-2
    s_len = PROMPT_TOKENS
    qp = torch.randn((prompts, s_len, h, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((prompts, s_len, kvh, d), generator=g, device="cuda").to(dtype)
    vp = torch.randn((prompts, s_len, kvh, d), generator=g, device="cuda").to(dtype)
    what = f"flash_prefill {dname} at {label} x {prompts}"
    before = dict(_ext.LAUNCHES)
    got = fp.flash_prefill_attention(qp, kp, vp, causal=True)
    wgmma = _ext.LAUNCHES["flash_prefill_wgmma"] - before["flash_prefill_wgmma"]
    if _ext.LAUNCHES["flash_prefill"] - before["flash_prefill"] != 1 or \
            wgmma != int(dtype is torch.bfloat16):
        raise AssertionError(f"{what}: took the wrong kernel")
    err = max_err(got, fp.flash_prefill_plain(qp, kp, vp, causal=True))
    if prompts > 1 and not all(torch.equal(
            fp.flash_prefill_attention(qp[i:i + 1], kp[i:i + 1], vp[i:i + 1], causal=True),
            got[i:i + 1]) for i in range(prompts)):
        raise AssertionError(f"{what}: a prompt differs from its solo launch")
    torch.cuda.synchronize()
    if not err <= tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol}")
    pairs = s_len * (s_len + 1) // 2
    bms, by = bound_ms((2 * s_len * h * d + 2 * s_len * kvh * d) * prompts * qp.element_size(),
                       4.0 * d * h * pairs * prompts, dname)
    qt, kt, vt = (x.transpose(1, 2) for x in (qp, kp, vp))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    backend, top, names = _sdpa_backend(torch, sdpa)
    log(f"SDPA at {label} ({dname}, {prompts} x {s_len} tokens): {backend} backend, kernels "
        f"{names}")
    row = dict(dtype=dname, heads=h, kv_heads=kvh, head_dim=d, group=h // kvh, prompts=prompts,
               tokens=s_len, max_abs_err=err,
               ms=timer.ms(lambda: fp.flash_prefill_attention(qp, kp, vp, causal=True)),
               plain_ms=timer.ms(lambda: fp.flash_prefill_plain(qp, kp, vp, causal=True),
                                 iters=3),
               bound_ms=bms, bound_by=by, library_ms=timer.ms(sdpa), library_backend=backend,
               library_kernel=top)
    log(f"K4 {dname} at {label} ({prompts} x S={s_len}, {h} heads over {kvh}, head_dim {d}): "
        f"{json.dumps(row)}; {bms / row['ms']:.3f} of its bound")
    return row


def _shapes_taken_check(torch, timer, g):
    """K3-K8 at ``SHAPES_TAKEN``: each against its plain version with the
    kernel phase's tolerances (K3, K6 1e-5 in f32 and 2e-2 in bf16; K5, K7
    normalised, m and l to 1e-5; K8 ``_k8_contract``), K3's two launches
    bitwise equal and its zero-length row zeros, K6 bitwise K3 per row,
    K5's and K7's one-shard combines bitwise K3 and K6; K4 (f32 and bf16)
    against its plain version, each launch on its dtype's kernel. Each timed
    beside its plain version and its bound (the decode kernels by their
    bytes, K4 by its operations), K4 also beside SDPA (``_k4_shape_row``).
    Returns {kernel: {shape: row}}."""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    out = {name: {} for name in TPU_KERNELS if name not in ("gather_blocks", "scatter_blocks")}
    ident = lambda t: t  # noqa: E731
    for label, (dname, h, kvh, d, bt) in SHAPES_TAKEN.items():
        dtype = getattr(torch, dname)
        tol = 1e-5 if dtype is torch.float32 else 2e-2
        nb = PROMPT_TOKENS // bt
        n_cache = PROMPTS * nb + 16
        tables = (torch.randperm(n_cache, generator=g, device="cuda")[: PROMPTS * nb]
                  .to(torch.int32).reshape(PROMPTS, nb))
        full = torch.full((PROMPTS,), PROMPT_TOKENS, dtype=torch.int32, device="cuda")
        ragged = torch.tensor([PROMPT_TOKENS, PROMPT_TOKENS - 1, 1000, 0], dtype=torch.int32,
                              device="cuda")
        q = torch.randn((PROMPTS, h, d), generator=g, device="cuda").to(dtype)
        k32 = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda")
        v32 = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda")
        kc, vc = k32.to(dtype), v32.to(dtype)
        kd, ks = kq.quantize_kv(k32)
        vd, vs = kq.quantize_kv(v32)
        what = f"{label} ({dname}, {h} heads over {kvh}, head_dim {d}, block {bt})"
        errs = dict.fromkeys(out, 0.0)
        for lens in (full, ragged):
            args = (q, kc, vc, tables, lens)
            k3 = pa.paged_decode_attention_batched(*args)
            again = pa.paged_decode_attention_batched(*args)
            stats = pa._decode_attention_stats(*args)
            m = pa.build_ragged_wave([t.cpu().numpy() for t in tables], lens.cpu().numpy(), bt,
                                     pad_to_pow2=True)
            meta = [torch.from_numpy(x).to("cuda") for x in (m.pages, m.page_rows,
                                                              m.page_starts, m.seq_lens)]
            k6 = pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=nb)
            rstats = pa._decode_attention_stats_ragged(q, kc, vc, *meta, table_width=nb)
            k8 = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
            torch.cuda.synchronize()
            errs["paged_decode_attention"] = max(errs["paged_decode_attention"], max_err(
                k3, pa.paged_decode_attention_plain_batched(*args)))
            errs["paged_decode_attention_ragged"] = max(
                errs["paged_decode_attention_ragged"], max_err(
                    k6, pa.paged_decode_attention_ragged_plain(q, kc, vc, meta[0], meta[2],
                                                               meta[3], nb)))
            errs["paged_decode_attention_stats"] = max(
                errs["paged_decode_attention_stats"],
                _stats_err(torch, stats, pa.decode_attention_stats_plain(*args)))
            errs["paged_decode_attention_ragged_stats"] = max(
                errs["paged_decode_attention_ragged_stats"],
                _stats_err(torch, rstats, pa.decode_attention_stats_ragged_plain(
                    q, kc, vc, meta[0], meta[2], meta[3], nb)))
            errs["paged_decode_attention_quantized"] = max(
                errs["paged_decode_attention_quantized"],
                _k8_contract(torch, kq, pa, q, kd, ks, vd, vs, tables, lens, k8, what)[0])
            if not torch.equal(k3, again) or not torch.equal(k6, k3):
                raise AssertionError(f"{what}: two K3 launches differ, or K6 is not K3 per row")
            if not torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k3) or \
                    not torch.equal(pa.combine_stats(*rstats, dtype, ident, ident), k6):
                raise AssertionError(f"{what}: K5's or K7's one-shard combine is not K3 / K6")
        if float(k3[-1].float().abs().max()) != 0.0 or float(k8[-1].float().abs().max()) != 0.0:
            raise AssertionError(f"{what}: a zero-length row must give zeros")
        for name in ("paged_decode_attention", "paged_decode_attention_ragged",
                     "paged_decode_attention_stats", "paged_decode_attention_ragged_stats"):
            if not errs[name] <= tol:
                raise AssertionError(f"{what}: {name} max abs err {errs[name]} > {tol}")
        log(f"K3, K5-K8 at {what}: max abs err " + ", ".join(
            f"{name} {err:.3e}" for name, err in errs.items() if name != "flash_prefill") +
            f" (tol {tol}); K3 two launches and K6 per row bitwise, K5 / K7 combines bitwise")

        # Timed at the full wave: every valid token's K and V read once, q
        # and the output once (K5 / K7: f32 acc, m and l), the page metadata.
        tokens = PROMPTS * PROMPT_TOKENS
        args = (q, kc, vc, tables, full)
        m = pa.build_ragged_wave([t.cpu().numpy() for t in tables], full.cpu().numpy(), bt,
                                 pad_to_pow2=True)
        meta = [torch.from_numpy(x).to("cuda") for x in (m.pages, m.page_rows, m.page_starts,
                                                          m.seq_lens)]
        kv_bytes = 2 * tokens * kvh * d * kc.element_size()
        q_bytes = q.numel() * q.element_size()
        stats_bytes = q.numel() * 4 + 2 * PROMPTS * h * 4
        table_bytes = tables.numel() * 4 + PROMPTS * 4
        meta_bytes = sum(x.numel() * 4 for x in meta)
        flops = 4.0 * h * d * tokens
        calls = {
            "paged_decode_attention": (
                lambda: pa.paged_decode_attention_batched(*args),
                lambda: pa.paged_decode_attention_plain_batched(*args),
                kv_bytes + 2 * q_bytes + table_bytes),
            "paged_decode_attention_stats": (
                lambda: pa._decode_attention_stats(*args),
                lambda: pa.decode_attention_stats_plain(*args),
                kv_bytes + q_bytes + stats_bytes + table_bytes),
            "paged_decode_attention_ragged": (
                lambda: pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=nb),
                lambda: pa.paged_decode_attention_ragged_plain(q, kc, vc, meta[0], meta[2],
                                                               meta[3], nb),
                kv_bytes + 2 * q_bytes + meta_bytes),
            "paged_decode_attention_ragged_stats": (
                lambda: pa._decode_attention_stats_ragged(q, kc, vc, *meta, table_width=nb),
                lambda: pa.decode_attention_stats_ragged_plain(q, kc, vc, meta[0], meta[2],
                                                               meta[3], nb),
                kv_bytes + q_bytes + stats_bytes + meta_bytes),
            "paged_decode_attention_quantized": (
                lambda: kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, full),
                lambda: kq._quant_decode_plain(q, kd, ks, vd, vs, tables, full),
                2 * tokens * kvh * (d + 4) + 2 * q_bytes + table_bytes),
        }
        for name, (kernel, plain, nbytes) in calls.items():
            bms, by = bound_ms(nbytes, flops, dname)
            row = dict(dtype=dname, heads=h, kv_heads=kvh, head_dim=d, group=h // kvh,
                       block_tokens=bt, rows=PROMPTS, tokens=PROMPT_TOKENS,
                       max_abs_err=errs[name], ms=timer.ms(kernel),
                       plain_ms=timer.ms(plain, iters=3), bound_ms=bms, bound_by=by,
                       library_ms=None)
            out[name][label] = row
            log(f"{name} at {label}: ms {row['ms']:.5f}, plain {row['plain_ms']:.5f}, bound "
                f"{bms:.5f} ({by}); {bms / row['ms']:.3f} of its bound")
        del kc, vc, kd, vd, k32, v32

        for k4_dtype_name in SHAPES_TAKEN_K4[label]:
            out["flash_prefill"][f"{label}_{k4_dtype_name}"] = _k4_shape_row(
                torch, timer, g, label, h, kvh, d, k4_dtype_name, 1)
            if (label, k4_dtype_name) == K4_BATCHED:
                out["flash_prefill"][f"{label}_{k4_dtype_name}_x{PROMPTS}"] = _k4_shape_row(
                    torch, timer, g, label, h, kvh, d, k4_dtype_name, PROMPTS)
        torch.cuda.empty_cache()
    return out


def _skewed_wave():
    """The kernel phase's skewed ragged wave at the engine's widths
    (``decode_probe.skewed_wave``): (per-row lens, per-row tables, table
    width, cache blocks)."""
    from infinistore_tpu_torch.cuda import decode_probe

    return decode_probe.skewed_wave(ENGINE_REQ_BLOCKS)


def _ragged_kernel_check(torch, timer, g, pa, nomerge):
    """K6 on a skewed wave at the engine phase's widths: against its plain
    version, bitwise against K3 per row, bitwise against solo launches. K7
    on the same wave: against its plain statistics, its one-shard combine
    bitwise K6, the combine of 4 disjoint slices of each row's pages within
    1e-5 of K6 (f32); in bf16 timed as it is, through ``nomerge`` (its
    entry built without the cross-split merge, swapped in under the
    wrapper: ``fold_ms``) and at the wave's first quarter-shard (each row's
    first 18 table entries, what one of 4 ranks folds: ``quarter_shard_ms``,
    held against its plain statistics, beside its own bound). Returns the two
    kernels' results."""
    from infinistore_tpu_torch.cuda import decode_probe

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    lens, row_tables, width, n_cache = _skewed_wave()
    m = pa.build_ragged_wave(row_tables, lens, bt, pad_to_pow2=True)
    pages, page_rows, page_starts, seq = (
        torch.from_numpy(x).cuda() for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens))
    rows_k3 = pa._ragged_row_tables(pages, page_starts, width).contiguous()
    read = {int(m.pages[m.page_starts[r] + j]) for r, n in enumerate(lens)
            for j in range(-(-n // bt))}
    out = out7 = None
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((len(lens), h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)

        def run():
            return pa.paged_decode_attention_ragged(q, kc, vc, pages, page_rows, page_starts,
                                                    seq, table_width=width)

        def plain():
            return pa.paged_decode_attention_ragged_plain(q, kc, vc, pages, page_starts, seq,
                                                          width)

        got, want, again = run(), plain(), run()
        k3 = pa.paged_decode_attention_batched(q, kc, vc, rows_k3, seq)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"ragged decode {dtype}: max abs err {err} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"ragged decode {dtype}: two launches differ")
        if float(got[2].float().abs().max()) != 0.0:
            raise AssertionError("ragged decode: seq_len 0 must give zeros")
        if not torch.equal(got, k3):
            raise AssertionError(f"ragged decode {dtype}: rows differ from K3 on their tables")
        for r in range(len(lens)):
            solo = pa.build_ragged_wave([row_tables[r]], [lens[r]], bt)
            one = pa.paged_decode_attention_ragged(
                q[r : r + 1].contiguous(), kc, vc, *(torch.from_numpy(x).cuda() for x in (
                    solo.pages, solo.page_rows, solo.page_starts, solo.seq_lens)),
                table_width=width)
            torch.cuda.synchronize()
            if not torch.equal(one[0], got[r]):
                raise AssertionError(f"ragged decode {dtype}: row {r} differs from its solo launch")
        log(f"K6 {dtype}: max abs err {err:.3e} (tol {tol}); bitwise K3 per row and solo per "
            "row, two launches bitwise equal; "
            f"{m.num_pages} pages ({m.pad_pages} pad), {len(read)} distinct read")
        err7 = _ragged_stats_check(torch, pa, q, kc, vc, (pages, page_rows, page_starts, seq),
                                   got, lens, row_tables, width, tol)
        if dtype is torch.bfloat16:
            meta_bytes = (m.num_pages + 3 * len(lens) + 1) * 4
            kv_bytes = 2 * len(read) * bt * kvh * d * q.element_size()
            flops = 4.0 * h * d * sum(lens)
            bms, by = bound_ms(kv_bytes + 2 * q.numel() * q.element_size() + meta_bytes, flops,
                               peak_dtype(q))
            out = dict(max_abs_err=err, ms=timer.ms(run), plain_ms=timer.ms(plain),
                       bound_ms=bms, bound_by=by, library_ms=None,
                       host_us=host_us(torch, run))
            log(f"K6 bf16 on the skewed wave: {bms / out['ms']:.3f} of its bound; wrapper host "
                f"time {out['host_us']:.1f} us per call")
            stats_args = (q, kc, vc, pages, page_rows, page_starts, seq, width)
            # K7 writes f32 acc [R, H, D] and m, l [R, H] where K6 writes q's dtype.
            out_bytes = q.numel() * 4 + 2 * len(lens) * h * 4
            bms, by = bound_ms(kv_bytes + q.numel() * q.element_size() + out_bytes + meta_bytes,
                               flops, peak_dtype(q))
            out7 = dict(max_abs_err=err7,
                        ms=timer.ms(lambda: pa._decode_attention_stats_ragged(*stats_args)),
                        plain_ms=timer.ms(lambda: pa.decode_attention_stats_ragged_plain(
                            q, kc, vc, pages, page_starts, seq, width)),
                        bound_ms=bms, bound_by=by, library_ms=None)
            with decode_probe.using(nomerge):
                out7["fold_ms"] = timer.ms(
                    lambda: pa._decode_attention_stats_ragged(*stats_args))
            sl = _slices(4, width)[0]
            qlens = _slice_lens(lens, sl, bt)
            qp, qr, qs, ql, qw = pa.build_ragged_wave_sharded(
                [[t[sl] for t in row_tables]], [qlens], bt)
            quarter = (q, kc, vc, *(torch.from_numpy(x[0]).cuda() for x in (qp, qr, qs, ql)),
                       qw)
            errq = _stats_err(torch, pa._decode_attention_stats_ragged(*quarter),
                              pa.decode_attention_stats_ragged_plain(*quarter[:4],
                                                                     *quarter[5:]))
            if not errq <= tol:
                raise AssertionError(f"K7 bf16 at the first quarter-shard: err {errq} "
                                     f"(tol {tol})")
            qread = {int(qp[0][qs[0][r] + j]) for r, n in enumerate(qlens)
                     for j in range(-(-n // bt))}
            qbms, _ = bound_ms(2 * len(qread) * bt * kvh * d * q.element_size() +
                               q.numel() * q.element_size() + out_bytes +
                               (qp[0].shape[0] + 3 * len(lens) + 1) * 4,
                               4.0 * h * d * sum(qlens), peak_dtype(q))
            out7.update(quarter_shard_ms=timer.ms(
                lambda: pa._decode_attention_stats_ragged(*quarter)),
                quarter_shard_max_abs_err=errq, quarter_shard_bound_ms=qbms)
            log(f"K7 bf16 on the skewed wave: {out7['ms']:.5f} ms; the fold alone (its merge "
                f"compiled out) {out7['fold_ms']:.5f} ms, so about "
                f"{out7['ms'] - out7['fold_ms']:.5f} ms (the difference) is the split merge; "
                f"{out7['quarter_shard_ms']:.5f} ms at its first quarter-shard ({qw}-page "
                f"tables; normalised max abs err {errq:.3e}, tol {tol}; bound {qbms:.5f} ms)")
    return out, out7


def _ragged_stats_check(torch, pa, q, kc, vc, meta, k6, lens, row_tables, width, tol):
    """K7 on one wave: against its plain statistics, its one-shard combine
    bitwise K6 (``k6``), and in f32 the combine of 4 disjoint slices of each
    row's pages (one ragged wave per slice) within 1e-5 of K6. Returns the
    normalised error against the plain statistics."""
    bt = kc.shape[1]
    dtype = q.dtype
    pages, page_rows, page_starts, seq = meta
    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats_ragged(q, kc, vc, pages, page_rows, page_starts, seq,
                                              width)
    err = _stats_err(torch, stats, pa.decode_attention_stats_ragged_plain(
        q, kc, vc, pages, page_starts, seq, width))
    if not torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k6):
        raise AssertionError(f"ragged stats {dtype}: one-shard combine is not K6")
    err4 = 0.0
    if dtype is torch.float32:
        cuts = _slices(4, width)
        sp, srows, sstarts, slens, swidth = pa.build_ragged_wave_sharded(
            [[t[sl] for t in row_tables] for sl in cuts],
            [_slice_lens(lens, sl, bt) for sl in cuts], bt)
        parts = [pa._decode_attention_stats_ragged(q, kc, vc, sp[s], srows[s], sstarts[s],
                                                   slens[s], swidth) for s in range(4)]
        acc4, m4, l4 = (torch.stack(x) for x in zip(*parts))
        err4 = max_err(pa.combine_stats(acc4, m4, l4, dtype, lambda t: t.amax(0),
                                        lambda t: t.sum(0)), k6)
    torch.cuda.synchronize()
    if not err <= tol or not err4 <= 1e-5:
        raise AssertionError(f"ragged stats {dtype}: err {err} (tol {tol}), 4-slice combine "
                             f"err {err4} (tol 1e-5)")
    log(f"K7 {dtype}: normalised max abs err {err:.3e} (tol {tol}); one-shard combine bitwise "
        f"K6" + (f"; 4-slice combine {err4:.3e} from K6" if dtype is torch.float32 else ""))
    return err


# ---------------------------------------------------------------------------
# Phase 2: prefill -> store -> decode at Llama-3-8B width
# ---------------------------------------------------------------------------


def _client(lib_mod, config_mod, port):
    conn = lib_mod.InfinityConnection(config_mod.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error",
    ))
    conn.connect()
    return conn


def _sync(torch, *devices):
    for device in devices:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def _decode_wave(torch, llama, params, cfg, caches, tables, first_tokens, max_blocks,
                 prompt_tokens, steps=DECODE_STEPS, on_step=None):
    """``steps`` greedy steps for the wave; returns per-step logits.
    ``on_step(step, logits)`` is called as each step's logits are queued."""
    tokens = first_tokens.clone()
    out = []
    for step in range(steps):
        positions = torch.full((tokens.shape[0],), prompt_tokens + step,
                               dtype=torch.int32, device=tokens.device)
        logits, caches = llama.decode_step_batched(
            params, tokens, positions, caches, tables, cfg, max_blocks)
        out.append(logits)
        if on_step is not None:
            on_step(step, logits)
        tokens = logits.argmax(dim=-1)
    return out


def main_path(torch, server_port, device="cuda", geometry=LLAMA3_8B,
              prompt_tokens=PROMPT_TOKENS, model_id="llama-3-8b", profile=True):
    """The main path on ``device`` (a CPU rehearsal passes a small
    ``geometry`` and ``device="cpu"``); on a card, ``profile`` also profiles
    one prefill and one decode step."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **geometry)
    bt = cfg.block_tokens
    nb = prompt_tokens // bt
    max_blocks = -(-(prompt_tokens + DECODE_STEPS) // bt)
    num_blocks = PROMPTS * max_blocks + 8
    spec = cfg.kv_spec(num_blocks)

    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    _sync(torch, device)
    n_params = sum(p.numel() for p in params.values())
    log(f"init_params: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, prompt_tokens).tolist() for _ in range(PROMPTS)]
    tables_a = torch.arange(PROMPTS * max_blocks, dtype=torch.int32, device=device).reshape(PROMPTS, max_blocks)
    perm = torch.from_numpy(rng.permutation(num_blocks)[: PROMPTS * max_blocks].astype(np.int32))
    tables_b = perm.to(device).reshape(PROMPTS, max_blocks)

    conn_a = _client(lib_mod, config_mod, server_port)
    conn_b = _client(lib_mod, config_mod, server_port)
    kv_a = KVConnector(conn_a, spec, model_id, max_blocks=nb, device=device)
    kv_b = KVConnector(conn_b, spec, model_id, max_blocks=nb, device=device)
    try:
        caches_a = spec.make_caches(device)
        caches_b = spec.make_caches(device)

        # Engine A: prefill each prompt into its own blocks.
        first = []
        t0 = time.perf_counter()
        for p in range(PROMPTS):
            logits, caches_a = llama.prefill(params, prompts[p], caches_a, tables_a[p, :nb], cfg)
            first.append(logits.argmax())
        _sync(torch, device)
        prefill_ms = (time.perf_counter() - t0) * 1e3 / PROMPTS
        if not bool(torch.isfinite(logits.float()).all()) or logits.shape != (cfg.vocab,):
            raise AssertionError(f"prefill logits bad: shape {tuple(logits.shape)}")
        first_tokens = torch.stack(first)

        kv_bytes = PROMPTS * nb * spec.block_nbytes * 2 * cfg.n_layers
        t0 = time.perf_counter()
        for p in range(PROMPTS):
            written = asyncio.run(kv_a.save(prompts[p], caches_a, tables_a[p, :nb].cpu().numpy()))
            if written != 2 * nb * cfg.n_layers:
                raise AssertionError(f"save wrote {written} blocks")
        save_s = time.perf_counter() - t0
        store = conn_a.get_stats()
        store_bytes_per_key = store["used_bytes"] / store["kvmap_len"]

        # Engine B: look up and load into different block ids.
        for p in range(PROMPTS):
            hit = kv_b.lookup(prompts[p])
            if hit != nb:
                raise AssertionError(f"lookup of prompt {p} found {hit} blocks, expected {nb}")
        t0 = time.perf_counter()
        for p in range(PROMPTS):
            caches_b, n = asyncio.run(kv_b.load(prompts[p], caches_b, tables_b[p, :nb].cpu().numpy()))
            if n != nb:
                raise AssertionError(f"load of prompt {p} brought {n} blocks")
        _sync(torch, device)
        load_s = time.perf_counter() - t0

        for layer in range(cfg.n_layers):
            for kind in (0, 1):
                for p in range(PROMPTS):
                    a = caches_a[layer][kind][tables_a[p, :nb].long()]
                    b = caches_b[layer][kind][tables_b[p, :nb].long()]
                    if not torch.equal(a, b):
                        raise AssertionError(f"layer {layer} kind {kind} prompt {p}: loaded bytes differ")
        log("engine B holds engine A's blocks byte for byte")

        t0 = time.perf_counter()
        logits_b = _decode_wave(torch, llama, params, cfg, caches_b, tables_b, first_tokens,
                                max_blocks, prompt_tokens)
        _sync(torch, device)
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
        logits_a = _decode_wave(torch, llama, params, cfg, caches_a, tables_a, first_tokens,
                                max_blocks, prompt_tokens)
        _sync(torch, device)
        for step, (la, lb) in enumerate(zip(logits_a, logits_b)):
            if la.shape != (PROMPTS, cfg.vocab) or not bool(torch.isfinite(la.float()).all()):
                raise AssertionError(f"decode step {step}: bad logits {tuple(la.shape)}")
            if not torch.equal(la, lb):
                raise AssertionError(f"decode step {step}: engine B's logits differ from A's")
        log(f"decode: engines A and B agree bitwise over {DECODE_STEPS} steps")
        launches = dict(_ext.LAUNCHES)  # the main path's own launches, read here

        if profile and torch.device(device).type == "cuda":
            profiles = {
                "prefill": _profile(torch, lambda: llama.prefill(
                    params, prompts[0], caches_a, tables_a[0, :nb], cfg)),
                "decode_step": _profile(torch, lambda: llama.decode_step_batched(
                    params, first_tokens, torch.full((PROMPTS,), prompt_tokens, dtype=torch.int32,
                                                     device=device),
                    caches_a, tables_a, cfg, max_blocks)),
            }
            for name, prof in profiles.items():
                log(f"profile {name}: {json.dumps(prof)}")
    finally:
        kv_a.close()
        kv_b.close()
        conn_a.close()
        conn_b.close()
    metrics = {
        "prefill_ms_per_prompt": prefill_ms,
        "save_GBps": kv_bytes / save_s / 1e9,
        "load_GBps": kv_bytes / load_s / 1e9,
        "decode_ms_per_step": decode_ms,
        "kv_bytes_moved": kv_bytes,
        "store_bytes_per_key": store_bytes_per_key,
    }
    # What the int8 round trip takes over: engine A's caches and tables.
    state = dict(cfg=cfg, spec=spec, prompts=prompts, nb=nb, caches_a=caches_a,
                 tables_a=tables_a, tables_b=tables_b, device=device, save_s=save_s,
                 load_s=load_s)
    return metrics, launches, params, state


# Device kernels by kind, matched on their names in this order: the port's
# own kernels, cuBLAS's GEMMs, copies (dtype casts, contiguous), reductions,
# and PyTorch's other elementwise kernels (norms, RoPE, activations, adds).
PROFILE_KINDS = (
    ("port_kernels", ("flash_prefill", "paged_decode", "bulk_copy", "vector_copy")),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copy", ("copy",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def _profile(torch, fn):
    """One call of ``fn`` under torch.profiler: wall time, the device's busy
    time (the kernels' self time) and idle share, and the kernels that took
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms)


async def _profile_async(torch, make_coro):
    """``_profile`` around one awaited coroutine; returns (its result, the
    summary). Device time of kernels on several streams adds up, so with
    overlapping streams the idle share is a lower bound of the true one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = await make_coro()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, _profile_summary(prof, wall_ms)


def _profile_summary(prof, wall_ms):
    from torch.autograd import DeviceType

    # Device-side events only (kernels, copies): the host ops that launched
    # them carry the same time again.
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in rows)
    rows.sort(key=lambda r: -r[1])
    by_kind = {}
    for name, ms in rows:
        kind = next((k for k, marks in PROFILE_KINDS if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "busy_by_kind_ms": by_kind,
        "top_kernels_ms": {name[:80]: ms for name, ms in rows[:12]},
    }


# ---------------------------------------------------------------------------
# Phase 3: a small f32 model, kernels (card) against plain versions (CPU)
# ---------------------------------------------------------------------------


def _run_round_trip(torch, geometry, model_id, store_bytes, store_unit, device="cuda",
                    prompt_tokens=PROMPT_TOKENS):
    """``main_path`` at ``geometry`` (bf16, seed-0 weights, made and dropped
    here) on a store of its own (``store_bytes`` in ``store_unit`` units),
    its launch counts zeroed just before it: (metrics, launches). Each saved
    block must take whole units: ``store_bytes_per_key`` is the block's
    bytes rounded up to the unit."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.cuda import _ext

    server = lib.start_local_server(prealloc_bytes=store_bytes, block_bytes=store_unit,
                                    pin_memory=False)
    try:
        _ext.reset_launches()
        metrics, launches, params, state = main_path(
            torch, server.port, device=device, geometry=geometry, prompt_tokens=prompt_tokens,
            model_id=model_id, profile=False)
    finally:
        server.stop()
    block = state["spec"].block_nbytes
    del params, state
    units = -(-block // store_unit)
    if metrics["store_bytes_per_key"] != units * store_unit:
        raise AssertionError(f"{model_id}: {metrics['store_bytes_per_key']} store bytes a key, "
                             f"expected {units} units of {store_unit} for a {block}-byte block")
    cfg = dict(geometry, head_dim=geometry["dim"] // geometry["n_heads"], block_bytes=block,
               units_per_key=units)
    return dict(metrics, model_id=model_id, geometry=cfg), launches


def round_trips_phase(torch, smi, llama_metrics):
    """The round trip at ``ROUND_TRIPS``' widths: Phi-3-mini at full depth
    (head_dim 96), Phi-2's and Gemma-2B's attention widths at 2 layers
    (head_dim 80 and 256). Each path must launch K1-K4 (checked in main);
    every K4 launch is bf16 on the tensor cores and every K1/K2 launch on
    the bulk ring. Logs each path's metrics beside the Llama-3-8B round
    trip's. Returns {path: launches}."""
    paths, rows = {}, {"prefill_store_decode": dict(llama_metrics, model_id="llama-3-8b")}
    for path, geometry, model_id, store_bytes, store_unit in ROUND_TRIPS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rows[path], paths[path] = _run_round_trip(torch, geometry, model_id, store_bytes,
                                                  store_unit)
        rows[path]["wall_s"] = time.perf_counter() - t0
        log(f"{path}: {json.dumps(rows[path])}")
        log(f"{path} launches: {json.dumps(paths[path])}")
    keys = ("prefill_ms_per_prompt", "save_GBps", "load_GBps", "decode_ms_per_step",
            "store_bytes_per_key")
    log(f"round trips on {smi}: " + json.dumps(
        {path: {k: row[k] for k in keys} for path, row in rows.items()}))
    return paths


def small_model_phase(torch, server_port):
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 32).tolist()
    nb, max_blocks = 4, 6
    spec = cfg.kv_spec(16)
    out = {}
    for device in ("cuda", "cpu"):
        params = {k: v.to(device) for k, v in params_cpu.items()}
        conn = _client(lib_mod, config_mod, server_port)
        kv = KVConnector(conn, spec, f"small-{device}", max_blocks=nb, device=device)
        try:
            table_a = torch.arange(max_blocks, dtype=torch.int32)
            table_b = torch.tensor([9, 3, 12, 5, 7, 1], dtype=torch.int32)
            logits, caches_a = llama.prefill(params, prompt, spec.make_caches(device), table_a[:nb], cfg)
            asyncio.run(kv.save(prompt, caches_a, table_a[:nb].numpy()))
            caches_b, n = asyncio.run(kv.load(prompt, spec.make_caches(device), table_b[:nb].numpy()))
            if n != nb:
                raise AssertionError(f"small model ({device}): loaded {n} blocks")
            steps = []
            token = int(logits.argmax())
            for i in range(4):
                step_logits, caches_b = llama.decode_step(
                    params, token, 32 + i, caches_b, table_b.to(device), cfg, max_blocks)
                steps.append(step_logits.cpu())
                token = int(step_logits.argmax())
            out[device] = torch.stack(steps)
        finally:
            kv.close()
            conn.close()
    err = max_err(out["cuda"], out["cpu"])
    if not err <= 2e-4:
        raise AssertionError(f"small f32 model: card vs CPU logits differ by {err} > 2e-4")
    log(f"small f32 model: card (kernels) vs CPU (plain) max abs err {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# Phase 4: the int8 round trip at Llama-3-8B width
# ---------------------------------------------------------------------------


def int8_round_trip(torch, server_port, state, bf16_metrics):
    """Engine A's prefixes (``main_path``'s ``state``) quantised, saved
    through ``QuantizedKVConnector``, looked up and loaded into engine B's
    int8 caches, then decoded by K8 for every layer. Returns (metrics,
    launches); the launches are read before the comparisons run."""
    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg, spec, prompts, nb = state["cfg"], state["spec"], state["prompts"], state["nb"]
    caches_a, tables_a, tables_b = state["caches_a"], state["tables_a"], state["tables_b"]
    device = state["device"]
    n_req = len(prompts)
    prompt_tokens = nb * cfg.block_tokens
    head_dim = cfg.dim // cfg.n_heads
    conn_a = _client(lib_mod, config_mod, server_port)
    conn_b = _client(lib_mod, config_mod, server_port)
    qa = kq.QuantizedKVConnector(conn_a, spec, "llama-3-8b", max_blocks=nb, device=device)
    qb = kq.QuantizedKVConnector(conn_b, spec, "llama-3-8b", max_blocks=nb, device=device)
    try:
        _ext.reset_launches()
        quant_a = [(kq.quantize_kv(k), kq.quantize_kv(v)) for k, v in caches_a]
        t0 = time.perf_counter()
        for p in range(n_req):
            written = asyncio.run(qa.save(prompts[p], quant_a, tables_a[p, :nb].cpu().numpy()))
            if written != 2 * nb * cfg.n_layers:
                raise AssertionError(f"int8 save wrote {written} data blocks")
        save_s = time.perf_counter() - t0
        store = conn_a.get_stats()
        for p in range(n_req):
            hit = qb.lookup(prompts[p])
            if hit != nb:
                raise AssertionError(f"int8 lookup of prompt {p} found {hit} blocks, expected {nb}")
        quant_b = [
            tuple((torch.zeros(spec.cache_shape, dtype=torch.int8, device=device),
                   torch.zeros(spec.cache_shape[:-1], dtype=torch.float32, device=device))
                  for _ in range(2))
            for _ in range(cfg.n_layers)
        ]
        t0 = time.perf_counter()
        for p in range(n_req):
            quant_b, n = asyncio.run(qb.load(prompts[p], quant_b, tables_b[p, :nb].cpu().numpy()))
            if n != nb:
                raise AssertionError(f"int8 load of prompt {p} brought {n} blocks")
        _sync(torch, device)
        load_s = time.perf_counter() - t0

        # K8 over engine B's int8 caches, one seeded bf16 query wave a layer.
        g = torch.Generator(device=device).manual_seed(7)
        lens = torch.full((n_req,), prompt_tokens, dtype=torch.int32, device=device)
        qs = [torch.randn((n_req, cfg.n_heads, head_dim), generator=g, device=device)
              .to(torch.bfloat16) for _ in range(cfg.n_layers)]
        outs = [kq.paged_decode_attention_quantized(qs[layer], *quant_b[layer][0],
                                                    *quant_b[layer][1], tables_b, lens)
                for layer in range(cfg.n_layers)]
        _sync(torch, device)
        launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
    finally:
        qa.close()
        qb.close()
        conn_a.close()
        conn_b.close()

    for layer in range(cfg.n_layers):
        for side in (0, 1):
            for part in (0, 1):
                for p in range(n_req):
                    a = quant_a[layer][side][part][tables_a[p, :nb].long()]
                    b = quant_b[layer][side][part][tables_b[p, :nb].long()]
                    if not torch.equal(a, b):
                        raise AssertionError(f"int8 layer {layer} side {side} part {part} prompt "
                                             f"{p}: loaded bytes differ")
    log("int8: engine B holds engine A's int8 data and scales byte for byte")
    scheme_err = plain_err = k3_err = 0.0
    for layer in range(cfg.n_layers):
        (kd, ks), (vd, vs) = quant_b[layer]
        out = outs[layer]
        if out.shape != (n_req, cfg.n_heads, head_dim) or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"int8 decode layer {layer}: bad output {tuple(out.shape)}")
        e, e3 = _k8_contract(torch, kq, pa, qs[layer], kd, ks, vd, vs, tables_b, lens, out,
                             f"int8 decode layer {layer}")
        plain_err, k3_err = max(plain_err, e), max(k3_err, e3)
        ref = pa.paged_decode_attention_batched(qs[layer], *caches_a[layer], tables_a, lens)
        scheme_err = max(scheme_err, max_err(out, ref))
    if not scheme_err <= 2e-2:
        raise AssertionError(f"int8 decode: {scheme_err} from K3 over the bf16 cache (tol 2e-2)")
    log(f"int8 decode: K8 within {plain_err:.3e} of its plain version and {k3_err:.3e} of K3 "
        f"over the dequantised cache in all {cfg.n_layers} layers, two launches and solo rows "
        f"bitwise equal; largest difference from K3 over the bf16 cache {scheme_err:.3e}")
    data_bytes = n_req * nb * cfg.n_layers * 2 * (qa.data.spec.block_nbytes
                                                 + qa.scales.spec.block_nbytes)
    metrics = {
        "save_GBps": data_bytes / save_s / 1e9,
        "load_GBps": data_bytes / load_s / 1e9,
        "kv_bytes_moved": data_bytes,
        "store_keys": store["kvmap_len"],
        "store_used_bytes": store["used_bytes"],
        "store_bytes_per_key": store["used_bytes"] / store["kvmap_len"],
        "store_bytes_per_block_and_side": store["used_bytes"] / (store["kvmap_len"] // 2),
        "bf16_store_bytes_per_block_and_side": bf16_metrics["store_bytes_per_key"],
        "bf16_save_GBps": bf16_metrics["save_GBps"],
        "bf16_load_GBps": bf16_metrics["load_GBps"],
        "max_abs_err_vs_bf16_cache": scheme_err,
        "max_abs_err_vs_plain": plain_err,
        "max_abs_err_vs_k3_dequantised": k3_err,
    }
    return metrics, launches


# ---------------------------------------------------------------------------
# Phases 5 to 7: the continuous-batching engine
# ---------------------------------------------------------------------------


def _engine_rounds(rng, vocab, traffic):
    """Two rounds of 4 prompts (see the module docstring)."""
    shared, tail, span = traffic["shared"], traffic["tail"], traffic["span"]
    keep, new = traffic["keep"], traffic["new"]
    prefix = rng.integers(0, vocab, shared).tolist()
    round1 = []
    for _ in range(4):
        t = rng.integers(0, vocab, tail).tolist()
        rep = t[:span]
        t[tail - span:] = rep  # the span occurs twice; the prompt ends on it
        round1.append(prefix + t)
    round2 = [p[:keep] + rng.integers(0, vocab, new).tolist() for p in round1]
    return round1, round2


async def _serve(h, prompts, gen):
    """Concurrency 4; the requests' stats in prompt order, the wall time."""
    sem = asyncio.Semaphore(4)

    async def one(p):
        async with sem:
            return await h.run_request(p, gen_tokens=gen)

    t0 = time.perf_counter()
    stats = await asyncio.gather(*(one(p) for p in prompts))
    return stats, time.perf_counter() - t0


def _run_engine(torch, server_port, params, cfg, device, model_id, traffic, num_blocks,
                req_blocks, verify_tol, quantized=False):
    """Both rounds on one harness, from one event loop; returns per-round
    (metrics, stats, wall seconds, waves in the round), the harness (its wave
    and speculation counters span both rounds), and the store's occupancy
    after both rounds. ``quantized``: the harness runs over
    ``QuantizingKVAdapter`` (int8 + scales in the store) and its second
    round is verified within ``_int8_verify_tol``."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda.kv_quant import QuantizedKVConnector, QuantizingKVAdapter
    from infinistore_tpu_torch.engine import (
        ContinuousBatchingHarness, EngineKVAdapter, NGramDrafter,
    )

    rounds = _engine_rounds(np.random.default_rng(3), cfg.vocab, traffic)
    conn = _client(lib_mod, config_mod, server_port)
    if quantized:
        # The adapter's staging rows: one request's blocks.
        kv = QuantizedKVConnector(conn, cfg.kv_spec(req_blocks), model_id,
                                  max_blocks=req_blocks, device=device)
        adapter = QuantizingKVAdapter(kv)
    else:
        kv = KVConnector(conn, cfg.kv_spec(num_blocks), model_id, max_blocks=req_blocks,
                         device=device)
        adapter = EngineKVAdapter(kv)
    try:
        h = ContinuousBatchingHarness(
            adapter, params, cfg, num_blocks, req_blocks, verify=True,
            verify_tol=verify_tol, drafter=NGramDrafter(max_draft=7), device=device,
        )

        async def drive():
            out = []
            for i, prompts in enumerate(rounds):
                if quantized and i == 1:
                    h.verify_tol = _int8_verify_tol(torch, h.caches, verify_tol)
                h.stats.clear()
                waves0 = h.wave.waves
                stats, wall = await _serve(h, prompts, traffic["gen"])
                _sync(torch, device)
                out.append((h.metrics(), stats, wall, h.wave.waves - waves0))
            return out

        results = asyncio.run(drive())
        store = conn.get_stats()
        return results, h, {"used_bytes": store["used_bytes"], "keys": store["kvmap_len"]}
    finally:
        kv.close()
        conn.close()


def _int8_verify_tol(torch, caches, base_tol):
    """The verification tolerance of requests whose prefix came back from
    int8: ``base_tol`` (the float path's own) plus two quantization steps of
    the largest vector in the cache. quantize_kv's per-element error is at
    most half a step, absmax / 254 (tests/test_kv_quant.py:36-38), and no
    vector's absmax exceeds the largest value in the cache, read here from
    the blocks the first round computed exactly: that bounds a hit's loaded
    blocks. The suffix resumed over them carries the error through the
    attention, which the scheme does not bound: on the repo's small f32
    models on the CPU (2 and 8 layers, tests/test_torch_kv_quant.py) it
    reached 1.1 steps in the first layer above the prefix and fell off
    deeper. Two steps cover both with room; a wrong or stale block differs
    by O(1). Used as both rtol and atol, as ``base_tol`` is."""
    absmax = max(float(c.abs().max()) for pair in caches for c in pair)
    return base_tol + 2.0 * absmax / 127.0


def _check_rounds(results, traffic, bt, what):
    hit_blocks = traffic["keep"] // bt
    for i, (m, stats, _, _) in enumerate(results):
        if not m["all_verified"]:
            raise AssertionError(f"{what} round {i + 1}: a request's blocks failed verification")
        if any(len(s.generated) != traffic["gen"] for s in stats):
            raise AssertionError(f"{what} round {i + 1}: not {traffic['gen']} tokens per request")
    if results[1][0]["loaded_blocks"] != 4 * hit_blocks:
        raise AssertionError(f"{what} round 2 loaded {results[1][0]['loaded_blocks']} blocks, "
                             f"expected {4 * hit_blocks}")
    last = results[-1][0]
    if last["max_wave_size"] < 2 or last["spec_drafted_tokens"] <= 0:
        raise AssertionError(f"{what}: waves never mixed requests or the drafter never proposed "
                             f"(max_wave_size {last['max_wave_size']}, drafted "
                             f"{last['spec_drafted_tokens']})")


def _engine_summary(results, h, store, smi):
    summary = {"card": smi}
    for i, (m, stats, wall, waves) in enumerate(results):
        summary[f"round{i + 1}"] = {
            "p50_ttft_us": m["p50_ttft_us"],
            "p99_ttft_us": m["p99_ttft_us"],
            "p50_prefix_ready_hit_us": m["p50_prefix_ready_hit_us"],
            "p50_prefix_ready_miss_us": m["p50_prefix_ready_miss_us"],
            "decode_waves": waves,
            "generated_tokens_per_s": m["generated_tokens"] / wall,
            "wall_s": wall,
            "loaded_blocks": m["loaded_blocks"],
            "computed_blocks": m["computed_blocks"],
            "max_wave_size": m["max_wave_size"],
        }
    # Wave and speculation counters over both rounds.
    last = results[-1][0]
    summary["wave_pad_fraction"] = last["wave_pad_fraction"]
    summary["spec_tokens_per_step"] = sum(m["generated_tokens"] for m, *_ in results) / h.spec_rounds
    summary["spec_drafted_tokens"] = last["spec_drafted_tokens"]
    summary["spec_accepted_tokens"] = last["spec_accepted_tokens"]
    summary["wave_buckets"] = len(last["wave_buckets"])
    # How the waves launched: CUDA graph replays, captures, eager waves.
    for key in ("wave_graph_replays", "wave_graph_captures", "wave_eager"):
        summary[key] = last[key]
    summary["store_used_bytes"] = store["used_bytes"]
    summary["store_keys"] = store["keys"]
    return summary


def engine_phase(torch, server_port, params, smi):
    """Phase 5: Llama-3-8B width, bf16, on the card. Returns (launches,
    summary)."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    _ext.reset_launches()
    results, h, store = _run_engine(torch, server_port, params, cfg, "cuda", "llama-3-8b-engine",
                                    ENGINE, ENGINE_BLOCKS, ENGINE_REQ_BLOCKS, ENGINE_VERIFY_TOL)
    launches = dict(_ext.LAUNCHES)
    _check_rounds(results, ENGINE, cfg.block_tokens, "engine phase")
    log(f"engine phase all_verified (bf16 verify_tol {ENGINE_VERIFY_TOL}, rtol = atol) "
        f"in both rounds; round 2 loaded {results[1][0]['loaded_blocks']} blocks")
    summary = _engine_summary(results, h, store, smi)
    log(f"engine phase: {json.dumps(summary)}")
    log(f"profile engine wave: {json.dumps(_profile_wave(torch, h, cfg))}")
    log(f"engine phase launches: {json.dumps(launches)}")
    return launches, summary


def _profile_wave(torch, h, cfg):
    """One mixed wave like round 1's first (4 requests at 1,024 tokens of
    context, each an 8-token verification chunk) under torch.profiler, on
    the harness's own cache once the rounds are done (the blocks it writes
    are free)."""
    from infinistore_tpu_torch.cuda.paged_attention import build_ragged_wave
    from infinistore_tpu_torch.models import llama

    import numpy as np

    mrb = ENGINE_REQ_BLOCKS
    tables = np.arange(4 * mrb, dtype=np.int32).reshape(4, mrb)
    ctx = ENGINE["shared"] + ENGINE["tail"]
    pos = [ctx - 1 + j for _ in range(4) for j in range(8)]
    row_of = [r for r in range(4) for _ in range(8)]
    meta = build_ragged_wave([tables[r] for r in row_of], [p + 1 for p in pos],
                             cfg.block_tokens, pad_to_pow2=True)
    toks = [7] * len(pos)
    return _profile(torch, lambda: llama.verify_step_ragged(
        h.params, toks, pos, row_of, meta.pages, meta.page_rows, meta.page_starts, h.caches,
        tables, cfg, mrb))


def int8_engine_phase(torch, server_port, params, smi, bf16_summary):
    """Phase 6: the engine phase's rounds through QuantizingKVAdapter."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    _ext.reset_launches()
    results, h, store = _run_engine(torch, server_port, params, cfg, "cuda",
                                    "llama-3-8b-int8-engine", ENGINE, ENGINE_BLOCKS,
                                    ENGINE_REQ_BLOCKS, ENGINE_VERIFY_TOL, quantized=True)
    launches = dict(_ext.LAUNCHES)
    _check_rounds(results, ENGINE, cfg.block_tokens, "int8 engine phase")
    summary = _engine_summary(results, h, store, smi)
    summary["round2_verify_tol"] = h.verify_tol
    log(f"int8 engine phase all_verified (round 1 tol {ENGINE_VERIFY_TOL}, round 2 tol "
        f"{h.verify_tol:.4f}, rtol = atol); round 2 loaded {results[1][0]['loaded_blocks']} "
        "blocks")
    log(f"int8 engine phase: {json.dumps(summary)}")
    side = {}
    for key in ("p50_ttft_us", "p50_prefix_ready_hit_us", "p50_prefix_ready_miss_us",
                "generated_tokens_per_s"):
        for rnd in ("round1", "round2"):
            side[f"{rnd}.{key}"] = {"bf16": bf16_summary[rnd][key], "int8": summary[rnd][key]}
    side["store_used_bytes"] = {"bf16": bf16_summary["store_used_bytes"],
                                "int8": summary["store_used_bytes"]}
    log(f"engine bf16 vs int8 store: {json.dumps(side)}")
    log(f"int8 engine phase launches: {json.dumps(launches)}")
    return launches


def small_engine_phase(torch, server_port):
    """Phase 7: the same traffic scaled down, f32, card against CPU, through
    the plain adapter and through the quantizing one."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for quantized in (False, True):
        what = "small int8 engine" if quantized else "small engine"
        tokens = {}
        for device in ("cuda", "cpu"):
            params = {k: v.to(device) for k, v in params_cpu.items()}
            results, _, _ = _run_engine(
                torch, server_port, params, cfg, device,
                f"small-engine-{'q8-' if quantized else ''}{device}", SMALL_ENGINE, 64, 12, 2e-4,
                quantized=quantized)
            _check_rounds(results, SMALL_ENGINE, cfg.block_tokens, f"{what} ({device})")
            tokens[device] = [[s.generated for s in stats] for _, stats, _, _ in results]
        if not quantized and tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{what}: the card's generated tokens differ from the CPU's")
        if quantized and tokens["cuda"][0] != tokens["cpu"][0]:
            raise AssertionError(f"{what}: the card's round-1 tokens differ from the CPU's")
        pairs = [(a, b) for rc, rp in zip(tokens["cuda"][1], tokens["cpu"][1])
                 for a, b in zip(rc, rp)]
        same = sum(a == b for a, b in pairs) / len(pairs)
        log(f"{what}: card (kernels) and CPU (plain) all verified; round 1 tokens identical, "
            f"round 2 {same:.3f} of tokens identical")


# ---------------------------------------------------------------------------
# Phase 8: sharded decode on a process group of one rank
# ---------------------------------------------------------------------------


def sharded_decode_phase(torch, device="cuda", backend="nccl", geometry=LLAMA3_8B,
                         tokens=SHARDED_CONTEXT):
    """Both sharded entry points on a process group of world size 1 (the
    card's only rank), initialised from a FileStore: one request over
    ``SHARDED_CONTEXT`` tokens of one layer, and the kernel phase's skewed
    wave. Returns the path's launches, read before the comparisons (K3 and
    K6 over the same caches, which the one-shard combine must equal
    bitwise). A CPU rehearsal passes device="cpu", backend="gloo" and a small
    ``geometry`` and ``tokens``."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, kvh, h = geometry["block_tokens"], geometry["n_kv_heads"], geometry["n_heads"]
    d = geometry["dim"] // h
    g = torch.Generator(device=device).manual_seed(99)

    def randn(shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    q = randn((h, d))
    kc, vc = randn((tokens // bt, bt, kvh, d)), randn((tokens // bt, bt, kvh, d))
    table = torch.randperm(tokens // bt, generator=g, device=device).to(torch.int32)
    lens, row_tables, width, n_cache = _skewed_wave()
    rq = randn((len(lens), h, d))
    rkc, rvc = randn((n_cache, bt, kvh, d)), randn((n_cache, bt, kvh, d))
    pages, rows, starts, slens, swidth = pa.build_ragged_wave_sharded([row_tables], [lens], bt)
    if backend == "nccl":
        # Loopback for NCCL's bootstrap; a caller's own setting wins.
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/filestore", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            _ext.reset_launches()
            one = pa.paged_decode_attention_sharded(q, kc, vc, table, tokens)
            wave = pa.paged_decode_attention_ragged_sharded(
                rq, rkc, rvc, pages[0], rows[0], starts[0], slens[0], table_width=swidth)
            _sync(torch, device)
            launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
        finally:
            dist.destroy_process_group()
    k3 = pa.paged_decode_attention_batched(
        q[None], kc, vc, table[None],
        torch.tensor([tokens], dtype=torch.int32, device=device))[0]
    meta = [torch.from_numpy(x).to(device) for x in (pages[0], rows[0], starts[0], slens[0])]
    k6 = pa.paged_decode_attention_ragged(rq, rkc, rvc, *meta, table_width=swidth)
    _sync(torch, device)
    for what, got, want in (("sharded decode", one, k3), ("ragged sharded decode", wave, k6)):
        if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{what}: bad output {tuple(got.shape)}")
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the one-rank combine is not bitwise the unsharded "
                                 f"kernel (max abs diff {max_err(got, want)})")
    log(f"sharded decode ({backend}, world size 1): {tokens}-token request and the "
        f"{len(lens)}-row skewed wave bitwise K3 / K6; the multi-rank combine is held only "
        "on the CPU (4 gloo ranks, tests/test_torch_sharded_decode.py) and over 4 slices in "
        "the kernel phase, since one card has no second rank")
    return launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 9: the overlapped prefill -> decode handoff
# ---------------------------------------------------------------------------


def _disagg_round_trip(torch, llama, h, prompt, gen_tokens):
    """The round trip's functions on the decode side's layout: ``prefill``
    into the decode prefix blocks, then ``decode_step_batched`` from the
    harness's first token. Returns (first logits as host f32, tokens)."""
    _, decode_ids, row = h.tables()
    caches = h.fresh_caches()
    _, caches = llama.prefill(h.params, prompt, caches, decode_ids, h.config)
    table = torch.as_tensor(row, dtype=torch.int32, device=h.device)[None]
    tok, first, tokens = h.first_token, None, []
    for i in range(gen_tokens):
        logits, caches = llama.decode_step_batched(
            h.params, torch.tensor([tok], device=h.device),
            torch.tensor([len(prompt) + i], dtype=torch.int32, device=h.device),
            caches, table, h.config, len(row))
        if i == 0:
            first = logits[0].float().cpu().numpy()
        tok = int(logits[0].argmax())
        tokens.append(tok)
    return first, tokens


class _StampedEvents(list):
    """A leg's ``trace_events`` list that also keeps when each event was
    appended, in ms after ``t0`` (the leg's call)."""

    def __init__(self):
        super().__init__()
        self.t0 = time.perf_counter()
        self.ms = []

    def append(self, event):
        super().append(event)
        self.ms.append((time.perf_counter() - self.t0) * 1e3)

    def timeline(self):
        """{"install": [ms of layer 0, 1, ...], "compute": [...]}"""
        out = {"install": {}, "compute": {}}
        for (kind, layer), ms in zip(self, self.ms):
            out[kind][layer] = ms
        return {kind: [t[k] for k in sorted(t)] for kind, t in out.items()}


def _check_disagg(np, legs, oracles, over_ev, block_ev, counts, journal, n_layers, vocab):
    """The path's checks (module docstring, phase 9); raises on the first
    that fails."""
    oracle = legs["local"]["result"]
    first = oracle.first_logits
    if first.shape != (vocab,) or not np.isfinite(first).all():
        raise AssertionError(f"disagg: local first logits bad, shape {first.shape}")
    for name, leg in legs.items():
        res, want = leg["result"], oracles[name]
        if res.fallback != (name == "fallback"):
            raise AssertionError(f"disagg {name} leg: fallback={res.fallback}")
        if not np.array_equal(res.first_logits, want.first_logits) or res.tokens != want.tokens:
            raise AssertionError(f"disagg {name} leg: first logits or tokens differ from the "
                                 "local recompute's")
    rt_first, rt_tokens = oracles["round_trip"]
    if not np.array_equal(rt_first, first) or rt_tokens != oracle.tokens:
        raise AssertionError("disagg: the local leg differs from the round trip's prefill + "
                             "decode_step_batched")
    for layer in range(n_layers):
        if over_ev.index(("install", layer)) > over_ev.index(("compute", layer)):
            raise AssertionError(f"disagg overlapped leg: layer {layer} computed before its "
                                 "install")
    if over_ev.index(("compute", 0)) > over_ev.index(("install", n_layers - 1)):
        raise AssertionError("disagg overlapped leg: layer 0 computed after the last install")
    last_install = max(i for i, (kind, _) in enumerate(block_ev) if kind == "install")
    first_compute = min(i for i, (kind, _) in enumerate(block_ev) if kind == "compute")
    if last_install > first_compute:
        raise AssertionError("disagg blocking leg: a compute preceded an install")
    if counts["disagg_fallback_recomputes"] != 1 or not journal:
        raise AssertionError(f"disagg: {counts['disagg_fallback_recomputes']} fallback "
                             f"recomputes, {len(journal)} disagg_fallback events (want 1, >= 1)")
    if counts["disagg_wrong_bytes"] != 0:
        raise AssertionError(f"disagg: {counts['disagg_wrong_bytes']} wrong bytes")


def _disagg_k3_check(torch, h, caches, prompt_tokens, gen_tokens, device):
    """K3 held against its plain version at the inputs the disagg path gives
    it: one row, q [1, H, D] in the model's dtype, the decode side's padded
    table row (the prefix's blocks and the generation's, the last one
    partial), and the lengths of the leg's decode steps (the prompt plus
    1..gen_tokens), over the first and the last layer's caches as an
    overlapped leg left them. Within 1e-5 (f32) or 2e-2 (bf16), as in the
    kernel phase; two launches bitwise equal. Not counted in the path's
    launches (read before). On the CPU the wrapper is the plain version,
    so there this only rehearses the check. Returns what it held."""
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg = h.config
    _, _, row = h.tables()
    table = torch.as_tensor(row, dtype=torch.int32, device=device).reshape(1, -1)
    g = torch.Generator(device=device).manual_seed(9)
    q = torch.randn((1, cfg.n_heads, cfg.head_dim), generator=g, device=device).to(cfg.dtype)
    tol = 2e-2 if cfg.dtype == torch.bfloat16 else 1e-5
    lens = [prompt_tokens + 1 + step for step in range(gen_tokens)]
    err = 0.0
    for layer in (0, cfg.n_layers - 1):
        kc, vc = caches[layer]
        for n in lens:
            seq = torch.tensor([n], dtype=torch.int32, device=device)
            got = pa.paged_decode_attention_batched(q, kc, vc, table, seq)
            again = pa.paged_decode_attention_batched(q, kc, vc, table, seq)
            want = pa.paged_decode_attention_plain_batched(q, kc, vc, table, seq)
            _sync(torch, device)
            if not torch.equal(got, again):
                raise AssertionError(f"disagg: K3 at seq_len {n}: two launches differ")
            err = max(err, max_err(got, want))
    if not err <= tol:
        raise AssertionError(f"disagg: K3 at the path's inputs: max abs err {err} > {tol}")
    log(f"disagg: K3 at the path's inputs (q {list(q.shape)} {cfg.dtype}, a {table.shape[1]}-block "
        f"table, seq_len {lens[0]}-{lens[-1]}): max abs err {err:.3e} (tol {tol})")
    return {"max_abs_err": err, "tol": tol, "table_blocks": table.shape[1], "seq_lens": lens}


def _run_disagg(torch, server_port, params, cfg, device, prompt_tokens=PROMPT_TOKENS,
                gen_tokens=DISAGG_GEN_TOKENS):
    """``DISAGG_ROUNDS`` rounds of the handoff's five legs on one
    ``DisaggHarness``, then (on the card) one overlapped leg under the
    profiler, and the checks of every round (module docstring, phase 9).
    Returns (summary, launches); the launches are those of the legs, read
    before the oracles' runs."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import disagg, telemetry
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    nb = prompt_tokens // cfg.block_tokens
    gen_blocks = -(-(prompt_tokens + gen_tokens) // cfg.block_tokens) - nb
    conns = []

    def make_conn():
        conns.append(_client(lib_mod, config_mod, server_port))
        return conns[-1]

    h = None
    try:
        h = disagg.DisaggHarness(make_conn, cfg, num_blocks=2 * nb + gen_blocks, req_blocks=nb,
                                 gen_blocks=gen_blocks, model_id="llama-3-8b-disagg",
                                 params=params, device=device)
        prompt, fb_prompt = h.prompt(seed=1), h.prompt(seed=2)

        async def one_round():
            """The five legs; returns (legs, trace events, counters, journal)."""
            disagg.reset_counters()
            telemetry.reset()
            legs = {"local": await h.run_local(prompt, gen_tokens=gen_tokens)}
            over_ev = _StampedEvents()
            legs["overlapped"] = await h.run_overlapped(
                prompt, watermark=1, gen_tokens=gen_tokens, trace_events=over_ev)
            h.drop(prompt)
            block_ev = _StampedEvents()
            legs["blocking"] = await h.run_blocking(prompt, gen_tokens=gen_tokens,
                                                    trace_events=block_ev)
            h.drop(prompt)
            legs["cold"] = await h.run_cold(prompt, gen_tokens=gen_tokens)
            h.drop(prompt)
            legs["fallback"] = await h.run_overlapped(
                fb_prompt, watermark=1, gen_tokens=gen_tokens, prefill=False,
                retry_missing_s=DISAGG_FALLBACK_RETRY_S)
            journal = [e for e in telemetry.get_journal().snapshot()
                       if e["kind"] == "disagg_fallback"]
            return legs, over_ev, block_ev, disagg.counters().status(), journal

        async def drive():
            rounds = [await one_round() for _ in range(DISAGG_ROUNDS)]
            profiled = profile = None
            if torch.device(device).type == "cuda":
                # One more overlapped leg, under the profiler (not timed as a leg).
                profiled, profile = await _profile_async(torch, lambda: h.run_overlapped(
                    prompt, watermark=1, gen_tokens=gen_tokens))
                h.drop(prompt)
            _sync(torch, device)
            launches = dict(_ext.LAUNCHES)
            fb_oracle = (await h.run_local(fb_prompt, gen_tokens=gen_tokens))["result"]
            return rounds, profiled, profile, launches, fb_oracle

        _ext.reset_launches()
        rounds, profiled, profile, launches, fb_oracle = asyncio.run(drive())
        round_trip = _disagg_round_trip(torch, llama, h, prompt, gen_tokens)
        summary = {"prompt_tokens": prompt_tokens, "gen_tokens": gen_tokens, "rounds": []}
        summary["k3_at_path_inputs"] = _disagg_k3_check(
            torch, h, rounds[0][0]["overlapped"]["result"].caches, prompt_tokens, gen_tokens,
            device)
        for legs, over_ev, block_ev, counts, journal in rounds:
            oracles = {name: legs["local"]["result"] for name in legs}
            oracles["fallback"] = fb_oracle
            oracles["round_trip"] = round_trip
            _check_disagg(np, legs, oracles, over_ev, block_ev, counts, journal,
                          cfg.n_layers, cfg.vocab)
            summary["rounds"].append({
                "handoff_bytes": legs["overlapped"]["written"] * cfg.kv_spec(1).block_nbytes,
                "legs": {
                    name: {
                        "ttft_ms": leg["ttft_s"] * 1e3,
                        "overlap_layers": leg["result"].overlap_layers,
                        "inflight_at_first_token": leg["result"].inflight_at_first_token,
                        "watermark_stalls": leg["result"].watermark_stalls,
                        "fallback": leg["result"].fallback,
                    }
                    for name, leg in legs.items()
                },
                "counters": counts,
                # When each layer installed and its first step's compute
                # began, ms after the leg was called.
                "timeline_ms": {"overlapped": over_ev.timeline(),
                                "blocking": block_ev.timeline()},
            })
        if profiled is not None:
            if not np.array_equal(profiled["result"].first_logits,
                                  rounds[0][0]["local"]["result"].first_logits):
                raise AssertionError("disagg: the profiled overlapped leg differs from the local")
            summary["profile_overlapped_leg"] = profile
        return summary, launches
    finally:
        if h is not None:
            h.close()
        for conn in conns:
            conn.close()


DISAGG_DEMO_PROMPT_TOKENS = 64


def _run_disagg_demo(torch, device):
    """The disagg path at ``disagg.demo_config()``'s defaults (the module's
    CLI model and ``DisaggHarness()``'s: f32, 6 layers, dim 64, 4 heads over
    2 KV heads, head_dim 16, block 8) with the demo weights (``params=None``:
    seed 0), one ``DISAGG_DEMO_PROMPT_TOKENS``-token prompt, on a store of
    its own: every check of phase 9, K3 held at its inputs (f32, 1e-5).
    Returns (summary, launches)."""
    from infinistore_tpu_torch import disagg
    from infinistore_tpu_torch import lib

    cfg = disagg.demo_config()
    if cfg.head_dim != 16:
        raise AssertionError(f"disagg demo: head_dim {cfg.head_dim}, not the demo's 16")
    server = lib.start_local_server(prealloc_bytes=256 << 20, block_bytes=64 << 10,
                                    pin_memory=False)
    try:
        summary, launches = _run_disagg(torch, server.port, None, cfg, device,
                                        prompt_tokens=DISAGG_DEMO_PROMPT_TOKENS)
    finally:
        server.stop()
    return {"head_dim": cfg.head_dim, **summary}, launches


def disagg_demo_phase(torch, smi):
    """Phase 9b: ``_run_disagg_demo`` on the card. Returns (launches,
    summary)."""
    summary, launches = _run_disagg_demo(torch, "cuda")
    summary = {"card": smi, **summary}
    log(f"disagg demo (demo_config(): head_dim {summary['head_dim']}, f32): every leg bitwise "
        "the local recompute in each round, the local leg bitwise the round trip's")
    log(f"disagg demo: {json.dumps(summary)}")
    log(f"disagg demo launches: {json.dumps(launches)}")
    return launches, summary


def disagg_phase(torch, server_port, params, smi):
    """Phase 9: Llama-3-8B width, bf16, on the card. Returns (launches,
    summary)."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    summary, launches = _run_disagg(torch, server_port, params, cfg, "cuda")
    summary = {"card": smi, **summary}
    log(f"disagg: in each of {DISAGG_ROUNDS} rounds every leg bitwise the local recompute "
        f"(first logits and {DISAGG_GEN_TOKENS} tokens), the local leg bitwise the round "
        "trip's; watermark held; one fallback recompute; 0 wrong bytes")
    log(f"disagg: {json.dumps(summary)}")
    log(f"disagg launches: {json.dumps(launches)}")
    return launches, summary


def _cluster_prompts(np, cluster, joiner_id, vocab, prompt_tokens, bt):
    """``PROMPTS`` prompts (from seed 3) such that every serving member owns
    a root, and prompt 0's owner owns a second once the joiner is in the
    placement too (so the member that dies takes two roots with it)."""
    from infinistore_tpu_torch.cluster import rendezvous_ranked
    from infinistore_tpu_torch.connector import token_chain_hashes

    rng = np.random.default_rng(3)
    members = list(cluster.member_ids)
    grown = members + [joiner_id]
    for _ in range(10000):
        prompts = [rng.integers(0, vocab, prompt_tokens).tolist() for _ in range(PROMPTS)]
        roots = [token_chain_hashes(p[:bt], bt)[0] for p in prompts]
        owners = [rendezvous_ranked(members, r)[0] for r in roots]
        owners4 = [rendezvous_ranked(grown, r)[0] for r in roots]
        if set(owners) == set(range(len(members))) and owners4.count(owners4[0]) > 1:
            return prompts
    raise AssertionError("cluster: no prompt set covers every member")


def _cluster_holders(cluster, prompts, nb, bt):
    """Each prompt's complete holders in the catalog (member ids at level
    ``nb``), for the readable members of the current view."""
    from infinistore_tpu_torch.connector import token_chain_hashes

    readable = set(cluster.membership.view().readable_ids())
    out = []
    for p in prompts:
        rec = cluster.catalog_get(token_chain_hashes(p[:bt], bt)[0])
        holders = {} if rec is None else rec.holders
        out.append(sorted(m for m, lv in holders.items() if lv >= nb and m in readable))
    return out


def _run_cluster(torch, params, cfg, device, prompt_tokens=PROMPT_TOKENS,
                 store_bytes=CLUSTER_STORE_BYTES, block_bytes=CLUSTER_BLOCK_BYTES):
    """The multi-server KV pool's path (module docstring, phase 10): four
    in-process servers, a ``ClusterKVConnector`` (R=2, strict, durable
    journal, breakers that open on one transport error) over three of them,
    and the legs save, routed load, join (and a load), owner death (a
    failover load, ``mark_dead``, a load after the re-replication) and
    drop. Every load leg: ``lookup`` hits every block, the loaded blocks
    are engine A's bytes, and ``DECODE_STEPS`` greedy steps at B=``PROMPTS``
    are bitwise engine A's own decode. Raises on the first failed check.
    Returns (summary, launches); the launches are those of the whole path."""
    import tempfile

    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch import telemetry
    from infinistore_tpu_torch.cluster import CircuitBreaker, ClusterKVConnector
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    bt = cfg.block_tokens
    nb = prompt_tokens // bt
    max_blocks = -(-(prompt_tokens + DECODE_STEPS) // bt)
    num_blocks = PROMPTS * max_blocks + 8
    spec = cfg.kv_spec(num_blocks)
    kv_bytes = nb * spec.block_nbytes * 2 * cfg.n_layers  # one prompt's K and V
    rng = np.random.default_rng(4)
    tables_a = torch.arange(PROMPTS * max_blocks, dtype=torch.int32,
                            device=device).reshape(PROMPTS, max_blocks)
    tables_b, tables_c = (
        torch.from_numpy(rng.permutation(num_blocks)[: PROMPTS * max_blocks].astype(np.int32))
        .to(device).reshape(PROMPTS, max_blocks)
        for _ in range(2)
    )
    servers, conns, cluster = [], [], None
    journal_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_")
    summary = {"prompt_tokens": prompt_tokens, "prompts": PROMPTS,
               "kv_bytes_per_prompt": kv_bytes, "store_bytes": store_bytes,
               "block_bytes": block_bytes, "loads": {}}

    def stats():
        out = {}
        for i, conn in enumerate(conns):
            mid = f"127.0.0.1:{servers[i].port}"
            if cluster is not None and cluster.membership.view().state_of(mid) == "dead":
                continue
            st = conn.get_stats()
            out[mid] = {"used_bytes": st["used_bytes"], "keys": st["kvmap_len"]}
        return out

    def reshard_counts():
        pr = cluster.resharder.progress()
        return {k: pr[k] for k in ("reshard_moved_roots", "reshard_moved_keys",
                                   "reshard_moved_bytes", "reshard_pruned_keys",
                                   "reshard_debt_roots", "reshard_lost_roots")}

    try:
        for _ in range(CLUSTER_MEMBERS + 1):
            servers.append(lib_mod.start_local_server(
                prealloc_bytes=store_bytes, block_bytes=block_bytes, pin_memory=False))
            # As the cluster's own dial: reconnecting, a 1 s connect timeout.
            conns.append(lib_mod.InfinityConnection(config_mod.ClientConfig(
                host_addr="127.0.0.1", service_port=servers[-1].port, log_level="error",
                auto_reconnect=True, connect_timeout_ms=1000, op_timeout_ms=5000)))
            conns[-1].connect()
        cluster = ClusterKVConnector(
            conns[:CLUSTER_MEMBERS], spec, "llama-3-8b-cluster", nb, replicas=2, degrade=False,
            journal_path=os.path.join(journal_dir.name, "catalog.journal"),
            breaker_factory=lambda i: CircuitBreaker(fail_threshold=1, seed=i), device=device)
        joiner_id = f"127.0.0.1:{servers[-1].port}"
        prompts = _cluster_prompts(np, cluster, joiner_id, cfg.vocab, prompt_tokens, bt)
        summary["owners"] = [cluster.owner_index(p) for p in prompts]
        caches_a, caches_b, caches_c = (spec.make_caches(device) for _ in range(3))

        def ids(table, p):
            return table[p, :nb].cpu().numpy()

        _ext.reset_launches()
        telemetry.reset()  # the breaker_open events counted below are this path's
        # Leg 1, save: engine A prefills (K4, K2); prompts 0..PROMPTS-2 are
        # mirrored by cluster.save (K1 on each replica), the last one
        # streams layer by layer to its owner (layer 0, the presence
        # sentinel, last).
        first = []
        for p in range(PROMPTS):
            logits, caches_a = llama.prefill(params, prompts[p], caches_a, tables_a[p, :nb],
                                             cfg)
            first.append(logits.argmax())
        first_tokens = torch.stack(first)
        _sync(torch, device)
        t0 = time.perf_counter()
        for p in range(PROMPTS - 1):
            written = asyncio.run(cluster.save(prompts[p], caches_a, ids(tables_a, p)))
            if written != 2 * nb * cfg.n_layers:
                raise AssertionError(f"cluster: save of prompt {p} wrote {written} blocks")
        mirrored_s = time.perf_counter() - t0
        mirror_writes = cluster.health()["qos"]["mirror_writes"]
        if mirror_writes != PROMPTS - 1:
            raise AssertionError(f"cluster: {mirror_writes} mirror writes, expected "
                                 f"{PROMPTS - 1}")
        last = PROMPTS - 1

        async def stream_last():
            order = list(range(1, cfg.n_layers)) + [0]
            for layer in order:
                ship = cluster.stage_layer_save(prompts[last], layer, caches_a[layer],
                                                ids(tables_a, last))
                if await ship() != 2 * nb:
                    raise AssertionError(f"cluster: layer {layer} of prompt {last} shipped "
                                         "short")

        t0 = time.perf_counter()
        asyncio.run(stream_last())
        streamed_s = time.perf_counter() - t0
        holders = _cluster_holders(cluster, prompts, nb, bt)
        if any(len(h) != 2 for h in holders[:last]) or len(holders[last]) != 1:
            raise AssertionError(f"cluster: catalog holders after the saves {holders}")
        summary["save"] = {
            "mirrored_s": mirrored_s, "layer_streamed_s": streamed_s,
            "cluster_save_GBps": {"mirrored": (PROMPTS - 1) * kv_bytes / mirrored_s / 1e9,
                                  "layer_streamed": kv_bytes / streamed_s / 1e9},
            "mirror_writes": mirror_writes, "holders": holders, "members": stats(),
        }
        oracle = _decode_wave(torch, llama, params, cfg, caches_a, tables_a, first_tokens,
                              max_blocks, prompt_tokens)

        def load_leg(name, caches, table):
            """Every prompt through lookup and load into zeroed caches, the
            bytes held against engine A's, and the decode against A's."""
            for k, v in caches:
                k.zero_()
                v.zero_()
            t0 = time.perf_counter()
            hits = [cluster.lookup(p) for p in prompts]
            lookup_s = time.perf_counter() - t0
            if hits != [nb] * PROMPTS:
                raise AssertionError(f"cluster {name}: lookup found {hits} blocks, expected "
                                     f"{nb}")
            t0 = time.perf_counter()
            for p in range(PROMPTS):
                caches, n = asyncio.run(cluster.load(prompts[p], caches, ids(table, p)))
                if n != nb:
                    raise AssertionError(f"cluster {name}: load of prompt {p} brought {n} "
                                         "blocks")
            _sync(torch, device)
            load_s = time.perf_counter() - t0
            for layer in range(cfg.n_layers):
                for kind in (0, 1):
                    for p in range(PROMPTS):
                        if not torch.equal(caches[layer][kind][table[p, :nb].long()],
                                           caches_a[layer][kind][tables_a[p, :nb].long()]):
                            raise AssertionError(f"cluster {name}: layer {layer} kind {kind} "
                                                 f"prompt {p}: loaded bytes differ")
            got = _decode_wave(torch, llama, params, cfg, caches, table, first_tokens,
                               max_blocks, prompt_tokens)
            for step, (la, lb) in enumerate(zip(oracle, got)):
                if not bool(torch.isfinite(lb.float()).all()) or not torch.equal(la, lb):
                    raise AssertionError(f"cluster {name}: decode step {step} differs from "
                                         "engine A's")
            # The lookups go first, so the first op against a dead member
            # is in lookup_s.
            summary["loads"][name] = {"lookup_s": lookup_s, "load_s": load_s,
                                      "cluster_load_GBps": PROMPTS * kv_bytes / load_s / 1e9}
            log(f"cluster {name}: {PROMPTS} prompts loaded byte-equal in {load_s:.3f} s, "
                f"{DECODE_STEPS} decode steps bitwise engine A's")
            return caches

        # Leg 2, routed load (engine B).
        caches_b = load_leg("routed", caches_b, tables_b)

        # Leg 3, join: the resharder moves the rendezvous delta, and the
        # reconcile pass mirrors the layer-streamed prompt.
        t0 = time.perf_counter()
        cluster.add_member(conns[-1], wait=True, timeout=CLUSTER_RESHARD_TIMEOUT_S)
        join_s = time.perf_counter() - t0
        counts = reshard_counts()
        if not cluster.membership.settled or counts["reshard_debt_roots"] != 0:
            raise AssertionError(f"cluster: the join did not settle: {counts}")
        holders = _cluster_holders(cluster, prompts, nb, bt)
        if any(len(h) < 2 for h in holders):
            raise AssertionError(f"cluster: holders {holders} after the join (prompt {last} "
                                 "must have a second)")
        summary["join"] = {"s": join_s, **counts, "holders": holders,
                           "GBps": counts["reshard_moved_bytes"] / join_s / 1e9,
                           "members": stats()}
        caches_b = load_leg("after_join", caches_b, tables_b)

        # Leg 4, owner death: prompt 0's owner stops; engine C fails over.
        victim = cluster.owner_index(prompts[0])
        victim_id = cluster.member_ids[victim]
        victim_roots = [p for p in range(PROMPTS) if cluster.owner_index(prompts[p]) == victim]
        served = {i: h["replica_serves"] for i, h in enumerate(cluster.health()["members"])}
        servers[victim].stop()
        caches_c = load_leg("failover", caches_c, tables_c)
        health = cluster.health()["members"]
        serves = sum(h["replica_serves"] - served.get(i, 0) for i, h in enumerate(health))
        if health[victim]["breaker_state"] == "closed":
            raise AssertionError(f"cluster: the dead member's breaker is {health[victim]}")
        if serves < len(victim_roots):
            raise AssertionError(f"cluster: {serves} replica serves for {len(victim_roots)} "
                                 "roots of the dead member")
        before = reshard_counts()
        t0 = time.perf_counter()
        cluster.mark_dead(victim_id, wait=True, timeout=CLUSTER_RESHARD_TIMEOUT_S)
        dead_s = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in reshard_counts().items()}
        holders = _cluster_holders(cluster, prompts, nb, bt)
        if reshard_counts()["reshard_debt_roots"] != 0 or any(len(h) < 2 for h in holders):
            raise AssertionError(f"cluster: after mark_dead, holders {holders}, {counts}")
        summary["death"] = {"member": victim_id, "roots": len(victim_roots),
                            "replica_serves": serves,
                            "breaker": health[victim]["breaker_state"],
                            "transport_errors": health[victim]["errors"], "s": dead_s,
                            "GBps": counts["reshard_moved_bytes"] / dead_s / 1e9, **counts,
                            "holders": holders, "members": stats()}
        caches_c = load_leg("after_rereplication", caches_c, tables_c)
        _sync(torch, device)
        launches = dict(_ext.LAUNCHES)

        # Leg 5, drop: no key and no catalog record is left.
        for p in prompts:
            if cluster.drop(p) == 0:
                raise AssertionError("cluster: a drop deleted nothing")
        left = {mid: st["keys"] for mid, st in stats().items()}
        live = [i for i, mid in enumerate(cluster.member_ids) if mid != victim_id]
        hits = [cluster.members[i].lookup(p) for i in live for p in prompts]
        catalog = cluster.membership_status()["reshard_catalog_roots"]
        if any(left.values()) or any(hits) or catalog:
            raise AssertionError(f"cluster: after the drops keys {left}, lookups {hits}, "
                                 f"catalog roots {catalog}")
        health = cluster.health()
        summary["replica_serves"] = sum(h["replica_serves"] for h in health["members"])
        summary["mirror_writes"] = health["qos"]["mirror_writes"]
        summary["breaker_trips"] = sum(1 for e in telemetry.get_journal().snapshot()
                                       if e["kind"] == "breaker_open")
        return summary, launches
    finally:
        if cluster is not None:
            cluster.close()
        for conn in conns:
            conn.close()
        for srv in servers:
            srv.stop()
        journal_dir.cleanup()


def cluster_phase(torch, params, smi):
    """Phase 10: Llama-3-8B width, bf16, on the card. Returns (launches,
    summary)."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    t0 = time.perf_counter()
    summary, launches = _run_cluster(torch, params, cfg, "cuda")
    summary = {"card": smi, "wall_s": time.perf_counter() - t0, **summary}
    log("cluster: every load leg (routed, after the join, failover, after the re-replication) "
        "byte-equal and decoding bitwise engine A's; the layer-streamed prompt mirrored by the "
        "join; two live holders a root after mark_dead; no key left after the drops")
    log(f"cluster: {json.dumps(summary)}")
    log(f"cluster launches: {json.dumps(launches)}")
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 11: the vLLM v1 connector under a vLLM-shaped scheduler and runner
# ---------------------------------------------------------------------------


@dataclass
class V1Request:
    """vLLM's ``Request``, as far as the connector reads it."""

    request_id: str
    prompt_token_ids: list


@dataclass
class V1NewRequestData:
    """vLLM's ``NewRequestData``: a request's first scheduled step."""

    req_id: str
    prompt_token_ids: list
    block_ids: list  # one list per KV-cache group
    num_computed_tokens: int = 0


@dataclass
class V1CachedRequestData:
    """vLLM's ``CachedRequestData``: a later step of a running request,
    with no prompt tokens."""

    req_id: str
    new_block_ids: list
    num_computed_tokens: int
    resumed_from_preemption: bool = False


@dataclass
class V1SchedulerOutput:
    """vLLM's ``SchedulerOutput``, as far as the connector reads it."""

    scheduled_new_reqs: list = field(default_factory=list)
    scheduled_cached_reqs: list = field(default_factory=list)
    num_scheduled_tokens: dict = field(default_factory=dict)


def v1_runner_step(worker, meta, names, forward=None, save=True, before_wait_for_save=None):
    """One model-runner step over the v1 connector's worker half, in vLLM's
    order: ``bind_connector_metadata``, ``start_load_kv``; per layer
    ``wait_for_layer_load``, the layer's forward (``forward(layer, k, v)``,
    which writes the layer's KV in place; none given: no compute) and, with
    ``save``, ``save_kv_layer``; ``before_wait_for_save()`` if given;
    ``wait_for_save``, ``clear_connector_metadata``. Returns the host time
    spent in the layer waits and the ``perf_counter`` of the first and last
    ``save_kv_layer`` call."""
    worker.bind_connector_metadata(meta)
    worker.start_load_kv(forward_context=None)
    waits = 0.0
    first_save = last_save = None
    for layer, name in enumerate(names):
        tw = time.perf_counter()
        worker.wait_for_layer_load(name)
        waits += time.perf_counter() - tw
        if forward is not None:
            forward(layer, *worker.kv_cache(name))
        if save:
            last_save = time.perf_counter()
            first_save = first_save or last_save
            worker.save_kv_layer(name, worker.kv_cache(name), attn_metadata=None)
    if before_wait_for_save is not None:
        before_wait_for_save()
    worker.wait_for_save()
    worker.clear_connector_metadata()
    return waits, first_save, last_save


def vllm_v1_phase(torch, server_port, params, smi):
    """Phase 11: Llama-3-8B width, bf16, on the card. Returns (launches,
    summary)."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    t0 = time.perf_counter()
    summary, launches = _run_vllm_v1(torch, server_port, params, cfg, "cuda")
    summary = {"card": smi, "wall_s": time.perf_counter() - t0, **summary}
    log(f"vllm_v1: {json.dumps(summary)}")
    log(f"vllm_v1 launches: {json.dumps(launches)}")
    return launches, summary


class _V1Engine:
    """One vLLM-shaped engine: the connector's scheduler half and worker
    half as separate instances, each over its own ``KVConnector`` and
    connection, and the runner's paged caches (registered with the worker)
    with one block table row per request."""

    def __init__(self, torch, server_port, spec, model_id, max_blocks, tables, device):
        import types

        from infinistore_tpu_torch import config as config_mod
        from infinistore_tpu_torch import lib as lib_mod
        from infinistore_tpu_torch.connector import KVConnector
        from infinistore_tpu_torch.vllm_v1 import InfiniStoreKVConnectorV1, KVConnectorRole

        self.torch, self.device, self.tables = torch, device, tables
        self.owned = []
        halves = []
        for role in (KVConnectorRole.SCHEDULER, KVConnectorRole.WORKER):
            conn = _client(lib_mod, config_mod, server_port)
            kv = KVConnector(conn, spec, model_id, max_blocks=max_blocks, device=device)
            self.owned.append((kv, conn))
            cfg = types.SimpleNamespace(kv_transfer_config=types.SimpleNamespace(
                kv_connector_extra_config={"kv_connector": kv}))
            halves.append(InfiniStoreKVConnectorV1(cfg, role))
        self.sched, self.worker = halves
        self.caches = spec.make_caches(device)
        self.names = [f"model.layers.{i}.self_attn" for i in range(spec.num_layers)]
        self.worker.register_kv_caches(dict(zip(self.names, self.caches)))

    def blocks(self, p, start, stop):
        return [int(b) for b in self.tables[p, start:stop].cpu()]

    def step(self, meta, forward, before_wait_for_save=None):
        """One runner step (``v1_runner_step``); returns its host timings."""
        w = self.worker
        t0 = time.perf_counter()
        waits, first_save, last_save = v1_runner_step(w, meta, self.names, forward,
                                                      before_wait_for_save=before_wait_for_save)
        _sync(self.torch, self.device)
        end = time.perf_counter()
        return {"wall_s": end - t0, "load_s": w.load_seconds, "layer_waits_s": waits,
                "save_s": end - first_save, "save_tail_s": end - last_save}

    def close(self):
        self.worker.close()
        for kv, conn in self.owned:
            kv.close()
            conn.close()


def _run_vllm_v1(torch, server_port, params, cfg, device, prompt_tokens=PROMPT_TOKENS,
                 chunk_tokens=V1_CHUNK_TOKENS, suffix_tokens=V1_SUFFIX_TOKENS,
                 decode_steps=DECODE_STEPS):
    """The vLLM v1 connector's path (module docstring, phase 11). Engine A
    prefills ``PROMPTS`` prompts in chunked steps (the first chunk through
    ``prefill_layer``, later ones through ``decode_wave_layer``), saving
    each step's blocks layer by layer; engine B loads every prefix behind
    per-layer waits, computes and saves a ``suffix_tokens`` suffix, and
    decodes ``decode_steps`` greedy steps; engine A runs the same suffix and
    steps on its own caches as the oracle. Raises on the first failed check.
    Returns (summary, launches); the launches are those of the whole path."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    bt = cfg.block_tokens
    nb = prompt_tokens // bt
    if prompt_tokens % chunk_tokens or chunk_tokens % bt or suffix_tokens % bt:
        raise ValueError("chunks and the suffix must be whole blocks of the prompt")
    chunks = prompt_tokens // chunk_tokens
    total = prompt_tokens + suffix_tokens
    max_blocks = -(-(total + decode_steps) // bt)
    num_blocks = PROMPTS * max_blocks + 8
    spec = cfg.kv_spec(num_blocks)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, prompt_tokens).tolist() for _ in range(PROMPTS)]
    suffixes = rng.integers(0, cfg.vocab, (PROMPTS, suffix_tokens))
    tables_a = torch.arange(PROMPTS * max_blocks, dtype=torch.int32,
                            device=device).reshape(PROMPTS, max_blocks)
    tables_b = torch.from_numpy(rng.permutation(num_blocks)[: PROMPTS * max_blocks]
                                .astype(np.int32)).to(device).reshape(PROMPTS, max_blocks)
    layer_bytes = 2 * spec.block_nbytes  # one block's K and V, one layer
    summary = {"prompt_tokens": prompt_tokens, "prompts": PROMPTS, "chunk_tokens": chunk_tokens,
               "suffix_tokens": suffix_tokens, "decode_steps": decode_steps, "steps": []}

    def record(engine, step, timing, saved_blocks, loaded_blocks):
        saved = saved_blocks * layer_bytes * cfg.n_layers
        loaded = loaded_blocks * layer_bytes * cfg.n_layers
        row = {"engine": engine, "step": step, **timing, "saved_bytes": saved,
               "loaded_bytes": loaded,
               "save_GBps": saved / timing["save_s"] / 1e9 if saved else None,
               "load_GBps": loaded / timing["load_s"] / 1e9 if loaded else None,
               "load_hidden_s": timing["load_s"] - timing["layer_waits_s"] if loaded else None}
        summary["steps"].append(row)
        log(f"vllm_v1 engine {engine} step {step}: {json.dumps(row)}")

    def suffix_chain(tables):
        """The suffix through the layer functions: [PROMPTS, suffix, vocab]."""
        positions = (prompt_tokens + torch.arange(suffix_tokens, dtype=torch.int32,
                                                  device=device)).repeat(PROMPTS, 1)
        index = llama.wave_index(positions, tables, cfg, max_blocks)
        state = {"x": llama.embed_wave(params, torch.from_numpy(suffixes).to(device))}

        def forward(layer, k, v):
            state["x"], _, _ = llama.decode_wave_layer(
                params, state["x"], positions, k, v, tables, cfg, layer, max_blocks,
                index=index)

        return forward, lambda: llama.lm_logits(params, state["x"])

    def decode(caches, tables, first, on_step=None):
        return _decode_wave(torch, llama, params, cfg, caches, tables, first, max_blocks,
                            total, steps=decode_steps, on_step=on_step)

    probe_conn = _client(lib_mod, config_mod, server_port)
    probe = KVConnector(probe_conn, spec, "v1-llama", max_blocks=max_blocks, device=device)
    engines = []
    _ext.reset_launches()
    try:
        # Engine A: misses, prefilled in chunks of chunk_tokens scheduled tokens.
        a = _V1Engine(torch, server_port, spec, "v1-llama", max_blocks, tables_a, device)
        engines.append(a)
        reqs = [V1Request(f"a{p}", prompts[p]) for p in range(PROMPTS)]
        cb = chunk_tokens // bt
        for p, req in enumerate(reqs):
            promised, is_async = a.sched.get_num_new_matched_tokens(req, 0)
            if promised != 0 or is_async:
                raise AssertionError(f"vllm_v1: engine A's {req.request_id} promised {promised}")
            a.sched.update_state_after_alloc(req, [a.blocks(p, 0, cb)], 0)
        for step in range(chunks):
            lo = step * chunk_tokens
            sched_tokens = {req.request_id: chunk_tokens for req in reqs}
            if step == 0:
                out = V1SchedulerOutput(
                    scheduled_new_reqs=[V1NewRequestData(req.request_id, req.prompt_token_ids,
                                                         [a.blocks(p, 0, cb)])
                                        for p, req in enumerate(reqs)],
                    num_scheduled_tokens=sched_tokens)
                xs = [llama.embed_prompt(params, prompts[p][:chunk_tokens]) for p in range(PROMPTS)]

                def forward(layer, k, v, xs=xs):
                    for p in range(PROMPTS):
                        xs[p], _, _ = llama.prefill_layer(params, xs[p], k, v,
                                                          tables_a[p, :cb], cfg, layer)
            else:
                out = V1SchedulerOutput(
                    scheduled_cached_reqs=[V1CachedRequestData(
                        req.request_id, [a.blocks(p, step * cb, (step + 1) * cb)], lo)
                        for p, req in enumerate(reqs)],
                    num_scheduled_tokens=sched_tokens)
                tokens = torch.tensor([pr[lo:lo + chunk_tokens] for pr in prompts], device=device)
                positions = (lo + torch.arange(chunk_tokens, dtype=torch.int32,
                                               device=device)).repeat(PROMPTS, 1)
                index = llama.wave_index(positions, tables_a, cfg, max_blocks)
                state = {"x": llama.embed_wave(params, tokens)}

                def forward(layer, k, v, state=state, positions=positions, index=index):
                    state["x"], _, _ = llama.decode_wave_layer(
                        params, state["x"], positions, k, v, tables_a, cfg, layer, max_blocks,
                        index=index)
            meta = a.sched.build_connector_meta(out)
            want = [(step * cb, cb)] * PROMPTS
            got = [(s.first_block, len(s.block_ids)) for s in meta.saves]
            if meta.loads or got != want:
                raise AssertionError(f"vllm_v1: engine A step {step + 1} plans saves {got}, "
                                     f"loads {len(meta.loads)}")
            record("A", step + 1, a.step(meta, forward), PROMPTS * cb, 0)
        hits = [probe.lookup(p) for p in prompts]
        if hits != [nb] * PROMPTS:
            raise AssertionError(f"vllm_v1: after the chunked prefill lookups read {hits}")
        summary["lookup_after_chunks"] = hits
        for req in reqs:
            a.sched.request_finished(req, None)
        log(f"vllm_v1: engine A's {PROMPTS} prompts prefilled in {chunks} chunked steps, "
            f"saved layer by layer, every lookup {nb} blocks")

        # Engine B: fresh caches; the prompts plus a suffix, the prefixes loaded.
        b = _V1Engine(torch, server_port, spec, "v1-llama", max_blocks, tables_b, device)
        engines.append(b)
        t_first = time.perf_counter()
        nt = total // bt
        full = [prompts[p] + suffixes[p].tolist() for p in range(PROMPTS)]
        reqs = [V1Request(f"b{p}", full[p]) for p in range(PROMPTS)]
        promised = []
        for p, req in enumerate(reqs):
            ext, is_async = b.sched.get_num_new_matched_tokens(req, 0)
            promised.append(ext if not is_async else None)
            b.sched.update_state_after_alloc(req, [b.blocks(p, 0, nt)], ext)
        if promised != [prompt_tokens] * PROMPTS:
            raise AssertionError(f"vllm_v1: engine B was promised {promised} tokens")
        summary["promised_tokens"] = promised
        meta = b.sched.build_connector_meta(V1SchedulerOutput(
            scheduled_new_reqs=[V1NewRequestData(req.request_id, req.prompt_token_ids,
                                                 [b.blocks(p, 0, nt)], promised[p])
                                for p, req in enumerate(reqs)],
            num_scheduled_tokens={req.request_id: suffix_tokens for req in reqs}))
        loads = [(s.first_block, len(s.block_ids)) for s in meta.loads]
        saves = [(s.first_block, len(s.block_ids)) for s in meta.saves]
        if loads != [(0, nb)] * PROMPTS or saves != [(nb, nt - nb)] * PROMPTS:
            raise AssertionError(f"vllm_v1: engine B plans loads {loads}, saves {saves}")
        forward, logits_of = suffix_chain(tables_b)
        sentinel = {}

        def before_wait_for_save():
            sentinel["before"] = sorted({probe.lookup(f) for f in full})

        timing = b.step(meta, forward, before_wait_for_save)
        sentinel["after"] = sorted({probe.lookup(f) for f in full})
        summary["lookup_before_wait_for_save"] = sentinel["before"]
        summary["lookup_after_wait_for_save"] = sentinel["after"]
        if (sentinel["before"], sentinel["after"]) != ([nb], [nt]):
            raise AssertionError(f"vllm_v1: lookups of prompt + suffix read {sentinel['before']} "
                                 f"blocks before wait_for_save and {sentinel['after']} after "
                                 f"(expected {nb}, then {nt}: the sentinel commits last)")
        loaded = [b.worker.loaded_tokens(req.request_id) for req in reqs]
        summary["loaded_tokens"] = loaded
        if loaded != [prompt_tokens] * PROMPTS:
            raise AssertionError(f"vllm_v1: engine B's loads delivered {loaded} tokens")
        record("B", 1, timing, PROMPTS * (nt - nb), PROMPTS * nb)
        logits_b = logits_of()

        def first_logits(step, logits):
            if step == 0:
                logits.cpu()
                summary["time_to_first_decode_logits_s"] = time.perf_counter() - t_first

        decode_b = decode(b.caches, tables_b, logits_b[:, -1].argmax(dim=-1), first_logits)
        _sync(torch, device)
        for layer in range(cfg.n_layers):
            for kind in (0, 1):
                for p in range(PROMPTS):
                    if not torch.equal(a.caches[layer][kind][tables_a[p, :nb].long()],
                                       b.caches[layer][kind][tables_b[p, :nb].long()]):
                        raise AssertionError(f"vllm_v1: layer {layer} kind {kind} prompt {p}: "
                                             "engine B's loaded blocks differ from A's")
        log("vllm_v1: engine B's loaded blocks equal engine A's byte for byte")

        # The oracle: engine A continues on its own caches, with no store.
        forward, logits_of = suffix_chain(tables_a)
        for layer in range(cfg.n_layers):
            forward(layer, *a.caches[layer])
        logits_a = logits_of()
        decode_a = decode(a.caches, tables_a, logits_a[:, -1].argmax(dim=-1))
        _sync(torch, device)
        launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
        if logits_b.shape != (PROMPTS, suffix_tokens, cfg.vocab) or \
                not bool(torch.isfinite(logits_b.float()).all()):
            raise AssertionError(f"vllm_v1: bad suffix logits {tuple(logits_b.shape)}")
        if not torch.equal(logits_a, logits_b):
            raise AssertionError("vllm_v1: engine B's suffix logits differ from engine A's")
        for step, (la, lb) in enumerate(zip(decode_a, decode_b)):
            if not bool(torch.isfinite(lb.float()).all()) or not torch.equal(la, lb):
                raise AssertionError(f"vllm_v1: decode step {step}: engine B's logits differ "
                                     "from engine A's")
        log(f"vllm_v1: engine B's suffix logits and {decode_steps} decode steps bitwise engine "
            "A's own continuation")
    finally:
        for engine in engines:
            engine.close()
        probe.close()
        probe_conn.close()
    return summary, launches


# ---------------------------------------------------------------------------
# Phase 12: the serving surface's command-line entry points
# ---------------------------------------------------------------------------


def _run_main(main, argv):
    """Call an entry point's ``main(argv)`` in this process; returns (exit
    code, its last stdout line as JSON)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _wait_membership(port, proc, predicate, timeout_s):
    """Poll a fleet client's ``GET /membership`` until ``predicate`` holds;
    raises if the process exits or the deadline passes."""
    import urllib.request

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"serving_cli: the fleet client exited ({proc.returncode})")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/membership",
                                        timeout=2) as resp:
                doc = json.loads(resp.read())
            if predicate(doc):
                return doc
        except (OSError, ValueError):
            pass
        time.sleep(0.2)
    raise AssertionError(f"serving_cli: /membership on {port} not ready in {timeout_s} s")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_serving_cli(torch, device, benchmark_args=("--wave", str(SERVING_WAVE)),
                     roots=FLEET_ROOTS):
    """The serving surface's entry points (module docstring, phase 12): the
    benchmark CLI's store, decode-wave and trace legs in this process
    against an in-process server, its module entry point once as a
    subprocess, and a fleet client seeded in a subprocess, stopped, and
    verified by its ``--verify`` run in this process. Raises on the first
    failed check. Returns (summary, launches); the launches are this
    process's over the whole path."""
    import signal
    import tempfile

    from infinistore_tpu_torch import benchmark, fleet_client
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.cuda import _ext

    dev = ["--device", str(device)]
    summary = {"trace_model": {k: str(v).removeprefix("torch.")
                               for k, v in benchmark.TRACE_MODEL.items()}}
    _ext.reset_launches()
    server = lib_mod.start_local_server(prealloc_bytes=1 << 30, block_bytes=64 << 10,
                                        pin_memory=False)
    try:
        port = ["--service-port", str(server.port)]
        for leg, argv in (("store", [*benchmark_args, "--json"]),
                          ("trace", ["--trace", "skewed", "--json"])):
            t0 = time.perf_counter()
            rc, result = _run_main(benchmark.main, argv + port + dev)
            result["wall_s"] = time.perf_counter() - t0
            log(f"serving_cli benchmark {leg}: {json.dumps(result)}")
            if rc != 0 or result["verified"] is not True:
                raise AssertionError(f"serving_cli: benchmark {leg} leg rc {rc}, verified "
                                     f"{result['verified']}")
            summary[f"benchmark_{leg}"] = result
        if "decode_wave" not in summary["benchmark_store"]:
            raise AssertionError("serving_cli: the benchmark ran no decode-wave leg")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "infinistore_tpu_torch.benchmark", "--type", "tcp",
             "--size", "4", "--json", *port, *dev],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        if out.returncode != 0 or json.loads(out.stdout.strip().splitlines()[-1])["verified"] \
                is not True:
            raise AssertionError(f"serving_cli: python -m infinistore_tpu_torch.benchmark exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        summary["benchmark_module_s"] = time.perf_counter() - t0
        log(f"serving_cli: python -m infinistore_tpu_torch.benchmark --type tcp: "
            f"{out.stdout.strip().splitlines()[-1]}")
    finally:
        server.stop()

    stores = [lib_mod.start_local_server(prealloc_bytes=64 << 20, block_bytes=4 << 10,
                                         pin_memory=False) for _ in range(2)]
    journal = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    manage = _free_port()
    args = ["--manage-port", str(manage),
            "--stores", ",".join(f"127.0.0.1:{s.port}" for s in stores),
            "--journal", os.path.join(journal.name, "client.journal"),
            "--roots", str(roots), "--seed", "23", *dev]
    proc = None
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "infinistore_tpu_torch.fleet_client",
                                 *args], cwd=HERE)
        doc = _wait_membership(manage, proc,
                               lambda d: d.get("reshard_catalog_roots", 0) >= roots,
                               FLEET_READY_S)
        summary["fleet_seed_s"] = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0 or doc["reshard_catalog_roots"] != roots:
            raise AssertionError(f"serving_cli: the seeding fleet client exited {rc} with "
                                 f"{doc['reshard_catalog_roots']} roots in its catalog")
        t0 = time.perf_counter()
        rc, report = _run_main(fleet_client.main, args + ["--verify"])
        summary["fleet_verify_s"] = time.perf_counter() - t0
        summary["fleet_verify"] = report
        log(f"serving_cli fleet client --verify: {json.dumps(report)}")
        if rc != 0 or (report["reads"], report["wrong"], report["misses"]) != (roots, 0, 0):
            raise AssertionError(f"serving_cli: fleet --verify rc {rc}: {report}")
        launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for s in stores:
            s.stop()
        journal.cleanup()
    return summary, launches


def serving_cli_phase(torch, smi):
    """Phase 12: on the card. Returns (launches, summary)."""
    t0 = time.perf_counter()
    summary, launches = _run_serving_cli(torch, "cuda")
    summary = {"card": smi, "wall_s": time.perf_counter() - t0, **summary}
    log("serving_cli: the benchmark's store, decode-wave and trace legs verified; the module "
        "entry point started; the fleet client's restart-and-verify read every root right")
    log(f"serving_cli: {json.dumps(summary)}")
    log(f"serving_cli launches: {json.dumps(launches)}")
    return launches, summary


# ---------------------------------------------------------------------------
# Phase 13: the same-mesh block handoff (``cuda/ici.py``)
# ---------------------------------------------------------------------------


def _run_ici_handoff(torch, server_port, params, device="cuda", geometry=LLAMA3_8B,
                     prompt_tokens=PROMPT_TOKENS, device_b=None):
    """Engine A (on ``device``) prefills ``PROMPTS`` prompts; the
    connector's interconnect branch moves each into engine B's cache over
    the mesh ``[device, device_b]`` (shard 0 engine A, shard 1 engine B;
    ``device_b`` None: ``device`` again, the one-card mesh); then the store
    branch moves the same prompts within engine A's caches to B's block ids
    (module docstring, phase 13). Engine B decodes on ``device_b`` with a
    copy of the weights. ``params`` None: seeded weights (the CPU
    rehearsal). Returns (metrics, launches); the launches are the path's
    own, every leg included."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda.ici import IciBlockTransfer
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **geometry)
    if params is None:
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)
    device_b = device if device_b is None else device_b
    params_b = params if device_b == device else {k: w.to(device_b) for k, w in params.items()}
    bt = cfg.block_tokens
    nb = prompt_tokens // bt
    max_blocks = -(-(prompt_tokens + DECODE_STEPS) // bt)
    # Engine A's requests in the first half of the blocks, B's scattered over
    # the second half, so that the store leg can land B's layout inside A's
    # caches without overwriting a prompt it has yet to save.
    half = PROMPTS * max_blocks
    spec = cfg.kv_spec(2 * half)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, prompt_tokens).tolist() for _ in range(PROMPTS)]
    tables_a = torch.arange(half, dtype=torch.int32).reshape(PROMPTS, max_blocks)
    tables_b = torch.from_numpy(half + rng.permutation(half).astype(np.int32)).reshape(
        PROMPTS, max_blocks)
    outside = torch.ones(2 * half, dtype=torch.bool)
    outside[tables_b[:, :nb].reshape(-1).long()] = False
    ids_a, ids_b = tables_a[:, :nb].numpy(), tables_b[:, :nb].numpy()
    tables_a, tables_b, outside = tables_a.to(device), tables_b.to(device_b), outside.to(device_b)
    # The CPU's plain versions count no launch.
    per_call = 1 if torch.device(device).type == "cuda" else 0

    tr = IciBlockTransfer([device, device_b], "store", perm=[(0, 1)])
    kv_ici = KVConnector(None, spec, "llama-3-8b-ici", max_blocks=nb, device=device, ici=tr)
    conn = _client(lib_mod, config_mod, server_port)
    kv_store = KVConnector(conn, spec, "llama-3-8b-ici", max_blocks=nb, device=device)
    try:
        caches_a = spec.make_caches(device)
        caches_b = spec.make_caches(device_b)
        _ext.reset_launches()
        first = []
        for p in range(PROMPTS):
            logits, caches_a = llama.prefill(params, prompts[p], caches_a, tables_a[p, :nb], cfg)
            first.append(logits.argmax())
        first_tokens = torch.stack(first)
        before_a = [(k.clone(), v.clone()) for k, v in caches_a]
        _sync(torch, device)

        ici_s, handoff_launches = [], []
        copies = ("gather_blocks", "gather_blocks_bulk", "scatter_blocks", "scatter_blocks_bulk")
        for p in range(PROMPTS):
            counts, launched = dict(_ext.LAUNCHES), tr.launches
            sharded = [((ka, kb), (va, vb)) for (ka, va), (kb, vb) in zip(caches_a, caches_b)]
            t0 = time.perf_counter()
            out, n = asyncio.run(kv_ici.handoff(prompts[p], sharded, ids_a[p], ids_b[p],
                                                src=0, dst=1))
            _sync(torch, device, device_b)
            ici_s.append(time.perf_counter() - t0)
            if n != nb:
                raise AssertionError(f"ICI handoff of prompt {p} moved {n} blocks, expected {nb}")
            moved = {name: _ext.LAUNCHES[name] - counts[name] for name in copies}
            handoff_launches.append(tr.launches - launched)
            if handoff_launches[-1] != 1 or set(moved.values()) != {per_call}:
                raise AssertionError(
                    f"ICI handoff of prompt {p}: {handoff_launches[-1]} transfer launches and "
                    f"{moved}, expected 1 and {per_call} K1 / K2 launch each, on the bulk ring")
            if any(got is not want for layer in range(cfg.n_layers) for kind in (0, 1)
                   for got, want in zip(out[layer][kind],
                                        (caches_a[layer][kind], caches_b[layer][kind]))):
                raise AssertionError("the ICI handoff did not update the caches in place")
        for layer in range(cfg.n_layers):
            for kind in (0, 1):
                a, b = caches_a[layer][kind], caches_b[layer][kind]
                if not torch.equal(a, before_a[layer][kind]):
                    raise AssertionError(f"layer {layer} kind {kind}: the source shard changed")
                for p in range(PROMPTS):
                    if not torch.equal(b[tables_b[p, :nb].long()],
                                       a[tables_a[p, :nb].long()].to(b.device)):
                        raise AssertionError(
                            f"layer {layer} kind {kind} prompt {p}: ICI-moved bytes differ")
                if bool(b[outside].any()):
                    raise AssertionError(f"layer {layer} kind {kind}: blocks outside dst changed")
        del before_a
        log(f"ici handoff: {PROMPTS} requests byte-equal in engine B, one transfer launch "
            "(one K1, one K2) each, the source shard unchanged")
        logits_ici = _decode_wave(torch, llama, params_b, cfg, caches_b, tables_b,
                                  first_tokens.to(device_b), max_blocks, prompt_tokens)

        store_s = []
        for p in range(PROMPTS):
            t0 = time.perf_counter()
            caches_a, n = asyncio.run(kv_store.handoff(prompts[p], caches_a, ids_a[p], ids_b[p]))
            _sync(torch, device)
            store_s.append(time.perf_counter() - t0)
            if n != nb:
                raise AssertionError(f"store handoff of prompt {p} moved {n} blocks")
        logits_store = _decode_wave(torch, llama, params, cfg, caches_a, tables_b.to(device),
                                    first_tokens, max_blocks, prompt_tokens)
        _sync(torch, device, device_b)
        launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
        for step, (li, ls) in enumerate(zip(logits_ici, logits_store)):
            if li.shape != (PROMPTS, cfg.vocab) or not bool(torch.isfinite(li.float()).all()):
                raise AssertionError(f"decode step {step}: bad logits {tuple(li.shape)}")
            if not torch.equal(li.to(ls.device), ls):
                raise AssertionError(
                    f"decode step {step}: after the ICI handoff the logits differ from those "
                    "after the store handoff")
        log(f"ici handoff: {DECODE_STEPS} greedy steps at B={PROMPTS} from engine B bitwise "
            "those after the store handoff")
        for p in range(PROMPTS):
            kv_store.drop(prompts[p])
    finally:
        kv_ici.close()
        kv_store.close()
        conn.close()
    req_bytes = nb * spec.block_nbytes * 2 * cfg.n_layers
    metrics = {
        "request_bytes": req_bytes,
        "handoff_ms": [s * 1e3 for s in ici_s],
        "handoff_GBps": [req_bytes / s / 1e9 for s in ici_s],
        "store_handoff_ms": [s * 1e3 for s in store_s],
        "store_handoff_GBps": [req_bytes / s / 1e9 for s in store_s],
        "handoff_launches": handoff_launches,
    }
    return metrics, launches


def ici_handoff_phase(torch, server_port, params, smi):
    """Phase 13: Llama-3-8B width, bf16, on the card. Returns (launches,
    metrics)."""
    metrics, launches = _run_ici_handoff(torch, server_port, params)
    metrics = {"card": smi, **metrics}
    log(f"ici handoff: {json.dumps(metrics)}")
    log(f"ici handoff launches: {json.dumps(launches)}")
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 14: the sequence-parallel long-context prefill
# ---------------------------------------------------------------------------


def _dense_long_context(torch, llama, params, cfg, tokens):
    """The oracle of ``prefill_ring``: the dense masked forward of
    ``tests/test_long_context.py:37-48`` over the whole prompt (``_kv_proj``
    and ``_block`` with an explicit causal mask). Returns (logits [1, S, V],
    [(k, v)] per layer)."""
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    mask = positions[:, :, None] >= positions[:, None, :]
    x = params["embed"][tokens]
    kvs = []
    for layer in range(cfg.n_layers):
        k, v = llama._kv_proj(params, layer, x, positions, cfg)
        kvs.append((k, v))
        x = llama._block(params, layer, x, k, v, positions, mask, cfg)
    return llama.lm_logits(params, x), kvs


def _check_close(torch, what, got, want, tol):
    """Raise unless ``got`` is finite, of ``want``'s shape and within
    ``tol`` (absolute and relative) of it; returns the largest absolute
    difference."""
    if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             "or values not finite")
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max abs diff {err} over the tolerance {tol}")
    return err


def _run_long_context(torch, server_port, params, device="cuda", backend="nccl",
                      geometry=LLAMA3_8B, tokens=LONG_CONTEXT_TOKENS, rank=0, world=1,
                      init_file=None):
    """One rank of the long-context path (module docstring, phase 14): its
    token chunk through ``prefill_ring`` on a process group of ``world``
    ranks, initialised from ``init_file`` (a fresh FileStore when None),
    its K/V saved under the full token list, every rank's K/V gathered, the
    prefix loaded into a fresh cache and decoded. ``params`` None: seeded
    weights (the CPU rehearsal, which runs 4 gloo ranks). Returns (metrics,
    launches); the launches are read before the oracles run."""
    import datetime
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda.paged import scatter_blocks_many
    from infinistore_tpu_torch.models import llama, long_context, ring_attention, ulysses

    if backend == "nccl":
        # Loopback for NCCL's bootstrap; a caller's own setting wins. One
        # card a rank: "cuda" is then the rank's card.
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **geometry)
    if params is None:
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)
    bt, s_loc = cfg.block_tokens, tokens // world
    nb, bps = tokens // bt, s_loc // bt
    max_blocks = -(-(tokens + DECODE_STEPS) // bt)
    spec = cfg.kv_spec(max_blocks)
    prompt = np.random.default_rng(17).integers(0, cfg.vocab, tokens)
    token_list = prompt.tolist()
    chunk = torch.from_numpy(prompt[rank * s_loc:(rank + 1) * s_loc]).to(device)[None]
    table = torch.arange(max_blocks, dtype=torch.int32, device=device)
    own_ids = table[rank * bps:(rank + 1) * bps]

    def blocks(t):
        """[1, S, KVH, D] K or V -> [S // bt, *block]."""
        return t[0].reshape(-1, *spec.block_shape)

    def gather(t):
        """Every rank's [1, S_loc, ...] chunk, concatenated in rank order."""
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=1)

    conn = _client(lib_mod, config_mod, server_port)
    kv = KVConnector(conn, spec, "llama-3-8b-long", max_blocks=nb, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{init_file or tmp + '/filestore'}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            _ext.reset_launches()
            # Twice: the first call also sets up the group's point-to-point
            # channels (NCCL makes them at their first use).
            prefill_s = []
            for _ in range(2):
                _sync(torch, device)
                t0 = time.perf_counter()
                logits, kvs = long_context.prefill_ring(params, chunk, cfg)
                _sync(torch, device)
                prefill_s.append(time.perf_counter() - t0)

            # This rank's shard into a paged cache at its global block ids,
            # saved under the full token list from its first block on.
            own = spec.make_caches(device)
            scatter_blocks_many([c for pair in own for c in pair], own_ids,
                                [blocks(t) for pair in kvs for t in pair])
            t0 = time.perf_counter()
            written = asyncio.run(kv.save(token_list, own, own_ids.cpu().numpy(),
                                          first_block=rank * bps))
            save_s = time.perf_counter() - t0
            if written != 2 * cfg.n_layers * bps:
                raise AssertionError(f"rank {rank} saved {written} blocks")
            del own
            dist.barrier()

            direct = spec.make_caches(device)
            scatter_blocks_many([c for pair in direct for c in pair], table[:nb],
                                [blocks(gather(t)) for pair in kvs for t in pair])
            hit = kv.lookup(token_list)
            if hit != nb:
                raise AssertionError(f"rank {rank}: lookup found {hit} blocks, expected {nb}")
            t0 = time.perf_counter()
            loaded, n = asyncio.run(kv.load(token_list, spec.make_caches(device),
                                            table[:nb].cpu().numpy()))
            _sync(torch, device)
            load_s = time.perf_counter() - t0
            if n != nb:
                raise AssertionError(f"rank {rank}: load brought {n} blocks")
            for layer in range(cfg.n_layers):
                for kind in (0, 1):
                    if not torch.equal(loaded[layer][kind], direct[layer][kind]):
                        raise AssertionError(
                            f"layer {layer} kind {kind}: the loaded prefix differs from the "
                            "ring's K/V")
            # The last rank holds the prompt's last row.
            first = logits[0, -1].argmax().reshape(1)
            dist.broadcast(first, src=world - 1)
            steps = [_decode_wave(torch, llama, params, cfg, caches, table[None], first,
                                  max_blocks, tokens) for caches in (loaded, direct)]
            _sync(torch, device)
            launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
            for step, (a, b) in enumerate(zip(*steps)):
                if a.shape != (1, cfg.vocab) or not bool(torch.isfinite(a.float()).all()):
                    raise AssertionError(f"decode step {step}: bad logits {tuple(a.shape)}")
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"decode step {step}: from the loaded prefix the logits differ from "
                        "those from the ring's own K/V")
            dist.barrier()
            if rank == 0 and kv.drop(token_list) == 0:
                raise AssertionError("the long-context prefix held no keys to drop")
            del loaded, direct, steps

            # The oracles: the dense masked forward, and Ulysses against the
            # ring on layer 0's inputs.
            ref_logits, ref_kvs = _dense_long_context(
                torch, llama, params, cfg, torch.from_numpy(prompt).to(device)[None])
            sl = slice(rank * s_loc, (rank + 1) * s_loc)
            errs = {"logits": _check_close(torch, "ring logits", logits,
                                           ref_logits[:, sl], LONG_CONTEXT_TOL)}
            del ref_logits
            errs["kv"] = max(
                _check_close(torch, f"layer {layer} {'kv'[side]}", kvs[layer][side],
                             ref_kvs[layer][side][:, sl], LONG_CONTEXT_TOL)
                for layer in range(cfg.n_layers) for side in (0, 1))
            del ref_kvs
            x = params["embed"][chunk]
            pos = (rank * s_loc + torch.arange(s_loc, dtype=torch.int32, device=device))[None]
            groups = cfg.n_heads // cfg.n_kv_heads
            q = llama._q_proj(params, 0, x, pos, cfg)
            k, v = (t.repeat_interleave(groups, dim=2)
                    for t in llama._kv_proj(params, 0, x, pos, cfg))
            errs["ulysses_vs_ring"] = _check_close(
                torch, "ulysses against ring", ulysses.ulysses_attention(q, k, v),
                ring_attention.ring_attention(q, k, v), ULYSSES_TOL)
            dist.barrier()
        finally:
            dist.destroy_process_group()
            kv.close()
            conn.close()
    kv_bytes = 2 * cfg.n_layers * bps * spec.block_nbytes
    metrics = {
        "world_size": world,
        "backend": backend,
        "tokens": tokens,
        "prefill_ring_s": prefill_s[0],
        "prefill_ring_warm_s": prefill_s[1],
        "save_GBps": kv_bytes / save_s / 1e9,
        "load_GBps": world * kv_bytes / load_s / 1e9,
        "max_abs_err": errs,
    }
    return metrics, launches


def long_context_phase(torch, server_port, params, smi):
    """Phase 14: Llama-3-8B width, bf16, world size 1 over NCCL on the
    card. Returns (launches, metrics)."""
    metrics, launches = _run_long_context(torch, server_port, params)
    metrics = {"card": smi, **metrics}
    log(f"long context: {json.dumps(metrics)}")
    log("long context: one NCCL rank (NCCL refuses two ranks on one card); the multi-rank "
        "ring and Ulysses are held on the CPU at 2, 4 and 8 gloo ranks "
        "(tests/test_torch_ring_attention.py, tests/test_torch_long_context.py)")
    log(f"long context launches: {json.dumps(launches)}")
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 15: the soft mixture of experts, and speculative_verify
# ---------------------------------------------------------------------------


MOE_FAULTS = {
    "experts_reversed": lambda g: g.flip(-1),
    "top1_expert_only": lambda g: (g == g.amax(dim=-1, keepdim=True)).to(g.dtype),
}


def _moe_layer_check(torch, llama, params, cfg, tokens):
    """Layer 0's bf16 ``_moe`` on ``tokens``' rms-normed embeddings against
    the reference's contraction ``einsum("bse,bsef,efd->bsd")`` in plain f32
    over the same weights, read as max abs error over the reference's max
    magnitude; the same reading for each of ``MOE_FAULTS`` planted in the
    f32 gates. Raises unless the sound reading is within ``MOE_LAYER_TOL``
    and every fault's is over it. Returns {"sound": x, fault: x, ...}."""
    silu = torch.nn.functional.silu
    h = llama._rms_norm(params["embed"][tokens], params["l0.ffn_norm"])
    got = llama._moe(params, "l0.", h, cfg).float()
    h32 = h.float()
    router, gate_up_w, down_w = (params[f"l0.{name}"].float()
                                 for name in ("router", "w_gate_up_moe", "w_down_moe"))
    gates = torch.softmax(torch.einsum("bsd,de->bse", h32, router), dim=-1)
    gate_up = torch.einsum("bsd,edcf->bsecf", h32, gate_up_w)
    ffn = silu(gate_up[..., 0, :]) * gate_up[..., 1, :]
    del gate_up, gate_up_w
    want = torch.einsum("bse,bsef,efd->bsd", gates, ffn, down_w)
    scale = float(want.abs().max())
    readings = {"sound": float((got - want).abs().max()) / scale}
    for name, fault in MOE_FAULTS.items():
        wrong = torch.einsum("bse,bsef,efd->bsd", fault(gates), ffn, down_w)
        readings[name] = float((wrong - want).abs().max()) / scale
    if not readings["sound"] <= MOE_LAYER_TOL:
        raise AssertionError(f"the bf16 mixture is {readings['sound']} (relative) from the f32 "
                             f"contraction, over {MOE_LAYER_TOL}")
    blind = [name for name in MOE_FAULTS if readings[name] <= MOE_LAYER_TOL]
    if blind:
        raise AssertionError(f"planted faults {blind} read within {MOE_LAYER_TOL}: {readings}")
    return readings


def _ffn_row_alone(torch, llama, params, cfg, tokens):
    """Layer 0's FFN half on ``tokens``' embeddings: its last row computed
    with the others (a prefill's GEMM shapes) and alone (a decode step's).
    Returns the two's max abs difference, and the largest magnitude of the
    FFN's own output (without the residual)."""
    x = params["embed"][tokens]
    full = llama._ffn(params, 0, x, cfg)[:, -1]
    alone = llama._ffn(params, 0, x[:, -1:], cfg)[:, 0]
    return {"max_abs_diff": max_err(full, alone),
            "ffn_out_max_abs": float((full.float() - x[:, -1].float()).abs().max())}


def _decode_gap(torch, llama, params, cfg, prompt, table, device):
    """``prefill`` of ``prompt`` (K4, K2), ``DECODE_STEPS`` greedy steps
    (K3), and a one-shot prefill of the prompt and the generated tokens.
    Returns (the last step's logits, the one-shot's, prefill s, decode s a
    step)."""
    n = len(prompt)
    max_blocks = table.shape[0]
    spec = cfg.kv_spec(max_blocks)
    _sync(torch, device)
    t0 = time.perf_counter()
    logits, caches = llama.prefill(params, prompt, spec.make_caches(device),
                                   table[:n // cfg.block_tokens], cfg)
    _sync(torch, device)
    prefill_s = time.perf_counter() - t0
    generated = []
    t0 = time.perf_counter()
    for step in range(DECODE_STEPS):
        generated.append(int(logits.argmax()))
        logits, caches = llama.decode_step(params, generated[-1], n + step, caches, table, cfg,
                                           max_blocks)
    _sync(torch, device)
    decode_s = (time.perf_counter() - t0) / DECODE_STEPS
    del caches
    one_shot, _ = llama.prefill(params, prompt + generated, spec.make_caches(device), table,
                                cfg)
    return logits, one_shot, prefill_s, decode_s


def _run_moe_spec(torch, params, device="cuda", geometry=LLAMA3_8B, moe_layers=MOE_LAYERS,
                  prompt_tokens=PROMPT_TOKENS):
    """The MoE leg on seeded mixture weights of ``moe_layers`` layers, then
    ``speculative_verify`` on ``params`` (the dense model; None: seeded, the
    CPU rehearsal) (module docstring, phase 15). Returns (metrics,
    launches)."""
    import numpy as np

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    bt = geometry["block_tokens"]
    nb = prompt_tokens // bt
    max_blocks = -(-(prompt_tokens + DECODE_STEPS) // bt)
    table = torch.arange(max_blocks, dtype=torch.int32, device=device)
    rng = np.random.default_rng(23)
    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **geometry)
    if params is None:
        params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)
    _ext.reset_launches()

    # The mixture: prefill (K4, K2), DECODE_STEPS greedy steps (K3), against
    # a one-shot prefill of the prompt and the generated tokens.
    mcfg = llama.LlamaConfig(dtype=torch.bfloat16, **dict(
        geometry, n_layers=moe_layers, n_experts=MOE_EXPERTS))
    mparams = llama.init_params(mcfg, torch.Generator(device=device).manual_seed(3),
                                device=device)
    prompt = rng.integers(0, mcfg.vocab, prompt_tokens).tolist()
    logits, one_shot, moe_prefill_s, moe_decode_s = _decode_gap(
        torch, llama, mparams, mcfg, prompt, table, device)
    moe_err = _check_close(torch, "MoE decode against its one-shot prefill", logits, one_shot,
                           MOE_TOL)
    launches = dict(_ext.LAUNCHES)  # the path's own launches: the mixture's, then verify's
    layer_errs = _moe_layer_check(torch, llama, mparams, mcfg,
                                  torch.tensor([prompt[:MOE_LAYER_TOKENS]], device=device))
    # Where the gap comes from: the same reading at each depth, for the
    # mixture, for the dense model on the same prompt, and for the mixture
    # with its routers zeroed (uniform gates: no path through the router).
    dcfg = llama.LlamaConfig(dtype=torch.bfloat16, **dict(geometry, n_layers=moe_layers))
    uniform = dict(mparams, **{f"l{layer}.router": torch.zeros_like(mparams[f"l{layer}.router"])
                               for layer in range(moe_layers)})
    gaps = {}
    for name, weights, config in (("moe", mparams, mcfg), ("dense", params, dcfg),
                                  ("moe_uniform_gates", uniform, mcfg)):
        gaps[name] = []
        for depth in range(1, moe_layers + 1):
            last, ref, _, _ = _decode_gap(torch, llama, weights, replace(config, n_layers=depth),
                                          prompt, table, device)
            gaps[name].append({"max_abs_diff": max_err(last, ref),
                               "logits_max_abs": float(ref.float().abs().max())})
    rows = torch.tensor([prompt], device=device)
    row_alone = {"moe": _ffn_row_alone(torch, llama, mparams, mcfg, rows),
                 "dense": _ffn_row_alone(torch, llama, params, dcfg, rows)}
    del mparams, uniform, last, ref
    dense_err = gaps["dense"][-1]["max_abs_diff"]
    if not dense_err <= MOE_TOL:
        raise AssertionError(f"the dense model's {moe_layers} layers: decode {dense_err} from "
                             f"its one-shot prefill, over {MOE_TOL}")
    log(f"moe: {moe_layers} layers x {MOE_EXPERTS} experts, {DECODE_STEPS} decode steps "
        f"after a {prompt_tokens}-token prefill match the one-shot prefill, "
        f"allclose(rtol=atol={MOE_TOL}) (max abs diff {moe_err}); by depth 1-{moe_layers} "
        f"{json.dumps(gaps)}; layer 0's FFN, last row with the prompt and alone "
        f"{json.dumps(row_alone)}; layer 0's bf16 mixture against the f32 contraction "
        f"{layer_errs['sound']} of its range, within {MOE_LAYER_TOL}, planted faults "
        f"{({k: layer_errs[k] for k in MOE_FAULTS})}")

    # speculative_verify on the dense model.
    spec = cfg.kv_spec(max_blocks)
    prompt = rng.integers(0, cfg.vocab, prompt_tokens).tolist()

    def prefilled():
        return llama.prefill(params, prompt, spec.make_caches(device), table[:nb], cfg)[1]

    _ext.reset_launches()
    logits, caches = llama.prefill(params, prompt, spec.make_caches(device), table[:nb], cfg)
    greedy, greedy_logits = [], []
    for step in range(SPEC_DRAFT + 1):
        greedy.append(int(logits.argmax()))
        logits, caches = llama.decode_step(params, greedy[-1], prompt_tokens + step, caches,
                                           table, cfg, max_blocks)
        greedy_logits.append(logits)
    caches = prefilled()
    _sync(torch, device)
    t0 = time.perf_counter()
    n, nxt, _ = llama.speculative_verify(params, greedy[:SPEC_DRAFT], prompt_tokens, caches,
                                         table, cfg, max_blocks)
    verify_s = time.perf_counter() - t0
    if (n, nxt) != (SPEC_DRAFT, greedy[SPEC_DRAFT]):
        raise AssertionError(f"a greedy draft of {SPEC_DRAFT}: accepted {n} with next token "
                             f"{nxt}, expected {SPEC_DRAFT} and {greedy[SPEC_DRAFT]}")
    cut = SPEC_DRAFT - 3
    bad = list(greedy[:SPEC_DRAFT])
    bad[cut] = (bad[cut] + 1) % cfg.vocab
    n, nxt, caches = llama.speculative_verify(params, bad, prompt_tokens, prefilled(), table,
                                              cfg, max_blocks)
    if (n, nxt) != (cut, greedy[cut]):
        raise AssertionError(f"a draft corrupted at {cut}: accepted {n} with next token {nxt}, "
                             f"expected {cut} and {greedy[cut]}")
    on = [nxt]
    for step in range(SPEC_DRAFT - cut):
        logits, caches = llama.decode_step(params, on[-1], prompt_tokens + cut + step, caches,
                                           table, cfg, max_blocks)
        on.append(int(logits.argmax()))
    if on != greedy[cut:SPEC_DRAFT + 1]:
        raise AssertionError(f"decoding on from the accepted point gave {on}, greedy "
                             f"{greedy[cut:SPEC_DRAFT + 1]}")
    rows, _ = llama.prefill_continue(params, greedy[:SPEC_DRAFT], prompt_tokens, prefilled(),
                                     table, cfg, max_blocks)
    _sync(torch, device)
    for name, count in _ext.LAUNCHES.items():
        launches[name] += count
    # The verify rows and the 1-row decode steps run the same ops over the
    # same cache; they are held bitwise.
    steps = torch.stack(greedy_logits[:SPEC_DRAFT])
    if rows.shape != steps.shape or not torch.equal(rows, steps):
        raise AssertionError(f"the verify rows differ from the greedy decode steps' logits "
                             f"(max abs diff {max_err(rows, steps)})")
    log(f"speculative_verify: a greedy draft of {SPEC_DRAFT} accepted whole, a draft "
        f"corrupted at {cut} cut there with greedy's token, decoding on reproduces greedy; "
        "the verify rows bitwise the decode steps' logits")
    metrics = {
        "moe_layers": moe_layers,
        "moe_experts": MOE_EXPERTS,
        "moe_prefill_ms": moe_prefill_s * 1e3,
        "moe_decode_ms_per_step": moe_decode_s * 1e3,
        "moe_max_abs_err": moe_err,
        "decode_gap_by_depth": gaps,
        "ffn_row_alone": row_alone,
        "moe_layer_rel_err": layer_errs,
        "verify_ms": verify_s * 1e3,
    }
    return metrics, launches


def moe_spec_phase(torch, params, smi):
    """Phase 15: Llama-3-8B widths, bf16, on the card. Returns (launches,
    metrics)."""
    metrics, launches = _run_moe_spec(torch, params)
    metrics = {"card": smi, **metrics}
    log(f"moe_spec: {json.dumps(metrics)}")
    log(f"moe_spec launches: {json.dumps(launches)}")
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 16: training, loss_fn / train_step
# ---------------------------------------------------------------------------


def _train_loss(torch, llama, params, tokens, cfg, fault=None):
    """``llama.loss_fn``, or its math with one of ``TRAIN_FAULTS`` planted."""
    if fault is None:
        return llama.loss_fn(params, tokens, cfg)
    b, s = tokens.shape
    positions, mask = llama._causal(b, s, tokens.device)
    if fault == "mask_dropped":
        mask = torch.ones_like(mask)
    x = params["embed"][tokens]
    for layer in range(cfg.n_layers):
        k, v = llama._kv_proj(params, layer, x, positions, cfg)
        x = llama._block(params, layer, x, k, v, positions, mask, cfg)
    if fault == "targets_shifted":
        x, tokens = x[:, :-1], tokens[:, 1:]
    return llama._next_token_nll(params, x, tokens).mean()


def _rel_err(torch, got, want) -> float:
    """||got - want|| / ||want||, in f32."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want))


def _timed_steps(torch, llama, params, tokens, cfg, device):
    """TRAIN_STEPS ``train_step``s on the same batch, each timed from a
    sync to its loss on the host (forward, backward and update). Returns
    (walls in s, losses)."""
    walls, losses = [], []
    for _ in range(TRAIN_STEPS):
        _sync(torch, device)
        t0 = time.perf_counter()
        params, loss = llama.train_step(params, tokens, cfg)
        losses.append(float(loss))
        _sync(torch, device)
        walls.append(time.perf_counter() - t0)
    return walls, losses


def _small_train_check(torch, llama, device):
    """The small f32 model's gradients and ``train_step`` on ``device``
    against the CPU's on the same weights and tokens; returns the largest
    absolute difference (loss, gradients, new parameters)."""
    import numpy as np

    cfg = llama.LlamaConfig(dtype=torch.float32, **SMALL_TRAIN)
    host = llama.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    card = {k: v.to(device=device, copy=True) for k, v in host.items()}
    tokens = np.random.default_rng(37).integers(0, cfg.vocab, (4, 64))
    (loss_h, grads_h), (loss_c, grads_c) = (
        llama._loss_and_grads(p, lambda q: llama.loss_fn(q, tokens, cfg)) for p in (host, card))
    errs = [abs(float(loss_h) - float(loss_c))]
    errs += [max_err(grads_c[k].cpu(), grads_h[k]) for k in grads_h]
    for p in (host, card):
        llama.train_step(p, tokens, cfg)
    errs += [max_err(card[k].cpu(), host[k]) for k in host]
    err = max(errs)
    if not err <= SMALL_TRAIN_TOL:
        raise AssertionError(f"the small model's step on {device} is {err} from the CPU's, "
                             f"over {SMALL_TRAIN_TOL}")
    return err


def _k4_refuses_grad(torch, cfg, device):
    """K4 on inputs that require grad: the CUDA route raises (its output
    would carry no gradient); the CPU route is the plain, differentiable
    version. Returns what happened."""
    from infinistore_tpu_torch.cuda.flash_prefill import flash_prefill_attention

    def qkv(heads):
        return torch.zeros((1, 128, heads, cfg.head_dim), dtype=cfg.dtype, device=device,
                           requires_grad=True)

    q, k, v = qkv(cfg.n_heads), qkv(cfg.n_kv_heads), qkv(cfg.n_kv_heads)
    if torch.device(device).type != "cuda":
        if flash_prefill_attention(q, k, v).grad_fn is None:
            raise AssertionError("K4's CPU route lost the graph")
        return "the CPU route differentiates"
    try:
        flash_prefill_attention(q, k, v)
    except RuntimeError as exc:
        if "requires grad" not in str(exc):
            raise
        return str(exc)
    raise AssertionError("K4 launched on inputs that require grad")


def _run_train(torch, device="cuda", geometry=LLAMA3_8B, layers=TRAIN_LAYERS,
               batch=TRAIN_BATCH, tokens=TRAIN_TOKENS):
    """The train path (module docstring, phase 16). Returns (metrics,
    launches); the launches are read after the steps, and every later check
    must leave them at 0 too."""
    import numpy as np

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cuda = torch.device(device).type == "cuda"
    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **dict(geometry, n_layers=layers))
    cfg32 = replace(cfg, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n_params = sum(p.numel() for p in params.values())
    data = torch.from_numpy(np.random.default_rng(29).integers(0, cfg.vocab, (batch, tokens)))
    data = data.to(device)
    peak = {}

    def peak_of(name, fn):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        if cuda:
            peak[name] = torch.cuda.max_memory_allocated(device)
        return out

    _ext.reset_launches()
    # The f32 reference on the same weights, upcast; then the bf16 sound and
    # planted losses' gradients against it.
    params32 = {k: p.float() for k, p in params.items()}
    loss32, grads32 = peak_of("f32_grads", lambda: llama._loss_and_grads(
        params32, lambda p: llama.loss_fn(p, data, cfg32)))
    readings, losses, by_param = {}, {}, {}
    for fault in (None, *TRAIN_FAULTS):
        name = fault or "sound"
        loss, grads = peak_of(f"bf16_grads_{name}", lambda: llama._loss_and_grads(
            params, lambda p: _train_loss(torch, llama, p, data, cfg, fault)))
        errs = {k: _rel_err(torch, grads[k], grads32[k]) for k in grads32}
        readings[name], losses[name] = max(errs.values()), float(loss)
        if fault is None:
            by_param = errs
        del grads
    del grads32
    if not all(np.isfinite(list(losses.values()))) or not np.isfinite(float(loss32)):
        raise AssertionError(f"losses not finite: {losses}, f32 {float(loss32)}")
    loss_err = abs(losses["sound"] - float(loss32))
    if not loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"the bf16 loss {losses['sound']} is {loss_err} from the f32 "
                             f"{float(loss32)}, over {TRAIN_LOSS_TOL}")
    if not readings["sound"] <= TRAIN_GRAD_TOL:
        worst = max(by_param, key=by_param.get)
        raise AssertionError(f"the bf16 gradients are {readings['sound']} (relative, {worst}) "
                             f"from the f32 ones, over {TRAIN_GRAD_TOL}")
    blind = [f for f in TRAIN_FAULTS if readings[f] <= TRAIN_GRAD_TOL]
    if blind:
        raise AssertionError(f"planted faults {blind} read within {TRAIN_GRAD_TOL}: {readings}")

    # Steps: f32 twice on the same batch (the loss must fall), then bf16.
    walls32, losses32 = peak_of("f32_step", lambda: _timed_steps(torch, llama, params32, data,
                                                                  cfg32, device))
    del params32
    if not losses32[1] < losses32[0]:
        raise AssertionError(f"a second f32 step did not lower the loss: {losses32}")
    walls16, losses16 = peak_of("bf16_step", lambda: _timed_steps(torch, llama, params, data,
                                                                  cfg, device))
    # One more bf16 step under the profiler: the device's busy time by kind.
    profile = _profile(torch, lambda: llama.train_step(params, data, cfg)) if cuda else None
    del params
    _sync(torch, device)
    launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
    small_err = _small_train_check(torch, llama, device)
    refused = _k4_refuses_grad(torch, cfg, device)
    if any(_ext.LAUNCHES.values()):
        raise AssertionError(f"the train path launched kernels: {_ext.LAUNCHES}")
    n_tokens = batch * tokens
    metrics = {
        "layers": layers,
        "batch": batch,
        "tokens": tokens,
        "parameters": n_params,
        "loss_f32": float(loss32),
        "loss_bf16": losses["sound"],
        "loss_abs_err": loss_err,
        "grad_rel_err": readings,
        "grad_rel_err_by_param": by_param,
        "f32_losses": losses32,
        "bf16_losses": losses16,
        "step_s": {"bf16": walls16, "f32": walls32},
        "tokens_per_s": {"bf16": n_tokens / walls16[-1], "f32": n_tokens / walls32[-1]},
        "peak_GiB": {k: v / 2 ** 30 for k, v in peak.items()},
        "bf16_step_profile": profile,
        "small_model_max_abs_err": small_err,
        "k4_with_grad": refused,
    }
    return metrics, launches


def train_phase(torch, smi):
    """Phase 16: Llama-3-8B widths cut to TRAIN_LAYERS layers, on the card.
    Returns (launches, metrics)."""
    metrics, launches = _run_train(torch)
    metrics = {"card": smi, **metrics}
    log(f"train: {json.dumps(metrics)}")
    log(f"train launches: {json.dumps(launches)}")
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 17: the parallel training paths (ring and Ulysses gradients, the
# pipeline, the expert-parallel step)
# ---------------------------------------------------------------------------


def _ep_layout(world):
    """(dp, tp, ep) of the expert-parallel leg at ``world`` ranks."""
    return (1, 2, world // 2) if world > 1 and world % 2 == 0 else (1, 1, world)


def _sp_grads_leg(torch, llama, geometry, device, rank, world, tokens):
    """Ring and Ulysses gradients on this rank's chunk of layer 0's q/k/v
    (GQA heads repeated, f32) against the dense oracle's over the whole
    sequence, of the global mean of squares of the causal output."""
    import numpy as np

    from infinistore_tpu_torch.models import ring_attention, ulysses

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **dict(geometry, n_layers=1))
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    prompt = torch.from_numpy(np.random.default_rng(31).integers(0, cfg.vocab, tokens))
    pos = torch.arange(tokens, dtype=torch.int32, device=device)[None]
    groups = cfg.n_heads // cfg.n_kv_heads
    with torch.no_grad():
        x = params["embed"][prompt.to(device)][None]
        q = llama._q_proj(params, 0, x, pos, cfg).float()
        k, v = (t.repeat_interleave(groups, dim=2).float()
                for t in llama._kv_proj(params, 0, x, pos, cfg))
    del params, x
    count = q.numel()

    def grads(attention, *qkv):
        leaves = [t.detach().clone().requires_grad_() for t in qkv]
        (attention(*leaves).square().sum() / count).backward()
        return [t.grad for t in leaves]

    sl = slice(rank * (tokens // world), (rank + 1) * (tokens // world))
    want = [g[:, sl].clone() for g in grads(ring_attention.dense_attention_reference, q, k, v)]
    chunk = [t[:, sl] for t in (q, k, v)]
    errs, walls = {}, {}
    for name, attention in (("ring", ring_attention.ring_attention),
                            ("ulysses", ulysses.ulysses_attention)):
        _sync(torch, device)
        t0 = time.perf_counter()
        got = grads(attention, *chunk)
        _sync(torch, device)
        walls[name] = time.perf_counter() - t0
        errs[name] = max(_rel_err(torch, g, w) for g, w in zip(got, want))
        if not errs[name] <= SP_GRAD_TOL:
            raise AssertionError(f"rank {rank}: {name} gradients {errs[name]} (relative) from "
                                 f"the dense oracle's, over {SP_GRAD_TOL}")
    return {"tokens": tokens, "grad_rel_err": errs, "fwd_bwd_s": walls}


def _pp_leg(torch, llama, geometry, device, rank, world, batch, tokens):
    """The pipeline at ``world`` stages: its loss and this stage's gradients
    against ``loss_fn``'s, then one timed step; the replicated weights must
    stay equal on every rank."""
    import numpy as np
    import torch.distributed as dist

    from infinistore_tpu_torch.models import pipeline

    cfg = llama.LlamaConfig(dtype=torch.float32, **dict(geometry, n_layers=PP_LAYERS))
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    data = torch.from_numpy(np.random.default_rng(41).integers(0, cfg.vocab, (batch, tokens)))
    data = data.to(device)
    loss_ref, grads_ref = llama._loss_and_grads(params, lambda p: llama.loss_fn(p, data, cfg))
    step, shard = pipeline.make_pp_train_step(None, cfg, world, PP_MICROBATCHES, device=device)
    want = shard(pipeline.stack_stage_params(grads_ref, cfg, world))
    del grads_ref
    local = shard(pipeline.stack_stage_params(params, cfg, world))
    del params
    loss, grads = pipeline.pp_loss_and_grads(local, data, cfg, world, PP_MICROBATCHES)
    loss_err = abs(float(loss) - float(loss_ref))
    grad_err = max(_rel_err(torch, grads[k], want[k]) for k in want)
    del grads, want
    if not (loss_err <= PARALLEL_LOSS_TOL and grad_err <= PP_GRAD_TOL):
        raise AssertionError(f"rank {rank}: the pipeline's loss is {loss_err} from loss_fn's "
                             f"(bound {PARALLEL_LOSS_TOL}), its gradients {grad_err} (relative, "
                             f"bound {PP_GRAD_TOL})")
    _sync(torch, device)
    t0 = time.perf_counter()
    local, step_loss = step(local, data)
    step_loss = float(step_loss)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    for name in pipeline._SHARED:
        first = local[name].clone()
        dist.broadcast(first, src=0)
        if not torch.equal(first, local[name]):
            raise AssertionError(f"rank {rank}: the replicated {name} differs from rank 0's "
                                 "after the step")
    return {"stages": world, "microbatches": PP_MICROBATCHES, "batch": batch, "tokens": tokens,
            "loss": float(loss), "loss_abs_err": loss_err, "grad_rel_err": grad_err,
            "step_s": wall, "step_loss": step_loss}


def _ep_leg(torch, llama, geometry, device, rank, world, tokens):
    """The expert-parallel step at ``_ep_layout(world)``: this rank's
    slices and their gradients against the single-device ``loss_fn``'s,
    the slices' shapes before and after one timed step."""
    import numpy as np

    from infinistore_tpu_torch.models import expert_parallel

    dp, tp, ep = _ep_layout(world)
    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **dict(
        geometry, n_layers=EP_LAYERS, n_experts=MOE_EXPERTS))
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(3), device=device)
    data = torch.from_numpy(np.random.default_rng(43).integers(0, cfg.vocab, (dp, tokens)))
    data = data.to(device)
    loss_ref, grads_ref = llama._loss_and_grads(params, lambda p: llama.loss_fn(p, data, cfg))
    grid = expert_parallel.ep_grid(dp, tp, ep)
    step, shard = expert_parallel.make_ep_train_step(grid, cfg, device=device)
    want = shard(grads_ref)
    del grads_ref
    local = shard(params)
    del params
    e, f, dim = cfg.n_experts // ep, cfg.ffn_dim // tp, cfg.dim
    shapes = {"w_gate_up_moe": (e, dim, 2, f), "w_down_moe": (e, f, dim), "router": (dim, e)}

    def check_slices(when):
        for layer in range(cfg.n_layers):
            for name, shape in shapes.items():
                got = tuple(local[f"l{layer}.{name}"].shape)
                if got != shape:
                    raise AssertionError(f"rank {rank} {when}: l{layer}.{name} is {got}, its "
                                         f"slice {shape}")

    check_slices("before the step")
    mine = data[grid.d:grid.d + 1]
    loss, grads = expert_parallel.ep_loss_and_grads(local, mine, cfg, grid)
    loss_err = abs(float(loss) - float(loss_ref))
    errs = {k: _rel_err(torch, grads[k], want[k]) for k in want}
    grad_err = max(errs.values())
    del grads, want
    if not (loss_err <= EP_LOSS_TOL and grad_err <= EP_GRAD_TOL):
        raise AssertionError(f"rank {rank}: the expert-parallel loss is {loss_err} from "
                             f"loss_fn's (bound {EP_LOSS_TOL}), its gradients {grad_err} "
                             f"(relative, {max(errs, key=errs.get)}; bound {EP_GRAD_TOL})")
    _sync(torch, device)
    t0 = time.perf_counter()
    local, step_loss = step(local, mine)
    step_loss = float(step_loss)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    check_slices("after the step")
    return {"grid": [dp, tp, ep], "coords": [grid.d, grid.i, grid.j], "layers": cfg.n_layers,
            "experts": cfg.n_experts, "tokens": tokens, "loss": float(loss),
            "loss_abs_err": loss_err, "grad_rel_err": grad_err, "step_s": wall,
            "step_loss": step_loss}


def _run_parallel_train(torch, device="cuda", backend="nccl", geometry=LLAMA3_8B, rank=0,
                        world=1, init_file=None, sp_tokens=SP_TOKENS, pp_batch=PP_BATCH,
                        pp_tokens=PP_TOKENS, ep_tokens=EP_TOKENS):
    """One rank of the parallel_train path (module docstring, phase 17) on
    a process group of ``world`` ranks, initialised from ``init_file`` (a
    fresh FileStore when None). Returns (metrics, launches); the launches
    are read after the three legs."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    if backend == "nccl":
        # Loopback for NCCL's bootstrap; a caller's own setting wins. One
        # card a rank: "cuda" is then the rank's card.
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{init_file or tmp + '/filestore'}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            _ext.reset_launches()
            metrics = {"world_size": world, "backend": backend}
            metrics["ring_ulysses"] = _sp_grads_leg(torch, llama, geometry, device, rank, world,
                                                    sp_tokens)
            metrics["pipeline"] = _pp_leg(torch, llama, geometry, device, rank, world, pp_batch,
                                          pp_tokens)
            metrics["expert_parallel"] = _ep_leg(torch, llama, geometry, device, rank, world,
                                                 ep_tokens)
            _sync(torch, device)
            launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
            dist.barrier()
        finally:
            dist.destroy_process_group()
    return metrics, launches


def parallel_train_phase(torch, smi):
    """Phase 17: world size 1 over NCCL on the card. Returns (launches,
    metrics)."""
    metrics, launches = _run_parallel_train(torch)
    metrics = {"card": smi, **metrics}
    log(f"parallel train: {json.dumps(metrics)}")
    log("parallel train: one NCCL rank (NCCL refuses two ranks on one card); world size 4 "
        "runs under --cards 4, and 2, 4 and 8 gloo ranks on the CPU "
        "(tests/test_torch_ring_attention.py, test_torch_pipeline.py, "
        "test_torch_expert_parallel.py)")
    log(f"parallel train launches: {json.dumps(launches)}")
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 18: the tensor-parallel train step and the multi-chip dryrun
# ---------------------------------------------------------------------------


def _tp_shift_flipped(tp, local, tokens, cfg, grid):
    """``tp_loss_fn`` with the loss shift flipped (each position scored
    against the token before it): the planted fault at tp = 1."""
    b, s = tokens.shape
    logits = (tp._hidden(local, tokens, cfg, grid) @ local["lm_head"]).float()
    return tp._vocab_parallel_nll(logits[:, 1:], tokens[:, :-1], grid).sum() / (b * (s - 1))


def _tp_check(torch, llama, geometry, device, rank, grid, layers, batch, tokens):
    """The tp step's loss and this rank's gradient slices, f32, against the
    one-device reference on this card, and the planted fault's reading."""
    import numpy as np

    from infinistore_tpu_torch.models import tensor_parallel as tp

    cfg = llama.LlamaConfig(dtype=torch.float32, **dict(geometry, n_layers=layers))
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    data = torch.from_numpy(np.random.default_rng(47).integers(0, cfg.vocab, (batch, tokens)))
    data = data.to(device)
    loss_ref, grads_ref = llama._loss_and_grads(params, lambda p: llama.loss_fn(p, data, cfg))
    _step, shard = tp.make_tp_train_step(grid, cfg, device=device)
    scale = {k: float(g.abs().max()) for k, g in grads_ref.items()}
    want = shard(grads_ref)
    del grads_ref
    local = shard(params)
    del params

    def worst(grads):
        errs = {k: float((grads[k] - want[k]).abs().max()) / scale[k] for k in want}
        return max(errs.values()), max(errs, key=errs.get)

    loss, grads = tp.tp_loss_and_grads(local, data, cfg, grid)
    loss_err = abs(float(loss) - float(loss_ref))
    grad_err, where = worst(grads)
    del grads
    if grid.tp > 1:
        fault = "norms_unreduced"
        _, planted = llama._loss_and_grads(local, lambda p: tp.tp_loss_fn(p, data, cfg, grid))
        tp._reduce_grads(planted, grid, over_tp=("router",))
    else:
        fault = "shift_flipped"
        _, planted = llama._loss_and_grads(
            local, lambda p: _tp_shift_flipped(tp, p, data, cfg, grid))
    fault_err, fault_where = worst(planted)
    del planted, want, local
    if not (loss_err <= TP_LOSS_TOL and grad_err <= TP_GRAD_TOL):
        raise AssertionError(f"rank {rank}: the tp step's loss is {loss_err} from one device's "
                             f"(bound {TP_LOSS_TOL}), its gradients {grad_err} ({where}; bound "
                             f"{TP_GRAD_TOL} of each reference gradient's largest magnitude)")
    if not fault_err > TP_GRAD_TOL:
        raise AssertionError(f"rank {rank}: the planted fault {fault} reads {fault_err}, within "
                             f"{TP_GRAD_TOL}")
    return {"layers": layers, "batch": batch, "tokens": tokens, "loss": float(loss),
            "loss_ref": float(loss_ref), "loss_abs_err": loss_err, "grad_err": grad_err,
            "grad_err_param": where, "fault": fault, "fault_err": fault_err,
            "fault_err_param": fault_where}


def _tp_timed(torch, llama, geometry, device, grid, layers, batch, tokens):
    """TP_STEPS bf16 steps at ``layers`` layers on this rank's slices, each
    timed from a sync to its loss on the host; the peak device memory over
    them."""
    import numpy as np

    from infinistore_tpu_torch.models import tensor_parallel as tp

    cuda = torch.device(device).type == "cuda"
    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **dict(geometry, n_layers=layers))
    step, shard = tp.make_tp_train_step(grid, cfg, device=device)
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    local = shard(params)
    del params
    data = torch.from_numpy(np.random.default_rng(29).integers(0, cfg.vocab, (batch, tokens)))
    data = data.to(device)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    walls, losses = [], []
    for _ in range(TP_STEPS):
        _sync(torch, device)
        t0 = time.perf_counter()
        local, loss = step(local, data)
        losses.append(float(loss))
        _sync(torch, device)
        walls.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"the bf16 tp step's losses are not finite: {losses}")
    return {"layers": layers, "batch": batch, "tokens": tokens,
            "parameters_on_rank": sum(p.numel() for p in local.values()), "losses": losses,
            "step_s": walls, "tokens_per_s": batch * tokens / walls[-1],
            "peak_GiB": torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None}


def _run_tensor_parallel(torch, device="cuda", backend="nccl", geometry=LLAMA3_8B, rank=0,
                         world=1, init_file=None, check_layers=TP_CHECK_LAYERS,
                         timed_layers=TRAIN_LAYERS, batch=TP_BATCH, tokens=TP_TOKENS):
    """One rank of the tensor_parallel path (module docstring, phase 18) at
    (1, world, 1) on a process group of ``world`` ranks, initialised from
    ``init_file`` (a fresh FileStore when None). Returns (metrics,
    launches); the launches are read after the check and the timed steps."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import expert_parallel, llama

    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{init_file or tmp + '/filestore'}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            _ext.reset_launches()
            grid = expert_parallel.ep_grid(1, world, 1)
            metrics = {"world_size": world, "backend": backend, "grid": [1, world, 1],
                       "coords": [grid.d, grid.i, grid.j]}
            metrics["check"] = _tp_check(torch, llama, geometry, device, rank, grid,
                                         check_layers, batch, tokens)
            metrics["step"] = _tp_timed(torch, llama, geometry, device, grid, timed_layers,
                                        batch, tokens)
            _sync(torch, device)
            launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
            dist.barrier()
        finally:
            dist.destroy_process_group()
    return metrics, launches


def tensor_parallel_phase(torch, smi):
    """Phase 18's tp step: world size 1 over NCCL on the card. Returns
    (launches, metrics)."""
    metrics, launches = _run_tensor_parallel(torch)
    metrics = {"card": smi, **metrics}
    log(f"tensor parallel: {json.dumps(metrics)}")
    log("tensor parallel: one NCCL rank at (1, 1, 1); (1, 4, 1) runs under --cards 4, and 1, "
        "2, 4 and 8 gloo ranks on the CPU (tests/test_torch_tensor_parallel.py)")
    log(f"tensor parallel launches: {json.dumps(launches)}")
    return launches, metrics


def _run_dryrun(torch, n, device="cuda"):
    """``dryrun_multichip(n)`` (its own n rank processes). Returns (metrics,
    launches summed over its legs and ranks); on a card the decode legs must
    have launched K5 and K7 and the handoff K1 and K2."""
    from infinistore_tpu_torch import dryrun

    t0 = time.perf_counter()
    result = dryrun.dryrun_multichip(n, device=device)
    wall = time.perf_counter() - t0
    by_leg = result["launches"]
    if torch.device(device).type == "cuda":
        for leg, names in (("sharded_decode", ("paged_decode_attention_stats",
                                               "paged_decode_attention_ragged_stats")),
                           ("ici_handoff", ("gather_blocks", "scatter_blocks"))):
            idle = [name for name in names if by_leg[leg][name] == 0]
            if idle:
                raise AssertionError(f"the dryrun's {leg} leg never launched {idle}")
    launches = {name: sum(counts[name] for counts in by_leg.values())
                for name in next(iter(by_leg.values()))}
    return {"n": n, "wall_s": wall, "line": result["line"], "legs": result["metrics"],
            "decode_head_dim": dryrun.D, "launches_by_leg": by_leg}, launches


def dryrun_phase(torch, smi):
    """Phase 18's dryrun: ``dryrun_multichip(1)`` on the card. Returns
    (launches, metrics)."""
    metrics, launches = _run_dryrun(torch, 1)
    metrics = {"card": smi, **metrics}
    log(f"dryrun: {json.dumps(metrics)}")
    log(f"dryrun launches: {json.dumps(launches)}")
    return launches, metrics


# ---------------------------------------------------------------------------
# --cards N: the legs across cards
# ---------------------------------------------------------------------------

CARDS_RANK_TIMEOUT_S = 600.0


def _long_context_rank(torch, args) -> int:
    """One rank of ``--cards N``'s long-context leg, in a process of its
    own; prints its metrics and launches as its last line."""
    metrics, launches = _run_long_context(torch, args.port, None, rank=args.long_context_rank,
                                          world=args.cards, init_file=args.init_file)
    print(json.dumps({"rank": args.long_context_rank, "metrics": metrics,
                      "launches": launches}), flush=True)
    return 0


def _parallel_train_rank(torch, args) -> int:
    """One rank of ``--cards N``'s parallel_train leg, in a process of its
    own; prints its metrics and launches as its last line."""
    metrics, launches = _run_parallel_train(torch, rank=args.parallel_train_rank,
                                            world=args.cards, init_file=args.init_file)
    print(json.dumps({"rank": args.parallel_train_rank, "metrics": metrics,
                      "launches": launches}), flush=True)
    return 0


def _tensor_parallel_rank(torch, args) -> int:
    """One rank of ``--cards N``'s tensor_parallel leg, in a process of its
    own; prints its metrics and launches as its last line."""
    metrics, launches = _run_tensor_parallel(torch, rank=args.tensor_parallel_rank,
                                             world=args.cards, init_file=args.init_file)
    print(json.dumps({"rank": args.tensor_parallel_rank, "metrics": metrics,
                      "launches": launches}), flush=True)
    return 0


def _spawn_ranks(flag, cards, tmp, *extra):
    """A leg at world size ``cards`` over NCCL, one process a card, each
    this script with ``flag`` and its rank. Returns each rank's last line;
    raises with a failing rank's output, and stops every rank before it
    returns."""
    init_file = os.path.join(tmp, "filestore")
    procs, outs = [], []
    try:
        for rank in range(cards):
            outs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cards", str(cards),
                 flag, str(rank), *extra, "--init-file", init_file],
                cwd=HERE, stdout=outs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + CARDS_RANK_TIMEOUT_S
        while True:
            codes = [proc.poll() for proc in procs]
            if None not in codes or any(code not in (None, 0) for code in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{flag} ranks still running after {CARDS_RANK_TIMEOUT_S} s")
            time.sleep(0.5)
    finally:
        stopped = [proc.poll() is None for proc in procs]
        for proc, stop in zip(procs, stopped):
            if stop:
                proc.kill()
            proc.wait()
    texts = []
    for out in outs:
        out.seek(0)
        texts.append(out.read())
        out.close()
    # A rank that failed on its own, before the ones stopped here.
    for rank in sorted(range(cards), key=lambda r: stopped[r]):
        if procs[rank].returncode != 0:
            raise AssertionError(f"{flag} rank {rank} exited {procs[rank].returncode}:\n"
                                 f"{texts[rank][-4000:]}")
    return [json.loads(text.strip().splitlines()[-1]) for text in texts]


def cards_main(torch, cards: int, t_start: float) -> int:
    """``--cards N``: the ICI handoff over ``[cuda:0, cuda:1]``, and the
    long-context, parallel training and tensor-parallel paths and the
    dryrun at world size N over NCCL (module docstring)."""
    import tempfile

    if cards < 2 or torch.cuda.device_count() < cards:
        print(f"chip_smoke: --cards {cards} needs 2 or more cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    _build_all(torch)
    from infinistore_tpu_torch import lib

    paths = {}
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        metrics, paths["ici_handoff"] = _run_ici_handoff(torch, server.port, None,
                                                         device="cuda:0", device_b="cuda:1")
    finally:
        server.stop()
    metrics = {"mesh": ["cuda:0", "cuda:1"],
               "peer_access": torch.cuda.can_device_access_peer(0, 1), **metrics}
    log(f"ici handoff across two cards: {json.dumps(metrics)}")
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ranks = _spawn_ranks("--long-context-rank", cards, tmp, "--port", str(server.port))
    finally:
        server.stop()
    for result in ranks:
        log(f"long context rank {result['rank']} of {cards}: {json.dumps(result['metrics'])}")
        idle = [name for name in PATH_KERNELS["long_context"] if result["launches"][name] == 0]
        if idle:
            raise AssertionError(f"long-context rank {result['rank']} never launched {idle}")
    paths["long_context"] = {name: sum(r["launches"][name] for r in ranks)
                             for name in ranks[0]["launches"]}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _spawn_ranks("--parallel-train-rank", cards, tmp)
    for result in ranks:
        log(f"parallel train rank {result['rank']} of {cards}: {json.dumps(result['metrics'])}")
        if any(result["launches"].values()):
            raise AssertionError(f"parallel-train rank {result['rank']} launched kernels: "
                                 f"{result['launches']}")
    paths["parallel_train"] = {name: sum(r["launches"][name] for r in ranks)
                               for name in ranks[0]["launches"]}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _spawn_ranks("--tensor-parallel-rank", cards, tmp)
    for result in ranks:
        log(f"tensor parallel rank {result['rank']} of {cards}: "
            f"{json.dumps(result['metrics'])}")
        if any(result["launches"].values()):
            raise AssertionError(f"tensor-parallel rank {result['rank']} launched kernels: "
                                 f"{result['launches']}")
    paths["tensor_parallel"] = {name: sum(r["launches"][name] for r in ranks)
                                for name in ranks[0]["launches"]}
    metrics, paths["dryrun"] = _run_dryrun(torch, cards)
    log(f"dryrun on {cards} cards: {json.dumps(metrics)}")
    for path in ("ici_handoff", "dryrun"):
        idle = [name for name in PATH_KERNELS[path] if paths[path][name] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on the {path} path: {idle}")
    log(f"total wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"cards": cards, "launches": paths}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


def _args(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--cards", type=int, default=1,
                    help="2 or more: run the legs across cards instead (module docstring)")
    ap.add_argument("--long-context-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-train-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tensor-parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _build_all(torch):
    """Compile the kernels (nvcc) while the native store library builds
    (g++, at its first import), and K5's and K7's source with the split
    merge compiled out (``-DITS_DECODE_NOMERGE``, as ``cuda/decode_probe.py``
    builds it, for the fold's time); all must succeed. Returns the latter
    library."""
    from infinistore_tpu_torch.cuda import _ext, decode_probe

    errors = []

    def build_kernels():
        try:
            _ext.kernels()
        except BaseException as exc:  # re-raised on the main thread below
            errors.append(exc)

    t0 = time.perf_counter()
    nomerge = decode_probe.build("nomerge", decode_probe.DECODE_SOURCES,
                                 defines=(decode_probe.NOMERGE,))
    worker = threading.Thread(target=build_kernels)
    worker.start()
    from infinistore_tpu_torch import lib  # noqa: F401  (builds the native core)

    worker.join()
    if errors:
        raise errors[0]
    nomerge = decode_probe.load(nomerge)
    log(f"built the store library and the kernels in {time.perf_counter() - t0:.1f} s")
    return nomerge


def main() -> int:
    t_start = time.perf_counter()
    args = _args(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "infinistore_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if args.long_context_rank is not None:
        return _long_context_rank(torch, args)
    if args.parallel_train_rank is not None:
        return _parallel_train_rank(torch, args)
    if args.tensor_parallel_rank is not None:
        return _tensor_parallel_rank(torch, args)
    smi_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    smi = smi_lines[0]
    if args.cards != 1:
        print("\n".join(smi_lines), flush=True)
        return cards_main(torch, args.cards, t_start)
    print(smi, flush=True)

    nomerge = _build_all(torch)
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.cuda import _ext

    timer = _timing().Timer(torch)
    kernels = kernel_phase(torch, timer, nomerge)
    del timer
    torch.cuda.empty_cache()

    paths = {}
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        _ext.reset_launches()
        metrics, paths["prefill_store_decode"], params, state = main_path(torch, server.port)
        log(f"main path: {json.dumps(metrics)}")
        log(f"main path launches: {json.dumps(paths['prefill_store_decode'])}")
        torch.cuda.empty_cache()
        small_model_phase(torch, server.port)
    finally:
        server.stop()

    # The int8 round trip takes over engine A's caches, with a store of its own.
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=INT8_STORE_UNIT,
                                    pin_memory=False)
    try:
        int8_metrics, paths["int8_round_trip"] = int8_round_trip(torch, server.port, state,
                                                                 metrics)
        log(f"int8 round trip: {json.dumps(int8_metrics)}")
        log(f"int8 round trip launches: {json.dumps(paths['int8_round_trip'])}")
    finally:
        server.stop()
    del state

    # The round trip at Phi-3-mini's widths (head_dim 96), and at Phi-2's and
    # Gemma-2B's attention widths (80, 256) cut to 2 layers, each on a store
    # of its own.
    paths.update(round_trips_phase(torch, smi, metrics))

    # Each engine phase gets a fresh store; the main path's caches are gone,
    # its weights are reused.
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["engine"], engine_summary = engine_phase(torch, server.port, params, smi)
    finally:
        server.stop()
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["int8_engine"] = int8_engine_phase(torch, server.port, params, smi,
                                                 engine_summary)
        torch.cuda.empty_cache()
        small_engine_phase(torch, server.port)
    finally:
        server.stop()
    paths["sharded_decode"] = sharded_decode_phase(torch)
    log(f"sharded decode launches: {json.dumps(paths['sharded_decode'])}")

    # The handoff reuses the main path's weights, on a store of its own.
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["disagg"], _ = disagg_phase(torch, server.port, params, smi)
    finally:
        server.stop()
    paths["disagg_demo"], _ = disagg_demo_phase(torch, smi)
    # The multi-server pool reuses them too, over servers of its own.
    torch.cuda.empty_cache()
    paths["cluster"], _ = cluster_phase(torch, params, smi)
    # So does the vLLM v1 connector, on a store of its own.
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["vllm_v1"], _ = vllm_v1_phase(torch, server.port, params, smi)
    finally:
        server.stop()
    # The multi-device serving paths reuse them too, each store its own.
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["ici_handoff"], _ = ici_handoff_phase(torch, server.port, params, smi)
    finally:
        server.stop()
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["long_context"], _ = long_context_phase(torch, server.port, params, smi)
    finally:
        server.stop()
    torch.cuda.empty_cache()
    paths["moe_spec"], _ = moe_spec_phase(torch, params, smi)
    del params
    torch.cuda.empty_cache()
    paths["serving_cli"], _ = serving_cli_phase(torch, smi)
    # The training paths make their own weights.
    torch.cuda.empty_cache()
    paths["train"], _ = train_phase(torch, smi)
    torch.cuda.empty_cache()
    paths["parallel_train"], _ = parallel_train_phase(torch, smi)
    torch.cuda.empty_cache()
    paths["tensor_parallel"], _ = tensor_parallel_phase(torch, smi)
    torch.cuda.empty_cache()
    paths["dryrun"], _ = dryrun_phase(torch, smi)

    for path, names in PATH_KERNELS.items():
        idle = [name for name in names if paths[path][name] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on the {path} path: {idle}")
        if not names and any(paths[path].values()):
            raise AssertionError(f"the {path} path launched kernels: {paths[path]}")
    # These paths are bf16 end to end: every K4 launch must be a tensor-core one.
    for path in BF16_K4_PATHS:
        k4, wgmma = paths[path]["flash_prefill"], paths[path]["flash_prefill_wgmma"]
        if wgmma == 0 or wgmma != k4:
            raise AssertionError(f"{path}: {k4} K4 launches but {wgmma} on the tensor cores")
    for path in BULK_COPY_PATHS:
        for name in ("gather_blocks", "scatter_blocks"):
            every, bulk = paths[path][name], paths[path][f"{name}_bulk"]
            if bulk != every:
                raise AssertionError(f"{path}: {every} {name} launches but {bulk} on the bulk ring")

    rows = []
    for name, (replaces, *sources) in TPU_KERNELS.items():
        row = {
            "name": name,
            "route": "cuda",
            "source": f"infinistore_tpu_torch/cuda/csrc/{sources[0]}",
            "replaces": replaces,
            # Every launch on the paths this script drives; per path below.
            "launches": sum(counts[name] for counts in paths.values()),
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "design": DESIGNS[name],
            **kernels[name],
        }
        if len(sources) > 1:
            row["sources"] = [f"infinistore_tpu_torch/cuda/csrc/{src}" for src in sources]
        if name == "flash_prefill":
            row["tensor_core_launches"] = sum(c["flash_prefill_wgmma"] for c in paths.values())
        if name in ("gather_blocks", "scatter_blocks"):
            row["bulk_launches"] = sum(c[f"{name}_bulk"] for c in paths.values())
        rows.append(row)
    log(f"total wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
