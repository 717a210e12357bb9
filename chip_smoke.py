#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: every CUDA source under paddle_tpu_torch/csrc/, one nvcc a
   part of a source (``paged_attention.cu`` 7, ``flash_attention.cu`` 3,
   the others 1: ``ops/_build.py`` ``PARTS``), all started together,
   then one link a source, into build/paddle_tpu_torch/.
3. Kernels against their plain PyTorch versions on the card, with
   timings, the card's bound and, where one PyTorch call computes the
   same function, its time:
   a. paged attention at the serving path's shapes (Llama-0.76B
      attention: 16 heads of 128, pages of 16, rows up to 2048 tokens),
      the serving path's f32 q over bf16 pages first, through each path
      of the kernel (``paged_cases``): decode rows split across blocks
      and merged, one 2048-token row, lengths at a page's and a
      partition's edge, a chunk's rows tiled, tiles across slot
      boundaries, padding rows on the null table, GQA and int8 pages;
      the decode and chunk cases timed beside their bounds; in every
      case one slot's live key poisoned, NaN in K, then in V (int8: in
      the k, then the v scale row): that slot's rows non-finite on the
      heads that read it, every other (row, head) ``torch.equal`` to the
      clean call (K4 carries a NaN as the JAX kernel does, to the row
      that reads it and no other);
   b. flash attention forward (K1), dQ (K2) and dK/dV (K3) at GPT-3
      1.3B's training shape (B 8, H 16, S 1024, D 128, causal; q/k/v
      strided views of one QKV projection) in bf16 (all three on tensor
      cores) and f32, and at Sq != Sk, S = 1000, key padding with an
      empty batch row (f32 and bf16), dropout, D 32 (f32 and bf16) and D
      64, and at BERT-base's shape (B 32, S 128, 12 heads of 64, bf16,
      non-causal, dropout 0.1; timed, and again with random key lengths
      and an empty batch row); each output held elementwise and by its
      norm (``FLASH_TOL``),
      and at gpt13 bf16 the same check must reject the plain versions run
      at a scale 1% off; a bf16 input whose sequence stride is off 16
      bytes must be refused with ValueError before any launch; the
      dropout seed is data the kernels read from device memory: K1-K3
      with dropout captured in one CUDA graph, two seeds written into
      their seed tensor after the capture, must replay to the eager
      calls' outputs with those seeds bit for bit (``flash_seed_replay``);
      SDPA's forward and backward time the library, and each timed
      kernel's factor against it is printed beside its share of the
      bound;
   c. fused AdamW (K5) at N = 10,000 (step 5), 2,000,000 (step 10), an
      odd N off 16-byte alignment (step 1, zero moments) and 354,942,976
      (step 10, timed): w', m', v' held elementwise (``ADAMW_TOL``) and
      the update w - w' at rtol 1e-5; the same check must reject the
      plain version run with Paddle AdamW's epsilon (eps / sqrt(bc2));
      PyTorch's fused AdamW times the library.
4. Serve: Llama-0.76B (vocab 32000, hidden 2048, 12 layers, 16 heads,
   intermediate 5632) with seeded random weights cast by
   ``amp.decorate(level="O2")``'s rule (bf16, the norms f32, so the
   activations f32 from the first layer on, as the JAX package serves
   it), bf16 KV pages, 8 requests of 64-1024 prompt tokens and 64 new
   tokens through ServingEngine, twice: with the step captured as a CUDA
   graph per token-grid bucket and replayed (the default), then eagerly.
   The streams must be equal, ``compile_counts()`` step == step_buckets,
   and K4's counts, zeroed just before each run and read just after,
   must show it in every layer of every step (eager: one launch a layer
   a step; graphed: one replayed launch a layer a step, plus one
   warm-up launch and one captured call a layer per bucket), the plain
   version never. Each run prints its decode-step p50, tokens/s, TTFT
   p50, capture seconds per bucket and peak memory. A third run, on the
   graphed engine with its prefix cache cleared, switches the metrics
   registry (``get_registry().disable()``) and the request tracer off
   for every other step: its streams must equal the first run's, and it
   prints the decode-step p50 with the instruments on and off.
5. Serve checks: one mixed step (3 decode rows + a 256-token chunk) run
   with the kernel and with the plain version on the same inputs, on the
   served model (held per layer) and on the same model in f32 (held per
   layer and at the logits). Serve features: Llama-0.76B on int8 pages
   with the prefix cache and ``spec_k=4``, 8 requests sharing a
   512-token prefix (suffixes of 64-512 tokens, two ending in a repeated
   n-gram; the first served alone until its prompt is cached), graphed
   and eagerly: equal streams, K4's counts as above, prefix hits and
   accepted drafts > 0, the pool's bytes beside bf16 pages'; then one
   step of three slots on the cached prefix pages with four drafts each,
   K4 held per layer against its plain version and, at the first layer,
   replayed from a CUDA graph and held the same way; a fork of one slot
   copies its last page (codes and scale rows) on the card; then every
   page must come back once the cache is cleared. Serve tenancy
   (``tools/serve_tenancy.py``'s traffic): Llama-0.76B on bf16 pages with
   the prefix cache, ``spec_k=4``, three rank-4 LoRA adapters (capacity
   4), a JSON-schema grammar over ``ToyTokenizer(32000, eos)`` and the
   host page tier, the pool holding the worst case of 5 of the 8 slots'
   streams (181 pages); 6 requests at priority 2, then 6 at priority 0
   four steps later (4 base, 5 on adapters, 3 constrained, one of them on
   an adapter; two at t = 0.8; one base request sharing an adapter
   request's first 256 tokens), adapter ``a2`` re-registered with new
   weights at step 10; graphed and eagerly: equal streams, one capture
   per bucket and the same graphs replayed after the swap, ``a2``'s
   streams unlike a run without the swap, every constrained stream
   valid, parks and auto-unparks with no late prefetch, K4's counts as
   above; the LoRA products timed from a graph replay at 8 and 64 rows;
   one mixed step with three adapters registered and every row on slot
   0 equal (``torch.equal``) to the same step over an empty store; an
   explicit park/unpark of a live stream giving back every layer's k/v
   bytes through its new block table (twice, timed per page); the pool
   empty once the cache is cleared; prints decode p50, park and unpark
   ms per page, cross-adapter prefix hits, drafts cut by the grammar,
   peak memory. Serve resilience (``tools/serve_chaos.py``): the six
   engine drills of the JAX package's chaos tool on Llama-0.76B,
   graphed, bf16 pages of 16, 8 slots, prefix cache on: a NaN quarantine
   (``poison_seq`` armed at ``serving.decode_step``; the mates' streams
   equal a fault-free run's, the scrubbed pages read zero, the page
   tensors keep their addresses, the graphs captured before the poison
   are replayed after it, the victim's prefix nodes miss and a mate's
   hit) on bf16 pages, on int8 pages and with an adapter and a grammar
   row; a prefill NaN (a 2-layer model of the same width, every
   parameter NaN in place); a ``serving.kv_alloc`` exhaustion
   mid-decode; a transient ``serving.compile_step`` raise; deadlines and
   cancel (queued, decoding, reentrant from a four-argument callback);
   backpressure and the watchdog. Prints a line a drill and the
   registry's counts (TTFT and ITL observations, ``serving_step``
   compiles = buckets, the reason counters); K4's counts as in the serve
   phase, summed over the drills' engines. Serve GPT: GPT-3 1.3B (vocab
   50304, hidden 2048, 24 layers, 16 heads of 128, intermediate 8192,
   ``max_position_embeddings`` 2048) with seeded random weights cast by
   O2's rule (bf16, the LayerNorms f32; the paged step bf16 throughout,
   as the JAX package's), bf16 pages of 16, 8 slots, budget 1024, 8
   requests of 64-1024 prompt tokens and 64 new tokens (two at t = 0.8),
   graphed and eagerly: equal streams, one capture a bucket, K4 in every
   layer of every step and its plain version never; decode p50, tokens/s,
   TTFT p50, capture seconds per bucket and peak memory printed. Serve
   fleet (``tools/serve_fleet.py``): the JAX chaos tool's scenarios 7-20
   on routers of Llama-0.76B engines at full width, graphed, bf16
   pages of 16 (int8 for scenario 18): failover with requeue-once,
   a rolling ``Router.reload`` of a donor checkpoint (another seed,
   committed by ``CheckpointManager``) into two replicas across live
   requests (every request completes, ``compile_counts()`` unchanged,
   each engine's greedy stream after the push equal to a lone engine's
   on the donor; the reload's seconds per engine printed),
   least-loaded dispatch, kills mid-decode, through a cached prefix,
   between prompt chunks, mid speculative burst, mid constrained adapter
   stream, with the flight recorder and with a parked stream, the
   control-plane thread fuzz under the lock sanitizer (two rolling
   reloads among its racers), the autoscaler, the brownout ladder, and
   the WAL-armed child process SIGKILLed mid-decode and recovered on one engine fewer; plus
   ``CompletionAPI`` routing by model between a three-engine Llama fleet
   and the GPT engine. Every drill must pass; each prints its seconds,
   migrations, captures and ``nvcc`` runs (0 after the build: a new
   engine and the restarted process capture only their own buckets and
   build nothing); the phase prints the WAL's fsyncs and ms per step,
   recovery seconds and peak memory. K4's counts, zeroed just before and
   read just after here and in the restart drill's children: launched,
   replayed, the plain version never. Reference: a small f32 Llama and a
   small f32 GPT served on the card (graphed, prefix cache,
   ``spec_k=2``) and on the CPU (plain path, both off) give the same
   token streams, one request on a LoRA adapter and one under a grammar
   among them.
6. Train: GPT-3 1.3B (vocab 50304, hidden 2048, 24 layers, 16 heads)
   through ``paddle_tpu_torch.bench`` as it runs by default (the step
   through ``jit.StaticFunction``: B 8, S 1024, O2 bf16 without master
   weights, fused cross entropy, AdamW), 8 steps (1 + 2 warm + 5 timed),
   every loss finite. The flash counts are zeroed just before and read
   just after: each of K1, K2 and K3 24 launches in the eager first
   step, 24 calls recorded by the capture and 24 replayed launches in
   each of the 7 replayed steps (captured + replayed = 24 x 8), the
   plain versions never.
7. Train check: a small f32 GPT (2 layers, hidden 256, 2 heads of 128,
   S 512) takes three AdamW steps on the card (kernels) and on the CPU
   (plain versions): the losses and the parameters agree.
8. K5's path: ``paddle_tpu_torch.tools.bench_adamw`` (K5 against
   PyTorch's fused AdamW at 2,000,000 elements, then both timed at
   354,942,976). K5's counts are zeroed just before and read just after:
   it launched, its plain version never.
9. Train Llama-0.76B (vocab 32000, hidden 2048, 12 layers, 16 heads)
   through ``paddle_tpu_torch.bench --model llama`` (B 8, S 1024, full
   recompute, O2 bf16 with master weights, fused cross entropy, AdamW),
   graphed as in 6, 8 steps, every loss finite. K1 24 a step (forward
   and recomputation), K2 and K3 12 each, counted as in 6; the plain
   versions never.
10. Train check: a small f32 Llama with GQA (2 layers, hidden 256, 4
   heads of 64 over 2 KV heads, S 512, recompute on) takes three AdamW
   steps on the card and on the CPU: the losses and parameters agree.
11. Facade (the Paddle eager core, ``import paddle_tpu_torch as
   paddle``): (a) every ``tests/op_registry.py`` case
   (``paddle_tpu_torch/tools/op_cases.py``, 233 specs over their dtypes,
   and the 119 grad specs' grads) on ``cuda`` against the CPU from the
   same numpy inputs, at the case's tolerance with equal dtypes; (b)
   GPT-3 1.3B's attention written in facade ops (B 8, S 1024, 16 heads
   of 128, bf16: ``paddle.matmul`` of an activation by a ``Parameter``,
   ``reshape``, ``split``, ``F.scaled_dot_product_attention(is_causal=
   True)``, ``paddle.mean``, ``loss.backward()``): K1, K2, K3 once each,
   plain versions never, the output and the grads of q, k, v held
   against the plain versions at ``FLASH_TOL``; ``paddle.grad(
   create_graph=True)`` on the card against the analytic second
   derivative; the facade's host cost per op (10,000 small
   ``paddle.add``/``paddle.matmul`` against the bare torch calls); (c)
   the root ``bench.py``'s gpt13 step verbatim through the facade
   (``bench.facade_step``), 8 steps: 24 launches a step of each flash
   kernel, plain versions never, every loss finite and compared with
   phase 6's, then one more torch step and facade step in turns.

12. Train graphed (``phase_train_graphed``): GPT-3 1.3B, then
   Llama-0.76B, at full width and depth, 8 steps eagerly (``--eager``)
   and then, rebuilt from the same seed, 8 steps through
   ``StaticFunction``: losses and final parameters equal bit for bit, one
   signature and one capture (``paddle_tpu_jit_compiles_total`` + 1), the
   graphed run's flash counts as in 6; one more graphed and eager run in
   turns; prints step ms graphed against eager, ``capture_s`` and both
   peak memories.
13. Train graphed state (``phase_train_graphed_state``): a small GPT
   (hidden 256, 4 layers, 2 heads of 128, S 256) with attention and
   hidden dropout 0.1, O2 bf16 with master weights, a ``GradScaler``
   (2^15, grows every 2 good steps, halves on each bad one),
   ``ClipGradByGlobalNorm(1.0)`` and a ``LinearWarmup`` scheduler
   stepped each call, the loss multiplied by inf on step 3: six steps
   eagerly and six through ``StaticFunction`` equal bit for bit (losses,
   a dropout mask returned by the step, every parameter after every
   step, the scale and both counters); step 3 skipped inside the graph
   and the scale halved; masks differing from step to step; one
   capture.
14. Train BERT (``phase_train_bert``): BERT-base pretraining (vocab
   30522, hidden 768, 12 layers, 12 heads of 64, intermediate 3072, a
   Paddle ``Layer`` model) through ``bench --model bert`` (B 32, S 128,
   MLM on 15% of the positions plus NSP, dropout 0.1, O2 bf16 with master
   weights, AdamW): the bench's graphed step as in 6 (K1, K2, K3 12 a
   step each); 8 steps graphed against 8 eager as in 12; then three
   calls of one step with an ``attention_mask`` padding 8 of the 32 rows
   (K1-K3 through key padding; finite losses, one capture, 12 launches
   each a step). Prints tokens/s, step ms graphed and eager, MFU, peak
   memory and ``capture_s``.
15. nn vision ops (``phase_nn_vision_ops``): every conv and pooling case
   of the CPU twins (``paddle_tpu_torch/tools/vision_cases.py``: every
   padding form, ``"SAME"`` at stride 2, transposes with
   ``output_padding``/``output_size``, ``ceil_mode`` windows starting in
   the padding, ties under a max pool, ``return_mask`` and
   ``max_unpool``, adaptive sizes that do not divide) on ``cuda`` in f32
   without TF32 against the CPU, outputs and input grads at
   ``VISION_TOL``; a 2-layer bidirectional LSTM and GRU (B 16, T 32,
   hidden 128) forward and backward through ``StaticFunction`` equal to
   eager bit for bit and to the CPU at ``VISION_TOL``. Prints one JSON
   line.
16. Train ResNet-50 (``phase_train_resnet50``): ``bench --model
   resnet50`` (B 64, 224 x 224, 1000 classes, ``Momentum(0.1, 0.9)``,
   O2 bf16 with master weights) at full width and depth, 8 steps eagerly,
   eagerly again and graphed (one capture): losses, every parameter and
   every BatchNorm's running statistics equal bit for bit (under
   ``cudnn.deterministic`` if cuDNN's default algorithms make two eager
   runs differ; the JSON line says which, with both settings' step ms);
   no K1-K5 launch on the path. Prints one JSON line: step ms graphed and
   eager, images/s, MFU over FlopCounterMode's FLOPs, peak memory,
   ``capture_s``.
17. Generate (``phase_generate``, ``tools/bench_generate.py``): dense
   KV-cache ``model.generate`` at full width, Llama-0.76B (vocab 32000,
   hidden 2048, 12 layers, 16 heads, 16 KV heads) and GPT-355M (vocab
   50304, hidden 1024, 24 layers, 16 heads), f32, seeded weights, B 8,
   prompt 128, 128 new tokens, greedy, the device loop (one captured
   step replayed per token, no host read a token): the first call's
   seconds, the best of 3, tokens/s, ms a token, ``capture_s`` and
   ``compile_counts`` a program, peak memory; no K1-K5 launch (the
   cached attention is the plain masked softmax, as in the JAX package).
   The device loop equal to the host loop token for token; the cached
   trunk's logits (prefill, then 4 decode steps at a device ``cur_len``)
   against one full forward within ``GEN_TOL`` of their scale (f32, TF32
   off); a sampled call (t 0.8, top_k 40) twice with one seed equal,
   another seed different; eos at B 1 stopping early with
   ``stop_reason == "eos"`` in both loops, at B 8 freezing one row; the
   caches and the loop's state on the card.
18. Train under recompute (``phase_train_recompute``): gpt13 graphed
   (``bench --model gpt13 [--recompute --recompute-policy P]``), no
   recompute and ``full``, ``dots``, ``dots_no_batch``, 4 steps each:
   step ms, peak memory, K1-K3 counted as in 6 (K1 2 a layer a step under
   each policy), losses against no recompute's and ``full``'s.
19. Flags (``phase_flags``): BERT's graphed step (4 steps) with
   ``FLAGS_use_pallas_flash_attention`` on (K1-K3 48 each) and off (0,
   and no plain flash call), losses within ``FLAG_LOSS_TOL``;
   ``FLAGS_check_nan_inf`` raising on an eager inf on ``cuda`` and a
   ``StaticFunction`` step under it captured and replayed.
20. Extended ops (``phase_nn_extended_ops``): every case of
   ``paddle_tpu_torch/tools/extended_cases.py`` (the extended
   functionals and ``paddle.linalg``) on ``cuda`` against the CPU,
   outputs and input grads at ``EXT_TOL``.
21. Train chaos (``phase_train_chaos``, ``tools/train_chaos.py --model
   bert_base``): BERT-base (at its width, ``CHAOS_LAYERS`` of its 12
   layers; B 32, S 128, O2 bf16 with master weights, dropout 0.1, AdamW)
   (a) fine-tuned through
   ``hapi.Model.fit(epochs=2, checkpoint_dir=, sentinel=TrainSentinel())``
   over a shuffled ``io.DataLoader``, in a child SIGKILLed mid-epoch 1
   after epoch 0 committed and then resumed: parameters, moments, epoch
   1's losses and the accuracy equal an uninterrupted child's bit for
   bit; (b) pretrained through ``TrainSentinel.guard`` with marks
   committed by a ``CheckpointManager``: a NaN step (``train.grads``)
   skipped, a NaN region rolled back to the committed mark and skipped
   past, parameters and moments equal a clean run's bit for bit, no
   capture; the checkpoint's bytes, sync and async save seconds and
   GB/s, restore and verify seconds, the eager step with and without an
   async save draining and the guarded step printed; (c) a child
   preempted by SIGTERM (``save_on_signal``) and a fresh child resumed
   through ``restore_or_init``: after 10 steps the losses (dropout on),
   parameters and moments equal an uninterrupted child's bit for bit.
   K1-K3 launch on every path and in every child, the plain versions
   never; no ``nvcc`` run.
22. Distributed (``phase_distributed``), each model at its width and a
   cut depth: gpt13 ``DP13_LAYERS`` of 24, GPT-355M
   ``dist_drills.DRILL_LAYERS`` of 24, Llama-0.76B's ``sep`` drill
   ``SEP_LAYERS`` of 12. (a) gpt13's bench step under ``DataParallel`` at world size 1 on NCCL (``init_parallel_env`` in
   this process through ``fleet.init``, ``fleet.distributed_model`` and
   ``distributed_optimizer``), 3 eager steps then 5 ``StaticFunction``
   calls (the reduction captured in the graph), against the plain step
   from the same state and batch: every loss and every parameter equal
   bit for bit after the eager and after the graphed steps; step ms of
   both, the buckets, the all_reduces and bytes a step. (b) Two ranks on
   the card over gloo (``tools/dist_drills.py``): every collective of
   ``tools/dist_cases.py`` on CUDA tensors against the value worked out
   from both ranks' inputs; GPT-355M data-parallel (its 4 rows a rank
   through ``DistributedBatchSampler`` and process workers, 2 steps,
   ranks equal bit for bit, each step's reduced gradients leaf by leaf
   within their tolerance of the single full-batch model's, and the
   unreduced gradient, a control, outside it) and tensor-parallel (mp 2,
   8 heads a rank, weights carried from the dense model; logits, loss
   and the gathered gradients within theirs, and the gradients of a
   backward without ``c_identity``'s all-reduce, a control, outside
   it); K1-K3 and the embedding backward in each rank, no child left.
   (c) The deterministic embedding backward (``csrc/embedding_grad.cu``):
   the kernel equal to its plain version bit for bit at gpt13's shape
   with Zipf ids (s 1.1), timed against its bound and ``tF.embedding``'s
   backward; 8 backwards from one state of BERT-base's and gpt13's word
   embeddings (Zipf ids) and of one f32 row under all 4,096 lookups of
   a batch all equal with ``FLAGS_cudnn_deterministic`` on, how many
   differ with it off, and an atomic sum of the one-row case, a control
   that must differ. (d) gpt13 under ZeRO (``group_sharded_parallel``)
   at ``os``, ``os_g`` and ``p_g_os`` at world size 1 on NCCL, in (a)'s
   process group, against (a)'s plain step bit for bit (``os`` and
   ``os_g`` eager then graphed, ``p_g_os`` eager throughout: its gathers
   re-allocate the parameters' storage). (e) Two ranks over gloo
   (``tools/zero_pp_drills.py``): GPT-355M at each ZeRO level equal to
   ``DataParallel`` bit for bit, a rank's state at most 0.55 of it (and
   ``p_g_os``'s parameters), the control (no all-gather after the
   update) differing; the ``os_g`` ranks' checkpoint through
   ``CheckpointManager`` restored whole and into ``p_g_os`` bit for bit,
   one more step equal to ``DataParallel``'s, a copy missing a shard
   file refused; each level's bytes after the backward and peak beside
   ``DataParallel``'s, ``os_g`` holding fewer than ``os`` after the
   backward; GPT-355M at pp 2 (4 microbatches from the strategy's
   ``accumulate_steps``), through the model's own forward and backward
   (``fleet.distributed_model``, GPipe) and through
   ``pipeline_1f1b_train``, gradients within their tolerance of one
   model's, each beside a control outside it (one backward send lost;
   the loss not divided by the microbatch count), and VPP 2's logits.
   (f) gpt13's whole train state (at its width, ``STATE_LAYERS`` of its
   24 layers since PR 21) saved and restored through
   ``CheckpointManager``, timed, bit for bit (GPT-355M's when the disk
   or host memory is under twice the state). (g) Sequence and expert
   parallelism (``tools/sep_moe_drills.py``): ring attention's block
   loop at P 4 at Llama-0.76B's attention shape (S 8192, bf16, causal
   and not) against K1-K3 over the whole sequence and their plain
   versions, the unweighted merge a control outside the limit, timed
   beside the one-call kernels; two gloo ranks of Llama-0.76B at ``sep``
   2 through ``fleet.distributed_model`` (B 1, S 8192), its loss and
   every leaf's gradient against one model's full-sequence ones, each
   rank's K1-K3 launches, the step's seconds and the bytes sent around
   the ring, beside two controls (no block from the other rank, RoPE at
   local positions); two gloo ranks of ``MoELayer`` at GPT-355M's width
   (8 experts, 4 a rank, 8 x 1024 tokens), naive and gshard top-2, its
   output, loss and gradients against the local path and the MoE clip's
   factor against the local clip's, beside two controls (no ``1 / ep``
   on the expert gradients, gshard's capacity counted per rank), timed
   beside the local path. Prints each part's seconds.
23. Distributed (g) (``phase_distributed_g``, ``tools/ps_engine_drills.py``):
   (a) gpt13 (``ENGINE_LAYERS`` of its 24 layers, O2 bf16, AdamW, B 8,
   S 1024, the cross entropy over its logits as ``Engine``'s loss) through ``auto_parallel.Engine`` at world
   size 1 on NCCL: ``fit`` 4 steps (graphed after the first), every loss
   and parameter bit for bit with the same step by hand under
   ``jit.to_static``; ``evaluate``, ``predict``, ``save``/``load`` of the
   model; ``cost()["flops"]`` within 2% of 6 x parameters x tokens plus
   K1-K3's attention flops; step ms graphed and eager; (b) two gloo ranks
   of GPT-355M through ``Engine`` at ``dp`` 2 with SGD: every leaf's
   update against one model's full-batch step, beside the reducer-off
   control; ``fused_allreduce_gradients`` bit for bit with
   ``DataParallel``'s reduction; ``broadcast_dp_parameters`` left out on
   ranks seeded apart, which must then differ; (d) ``rpc`` between those
   two processes: GPT-355M's logits computed on worker 1, called by
   ``rpc_sync`` and ``rpc_async``, bit for bit with worker 0's own call;
   (c) a Wide&Deep CTR trainer (Criteo's shapes as PaddleRec sets them)
   under ``distributed.launch --run_mode ps --server_num 2
   --trainer_num 1``: one sync step equal to a dense-embedding twin's
   beside a control without the push, 200 steps timed (steps/s, pull and
   push ms, table rows), then two async trainers whose loss falls and
   whose communicator merged rows. Then bucket independence
   (``bucket_independence``): Llama-0.76B (at its width,
   ``BUCKET_LAYERS`` of its 12 layers since PR 21) served graphed at token
   budgets 16, 64 and 1024 on 4 seeds of the serve workload, the streams
   that differ from budget 1024's counted, with the first differing
   position and the gap between the two tokens' logits there.
24. Zoo (h) (``phase_zoo_h``, ``tools/zoo_drills.py``): (a) ``bench
   --model gpt``'s step, GPT-355M (vocab 50304, hidden 1024, 24 layers,
   16 heads), B 8, S 1024, O2 bf16 with master weights, AdamW: three
   ``StaticFunction`` calls (eager, capture, replay) against three eager
   steps from the same seed, every loss and parameter bit for bit, then
   10 replays timed (tokens/s, step ms), K1-K3 24 launches a step and the
   embedding kernel counted; (b) the classification zoo at full width
   (every ``TestModelZoo`` constructor outside ResNet, ``alexnet``,
   ``vgg16``, ``googlenet``, ``inception_v3``, ``mobilenet_v3_large``,
   ``shufflenet_v2_x1_0``; B 8, 224 x 224, InceptionV3 299, 1000
   classes), each eval forward in f32 (TF32 off) against the same model
   on the CPU within ``ZOO_TOL`` by norm, a model with one weight doubled
   outside it; one O2 bf16 AdamW step graphed against eager bit for bit
   for ``mobilenet_v3_large``, ``densenet121`` and ``inception_v3``; (c)
   PP-YOLOE-s on ``bench --model yoloe``'s stream (sides [320, 416,
   512], B 8, up to 16 boxes, 8 batches) through ``BucketedFunction``:
   the 16 warm-up steps (each bucket's eager call, then its capture)
   against the same padded steps eagerly from the same seed, every loss
   and the final state bit for bit, ``recompiles`` at most the stream's
   bucket keys, then 3 timed passes (images/s, capture seconds, peak
   bytes); ``predict``'s ``nms`` on one 512 x 512 image on the card equal
   to ``nms`` on the CPU over the same boxes and scores, timed; (d) CRNN
   on ``bench --model ocr``'s stream (widths [96, 160, 256, 320], B 32,
   labels up to 24, 97 classes), checked and timed as (c); every
   graphed step under cuDNN's defaults. Prints one JSON line a part.
25. Deploy (i) (``phase_deploy_i``, ``tools/deploy_drills.py``): (a)
   GPT-355M (``bench --model gpt``'s, O2 bf16 from its seed) exported by
   ``jit.save`` (dynamic batch, S 1024; one ``paddle_tpu_torch::flash_fwd``
   node, K1, a layer), served by ``inference.create_predictor`` on the
   card at B 8 and B 2: logits bit for bit the eager model's, K1 24
   launches a call, K2-K5, the embedding kernel and the plain versions
   none; (b) the same artifact through the ``PD_*`` C API at B 2, equal;
   (c) ``convert_to_mixed_precision`` to bf16 storage, reloaded, equal;
   (d) ``profiler.Profiler`` (``make_scheduler(closed=1, ready=1,
   record=2)``, ``export_chrome_tracing``) around four calls of the bench
   step: the trace's K1/K2/K3 device events equal the launch counters
   over the two recorded steps, the step spans there, ``summary()``'s
   device operations printed; (e) the device API (memory queries equal
   ``torch.cuda``'s, an ``Event`` pair timing K1, K1 under
   ``stream_guard(Stream())`` equal and on another stream, the operator's
   host cost per eager call); (f) one QAT step of a conv + linear net on
   the card against the CPU within ``QAT_TOL``. Prints one JSON line a
   part.
26. Incubate (j) (``phase_incubate_j``, ``tools/incubate_drills.py``):
   (a) 12 ``FusedTransformerEncoderLayer`` at BERT-base's width (768, 12
   heads, 3072, gelu, post-LN, dropout 0.1), B 32, S 128, a bool
   key-padding mask, O2 bf16, AdamW on an MSE loss: 4 steps eagerly,
   then the same 4 through ``jit.to_static``, losses and parameters bit
   for bit, K1-K3 12 a step, nothing else; the same eager steps with
   ``incubate.set_config({"kernel": {"enable": False}})``: no flash
   launch, losses within ``KERNEL_OFF_RTOL``; (b) ``FusedMultiTransformer``
   at GPT-355M's width (24 layers, 1024, 16 heads), bf16, B 8: a 128-token
   prefill (dense attention), then 32 one-token steps on the caches, K1
   at Sq 1 and Sk 129-160, 24 launches a step, each call held against
   the plain K1 within phase 3b's bf16 tolerance, every step within
   ``DECODE_REL`` of the kernels-off run; K1 timed at that shape beside
   its bound, its plain version and SDPA; (c) ``flash_attn_unpadded``,
   the masked softmax, the segment and graph ops on 100,000 edges,
   ``FusedEcMoe``, the optimizers, BFGS/L-BFGS and ``asp`` on the card
   against the CPU. Prints one JSON line a part.
27. Static (k) (``phase_static_k``, ``tools/static_drills.py``): (a)
   GPT-355M (``bench --model gpt``'s width, f32) built as a static
   Program (``static.data`` ids and labels ``[None, 1024]``,
   ``AdamW(1e-4).minimize(loss)``) and run by ``Executor.run``: four
   steps at B 4, two at B 2 (two captures), every loss and parameter bit
   for bit the port's eager dygraph loop from the same seed, K1-K3 24 a
   step; (b) a ``jit.to_static`` greedy decode over that model (B 4, L
   256, a 32-token prompt; ``while cur < L and not paddle.all(done)``
   converted by dy2static into one WHILE node of the graph,
   ``csrc/graph_cond.cu``), three calls on one captured graph (an early
   stop, a run to L, zero trips) bit for bit the Python loop on the
   card, K1 captured 24 times; (c) ``cond``/``case``/``switch_case``/
   ``while_loop`` in ``to_static`` and in an Executor program, every
   branch replayed, a ``cond`` in a WHILE body, the gradient through a
   captured ``cond`` equal to eager, a host read in a captured branch
   refused with RuntimeError; (d) the WHILE node's ms a trip against the
   plain loop's. Prints one JSON line a part and a summary with the
   capture seconds, the step ms and the ms a decode trip.
28. Export (l) (``phase_export_l``, ``tools/export_drills.py``): (a) phase
   27's ``to_static`` greedy decode over GPT-355M (B 4, L 256, a 32-token
   prompt) saved by ``jit.save``: one ``while_loop`` node whose body holds
   24 ``paddle_tpu_torch::flash_fwd`` nodes; loaded by ``jit.load`` on the
   card, its three calls give phase 27's tokens and ``cur`` (the Python
   loop's and the replayed WHILE node's) bit for bit, K1 24 launches a
   trip; a small Layer with a tensor ``if`` saved and loaded, both
   branches equal to eager; (b) ``onnx.export_decode`` of GPT-355M at B 1
   in f32 from the card: four decode steps after a 16-token prompt in the
   numpy evaluator on the host against the card's eager step, equal
   tokens, caches within 1e-4 by norm; ``onnx.export`` of MobileNetV2 at
   B 1, 224 x 224, logits within 1e-4 by norm; every op type one the JAX
   converter emits; (c) an ASR front end (B 8 x 160,000 samples, n_fft
   512, hop 160: ``stft``/``istft``, ``LogMelSpectrogram`` with 80 mels,
   ``MFCC`` with 40), ``viterbi_decode`` at B 64, T 128, 52 tags and the
   ``fft`` family's gradients on the card against the CPU, Viterbi paths
   equal. Part (b) runs in a child process started just before phase 21
   and waited for just after it (``clock: onnx_child``): its exports are
   host-bound tracing, beside drills that mostly wait on their own
   children. Each path's launches are counted from 0 just before it and
   read just after (in the child for (b)). Prints one JSON line a part
   and a summary; the phase's clock line adds the child's seconds.

The last two lines are the kernels' JSON record (K1-K3 with their
launches by path: ``train_gpt13``, ``train_llama``,
``train_graphed_gpt13``, ``train_graphed_llama``,
``train_graphed_state``, ``facade_attention``, ``facade_train``,
``train_bert``, ``train_graphed_bert``, ``train_bert_masked``,
``train_gpt13_rc_{off,full,dots,dots_no_batch}``, ``flag_flash_on``,
``flag_flash_off``, ``generate_llama``, ``generate_gpt``,
``train_fit_resume``, ``train_guard``, ``train_preemption``,
``train_dp_gpt13``, ``train_dp2_gpt355m``, ``train_tp2_gpt355m``,
``train_zero_{os,os_g,p_g_os}_gpt13``, ``train_zero_{dp,os,os_g,
p_g_os}_gpt355m``, ``train_pp_1f1b_gpt355m``,
``train_pp_model_gpt355m``, ``vpp_forward_gpt355m``,
``train_sep2_llama076b``, ``train_engine_gpt13``,
``train_engine_dp2_gpt355m`` (the two-rank paths summed over the ranks),
``train_gpt355m``, ``profile_gpt355m``, ``infer_gpt355m``,
``infer_capi_gpt355m``, ``infer_bf16_store_gpt355m`` (K1 only: 24 a
call), ``train_fused_encoder_bert`` (graphed),
``train_fused_encoder_bert_eager``, ``decode_fused_gpt355m`` (K1 only: 24
a decode step), and 0 on ``zoo_forward``, ``zoo_train``,
``train_yoloe_stream``, ``train_ocr_stream``,
``train_fused_encoder_bert_kernel_off`` and
``decode_fused_gpt355m_kernel_off``, ``train_static_gpt355m`` (24 a step)
and ``decode_static_gpt355m`` (K1: the eager first call's, then 24 a
trip of the captured WHILE body), ``export_decode_loaded_gpt355m`` (K1:
24 a trip of the loaded ``while_loop``), and 0 on
``onnx_trace_gpt355m``, ``onnx_trace_mobilenet_v2`` and ``spectral``; on
a graphed path the eager first
step's launches plus the replayed ones; and ``bert_case``, their times at
BERT's shape, and K1's ``decode_case`` (Sq 1, Sk 160); K4's paths add
``serve_fleet_reload``; K4 and K5 record
the distributed paths' 0; then the embedding backward kernel, which
replaces no Pallas kernel, with its launches on every training path
above, counted the same way, and on the repeats of (c) alone; and the
WHILE node of ``csrc/graph_cond.cu``, which replaces no Pallas kernel
either (the JAX package's ``lax.while_loop``), with its executions on
the decode path) and {"ok": true, "device": {...}}.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; f32 FMA


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# ───────────────────────────── timing and bounds ─────────────────────────────


def cuda_ms(torch, fn, launches=20, rounds=5):
    """Median over ``rounds`` of the mean device time of ``launches``
    back-to-back calls, timed with CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def graph_ms(torch, fn, launches=20, rounds=5):
    """Median over ``rounds`` of the mean device time of ``launches``
    calls captured in one CUDA graph and replayed: the card's time for
    the calls without the host's time to issue them (which exceeds the
    device time of a call of a few microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(per)


def paged_bound(torch, q, k_pool, bt, lens, scales):
    """Least time for one ragged paged-attention call on these inputs:
    the larger of (bytes it must move / memory rate) and (its multiply-
    adds / peak rate of its type). Bytes: every KV page the rows' lengths
    reach (once, however many rows share it) with its scales, the block
    table entries read, the lengths, q and the output. Operations: 2 per
    multiply-add of q.k and p.v over each row's keys and heads."""
    T, nh, hd = q.shape
    page, nkv = k_pool.shape[1], k_pool.shape[2]
    lens_h = lens.cpu().tolist()
    bt_h = bt.cpu().tolist()
    pages, table_entries = set(), 0
    for row, n in zip(bt_h, lens_h):
        need = -(-n // page)
        pages.update(row[:need])
        table_entries += need
    kv = 2 * len(pages) * page * nkv * hd * k_pool.element_size()
    if scales:
        kv += 2 * len(pages) * page * nkv * 4
    nbytes = kv + 4 * table_entries + 4 * T + 2 * q.numel() * q.element_size()
    ops = 4.0 * sum(lens_h) * nh * hd
    kind = ("bf16" if q.dtype == torch.bfloat16
            and k_pool.dtype == torch.bfloat16 else "f32")
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ───────────────────────────── phases ─────────────────────────────


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {card}")
    return name, card


def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(secs)} source(s) in {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    for n in secs:
        log_path = _build.library_path(n).with_suffix(".log")
        if not log_path.exists():
            continue
        kernel = "?"
        for line in log_path.read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas[{n}] {kernel}: "
                    f"{line.replace('ptxas info    :', '').strip()}")


def kernel_label(mangled):
    """``flash_fwd_bf16_kernel<128>`` from a mangled kernel name: its
    length-prefixed names read in order up to the one that ends in
    ``kernel``, then its template arguments (``f`` f32,
    ``13__nv_bfloat16`` bf16, ``a`` int8, ``Li128E`` an int, ``S0_`` or
    ``S1_``, a back-reference, the bf16 named before it)."""
    import re

    pos = len("_ZN") if mangled.startswith("_ZN") else len("_Z")
    while (n := re.match(r"\d+", mangled[pos:])) is not None:
        pos += n.end()
        name = mangled[pos:pos + int(n.group())]
        pos += len(name)
        if not name.endswith("kernel"):
            continue
        args = re.match(r"I(.*?)E+v", mangled[pos:])
        if args is None:
            return name
        kinds = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}
        return name + "<" + ", ".join(
            t.group(1) or kinds.get(t.group(0), "bf16") for t in re.finditer(
                r"Li(\d+)E?|13__nv_bfloat16|S\d*_|f|a", args.group(1))) + ">"
    return mangled


def _pool(torch, gen, shape, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def make_case(torch, dev, *, q_lens, starts, nh, nkv, q_dtype, kv_dtype,
              hd=128, page=16, pages_per_seq=128, null_rows=0, seed=0):
    """Inputs of one ragged call: slot i contributes q_lens[i] rows at
    positions starts[i].. over its own pages, then ``null_rows`` padding
    rows on the null table (page 0) at position 0, as the engine lays
    them out."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_slots = len(q_lens)
    num_pages = n_slots * pages_per_seq + 1
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    slot_bt = perm.view(n_slots, pages_per_seq).to(torch.int32)
    reps = torch.tensor(q_lens, device=dev)
    bt = slot_bt.repeat_interleave(reps, dim=0)
    lens = torch.cat([torch.arange(s, s + n, device=dev) + 1
                      for s, n in zip(starts, q_lens)]).to(torch.int32)
    if null_rows:
        bt = torch.cat([bt, torch.zeros((null_rows, pages_per_seq),
                                        dtype=torch.int32, device=dev)])
        lens = torch.cat([lens, torch.ones(null_rows, dtype=torch.int32,
                                           device=dev)])
    bt = bt.contiguous()
    T = int(lens.numel())
    q = torch.randn((T, nh, hd), generator=gen, device=dev).to(q_dtype)
    shape = (num_pages, page, nkv, hd)
    k = _pool(torch, gen, shape, kv_dtype, dev)
    v = _pool(torch, gen, shape, kv_dtype, dev)
    ks = vs = None
    if kv_dtype == torch.int8:
        ks = torch.rand(shape[:3], generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(shape[:3], generator=gen, device=dev) * 0.02 + 1e-3
    return q, k, v, bt, lens, ks, vs


def paged_cases(torch, pa):
    """Phase 3a's cases: (name, make_case arguments, tolerance, timed).
    The serving path's shapes (Llama-0.76B: 16 heads of 128, pages of
    16, tables of 128 pages), through every path of the kernel: rows
    split across blocks with a merge (decode), rows tiled per chunk (no
    split), tiles that cross a slot boundary, padding rows."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    decode_lens = [2048, 1, 731, 1500, 64, 1999, 17, 1024]
    decode = dict(q_lens=[1] * 8, starts=[n - 1 for n in decode_lens])
    chunk = dict(q_lens=[1, 1, 1, 256], starts=[900, 2047, 33, 1500])
    # four decode rows: 1 key, a page, a partition, a partition + 1
    part = pa.launch_plan(4, 16, 16, 16, 128).part_pages * 16
    edges = dict(q_lens=[1] * 4, starts=[0, 15, part - 1, part])
    serve = dict(nh=16, nkv=16, q_dtype=f32, kv_dtype=bf16)
    return [
        # the serving path's pairing: f32 q (rope'd by f32 tables) over
        # bf16 pages; both versions widen the pages and compute in f32
        ("a_decode_f32q_bf16kv", dict(decode, **serve), 5e-5, True),
        ("a_decode_f32", dict(decode, nh=16, nkv=16, q_dtype=f32,
                              kv_dtype=f32), 5e-5, True),
        ("a_decode_bf16", dict(decode, nh=16, nkv=16, q_dtype=bf16,
                               kv_dtype=bf16), 2e-2, True),
        ("b_chunk_bf16", dict(chunk, nh=16, nkv=16, q_dtype=bf16,
                              kv_dtype=bf16), 2e-2, True),
        ("c_gqa_bf16", dict(decode, nh=32, nkv=8, q_dtype=bf16,
                            kv_dtype=bf16), 2e-2, False),
        ("d_int8_pages", dict(decode, nh=16, nkv=16, q_dtype=f32,
                              kv_dtype=i8), 5e-5, False),
        ("e_one_row_2048", dict(q_lens=[1], starts=[2047], **serve), 5e-5,
         True),
        ("f_edges", dict(edges, **serve), 5e-5, False),
        ("g_chunk_cross_slots", dict(q_lens=[5, 20, 1], starts=[700, 1200, 40],
                                     **serve), 5e-5, False),
        ("h_padding_rows", dict(q_lens=[1, 1, 1], starts=[300, 5, 1100],
                                null_rows=13, **serve), 5e-5, False),
        ("i_gqa_int8_split", dict(q_lens=[1, 1], starts=[2047, 600], nh=32,
                                  nkv=8, q_dtype=f32, kv_dtype=i8), 5e-5,
         False),
        ("j_chunk_f32q", dict(chunk, **serve), 5e-5, False),
    ]


def nan_confined(torch, pa, q, k, v, bt, lens, ks, vs, base):
    """K4 with one slot's live key poisoned: position 0 of the first row's
    first page, kv head 0, NaN in turn in K and V (bf16/f32 pages) or in
    their scale rows (int8 pages, whose codes cannot hold NaN). Every row
    of that slot must come out non-finite on the query heads of kv head
    0, and every other (row, head) ``torch.equal`` to the unpoisoned
    call ``base``: the kernel carries the NaN as the JAX package's does,
    to the row that reads it and to no other. Returns the kinds held."""
    groups = q.shape[1] // k.shape[2]
    page = int(bt[0, 0])
    rows = (bt == bt[0]).all(dim=1)
    mask = torch.zeros(q.shape[:2], dtype=torch.bool, device=q.device)
    mask[rows, :groups] = True
    inputs = {"k": k, "v": v, "ks": ks, "vs": vs}
    kinds = ("ks", "vs") if ks is not None else ("k", "v")
    for kind in kinds:
        args = dict(inputs)
        args[kind] = inputs[kind].clone()
        args[kind][page, 0, 0] = float("nan")
        out = pa.paged_attention(q, args["k"], args["v"], bt, lens,
                                 k_scale=args["ks"], v_scale=args["vs"])
        torch.cuda.synchronize()
        read = out[mask]
        if bool(torch.isfinite(read).any()) or not torch.equal(
                out[~mask], base[~mask]):
            fail(f"K4 with NaN in {kind} at page {page}: "
                 f"{int(torch.isfinite(read).sum())} finite values on the "
                 f"poisoned rows' heads, others equal "
                 f"{torch.equal(out[~mask], base[~mask])}")
    return kinds


def phase_paged_kernels(torch):
    from paddle_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    results = {}
    for name, kw, tol, timed in paged_cases(torch, pa):
        q, k, v, bt, lens, ks, vs = make_case(torch, dev, **kw)
        plan = pa.launch_plan(q.shape[0], q.shape[1], k.shape[2], k.shape[1],
                              bt.shape[1])
        got = pa.paged_attention(q, k, v, bt, lens, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = pa.ref_paged_attention(q, k, v, bt, lens, k_scale=ks,
                                      v_scale=vs)
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= tol + tol * want.float().abs()).all())
        line = (f"kernel {name}: T={q.shape[0]} nh={q.shape[1]} "
                f"nkv={k.shape[2]} {k.dtype} pages, plan n_split="
                f"{plan.n_split} part_pages={plan.part_pages} rows_per_tile="
                f"{plan.rows_per_tile}; max_abs_err={max_err:.3e} "
                f"(atol=rtol={tol:g}) {'ok' if ok else 'MISMATCH'}")
        rec = {"max_abs_err": max_err}
        if timed:
            def call():
                return pa.paged_attention(q, k, v, bt, lens, k_scale=ks,
                                          v_scale=vs)
            # the kernel's time: calls replayed from a CUDA graph; beside
            # it the eager calls' time, which includes the host's time to
            # issue each call where that is the longer
            ms = graph_ms(torch, call)
            eager_ms = cuda_ms(torch, call)
            plain_ms = cuda_ms(torch, lambda: pa.ref_paged_attention(
                q, k, v, bt, lens, k_scale=ks, v_scale=vs),
                launches=2, rounds=3)
            bound_ms, bound_by = paged_bound(torch, q, k, bt, lens,
                                             ks is not None)
            rec.update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            line += (f" | kernel {ms:.4f} ms (eager calls {eager_ms:.4f} "
                     f"ms), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}), {bound_ms / ms:.1%} of bound")
        log(line)
        if not ok:
            fail(f"kernel case {name} disagrees with its plain version")
        kinds = nan_confined(torch, pa, q, k, v, bt, lens, ks, vs, got)
        rows = int((bt == bt[0]).all(dim=1).sum())
        log(f"kernel {name}: NaN in {'/'.join(kinds)} of one slot's live "
            f"key: its {rows} row(s) non-finite on the heads reading kv "
            f"head 0, every other (row, head) equal to the clean call")
        rec["nan_confined"] = list(kinds)
        results[name] = rec
    return results


# ───────────────────────────── flash attention ─────────────────────────────


def flash_pairs(torch, B, sq, sk, causal, kpad):
    """(q, k) pairs the masks leave valid, over the batch, per head: the
    work a flash kernel needs on these inputs."""
    ok = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        ok = ok.tril(sk - sq)
    if kpad is None:
        return B * int(ok.sum())
    return int((ok[None] & (kpad[:, None, :] > 0.5)).sum())


def flash_bounds(torch, q, k, causal, kpad):
    """Least time of K1, K2 and K3 on these inputs: the larger of (bytes
    each must move / memory rate) and (its flops / the peak rate of its
    type). Bytes: each input read once, each output written once (K1: q,
    k, v, kpad in; O, LSE out. K2: q, k, v, dO, LSE, Delta, kpad in; dQ
    out. K3: the same in; dK, dV out). Flops per valid (q, k) pair and
    head: K1 4 D (q.k and p.v), K2 6 D (q.k, dO.v, dS.k), K3 8 D (q.k,
    dO.v, p^T.dO, dS^T.q)."""
    B, sq, H, D = q.shape
    sk = k.shape[1]
    e = q.element_size()
    qb, kb = B * sq * H * D * e, B * sk * H * D * e
    rows = 4 * B * H * sq
    kp = 4 * B * sk if kpad is not None else 0
    pairs = H * flash_pairs(torch, B, sq, sk, causal, kpad)
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    out = {}
    for name, nbytes, flops in (
            ("flash_fwd", 2 * qb + 2 * kb + kp + rows, 4 * D * pairs),
            ("flash_dq", 3 * qb + 2 * kb + kp + 2 * rows, 6 * D * pairs),
            ("flash_dkv", 2 * qb + 4 * kb + kp + 2 * rows, 8 * D * pairs)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_OPS[kind]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def flash_case(torch, gen, B, sq, sk, H, D, dtype, kpad_rows=False):
    """q as a strided [B, Sq, H, D] view of a [B, Sq, 3, H, D] QKV
    tensor (GPT's layout), k and v the same at Sk, dO contiguous. Key
    padding (``kpad_rows``): True keeps half of row 0's keys; "random"
    keeps a random length of each row's (from 1); both keep no key of
    the last row."""
    dev = "cuda"
    qkv = torch.randn((B, sq, 3, H, D), generator=gen, device=dev).to(dtype)
    kvx = torch.randn((B, sk, 3, H, D), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], kvx[:, :, 1], kvx[:, :, 2]
    do = torch.randn((B, sq, H, D), generator=gen, device=dev).to(dtype)
    kpad = None
    if kpad_rows:
        kpad = torch.ones((B, sk), device=dev)
        if kpad_rows == "random":
            lens = torch.randint(1, sk + 1, (B, 1), generator=gen,
                                 device=dev)
            kpad = (torch.arange(sk, device=dev)[None] < lens).float()
        else:
            kpad[0, sk // 2:] = 0.0
        kpad[-1] = 0.0  # the last batch row keeps no key
    return q, k, v, do, kpad


# (atol, rtol, norm-relative) of the flash checks. bf16: the kernels and
# the plain versions round p and dS to bf16 at the same points, so an
# element may land at most a bf16 ulp (2^-8..2^-7 of its size) apart;
# rtol 2^-6 allows two, atol 2e-3 the elements near zero, and the whole
# tensor's error must stay within 5e-3 of its norm.
FLASH_TOL = {"f32": (5e-5, 5e-5, 1e-5), "bf16": (2e-3, 2.0 ** -6, 5e-3)}


def held(torch, got, want, tol):
    """``(ok, max abs err, norm-relative err)`` of ``got`` against
    ``want``: every element within ``atol + rtol |want|`` and
    ``||got - want|| / ||want||`` within ``rel``."""
    atol, rtol, rel = tol
    want = want.float()
    err = (got.float() - want).abs()
    rel_err = float(torch.linalg.vector_norm(err)
                    / torch.linalg.vector_norm(want).clamp_min(1e-30))
    ok = bool((err <= atol + rtol * want.abs()).all()) and rel_err <= rel
    return ok, float(err.max()), rel_err


def flash_plain(fa, q, k, v, do, causal, scale, drop, seed, kpad):
    """The plain versions' O, LSE, dQ, dK, dV on these inputs, the
    backward from their own forward's LSE and Delta."""
    pargs = (causal, scale, drop, seed, kpad)
    o, lse = fa.ref_flash_fwd(q, k, v, *pargs)
    delta = fa.flash_delta(o, do)
    bargs = (q, k, v, do, lse, delta) + pargs
    return (o, lse, fa.ref_flash_dq(*bargs), *fa.ref_flash_dkv(*bargs))


def flash_controls(torch, fa, got, q, k, v, do, kw, tol):
    """The bf16 check's reach, on gpt13's kernel outputs ``got`` (O, LSE,
    dQ, dK, dV): against the plain versions with the scale 1% off (what a
    kernel with a wrong constant would give), which the check must
    reject, and against the plain versions on f32 copies of the inputs
    (p, dS and the outputs unrounded), which it reports."""
    scale = kw["scale"]
    drop, seed, kpad = (kw["dropout_p"], kw["dropout_seed"],
                        kw["key_padding_mask"])
    f32 = [t.float() for t in (q, k, v, do)]
    out = {}
    for label, want in (
            ("scale_1pct_off", flash_plain(fa, q, k, v, do, kw["causal"],
                                           scale * 1.01, drop, seed, kpad)),
            ("f32_p", flash_plain(fa, *f32, kw["causal"], scale, drop, seed,
                                  kpad))):
        res = {n: held(torch, g, w, tol) for n, g, w in
               zip(("o", "lse", "dq", "dk", "dv"), got, want)}
        out[label] = res
        log(f"  control {label}: " + ", ".join(
            f"{n} {'passes' if ok else 'rejected'} (max {m:.2e}, rel "
            f"{r:.2e})" for n, (ok, m, r) in res.items()))
    if all(ok for ok, _m, _r in out["scale_1pct_off"].values()):
        fail("flash check: a 1% scale error passes the bf16 tolerance")
    return out


def phase_flash_kernels(torch):
    """K1, K2 and K3 against their plain versions on the same inputs,
    per case: O, LSE, dQ, dK, dV, each held elementwise and by its norm at
    ``FLASH_TOL``. The gpt13 cases are timed; the bf16 one also reads the
    check's reach (``flash_controls``)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        # name, B, Sq, Sk, H, D, dtype, causal, kpad, dropout, timed
        ("gpt13_bf16", 8, 1024, 1024, 16, 128, bf16, True, False, 0.0, True),
        ("gpt13_f32", 8, 1024, 1024, 16, 128, f32, True, False, 0.0, True),
        ("sq256_sk1024_bf16", 2, 256, 1024, 16, 128, bf16, True, False, 0.0,
         False),
        ("s1000_bf16", 2, 1000, 1000, 16, 128, bf16, True, False, 0.0, False),
        ("kpad_f32", 3, 512, 512, 4, 128, f32, False, True, 0.0, False),
        ("dropout_bf16", 2, 1024, 1024, 4, 128, bf16, True, False, 0.1,
         False),
        ("d32_f32", 2, 300, 300, 8, 32, f32, True, False, 0.0, False),
        ("d32_bf16", 2, 300, 300, 8, 32, bf16, True, False, 0.0, False),
        ("d64_bf16", 2, 512, 512, 8, 64, bf16, True, False, 0.0, False),
        ("kpad_bf16", 3, 512, 512, 4, 128, bf16, False, True, 0.0, False),
        # BERT-base's attention on the train_bert path: non-causal, 12
        # heads of 64, dropout 0.1; then with random key lengths
        ("bert_bf16", 32, 128, 128, 12, 64, bf16, False, False, 0.1, True),
        ("bert_kpad_bf16", 32, 128, 128, 12, 64, bf16, False, "random",
         0.1, False),
    ]
    results = {}
    for (name, B, sq, sk, H, D, dt, causal, kp, drop, timed) in cases:
        q, k, v, do, kpad = flash_case(torch, gen, B, sq, sk, H, D, dt, kp)
        kw = dict(causal=causal, scale=D ** -0.5, dropout_p=drop,
                  dropout_seed=4321 if drop else 0, key_padding_mask=kpad)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        pargs = (causal, D ** -0.5, drop, kw["dropout_seed"], kpad)
        o_r, lse_r = fa.ref_flash_fwd(q, k, v, *pargs)
        bargs = (q, k, v, do, lse, delta) + pargs
        dq_r = fa.ref_flash_dq(*bargs)
        dk_r, dv_r = fa.ref_flash_dkv(*bargs)
        tol = FLASH_TOL["f32" if dt == f32 else "bf16"]
        errs, rels, ok = {}, {}, True
        for label, got, want in (("o", o, o_r), ("lse", lse, lse_r),
                                 ("dq", dq, dq_r), ("dk", dk, dk_r),
                                 ("dv", dv, dv_r)):
            good, errs[label], rels[label] = held(torch, got, want, tol)
            ok &= good
        rec = {"max_abs_err": {"flash_fwd": max(errs["o"], errs["lse"]),
                               "flash_dq": errs["dq"],
                               "flash_dkv": max(errs["dk"], errs["dv"])},
               "rel_err": rels}
        line = (f"flash {name}: B={B} Sq={sq} Sk={sk} H={H} D={D} "
                f"causal={causal} kpad={kp} dropout={drop} max_abs_err "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
                + " rel " + " ".join(f"{n}={e:.2e}" for n, e in rels.items())
                + f" (atol {tol[0]:g}, rtol {tol[1]:g}, rel {tol[2]:g}) "
                + ("ok" if ok else "MISMATCH"))
        log(line)
        if not ok:
            fail(f"flash case {name}: a kernel disagrees with its plain "
                 "version")
        if name == "gpt13_bf16":
            rec["controls"] = flash_controls(
                torch, fa, (o, lse, dq, dk, dv), q, k, v, do, kw, tol)
        if timed:
            rec.update(time_flash(torch, fa, q, k, v, do, o, lse, delta, kw,
                                  pargs))
            bounds = flash_bounds(torch, q, k, causal, kpad)
            for kname in fa.KERNELS:
                r = rec[kname]
                r["bound_ms"], r["bound_by"] = bounds[kname]
                log(f"  {kname}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of "
                    f"bound; SDPA {r['library_ms']:.4f} ms "
                    f"({r['library_of']}), kernel "
                    f"{r['ms'] / r['library_ms']:.2f}x SDPA")
        results[name] = rec
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r, dq_r, dk_r
        del dv_r
        torch.cuda.empty_cache()
    flash_refuses_misaligned(torch, fa)
    results["seed_replay"] = flash_seed_replay(torch, fa)
    return results


def flash_seed_replay(torch, fa):
    """The dropout seed is data: K1, K2 and K3 with dropout 0.1 (bf16, B
    2, S 512, 4 heads of 128, causal) captured in one CUDA graph that
    reads a seed tensor; two seeds written into it after the capture, one
    before each replay, must give the eager calls' outputs with those
    seeds bit for bit, and the two must differ."""
    B, S, H, D = 2, 512, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do, _ = flash_case(torch, gen, B, S, S, H, D, torch.bfloat16)
    seed = torch.zeros((), dtype=torch.int32, device="cuda")
    kw = dict(causal=True, dropout_p=0.1, dropout_seed=seed)

    def run():
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
        return (o, lse, dq, *fa.flash_dkv(q, k, v, do, lse, delta, **kw))

    seeds = (1234, 98765)
    eager, got = {}, {}
    for val in seeds:
        seed.fill_(val)
        eager[val] = [t.clone() for t in run()]
    seed.fill_(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for val in seeds:
        seed.fill_(val)
        graph.replay()
        got[val] = [t.clone() for t in out]
    torch.cuda.synchronize()
    equal = {val: all(torch.equal(a, b) for a, b in zip(got[val],
                                                        eager[val]))
             for val in seeds}
    differ = not torch.equal(got[seeds[0]][0], got[seeds[1]][0])
    log(f"flash seed after capture: replays with seeds {seeds} equal the "
        f"eager calls bit for bit {equal}; the two outputs differ {differ}")
    if not all(equal.values()) or not differ:
        fail("flash seed: a seed written after the capture did not reach "
             "the replay")
    del graph
    return {"equal": equal, "differ": differ}


def flash_refuses_misaligned(torch, fa):
    """A bf16 q whose sequence stride (132 elements, 264 bytes) is off 16
    bytes: K1's, K2's and K3's wrappers must raise ValueError before any
    launch."""
    B, S, H, D = 1, 64, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = torch.randn((B, S, H * D + 4), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = base.as_strided((B, S, H, D), (S * (H * D + 4), H * D + 4, D, 1))
    k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    lse = torch.zeros((B * H, S), device="cuda")
    before = dict(fa.kernel_launches)
    refused = []
    for kname, call in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, causal=True)),
            ("flash_dq", lambda: fa.flash_dq(q, k, v, do, lse, lse,
                                             causal=True)),
            ("flash_dkv", lambda: fa.flash_dkv(q, k, v, do, lse, lse,
                                               causal=True))):
        try:
            call()
        except ValueError as e:
            refused.append(kname)
            msg = str(e)
    torch.cuda.synchronize()
    ok = (refused == ["flash_fwd", "flash_dq", "flash_dkv"]
          and fa.kernel_launches == before)
    log(f"flash misaligned bf16 q (sequence stride {q.stride(1) * 2} bytes): "
        f"refused by {refused}, launches {fa.kernel_launches} "
        f"{'ok' if ok else 'NOT REFUSED'}" + (f" ({msg})" if refused else ""))
    if not ok:
        fail("flash wrappers took a bf16 input off 16-byte alignment")


def time_flash(torch, fa, q, k, v, do, o, lse, delta, kw, pargs):
    """Device ms of each kernel, its plain version, and SDPA's forward
    and backward (one call each: the library's flash attention on the
    same q, k, v, dO, with the same dropout rate; its backward computes
    dQ, dK and dV together)."""
    F = torch.nn.functional
    bargs = (q, k, v, do, lse, delta) + pargs
    out = {
        "flash_fwd": dict(
            ms=cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.ref_flash_fwd(q, k, v, *pargs),
                             launches=2, rounds=3)),
        "flash_dq": dict(
            ms=cuda_ms(torch, lambda: fa.flash_dq(q, k, v, do, lse, delta,
                                                  **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.ref_flash_dq(*bargs),
                             launches=2, rounds=3)),
        "flash_dkv": dict(
            ms=cuda_ms(torch, lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                                   **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.ref_flash_dkv(*bargs),
                             launches=2, rounds=3)),
    }
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2)
    causal = kw["causal"]
    drop = kw["dropout_p"]
    fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, dropout_p=drop, is_causal=causal))
    oh = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=drop,
                                        is_causal=causal)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        oh, (qh, kh, vh), doh, retain_graph=True))
    out["flash_fwd"].update(library_ms=fwd_ms, library_of="forward")
    for kname in ("flash_dq", "flash_dkv"):
        out[kname].update(library_ms=bwd_ms,
                          library_of="backward, dQ+dK+dV in one call")
    return out


# ───────────────────────────── fused AdamW ─────────────────────────────

# (atol, rtol) on w', m', v' (the JAX package's tolerance between its
# kernel and its XLA form) and rtol on the update w - w': the kernel runs
# the plain version's f32 operations in its order, each rounded once, so
# the two agree to the bit; a wrong constant or formula moves the update
# of every element with a small v by far more than 1e-5 of itself.
ADAMW_TOL = (1e-7, 1e-6)
ADAMW_UPDATE_RTOL = 1e-5
ADAMW_FLOPS = 16  # per element: m' 3, v' 4, the Adam term 5, w' 4


def adamw_held(torch, w, got, want):
    """``(ok, max abs err over w', m', v', max relative err of the
    update)`` of ``got`` against ``want`` on inputs with weights ``w``."""
    atol, rtol = ADAMW_TOL
    ok, max_err = True, 0.0
    for a, b in zip(got, want):
        err = (a - b).abs()
        max_err = max(max_err, float(err.max()))
        ok &= bool((err <= atol + rtol * b.abs()).all())
    du_got, du_want = w - got[0], w - want[0]
    du_err = (du_got - du_want).abs()
    ok &= bool((du_err <= ADAMW_UPDATE_RTOL * du_want.abs()).all())
    rel = float((du_err / du_want.abs().clamp_min(1e-30)).max())
    return ok, max_err, rel


def phase_adamw_kernels(torch):
    """K5 against its plain version on the same inputs (w normal, g 1e-3
    x normal, moments zero or warm), a control that must be rejected, and
    at the bench's size the kernel, plain and library times."""
    from paddle_tpu_torch.ops import fused_adamw as k5
    from paddle_tpu_torch.tools.bench_adamw import N_TIMED, library_adamw

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [
        # name, N, step, lr, warm moments, offset (1: not 16-byte aligned)
        ("n10000_step5", 10_000, 5, 1e-3, False, 0),
        ("n2m_step10", 2_000_000, 10, 1e-4, True, 0),
        ("odd_unaligned_step1", 1_000_003, 1, 1e-3, False, 1),
        ("n355m_step10", N_TIMED, 10, 1e-4, True, 0),
    ]
    results = {}
    for name, n, step, lr, warm, off in cases:
        def vec(scale):
            return (torch.randn(n + off, generator=gen, device="cuda")
                    * scale)[off:]
        w, g = vec(1.0), vec(1e-3)
        m, v = ((vec(1e-4), vec(1e-3).square()) if warm
                else (torch.zeros_like(w), torch.zeros_like(w)))
        got = k5.fused_adamw_flat(w, m, v, g, lr, step)
        torch.cuda.synchronize()
        want = k5.ref_adamw_flat(w, m, v, g, lr, step)
        ok, max_err, du_rel = adamw_held(torch, w, got, want)
        bc2 = 1.0 - 0.999 ** step
        paddle_eps = k5.ref_adamw_flat(w, m, v, g, lr, step,
                                       eps=1e-8 / math.sqrt(bc2))
        c_ok, _c_err, c_rel = adamw_held(torch, w, got, paddle_eps)
        line = (f"adamw {name}: N={n} step={step} lr={lr:g} max_abs_err "
                f"{max_err:.2e}, update max rel err {du_rel:.2e} (atol "
                f"{ADAMW_TOL[0]:g}, rtol {ADAMW_TOL[1]:g}; update rtol "
                f"{ADAMW_UPDATE_RTOL:g}) {'ok' if ok else 'MISMATCH'}; "
                f"control paddle_eps {'passes' if c_ok else 'rejected'} "
                f"(update rel {c_rel:.2e})")
        log(line)
        if not ok:
            fail(f"adamw case {name}: the kernel disagrees with its plain "
                 "version")
        if c_ok:
            fail(f"adamw case {name}: Paddle's epsilon passes the check")
        rec = {"max_abs_err": max_err, "update_rel_err": du_rel,
               "control_update_rel_err": c_rel}
        del got, want, paddle_eps
        if name == "n355m_step10":
            rec["ms"] = cuda_ms(torch, lambda: k5.fused_adamw_flat(
                w, m, v, g, lr, step))
            rec["plain_ms"] = cuda_ms(torch, lambda: k5.ref_adamw_flat(
                w, m, v, g, lr, step), launches=2, rounds=3)
            opt, _p = library_adamw(w.clone(), m.clone(), v.clone(), g, lr,
                                    step)
            rec["library_ms"] = cuda_ms(torch, opt.step)
            del opt, _p
            t_bytes = 28 * n / HBM_BYTES_PER_S
            t_ops = ADAMW_FLOPS * n / PEAK_OPS["f32"]
            rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            log(f"  fused_adamw: kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}), {rec['bound_ms'] / rec['ms']:.1%} of "
                f"bound; torch fused AdamW {rec['library_ms']:.4f} ms")
        results[name] = rec
        del w, m, v, g
        torch.cuda.empty_cache()
    return results


def llama_076b():
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=12,
                       num_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)


def serve_traffic(torch, engine, requests, first_alone=None,
                  toggle_instruments=False):
    """Serve ``requests`` (``(prompt, temperature, seed, max_new)``) to
    completion through ``engine.step``, with K4's counts zeroed just
    before and read just after and the peak memory reset. With
    ``first_alone`` (a callable) the first request is served alone to
    completion (its prompt's full pages are then in the prefix cache),
    ``first_alone(prompt, output)`` is called, and then the rest are
    submitted. With ``toggle_instruments`` the metrics registry and the
    request tracer are switched off for every other step, and the record
    holds the decode-step p50 of each half. Returns the outputs in
    request order and the run's record."""
    from paddle_tpu_torch import metrics
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import get_tracer

    first_token, rids, steps = {}, [], []

    def stream_cb(rid, token, finished):
        if token is not None and rid not in first_token:
            first_token[rid] = time.perf_counter()

    def submit(prompt, temp, seed, max_new):
        rids.append(engine.add_request(prompt, max_new_tokens=max_new,
                                       temperature=temp, eos_token_id=2,
                                       seed=seed, stream_cb=stream_cb))

    def step():
        on = not toggle_instruments or len(steps) % 2 == 0
        reg, tracer = metrics.get_registry(), get_tracer()
        if not on:
            reg.disable()
            tracer.enabled = False
        ts = time.perf_counter()
        try:
            engine.step()
        finally:
            reg.enable()
            tracer.enabled = True
        steps.append((engine.stats["step_decode_tokens"],
                      engine.stats["step_prefill_tokens"],
                      time.perf_counter() - ts, on))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    steps_before = engine.stats["steps"]
    pa.reset_counters()
    t_start = time.perf_counter()
    later, outs = requests, {}
    if first_alone is not None:
        submit(*requests[0])
        later = requests[1:]
        while engine.has_work:
            step()
        outs.update(engine.take_outputs())
        first_alone(requests[0][0], outs[rids[0]])
    for r in later:
        submit(*r)
    while engine.has_work:
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {"kernel_launches": pa.kernel_launches,
              "captured_launches": pa.captured_launches,
              "replayed_launches": pa.replayed_launches,
              "plain_calls": pa.plain_calls}
    outs.update(engine.take_outputs())
    if set(outs) != set(rids):
        fail(f"served {len(outs)} of {len(rids)} requests")
    decode_ms = [1e3 * s for d, p, s, _on in steps if p == 0 and d > 0]
    ttft = sorted(first_token[r] - t_start for r in rids)
    generated = sum(outs[r].n_gen for r in rids)
    record = {
        "step": "cuda_graph" if engine._graphed else "eager",
        "steps": engine.stats["steps"] - steps_before,
        "generated_tokens": generated,
        "prompt_tokens": int(sum(len(r[0]) for r in requests)),
        "wall_s": wall, "tokens_per_s": generated / wall,
        "decode_step_ms_p50": (statistics.median(decode_ms) if decode_ms
                               else None),
        "decode_steps": len(decode_ms),
        "ttft_s_p50": statistics.median(ttft), "ttft_s_max": ttft[-1],
        **({"decode_step_ms_p50_instruments": {
            state: statistics.median(
                1e3 * s for d, p, s, on in steps
                if p == 0 and d > 0 and on == (state == "on"))
            for state in ("on", "off")}} if toggle_instruments else {}),
        "compile_counts": engine.compile_counts(),
        "capture_s_by_bucket": engine.capture_seconds(),
        # the peak, and what was allocated when the run began (weights,
        # pools, earlier engines still alive)
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "memory_before_gib": held_before / 2**30,
        **counts,
    }
    vocab = engine.model.config.vocab_size
    for (_p, _t, _s, new), r in zip(requests, rids):
        o = outs[r]
        if not (o.n_gen == new or (o.finish_reason == "stop"
                                   and o.token_ids[-1] == 2)):
            fail(f"request {r}: {o.n_gen} tokens, {o.finish_reason}")
        if not all(0 <= t < vocab for t in o.token_ids):
            fail(f"request {r}: token outside the vocabulary")
    return [outs[r] for r in rids], record


def check_k4_counts(name, engine, record):
    """K4 went through the run's every step and its plain version never:
    eagerly one launch a layer a step; graphed one replayed launch a
    layer a step, and per bucket captured one call a layer after a
    warm-up of one launch a layer."""
    layers, steps = engine.n_layers, record["steps"]
    buckets = record["compile_counts"]["step"]
    if record["compile_counts"]["step"] != \
            record["compile_counts"]["step_buckets"]:
        fail(f"{name}: compile_counts {record['compile_counts']}: "
             "step != step_buckets")
    if engine._graphed:
        want = {"kernel_launches": layers * buckets,
                "captured_launches": layers * buckets,
                "replayed_launches": layers * steps, "plain_calls": 0}
    else:
        want = {"kernel_launches": layers * steps, "captured_launches": 0,
                "replayed_launches": 0, "plain_calls": 0}
    got = {k: record[k] for k in want}
    if got != want:
        fail(f"{name}: K4 counts {got} != {want} ({layers} layers, "
             f"{steps} steps, {buckets} buckets)")


def phase_serve(torch, card):
    """Llama-0.76B served twice on the same requests, through the graphed
    step (the default) and the eager one: the streams must be equal (both
    runs take the same buckets, so the same GEMM shapes)."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_076b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, 8)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)),
                 0.8 if i in (2, 5) else 0.0, 1000 + i, 64)
                for i, n in enumerate(lengths)]
    runs = {}
    for graphed in (True, False):
        engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                               max_model_len=2048, token_budget=1024,
                               kv_dtype=torch.bfloat16, cuda_graph=graphed,
                               device="cuda")
        if graphed:
            log(f"serve: Llama-0.76B {n_params / 1e9:.3f} B params "
                f"({', '.join(dtypes)}: O2's rule, norms f32), intermediate "
                f"{cfg.intermediate_size}, pool {engine.pool.num_pages} "
                f"pages, set up in {time.perf_counter() - t0:.1f} s")
        outs, rec = serve_traffic(torch, engine, requests)
        rec["card"] = card
        log(f"serve ({rec['step']}): " + json.dumps(rec))
        check_k4_counts(f"serve ({rec['step']})", engine, rec)
        if engine.pool.used_pages != 0:
            fail(f"{engine.pool.used_pages} pages still in use after the run")
        runs[graphed] = (engine, [o.token_ids for o in outs], rec)
    (engine, graphed_streams, rec), (eager, eager_streams, _r) = (
        runs[True], runs[False])
    same = graphed_streams == eager_streams
    log(f"serve: graphed and eager streams {'identical' if same else 'DIFFER'}"
        f" over {len(requests)} requests")
    if not same:
        fail("serve: the graphed step's streams differ from the eager one's")
    del eager
    # the instruments' host cost: the same traffic on the graphed engine
    # (its cache cleared, so the same steps replay the same graphs) with
    # the metrics registry and the request tracer off every other step
    engine.prefix_cache.clear()
    outs, rec3 = serve_traffic(torch, engine, requests,
                               toggle_instruments=True)
    p50 = rec3["decode_step_ms_p50_instruments"]
    log(f"serve instruments (graphed, decode steps alternating): p50 on "
        f"{p50['on']:.4f} ms, off {p50['off']:.4f} ms, "
        f"{rec3['decode_steps']} decode steps; {card}")
    if [o.token_ids for o in outs] != graphed_streams:
        fail("serve: the instruments' run changed the streams")
    rec["decode_step_ms_p50_instruments"] = p50
    return engine, rec


def mixed_step(torch, engine, layer_tol):
    """Bring ``engine`` (idle) to one mixed step, 3 decode rows + a
    256-token chunk, and run that step twice on the same inputs. The first
    run's attention is the kernel, checked at every layer against the
    plain version called on the very same tensors; the second run's
    attention is the plain version throughout. Returns the largest
    per-layer error and the two runs' sample logits (live slots)."""
    import numpy as np

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    for n in (600, 90, 300):
        engine.add_request(rng.integers(0, 32000, n), max_new_tokens=4)
    engine.step()          # admits the three and prefills all 990 tokens
    engine.add_request(rng.integers(0, 32000, 256), max_new_tokens=2)
    for req in engine.scheduler.admit(1, engine.pool):
        engine._admit(req)
    batch = engine._plan()
    if batch.n_decode != 3 or batch.total != 259:
        fail(f"mixed step has {batch.n_decode} decode rows, "
             f"{batch.total} rows")
    layer_errs = []

    def checked(q, kp, vp, bt, lens, **kw):
        out = pa.ragged_paged_attention(q, kp, vp, bt, lens, **kw)
        ref = pa.ref_paged_attention(q, kp, vp, bt, lens, **kw).float()
        err = (out.float() - ref).abs()
        layer_errs.append(float(err.max()))
        if not bool((err <= layer_tol + layer_tol * ref.abs()).all()):
            fail(f"mixed step layer {len(layer_errs) - 1}: kernel and plain "
                 f"version disagree on the same inputs "
                 f"(max_abs_err {layer_errs[-1]:.3e})")
        return out

    live = [i for i, st in enumerate(engine.slots) if st is not None]
    logits = engine._forward(batch, attention=checked)
    plain = engine._forward(batch, attention=pa.ref_paged_attention)
    torch.cuda.synchronize()
    engine._land(batch, torch.argmax(logits, -1).cpu().numpy())
    engine.run()
    if engine.pool.used_pages != 0:
        fail("pages leaked after the mixed step")
    return max(layer_errs), logits[live], plain[live]


def phase_mixed_steps(torch, engine):
    """The mixed step on the served model (bf16 weights and pages, f32
    activations: the attention is f32 q over bf16 pages, computed in f32
    by both versions, so it is held per layer at the f32 tolerance), then
    on the same model in f32 (weights and pages). In the served model the
    two runs' logits may still part where a k or v sits at a bf16
    rounding midpoint as it is written to the pages, so its logit gap is
    reported; the f32 run, free of that rounding, holds the end-to-end
    logits too."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    layer_err, k_logits, p_logits = mixed_step(torch, engine, 5e-5)
    log(f"mixed step bf16 pages: 3 decode rows + 256 chunk rows; attention "
        f"kernel vs plain on the same inputs, max over 12 layers "
        f"{layer_err:.3e} (atol=rtol=5e-5) ok; sample logits gap "
        f"{float((k_logits - p_logits).abs().max()):.3e}")
    model = LlamaForCausalLM(llama_076b(), device="cuda", dtype=torch.float32,
                             seed=0)
    engine32 = ServingEngine(model, page_size=16, max_batch_slots=4,
                             max_model_len=2048, token_budget=1024,
                             kv_dtype=torch.float32, device="cuda")
    layer_err, k_logits, p_logits = mixed_step(torch, engine32, 5e-5)
    err = (k_logits - p_logits).abs()
    tol = 1e-3
    ok = bool((err <= tol + tol * p_logits.abs()).all())
    log(f"mixed step f32: attention per layer {layer_err:.3e} "
        f"(atol=rtol=5e-5) ok; sample logits kernel vs plain max_abs_err "
        f"{float(err.max()):.3e} (atol=rtol={tol:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("mixed-step f32 logits: kernel and plain version disagree")


def features_step(torch, engine, prefix, rng, layer_tol):
    """Bring the features engine (idle, its prefix cached) to one step of
    three decoding slots on the cached prefix pages, each with a burst of
    four drafts, over int8 pages the quantizing write filled, and run
    that step eagerly with K4 checked at every layer against its plain
    version on the same inputs; at the first layer the same K4 call is
    also captured in a CUDA graph and replayed, and held the same way.
    Then land the step's samples, fork one slot and make the fork's last
    written page its own (copy-on-write on the card: the page's codes
    and scale rows must arrive equal), and drain. Returns the largest
    per-layer error and the replay's."""
    import numpy as np

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import sampling

    class Repeat:  # proposes the stream's last token k times
        def propose(self, ids, k):
            return np.full(k, ids[-1], np.int32)

    vocab = engine.model.config.vocab_size
    for n in (40, 100, 70):
        engine.add_request(np.concatenate([prefix, rng.integers(0, vocab, n)]),
                           max_new_tokens=12)
    while engine.scheduler.waiting or any(
            s is not None and s.prefilling for s in engine.slots):
        engine.step()
    drafter, engine.drafter = engine.drafter, Repeat()
    batch = engine._plan()
    engine.drafter = drafter
    live = [i for i, st in enumerate(engine.slots) if st is not None]
    shared = [engine.pool._ref[engine.pool.block_table(engine.slots[i].req
                                                       .req_id)[0]]
              for i in live]
    if batch.n_draft != 4 * len(live) or batch.total != 5 * len(live) \
            or min(shared) < 2:
        fail(f"features step: {batch.n_draft} drafts over {len(live)} slots, "
             f"{batch.total} rows, first-page refcounts {shared}")
    errs, replay = [], []

    def checked(q, kp, vp, bt, lens, **kw):
        out = pa.ragged_paged_attention(q, kp, vp, bt, lens, **kw)
        ref = pa.ref_paged_attention(q, kp, vp, bt, lens, **kw).float()
        err = (out.float() - ref).abs()
        errs.append(float(err.max()))
        if not bool((err <= layer_tol + layer_tol * ref.abs()).all()):
            fail(f"features step layer {len(errs) - 1}: kernel and plain "
                 f"version disagree (max_abs_err {errs[-1]:.3e})")
        if not replay:
            T, nh, hd = q.shape
            n = pa.workspace_numel(T, nh, kp.shape[2], hd, kp.shape[1],
                                   bt.shape[1])
            ws = torch.empty(max(n, 1), device=q.device)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                pa.ragged_paged_attention(q, kp, vp, bt, lens, workspace=ws,
                                          **kw)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = pa.ragged_paged_attention(q, kp, vp, bt, lens,
                                                workspace=ws, **kw)
            graph.replay()
            torch.cuda.synchronize()
            e = (got.float() - ref).abs()
            replay.append(float(e.max()))
            if not bool((e <= layer_tol + layer_tol * ref.abs()).all()):
                fail(f"features step: the replayed K4 call disagrees with "
                     f"its plain version (max_abs_err {replay[0]:.3e})")
        return out

    logits = engine._forward(batch, attention=checked)
    S = engine._spec_rows
    nxt = sampling.sample(
        logits, torch.from_numpy(np.repeat(batch.temps, S)).cuda(),
        torch.from_numpy(np.repeat(batch.seeds, S)).cuda(),
        torch.from_numpy(batch.sample_pos.reshape(-1)).cuda())
    engine._land(batch, nxt.cpu().numpy())
    pool = engine.pool
    rid = engine.slots[live[0]].req.req_id
    n = pool.seq_len(rid)
    pool.fork(rid, "cow-probe")
    pi = (n - 1) // pool.page_size
    pool.extend_write("cow-probe", n - 1, n)
    old, fresh = pool.block_table(rid)[pi], pool.block_table("cow-probe")[pi]
    every = pool.k_pools + pool.v_pools + pool.k_scales + pool.v_scales
    if old == fresh or not all(torch.equal(t[fresh], t[old]) for t in every):
        fail(f"features step: copy-on-write of page {old} into {fresh} did "
             "not copy its codes and scales")
    pool.free("cow-probe")
    log(f"features step: copy-on-write on the card copied page {old} into "
        f"{fresh} (codes and scale rows of {pool.num_layers} layers, equal)")
    engine.run()
    return max(errs), replay[0]


def phase_serve_features(torch, card):
    """Llama-0.76B on int8 pages with the prefix cache and 4-token drafts,
    on ``tools.serve_features``' traffic (8 requests sharing a 512-token
    prefix, two retrying request 0) and drafter (``RetrievalDrafter``,
    its store filled with request 0's stream once request 0 was served
    alone), graphed (the default) and eager: the streams must be equal,
    the cache must have covered prompt tokens, drafts must have been
    accepted, and every page must come back."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine, page_bytes
    from paddle_tpu_torch.tools.serve_features import (RetrievalDrafter,
                                                       features_traffic)

    cfg = llama_076b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    prefix, requests = features_traffic(np.random.default_rng(3),
                                        cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        drafter = RetrievalDrafter(k=4)
        engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                               max_model_len=2048, token_budget=1024,
                               kv_dtype="int8", prefix_cache=True, spec_k=4,
                               drafter=drafter, cuda_graph=graphed,
                               device="cuda")
        outs, rec = serve_traffic(
            torch, engine, requests, first_alone=lambda p, o: drafter.add(
                np.concatenate([p, o.token_ids])))
        pool = engine.pool
        bf16_bytes = pool.num_pages * page_bytes(
            pool.page_size, pool.n_kv_heads, pool.head_dim, pool.num_layers,
            "bf16")
        rec.update(
            prefix_hit_tokens=engine.stats["prefix_hit_tokens"],
            spec_drafted=engine.stats["spec_drafted"],
            spec_accepted=engine.stats["spec_accepted"],
            cow_copies=pool.cow_copies, pool_bytes=pool.device_bytes(),
            bf16_pool_bytes=bf16_bytes, card=card)
        log(f"serve features ({rec['step']}, int8 pages, prefix cache, "
            f"spec_k 4): " + json.dumps(rec))
        check_k4_counts(f"serve features ({rec['step']})", engine, rec)
        if rec["prefix_hit_tokens"] <= 0 or rec["spec_accepted"] <= 0:
            fail(f"serve features: prefix hits {rec['prefix_hit_tokens']}, "
                 f"accepted drafts {rec['spec_accepted']} (both must be > 0)")
        if pool.used_pages != 0:
            fail(f"serve features: {pool.used_pages} pages in use after the "
                 "run")
        runs[graphed] = (engine, [o.token_ids for o in outs], rec)
    (engine, graphed_streams, rec), (eager, eager_streams, _r) = (
        runs[True], runs[False])
    del eager
    same = graphed_streams == eager_streams
    log(f"serve features: graphed and eager streams "
        f"{'identical' if same else 'DIFFER'} over {len(requests)} requests")
    if not same:
        fail("serve features: the graphed step's streams differ from the "
             "eager one's")
    layer_err, replay_err = features_step(
        torch, engine, prefix, np.random.default_rng(4), 5e-5)
    log(f"serve features step: 3 decode rows x (1 + 4 drafts) on shared "
        f"prefix pages over int8 pages; attention kernel vs plain on the "
        f"same inputs, max over 12 layers {layer_err:.3e}, graph-replayed "
        f"call {replay_err:.3e} (atol=rtol=5e-5) ok")
    pool = engine.pool
    cleared = engine.prefix_cache.clear()
    if pool.used_pages != 0 or len(pool._free) != pool.usable_pages:
        fail(f"serve features: {pool.usable_pages - len(pool._free)} pages "
             f"held after the cache's {cleared} nodes were cleared")
    log(f"serve features: drained, {cleared} cache nodes cleared, all "
        f"{pool.usable_pages} pages free")
    return rec


def lora_products_ms(torch, engine, T):
    """Device ms of one step's LoRA products at ``T`` grid rows: every
    site group of every layer (``AdapterRows.apply_group``, as the trunk
    calls it: q/k/v and gate/up each one A product), rows spread over
    the store's slots, replayed from a CUDA graph."""
    from paddle_tpu_torch.serving import AdapterRows

    store = engine.adapters
    dims = {site: (d_in, d_out) for site, d_in, d_out in store.sites}
    gen = torch.Generator(device="cuda").manual_seed(0)
    slots = torch.arange(T, device="cuda") % store.capacity
    groups = [(g, torch.randn(T, dims[g[0]][0], device="cuda", generator=gen),
               [torch.randn(T, dims[s][1], device="cuda", generator=gen)
                for s in g]) for g in store.group_a]

    def fn():
        rows = AdapterRows(store, slots)
        for layer in range(store.num_layers):
            for g, x, bases in groups:
                rows.apply_group(g, layer, x, bases)

    return graph_ms(torch, fn, launches=5)


def tenancy_checks(torch, engine, rng):
    """On the tenancy engine (idle, its adapters registered): one mixed
    step (decode rows and a prompt chunk, every row on slot 0) computed
    twice, over the registered store and over an empty one, must give
    equal hidden states (slot 0 adds exact zeros); then one live stream
    parked and unparked explicitly must read back every layer's k/v pages
    bit for bit through its new block table, twice (the first pays for
    the pinned host buffers, the second reuses them). Returns the second
    park's and unpark's ms per page, the first's, and the pages moved."""
    from paddle_tpu_torch.serving import AdapterRows, AdapterStore

    vocab = engine.model.config.vocab_size
    for n in (300, 90, 200):
        engine.add_request(rng.integers(0, vocab, n), max_new_tokens=4)
    engine.step()
    engine.add_request(rng.integers(0, vocab, 256), max_new_tokens=2)
    for req in engine.scheduler.admit(1, engine.pool):
        engine._admit(req)
    batch = engine._plan()
    if batch.n_decode != 3 or int(batch.tok_adp.max()) != 0:
        fail(f"tenancy mixed step: {batch.n_decode} decode rows, adapter "
             f"slots {sorted(set(batch.tok_adp.tolist()))}")
    empty = AdapterStore.from_model(engine.model)
    hidden = []
    for store in (engine.adapters, empty):
        def put(a):
            return torch.from_numpy(a).cuda()
        with torch.no_grad():
            hidden.append(engine.trunk.forward_paged(
                put(batch.tok), put(batch.tok_pos), put(batch.tok_bt),
                engine.pool.layer_caches(),
                adapters=AdapterRows(store, put(batch.tok_adp))))
    if len(engine.adapters.names()) != 3 or not torch.equal(*hidden):
        fail("tenancy mixed step: slot-0 rows over a store holding "
             f"{engine.adapters.names()} differ from the empty store's "
             f"(max {float((hidden[0] - hidden[1]).abs().max()):.3e})")
    log(f"tenancy mixed step: {batch.total} rows ({batch.n_decode} decode + "
        f"a 256-token chunk) on slot 0 with adapters "
        f"{list(engine.adapters.names())} registered: hidden states equal "
        "to the empty store's (torch.equal)")
    logits = engine.model.logits(hidden[0][torch.from_numpy(
        batch.sample_rows.reshape(-1)).cuda().long()]).float()
    engine._land(batch, torch.argmax(logits, -1).cpu().numpy())
    engine.run()

    rid = engine.add_request(rng.integers(0, vocab, 333), max_new_tokens=16,
                             prefix_cache=False)
    engine.step()
    _, live = engine._find_slot(rid)
    while live.prefilling or len(live.gen) < 4:
        engine.step()
    pool = engine.pool
    table = pool.block_table(rid)
    n_written = pool.pages_needed(pool.seq_len(rid))
    every = [t for _n, ts in pool._page_tensors() for t in ts]
    before = [t[table[:n_written]].clone() for t in every]
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = engine.park_request(rid)
        t1 = time.perf_counter()
        if moved != n_written or pool.offloaded_pages(rid) != moved:
            fail(f"explicit park moved {moved} of {n_written} written pages")
        back = engine.unpark_request(rid)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        table2 = pool.block_table(rid)
        after = [t[table2[:n_written]] for t in every]
        if back != moved or not all(torch.equal(a, b)
                                    for a, b in zip(after, before)):
            fail("explicit park/unpark did not give back the k/v bytes")
        times.append((1e3 * (t1 - t0) / moved, 1e3 * (t2 - t1) / moved))
        log(f"tenancy park/unpark: {moved} pages of {pool.num_layers} "
            f"layers' k/v moved to pinned host memory in "
            f"{times[-1][0]:.4f} ms/page and back in {times[-1][1]:.4f} "
            f"ms/page (table {table[:3]}... -> {table2[:3]}...), every "
            f"byte equal")
        table = table2
    engine.run()
    return times[1] + times[0] + (moved,)


def phase_serve_tenancy(torch, card):
    """Llama-0.76B with three LoRA adapters, a JSON-schema grammar and the
    host page tier on ``tools.serve_tenancy``'s traffic (12 requests,
    6 at priority 2 then 6 at priority 0 four steps later, the pool
    holding the worst case of 5 streams), graphed and eagerly, with
    adapter ``a2`` hot-swapped at a fixed step: equal streams, one
    captured program per bucket and none recaptured across the swap,
    ``a2``'s streams unlike those of a run without the swap, every
    constrained stream valid, parks and unparks with no late prefetch,
    K4's counts as in the serve phase; then ``tenancy_checks`` and the
    pool empty once the cache is cleared."""
    import gc

    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.tools import serve_tenancy as st

    # earlier phases' engines hold their graphs in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_076b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    requests, fsm = st.tenancy_traffic(np.random.default_rng(7),
                                       cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        engine = st.tenancy_engine(model, cuda_graph=graphed, device="cuda")
        weights = st.register_tenants(engine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        graphs = {}

        def at_swap():
            graphs.update({T: p.graph for T, p in engine._programs.items()})

        pa.reset_counters()
        outs, rec = st.serve_tenancy(
            engine, requests, swap=weights["a2'"], at_swap=at_swap,
            sync=torch.cuda.synchronize)
        rec.update(kernel_launches=pa.kernel_launches,
                   captured_launches=pa.captured_launches,
                   replayed_launches=pa.replayed_launches,
                   plain_calls=pa.plain_calls,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                   memory_before_gib=held_before / 2**30, card=card)
        log(f"serve tenancy ({rec['step']}, bf16 pages, 3 adapters, grammar, "
            f"host tier, spec_k 4): " + json.dumps(rec))
        check_k4_counts(f"serve tenancy ({rec['step']})", engine,
                        dict(rec, steps=rec["model_steps"]))
        if graphed and (len(engine.capture_seconds())
                        != rec["compile_counts"]["step"]):
            fail(f"serve tenancy: {len(engine.capture_seconds())} captures "
                 f"for {rec['compile_counts']}")
        bad = [i for i, (o, r) in enumerate(zip(outs, requests))
               if r["grammar"] is not None and not (
                   fsm.validates(o.token_ids) and o.finish_reason == "stop")]
        if bad:
            fail(f"serve tenancy: constrained requests {bad} do not validate")
        if rec["parks"] < 1 or rec["unparks"] < 1 \
                or rec["kv_prefetch_late_pages"] != 0 \
                or rec["swapped_at_step"] is None:
            fail(f"serve tenancy: parks {rec['parks']}, unparks "
                 f"{rec['unparks']}, late prefetches "
                 f"{rec['kv_prefetch_late_pages']}, swap at "
                 f"{rec['swapped_at_step']}")
        runs[graphed] = (engine, [o.token_ids for o in outs], rec, graphs,
                         weights)
    engine, streams, rec, graphs, weights = runs[True]
    eager_rec = runs[False][2]
    same = streams == runs[False][1]
    del runs
    log(f"serve tenancy: graphed and eager streams "
        f"{'identical' if same else 'DIFFER'} over {len(requests)} requests")
    if not same:
        fail("serve tenancy: the graphed step's streams differ from the "
             "eager one's")
    # the graphs captured before the swap are the ones replayed after it
    if not graphs or any(engine._programs[T].graph is not g
                         for T, g in graphs.items()):
        fail(f"serve tenancy: a step program was recaptured across the "
             f"swap, or none was captured before it ({sorted(graphs)})")
    log(f"serve tenancy: the {len(graphs)} graphs captured before the swap "
        f"(buckets {sorted(graphs)}) replayed after it; "
        f"{rec['compile_counts']}")
    # a2 without the swap: its requests alone on a cold cache, a2 holding
    # its first weights throughout (streams do not depend on batch-mates)
    engine.prefix_cache.clear()
    engine.register_adapter("a2", weights["a2"])
    a2 = [i for i, r in enumerate(requests) if r["adapter_id"] == "a2"]
    rids = [engine.add_request(requests[i]["prompt"], max_new_tokens=64,
                               temperature=requests[i]["temperature"],
                               eos_token_id=st.EOS,
                               seed=requests[i]["seed"], adapter_id="a2",
                               grammar=requests[i]["grammar"]) for i in a2]
    outs = engine.run()
    unswapped = [outs[r].token_ids for r in rids]
    differ = [streams[i] != u for i, u in zip(a2, unswapped)]
    log(f"serve tenancy: a2's {len(a2)} streams against a run without the "
        f"swap: {['differ' if d else 'equal' for d in differ]}")
    if not any(differ):
        fail("serve tenancy: the hot-swapped adapter changed no stream")
    lora8 = lora_products_ms(torch, engine, 8)
    lora64 = lora_products_ms(torch, engine, 64)
    log(f"tenancy LoRA products ({len(engine.adapters.sites)} sites x "
        f"{engine.n_layers} layers, capacity {engine.adapters.capacity}, rank "
        f"{engine.adapters.rank}), graph-replayed: T 8 {lora8:.4f} ms, T 64 "
        f"{lora64:.4f} ms a step")
    park_ms, unpark_ms, park0_ms, unpark0_ms, moved = tenancy_checks(
        torch, engine, np.random.default_rng(8))
    pool = engine.pool
    cleared = engine.prefix_cache.clear()
    if pool.used_pages != 0 or pool.offloaded_pages() != 0 \
            or len(pool._free) != pool.usable_pages:
        fail(f"serve tenancy: {pool.used_pages} pages used, "
             f"{pool.offloaded_pages()} offloaded after the cache's "
             f"{cleared} nodes were cleared")
    summary = {
        "card": card,
        "decode_step_ms_p50": {"graphed": rec["decode_step_ms_p50"],
                               "eager": eager_rec["decode_step_ms_p50"]},
        "auto_offload_ms_per_page": rec["offload_ms_per_page"],
        "auto_prefetch_ms_per_page": rec["prefetch_ms_per_page"],
        "explicit_park_ms_per_page": park_ms,
        "explicit_unpark_ms_per_page": unpark_ms,
        "explicit_first_park_ms_per_page": park0_ms,
        "explicit_first_unpark_ms_per_page": unpark0_ms,
        "explicit_pages": moved,
        "prefix_hit_tokens_cross_adapter":
            rec["prefix_hit_tokens_cross_adapter"],
        "grammar_filtered_drafts": rec["grammar_filtered_drafts"],
        "lora_products_ms": {"T8": lora8, "T64": lora64},
        "peak_memory_gib": rec["peak_memory_gib"],
    }
    log("serve tenancy summary: " + json.dumps(summary))
    return rec


def phase_serve_resilience(torch, card):
    """``tools.serve_chaos``'s six drills on Llama-0.76B, graphed, bf16
    pages of 16 (and int8 pages, and an adapter and a grammar row, for
    the NaN quarantine), the prefill drill on a 2-layer model of the same
    width; K4's counts zeroed just before and read just after: launched
    in every captured bucket and replayed, the plain version never."""
    import gc
    from dataclasses import replace

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.tools import serve_chaos

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_076b()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    nan_model = LlamaForCausalLM(replace(cfg, num_layers=2), device="cuda",
                                 dtype=torch.bfloat16, seed=1)
    made = []
    torch.cuda.synchronize()
    pa.reset_counters()
    t0 = time.perf_counter()
    records = serve_chaos.run_drills(model, nan_model, log=log,
                                     engine_kw=dict(device="cuda"),
                                     made=made)
    torch.cuda.synchronize()
    counts = {"kernel_launches": pa.kernel_launches,
              "captured_launches": pa.captured_launches,
              "replayed_launches": pa.replayed_launches,
              "plain_calls": pa.plain_calls}
    want = sum(e.n_layers * e.compile_counts()["step"] for e in made)
    if not (counts["kernel_launches"] == counts["captured_launches"] == want
            and counts["replayed_launches"] > 0
            and counts["plain_calls"] == 0
            and all(e._graphed for e in made)):
        fail(f"serve resilience: K4 counts {counts}, {want} captured calls "
             f"expected over {len(made)} graphed engines")
    summary = {"card": card, "seconds": time.perf_counter() - t0,
               "engines": len(made), **counts,
               "metrics": records["metrics"]}
    log("serve resilience summary: " + json.dumps(summary))
    del made
    return summary


def gpt13_serving():
    from paddle_tpu_torch.models import gpt3_1_3b

    return gpt3_1_3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def phase_serve_gpt(torch, card):
    """GPT-3 1.3B served twice on the same requests, graphed and eagerly,
    as ``phase_serve`` serves Llama: equal streams, one capture a bucket,
    K4 in every layer of every step and its plain version never. Returns
    the model (the fleet phase routes to it) and the graphed record."""
    import gc

    import numpy as np

    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt13_serving()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    rng = np.random.default_rng(1)
    lengths = rng.integers(64, 1025, 8)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)),
                 0.8 if i in (1, 6) else 0.0, 2000 + i, 64)
                for i, n in enumerate(lengths)]
    runs = {}
    for graphed in (True, False):
        engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                               max_model_len=2048, token_budget=1024,
                               kv_dtype=torch.bfloat16, cuda_graph=graphed,
                               device="cuda", model_id="gpt")
        if graphed:
            log(f"serve gpt: GPT-3 1.3B {n_params / 1e9:.3f} B params "
                f"({', '.join(dtypes)}: O2's rule, LayerNorms f32), vocab "
                f"{cfg.vocab_size}, max_position_embeddings "
                f"{cfg.max_position_embeddings}, pool "
                f"{engine.pool.num_pages} pages, set up in "
                f"{time.perf_counter() - t0:.1f} s")
        outs, rec = serve_traffic(torch, engine, requests)
        rec["card"] = card
        log(f"serve gpt ({rec['step']}): " + json.dumps(rec))
        check_k4_counts(f"serve gpt ({rec['step']})", engine, rec)
        if engine.pool.used_pages != 0:
            fail(f"serve gpt: {engine.pool.used_pages} pages in use after "
                 "the run")
        runs[graphed] = ([o.token_ids for o in outs], rec)
        del engine
    same = runs[True][0] == runs[False][0]
    log(f"serve gpt: graphed and eager streams "
        f"{'identical' if same else 'DIFFER'} over {len(requests)} requests")
    if not same:
        fail("serve gpt: the graphed step's streams differ from the eager "
             "one's")
    return model, runs[True][1]


def phase_serve_fleet(torch, card, gpt_model):
    """``tools.serve_fleet``'s drills (scenarios 7, 9-20 and the
    multi-model one) on Llama-0.76B at full width, graphed, bf16 pages of
    16, with ``gpt_model`` behind the completion API. K4's counts are
    zeroed just before and read just after, in this process and in every
    child of the restart drill (the killed one's up to its last step):
    launched, replayed, and the plain version never."""
    import gc

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.tools import serve_fleet

    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(llama_076b(), device="cuda",
                             dtype=torch.bfloat16, seed=0)
    fleet = serve_fleet.Fleet(model, torch.device("cuda", 0), gpt=gpt_model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nvcc0 = _build.nvcc_runs
    pa.reset_counters()
    t0 = time.perf_counter()
    try:
        records = serve_fleet.run_drills(fleet, log=log)
    except serve_fleet.DrillFailed as e:
        fail(f"serve fleet: {e}")
    torch.cuda.synchronize()
    counts = {"kernel_launches": pa.kernel_launches,
              "captured_launches": pa.captured_launches,
              "replayed_launches": pa.replayed_launches,
              "plain_calls": pa.plain_calls}
    children = records["kill-serving-process-mid-decode"]["child_counts"]
    launches = counts["kernel_launches"] + counts["replayed_launches"]
    for name, c in children.items():
        if c["plain_calls"] != 0 or c["kernel_launches"] == 0 \
                or c["replayed_launches"] == 0 or c["nvcc_runs"] != 0:
            fail(f"serve fleet: restart child {name}: K4 counts {c}")
        launches += c["kernel_launches"] + c["replayed_launches"]
    if counts["plain_calls"] != 0 or counts["replayed_launches"] == 0 \
            or counts["captured_launches"] == 0:
        fail(f"serve fleet: K4 counts {counts}")
    if _build.nvcc_runs != nvcc0:
        fail("serve fleet: a kernel was built during the drills")
    restart = records["kill-serving-process-mid-decode"]
    summary = {
        "card": card, "seconds": time.perf_counter() - t0,
        "drill_seconds": {k: r["seconds"] for k, r in records.items()},
        "migrations": sum(r["migrations"] for r in records.values()),
        "engines": sum(r["engines"] for r in records.values()),
        "captures": sum(r["captures"] for r in records.values()),
        "capture_s": sum(r["capture_s"] for r in records.values()),
        "wal_fsyncs_per_step": restart["wal_fsyncs_per_step"],
        "wal_fsync_ms_per_step": restart["wal_fsync_ms_per_step"],
        "recover_s": restart["recover_s"], "rto_s": restart["rto_s"],
        "recover_captures": restart["recover_captures"],
        "recover_nvcc_runs": restart["recover_nvcc_runs"],
        "autoscale_new_engine_captures":
            records["autoscale-under-burst"]["new_engine_captures"],
        "autoscale_capture_s": records["autoscale-under-burst"]["capture_s"],
        "reload_s_per_engine":
            records["router-rolling-reload"]["reload_s_per_engine"],
        "reload_save_s": records["router-rolling-reload"]["save_s"],
        "reload_k4_launches": records["router-rolling-reload"]["k4_launches"],
        "fuzz_reloads": records["thread-fuzz-control-plane"]["reloads"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        **counts, "child_counts": children, "launches": launches}
    if summary["reload_k4_launches"] == 0 or summary["fuzz_reloads"] < 2:
        fail(f"serve fleet: the reload drills: K4 launches "
             f"{summary['reload_k4_launches']}, fuzz reloads "
             f"{summary['fuzz_reloads']}")
    log("serve fleet summary: " + json.dumps(summary, default=str))
    log(f"reload ({card}): {summary['reload_s_per_engine']:.3f} s per "
        f"engine (drain of the live requests, restore, in-place load, "
        f"canary), donor save {summary['reload_save_s']:.3f} s")
    del fleet, model
    return summary


def phase_reference(torch):
    """A small f32 Llama (GQA), then a small f32 GPT, each served on the
    card, graphed, with the prefix cache and 2-token drafts, and on the
    CPU through the plain version with both off: the same token streams.
    The fifth request shares the first one's two full pages; the sixth
    runs on a LoRA adapter (the same seeded weights on both) and the
    seventh under a grammar, whose stream must validate."""
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)

    reference_streams(torch, "llama", LlamaForCausalLM, llama_tiny(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_key_value_heads=2, max_position_embeddings=256))
    reference_streams(torch, "gpt", GPTForCausalLM, gpt_tiny(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        max_position_embeddings=256))


def reference_streams(torch, name, model_cls, cfg):
    import numpy as np

    from paddle_tpu_torch.serving import (GrammarFSM, ServingEngine,
                                          random_adapter, toy_tokenizer)

    rng = np.random.default_rng(2)
    work = [(rng.integers(0, 256, int(n)), t, s) for n, t, s in
            ((40, 0.0, 0), (7, 0.8, 1), (130, 0.0, 2), (64, 0.8, 3))]
    work.append((np.concatenate([work[0][0][:35], rng.integers(0, 256, 20)]),
                 0.0, 4))
    fsm = GrammarFSM.compile({"enum": ["red", "green", "blue"]},
                             toy_tokenizer(256))
    tenancy = [dict(adapter_id="t1"), dict(grammar=fsm)]
    work += [(rng.integers(0, 256, 50), 0.8, 5), (rng.integers(0, 256, 20),
                                                  0.0, 6)]
    streams, stats = {}, {}
    for dev, kw in (("cuda", dict(spec_k=2)),
                    ("cpu", dict(prefix_cache=False))):
        model = model_cls(cfg, device="cpu", seed=5).to(dev)
        eng = ServingEngine(model, page_size=16, max_batch_slots=3,
                            token_budget=48, device=dev, **kw)
        eng.register_adapter("t1", random_adapter(eng.adapters, seed=9,
                                                  scale=0.2))
        rids = [eng.add_request(p, max_new_tokens=12, temperature=t, seed=s,
                                **(tenancy[i - 5] if i >= 5 else {}))
                for i, (p, t, s) in enumerate(work)]
        outs = eng.run()
        streams[dev] = [outs[r].token_ids for r in rids]
        stats[dev] = {k: eng.stats[k] for k in (
            "prefix_hit_tokens", "spec_drafted", "spec_accepted",
            "grammar_tokens")}
        stats[dev]["compile_counts"] = eng.compile_counts()
    same = streams["cuda"] == streams["cpu"]
    card = stats["cuda"]
    log(f"reference: small f32 {name}, card (graphed, prefix cache, spec_k 2: "
        f"{json.dumps(card)}) vs CPU (plain, both off) streams "
        f"{'identical' if same else 'DIFFER'} over {len(work)} requests, one "
        f"on a LoRA adapter, one under a grammar")
    if not same or not fsm.validates(streams["cuda"][6]):
        fail(f"{name}: streams differ, or the constrained one is invalid: "
             f"{streams}")
    cc = card["compile_counts"]
    if card["prefix_hit_tokens"] <= 0 or card["spec_drafted"] <= 0 \
            or cc["step"] != cc["step_buckets"]:
        fail(f"reference {name}: the card run took no prefix hit or no "
             f"draft, or its compile counts differ: {card}")


# ───────────────────────────── training ─────────────────────────────


def phase_train(torch, card, model):
    """``model``'s bench through its entry point as it runs by default
    (the step through ``jit.StaticFunction``: an eager first call, then a
    CUDA graph captured and replayed), full width and depth, 8 steps. The
    flash counts are zeroed just before and read just after: each kernel
    launched as often a step as the model's layers run it (``per_layer``:
    K1 twice under recompute), eagerly in the first step, recorded once
    by the capture and replayed in the 7 others (captured + replayed =
    ``per_layer`` x layers x steps), the plain versions never."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = bench.SETUPS[model](False)[0]
    rc = bool(getattr(cfg, "recompute", False))
    per_layer = {"flash_fwd": 2 if rc else 1, "flash_dq": 1, "flash_dkv": 1}
    reset_train_counts(fa)
    t0 = time.perf_counter()
    rec = bench.bench_model(model, small=False, device="cuda", steps=5,
                            reps=1)
    wall = time.perf_counter() - t0
    counts = flash_counts(fa)
    note_embedding(f"train_{model}")
    losses = rec.pop("losses")
    steps = rec.pop("steps_run")
    summary = dict(rec, steps_run=steps, wall_s=wall, losses=losses,
                   **counts, card=card)
    log(f"train {model}: " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses):
        fail(f"train {model}: a loss is not finite: {losses}")
    check_graphed_counts(f"train {model}", counts, per_layer,
                         cfg.num_layers, steps)
    return ran(counts), summary


def flash_counts(fa):
    return {"kernel_launches": dict(fa.kernel_launches),
            "captured_launches": dict(fa.captured_launches),
            "replayed_launches": dict(fa.replayed_launches),
            "plain_calls": dict(fa.plain_calls)}


def ran(counts):
    """Launches each flash kernel made on the card: eager ones and those
    of graph replays."""
    return {n: counts["kernel_launches"][n] + counts["replayed_launches"][n]
            for n in counts["kernel_launches"]}


# The embedding backward kernel's launches (eager and graph-replayed) on
# each training path: zeroed with K1-K3's just before that path's run
# (``reset_train_counts``) and read just after it (``note_embedding``)
EMB_BY_PATH = {}


def reset_train_counts(fa):
    from paddle_tpu_torch.ops import embedding_grad as eg

    fa.reset_counters()
    eg.reset_counters()


def note_embedding(path):
    """Record the embedding backward's launches on ``path``'s run, which
    looked rows up and took their gradient: the kernel must have
    launched, and its plain version never."""
    from paddle_tpu_torch.ops import embedding_grad as eg

    if eg.launches() == 0 or eg.plain_calls:
        fail(f"{path}: the embedding backward kernel launched "
             f"{eg.launches()} times, its plain version {eg.plain_calls}")
    EMB_BY_PATH[path] = eg.launches()


def check_graphed_counts(label, counts, per_layer, layers, steps):
    """A ``StaticFunction`` step run ``steps`` times on one signature: one
    eager step, one capture, ``steps - 1`` replays; the plain versions
    never."""
    one = {n: k * layers for n, k in per_layer.items()}
    want = {"kernel_launches": one, "captured_launches": one,
            "replayed_launches": {n: k * (steps - 1) for n, k in one.items()},
            "plain_calls": dict.fromkeys(one, 0)}
    total = {n: counts["captured_launches"][n]
             + counts["replayed_launches"][n] for n in one}
    if counts != want or total != {n: k * steps for n, k in one.items()}:
        fail(f"{label}: flash counts {counts} != {want} ({layers} layers x "
             f"{steps} steps: captured + replayed = per_layer x layers x "
             f"steps)")


def jit_compiles(fn):
    from paddle_tpu_torch.metrics import get_registry

    return get_registry().counter(
        "paddle_tpu_jit_compiles_total", labels=("fn", "source")).labels(
            fn=fn, source="fresh").value


def phase_train_graphed(torch, card, model):
    """``model``'s bench at full width and depth, 8 steps eagerly
    (``--eager``) and then, rebuilt from the same seed, 8 steps through
    ``StaticFunction``: the losses and the final parameters must be equal
    bit for bit, the step must have one signature and one capture
    (``paddle_tpu_jit_compiles_total`` up by 1), and the flash counts of
    the graphed run as in ``phase_train``. Then one more graphed and one
    more eager run in turns, for the step ms. Prints step ms graphed
    against eager, ``capture_s`` and the peak memory of both."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = bench.SETUPS[model](False)[0]
    rc = bool(getattr(cfg, "recompute", False))
    per_layer = {"flash_fwd": 2 if rc else 1, "flash_dq": 1, "flash_dkv": 1}
    runs = {}
    for kind in ("eager", "graphed"):
        reset_train_counts(fa)
        before = jit_compiles("train_fn")
        rec, net, opt = bench.train_run(model, device="cuda", steps=5,
                                        reps=1, eager=kind == "eager")
        counts = flash_counts(fa)
        if kind == "graphed":
            note_embedding(f"train_graphed_{model}")
        rec["jit_compiles"] = jit_compiles("train_fn") - before
        runs[kind] = (rec, [getattr(p, "_value", p).detach().clone()
                            for p in net.parameters()], counts)
        del net, opt
        torch.cuda.empty_cache()
    (r_e, p_e, c_e), (r_g, p_g, c_g) = runs["eager"], runs["graphed"]
    differ = [i for i, (a, b) in enumerate(zip(p_e, p_g))
              if not torch.equal(a, b)]
    same_losses = r_e["losses"] == r_g["losses"]
    del p_e, p_g, runs
    torch.cuda.empty_cache()
    turns = []
    for kind in ("graphed", "eager"):
        r = bench.bench_model(model, device="cuda", steps=5, reps=1,
                              eager=kind == "eager")
        turns.append((kind, r["step_ms"], r["peak_memory_gib"]))
        torch.cuda.empty_cache()
    steps = r_g["steps_run"]
    summary = {
        "model": model, "steps": steps, "losses_equal": same_losses,
        "tokens_per_s": {"eager": r_e["value"], "graphed": r_g["value"]},
        "mfu": {"eager": r_e["mfu"], "graphed": r_g["mfu"]},
        "params_differ": len(differ), "losses": r_g["losses"],
        "step_ms": {"eager": r_e["step_ms"], "graphed": r_g["step_ms"]},
        "turns_step_ms": turns, "capture_s": r_g["capture_s"],
        "first_step_s": {"eager": r_e["compile_s"],
                         "graphed": r_g["compile_s"]},
        "peak_memory_gib": {"eager": r_e["peak_memory_gib"],
                            "graphed": r_g["peak_memory_gib"]},
        "compile_counts": r_g["compile_counts"],
        "jit_compiles": r_g["jit_compiles"], "graphed_counts": c_g,
        "eager_counts": c_e, "card": card}
    log(f"train graphed {model}: " + json.dumps(summary))
    log(f"train graphed {model}: step {r_g['step_ms']} ms graphed vs "
        f"{r_e['step_ms']} ms eager (turns: " + ", ".join(
            f"{k} {ms} ms" for k, ms, _m in turns)
        + f"); capture {r_g['capture_s']} s; peak "
        f"{r_g['peak_memory_gib']} vs {r_e['peak_memory_gib']} GiB; "
        + ("losses and parameters equal bit for bit" if same_losses
           and not differ else "DIFFER"))
    if not same_losses or differ:
        fail(f"train graphed {model}: graphed and eager differ (losses "
             f"{r_g['losses']} vs {r_e['losses']}; {len(differ)} "
             f"parameters differ, first {differ[:5]})")
    if r_g["compile_counts"] != {"signatures": 1, "captured": 1,
                                 "calls": steps} \
            or r_g["jit_compiles"] != 1:
        fail(f"train graphed {model}: not one capture of one signature: "
             f"{r_g['compile_counts']}, jit_compiles_total "
             f"+{r_g['jit_compiles']}")
    check_graphed_counts(f"train graphed {model}", c_g, per_layer,
                         cfg.num_layers, steps)
    eager_want = {n: k * cfg.num_layers * steps for n, k in per_layer.items()}
    if c_e["kernel_launches"] != eager_want or any(
            sum(c_e[k].values()) for k in ("captured_launches",
                                           "replayed_launches",
                                           "plain_calls")):
        fail(f"train graphed {model}: the eager run's flash counts "
             f"{c_e} != {eager_want} launches")
    return ran(c_g), summary


def phase_train_bert(torch, card):
    """BERT-base's pretraining step (``bench --model bert``: B 32, S 128,
    O2 bf16 with master weights, dropout 0.1 on the hidden states and in
    attention) on its three paths: the bench's graphed step
    (``phase_train``: 8 steps, 12 launches of each flash kernel a step);
    8 steps graphed against 8 eager from the same weights and seeds
    (``phase_train_graphed``: bit-equal losses and parameters, one
    capture); and ``bert_masked_step``. Returns the launches of each
    path and the graphed phase's summary."""
    bench_launches, _ = phase_train(torch, card, "bert")
    torch.cuda.empty_cache()
    graphed, summary = phase_train_graphed(torch, card, "bert")
    torch.cuda.empty_cache()
    masked = bert_masked_step(torch, card)
    torch.cuda.empty_cache()
    log(f"train bert: {summary['tokens_per_s']['graphed']} tokens/s "
        f"graphed, {summary['tokens_per_s']['eager']} eager; step "
        f"{summary['step_ms']['graphed']} ms graphed, "
        f"{summary['step_ms']['eager']} ms eager; MFU "
        f"{summary['mfu']['graphed']}; peak {summary['peak_memory_gib']} "
        f"GiB; capture {summary['capture_s']} s ({card})")
    return {"train_bert": bench_launches, "train_graphed_bert": graphed,
            "train_bert_masked": masked}, summary


def bert_masked_step(torch, card):
    """The bench's BERT step with an ``attention_mask`` in which 8 of the
    32 rows keep a random length of their 128 tokens: its bool [B, 1, 1,
    S] form sends K1-K3 through key padding. Three calls of one
    ``StaticFunction`` signature (eager, capture and replay, replay), each
    loss finite, the counts those of 12 layers a step; then, in eval, the
    encoder's output with the mask against without: the padded rows
    move, the others agree at the bf16 flash check's norm tolerance."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, bench, jit
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg, B, S, _ = bench.SETUPS["bert"](False)
    model, opt = bench.build(cfg, torch.device("cuda"), None)
    step = jit.StaticFunction(bench.make_bert_train_fn(model, opt),
                              observe=[model, opt], warmup=False)
    ids, mlm, nsp = bench.bert_data(cfg, B, S, "cuda")
    rng = np.random.default_rng(1)
    mask = np.ones((B, S), np.int64)
    for row in rng.choice(B, B // 4, replace=False):
        mask[row, rng.integers(1, S):] = 0
    am = paddle.to_tensor(mask, place="cuda")
    reset_train_counts(fa)
    losses = [float(step(ids, mlm, nsp, am)) for _ in range(3)]
    counts = flash_counts(fa)
    note_embedding("train_bert_masked")
    log(f"train bert masked: losses {losses}, padded rows "
        f"{int((mask.sum(1) < S).sum())}, {step.compile_counts()}, "
        f"counts {counts} ({card})")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train bert masked: a loss is not finite: {losses}")
    if step.compile_counts() != {"signatures": 1, "captured": 1,
                                 "calls": 3}:
        fail(f"train bert masked: not one capture: {step.compile_counts()}")
    check_graphed_counts("train bert masked", counts,
                         dict.fromkeys(fa.KERNELS, 1), cfg.num_layers, 3)
    # the mask reaches attention: in eval (no dropout) the padded rows'
    # sequence outputs move and the others stay within the bf16 check
    model.eval()
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        masked = model.bert(ids, attention_mask=am)[0]._value.float()
        plain = model.bert(ids)[0]._value.float()
    padded = torch.from_numpy(mask.sum(1) < S).to("cuda")
    moved = float((masked[padded] - plain[padded]).abs().max())
    _ok, _m, rel_kept = held(torch, masked[~padded], plain[~padded],
                             FLASH_TOL["bf16"])
    log(f"train bert masked: eval forward, padded rows moved by up to "
        f"{moved:.3e}, unpadded rows' norm-relative difference "
        f"{rel_kept:.2e}")
    if not moved > 1e-3 or rel_kept > FLASH_TOL["bf16"][2]:
        fail("train bert masked: the attention mask did not reach the "
             f"encoder (padded rows moved {moved}, the others {rel_kept})")
    del model, opt, step
    return ran(counts)


def state_step(torch, graphed):
    """The small GPT's step of ``phase_train_graphed_state``, built from
    ``generator.seed(0)``: ``(step, (ids, labels), model, scaler)``. The
    step scales ``loss * mult`` by the ``GradScaler``, steps the
    optimizer through it and returns the loss and a dropout mask of a
    fixed ones tensor."""
    import numpy as np

    from paddle_tpu_torch import amp, generator, jit
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup

    generator.seed(0)
    cfg = gpt_tiny(vocab_size=2048, hidden_size=256, num_layers=4,
                   num_heads=2, max_position_embeddings=512,
                   hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                   fused_loss=True)
    model = GPTForCausalLM(cfg, device="cuda")
    sched = LinearWarmup(learning_rate=1e-3, warmup_steps=4, start_lr=0.0,
                         end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            incr_every_n_steps=2, decr_every_n_nan_or_inf=1,
                            device="cuda")
    ones = torch.ones((64, 256), device="cuda")

    def train_fn(ids, labels, mult):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = model(ids, labels=labels)
        scaler.scale(loss * mult).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss, F.dropout(ones, 0.1)

    step = (jit.StaticFunction(train_fn, observe=[model, opt, scaler])
            if graphed else train_fn)
    ids_np = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 256))
    args = (torch.from_numpy(ids_np).to("cuda"),
            torch.from_numpy(np.roll(ids_np, -1, axis=1)).to("cuda"))
    return step, args, model, scaler, sched


def phase_train_graphed_state(torch, card):
    """A small GPT (hidden 256, 4 layers, 2 heads of 128, S 256) with
    attention and hidden dropout 0.1, O2 bf16 with master weights,
    ``GradScaler(init_loss_scaling=2**15, incr_every_n_steps=2,
    decr_every_n_nan_or_inf=1)``, ``ClipGradByGlobalNorm(1.0)`` and a
    ``LinearWarmup`` scheduler stepped after each call; the loss is
    multiplied by an input that is inf on step 3. Six steps eagerly, then
    six through ``StaticFunction`` from the same seed: equal bit for bit
    (losses, dropout masks, every parameter after every step, the scale
    and both counters); step 3 skipped inside the graph (parameters as
    after step 2) and the scale halved; masks that differ from step to
    step; one signature, one capture."""
    from paddle_tpu_torch.ops import flash_attention as fa

    runs = {}
    for graphed in (False, True):
        step, args, model, scaler, sched = state_step(torch, graphed)
        reset_train_counts(fa)
        hist = []
        for i in range(6):
            mult = torch.full((), math.inf if i == 2 else 1.0,
                              device="cuda")
            loss, mask = step(*args, mult)
            hist.append({
                "loss": loss.detach().clone(), "mask": mask.clone(),
                "params": [p.detach().clone() for p in model.parameters()],
                "cells": [c.clone() for c in scaler.__jit_state__()]})
            sched.step()
        torch.cuda.synchronize()
        if graphed:
            note_embedding("train_graphed_state")
        runs[graphed] = (hist, flash_counts(fa),
                         step.compile_counts() if graphed else None)
    (h_e, c_e, _), (h_g, c_g, cc) = runs[False], runs[True]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    equal = [h_e[i]["loss"].equal(h_g[i]["loss"])
             and h_e[i]["mask"].equal(h_g[i]["mask"])
             and same(h_e[i]["params"], h_g[i]["params"])
             and same(h_e[i]["cells"], h_g[i]["cells"]) for i in range(6)]
    skipped = same(h_g[2]["params"], h_g[1]["params"])
    scales = [float(h["cells"][0]) for h in h_g]
    counters = [(int(h["cells"][1]), int(h["cells"][2])) for h in h_g]
    masks_differ = all(not h_g[i]["mask"].equal(h_g[i + 1]["mask"])
                       for i in range(5))
    updated = not same(h_g[3]["params"], h_g[2]["params"])
    rec = {"steps_equal": equal, "step3_skipped": skipped,
           "step4_updated": updated, "scales": scales,
           "good_bad": counters, "masks_differ": masks_differ,
           "losses": [float(h["loss"]) for h in h_g],
           "compile_counts": cc, "graphed_counts": c_g, "eager_counts": c_e,
           "card": card}
    log("train graphed state: " + json.dumps(rec))
    if not all(equal) or not skipped or not updated or not masks_differ:
        fail(f"train graphed state: graphed vs eager equal per step "
             f"{equal}, step 3 skipped {skipped}, step 4 updated "
             f"{updated}, masks differ {masks_differ}")
    if scales[2] != scales[1] / 2 or cc != {"signatures": 1, "captured": 1,
                                            "calls": 6}:
        fail(f"train graphed state: the scale did not halve on the inf "
             f"step ({scales}), or not one capture: {cc}")
    check_graphed_counts("train graphed state", c_g, dict.fromkeys(
        fa.KERNELS, 1), 4, 6)
    return ran(c_g), rec


def phase_train_reference(torch, model):
    """A small f32 model takes three AdamW steps on the card (the flash
    kernels) and on the CPU (their plain versions) from the same weights
    and tokens: GPT (2 layers, hidden 256, 2 heads of 128) or Llama (2
    layers, hidden 256, 4 heads of 64 over 2 KV heads, recompute on), S
    512. Tolerance atol = rtol = 1e-4 on the losses and on every
    parameter: both run the same f32 math with summation orders of their
    own (TF32 is off), and ``epsilon=1e-6`` keeps Adam from turning the
    sign of a near-zero grad into a full step."""
    import copy

    import numpy as np

    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops import flash_attention as fa

    if model == "gpt":
        cfg = gpt_tiny(vocab_size=2048, hidden_size=256, num_layers=2,
                       num_heads=2, max_position_embeddings=512,
                       fused_loss=True)
        base = GPTForCausalLM(cfg, device="cpu", seed=11)
        per_step = dict.fromkeys(fa.KERNELS, 2)
    else:
        cfg = llama_tiny(vocab_size=2048, hidden_size=256, num_layers=2,
                         num_heads=4, num_key_value_heads=2,
                         max_position_embeddings=512, recompute=True,
                         fused_loss=True)
        base = LlamaForCausalLM(cfg, device="cpu", seed=11)
        per_step = {"flash_fwd": 4, "flash_dq": 2, "flash_dkv": 2}
    ids_np = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 512))
    runs = {}
    for dev in ("cuda", "cpu"):
        net = copy.deepcopy(base).to(dev)
        opt = AdamW(learning_rate=1e-3, epsilon=1e-6,
                    parameters=net.named_parameters())
        ids = torch.from_numpy(ids_np).to(dev)
        labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).to(dev)
        fa.reset_counters()
        losses = []
        for _ in range(3):
            _, loss = net(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        used = dict(fa.kernel_launches if dev == "cuda" else fa.plain_calls)
        runs[dev] = (losses, {n: p.detach().cpu() for n, p in
                              net.named_parameters()}, used)
    (l_gpu, p_gpu, used_gpu), (l_cpu, p_cpu, used_cpu) = (runs["cuda"],
                                                          runs["cpu"])
    tol = 1e-4
    loss_err = max(abs(a - b) for a, b in zip(l_gpu, l_cpu))
    ok = all(abs(a - b) <= tol + tol * abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = 0.0
    for n, want in p_cpu.items():
        err = (p_gpu[n] - want).abs()
        param_err = max(param_err, float(err.max()))
        ok &= bool((err <= tol + tol * want.abs()).all())
    log(f"train reference: small f32 {model}, 3 AdamW steps, card (kernels "
        f"{used_gpu}) vs CPU (plain {used_cpu}): losses {l_gpu} vs {l_cpu}, "
        f"max loss err {loss_err:.2e}, max param err {param_err:.2e} "
        f"(atol=rtol={tol:g}) {'ok' if ok else 'MISMATCH'}")
    want_used = {n: 3 * k for n, k in per_step.items()}
    if not ok or used_gpu != want_used or used_cpu != want_used:
        fail(f"train reference {model}: card and CPU runs disagree, or a "
             "run did not take its path")


def phase_adamw_path(torch):
    """K5's path, ``tools.bench_adamw``, with K5's counts zeroed just
    before and read just after."""
    from paddle_tpu_torch.ops import fused_adamw as k5
    from paddle_tpu_torch.tools import bench_adamw

    k5.reset_counters()
    rec = bench_adamw.bench_adamw(device="cuda")
    launches, plain = k5.kernel_launches, k5.plain_calls
    log("adamw path: " + json.dumps(dict(rec, kernel_launches=launches,
                                         plain_calls=plain)))
    if launches == 0 or plain != 0:
        fail(f"adamw path: K5 launched {launches} times, plain version "
             f"{plain} times")
    return launches


# ───────────────────────────── facade ─────────────────────────────


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _as_np(paddle, o):
    """(dtype name, numpy value) of an op's output."""
    import numpy as np

    if isinstance(o, paddle.Tensor):
        return paddle.dtypes.dtype_name(o.dtype), o.numpy()
    return type(o).__name__, np.asarray(o)


def case_run(paddle, case, dt, device, grad=False):
    """One op case on ``device``: its outputs as (dtype, array) pairs,
    or with ``grad`` the gradients of the sum of its outputs with respect
    to its f32 inputs."""
    paddle.set_device(device)
    inputs = case.make("float32" if grad else dt)
    ts = [paddle.to_tensor(x, stop_gradient=not grad) for x in inputs]
    outs = _flat(case.call(paddle, *ts))
    if not grad:
        return [_as_np(paddle, o) for o in outs]
    loss = None
    for o in outs:
        s = o.sum() if o.ndim > 0 else o
        loss = s if loss is None else loss + s
    loss.backward()
    return [("float32", t.grad.numpy()) for t in ts]


def facade_ops(torch, paddle):
    """(a) Every registry case of the op library (``tools/op_cases``) on
    ``cuda`` and on the CPU from the same numpy inputs: outputs at the
    case's tolerance with equal dtypes, and the grad cases' grads at
    1e-4. Returns the number of cases and seconds."""
    import numpy as np

    from paddle_tpu_torch.tools.op_cases import CASES, tol

    t0 = time.perf_counter()
    runs, bad = 0, []
    for name, case in sorted(CASES.items()):
        checks = [(dt, False, tol(case, dt)) for dt in case.dtypes]
        if case.grad:
            checks.append(("float32", True, 1e-4))
        for dt, grad, t in checks:
            runs += 1
            try:
                got = case_run(paddle, case, dt, "cuda", grad)
                want = case_run(paddle, case, dt, "cpu", grad)
            except Exception as e:  # noqa: BLE001 - reported, then fail
                bad.append(f"{name}[{dt}{' grad' if grad else ''}]: "
                           f"{type(e).__name__}: {e}")
                continue
            what = f"{name}[{dt}{' grad' if grad else ''}]"
            if len(got) != len(want):
                bad.append(f"{what}: {len(got)} outputs vs {len(want)}")
                continue
            for i, ((gd, g), (wd, w)) in enumerate(zip(got, want)):
                if gd != wd or g.shape != w.shape or not np.allclose(
                        g, w, atol=t, rtol=t, equal_nan=True):
                    bad.append(f"{what} output {i}: cuda {gd}{g.shape} vs "
                               f"cpu {wd}{w.shape}, max err "
                               f"{np.max(np.abs(g - w)) if g.shape == w.shape and g.size else 'n/a'}")
    paddle.set_device(None)
    secs = time.perf_counter() - t0
    log(f"facade ops: {len(CASES)} registry cases, {runs} runs (dtypes and "
        f"grads) on cuda against the CPU in {secs:.1f} s: "
        + ("ok" if not bad else f"{len(bad)} MISMATCH"))
    for b in bad:
        log(f"  {b}")
    if bad:
        fail(f"facade ops: {len(bad)} case(s) differ between cuda and CPU")
    return {"cases": len(CASES), "runs": runs, "seconds": secs}


def facade_attention(torch, paddle):
    """(b) GPT-3 1.3B's attention written in facade ops (B 8, S 1024, 16
    heads of 128, bf16): QKV = ``paddle.matmul`` of an activation by a
    ``Parameter``, ``paddle.reshape`` and ``paddle.split`` into strided
    q, k, v, then ``F.scaled_dot_product_attention(is_causal=True)``, a
    ``paddle.mean`` loss and ``loss.backward()``. K1, K2 and K3 must
    launch once each and the plain versions never; the output and the
    grads of q, k and v are held against the plain flash versions on the
    same inputs at ``FLASH_TOL``."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, D = 8, 1024, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = paddle.Tensor(torch.randn((B, S, H * D), generator=gen,
                                  device="cuda").to(torch.bfloat16),
                      stop_gradient=False)
    w = paddle.Parameter((torch.randn((H * D, 3 * H * D), generator=gen,
                                      device="cuda") * 0.02).to(
                                          torch.bfloat16))
    grads = {}
    fa.reset_counters()
    qkv = paddle.reshape(paddle.matmul(x, w), [B, S, 3 * H, D])
    q, k, v = paddle.split(qkv, 3, axis=2)
    for label, t in (("dq", q), ("dk", k), ("dv", v)):
        t.register_hook(lambda g, label=label: grads.__setitem__(label, g))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    out.register_hook(lambda g: grads.__setitem__("do", g))
    loss = paddle.mean(out)
    loss.backward()
    torch.cuda.synchronize()
    launches, plain = dict(fa.kernel_launches), dict(fa.plain_calls)
    want = flash_plain(fa, q._value.detach(), k._value.detach(),
                       v._value.detach(), grads["do"]._value, True, D ** -0.5,
                       0.0, 0, None)
    tol = FLASH_TOL["bf16"]
    res = {}
    for label, got, ref in (("o", out._value.detach(), want[0]),
                            ("dq", grads["dq"]._value, want[2]),
                            ("dk", grads["dk"]._value, want[3]),
                            ("dv", grads["dv"]._value, want[4])):
        res[label] = held(torch, got, ref, tol)
    ok = all(r[0] for r in res.values())
    log(f"facade attention: B={B} S={S} H={H} D={D} bf16, strided q/k/v "
        f"from paddle.matmul/reshape/split, loss {float(loss):.6e}; "
        f"launches {launches}, plain {plain}; vs plain flash: "
        + " ".join(f"{n} max {m:.2e} rel {r:.2e}" for n, (_ok, m, r)
                   in res.items())
        + f" (atol {tol[0]:g}, rtol {tol[1]:g}, rel {tol[2]:g}) "
        + ("ok" if ok else "MISMATCH"))
    if launches != dict.fromkeys(fa.KERNELS, 1) or any(plain.values()):
        fail(f"facade attention: flash launches {launches} != 1 each, or "
             f"plain calls {plain} != 0")
    if not ok or x.grad is None or w.grad is None:
        fail("facade attention: a kernel's output or grad disagrees with "
             "the plain version, or x/W got no grad")
    return launches


def facade_double_grad(torch, paddle):
    """``paddle.grad(create_graph=True)`` on the card through an
    elementwise and matmul chain, f64: u = x W, y = sum(u^3), g = dy/dx =
    3 u^2 W^T, and d sum(g)/dx = 6 (u * colsum(W)) W^T, analytically."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    xv = torch.randn((64, 48), generator=gen, device="cuda",
                     dtype=torch.float64)
    wv = torch.randn((48, 32), generator=gen, device="cuda",
                     dtype=torch.float64)
    x = paddle.Tensor(xv, stop_gradient=False)
    w = paddle.Tensor(wv, stop_gradient=False)
    y = paddle.sum(paddle.pow(paddle.matmul(x, w), 3))
    (g,) = paddle.grad(y, [x], create_graph=True)
    (h,) = paddle.grad(paddle.sum(g), [x])
    u = xv @ wv
    g_want = 3 * (u * u) @ wv.T
    h_want = 6 * (u * wv.sum(0)[None, :]) @ wv.T
    gv, hv = g._value.detach(), h._value
    err = max(float((gv - g_want).abs().max() / g_want.abs().max()),
              float((hv - h_want).abs().max() / h_want.abs().max()))
    log(f"facade double grad: cuda f64, first and second derivative vs "
        f"analytic, max rel err {err:.2e} (limit 1e-12) "
        + ("ok" if err <= 1e-12 else "MISMATCH"))
    if err > 1e-12 or g.stop_gradient:
        fail("facade double grad disagrees with the analytic derivative")


def facade_host_cost(torch, paddle):
    """The facade's host cost per op: 10,000 calls each of a small
    ``paddle.add`` and ``paddle.matmul`` on ``cuda`` against the bare
    torch call, wall clock, one synchronisation at the end."""
    paddle.set_device("cuda")
    a = paddle.ones([16, 16])
    paddle.set_device(None)
    av = a._value
    out = {}
    for name, fac, bare in (
            ("add", lambda: paddle.add(a, a), lambda: torch.add(av, av)),
            ("matmul", lambda: paddle.matmul(a, a),
             lambda: torch.matmul(av, av))):
        times = {}
        for label, fn in (("bare", bare), ("facade", fac), ("bare", bare),
                          ("facade", fac)):
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10_000):
                fn()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / 10_000 * 1e6
            times[label] = min(times.get(label, us), us)
        out[name] = dict(bare_us=times["bare"], facade_us=times["facade"],
                         overhead_us=times["facade"] - times["bare"])
    log("facade host cost (10,000 calls, 16x16 f32 on cuda, best of two "
        "rounds): " + ", ".join(
            f"{n} {r['facade_us']:.2f} us vs torch {r['bare_us']:.2f} us "
            f"(+{r['overhead_us']:.2f})" for n, r in out.items()))
    return out


def facade_train(torch, card, gpt13):
    """(c) The root bench.py's gpt13 step verbatim through the facade
    (``bench.facade_step``: GPT-3 1.3B, B 8, S 1024, O2 bf16 without
    master weights, fused CE, AdamW 1e-4, ``paddle.seed(0)``,
    ``paddle.to_tensor`` ids from numpy seed 0, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``, ``loss.numpy()``), 8 steps (1
    + 2 warm + 5 timed). K1-K3 must launch 24 times a step each and the
    plain versions never; every loss finite, compared with phase ``train
    gpt13``'s (the same weights and ids through torch tensors)."""
    import numpy as np

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg, B, S, _ = bench.gpt13_setup(False)
    step, args, model, opt = bench.facade_step(cfg, B, S)
    kept = []

    def run(*a):
        kept[:] = [step(*a)]
        return kept[0]

    reset_train_counts(fa)
    dt, first_s, losses = bench.time_steps(run, args, 5, 1,
                                           torch.device("cuda"))
    launches, plain = dict(fa.kernel_launches), dict(fa.plain_calls)
    note_embedding("facade_train")
    # the bench's own read of the loss (bench.py:413)
    last = float(np.asarray(kept[0].numpy(), dtype="float32"))
    steps = len(losses)
    ref = gpt13["losses"]
    same = losses == ref[:steps]
    err = max(abs(a - b) for a, b in zip(losses, ref))
    rec = {"step_ms": 1000 * dt, "first_step_s": first_s, "losses": losses,
           "loss_numpy": last, "train_gpt13_step_ms": gpt13["step_ms"],
           "train_gpt13_losses": ref[:steps], "bit_for_bit": same,
           "max_loss_diff": err, "kernel_launches": launches,
           "plain_calls": plain, "card": card}
    log("facade train gpt13: " + json.dumps(rec))
    log(f"facade train: step {1000 * dt:.1f} ms vs train gpt13 "
        f"{gpt13['step_ms']} ms; losses "
        + ("equal bit for bit" if same else f"differ, max {err:.3e}"))
    if not all(math.isfinite(x) for x in losses) or last != losses[-1]:
        fail(f"facade train: a loss is not finite, or loss.numpy() "
             f"{last} is not the last loss: {losses}")
    want = {n: cfg.num_layers * steps for n in fa.KERNELS}
    if launches != want or any(plain.values()):
        fail(f"facade train: flash launches {launches} != {want}, or plain "
             f"calls {plain} != 0")
    del step, args, model, opt, kept
    torch.cuda.empty_cache()
    rec["alternate_ms"] = facade_train_turns(torch, cfg, B, S)
    return launches, rec


def facade_train_turns(torch, cfg, B, S):
    """The step ms of the bench's torch step and of the facade step once
    more each, in turns after (c) (facade, torch, facade, with phase
    ``train gpt13`` before them all): 1 + 2 warm + 5 timed steps each,
    one synchronisation a block, so the order's effect can be read."""
    import numpy as np

    from paddle_tpu_torch import bench

    out = []
    for kind in ("torch", "facade"):
        if kind == "torch":
            model, opt = bench.build(cfg, torch.device("cuda"), False)
            step = bench.make_train_fn(model, opt)
            rng = np.random.default_rng(0)
            ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (B, S))).to("cuda")
            args = (ids, ids.roll(-1, 1))
        else:
            step, args, model, opt = bench.facade_step(cfg, B, S)
        dt, _, _ = bench.time_steps(step, args, 5, 1, torch.device("cuda"))
        out.append((kind, 1000 * dt))
        del step, args, model, opt
        torch.cuda.empty_cache()
    log("facade train turns: " + ", ".join(f"{k} {ms:.1f} ms"
                                             for k, ms in out))
    return out


def phase_facade(torch, card, gpt13):
    """The eager core on the card: (a) the op library against the CPU,
    (b) full-width attention in facade ops, the double grad, the host
    cost per op, (c) the bench step through the facade."""
    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    ops = facade_ops(torch, paddle)
    attention = facade_attention(torch, paddle)
    torch.cuda.empty_cache()
    facade_double_grad(torch, paddle)
    cost = facade_host_cost(torch, paddle)
    train, rec = facade_train(torch, card, gpt13)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"facade phase: {secs:.1f} s")
    return {"ops": ops, "attention": attention, "train": train,
            "train_rec": rec, "host_cost": cost, "seconds": secs}


VISION_TOL = 1e-4   # f32, TF32 off: cuDNN's and the CPU's summation orders


def vision_run(paddle, fn, arrays, device):
    """One ``tools/vision_cases`` case on ``device``: its outputs, then
    the grads of its float inputs under a seeded cotangent on every float
    output (the CPU twins' rule), as numpy arrays."""
    import numpy as np

    paddle.set_device(device)
    ts = [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f")
          for a in arrays]
    out = fn(paddle, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    rng = np.random.default_rng(7)
    loss = None
    for o in outs:
        if o.stop_gradient:
            continue
        term = (o * paddle.to_tensor(
            rng.standard_normal(o.shape).astype("f4"))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return ([np.asarray(o.numpy()) for o in outs]
            + [np.asarray(t.grad.numpy()) for t in ts if t.grad is not None])


def rnn_graphed(torch, paddle, name):
    """A 2-layer bidirectional ``name`` (``LSTM`` or ``GRU``; input 64,
    hidden 128, B 16, T 32) on the card: one step (forward, the loss
    against a fixed cotangent, backward; returns the output and every
    parameter's grad) eagerly, and through ``StaticFunction`` three times
    (eager, capture and replay, replay): the third call equal to the
    eager one bit for bit, one capture; the eager step against the same
    step on the CPU at ``VISION_TOL``."""
    import numpy as np

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn.functional.common import as_torch

    rng = np.random.default_rng(3)
    x_np = rng.standard_normal((16, 32, 64)).astype("f4")
    cot_np = rng.standard_normal((16, 32, 256)).astype("f4")

    def make_step(device, weights=None):
        """A net on ``device`` (from ``weights`` when given) and its
        step."""
        paddle.set_device(device)
        paddle.seed(0)
        net = getattr(paddle.nn, name)(64, 128, num_layers=2,
                                       direction="bidirect")
        if weights is not None:
            net.set_state_dict(weights)
        params = net.parameters()
        cot = as_torch(paddle.to_tensor(cot_np))

        def step(x):
            out, _ = net(x)
            (out * cot).sum().backward()
            grads = [p.grad._value.clone() for p in params]
            net.clear_gradients()
            return out, grads
        return net, step

    net, step = make_step("cpu")
    weights = {k: v.numpy() for k, v in net.state_dict().items()}
    out, grads = step(paddle.to_tensor(x_np))
    results = {"cpu": [out._value.detach()] + grads}
    _net, step = make_step("cuda", weights)
    x = paddle.to_tensor(x_np)
    out, grads = step(x)
    results["cuda"] = [out._value.detach()] + grads
    del out, _net, step
    _net, step = make_step("cuda", weights)
    static = jit.StaticFunction(step, observe=[_net])
    for _ in range(3):
        g_out, g_grads = static(x)
    torch.cuda.synchronize()
    graphed = [g_out._value] + g_grads
    graphed_equal = all(a.equal(b) for a, b in zip(graphed,
                                                   results["cuda"]))
    counts = static.compile_counts()
    results["cuda"] = [t.cpu() for t in results["cuda"]]
    err = max(float((a - b).abs().max())
              for a, b in zip(results["cuda"], results["cpu"]))
    scale = max(float(b.abs().max()) for b in results["cpu"])
    return {"graphed_equal_eager": graphed_equal, "compile_counts": counts,
            "max_abs_err_vs_cpu": err, "max_abs": scale,
            "ok": graphed_equal and err <= VISION_TOL * max(scale, 1.0)
            and counts == {"signatures": 1, "captured": 1, "calls": 3}}


def phase_nn_vision_ops(torch, card):
    """Every conv and pooling case of the CPU twins
    (``paddle_tpu_torch/tools/vision_cases.py``: every padding form,
    ``"SAME"`` at stride 2, transposes with ``output_padding`` and
    ``output_size``, ``ceil_mode`` windows starting in the padding, the
    max pool's gradient over ties, ``return_mask`` and ``max_unpool``,
    adaptive sizes that do not divide) on ``cuda`` in f32 with TF32 off
    against the same call on the CPU: outputs and input grads at
    ``VISION_TOL``, masks exactly. Then a 2-layer bidirectional LSTM and
    GRU graphed against eager (``rnn_graphed``). Prints one JSON line."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools.vision_cases import CASES

    t0 = time.perf_counter()
    bad, worst = [], (0.0, None)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, (fn, arrays) in sorted(CASES.items()):
            got = vision_run(paddle, fn, arrays, "cuda")
            want = vision_run(paddle, fn, arrays, "cpu")
            if len(got) != len(want):
                bad.append(f"{name}: {len(got)} arrays vs {len(want)}")
                continue
            for i, (g, w) in enumerate(zip(got, want)):
                if g.dtype != w.dtype or g.shape != w.shape:
                    bad.append(f"{name}[{i}]: {g.dtype}{g.shape} vs "
                               f"{w.dtype}{w.shape}")
                elif w.dtype.kind != "f":
                    if not np.array_equal(g, w):
                        bad.append(f"{name}[{i}]: masks differ")
                else:
                    fin = np.isfinite(w)
                    err = (float(np.abs(g[fin] - w[fin]).max())
                           if fin.any() else 0.0)
                    if err > worst[0]:
                        worst = (err, f"{name}[{i}]")
                    if not np.allclose(g, w, atol=VISION_TOL,
                                       rtol=VISION_TOL):
                        bad.append(f"{name}[{i}]: max abs err {err:.3e}")
        rnn = {n: rnn_graphed(torch, paddle, n) for n in ("LSTM", "GRU")}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        paddle.set_device(None)
    rec = {"phase": "nn_vision_ops", "cases": len(CASES),
           "tol": VISION_TOL, "failed": bad, "max_abs_err": worst[0],
           "worst": worst[1], "rnn": rnn,
           "seconds": round(time.perf_counter() - t0, 1), "card": card}
    log(json.dumps(rec))
    if bad or not all(r["ok"] for r in rnn.values()):
        fail(f"nn vision ops: {len(bad)} case(s) off on the card "
             f"({bad[:5]}), rnn {rnn}")
    return rec


def resnet_state(net):
    """Every parameter and BatchNorm running statistic of ``net``, cloned
    (torch tensors by name)."""
    return {k: getattr(v, "_value", v).detach().clone()
            for k, v in net.state_dict().items()}


def resnet_runs(torch, kinds):
    """One ``bench --model resnet50`` run per entry of ``kinds``
    (``"eager"`` or ``"graphed"``), 8 steps each from the same seed:
    ``[(record, state after the 8 steps, kernel launches of K1-K5)]``."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import fused_adamw, paged_attention
    from paddle_tpu_torch.ops import flash_attention as fa

    out = []
    for kind in kinds:
        for mod in (fa, paged_attention, fused_adamw):
            mod.reset_counters()
        before = jit_compiles("train_fn")
        rec, net, opt = bench.train_run("resnet50", device="cuda", steps=5,
                                        reps=1, eager=kind == "eager")
        rec["jit_compiles"] = jit_compiles("train_fn") - before
        launches = (sum(ran(flash_counts(fa)).values())
                    + paged_attention.kernel_launches
                    + paged_attention.replayed_launches
                    + fused_adamw.kernel_launches)
        out.append((rec, resnet_state(net), launches))
        del net, opt
        torch.cuda.empty_cache()
    return out


def same_run(a, b):
    """Losses and every state tensor equal bit for bit: ``(equal, names
    of the tensors that differ)``."""
    differ = [k for k in a[1] if not a[1][k].equal(b[1][k])]
    return a[0]["losses"] == b[0]["losses"] and not differ, differ


def phase_train_resnet50(torch, card):
    """ResNet-50's training step (``bench --model resnet50``: B 64, 3 x
    224 x 224, 1000 classes, ``Momentum(0.1, 0.9)``, O2 bf16 with master
    weights, ``F.cross_entropy`` under ``auto_cast``) at full width and
    depth, 8 steps each: eagerly, eagerly again, then through the bench's
    ``StaticFunction`` (one capture). The losses, every parameter and
    every BatchNorm's running statistics after the 8 steps must be equal
    bit for bit between graphed and eager. If the two eager runs already
    differ (cuDNN's algorithms may not be deterministic), the three runs
    are made again with ``torch.backends.cudnn.deterministic = True``, the
    setting the equality is then held under, and its cost in step ms is
    printed. No K1-K5 launch is on this path (counted, must be 0).
    Prints one JSON line: losses, step ms graphed and eager, images/s,
    MFU, FLOPs a step and their source, peak memory, ``capture_s``."""
    t0 = time.perf_counter()
    runs = resnet_runs(torch, ("eager", "eager", "graphed"))
    eager_repeat, eager_differ = same_run(runs[0], runs[1])
    graphed_equal, graphed_differ = same_run(runs[0], runs[2])
    setting, det = "cudnn defaults (benchmark off)", None
    if not (eager_repeat and graphed_equal):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det = resnet_runs(torch, ("eager", "eager", "graphed"))
        finally:
            torch.backends.cudnn.deterministic = prev
        setting = "torch.backends.cudnn.deterministic = True"
    final = det or runs
    ok_repeat, _ = same_run(final[0], final[1])
    ok_graphed, differ = same_run(final[0], final[2])
    (r_e, _, l_e), (r_g, _, l_g) = final[0], final[2]
    summary = {
        "phase": "train_resnet50", "config": r_g["config"],
        "steps": r_g["steps_run"], "setting": setting,
        "default_eager_repeatable": eager_repeat,
        "default_graphed_equal_eager": graphed_equal,
        "default_differ": (eager_differ or graphed_differ)[:8],
        "graphed_equal_eager": ok_graphed, "eager_repeatable": ok_repeat,
        "state_tensors": len(final[0][1]), "differ": differ[:8],
        "losses": r_g["losses"],
        "images_per_s": {"eager": r_e["value"], "graphed": r_g["value"]},
        "step_ms": {"eager": r_e["step_ms"], "graphed": r_g["step_ms"]},
        "default_step_ms": {"eager": runs[0][0]["step_ms"],
                            "eager_again": runs[1][0]["step_ms"],
                            "graphed": runs[2][0]["step_ms"]},
        "deterministic_step_ms": None if det is None else {
            "eager": det[0][0]["step_ms"], "graphed": det[2][0]["step_ms"]},
        "mfu": {"eager": r_e["mfu"], "graphed": r_g["mfu"]},
        "flops_per_step": r_g["flops_per_step"],
        "flops_source": r_g["flops_source"],
        "achieved_tflops_per_s": r_g["achieved_tflops_per_s"],
        "peak_memory_gib": {"eager": r_e["peak_memory_gib"],
                            "graphed": r_g["peak_memory_gib"]},
        "capture_s": r_g["capture_s"], "compile_counts": r_g["compile_counts"],
        "jit_compiles": r_g["jit_compiles"],
        "kernel_launches_k1_k5": {"eager": l_e, "graphed": l_g},
        "seconds": round(time.perf_counter() - t0, 1), "card": card}
    log(json.dumps(summary))
    if not all(math.isfinite(x) for r in final for x in r[0]["losses"]):
        fail("train resnet50: a loss is not finite")
    if not ok_graphed or not ok_repeat:
        fail(f"train resnet50: graphed and eager differ under {setting} "
             f"(eager repeatable {ok_repeat}; differ {differ[:8]})")
    if r_g["compile_counts"] != {"signatures": 1, "captured": 1,
                                 "calls": r_g["steps_run"]} \
            or r_g["jit_compiles"] != 1:
        fail(f"train resnet50: not one capture: {r_g['compile_counts']}")
    if l_e or l_g:
        fail(f"train resnet50: a K1-K5 kernel launched on the conv-net "
             f"path ({l_e}, {l_g})")
    return summary


# ──────────────────── generation, recompute, flags, extended ops ────────────────────

GEN_TOL = 1e-3   # f32, TF32 off: cached decode logits vs the full forward's,
#                  relative to the logits' largest magnitude


def k1_k5_launches():
    """Every launch of K1-K5 counted so far (eager and replayed)."""
    from paddle_tpu_torch.ops import fused_adamw as fw
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    return (sum(fa.kernel_launches.values())
            + sum(fa.replayed_launches.values()) + pa.kernel_launches
            + pa.replayed_launches + fw.kernel_launches)


def reset_k1_k5():
    from paddle_tpu_torch.ops import fused_adamw as fw
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    fa.reset_counters()
    pa.reset_counters()
    fw.kernel_launches = fw.plain_calls = 0


def cached_vs_full(torch, model, ids):
    """The KV-cache trunk (prefill of the 128-token prompt, then 4 decode
    steps at device ``cur_len``) against one full forward over the 132
    tokens: the largest logit difference and the logits' largest
    magnitude, at the prompt's positions and at the 4 decode steps."""
    S0 = ids.shape[1] - 4
    dev = ids.device
    with torch.no_grad():
        full = model(ids)
        caches = model._kv_caches(ids.shape[0], ids.shape[1], dev)
        trunk = model._decode_trunk()
        h, _ = trunk(ids[:, :S0], caches=caches,
                     cur_len=torch.zeros((), dtype=torch.int64, device=dev))
        steps = [model.logits(h)]
        for p in range(S0, S0 + 4):
            h, _ = trunk(ids[:, p:p + 1], caches=caches,
                         cur_len=torch.full((), p, dtype=torch.int64,
                                            device=dev))
            steps.append(model.logits(h))
        cached = torch.cat(steps, dim=1)
    err = (cached - full).abs()
    return {"prefill_err": float(err[:, :S0].max()),
            "decode_err": float(err[:, S0:].max()),
            "max_abs": float(full.abs().max())}


def until_eos(ids, eos, S0):
    """Per row, the length up to and with its first generated ``eos`` (the
    whole row without one)."""
    lens = []
    for row in ids[:, S0:]:
        hits = (row == eos).nonzero()
        lens.append(S0 + int(hits[0, 0]) + 1 if len(hits) else ids.shape[1])
    return lens


def phase_generate(torch, card):
    """Dense ``generate()`` at full width (``tools/bench_generate.py``):
    Llama-0.76B and GPT-355M, f32, seeded weights, B 8, prompt 128, 128
    new tokens, greedy, device loop. K1-K5 counted from just before the
    timed calls to just after: none runs on this path (the cached
    attention is the plain masked softmax, as in the JAX package). Then:
    the device loop equal to the host loop token for token; the cached
    trunk's logits against a full forward over the prompt and 4 generated
    tokens within ``GEN_TOL`` of their scale; a sampled call (t 0.8,
    top_k 40) twice with one seed equal, with another seed different; an
    eos call at B 1 stopping early with ``stop_reason == "eos"`` in both
    loops, and at B 8 one row's eos freezing that row (eos from then on)
    while the others keep the greedy stream; the caches, the loop's
    state and the sampler's key on the card. Prints one JSON line a
    model."""
    from paddle_tpu_torch.tools import bench_generate as bg

    out = {}
    for name in bg.MODELS:
        t0 = time.perf_counter()
        built = bg.build(name, 128, 128, False, "cuda")
        model, vocab, _label = built
        reset_k1_k5()
        rec = bg.bench_one(name, built=built)
        launches = k1_k5_launches()
        ids = torch.from_numpy(__import__("numpy").random.default_rng(0)
                               .integers(0, vocab, (8, 128))).cuda()
        dev_ids = model.generate(ids, 128, temperature=0.0)._value
        host_ids = model.generate(ids, 128, temperature=0.0,
                                  device_loop=False)._value
        close = cached_vs_full(torch, model, dev_ids[:, :132])
        kw = dict(temperature=0.8, top_k=40)
        s1 = model.generate(ids, 32, seed=5, **kw)._value
        s2 = model.generate(ids, 32, seed=5, **kw)._value
        s3 = model.generate(ids, 32, seed=6, **kw)._value
        eos = int(dev_ids[0, 128 + 3])
        one = {}
        for dl in (True, False):
            o, st = model.generate(ids[:1], 128, temperature=0.0,
                                   eos_token_id=eos, device_loop=dl,
                                   return_stats=True)
            one[dl] = (o._value, st)
        frozen = {}
        for dl in (True, False):
            frozen[dl] = model.generate(ids, 128, temperature=0.0,
                                        eos_token_id=eos,
                                        device_loop=dl)._value
        f = frozen[True]
        row0 = f[0, 128:]
        first = int((row0 == eos).nonzero()[0, 0])
        others_kept = all(torch.equal(f[r, :n], dev_ids[r, :n])
                          for r, n in enumerate(until_eos(f, eos, 128)))
        sig = model._generation_programs[(8, 128, 256, 0.0, 0)]
        on_card = ({t.device.type for t in sig.state.values()}
                   | {t.device.type for kv in model._generation_caches[
                       (8, 256, torch.device("cuda", 0))] for t in kv})
        checks = {
            "device_loop_equals_host_loop": torch.equal(dev_ids, host_ids),
            "cached_logits_close": max(close["prefill_err"],
                                       close["decode_err"])
            <= GEN_TOL * max(close["max_abs"], 1.0),
            "sampled_same_seed_equal": torch.equal(s1, s2),
            "sampled_other_seed_differs": not torch.equal(s1, s3),
            "eos_b1_stops_early": all(
                st["stop_reason"] == "eos" and o.shape[1] < 256
                for o, st in one.values())
            and torch.equal(one[True][0], one[False][0]),
            "eos_b8_loops_equal": torch.equal(frozen[True], frozen[False]),
            "eos_row_frozen": bool((row0[first:] == eos).all()),
            "eos_other_rows_kept": others_kept,
            "state_on_card": on_card == {"cuda"},
            "no_k1_k5_launch": launches == 0,
        }
        out[name] = dict(rec, checks=checks, logits=close, tol=GEN_TOL,
                         launches=launches, eos=eos,
                         eos_b1_len=int(one[True][0].shape[1]),
                         seconds=round(time.perf_counter() - t0, 1),
                         card=card)
        log(f"generate {name}: " + json.dumps(out[name]))
        log(f"generate {name}: {rec['value']} tokens/s, "
            f"{rec['per_token_ms']} ms a token, first call "
            f"{rec['first_s']} s, capture {rec['capture_s']} s, peak "
            f"{rec['peak_memory_gib']} GiB ({card})")
        if not all(checks.values()):
            fail(f"generate {name}: {checks}")
        del model, built, sig
        torch.cuda.empty_cache()
    return out


RC_POLICIES = (None, "full", "dots", "dots_no_batch")


def phase_train_recompute(torch, card):
    """gpt13 (``bench --model gpt13``, graphed) with no recompute and with
    ``--recompute --recompute-policy {full,dots,dots_no_batch}``, 4 steps
    each (eager, capture, 2 replays). Per policy: step ms, peak memory,
    K1-K3 launches (K1 twice a layer under every policy: flash attention
    is no aten product, so it is recomputed, as no JAX policy saves a
    Pallas call's output), and the losses against no recompute's (bit
    for bit, else the largest difference: under O2 the ``recompute`` op
    casts the block's f32 norm weights to bf16, as the JAX package's
    does) and against ``full``'s. Prints one JSON line."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = bench.SETUPS["gpt13"](False)[0]
    runs, launches = {}, {}
    for policy in RC_POLICIES:
        label = f"rc_{policy or 'off'}"
        reset_train_counts(fa)
        rec = bench.bench_model("gpt13", device="cuda", steps=1, reps=1,
                                recompute=policy is not None,
                                recompute_policy=policy)
        counts = flash_counts(fa)
        note_embedding(f"train_gpt13_{label}")
        per_layer = {"flash_fwd": 1 if policy is None else 2,
                     "flash_dq": 1, "flash_dkv": 1}
        check_graphed_counts(f"train gpt13 {label}", counts, per_layer,
                             cfg.num_layers, rec["steps_run"])
        launches[label] = ran(counts)
        runs[label] = rec
        torch.cuda.empty_cache()
    base = runs["rc_off"]["losses"]
    summary = {"phase": "train_recompute", "card": card, "policies": {
        k: {"config": r["config"], "step_ms": r["step_ms"],
            "peak_memory_gib": r["peak_memory_gib"],
            "capture_s": r["capture_s"], "launches": launches[k],
            "losses": r["losses"],
            "losses_equal_no_recompute": r["losses"] == base,
            "losses_equal_full": r["losses"] == runs["rc_full"]["losses"],
            "max_loss_diff": max(abs(a - b) for a, b in
                                 zip(r["losses"], base))}
        for k, r in runs.items()}}
    log(json.dumps(summary))
    for k, r in summary["policies"].items():
        log(f"train gpt13 {k}: step {r['step_ms']} ms, peak "
            f"{r['peak_memory_gib']} GiB, K1-K3 {r['launches']}, losses "
            + ("equal" if r["losses_equal_no_recompute"]
               else f"differ by {r['max_loss_diff']:.3e}") + f" ({card})")
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"]):
        fail(f"train recompute: a loss is not finite: {summary}")
    return launches, summary


FLAG_LOSS_TOL = 0.02   # absolute, BERT's losses (~10.4) over 4 steps:
#                        bf16 dense attention against the flash kernels


def phase_flags(torch, card):
    """The flags on the card. ``FLAGS_use_pallas_flash_attention``: BERT's
    graphed step (``bench --model bert``, 4 steps) with the flag on, then
    off: 12 launches a step of each of K1-K3, then none (and none of
    their plain versions), losses within ``FLAG_LOSS_TOL`` (one dropout
    hash in both routes). ``FLAGS_check_nan_inf``: an eager op giving
    inf on ``cuda`` raises FloatingPointError; a ``StaticFunction`` step
    under the flag captures (the sweep skips during capture) and replays
    equal to its eager call. Prints one JSON line."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import bench, jit
    from paddle_tpu_torch.ops import flash_attention as fa

    bert = {}
    try:
        for flag in (True, False):
            paddle.set_flags({"FLAGS_use_pallas_flash_attention": flag})
            reset_train_counts(fa)
            rec = bench.bench_model("bert", device="cuda", steps=1, reps=1)
            bert[flag] = (rec, flash_counts(fa))
            note_embedding("flag_flash_on" if flag else "flag_flash_off")
            torch.cuda.empty_cache()
    finally:
        paddle.set_flags({"FLAGS_use_pallas_flash_attention": True})
    (r_on, c_on), (r_off, c_off) = bert[True], bert[False]
    diff = max(abs(a - b) for a, b in zip(r_on["losses"], r_off["losses"]))
    raised = False
    try:
        paddle.set_flags({"FLAGS_check_nan_inf": True})
        x = paddle.to_tensor(np.array([1.0, 0.0], "f4"), place="cuda")
        try:
            x / 0.0
        except FloatingPointError:
            raised = True
        w = paddle.to_tensor(np.linspace(-1, 1, 64, dtype="f4"),
                             place="cuda")

        def sweep_step(a):
            return paddle.tanh(a * w) * 2.0 + 1.0

        static = jit.StaticFunction(sweep_step)
        a = paddle.to_tensor(np.ones(64, "f4"), place="cuda")
        calls = [static(a)._value.clone() for _ in range(3)]
        replayed = all(torch.equal(c, calls[0]) for c in calls)
        counts = static.compile_counts()
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    on_launch, off_launch = ran(c_on), ran(c_off)
    checks = {
        "flash_on_launches": on_launch == dict.fromkeys(fa.KERNELS, 48),
        "flash_off_no_launch": off_launch == dict.fromkeys(fa.KERNELS, 0)
        and not any(c_off["plain_calls"].values()),
        "losses_close": diff <= FLAG_LOSS_TOL,
        "nan_inf_raises_on_card": raised,
        "captured_step_replays_under_sweep": replayed and counts == {
            "signatures": 1, "captured": 1, "calls": 3},
    }
    rec = {"phase": "flags", "card": card, "checks": checks,
           "bert_losses": {"flash_on": r_on["losses"],
                           "flash_off": r_off["losses"]},
           "max_loss_diff": diff, "tol": FLAG_LOSS_TOL,
           "step_ms": {"flash_on": r_on["step_ms"],
                       "flash_off": r_off["step_ms"]},
           "peak_memory_gib": {"flash_on": r_on["peak_memory_gib"],
                               "flash_off": r_off["peak_memory_gib"]},
           "launches": {"flag_flash_on": on_launch,
                        "flag_flash_off": off_launch}}
    log(json.dumps(rec))
    if not all(checks.values()):
        fail(f"flags: {checks}")
    return rec["launches"], rec


EXT_TOL = 1e-4   # f32, TF32 off: the card's and the CPU's summation orders


def phase_nn_extended_ops(torch, card):
    """Every case of ``paddle_tpu_torch/tools/extended_cases.py`` (the
    extended functionals and ``paddle.linalg``, the CPU twins' cases) on
    ``cuda`` against the CPU: same dtypes and shapes, outputs and input
    grads within ``EXT_TOL`` of each array's scale, integer outputs
    equal, the same inputs given grads. Prints one JSON line."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools.extended_cases import CASES, run_case

    t0 = time.perf_counter()
    bad, worst = [], (0.0, None)
    try:
        for name, (fn, arrays) in sorted(CASES.items()):
            paddle.set_device("cuda")
            go, gg = run_case(paddle, fn, arrays)
            paddle.set_device("cpu")
            wo, wg = run_case(paddle, fn, arrays)
            if len(go) != len(wo) or gg.keys() != wg.keys():
                bad.append(f"{name}: {len(go)} outputs, grads {list(gg)} "
                           f"vs {len(wo)}, {list(wg)}")
                continue
            pairs = list(zip(go, wo)) + [(gg[k], wg[k]) for k in wg]
            for i, (g, w) in enumerate(pairs):
                if g.dtype != w.dtype or g.shape != w.shape:
                    bad.append(f"{name}[{i}]: {g.dtype}{g.shape} vs "
                               f"{w.dtype}{w.shape}")
                elif w.dtype.kind != "f":
                    if not np.array_equal(g, w):
                        bad.append(f"{name}[{i}]: integers differ")
                elif w.size:
                    err = float(np.abs(g - w).max())
                    scale = max(float(np.abs(w).max()), 1.0)
                    if err / scale > worst[0]:
                        worst = (err / scale, f"{name}[{i}]")
                    if err > EXT_TOL * scale:
                        bad.append(f"{name}[{i}]: err {err:.3e}")
    finally:
        paddle.set_device(None)
    rec = {"phase": "nn_extended_ops", "cases": len(CASES), "tol": EXT_TOL,
           "failed": bad, "max_rel_err": worst[0], "worst": worst[1],
           "seconds": round(time.perf_counter() - t0, 1), "card": card}
    log(json.dumps(rec))
    if bad:
        fail(f"nn extended ops: {len(bad)} case(s) off on the card "
             f"({bad[:5]})")
    return rec


# ──────────────────── checkpoints, the sentinel, fit and reload ────────────────────


def phase_train_chaos(torch, card):
    """``tools/train_chaos.py --model bert_base`` at BERT-base's full width
    (B 32, S 128, O2 bf16 with master weights, dropout 0.1, AdamW):
    (a) ``hapi.Model.fit`` with ``checkpoint_dir`` and a ``TrainSentinel``
    in a child SIGKILLed mid-epoch 1 and resumed, equal to an
    uninterrupted child bit for bit; (b) the guarded pretraining loop with
    one NaN step skipped and a NaN region rolled back to its committed
    mark, equal to a clean run bit for bit, with the checkpoint's costs;
    (c) a child preempted by SIGTERM and resumed, equal to an
    uninterrupted child bit for bit. K1-K3 must launch on every path, in
    every child, and their plain versions never. Prints each drill's
    record and the costs beside the card's name and power limit."""
    import gc

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.tools import train_chaos

    gc.collect()
    torch.cuda.empty_cache()
    reset_k1_k5()
    from paddle_tpu_torch.ops import fused_adamw as fw

    nvcc0 = _build.nvcc_runs
    t0 = time.perf_counter()
    try:
        recs = train_chaos.run_bert_drills("cuda", small=False, log=log)
    except train_chaos.DrillFailed as e:
        fail(f"train chaos: {e}")
    if _build.nvcc_runs != nvcc0:
        fail("train chaos: a kernel was built during the drills")
    fit, guard, pre = (recs["fit-resume"], recs["guard-skip-rollback"],
                       recs["preemption"])
    paths = {"train_fit_resume": [fit["flash_reference"],
                                  fit["flash_resumed"]],
             "train_guard": [guard["flash"]],
             "train_preemption": [pre["flash_reference"],
                                  pre["flash_resumed"]]}
    plains = [fit["plain_reference"], fit["plain_resumed"], guard["plain"],
              pre["plain_reference"], pre["plain_resumed"]]
    for path, runs in paths.items():
        for c in runs:
            if not all(c[k] > 0 for k in ("flash_fwd", "flash_dq",
                                          "flash_dkv")):
                fail(f"train chaos: {path}: a flash kernel never launched "
                     f"({c})")
    if any(n for c in plains for n in c.values()):
        fail(f"train chaos: a plain flash version ran: {plains}")
    for path, r in (("train_fit_resume", fit), ("train_guard", guard),
                    ("train_preemption", pre)):
        if not all(r["embedding_grad"]) or r["embedding_grad_plain"]:
            fail(f"train chaos: {path}: the embedding backward kernel "
                 f"launched {r['embedding_grad']} times (a child each), "
                 f"its plain version {r['embedding_grad_plain']}")
        EMB_BY_PATH[path] = sum(r["embedding_grad"])
    launches = {path: {k: sum(c[k] for c in runs) for k in runs[0]}
                for path, runs in paths.items()}
    costs = {k: guard[k] for k in (
        "state_bytes", "sync_save_s", "sync_save_gb_s", "async_snapshot_s",
        "async_save_s", "async_save_gb_s", "verify_s", "restore_s",
        "restore_gb_s", "eager_step_ms", "eager_step_ms_async_draining",
        "save_outlasted_the_steps", "guarded_step_ms", "unguarded_step_ms",
        "eager_step_ms_turns", "guarded_step_ms_turns")}
    rec = {"phase": "train_chaos", "card": card,
           "seconds": time.perf_counter() - t0,
           "fit_resume": {k: fit[k] for k in (
               "seconds", "accuracy", "epoch1_losses", "tensors_compared",
               "moments_compared", "fit_seconds_reference")},
           "guard": {k: guard[k] for k in (
               "seconds", "actions", "excluded", "forward_only",
               "marks_committed", "tensors_compared")},
           "preemption": {k: pre[k] for k in (
               "seconds", "sigterm_step", "losses_compared",
               "tensors_compared")},
           "checkpoint_costs": costs, "flash_launches": launches,
           "fused_adamw_launches": fw.kernel_launches}
    log(json.dumps(rec, default=str))
    log(f"checkpoint costs ({card}): state {costs['state_bytes']} "
        f"bytes; sync save {costs['sync_save_s']:.3f} s "
        f"({costs['sync_save_gb_s']:.3f} GB/s), async save "
        f"{costs['async_save_s']:.3f} s (host copy "
        f"{costs['async_snapshot_s']:.3f} s); verify {costs['verify_s']:.3f}"
        f" s, restore {costs['restore_s']:.3f} s; eager step "
        f"{costs['eager_step_ms']:.2f} ms, "
        f"{costs['eager_step_ms_async_draining']:.2f} ms while an async "
        f"save drains; guarded step "
        f"{costs['guarded_step_ms']:.2f} ms against "
        f"{costs['unguarded_step_ms']:.2f} unguarded (best of 3 turns)")
    torch.cuda.empty_cache()
    return rec


DP13_EAGER, DP13_GRAPHED = 3, 5   # eager steps, then StaticFunction calls
DP13_LAYERS = 6            # of gpt13's 24: the depth cut, widths whole


def dp13_run(torch, wrap, level=None):
    """gpt13's bench step (O2 bf16, no master weights, fused CE, B 8, S
    1024; its first ``DP13_LAYERS`` layers) from ``bench.build``'s state: ``DP13_EAGER`` eager steps, then
    ``DP13_GRAPHED`` calls of ``jit.StaticFunction`` (a warm-up, a
    capture, replays), on the bench's batch. With ``wrap`` the model and
    optimizer go through ``fleet.init`` (dp 1: ``init_parallel_env`` on
    NCCL in this process), then ``fleet.distributed_model`` and
    ``distributed_optimizer``, or with ``level`` ZeRO's
    ``group_sharded_parallel`` at that level (``p_g_os`` runs all its
    steps eagerly: its gathers re-allocate the parameters' storage, which
    a graph cannot replay). Returns the losses, host copies of every
    parameter after the eager steps and after the graphed ones, the step
    times and the launch counts of the run."""
    import dataclasses

    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import bench, jit
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import embedding_grad as eg
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_adamw as fw
    from paddle_tpu_torch.ops import paged_attention as pa

    cfg, B, S, _ = bench.SETUPS["gpt13"](False)
    cfg = dataclasses.replace(cfg, num_layers=DP13_LAYERS)
    model, opt = bench.build(cfg, "cuda", bench.MASTER_WEIGHT["gpt13"])
    net = model
    if wrap:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
        fleet.init(is_collective=True, strategy=strategy)
        if level is None:
            net = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
        else:
            from paddle_tpu_torch import distributed as dist

            net, opt = dist.group_sharded_parallel(model, opt, level=level)
    train_fn = bench.make_train_fn(net, opt)
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, cfg.vocab_size, (B, S))
    labels_np = np.roll(ids_np, -1, axis=1)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(labels_np).cuda()
    reset_k1_k5()
    eg.reset_counters()
    losses, eager_s = [], []
    for _ in range(DP13_EAGER):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_fn(ids, labels).detach())
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
    after_eager = _params_whole(model, net)
    if level == "p_g_os":
        step = train_fn
        args = (ids, labels)
    else:
        step = jit.StaticFunction(train_fn, observe=[net, opt],
                                  warmup=False)
        args = (paddle.to_tensor(ids_np, place="cuda"),
                paddle.to_tensor(labels_np, place="cuda"))
    graphed_s = []
    for _ in range(DP13_GRAPHED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        losses.append(getattr(out, "_value", out).detach())
        torch.cuda.synchronize()
        graphed_s.append(time.perf_counter() - t0)
    after_graphed = _params_whole(model, net)
    launches = {k: fa.kernel_launches[k] + fa.replayed_launches[k]
                for k in fa.KERNELS}
    rec = {"losses": [float(x) for x in losses], "after_eager": after_eager,
           "after_graphed": after_graphed,
           "eager_step_ms": 1000 * min(eager_s[1:]),
           "graphed_step_ms": 1000 * min(graphed_s[2:]),
           "flash_launches": launches,
           "flash_plain": dict(fa.plain_calls),
           "paged_launches": pa.kernel_launches + pa.replayed_launches,
           "adamw_launches": fw.kernel_launches,
           "embedding_grad_launches": eg.launches(),
           "embedding_grad_plain": eg.plain_calls,
           "compile_counts": getattr(step, "compile_counts", dict)()}
    if wrap:
        rec["comm"] = net.comm_stats()
    if level is not None:
        rec["state_bytes"] = sum(v.numel() * v.element_size()
                                 for accs in opt._accumulators.values()
                                 for v in accs.values())
        rec["resident_param_bytes"] = net.resident_parameter_bytes()
    del step, train_fn, net, model, opt
    return rec


def _params_whole(model, net):
    """Host copies of every parameter; a ``p_g_os`` model's blocks
    gathered whole (at world size 1, the block is the parameter)."""
    sharder = getattr(net, "_sharder", None)
    if sharder is None:
        return [p.detach().cpu() for p in model.parameters()]
    return [sharder.shards.get(id(p), p).detach().cpu()
            for p in model.parameters()]


def phase_dp_gpt13(torch, card):
    """Part 1 of the distributed phase: gpt13 under ``DataParallel``, then
    under ZeRO at each level, at world size 1 on NCCL (``dp13_run``)
    against the plain step from the same state and batch: every loss and
    every parameter equal bit for bit after the eager steps and after the
    graphed ones."""
    import gc

    from paddle_tpu_torch import distributed as dist

    t0 = time.perf_counter()
    plain = dp13_run(torch, False)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        dp = dp13_run(torch, True)
    except RuntimeError as e:
        fail(f"distributed: gpt13 under DataParallel: {e}")
    gc.collect()
    torch.cuda.empty_cache()
    zero = {}
    for level in ZERO_LEVELS:
        try:
            zero[level] = dp13_run(torch, True, level)
        except RuntimeError as e:
            fail(f"distributed: gpt13 under ZeRO {level}: {e}")
        gc.collect()
        torch.cuda.empty_cache()
    backend = dist.get_backend()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    if backend != "NCCL":
        fail(f"distributed: gpt13 DataParallel ran on {backend}, not NCCL")
    for name, r in [("DataParallel", dp)] + [(f"ZeRO {lv}", zero[lv])
                                             for lv in ZERO_LEVELS]:
        if r["losses"] != plain["losses"]:
            fail(f"distributed: {name} losses {r['losses']} != the plain "
                 f"step's {plain['losses']}")
        for when in ("after_eager", "after_graphed"):
            bad = sum(not torch.equal(a, b)
                      for a, b in zip(r[when], plain[when]))
            if bad or len(r[when]) != len(plain[when]):
                fail(f"distributed: {name}: {bad} parameters differ {when} "
                     "from the plain step's")
    for r in (plain, dp, *zero.values()):
        if not all(v > 0 for v in r["flash_launches"].values()) \
                or any(r["flash_plain"].values()):
            fail(f"distributed: gpt13 flash counts {r['flash_launches']}, "
                 f"plain {r['flash_plain']}")
        if r["embedding_grad_plain"] or not r["embedding_grad_launches"]:
            fail("distributed: the embedding backward kernel did not run "
                 f"({r['embedding_grad_launches']} launches, "
                 f"{r['embedding_grad_plain']} plain)")
    comm = dp["comm"]
    steps = comm["reductions"]
    rec = {"phase": "dp_gpt13", "card": card, "backend": backend,
           "losses": dp["losses"],
           "plain_eager_step_ms": plain["eager_step_ms"],
           "plain_graphed_step_ms": plain["graphed_step_ms"],
           "dp_eager_step_ms": dp["eager_step_ms"],
           "dp_graphed_step_ms": dp["graphed_step_ms"],
           "buckets": comm["buckets"],
           "bucket_bytes_max": max(comm["bucket_bytes"]),
           "all_reduces_per_step": comm["all_reduces"] / steps,
           "bytes_reduced_per_step": comm["bytes_reduced"] / steps,
           "reductions_issued": steps,
           "params_compared": len(dp["after_graphed"]),
           "compile_counts": dp["compile_counts"],
           "flash_launches": dp["flash_launches"],
           "paged_launches": dp["paged_launches"],
           "adamw_launches": dp["adamw_launches"],
           "embedding_grad_launches": dp["embedding_grad_launches"],
           "zero": {lv: {k: z[k] for k in (
               "eager_step_ms", "graphed_step_ms", "flash_launches",
               "paged_launches", "adamw_launches", "embedding_grad_launches",
               "compile_counts", "state_bytes", "resident_param_bytes")}
               | {"all_reduces_per_step": z["comm"]["all_reduces"]
                  / z["comm"]["reductions"],
                  "params_compared": len(z["after_graphed"])}
               for lv, z in zero.items()},
           "seconds": time.perf_counter() - t0}
    log("distributed dp_gpt13: " + json.dumps(rec))
    log(f"distributed dp_gpt13 ({card}): step ms plain eager "
        f"{rec['plain_eager_step_ms']:.2f}, DataParallel eager "
        f"{rec['dp_eager_step_ms']:.2f}; plain graphed "
        f"{rec['plain_graphed_step_ms']:.2f}, DataParallel graphed "
        f"{rec['dp_graphed_step_ms']:.2f}; {rec['buckets']} buckets, "
        f"{rec['all_reduces_per_step']:.0f} all_reduces and "
        f"{rec['bytes_reduced_per_step']:.0f} bytes a step")
    log(f"distributed zero_gpt13 ({card}): step ms "
        + ", ".join(f"{lv} eager {z['eager_step_ms']:.2f} "
                    + ("eager" if lv == "p_g_os" else "graphed")
                    + f" {z['graphed_step_ms']:.2f}"
                    for lv, z in rec["zero"].items())
        + "; losses and all parameters equal to the plain step's")
    return rec


ZERO_LEVELS = ("os", "os_g", "p_g_os")


def state_roundtrip(torch, card):
    """Part 4 of the distributed phase: gpt13's whole train state (its
    first ``STATE_LAYERS`` layers at its width: the bf16 parameters and
    AdamW's moments after one step, at world size 1)
    saved through ``CheckpointManager`` and restored whole on the card,
    timed, every leaf bit for bit. The free disk under ``TMPDIR`` and the
    host's available memory are read first; either under twice the
    state's bytes takes GPT-355M's state instead (O2 with master weights,
    ``tools/dist_drills.py``), and the record says why."""
    import gc
    import shutil
    import tempfile

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.tools import dist_drills

    import dataclasses

    cfg, B, S, _ = bench.SETUPS["gpt13"](False)
    cfg = dataclasses.replace(cfg, num_layers=STATE_LAYERS)
    n_params = 1313.7e6   # gpt13's parameters; bf16, two bf16 moments
    need = 2 * n_params * (2 + 2 * 2)
    tmp = tempfile.gettempdir()
    free_disk = shutil.disk_usage(tmp).free
    with open("/proc/meminfo") as f:
        avail = int(next(ln for ln in f if ln.startswith("MemAvailable"))
                    .split()[1]) * 1024
    rec = {"phase": "state_roundtrip", "card": card, "tmpdir": tmp,
           "free_disk_bytes": free_disk, "mem_available_bytes": avail,
           "needed_bytes": need, "model": "gpt13"}
    if free_disk < need or avail < need:
        rec["model"] = "gpt355m"
        rec["reason"] = (f"free disk {free_disk} or available memory "
                         f"{avail} under twice gpt13's state ({need})")
        model, opt = dist_drills._decorate(*dist_drills._build(
            dist_drills.gpt355m_config(False), "cuda"))
        S = model.config.max_position_embeddings
    else:
        model, opt = bench.build(cfg, "cuda", bench.MASTER_WEIGHT["gpt13"])
    rng = __import__("numpy").random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, model.config.vocab_size,
                                        (2, S))).cuda()
    bench.make_train_fn(model, opt)(ids, ids.roll(-1, 1))
    rec["layers"] = model.config.num_layers
    state = {"model": model.state_dict(), "opt": opt.state_dict()}
    flat = [v for v in state["model"].values()] + [
        v for v in state["opt"].values() if hasattr(v, "numel")]
    rec["state_bytes"] = sum(v.numel() * v.element_size() for v in flat)
    rec["leaves"] = len(flat)
    root = tempfile.mkdtemp(prefix="state_roundtrip_")
    try:
        mgr = CheckpointManager(root, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, state)
        rec["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, step = mgr.restore()
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        bad = sum(not torch.equal(back["model"][k]._value, v)
                  for k, v in state["model"].items())
        bad += sum(not torch.equal(back["opt"][k]._value, v)
                   for k, v in state["opt"].items() if hasattr(v, "numel"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["differing"] = bad
    del back, state, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        fail(f"distributed: {bad} leaves of the restored state differ")
    rec["save_gb_per_s"] = rec["state_bytes"] / rec["save_s"] / 1e9
    rec["restore_gb_per_s"] = rec["state_bytes"] / rec["restore_s"] / 1e9
    log("distributed state_roundtrip: " + json.dumps(rec))
    log(f"distributed state_roundtrip ({card}): {rec['model']} "
        f"({rec['layers']} layers) "
        f"{rec['state_bytes']} bytes in {rec['leaves']} leaves, save "
        f"{rec['save_s']:.2f} s, restore {rec['restore_s']:.2f} s, "
        "bit for bit")
    return rec


EMB_SHAPE = (50304, 2048, 8 * 1024)   # gpt13's rows, width and B x S ids


def zipf_ids(n, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.zipf(1.1, n) - 1) % vocab


def embedding_repeats(torch, params, weight, make_loss, flag):
    """The embedding weight's gradient of 8 backwards from one state (the
    parameters and the generator's seed, so dropout draws the same masks)
    with ``FLAGS_cudnn_deterministic`` set to ``flag``: how many differ
    anywhere from the first."""
    import paddle_tpu_torch as paddle

    from paddle_tpu_torch import generator

    paddle.set_flags({"FLAGS_cudnn_deterministic": flag})
    grads = []
    try:
        for _ in range(8):
            generator.seed(0)  # one state: the same dropout masks
            loss = make_loss()
            loss.backward()
            grads.append(weight.grad.detach().clone())
            for p in params:
                getattr(p, "_value", p).grad = None
    finally:
        paddle.set_flags({"FLAGS_cudnn_deterministic": True})
    return sum(not torch.equal(grads[0], g) for g in grads[1:])


ONE_ROW = (2, 768, 32 * 128)   # BERT-base's token types: every id row 0


def one_row_repeats(torch):
    """One row under every lookup: BERT-base's f32 token-type table
    ``[2, 768]`` with all 4,096 ids of a batch (B 32, S 128) on row 0,
    and a fixed f32 output gradient. Returns how many of 8 repeats differ from the first
    with ``FLAGS_cudnn_deterministic`` on and off, and for a control
    that sums the same rows with atomics (``index_add_``) and so must
    differ, or the repeats could not see a nondeterministic sum."""
    from paddle_tpu_torch.nn import functional as F

    V, H, N = ONE_ROW
    gen = torch.Generator(device="cuda").manual_seed(15)
    w = torch.randn(V, H, device="cuda", generator=gen).requires_grad_()
    ids = torch.zeros(N, dtype=torch.int64, device="cuda")
    g = torch.randn(N, H, device="cuda", generator=gen)

    def loss():
        return (F.embedding(ids, w) * g).sum()

    out = {flag: embedding_repeats(torch, [w], w, loss, flag)
           for flag in (True, False)}
    sums = [torch.zeros(V, H, device="cuda").index_add_(0, ids, g)
            for _ in range(8)]
    out["atomics"] = sum(not torch.equal(sums[0], x) for x in sums[1:])
    return out


def phase_embedding_grad(torch, card):
    """Part 3 of the distributed phase: the deterministic embedding
    backward. (a) The kernel against its plain version at gpt13's shape
    (8192 Zipf ids, s 1.1, over 50304 rows of 2048, bf16): equal bit for
    bit (the same f32 sum in the same order), timed beside its bound and
    ``tF.embedding``'s backward (``embedding_dense_backward``). (b)
    BERT-base's and gpt13's backward 8 times each from one state with
    Zipf ids, and of one f32 row under 4,096 lookups
    (``one_row_repeats``): the gradients all equal with the flag on; with
    it off, how many differ; an atomic sum of the one-row case must
    differ, or the repeats could not tell. The kernel's launches are
    counted over the repeats alone."""
    import numpy as np

    from paddle_tpu_torch import amp, bench
    from paddle_tpu_torch.ops import embedding_grad as eg

    t0 = time.perf_counter()
    V, H, N = EMB_SHAPE
    ids = torch.from_numpy(zipf_ids(N, V, 11)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn(N, H, device="cuda", generator=gen).to(torch.bfloat16)
    eg.reset_counters()
    got = eg.embedding_grad(ids, g, V)
    want = eg.ref_embedding_grad(ids.cpu(), g.cpu(), V)
    err = float((got.float().cpu() - want.float()).abs().max())
    if not torch.equal(got.cpu(), want):
        fail(f"embedding_grad: kernel != plain version (max abs {err})")
    ms = cuda_ms(torch, lambda: eg.embedding_grad(ids, g, V))
    plain_ms = cuda_ms(torch, lambda: eg.ref_embedding_grad(ids, g, V))
    lib_ms = cuda_ms(torch, lambda: torch.ops.aten.embedding_dense_backward(
        g, ids, V, -1, False))
    distinct = int(torch.unique(ids).numel())
    nbytes = 8 * N + N * H * 2 + V * H * 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = N * H / PEAK_OPS["f32"]
    kernel = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "bound_ms": 1000 * max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "distinct_rows": distinct, "ids": N}
    log(f"embedding_grad ({card}): kernel {ms:.4f} ms, plain version "
        f"{plain_ms:.4f} ms, tF.embedding backward {lib_ms:.4f} ms, bound "
        f"{kernel['bound_ms']:.4f} ms ({N} Zipf ids, {distinct} distinct, "
        f"{V} x {H} bf16)")

    eg.reset_counters()
    repeats = {"one_row_f32": one_row_repeats(torch)}
    cfg, B, S, _ = bench.SETUPS["gpt13"](False)
    model, _ = bench.build(cfg, "cuda", False)
    ids13 = torch.from_numpy(zipf_ids(B * S, cfg.vocab_size, 12)
                             .reshape(B, S)).cuda()
    lab13 = torch.roll(ids13, -1, 1)

    def gpt_loss():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return model(ids13, labels=lab13)[1]

    w = model.gpt.embeddings.weight
    repeats["gpt13"] = {flag: embedding_repeats(
        torch, list(model.parameters()), w, gpt_loss, flag)
        for flag in (True, False)}
    del model
    torch.cuda.empty_cache()
    bcfg, bB, bS, _ = bench.SETUPS["bert"](False)
    bert, _ = bench.build(bcfg, "cuda", None)
    bids = torch.from_numpy(zipf_ids(bB * bS, bcfg.vocab_size, 13)
                            .reshape(bB, bS)).cuda()
    mlm = bids.clone()
    nsp = torch.zeros(bB, dtype=torch.int64, device="cuda")

    def bert_loss():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return bert(bids, masked_lm_labels=mlm,
                        next_sentence_labels=nsp)[1]._value

    bw = bert.bert.embeddings.word_embeddings.weight._value
    repeats["bert_base"] = {flag: embedding_repeats(
        torch, list(bert.parameters()), bw, bert_loss, flag)
        for flag in (True, False)}
    del bert
    torch.cuda.empty_cache()
    for name, r in repeats.items():
        if r[True]:
            fail(f"embedding_grad: {name}'s embedding gradients differ in "
                 f"{r[True]} of 7 repeats with the flag on")
    if not repeats["one_row_f32"]["atomics"]:
        fail("embedding_grad: an atomic sum of one row's 4,096 gradients "
             "gave the same bits 8 times: the repeats cannot see a "
             "nondeterministic sum")
    rec = {"phase": "embedding_grad", "card": card, "kernel": kernel,
           "repeats_differing": {k: {"flag_on": v[True], "flag_off": v[False]}
                                 for k, v in repeats.items()},
           "atomics_control_differing": repeats["one_row_f32"]["atomics"],
           "launches": eg.launches(),
           "seconds": time.perf_counter() - t0}
    log("distributed embedding_grad: " + json.dumps(rec))
    log(f"embedding repeats ({card}): of 7, differing with the flag on / "
        f"off: " + ", ".join(f"{k} {v[True]} / {v[False]}"
                             for k, v in repeats.items())
        + f"; the one-row atomic control {rec['atomics_control_differing']}")
    return rec


def phase_distributed(torch, card):
    """The distributed phase: (1) gpt13 under ``DataParallel`` at world
    size 1 on NCCL, eager and graphed, bit for bit against the plain step
    (``phase_dp_gpt13``); (2) two ranks on the card over gloo
    (``tools/dist_drills.py``: the collectives on CUDA tensors, GPT-355M
    data-parallel and tensor-parallel at its stated tolerances, K1-K3 in
    each rank, no child left holding the card); (3) the deterministic
    embedding backward (``phase_embedding_grad``). Prints each part's
    seconds."""
    from paddle_tpu_torch.tools import (dist_drills, sep_moe_drills,
                                        zero_pp_drills)

    t0 = time.perf_counter()
    dp13 = phase_dp_gpt13(torch, card)
    t1 = time.perf_counter()
    try:
        drills = dist_drills.run("cuda", small=False, log=log)
    except (dist_drills.DrillFailed, RuntimeError) as e:
        fail(f"distributed: two-rank drills: {e}")
    log("distributed two ranks: " + json.dumps(drills, default=str))
    t2 = time.perf_counter()
    emb = phase_embedding_grad(torch, card)
    t3 = time.perf_counter()
    try:
        zero_pp = zero_pp_drills.run("cuda", small=False, log=log)
    except (zero_pp_drills.DrillFailed, RuntimeError) as e:
        fail(f"distributed: ZeRO and pipeline drills: {e}")
    log("distributed zero_pp: " + json.dumps(zero_pp, default=str))
    zp, zz = zero_pp["pp"], zero_pp["zero"]
    mem = {lv: zz[lv]["memory"] for lv in ("os", "os_g", "p_g_os")}
    mem["dp"] = zz["dp_memory"]
    log(f"distributed zero_pp ({card}): two ranks of GPT-355M, ZeRO os / "
        f"os_g / p_g_os equal to DataParallel bit for bit, state ratio "
        f"{zz['os']['state_ratio']:.4f}, p_g_os parameters "
        f"{zz['p_g_os']['param_ratio']:.4f}; rank 0's bytes after the "
        f"backward / peak, above those before its model: " + ", ".join(
            f"{k} {v['after_backward']} / {v['peak']}"
            for k, v in mem.items()) + "; checkpoint save "
        f"{zz['save_s']:.2f} s, restores bit for bit; pp 2 gradients at "
        f"most {zp['model']['grads_rel']['max']:.4f} (the model, GPipe), "
        f"{zp['1F1B']['grads_rel']['max']:.4f} (1F1B) by norm, the "
        f"controls {zp['model_control']['grads_rel']['max']:.3f} (largest,"
        f" one send lost) and {zp['control']['grads_rel']['min']:.3f} "
        f"(smallest, the loss undivided); VPP logits "
        f"{zp['vpp']['logits_rel_norm']:.4f}")
    t4 = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        sep_moe = sep_moe_drills.run("cuda", small=False, log=log)
    except (sep_moe_drills.DrillFailed, RuntimeError) as e:
        fail(f"distributed: sequence and expert parallel drills: {e}")
    for part in ("ring", "sep", "moe"):
        log(f"distributed sep_moe {part}: "
            + json.dumps(sep_moe[part], default=str))
    log_sep_moe(card, sep_moe)
    t5 = time.perf_counter()
    torch.cuda.empty_cache()
    roundtrip = state_roundtrip(torch, card)
    t6 = time.perf_counter()
    log(f"distributed phase ({card}): dp_gpt13 and zero_gpt13 {t1 - t0:.1f}"
        f" s, two ranks {t2 - t1:.1f} s, embedding_grad {t3 - t2:.1f} s, "
        f"zero_pp {t4 - t3:.1f} s, sep_moe {t5 - t4:.1f} s, "
        f"state_roundtrip {t6 - t5:.1f} s")
    return {"dp_gpt13": dp13, "drills": drills, "embedding_grad": emb,
            "zero_pp": zero_pp, "sep_moe": sep_moe,
            "state_roundtrip": roundtrip}


# the depth of the earlier count-free paths, cut so the smoke stays well
# inside its limit as phases are added (widths and checks unchanged)
BUCKET_LAYERS = 3          # of Llama-0.76B's 12 (6 in PR 21, 3 in PR 22)
STATE_LAYERS = 3           # of gpt13's 24 (12, then 6, before)


def bucket_independence(torch, card):
    """Llama-0.76B (its first ``BUCKET_LAYERS`` layers) served graphed at
    token budgets 16, 64 and 1024 on 4
    seeds of the serve workload (``phase_serve``'s: 8 requests of
    64-1024 prompt tokens, 64 new, two sampled at temperature 0.8), one
    engine a budget, its prefix cache cleared between seeds: each
    request's stream at budgets 16 and 64 against budget 1024's. For a
    stream that differs: the first differing position, the two tokens
    and the gap between their logits there (a full forward of the
    prompt and the common prefix). Measurement only: differences are
    recorded, not failed."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    import dataclasses

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama_076b(), num_layers=BUCKET_LAYERS)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    budgets = (1024, 64, 16)
    workloads = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        lengths = rng.integers(64, 1025, 8)
        workloads.append([(rng.integers(0, cfg.vocab_size, int(n)),
                           0.8 if i in (2, 5) else 0.0, 1000 + i, 64)
                          for i, n in enumerate(lengths)])
    streams, steps = {}, {}
    for budget in budgets:
        engine = ServingEngine(model, page_size=16, max_batch_slots=8,
                               max_model_len=2048, token_budget=budget,
                               kv_dtype=torch.bfloat16, cuda_graph=True,
                               device="cuda")
        for seed, requests in enumerate(workloads):
            engine.prefix_cache.clear()
            outs, rec = serve_traffic(torch, engine, requests)
            streams[budget, seed] = [o.token_ids for o in outs]
            steps[budget, seed] = rec["steps"]
        del engine
        torch.cuda.empty_cache()
    diffs = []
    for budget in budgets[1:]:
        for seed, requests in enumerate(workloads):
            for i, (ref, got) in enumerate(zip(streams[1024, seed],
                                               streams[budget, seed])):
                if ref == got:
                    continue
                pos = next((j for j, (a, b) in enumerate(zip(ref, got))
                            if a != b), min(len(ref), len(got)))
                d = {"budget": budget, "seed": seed, "request": i,
                     "temperature": requests[i][1], "position": pos,
                     "lengths": [len(ref), len(got)]}
                if pos < min(len(ref), len(got)):
                    ids = np.concatenate([requests[i][0],
                                          np.asarray(ref[:pos])])
                    with torch.no_grad():
                        logits = model(torch.from_numpy(ids)[None].cuda())
                    last = getattr(logits, "_value", logits)[0, -1].float()
                    d.update(tokens=[ref[pos], got[pos]],
                             logit_gap=float(last[ref[pos]]
                                             - last[got[pos]]),
                             top2_gap=float(last.topk(2).values.diff()
                                            .abs()[0]))
                diffs.append(d)
    rec = {"card": card, "layers": cfg.num_layers,
           "budgets": list(budgets), "seeds": 4,
           "streams_compared": 2 * 4 * 8, "streams_differing": len(diffs),
           "differences": diffs,
           "steps": {f"{b}/{s}": n for (b, s), n in steps.items()},
           "seconds": time.perf_counter() - t0}
    del model
    torch.cuda.empty_cache()
    log("bucket independence: " + json.dumps(rec))
    log(f"bucket independence ({card}): Llama-0.76B ({cfg.num_layers} "
        "layers) graphed, budgets 16 "
        f"and 64 against 1024, 4 seeds x 8 requests: "
        f"{len(diffs)} of {rec['streams_compared']} streams differ"
        + ("".join(f"; budget {d['budget']} seed {d['seed']} request "
                   f"{d['request']} from position {d['position']}"
                   + (f" (tokens {d['tokens']}, logit gap "
                      f"{d['logit_gap']:.4f})" if "tokens" in d else "")
                   for d in diffs[:6]))
        + f"; {rec['seconds']:.1f} s")
    return rec


def phase_distributed_g(torch, card):
    """Phase 23 (module docstring): ``tools/ps_engine_drills.py``'s four
    paths, then ``bucket_independence``. Prints each part's seconds."""
    from paddle_tpu_torch.tools import ps_engine_drills as d

    t0 = time.perf_counter()
    try:
        r = d.run("cuda", small=False, log=log)
    except (d.DrillFailed, RuntimeError) as e:
        fail(f"distributed (g): {e}")
    a, b, c = r["engine_gpt13"], r["engine_dp2"], r["ctr"]
    sync, asyn = c["sync"], c["async"]
    log(f"distributed (g) ({card}): (a) gpt13 through Engine, 4 steps bit "
        f"for bit with the hand step under to_static "
        f"({a['params_compared']} parameters), step ms graphed "
        f"{a['graphed_step_ms']:.2f}, eager {a['eager_step_ms']:.2f}; "
        f"cost() {a['cost']['flops']:.4e} flops ({a['cost_rel']:.4%} off "
        f"{a['analytic_flops']:.4e}), peak {a['cost']['peak_bytes']} "
        f"bytes; save / load {a['save_s']:.2f} / {a['load_s']:.2f} s of "
        f"{a['state_bytes']} bytes; K1/K2/K3 "
        f"{a['launches']['flash_fwd']}/{a['launches']['flash_dq']}/"
        f"{a['launches']['flash_dkv']}; (b) GPT-355M Engine dp 2 on gloo: "
        f"updates at most {b['update_rel']['max']:.4%} off one model's by "
        f"norm (median {b['update_rel']['median']:.4%}), reducer off "
        f"{b['control_no_sync_rel']['min']:.3f} at least; "
        f"fused_allreduce_gradients bit for bit with DataParallel on "
        f"{b['fused_leaves']} leaves; without broadcast_dp_parameters "
        f"{b['no_broadcast_ranks_unequal']} tensors differ; step "
        f"{max(b['step_s']):.2f} s eager ({b['eager_reason']}); (d) rpc "
        f"sync and async bit for bit; (c) CTR sync step rows "
        f"{max(sync['rows_rel']):.2e} off the dense twin (control "
        f"{min(sync['control_rows_rel']):.2f}), {sync['steps']} steps at "
        f"{sync['steps_per_s']:.2f} steps/s, pull {sync['pull_ms']:.3f} ms "
        f"and push {sync['push_ms']:.3f} ms a step "
        f"({sync['pull_push_share']:.1%} of the step), tables "
        f"{sync['table_rows']} rows; async losses "
        + ", ".join(f"{x['loss_first']:.4f} -> {x['loss_last']:.4f} "
                    f"({x['merged']} rows merged)" for x in asyn.values())
        + "; seconds " + json.dumps(r["seconds"]))
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    buckets = bucket_independence(torch, card)
    t2 = time.perf_counter()
    log(f"distributed (g) phase ({card}): drills {t1 - t0:.1f} s, bucket "
        f"independence {t2 - t1:.1f} s")
    return {"drills": r, "buckets": buckets}


def phase_zoo_h(torch, card):
    """Phase 24 (module docstring): ``tools/zoo_drills.py``'s four parts.
    Prints one JSON line a part and a summary; returns the drills'
    record (``launches`` by path)."""
    from paddle_tpu_torch.tools import zoo_drills as d

    t0 = time.perf_counter()
    try:
        r = d.run("cuda", small=False, log=log)
    except (d.DrillFailed, RuntimeError) as e:
        fail(f"zoo (h): {e}")
    a, b, c, o = r["gpt355m"], r["zoo"], r["yoloe"], r["ocr"]
    fwd = b["forward"]
    worst = max(fwd["models"].items(), key=lambda kv: kv[1]["rel"])
    log(f"zoo (h) ({card}): (a) GPT-355M {a['params_m']} M, graphed = "
        f"eager bit for bit over 3 steps ({a['params_compared']} "
        f"parameters), step {a['step_ms']:.2f} ms, "
        f"{a['tokens_per_s']:.1f} tokens/s, capture {a['capture_s']:.2f} s, "
        f"peak {a['peak_bytes']} bytes, K1/K2/K3 "
        f"{a['launches']['flash_fwd']}/{a['launches']['flash_dq']}/"
        f"{a['launches']['flash_dkv']}, embedding "
        f"{a['launches']['embedding_grad']}; (b) {len(fwd['models'])} "
        f"models within {fwd['tol']} of the CPU by norm (worst "
        f"{worst[0]} {worst[1]['rel']:.3e}), control "
        f"{fwd['control']['rel']:.3e}; graphed train steps bit for bit: "
        + ", ".join(b["train"]) + "; " + "; ".join(
            f"({p}) {x['config']}: {x['images_per_s']:.1f} images/s, "
            f"stream {x['stream_ms']:.1f} ms, {x['recompiles']} graphs for "
            f"{x['bucket_keys']} bucket keys ({x['distinct_input_shapes']} "
            f"shapes), capture {sum(x['capture_s']):.2f} s, peak "
            f"{x['peak_bytes']} bytes, 16 steps bit for bit"
            for p, x in (("c", c), ("d", o)))
        + f"; predict nms {c['predict']['kept']} of "
        f"{c['predict']['candidates']} kept, equal to the CPU's, "
        f"{c['predict']['nms_ms']:.1f} ms; seconds "
        + json.dumps({k: round(v, 1) for k, v in r["seconds"].items()})
        + f", phase {time.perf_counter() - t0:.1f} s")
    return r


def phase_deploy_i(torch, card):
    """Phase 25 (module docstring): ``tools/deploy_drills.py``'s six
    parts. Prints one JSON line a part and a summary; returns the drills'
    record (``launches`` by path)."""
    from paddle_tpu_torch.tools import deploy_drills as d

    t0 = time.perf_counter()
    try:
        r = d.run("cuda", small=False, log=log)
    except (d.DrillFailed, RuntimeError, ValueError) as e:
        fail(f"deploy (i): {e}")
    a, p, e, q = r["serve"], r["profile"], r["device_api"], r["qat"]
    log(f"deploy (i) ({card}): (a) GPT-355M exported in "
        f"{a['export_s']:.1f} s ({a['flash_nodes']} K1 nodes, .pdmodel "
        f"{a['pdmodel_bytes']} bytes, .pdiparams {a['pdiparams_bytes']}), "
        f"loaded in {a['load_s']:.1f} s; logits bit for bit eager "
        + json.dumps(a["predictor_equal"]) + ", ms a call predictor / eager "
        + json.dumps({b: [round(a['predictor_ms'][b], 3),
                          round(a['eager_ms'][b], 3)]
                      for b in a["predictor_ms"]})
        + f", K1 {a['launches_predictor']['flash_fwd']} a call; (b) C API "
        f"equal {a['capi_equal']}; (c) bf16 storage equal "
        f"{a['bf16_store_equal']} (.pdiparams {a['bf16_pdiparams_bytes']} "
        f"bytes); (d) trace K1/K2/K3 events {p['in_trace']} = counters "
        f"over 2 steps, {p['device_events']} device events, "
        f"{p['device_ms_per_step']:.3f} device ms a step; (e) K1 "
        f"{e['k1_event_ms']:.4f} ms by Event, side stream equal "
        f"{e['side_equal']} on streams {e['k1_streams']}, the operator's "
        f"host cost {e['op_overhead_us']:.1f} us a call "
        + json.dumps({k: round(v, 1) for k, v in e["dispatch_us"].items()})
        + f"; (f) QAT card/CPU worst {q['worst_rel_to_max']:.2e}; seconds "
        + json.dumps({k: round(v, 1) for k, v in r["seconds"].items()})
        + f", phase {time.perf_counter() - t0:.1f} s")
    log(f"deploy (i) ({card}): GPT-355M bench step (replayed) by device "
        "time, ms a step and launches by part: "
        + json.dumps(p["groups_ms_per_step"]) + "; by kernel: "
        + json.dumps([(n[:60], t, c) for n, t, c in p["top"]]))
    return r


def phase_incubate_j(torch, card):
    """Phase 26 (module docstring): ``tools/incubate_drills.py``'s three
    parts, then K1 timed at the decode shape (the last decode step's q,
    k, v; from graph replays) beside its bound, its plain version and
    SDPA's forward. Prints
    one JSON line a part and a summary; returns the drills' record
    (``launches`` by path) with ``k1_decode``."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import incubate_drills as d

    if d.K1_BF16_TOL != FLASH_TOL["bf16"]:
        fail("incubate (j): the drills' K1 tolerance is not phase 3b's")
    t0 = time.perf_counter()
    try:
        r = d.run("cuda", small=False, log=log)
    except (d.DrillFailed, RuntimeError, ValueError) as e:
        fail(f"incubate (j): {e}")
    q, k, v = r.pop("k1_decode_inputs")
    scale = 1.0 / math.sqrt(q.shape[-1])
    bound, bound_by = flash_bounds(torch, q, k, False, None)["flash_fwd"]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # a call at this shape is a few microseconds of device work, less than
    # the host's time to issue it: device times from graph replays, and
    # K1's eager time (host-bound) beside them
    k1 = {"shape": {"q": list(q.shape), "k": list(k.shape),
                    "dtype": str(q.dtype)},
          "ms": graph_ms(torch, lambda: fa.flash_fwd(q, k, v)),
          "eager_ms": cuda_ms(torch, lambda: fa.flash_fwd(q, k, v)),
          "plain_ms": graph_ms(torch, lambda: fa.ref_flash_fwd(
              q, k, v, False, scale)),
          "library_ms": graph_ms(torch, lambda: sdpa(qh, kh, vh)),
          "bound_ms": bound, "bound_by": bound_by,
          "max_abs_err": r["decode"]["k1_max_abs_err"]}
    r["k1_decode"] = k1
    del q, k, v, qh, kh, vh
    a, b, c = r["encoder"], r["decode"], r["rest"]
    log(f"incubate (j) ({card}): (a) fused encoder, 12 layers at BERT-base "
        f"width, B 32, S 128 ({a['padded_share']:.3f} of the keys padded): "
        f"graphed = eager bit for bit over {len(a['losses_eager'])} steps, "
        f"step ms eager {a['step_ms_eager']:.2f} / graphed "
        f"{a['step_ms_graphed']:.2f}, capture {a['capture_s']:.2f} s, "
        f"K1/K2/K3 {a['launches_graphed']['flash_fwd']}/"
        f"{a['launches_graphed']['flash_dq']}/"
        f"{a['launches_graphed']['flash_dkv']}; kernels off "
        f"{a['step_ms_kernel_off']:.2f} ms a step, losses "
        f"{a['kernel_off_rel']:.2e} off (limit {d.KERNEL_OFF_RTOL}); (b) "
        f"fused decode at GPT-355M width, B 8: {b['step_ms']:.2f} ms a "
        f"decode step ({b['step_ms_kernel_off']:.2f} kernels off), K1 "
        f"{b['launches']['flash_fwd']} over {b['decode_steps']} steps at Sq "
        f"{b['k1_sq']}, Sk {b['k1_sk']}, {b['k1_calls_checked']} calls "
        f"against the plain K1: max abs {b['k1_max_abs_err']:.3e}, rel "
        f"{b['k1_max_rel_err']:.3e}; kernels-off worst step "
        f"{b['kernel_off_rel_max']:.3e} (limit {d.DECODE_REL}); K1 at the "
        f"decode shape {k1['ms']:.4f} ms replayed, {k1['eager_ms']:.4f} "
        f"eager (bound {k1['bound_ms']:.4f}, {k1['bound_by']}; plain "
        f"{k1['plain_ms']:.4f}, SDPA {k1['library_ms']:.4f}, replayed); "
        f"(c) against the CPU "
        + json.dumps({n: round(x["rel"], 9) for n, x in c.items()})
        + "; seconds "
        + json.dumps({k: round(v, 1) for k, v in r["seconds"].items()})
        + f", phase {time.perf_counter() - t0:.1f} s")
    return r


def phase_static_k(torch, card):
    """Phase 27 (module docstring): ``tools/static_drills.py``'s four
    parts. Prints one JSON line a part and a summary; returns the drills'
    record (``launches`` by path)."""
    from paddle_tpu_torch.tools import static_drills as d

    t0 = time.perf_counter()
    try:
        r = d.run("cuda", small=False, log=log)
    except (d.DrillFailed, RuntimeError, ValueError) as e:
        fail(f"static (k): {e}")
    a, b, c, w = r["train"], r["decode"], r["control_flow"], r["while_node"]
    log(f"static (k) ({card}): (a) GPT-355M f32 through Executor.run, "
        f"{len(a['losses'])} steps (B {list(d.TRAIN_B)}): losses and "
        f"{a['params']} parameters bit for bit the eager loop "
        f"{a['losses_equal'] and not a['params_differing']}, "
        f"{a['captures']} captures ("
        + ", ".join(f"{x:.2f}" for x in a["capture_s"])
        + f" s), step ms replayed at B 4 {a['step_ms_replayed_b4']:.2f}, "
        f"build {a['build_s']:.2f} s, K1/K2/K3 "
        f"{a['launches']['flash_fwd']}/{a['launches']['flash_dq']}/"
        f"{a['launches']['flash_dkv']}; (b) to_static greedy decode B "
        f"{d.DECODE_B}, L {d.DECODE_L}: trips " + json.dumps(b["trips"])
        + f", tokens and cur bit for bit the Python loop, "
        f"{b['ms_per_trip']:.3f} ms a decode trip (ms a call "
        + json.dumps({k: round(v, 2) for k, v in b["ms_per_call"].items()})
        + f"), capture {sum(b['capture_s']):.2f} s, K1 captured "
        f"{b['k1_captured']}, WHILE node executions "
        f"{b['launches']['while_nodes']}; (c) control flow "
        + json.dumps({k: v for k, v in c.items() if k != "cond_gradients"},
                     default=str)
        + f"; (d) WHILE node {w['ms_per_trip'] * 1e3:.2f} us a trip, plain "
        f"loop {w['plain_ms_per_trip'] * 1e3:.2f} us; seconds "
        + json.dumps({k: round(v, 1) for k, v in r["seconds"].items()})
        + f", phase {time.perf_counter() - t0:.1f} s")
    return r


def phase_export_l(torch, card, onnx):
    """Phase 28 (module docstring): ``tools/export_drills.py``'s three
    parts, (b) the record of ``onnx``, the ``OnnxChild`` that ran beside
    phase 21. Prints one JSON line a part and a summary; returns the
    drills' record (``launches`` by path)."""
    from paddle_tpu_torch.tools import export_drills as d

    t0 = time.perf_counter()
    try:
        r = d.run("cuda", small=False, log=log, onnx=onnx)
    except (d.DrillFailed, RuntimeError, ValueError,
            NotImplementedError) as e:
        fail(f"export (l): {e}")
    a, o, c = r["control_flow"], r["onnx"], r["spectral"]
    g, m = o["gpt_decode"], o["mobilenet_v2"]
    log(f"export (l) ({card}): (a) GPT-355M to_static greedy decode saved "
        f"by jit.save in {a['export_s']:.2f} s ({a['pdmodel_bytes']} bytes "
        f".pdmodel, {a['pdiparams_bytes']} .pdiparams), while_loop nodes "
        f"{a['nodes']['while_loop']} with K1 nodes "
        f"{a['nodes']['flash_fwd_in_body']} in the body, loaded in "
        f"{a['load_s']:.2f} s; trips " + json.dumps(a["trips"])
        + ", tokens and cur bit for bit phase 27's Python loop and WHILE "
        f"node, K1 " + json.dumps(a["k1_by_case"])
        + f"; {a['ms_per_trip_loaded']:.3f} ms a trip loaded against "
        f"{a['ms_per_trip_captured']:.3f} ms captured; gated layer "
        + json.dumps(a["gated_branches_equal"])
        + f"; (b) ONNX GPT-355M decode step: {g['nodes']} nodes, "
        f"{g['bytes']} bytes, export {g['export_s']:.2f} s, read "
        f"{g['read_s']:.2f} s, {len(g['tokens'])} steps evaluated in "
        f"{g['eval_s']:.2f} s, tokens (card, onnx) "
        + json.dumps(g["tokens"]) + f", caches {g['caches_rel']:.2e} by "
        f"norm; MobileNetV2 224: {m['nodes']} nodes, {m['bytes']} bytes, "
        f"export {m['export_s']:.2f} s, evaluated in {m['eval_s']:.2f} s, "
        f"logits {m['logits_rel']:.2e} by norm (the child process "
        f"{o['child_s']:.1f} s from its start, beside phase 21); launches "
        + json.dumps(r["launches"]) + "; op types "
        + json.dumps(sorted(set(g["op_types"]) | set(m["op_types"])))
        + "; (c) spectral card against CPU " + json.dumps(
            {k: f"{v:.2e}" for k, v in c["diffs"].items()})
        + ", Viterbi paths equal, card ms " + json.dumps(
            {k: round(v, 3) for k, v in c["ms"].items()})
        + "; seconds " + json.dumps(
            {k: round(v, 1) for k, v in r["seconds"].items()})
        + f", phase {time.perf_counter() - t0:.1f} s")
    return r


def log_sep_moe(card, r):
    """One line of the sequence- and expert-parallel drills' readings."""
    ring, sep, moe = r["ring"], r["sep"], r["moe"][0]
    rc, rf = ring["causal"], ring["full"]
    log(f"distributed sep_moe ({card}): ring P 4 at S 8192 bf16, causal / "
        f"full: worst rel to one call {max(rc['rel_one_call'].values()):.5f}"
        f" / {max(rf['rel_one_call'].values()):.5f}, to plain "
        f"{max(rc['rel_plain'].values()):.5f} / "
        f"{max(rf['rel_plain'].values()):.5f}, control "
        f"{rc['control_rel_one_call']:.4f} / "
        f"{rf['control_rel_one_call']:.4f}; ring fwd+bwd "
        f"{1e3 * (rc['ring_fwd_s'] + rc['ring_bwd_s']):.2f} / "
        f"{1e3 * (rf['ring_fwd_s'] + rf['ring_bwd_s']):.2f} ms against one "
        f"call {1e3 * (rc['one_call_fwd_s'] + rc['one_call_bwd_s']):.2f} / "
        f"{1e3 * (rf['one_call_fwd_s'] + rf['one_call_bwd_s']):.2f} ms; "
        f"Llama-0.76B sep 2: loss {sep['sep']['loss']:.6f} against "
        f"{sep['dense_loss']:.6f}, gradients at most "
        f"{sep['sep']['grads_rel']['max']:.4f} by norm, controls "
        f"{sep['control_no_hop']['grads_rel']['max']:.3f} (no hop) and "
        f"{sep['control_local_rope']['grads_rel']['max']:.3f} (local RoPE); "
        f"step {sep['sep']['seconds']:.2f} s, ring "
        f"{sep['sep']['hop_bytes'] / 1e9:.3f} GB a rank; MoE ep 2 gshard: "
        f"worst {max(moe['gshard']['ep']['out_rel'], moe['gshard']['ep']['grads_rel']['max']):.2e}"
        f", fwd+bwd {1e3 * moe['gshard']['ep_s']:.1f} ms against local "
        f"{1e3 * moe['gshard']['local_s']:.1f} ms")


def timed(phase, *args, note=""):
    """``phase(*args)``, printing its wall seconds, ``note`` and the
    run's so far."""
    t0 = time.perf_counter()
    out = phase(*args)
    t1 = time.perf_counter()
    log(f"clock: {phase.__name__} {t1 - t0:.1f} s{note}, at "
        f"{t1 - CLOCK_T0:.1f} s")
    return out


def onnx_child(child):
    """Waits for phase 28's ONNX child (``export_drills.OnnxChild``) and
    returns it; its clock line is the wait beyond phase 21."""
    from paddle_tpu_torch.tools import export_drills as d

    try:
        child.result()
    except d.DrillFailed as e:
        fail(f"export (l): {e}")
    return child


CLOCK_T0 = time.perf_counter()


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail("paddle_tpu_torch/ not found beside chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, HERE)
    name, card = timed(phase_device, torch)
    timed(phase_build)
    paged = timed(phase_paged_kernels, torch)
    flash = timed(phase_flash_kernels, torch)
    adamw = timed(phase_adamw_kernels, torch)
    engine, serve = timed(phase_serve, torch, card)
    timed(phase_mixed_steps, torch, engine)
    del engine
    torch.cuda.empty_cache()
    features = timed(phase_serve_features, torch, card)
    torch.cuda.empty_cache()
    tenancy = timed(phase_serve_tenancy, torch, card)
    torch.cuda.empty_cache()
    resilience = timed(phase_serve_resilience, torch, card)
    torch.cuda.empty_cache()
    gpt_model, serve_gpt = timed(phase_serve_gpt, torch, card)
    fleet = timed(phase_serve_fleet, torch, card, gpt_model)
    del gpt_model
    torch.cuda.empty_cache()
    timed(phase_reference, torch)
    torch.cuda.empty_cache()
    flash_launches, gpt13 = timed(phase_train, torch, card, "gpt13")
    timed(phase_train_reference, torch, "gpt")
    adamw_launches = timed(phase_adamw_path, torch)
    llama_launches, _ = timed(phase_train, torch, card, "llama")
    timed(phase_train_reference, torch, "llama")
    torch.cuda.empty_cache()
    facade = timed(phase_facade, torch, card, gpt13)
    torch.cuda.empty_cache()
    graphed_gpt13, _ = timed(phase_train_graphed, torch, card, "gpt13")
    graphed_llama, _ = timed(phase_train_graphed, torch, card, "llama")
    graphed_state, _ = timed(phase_train_graphed_state, torch, card)
    torch.cuda.empty_cache()
    bert, _ = timed(phase_train_bert, torch, card)
    torch.cuda.empty_cache()
    timed(phase_nn_vision_ops, torch, card)
    torch.cuda.empty_cache()
    timed(phase_train_resnet50, torch, card)
    torch.cuda.empty_cache()
    generate = timed(phase_generate, torch, card)
    rc_launches, _ = timed(phase_train_recompute, torch, card)
    flag_launches, _ = timed(phase_flags, torch, card)
    torch.cuda.empty_cache()
    timed(phase_nn_extended_ops, torch, card)
    # phase 28's ONNX part in a child process beside phase 21: host-bound
    # tracing while the chaos drills wait on their own children
    from paddle_tpu_torch.tools import export_drills

    onnx = export_drills.OnnxChild("cuda")
    chaos = timed(phase_train_chaos, torch, card)
    timed(onnx_child, onnx)
    torch.cuda.empty_cache()
    distributed = timed(phase_distributed, torch, card)
    torch.cuda.empty_cache()
    # Engine (gpt13 at world 1, GPT-355M at dp 2 summed over the ranks)
    engine_paths = timed(phase_distributed_g, torch,
                         card)["drills"]["launches"]
    torch.cuda.empty_cache()
    # GPT-355M's bench step, the zoo and the two bucketed streams
    zoo_paths = timed(phase_zoo_h, torch, card)["launches"]
    torch.cuda.empty_cache()
    # GPT-355M exported and served (K1 only), and its profiled bench step
    deploy_paths = timed(phase_deploy_i, torch, card)["launches"]
    torch.cuda.empty_cache()
    # the fused encoder trained, the fused decoder, the rest of incubate
    incubate = timed(phase_incubate_j, torch, card)
    torch.cuda.empty_cache()
    # GPT-355M trained through a static Program, its to_static decode
    static_k = timed(phase_static_k, torch, card)
    torch.cuda.empty_cache()
    # that decode saved and loaded, ONNX from the card, the spectral paths
    export_l = timed(phase_export_l, torch, card, onnx,
                     note=f" (its ONNX part {onnx.result()['child_s']:.1f}"
                     " s in a child beside phase_train_chaos)")
    zoo_paths = (zoo_paths | deploy_paths | incubate["launches"]
                 | static_k["launches"] | export_l["launches"])
    dp13 = distributed["dp_gpt13"]
    dist_flash = {"train_dp_gpt13": dp13["flash_launches"],
                  **distributed["drills"]["flash_launches"],
                  **{f"train_zero_{lv}_gpt13": z["flash_launches"]
                     for lv, z in dp13["zero"].items()}}
    # the two-rank ZeRO, pipeline and sequence-parallel paths (summed
    # over the ranks)
    zero_pp = distributed["zero_pp"]["launches"] \
        | distributed["sep_moe"]["launches"]
    gen_launches = {f"generate_{m}": rec["launches"]
                    for m, rec in generate.items()}
    head = paged["a_decode_f32q_bf16kv"]
    chunk = paged["b_chunk_bf16"]
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:124",
        # the graphed serve phase's launches: one warm-up a layer per
        # bucket, then one a layer per replayed step
        "launches": serve["kernel_launches"] + serve["replayed_launches"],
        "replayed_launches": serve["replayed_launches"],
        # each serving path's graphed run, counted the same way
        "launches_by_path": {
            name: rec["kernel_launches"] + rec["replayed_launches"]
            for name, rec in (("serve", serve),
                              ("serve_features", features),
                              ("serve_tenancy", tenancy),
                              ("serve_resilience", resilience),
                              ("serve_gpt", serve_gpt))}
        # every engine of the fleet phase, the restart drill's children
        # (the killed one up to its last step) included, and of its
        # rolling-reload drill alone
        | {"serve_fleet": fleet["launches"],
           "serve_fleet_reload": fleet["reload_k4_launches"]}
        # dense generate(): K1-K5 together, none expected
        | gen_launches
        # the distributed phase's training paths: none expected
        | {"train_dp_gpt13": dp13["paged_launches"]}
        | {f"train_zero_{lv}_gpt13": z["paged_launches"]
           for lv, z in dp13["zero"].items()}
        | {path: n["paged_attention"]
           for path, n in distributed["drills"]["flash_launches"].items()}
        | {path: n["paged_attention"] for path, n in zero_pp.items()}
        | {path: n["paged_attention"] for path, n in engine_paths.items()}
        | {path: n["paged_attention"] for path, n in zoo_paths.items()},
        # NaN in one slot's live K, V or scale rows, per phase-3a case:
        # non-finite on that slot's rows only (the kinds held)
        "nan_confined": {name: rec["nan_confined"]
                         for name, rec in paged.items()},
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "chunk_case": {"name": "b_chunk_bf16", **chunk},
    }]
    flash13 = flash["gpt13_bf16"]
    for kname, line in (("flash_fwd", 128), ("flash_dq", 290),
                        ("flash_dkv", 351)):
        r = flash13[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": flash_launches[kname],
            # each training path's run, counted the same way
            "launches_by_path": {
                "train_gpt13": flash_launches[kname],
                "train_llama": llama_launches[kname],
                "train_graphed_gpt13": graphed_gpt13[kname],
                "train_graphed_llama": graphed_llama[kname],
                "train_graphed_state": graphed_state[kname],
                "facade_attention": facade["attention"][kname],
                "facade_train": facade["train"][kname]}
            | {path: bert[path][kname] for path in bert}
            | {f"train_gpt13_{rc}": n[kname]
               for rc, n in rc_launches.items()}
            | {path: n[kname] for path, n in flag_launches.items()}
            | gen_launches
            # the train chaos phase: fit killed and resumed (both
            # children), the guarded loop, preempted and resumed
            | {path: n[kname]
               for path, n in chaos["flash_launches"].items()}
            # the distributed phase: gpt13 under DataParallel at world
            # size 1 (eager and graphed), GPT-355M data- and
            # tensor-parallel on two ranks (summed over the ranks)
            | {path: n[kname] for path, n in dist_flash.items()}
            # ZeRO at world 1 (above), the two-rank ZeRO, pipeline (1F1B,
            # the model's GPipe) and VPP paths, summed over the ranks
            | {path: n[kname] for path, n in zero_pp.items()}
            # the auto-parallel Engine: gpt13 at world 1 (one eager step,
            # one capture, replays), GPT-355M at dp 2 (eager, gloo)
            | {path: n[kname] for path, n in engine_paths.items()}
            # GPT-355M's bench step (eager, then replays), and the zoo's
            # vision paths (none expected)
            | {path: n[kname] for path, n in zoo_paths.items()},
            "max_abs_err": flash13["max_abs_err"][kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # K1 at the fused decoder's last step (Sq 1, Sk 160, bf16)
            **({"decode_case": incubate["k1_decode"]}
               if kname == "flash_fwd" else {}),
            # BERT-base's shape (B 32, S 128, 12 heads of 64, bf16,
            # non-causal, dropout 0.1), timed the same way
            "bert_case": {
                "max_abs_err": flash["bert_bf16"]["max_abs_err"][kname],
                "kpad_max_abs_err":
                    flash["bert_kpad_bf16"]["max_abs_err"][kname],
                **{key: flash["bert_bf16"][kname][key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}},
        })
    k5 = adamw["n355m_step10"]
    kernels.append({
        "name": "fused_adamw", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_adamw.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_adamw.py:62",
        "launches": adamw_launches,
        # the training paths of the train chaos phase (the optimizer there
        # is AdamW's plain update: none expected)
        "launches_by_path": {"adamw_path": adamw_launches,
                             "train_guard": chaos["fused_adamw_launches"],
                             "train_dp_gpt13": dp13["adamw_launches"]}
        | {f"train_zero_{lv}_gpt13": z["adamw_launches"]
           for lv, z in dp13["zero"].items()}
        | {path: n["fused_adamw"]
           for path, n in distributed["drills"]["flash_launches"].items()}
        | {path: n["fused_adamw"] for path, n in zero_pp.items()}
        | {path: n["fused_adamw"] for path, n in engine_paths.items()}
        | {path: n["fused_adamw"] for path, n in zoo_paths.items()},
        "max_abs_err": k5["max_abs_err"],
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
    })
    k6 = distributed["embedding_grad"]
    kernels.append({
        "name": "embedding_grad", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/embedding_grad.cu",
        # no Pallas kernel: the JAX package's embedding gradient is XLA's
        # scatter-add, behind this function
        "replaces": "paddle_tpu/nn/functional/common.py:103",
        # gpt13's bench path, as K1-K3's; every training path's run,
        # counted the same way (eager and graph-replayed launches)
        "launches": EMB_BY_PATH["train_gpt13"],
        "launches_by_path": dict(EMB_BY_PATH)
        | {"train_dp_gpt13": dp13["embedding_grad_launches"]}
        | {f"train_zero_{lv}_gpt13": z["embedding_grad_launches"]
           for lv, z in dp13["zero"].items()}
        | {path: n["embedding_grad"]
           for path, n in distributed["drills"]["flash_launches"].items()}
        | {path: n["embedding_grad"] for path, n in zero_pp.items()}
        | {path: n["embedding_grad"] for path, n in engine_paths.items()}
        | {path: n["embedding_grad"] for path, n in zoo_paths.items()}
        # the repeats of the distributed phase alone (flag on)
        | {"embedding_repeats": k6["launches"]},
        **{k: k6["kernel"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
    })
    w = static_k["while_node"]
    kernels.append({
        "name": "graph_cond_while", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/graph_cond.cu",
        # no Pallas kernel: the JAX package's tensor while is XLA's
        # lax.while_loop, here a WHILE node of the captured graph
        "replaces": "paddle_tpu/static/nn/control_flow.py:315",
        # the node's executions in the decode path's replays
        "launches": static_k["decode"]["launches"]["while_nodes"],
        "launches_by_path": {
            "decode_static_gpt355m":
                static_k["decode"]["launches"]["while_nodes"]},
        "trips": static_k["decode"]["trips"],
        "max_abs_err": w["max_abs_err"],
        # a trip of a one-add body against the host loop's trip
        "ms": w["ms_per_trip"], "plain_ms": w["plain_ms_per_trip"],
        "bound_ms": w["bound_ms_per_trip"], "bound_by": w["bound_by"],
        "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
