"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from `src/repro_torch/kernels/csrc` (nvcc,
     one process per source, started together) and print each kernel's
     registers, spills and shared memory (-Xptxas -v) on one line;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (n = 128, 2048, 65536 queries, top-k 32, m 64)
     and time kernel, plain version and, where one PyTorch call computes
     the same function, that call (`F.embedding_bag`); a device time is
     the mean of a kernel's launches under torch.profiler, and a session
     that lost launch records is run again (up to 4):
       K2 `lram_query`, its weights and indices bit-equal to the plain
       version's on uniform queries and on `lattice.tie_queries` (exact
       ties of weight, and ties in the canonical sort), and K1
       `gather_interp`, on the full 2^20-row table, and K1 again at
       n = 65536 on clustered queries (64 near each of n / 64 points, as
       training's queries crowd rows);
       B4 `gather_interp_quant` on the table quantized to int8 and e4m3,
       at n = 128 and 2048 also at every split (warps a query) with and
       without its wide loads (through its C entry, not counted);
       B5 `tiered_gather` and B6 `tiered_gather_quant` (int8, e4m3) on a
       full-width device cache (32 slots x 8192 rows) with resident
       indices, B5's call and its yardstick's timed again in turns;
       at n = 128 and 2048 serve paths (e)'s and (f)'s calls: one of
       the 4 row ranges, every token's k elements with the other ranges'
       reading the range's first routed row at weight 0, K1 over the
       range's flat route (8 of its 32 shards cached) and B5 on the
       range resident in 32 shuffled slots;
       the backward kernel `lookup_bwd` in both instantiations (B3's
       backward with dq, B1's VJP with dw) on the full table with K2's
       indices, library yardstick for the dw instance: the backward of
       `F.embedding_bag` through `torch.autograd.grad`;
       the tiered train step's kernels at n = 128, 2048, 16384 (its n)
       and 65536, on a tiered store's flat route (32 of 128 shards
       cached, the other rows appended): K2 at 16384, K1 and B4 (int8,
       e4m3) over the flat table, and the backward's instances without
       scatter, `lookup_bwd_rows` (fp32 rows, with dq: path (a)'s
       backward; with dw, library yardstick the backward of
       `F.embedding_bag` to its per-sample weights) and
       `lookup_bwd_quant` (int8 and e4m3 rows, with dq: path (b)'s
       backward; with dw: B4's VJP); the same at 16384 and 65536 on
       clustered queries;
       row 9's kernels at n = 128, 2048 and 32768 (one data rank's n on
       the mesh step), on both halves of the table (2^19-row shards at
       base 0 and 2^19): the range gather over fp32 (library yardstick
       `F.embedding_bag` with the clamped rows and masked weights), int8
       and e4m3 shards, and the range backward (fp32 with scatter,
       1-byte without; each with dq and with dw);
       K2 and K1 at path (h)'s n: 384, 768, 960 and 1,024 (a decode tick
       of 4 slots x 96, 192, 240 and 256 memory heads; 1,024 is path
       (n)'s MoE tick too), 512 (path (n)'s mamba2-1.3b tick, 128 heads),
       192 (path (o)'s whisper-small decode step, 4 x 48 heads; its
       qwen2-vl-72b step, 4 x 512, is the 2,048 above) and 16,384 (a
       64-token yi-9b prompt) as above, and
       1,966,080 in one call (danube's 8,192-token prompt x 240 heads),
       held against the plain versions on its last 65,536 queries;
       K2, K1 and the backward (dq, dw) at path (p)'s n: 196,608,
       262,144 and 524,288 (K2 on uniform queries: the tie sets hold at
       the smaller n), and the range gather and range backward (fp32)
       at (p4a)'s 262,144 on both halves of the table;
       the bf16-table instances (path (m)), each with a launch count of
       its own, on the table rounded to bf16: K1's `gather_interp_bf16`
       at n = 128, 2,048, 65,536 and 1,966,080, bit for bit the fp32
       instance's output on the same values widened (its device time
       beside) and within rtol 2e-5 / atol 1e-6 of the plain version;
       the backward's `lookup_bwd_bf16` (dq and dw) at 128 / 2,048 /
       65,536 and the range instances `sharded_gather_bf16` (bit for bit
       the fp32 one on the widened shard) and `lookup_bwd_range_bf16`
       at 128 / 2,048 / 32,768 on the lower half: dvalues fp32 to atol
       1e-5 and, rounded once to bf16, within one bf16 ulp or (a sum
       that cancels) 1e-3 of the largest magnitude; no library
       yardstick (`F.embedding_bag` sums a bf16 table in bf16);
       the fp16-table instances (path (q)) the same way on the table
       rounded to fp16: `gather_interp_f16` at n = 128, 2,048 and
       65,536, `lookup_bwd_f16` (dq and dw) there and
       `sharded_gather_f16` / `lookup_bwd_range_f16` at 128 / 2,048 /
       32,768 on the lower half, each bit for bit its fp32 instance on
       the widened rows (the backward's dq / dw; its dvalues within
       atol 1e-5 and one fp16 ulp once rounded: atomics order a row's
       sum), no library yardstick (`F.embedding_bag` over an fp16 table
       returns fp16);
  4. serve at full width through `repro_torch.launch.serve.main --warmup`
     (the trace's prefill buckets and one decode tick first; then 8 requests, 4
     slots, prompts <= 64, generation <= 32, all queued at t=0).  Each
     path is driven with every launch count set to 0 just before it and
     read just after, and fails unless its kernels launched, 8 of 8
     requests finished and every logit is finite:
       dense  `lram-tiered --placement pallas`: K2 + K1;
       (a)    `lram-tiered` on its own tiered spec (32 of 128 shards
              cached): K2 + K1 on the overflow route;
       (b)    `lram-tiered-q8` on its own spec: K2 + B4;
       (c)    `lram-tiered --cache-slots 128` (the whole table resident
              after warm()): K2 + B5 on every lookup;
       (d)    `lram-tiered-q8 --cache-slots 128`: K2 + B6;
       (e)    `lram-sharded-tiered` on its own spec (4 row ranges, each a
              tiered store caching 8 of its 32 shards; each range the
              indices name gathers all k of every token, the other
              ranges' elements at weight 0, and the partials are added
              in range order): K2 + K1 on the ranges' overflow routes;
       (f)    `lram-sharded-tiered --cache-slots 32` (every range
              resident): K2 + B5 on every range's lookups.
     All seven serve the same seed's weights, so (a), (c), (e) and (f)
     must give the dense path's first logits and (d) those of (b), to
     1e-5.  The dense path's decode tick is one CUDA graph (captured once
     in warmup(): `graph_captures` 1, every tick replayed); the tiered
     paths run eagerly.  Every tick's logits are checked finite, graph
     replay or eager.  Then, each fatal:
       graph against eager: the dense path's weights and trace through
              an engine with the graph and one with `cuda_graph=False`
              in this process: every request's tokens equal (and the CLI
              run's), one capture, and the K2 / K1 launch counts of the
              timed trace (reset after warm-up and capture) equal; decode
              p50 / p99 and tokens/s of both;
       (g)    `lram-tiered --placement pallas --spill-at-tick 8`: the
              dense 2^20 x 64 fp32 table spilled to the arch's own
              TieredSpec (32 of 128 shards of 8192 rows cached) between
              decode ticks with requests in flight: one `spill` event
              (its pause printed), 8 of 8 requests with the dense path's
              tokens, K2 + K1 launched, the graph dropped at the swap,
              the store's hit rate in the report;
       (i)    per-tenant overlays: `lram-tiered --placement pallas
              --tenants 4 --overlay-rows 8 --overlay-dir` (every request
              a tenant of 4, 8 overlay rows a slot, the decode tick one
              CUDA graph over the packs): K2 + K1, 8 of 8, finite, one
              capture and every tick replayed, tenants parked at the end;
              its relaunch prints `restored_overlays` equal to the files
              parked; with `--overlay-ttl 4 --overlay-budget-kb 64` (the
              controller's lifecycle) every request's tokens equal the
              run without it, at least one event, every event a spill,
              the spills the events; then in this process on one model
              of the same weights: the trace through the graph engine
              and an eager twin (`cuda_graph=False`): tokens equal (and
              the CLI's), the tenants' rows equal (ids, payloads within
              1e-6), K2 / K1 launch counts equal; the same graph engine
              serving the dense path's trace without tenants: the dense
              path's tokens and first logits bit for bit, still one
              capture; decode p50 / p99, tokens/s and the host ms a tick
              spends in the overlays' write-back and pack refresh, beside
              the dense path's numbers;
       (i-g)  (i)'s weights and trace with a live spill to the tiered
              store at tick 8 (`LifecyclePolicy(spill_at_tick=8)`): one
              spill, the graph dropped at the swap, every token (i)'s,
              the tenants' rows (i)'s within 1e-6, K2 + K1;
       (j)    `lram-tiered-q8` on its own TieredSpec with
              `backing="mmap"` in a fresh temporary directory, and the
              same config in RAM, in turns, each without and then with 4
              tenants: the files `values_1048576x64.npy` and
              `scales_1048576x64.npy` (N * m and N * 4 bytes past their
              `.npy` headers), K2 + B4, both first logits path (b)'s bit
              for bit, int8 overlays, the tenants' tokens equal across
              the backings; the stores' host fill ms a lookup of each;
       (k)    `lram-sharded-tiered` backed by memmaps under a temporary
              directory: `range_000` ... `range_003`, one file each, K2 +
              K1 on the ranges' overflow routes, path (e)'s tokens and
              first logits bit for bit; every temporary directory is
              removed;
       (l)    obs armed (`--metrics-dir`, `--profile-dir` in temporary
              directories; every line of metrics.jsonl and metrics.prom
              validated, the summary's `metrics` the snapshot, one
              `serve.run` span, one `serve.decode_tick` span and
              `serve.decode_step_s` sample a tick, `serve.tokens` +
              `serve.admitted` = the generated tokens): (l1) the dense
              path served with obs off, on, on, off in turns (tick p50 /
              p99, tokens/s), then profiled, then without `--warmup`
              off and profiled (the capture inside the profiled
              `serve.run`): every armed run has the tokens and launch
              counts of obs off and one capture, each profile is one
              torch.profiler trace whose kernel events name
              `lram_query_kernel` and `gather_interp_kernel` (its bytes
              and the span counts printed); (l2) path (b) and (l3) path
              (e) armed: the `memstore.*` deltas on the tick and prefill
              spans equal the summary's cache stats, their fill bytes
              their fills' slots, and `memstore.prefetch_queue_depth` is
              (e)'s 4 ranges; (l4) (i-g) through the CLI (`--tenants 4
              --spill-at-tick 8`) off and armed: equal tokens and
              launches, one `memctl.spill` span and event,
              `memctl.table_device_bytes` the tiered caches' bytes,
              `serve.overlay_writebacks` the active slots summed over the
              ticks; (l5) `train --grow-at 6:21 --telemetry` 12 steps
              off, armed, off: equal launch counts, the first loss bit
              for bit and every loss within rtol 1e-4 (bit for bit if
              the two runs off are), one `train.step` span a step, one
              `memctl.grow` span and event, `memctl.num_locations` 2^21,
              the `train.util_*` gauges the last utilisation report's;
       (m)    bfloat16 memory tables (`LRAMConfig.table_dtype`, put in
              with `dataclasses.replace`; the CLIs build it from
              `configs.get_config` under `tables_in()`, having no
              flag, as the reference's): (m1) the dense `pallas` path's
              model with a bf16 table under the decode graph and its fp32
              twin (the same weights, the table widened): tokens equal,
              first logits bit for bit, K1's bf16 instance alone
              launched, the table 134,217,728 B against 268,435,456;
              tick p50 / p99, tokens/s, peak memory; (m2) (a) and (c)
              and (m3) (e) through the serve CLI, every store's host
              tier bf16 (2-byte rows) under its fp32 cache: (m1)'s
              tokens, first logits within 1e-5, the fp32 gathers
              launched, fill bytes and fill ms a lookup beside phase
              4's; (m4) `lram-bert-medium --placement pallas` 20 steps
              (K1 and the backward's bf16 instances, the backward once a
              step; the loss falls; step 1's backward held against the
              plain version: dvalues to atol 1e-5 and rounded as above,
              dq / dw rtol 1e-4; step ms and peak memory printed beside
              phase 6's after it); (m5) `lram-tiered` 10 steps on a bf16
              host tier (a write-back a step, the loss falls, the tier
              changes only on touched rows); (m6) 4 gloo ranks (data 2 x
              model 2) on the `sharded` placement with a bf16 table: 2
              eval forwards and a train forward and backward on the
              whole batch, the logits within 1e-5 of the dense bf16
              twin's and each rank's bf16 shard of d values the twin's
              rows within one ulp (as above); the bf16 range instances
              launched on every rank; then, in the same spawn, (q4) the
              same with an fp16 table (the fp16 range instances);
  5. a shorter serve of each path's warmed engine under torch.profiler
     (the dense path twice: with the graph and eager): kernel time by
     name and the device's busy share;
 5h. path (h), the dense public decoders at full width in bfloat16, each
     `configs.with_lram(get_config(arch), 20)` (the memory FFN at layer
     num_layers // 2, a 2^20 x 64 fp32 table, `pallas`), weights drawn
     on the card from seed 0, served through `ServeEngine` (warm-up over
     the trace's prompt lengths, the decode tick one CUDA graph), each
     model freed before the next: h1 yi-9b, h2 qwen2-1.5b, h3
     starcoder2-3b on the serve paths' trace; h4 h2o-danube-3-4b (window
     4,096) on 4 requests of exactly 8,192 prompt tokens and 32 new
     ones in 2 slots (a chunked prefill, a 4,096-slot ring that wraps;
     requests 2 and 3 are prefilled into a slot whose ring an earlier
     request wrapped; cut from 8 requests in 4 slots for the time
     limit, keeping that second wave).  Each
     prints decode p50 / p99, tokens/s, the median prefill, the peak
     memory, K2 / K1 launches and the memory reads' n, and one replayed
     tick's profiled busy share; each fails unless K2 and K1 launched
     (counts reset just before, read just after), every request
     finished with finite logits, the kernels agree with their plain
     versions on the queries the path itself gave them (the last eager
     memory read at each n, warm-up and run: K2 bit for bit, K1 rtol
     2e-5 / atol 1e-6), and every request's first logits match a
     prefill of its prompt, padded as the engine pads it, with the
     kernels' plain versions on the card to the bfloat16 tolerance of
     the CPU tests (2^-8 x (layers + 1) x the largest logit).  h1 also
     serves eagerly: tokens and launch counts equal the graph's, and
     its real decode ticks' reads are held as above.  h4 also holds one prompt's
     chunked prefill against `attn_impl="dense"`, and request 0's last
     decode tick (past the window) against a full forward of its prompt
     and generated tokens, both to that tolerance;
 5n. path (n), the MoE and SSM families at full width in bfloat16, as
     path (h) serves (`with_lram(cfg, 20)` on `pallas`, the memory FFN
     at layer num_layers // 2, weights drawn on the card from seed 0,
     warm-up, the decode tick one CUDA graph, each model freed before
     the next): n1 phi3.5-moe-42b-a6.6b and n2 mixtral-8x7b with
     num_layers cut from 32 to 8 (every width as published: 16 / 8
     experts, top-2; at 32 layers their bf16 weights, about 84 and 93
     GB, fit no 80 GB card) on the serve paths' trace (phi bucketed,
     mixtral at exact lengths); n3 mamba2-1.3b whole (48 layers, the
     memory FFN at 24 on the residual stream) on that trace at exact
     lengths (the sequential scan), and n3b on 4 requests of exactly
     512 prompt tokens and 32 new ones (the chunked scan, 8 chunks).
     Each prints what path (h) prints, the tick's read bound (every weight but the embedding and
     the table, 32 table rows a head and slot, the caches; an SSM's
     fp32 state read and written) and the path's seconds; an MoE the
     token copies its capacity dropped in the prefills, by block.  Each
     fails as path (h)'s do, its first logits held against the plain
     memory reads to the bfloat16 tolerance under the routing rule of
     the CPU tests (a request whose prefill routes a token before its
     last differently is excused only where the router's margin there is
     below one bf16 rounding of the two logits, and printed); n1 and n3
     also serve eagerly (tokens and launch counts equal the graph's: the
     SSM state written in place under the graph); n3b holds one prompt's
     chunked prefill against `ssd_sequential` to that tolerance;
 5o. path (o), the hybrid, enc-dec and VLM families at full width in
     bfloat16, weights drawn on the card from seed 0, each model freed
     before the next: (o1) zamba2-2.7b whole (54 Mamba layers, the shared
     attention + MLP block called after every 6; no memory layer: the
     reference allows none in a hybrid) served through `ServeEngine` on
     the serve paths' trace (exact-length prefills, the decode tick one
     CUDA graph) and again eagerly, tokens equal, no kernel of the port
     launched, every request's first logits against an eager prefill of
     its prompt, and the tick against its read bound (the shared block's
     weights once a call); (o2) whisper-small with `with_lram(cfg, 20)`
     (encoder 12 layers over 1,500 seeded frames, the memory FFN at
     decoder layer 6 of 12, 48 heads) and (o3) qwen2-vl-72b cut from 80
     layers to 8 (widths as published; the memory FFN at layer 4, 512
     heads; 256 seeded vision embeddings on a 16 x 16 frame at their
     M-RoPE positions, text after them), both on `pallas`: the engine
     refuses both families (as the reference's), so 4 prompts (64 and
     512 tokens) go through `transformer.prefill` and 32 greedy
     `decode_step`s; each fails unless K2 and K1 launched, the path's
     own memory reads agree with the plain versions, the first logits
     match a prefill through the plain versions and every decoded
     step's logits a full forward over the generated sequence, both to
     the bfloat16 tolerance.  Each prints its decode step (or tick) p50
     / p99 against its read bound, the prefill, the peak memory and its
     K2 / K1 launches;
 5p. path (p), the public archs trained in bfloat16 with the memory FFN
     (`with_lram(get_config(arch), 20)`: a 2^20 x 64 fp32 table, at
     layer num_layers // 2) through `train.main` on a replaced config
     registry (`p_registry`; the reference's CLI has no flag for
     `with_lram`), `--placement pallas --batch 8 --seq 256 --steps 12`
     (cut from 20 for the time limit)
     (weights drawn on the card from seed 0, `transformer.init(device=)`
     put in for the host draw, which (p1) also times once at its size; no
     CPU twin), each freed before the next: (p1) qwen2-1.5b whole (28
     layers, the memory FFN at 14, 96 heads: n = 196,608 a step), (p2)
     mamba2-1.3b whole (48 layers, at 24, 128 heads: n = 262,144; 256
     positions, 4 chunks of the SSD scan forward and backward), (p3)
     phi3.5-moe-42b-a6.6b cut from 32 layers to 2 (widths as published:
     one MoE layer of 16 experts, top-2, then the memory FFN, 256 heads:
     n = 524,288); then (p4) one spawn of 4 gloo ranks on the card (data
     2 x model 2) running in turn (p4a) (p3)'s config on `--placement
     sharded` 3 steps (the range gather and the range backward at
     262,144 a rank) and (p4b) zamba2-2.7b cut from 9 units to 2 (12
     Mamba layers, the shared block called twice, no memory layer) 3
     steps, against a one-process run of the same cut first, then on a
     data 4 x model 1 mesh of the same ranks (p4c) (p1)'s config (every
     dense leaf split 4 ways over data and gathered one unit at a time,
     `distributed.sharding.DenseBlocks`) 3 steps, against (p1)'s first 3
     losses.
     Counts set to 0 just before each run and read just after; each
     fails unless K2 and K1 (the range gather on p4a) launched every step
     and the backward (`lookup_bwd`, p4a `lookup_bwd_range`) once a
     step, the losses are finite and fall, and step 1's backward inputs,
     kept on the host, agree with the plain version on the card (dvalues
     atol 1e-5, dq / dw rtol 1e-4 / atol 1e-5); (p4a)'s router term
     within 1% of (p3)'s at step 1 (same weights, same batch) and within
     5% at steps 2-3 (`P4A_AUX_TOL`), and its losses, as (p4b)'s against
     its twin and (p4c)'s against (p1)'s, within 2^-8 x (layers + 1) x
     the largest (the CPU tests' bf16 bound); (p4b) and its twin launch
     no kernel; (p4c) holds no two units whole at once (beside the tied
     embedding) and prints the bytes a rank gathered and summed and the
     units it held whole at once, a step.  Each prints the
     step ms median (from step 6; from step 2 on the mesh), tokens/s, the
     step against its FLOP bound (`train_flops` at 989 TFLOP/s: every
     Dense product, the attention's, an MoE's dispatch buffers), peak
     memory against `train_bytes`' reckoning, the init seconds, an MoE's
     router term and dropped copies a step, a rank's held bytes; then
     one profiled step's top kernels (p1-p3);
 5q. path (q), float16 tables and models, after (p): (q1) (m1) with an fp16
     table (K1's fp16 instance alone launched, tokens and first logits
     bit for bit the fp32 twin's); (q2) path (a) through the serve CLI
     with an fp16 host tier under its fp32 cache, (q1)'s tokens, first
     logits within 1e-5; (q3) (m4) with an fp16 table (`lookup_bwd_f16`
     once a step, step 1's backward held as there; step ms and peak
     printed beside (m4)'s and phase 6's after phase 6); (q4) runs in
     (m6)'s spawn; (q5) `with_lram(qwen2-1.5b, 20)` with the model and
     its table in float16, drawn on the card and served through
     `ServeEngine` at (h2)'s trace under the decode graph: a forward of
     the first prompt checked finite first (a float16 overflow fails,
     naming the modules whose outputs overflowed), K2 and K1's fp16
     instance launched, request 0's first logits within 2^-11 x (layers
     + 1) x the largest of an fp32 copy of the same weights on the card,
     tick p50 / p99 beside the tick's read bound; (q6) `lram-bert-pkm`
     in bfloat16 (the PKM's leaves with it), 20 steps at 7b's size, no
     kernel of the port launched, the loss falls, step ms and peak
     printed beside 7b's after it.  Prints `path_q_s`;
 5r. phase (r), the dry-run (`repro_torch.launch.dryrun`) on this
     machine's host, never the card: three subprocesses started together
     (a fake world is process-global), each a step on `meta` tensors in
     a one-process fake world, all done within `R_TIMEOUT_S`: (r1) (p1)'s
     own cell (its config, 8 x 256, one rank), failing unless its
     products, less the memory layer's lookup (run alone), are within 1%
     of (p1)'s `train_flops` reckoning (the lookup's printed by op), its
     peak of live bytes printed beside (p1)'s measured steps' peak;
     (r2) (p4c)'s config on a fake 4-rank world (data 4 x model 1),
     failing unless the tally's gathered and summed bytes of the dense
     blocks equal every (p4c) rank's measured bytes of every step;
     (r3) one production cell, qwen2-1.5b+lram20 x train_4k on the
     16 x 16 mesh: its roofline row (at the H100 data sheet's peaks)
     and seconds.  Printed with the card's name and power limit;
  6. train `lram-bert-medium` at full width through
     `repro_torch.launch.train.main` (`--placement pallas --batch 8 --seq
     256 --steps 20`: 2,048 tokens, n = 65,536 lookups a step), with every
     launch count set to 0 just before and read just after; fails unless
     K2, K1 and the backward kernel `lookup_bwd` launched (the backward
     once a step), every loss and grad norm is finite and the mean loss of
     steps 16-20 is below that of steps 1-5.  Step-time median over steps
     6-20, tokens/s, peak device memory (beside the bytes already
     allocated when it was reset, as every training path prints it);
     then one more step under
     torch.profiler (busy share, top kernels, and K1's device time in it
     beside its bound on that step's own indices: each distinct row they
     name read once);
 6a. crash and resume (dense): the same training with `--ckpt-dir` (under
     the system temp directory, deleted afterwards) `--ckpt-every 10
     --simulate-failure-at 15`: only `SimulatedFailure` is caught, then
     the same command again.  Fails unless the relaunch prints `resumed
     from step 10`, its step-10 loss is the crashed run's bit for bit,
     steps 10-14 are within rtol 1e-4 and 15-19 within 1e-3 of phase 6's
     uninterrupted run, and K2, K1 and `lookup_bwd` launched in both runs
     (counts reset just before each, read just after).  Each save's
     snapshot and write ms and bytes, the restore's ms;
 6b. the mesh: 4 ranks spawned on the one card (gloo, which sums CUDA
     tensors through host memory: data 2 x model 2, the 2^20-row table
     row-sharded over model, 128 MiB a rank; every dense leaf the
     reference's GSPMD rules split kept as the rank's block, gathered
     whole for each forward).  Each rank checks two full-width forwards
     first: the first eval batch's logits on its shard (the dense blocks
     gathered) against the dense pallas table's (1e-5), and the sharded
     int8 and e4m3 cells' `lram_apply` against the dense 1-byte cell's
     (B4) on the same payloads (1e-5).  Then `train.main` (`--placement
     sharded --use-mesh --batch 8 --seq 256 --steps 20`: n = 32,768
     lookups a rank a step), launch counts reset just before and read
     just after; fails unless K2, the range gather and the range backward
     launched on every rank (the backward once a step), the losses are
     finite and fall, they match phase 6's (rtol 1e-4 over steps 1-5,
     1e-3 over all 20: atomics sum in another order), and after the run
     each rank holds no more bytes of dense parameters and Adam moments
     than its blocks' share plus the replicated leaves (listed).
     Step-time median, tokens/s, peak memory and held bytes per rank, and
     two more steps with every sum and every gather across ranks timed
     (ms, bytes and share of the step);
 6c. crash, resume and elastic restore on the mesh: 6b's run with
     `--steps 12 --ckpt-every 6 --ckpt-dir` (every rank snapshots, the
     table shard and its moments gathered over model on a gloo group of
     host arrays; rank 0 writes) fails before step 9 on every rank (only
     `SimulatedFailure` caught, after a barrier behind rank 0's write);
     4 new ranks relaunch it.  Fails unless rank 0 alone prints `resumed
     from step 6`, the step-6 loss is the crashed run's bit for bit,
     steps 6-11 are within rtol 1e-5 of 6b's, K2, the range gather and
     the range backward launched on every rank in both runs, and the
     step-12 checkpoint has 6a's leaf names, shapes, dtypes and bytes (to
     256 B of JSON), and each relaunched rank holds only its blocks'
     share as in 6b (every rank's peak memory reported).  Then one process restores it into the dense pallas
     table (`--steps 14`): `resumed from step 12`, steps 12-13 within
     rtol 1e-5 of 6b's, K2, K1 and `lookup_bwd` launched.  Every rank's
     snapshot (the gathers of the blocks and the table shard included),
     write and restore ms, and the bytes;
 6d. the pipeline: 4 ranks spawned on a ("pod",) mesh run
     `distributed.pipeline.pipeline_apply` (GPipe, 4 microbatches) over 4
     full-width plain layers of lram-bert-medium (w 512, d_ff 2048), a
     stage a rank, on x (8, 256, 512); fails unless every rank's output
     is within 1e-5 (rtol and atol) of the 4 layers applied in sequence
     in one process, and the backward of sum(out * r) (x's gradient and
     each rank's stage's parameter gradients) within 1e-5 of the
     sequential layers' (rtol, and atol 1e-5 x each gradient's largest
     element: a microbatch at a time, the fp32 sums run in another
     order).  Both timed, forward and backward;
 6e. gradient compression: lram-bert-medium at full width, `--placement
     pallas --compression int8` and then `topk`, 10 steps each; fails
     unless K2, K1 and `lookup_bwd` launched (the backward once a step),
     the losses are finite and the mean of steps 6-10 is below that of
     steps 1-5.  Step-time median over steps 6-10, tokens/s, peak
     memory;
 6f. growth in training: phase 6 with `--grow-at 10:21 --telemetry`: the
     table and Adam's mu / nu grow from 2^20 to 2^21 rows before step 10;
     fails unless `{"grow": "2^21", "step": 10, ...}` is printed, K2, K1
     and `lookup_bwd` launched (the backward once a step), steps 0-9 are
     within rtol 1e-4 of phase 6's, the losses are finite and fall.
     Step 10's loss beside phase 6's, the grow pause, the step-time
     median over steps 12-20, peak memory, the utilisation lines and the
     dead share of the appended bins;
  7. train `lram-tiered` (path (a)) and `lram-tiered-q8` (path (b)) at
     full width on their own tiered spec through `train.main` (`--batch 8
     --seq 64 --steps 10`, cut from 20 for the time limit: n = 16,384
     lookups a step, the table in host RAM, 32 of 128 shards cached, the
     write-back's sparse SGD at 1e-3),
     and (7c) `lram-sharded-tiered` 10 steps (4 ranges, 8 of 32 shards
     cached a range; K1 over the ranges' concatenated flat tables), each
     with the launch counts set to 0 just before and read just after;
     fails unless K2, the gather (K1 or B4) and the path's backward
     instance launched (the backward once a step), one write-back ran a
     step (a range write-back a range), the loss fell (the last 5 steps
     below steps 1-5), and the host tier changed on rows the write-back
     touched and nowhere else.  Step-time
     median over steps 6-10, tokens/s, peak device memory, the write-back's
     and the flat route's host ms a step, bytes copied to the host a step,
     hit rate and overflow share; then one more step under torch.profiler;
 7a. crash, resume and serve (tiered int8): `lram-tiered-q8` at full width
     (`--batch 8 --seq 64 --steps 6 --ckpt-every 3`), a failure before step
     4, the relaunch: its step-3 loss is the crashed run's bit for bit and
     every shard it restored (payload and scales) equals the saved file;
     then `serve --ckpt-dir --warmup --json` restores step 6, serves 8 of 8
     requests through K2 + B4, from the trained table bit for bit;
 7d. grow, crash, resume and serve (tiered): `lram-tiered` at full width
     (`--batch 8 --seq 64 --steps 6 --grow-at 2:21 --ckpt-every 2`), a
     failure before step 5, the relaunch: `catch_up` grows before the
     restore, which resumes from step 4 with the crashed run's step-4
     loss bit for bit on the 536,870,912 B grown host tier; then `serve
     --grow-to 21 --ckpt-dir --warmup --json` restores step 6 and serves
     8 of 8 requests through K2 + K1; the saves' bytes and ms;
 7b. train the paper's PKM baseline `lram-bert-pkm` at full width (2^16 x
     512 table, 8 heads, top-32; `--batch 8 --seq 256 --steps 20`): the
     reference has no Pallas kernel there, so no kernel of the port may
     launch (counts reset just before, read just after, all 0); the loss
     falls; step-time median over 6-20, tokens/s, peak memory and one
     profiled step (busy share, top kernels);
  8. serve the smoke configs (tiered and q8) on the card and on the CPU
     (plain versions), and tiered against dense on the card, with the same
     weights, comparing every request's first logits to 1e-5; train the
     lram-bert-medium, lram-tiered, lram-tiered-q8 and
     lram-sharded-tiered smoke configs 5 steps on the card and on the CPU
     from the same seed's weights and batches, per-step losses and
     gradient norms to rtol 1e-4, and lram-bert-pkm's smoke config and
     lram-bert-medium's with `--compression int8` and `topk` the same
     way; serve every public arch's smoke config with the memory FFN
     (2^16 rows, `pallas`; zamba2 without) on the card and on the CPU
     from the same weights, in float32 (first logits to rtol / atol
     1e-5, greedy tokens equal) and in bfloat16 (to the tolerance
     above), whisper-small and qwen2-vl-72b (which the engine refuses)
     through `transformer.prefill` and 4 `decode_step`s instead; train
     qwen2-1.5b, mamba2-1.3b and phi3.5-moe's smoke configs in bfloat16
     with the memory FFN (2^16 rows, `pallas`) 5 steps on the card and
     on the CPU: losses and gradient norms within 2^-8 x (layers + 1) of
     the CPU's, relative; and qwen2-1.5b's the same in float16, within
     2^-11 x (layers + 1);
  9. last lines: the script's seconds, the card again, the `kernels` JSON
     line, and {"ok": true, "device": {...}}.

It imports nothing of JAX, of the JAX package or of ml_dtypes.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import inspect
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# fails here, printing nothing, when the checkout around the script is missing
from repro_torch import configs, data, memctl, obs, quant  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _load, _tree_items  # noqa: E402
from repro_torch.core import indexing, lattice, lookup  # noqa: E402
from repro_torch.core.lram import LRAM  # noqa: E402
from repro_torch.core.pkm import PKM  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    train_bytes, train_flops, whole_leaves)
from repro_torch.distributed import (  # noqa: E402
    collectives, context, fault, pipeline, sharding)
from repro_torch.kernels import (  # noqa: E402
    _build, e8_lookup, gather_interp, ops, sharded_gather, tiered_gather)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.distributed.sharded_lram import (  # noqa: E402
    ShardedTieredStore)
from repro_torch.memstore import TieredValueStore  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attention, mamba2, moe, transformer)
from repro_torch.serving import (  # noqa: E402
    EngineConfig, ServeEngine, synthetic_trace)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
PROFILE_SESSIONS = 4  # profiler sessions a device time may take
FP32_OPS_PER_S = 67e12
SHAPES = (128, 2048, 65536)  # decode tick (4 slots x 32 heads), 64-token
#                              prefill (64 x 32 heads), a large batch
ROWS_SHAPES = (128, 2048, 16384, 65536)  # + the tiered train step's n
RANGE_SHAPES = (128, 2048, 32768)  # + one data rank's n on the mesh step
RANGE_ROWS = 2**19  # one rank's shard of the 2^20-row table, model 2
# path (h)'s memory reads: a decode tick of 4 slots x 96 / 192 / 240 / 256
# heads (qwen2-1.5b, starcoder2-3b, danube, yi-9b), a 64-token yi-9b prompt
# (64 x 256); danube's 8,192-token prompt x 240 heads; path (n)'s decode
# tick of 4 slots x 128 heads (mamba2-1.3b; its MoE archs' 256 are 1,024);
# path (o)'s decode steps of 4 sequences x 48 heads (whisper-small: 192;
# qwen2-vl-72b's 512 heads give 2,048, in SHAPES)
H_SHAPES = (192, 384, 512, 768, 960, 1024, 16384)
# path (p)'s train steps: 2,048 tokens x 96 / 128 / 256 memory heads
# (qwen2-1.5b, mamba2-1.3b, phi3.5-moe); (p4a)'s data rank holds half of
# phi's (the range gather and its backward at 262,144)
P_SHAPES = (196608, 262144, 524288)
P4A_RANGE_N = 262144
H_BIG_N = 8192 * 240
PLAIN_SLICE = 65536  # the plain versions' share of the H_BIG_N call
TOP_K = 32
LOG2_LOCATIONS = 20
M = 64
SHARD_ROWS, CACHE_SLOTS = 8192, 32  # lram-tiered's full-width TieredSpec
ST_RANGES, ST_CACHE_SLOTS = 4, 8  # lram-sharded-tiered's, a range
PAYLOADS = ("int8", "fp8")

CSRC = "src/repro_torch/kernels/csrc"
# name -> (wrapper with its launch count, CUDA source, TPU kernel replaced)
KERNELS = {
    "lram_query": (e8_lookup.lram_query, f"{CSRC}/e8_lookup.cu",
                   "src/repro/kernels/e8_lookup.py:189"),
    "gather_interp": (gather_interp.gather_interp,
                      f"{CSRC}/gather_interp.cu",
                      "src/repro/kernels/gather_interp.py:73"),
    "gather_interp_quant": (gather_interp.gather_interp_quant,
                            f"{CSRC}/gather_interp_quant.cu",
                            "src/repro/kernels/gather_interp.py:138"),
    "tiered_gather": (tiered_gather.tiered_gather,
                      f"{CSRC}/tiered_gather.cu",
                      "src/repro/kernels/tiered_gather.py:91"),
    "tiered_gather_quant": (tiered_gather.tiered_gather_quant,
                            f"{CSRC}/tiered_gather.cu",
                            "src/repro/kernels/tiered_gather.py:162"),
    "lookup_bwd": (ops.lookup_bwd, f"{CSRC}/lookup_bwd.cu",
                   "src/repro/kernels/ops.py:51 (backward :78); "
                   "src/repro/kernels/gather_interp.py:189 (backward :206)"),
    "lookup_bwd_rows": (ops.lookup_bwd_rows, f"{CSRC}/lookup_bwd.cu",
                        "src/repro/kernels/gather_interp.py:189 (B1's VJP "
                        "dw, backward :206, without the scatter: the "
                        "tiered VJP, src/repro/memstore/interp.py:99)"),
    "lookup_bwd_quant": (ops.lookup_bwd_quant, f"{CSRC}/lookup_bwd.cu",
                         "src/repro/kernels/gather_interp.py:148 (B4's "
                         "VJP, backward :165)"),
    "sharded_gather": (sharded_gather.sharded_gather,
                       f"{CSRC}/sharded_gather.cu",
                       "src/repro/distributed/sharded_lram.py:62 "
                       "(sharded_gather_interp, fp32 shard :92-102: "
                       "src/repro/kernels/gather_interp.py:73)"),
    "sharded_gather_quant": (sharded_gather.sharded_gather_quant,
                             f"{CSRC}/sharded_gather.cu",
                             "src/repro/distributed/sharded_lram.py:62 "
                             "(sharded_gather_interp, 1-byte shard "
                             ":104-118: src/repro/kernels/"
                             "gather_interp.py:138)"),
    "lookup_bwd_range": (ops.lookup_bwd_range, f"{CSRC}/lookup_bwd.cu",
                         "src/repro/distributed/sharded_lram.py:62 (the "
                         "autodiff of its shard-local gathers: "
                         "src/repro/kernels/gather_interp.py:206, :165)"),
    # the bf16-table instances (path (m)), each with its own count
    "gather_interp_bf16": (gather_interp.gather_interp_bf16,
                           f"{CSRC}/gather_interp.cu",
                           "src/repro/kernels/gather_interp.py:73 (a bf16 "
                           "table: row_ref[...].astype(out_ref.dtype), "
                           ":40)"),
    "lookup_bwd_bf16": (ops.lookup_bwd_bf16, f"{CSRC}/lookup_bwd.cu",
                        "src/repro/kernels/ops.py:51 (backward :78, "
                        "dvalues.astype(values.dtype) :98); "
                        "src/repro/kernels/gather_interp.py:189 (backward "
                        ":206, :217) on bf16 rows"),
    "sharded_gather_bf16": (sharded_gather.sharded_gather_bf16,
                            f"{CSRC}/sharded_gather.cu",
                            "src/repro/distributed/sharded_lram.py:62 (a "
                            "bf16 shard, .astype(w_l.dtype) :105: "
                            "src/repro/kernels/gather_interp.py:73)"),
    "lookup_bwd_range_bf16": (ops.lookup_bwd_range_bf16,
                              f"{CSRC}/lookup_bwd.cu",
                              "src/repro/distributed/sharded_lram.py:62 "
                              "(the autodiff of its bf16 shard gather: "
                              "src/repro/kernels/gather_interp.py:206, "
                              ":217)"),
    # the fp16-table instances (path (q)), each with its own count
    "gather_interp_f16": (gather_interp.gather_interp_f16,
                          f"{CSRC}/gather_interp.cu",
                          "src/repro/kernels/gather_interp.py:73 (an fp16 "
                          "table: row_ref[...].astype(out_ref.dtype), "
                          ":40)"),
    "lookup_bwd_f16": (ops.lookup_bwd_f16, f"{CSRC}/lookup_bwd.cu",
                       "src/repro/kernels/ops.py:51 (backward :78, "
                       "dvalues.astype(values.dtype) :98); "
                       "src/repro/kernels/gather_interp.py:189 (backward "
                       ":206, :217) on fp16 rows"),
    "sharded_gather_f16": (sharded_gather.sharded_gather_f16,
                           f"{CSRC}/sharded_gather.cu",
                           "src/repro/distributed/sharded_lram.py:62 (an "
                           "fp16 shard, .astype(w_l.dtype) :105: "
                           "src/repro/kernels/gather_interp.py:73)"),
    "lookup_bwd_range_f16": (ops.lookup_bwd_range_f16,
                             f"{CSRC}/lookup_bwd.cu",
                             "src/repro/distributed/sharded_lram.py:62 "
                             "(the autodiff of its fp16 shard gather: "
                             "src/repro/kernels/gather_interp.py:206, "
                             ":217)"),
}
# why the 2-byte instances have no library yardstick
BF16_NO_LIBRARY = ("none: F.embedding_bag over a bf16 table takes bf16 "
                   "per-sample weights and sums in bf16, another function "
                   "than an fp32 sum of widened rows")
F16_NO_LIBRARY = ("none: F.embedding_bag over an fp16 table takes fp16 "
                  "per-sample weights and returns fp16, another function "
                  "than an fp32 sum of widened rows")
# a 2-byte table dtype -> (its instances' suffix, why no library yardstick)
HALF = {torch.bfloat16: ("bf16", BF16_NO_LIBRARY),
        torch.float16: ("f16", F16_NO_LIBRARY)}
# the shape of the kernels line's headline numbers: the serving decode tick
# (n = 128), or a train step's n for the backward kernel's instances
HEAD_N = {"lookup_bwd": 65536, "lookup_bwd_rows": 16384,
          "lookup_bwd_quant": 16384, "sharded_gather": 32768,
          "sharded_gather_quant": 32768, "lookup_bwd_range": 32768,
          "lookup_bwd_bf16": 65536, "sharded_gather_bf16": 32768,
          "lookup_bwd_range_bf16": 32768, "lookup_bwd_f16": 65536,
          "sharded_gather_f16": 32768, "lookup_bwd_range_f16": 32768}

SERVE_ARGS = ["--batch", "4", "--prompt-len", "64", "--gen", "32",
              "--requests", "8", "--seed", "0", "--warmup"]
# path -> (serve arguments, kernels that must launch)
PATHS = {
    "dense": (["--arch", "lram-tiered", "--placement", "pallas"],
              ("lram_query", "gather_interp")),
    "a_tiered": (["--arch", "lram-tiered"],
                 ("lram_query", "gather_interp")),
    "b_tiered_q8": (["--arch", "lram-tiered-q8"],
                    ("lram_query", "gather_interp_quant")),
    "c_tiered_resident": (["--arch", "lram-tiered", "--cache-slots", "128"],
                          ("lram_query", "tiered_gather")),
    "d_tiered_q8_resident": (["--arch", "lram-tiered-q8",
                              "--cache-slots", "128"],
                             ("lram_query", "tiered_gather_quant")),
    "e_sharded_tiered": (["--arch", "lram-sharded-tiered"],
                         ("lram_query", "gather_interp")),
    "f_sharded_tiered_resident": (["--arch", "lram-sharded-tiered",
                                   "--cache-slots", "32"],
                                  ("lram_query", "tiered_gather")),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def reset_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def time_ms(fn, budget_ms: float = 200.0) -> float:
    """Mean time of one call, by CUDA events over repeated calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max(budget_ms / once, 3), 200))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bound(distinct_rows: int, row_bytes: int, n: int):
    """A gather's bound: each distinct row this run's indices name read
    once, plus the indices, weights and output."""
    return bound_ms(distinct_rows * row_bytes + n * TOP_K * 8 + 4 * n * M,
                    2 * n * TOP_K * M)


def no_scatter_bound(n: int, distinct: int, row_bytes: int, stage: str,
                     terms: int, rows_apart: bool):
    """The bound of a backward instance without scatter: each distinct row
    read once; g, w and the rows read (with dq also q, and idx where the
    rows are not idx), the output (dq or dw); 2 flops a term of the dots
    (`terms` (t, k) pairs), 40 more a term for dq."""
    if stage == "dq":
        small = 4 * n * TOP_K * rows_apart + 32 * n + 32 * n
    else:
        small = 4 * n * TOP_K
    return bound_ms(distinct * row_bytes + 4 * n * M + 8 * n * TOP_K + small,
                    2 * terms * M + (40 * terms if stage == "dq" else 0))


def b4_split(table, scale, ix, w, split: int, wide: int) -> torch.Tensor:
    """B4 through its C entry with an explicit split (warps a query) and
    variant (wide 1: 8-byte loads where they fit; 0: byte pairs); counts
    no launch."""
    name = "i8" if table.dtype == torch.int8 else "e4m3"
    fn = _build.function(
        "gather_interp_quant", f"gather_interp_quant_{name}_split",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty(ix.shape[0], table.shape[1], device=table.device)
    _build.check(fn(table.data_ptr(), scale.data_ptr(), ix.data_ptr(),
                    w.data_ptr(), out.data_ptr(), ix.shape[0], ix.shape[1],
                    table.shape[1], split, wide, table.device.index,
                    torch.cuda.current_stream().cuda_stream), "B4 split")
    return out


def b5_split(cache, gid, slot_table, w, split: int) -> torch.Tensor:
    """B5 through its C entry with an explicit split; counts no launch."""
    fn = _build.function(
        "tiered_gather", "tiered_gather_f32_split",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty(gid.shape[0], cache.shape[1], device=cache.device)
    _build.check(fn(cache.data_ptr(), gid.data_ptr(), slot_table.data_ptr(),
                    w.data_ptr(), out.data_ptr(), gid.shape[0], gid.shape[1],
                    cache.shape[1], tiered_gather._log2(SHARD_ROWS), split,
                    cache.device.index,
                    torch.cuda.current_stream().cuda_stream), "B5 split")
    return out


def b6_split(cache, scale, gid, slot_table, w, split: int,
             wide: int) -> torch.Tensor:
    """B6 through its C entry with an explicit split and variant (wide 1:
    8-byte loads where they fit; 0: byte pairs); counts no launch."""
    name = "i8" if cache.dtype == torch.int8 else "e4m3"
    fn = _build.function(
        "tiered_gather", f"tiered_gather_quant_{name}_split",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    out = torch.empty(gid.shape[0], cache.shape[1], device=cache.device)
    _build.check(fn(cache.data_ptr(), scale.data_ptr(), gid.data_ptr(),
                    slot_table.data_ptr(), w.data_ptr(), out.data_ptr(),
                    gid.shape[0], gid.shape[1], cache.shape[1],
                    tiered_gather._log2(SHARD_ROWS), split, wide,
                    cache.device.index,
                    torch.cuda.current_stream().cuda_stream), "B6 split")
    return out


def split_ms(what: str, call, want, kernel: str, wides=(0, 1)) -> dict:
    """A gather at every split (warps a query) and variant through its C
    entry, `call(split, wide)`, each held against the plain version's
    output `want` (rtol 2e-5 / atol 1e-6): device ms of `kernel` by split
    ("8w": 8 warps a query, wide loads; "8p": pairs)."""
    out = {}
    for split in (1, 2, 4, 8):
        for wide in wides:
            got = call(split, wide)
            check(torch.allclose(got, want, rtol=2e-5, atol=1e-6),
                  f"{what} split {split} wide {wide} differs from its plain "
                  f"version by {(got - want).abs().max().item()}")
            out[f"{split}{'w' if wide else 'p'}"] = device_ms(
                lambda: call(split, wide), kernel)
    return out


def _kernel_of(symbol: str) -> tuple[str, str]:
    """(kernel name, instance) of a mangled kernel symbol: the name whose
    length prefix ends in `_kernel`, and its template arguments (payload
    type, then each bool as 0 / 1 and each int), e.g. ("lookup_bwd_kernel",
    "f32,1,0,0,1")."""
    for m in re.finditer(r"\d+", symbol):  # a hash may run into the prefix
        sizes = {int(m.group()[i:]) for i in range(len(m.group()))}
        name = next((symbol[m.end():m.end() + n] for n in sizes
                     if symbol[m.end():m.end() + n].endswith("_kernel")
                     and m.end() + n <= len(symbol)), None)
        if name:
            rest = symbol[m.end() + len(name):]
            if not rest.startswith("I"):
                return name, ""
            args = rest.split("EEv")[0] + "E"
            payload = ("f32" if args.startswith("If") else "i8"
                       if args.startswith("Ia") else "e4m3"
                       if args.startswith("I13__nv_fp8_e4m3") else "bf16"
                       if args.startswith("I13__nv_bfloat16") else "")
            return name, ",".join([payload]
                                  + re.findall(r"L[bi](\d+)E", args))
    return symbol, ""


def ptxas_report(log: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of each kernel in
    nvcc's -Xptxas -v output."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, instance = _kernel_of(m.group(1))
            out.append({"kernel": name, "instance": instance})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(m.group(1)) if m else 0
    return out


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(fn):
    """Run fn under torch.profiler; (result, {device activity: us},
    {device activity: calls}).  Only device-side events count (kernels,
    copies): the CPU ops that launched them would count the same time
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    per_kernel, calls = {}, {}
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us > 0 and evt.device_type == DeviceType.CUDA:
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
            calls[evt.key] = calls.get(evt.key, 0) + evt.count
    return out, per_kernel, calls


def device_split(fn, kernel: str, calls: int = 20):
    """Device ms of one call's kernels whose names hold `kernel` (a call
    may launch several: the backward's scatter instances launch a
    pipeline, each kernel once), the sum of each one's mean over the
    launches the profiler recorded; and of everything else the call ran
    (fills, copies) per call; and the kernel names it matched.  A profiler session now and then delivers none or
    only some of its kernel records (the cells of the table that read
    "not measured"): a session that recorded fewer than `calls` launches
    of a matched kernel is run again, up to PROFILE_SESSIONS sessions, and
    the one that recorded the most launches is kept (`profile_sessions`:
    each session's launches of ours and all its device events).  None
    where no session saw device time."""
    fn()
    best, by_session = None, []
    for session in range(1, PROFILE_SESSIONS + 1):
        _, per_kernel, counts = profile(lambda: [fn() for _ in range(calls)])
        ours = [k for k in per_kernel if kernel in k]
        check(all(counts[k] <= calls for k in ours),
              f"{kernel}: a call launched one of {ours} more than once")
        recorded = sum(counts[k] for k in ours)
        # launches of ours, and all device events, each session recorded
        by_session.append([recorded, sum(counts.values())])
        if best is None or recorded > best[0]:
            best = (recorded, per_kernel, counts, ours)
        if ours and all(counts[k] == calls for k in ours):
            break
    recorded, per_kernel, counts, ours = best
    rest = [k for k in per_kernel if k not in ours]
    ours_ms = (sum(per_kernel[k] / counts[k] for k in ours) / 1e3
               if ours else None)
    rest_ms = (sum(per_kernel[k] for k in rest) / calls / 1e3
               if rest else None)
    return ours_ms, rest_ms, {
        "device_events": recorded, "device_calls": calls,
        "profile_sessions": by_session,
        "device_kernels": [k[:120] for k in ours]}


def device_ms(fn, kernel: str, calls: int = 20):
    """Device time of one launch of `kernel` (profiler), or None if the
    profiler saw no device time."""
    return device_split(fn, kernel, calls)[0]


def measure(name, n, fn, plain, tol, *, device_kernel, bound, extra=None,
            library=None, library_tol=(1e-5, 1e-5)):
    """Hold `fn` against `plain` (allclose with tol = (rtol, atol)) and
    time kernel, plain version and library call (held against the plain
    version to library_tol): one row of the table."""
    out, want = fn(), plain()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(torch.allclose(out, want, rtol=tol[0], atol=tol[1]),
          f"{name} differs from its plain version by {err} at n={n}")
    lib_ms = None
    if library is not None:
        check(torch.allclose(library(), want, rtol=library_tol[0],
                             atol=library_tol[1]),
              f"{name}: the library yardstick disagrees at n={n}")
        lib_ms = time_ms(library)
    b, by = bound
    dev, _, seen = device_split(fn, device_kernel)
    return {"n": n, "max_abs_err": err, "ms": time_ms(fn),
            "device_ms": dev, **seen,
            "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, **(extra or {})}


def ulps_apart(a: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Elementwise distance of two fp32 tensors rounded to the 2-byte
    `dtype`, in its ulps (the sign-magnitude words mapped to a monotone
    scale)."""
    def scale(t):
        x = t.to(dtype).view(torch.int16).int()
        return torch.where(x < 0, -32768 - x, x)
    return (scale(a) - scale(b)).abs()


def rounding_agrees(got: torch.Tensor, want: torch.Tensor,
                    dtype: torch.dtype) -> dict:
    """Two fp32 gradients rounded once to the 2-byte `dtype` (a table's):
    each element within one ulp of it, or, where an fp32 sum cancels,
    within 1e-3 of the largest magnitude (the fp32 atol regime).  Returns
    the counts."""
    ulps = ulps_apart(got, want, dtype)
    near = (got.to(dtype).float() - want.to(dtype).float()).abs() \
        <= 1e-3 * want.abs().max()
    return {"ok": bool(((ulps <= 1) | near).all()),
            "max_ulps": int(ulps.max()),
            "beyond_1_ulp": int((ulps > 1).sum()), "elements": ulps.numel()}


def backward_rows(n, spec, values, q, idx, w, gen, wide=None):
    """The backward kernel at one n, both scatter instances (dq, dw: the
    body and the scatter's pipeline), against `lookup_bwd_plain`: dvalues
    to atol 1e-5 (a row's sum runs in placement order, which atomics set),
    dq / dw to rtol 1e-4 / atol 1e-5.  On a 2-byte table (its own
    instances) also dvalues rounded once to the table's dtype
    (`rounding_agrees`); no library yardstick there (`HALF`).  `wide`
    (the same table widened to fp32): dq / dw bit for bit the fp32
    instance's on it, their device time beside."""
    half = values.dtype in HALF
    g = torch.randn(n, M, generator=gen, device=values.device)
    distinct = torch.unique(idx).numel()
    rows = []
    for stage in ("dq", "dw"):
        extra = {"q": q, "spec": spec} if stage == "dq" else {}
        fn = lambda: ops.lookup_bwd(values, idx, w, g, **extra)  # noqa: E731
        plain = lambda: ops.lookup_bwd_plain(  # noqa: E731
            values, idx, w, g, **extra)
        (dv, small), (dv_p, small_p) = fn(), plain()
        torch.cuda.synchronize()
        err_dv = (dv - dv_p).abs().max().item()
        err_small = (small - small_p).abs().max().item()
        check(torch.allclose(dv, dv_p, rtol=0, atol=1e-5)
              and torch.allclose(small, small_p, rtol=1e-4, atol=1e-5),
              f"lookup_bwd ({stage}, {values.dtype}) differs from its plain "
              f"version at n={n}: dvalues {err_dv}, {stage} {err_small}")
        notes = {}
        if half:
            suffix, why = HALF[values.dtype]
            rounded = rounding_agrees(dv, dv_p, values.dtype)
            check(rounded["ok"], f"lookup_bwd ({stage}, {suffix}): dvalues "
                                 f"rounded to {suffix} differ: {rounded}")
            notes = {f"dvalues_{suffix}": rounded, "library_note": why}
        if wide is not None:
            twin = lambda: ops.lookup_bwd(  # noqa: E731
                wide, idx, w, g, **extra)
            same = torch.equal(small, twin()[1])
            check(same, f"lookup_bwd ({stage}, {values.dtype}) at n={n}: "
                        f"{stage} not bit-equal to the fp32 instance on the "
                        f"widened table")
            notes.update({f"{stage}_bit_equal_fp32_instance": same,
                          "fp32_instance_device_ms": device_ms(
                              twin, "lookup_bwd")})
        lib_ms = None
        if stage == "dw" and not half:  # one PyTorch call: dvalues and dw
            vals = values.detach().requires_grad_()
            ww = w.detach().requires_grad_()
            bag = F.embedding_bag(idx.long(), vals, per_sample_weights=ww,
                                  mode="sum")
            lib = lambda: torch.autograd.grad(  # noqa: E731
                bag, (vals, ww), g, retain_graph=True)
            l_dv, l_dw = lib()
            check(torch.allclose(l_dv, dv_p, rtol=0, atol=1e-5)
                  and torch.allclose(l_dw, small_p, rtol=1e-4, atol=1e-5),
                  f"lookup_bwd: the embedding_bag yardstick disagrees at "
                  f"n={n}")
            lib_ms = time_ms(lib)
            del vals, ww, bag, l_dv, l_dw
        # g, idx + w, q; the output (dq or dw)
        small = (4 * n * M + 8 * n * TOP_K
                 + (64 * n if stage == "dq" else 4 * n * TOP_K))
        fill = values.numel() * 4  # the dense fp32 dvalues, written once
        ops_n = 4 * n * TOP_K * M + (n * TOP_K * 40 if stage == "dq" else 0)
        # the function (the call): each distinct row read once, dvalues
        # written once (the kernels write it whole)
        b, by = bound_ms(distinct * values.element_size() * M + fill + small,
                         ops_n)
        dev, rest, seen = device_split(fn, "lookup_bwd")
        rows.append({**notes,
            "n": n, "stage": stage, "max_abs_err": max(err_dv, err_small),
            "dvalues_max_abs_err": err_dv, f"{stage}_max_abs_err": err_small,
            "ms": time_ms(fn), "device_ms": dev, **seen,
            "fill_device_ms": rest, "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, "distinct_rows": distinct})
        del dv, small, dv_p, small_p
    return rows


def k2_row(rows, n, q, spec, values, ties: bool = True):
    """K2 at one n against its plain version, bit for bit: weights and
    indices on the uniform queries q and on `lattice.tie_queries` (exact
    ties of weight, most at the top-32's cut; and ties in the canonical
    sort), and the output the uniform set gathers; the timings on q, with
    the device time on the weight-tie set beside them.  Without `ties`
    the uniform set alone (path (p)'s n, where drawing the tie sets takes
    the host seconds; smaller n hold the tie rule).  Appends its row and
    returns the kernel's (idx, w) on q."""
    sets = {"uniform": q}
    for name, distinct in (("weight_ties", True),
                           ("sort_ties", False)) if ties else ():
        sets[name] = torch.from_numpy(lattice.tie_queries(
            n, spec.K, seed=n, distinct=distinct)).to(q.device)
    same = {}
    for name, qs in sets.items():
        idx, w = e8_lookup.lram_query(qs, spec, TOP_K)
        idx_p, w_p = e8_lookup.lram_query_plain(qs, spec, TOP_K)
        torch.cuda.synchronize()
        same[name] = (idx == idx_p).float().mean().item()
        w_err = (w - w_p).abs().max().item()
        check(same[name] == 1.0 and torch.equal(w, w_p),
              f"K2 differs from its plain version on the {name} queries at "
              f"n={n}: {same[name]} of the indices equal, weights by "
              f"{w_err}")
        if name == "uniform":
            idx_u, w_u = idx, w
            out = gather_interp.gather_interp_plain(values, idx, w)
            out_p = gather_interp.gather_interp_plain(values, idx_p, w_p)
            check(torch.allclose(out, out_p, rtol=2e-5, atol=1e-5),
                  f"K2 gathered output differs at n={n}: max "
                  f"{(out - out_p).abs().max().item()}")
    k2 = lambda: e8_lookup.lram_query(q, spec, TOP_K)  # noqa: E731
    # per query: 232 distances of 23 fp32 ops, and the compares a top-k of
    # 232 needs (232 * log2 k), not the kernel's k full passes
    b2 = bound_ms(n * 8 * 4 + n * TOP_K * 8,
                  n * 232 * (23 + math.log2(TOP_K)))
    dev, _, seen = device_split(k2, "lram_query_kernel")
    rows["lram_query"].append({
        "n": n, "max_abs_err": 0.0, "same_idx_frac": same["uniform"],
        "same_idx_frac_by_set": same, "w_bit_equal": True,
        "out_max_abs_err": (out - out_p).abs().max().item(),
        "ms": time_ms(k2), "device_ms": dev, **seen,
        "weight_ties_device_ms": device_ms(
            lambda: e8_lookup.lram_query(sets["weight_ties"], spec, TOP_K),
            "lram_query_kernel") if ties else None,
        "plain_ms": time_ms(lambda: e8_lookup.lram_query_plain(
            q, spec, TOP_K)),
        "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None})
    return idx_u, w_u


def in_turns(fn_a, fn_b) -> tuple[list, list]:
    """Call ms of fn_a and fn_b, timed a, b, b, a."""
    a, b = [], []
    for which in (a, b, b, a):
        which.append(time_ms(fn_a if which is a else fn_b))
    return a, b


def kernel_phase(device):
    spec = indexing.choose_torus(LOG2_LOCATIONS)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn(spec.num_locations, M, generator=gen,
                         device=device)
    # the table rounded to bf16 and to fp16, and those values widened to
    # fp32: the 2-byte instances' inputs and their fp32 twins
    values_bf16 = values.to(torch.bfloat16)
    values_wide = values_bf16.float()
    values_f16 = values.half()
    values_wide16 = values_f16.float()
    wrap = torch.tensor(spec.K, dtype=torch.float32, device=device)
    host_values = values.cpu().numpy()
    tables = {}   # payload -> (q, scale) of the full table
    for kind in PAYLOADS:
        q, s = quant.quantize_rows_np(host_values, kind)
        tables[kind] = (quant.as_torch_payload(q).to(device),
                        torch.from_numpy(s).to(device))
    # a full-width device cache: 32 of the 128 shards resident, in
    # shuffled slots
    cache = torch.randn(CACHE_SLOTS * SHARD_ROWS, M, generator=gen,
                        device=device)
    caches = {}
    for kind in PAYLOADS:
        q, s = quant.quantize_rows_np(cache.cpu().numpy(), kind)
        caches[kind] = (quant.as_torch_payload(q).to(device),
                        torch.from_numpy(s).to(device))
    num_shards = spec.num_locations // SHARD_ROWS
    host_gen = torch.Generator().manual_seed(0)
    resident = torch.randperm(num_shards, generator=host_gen)[:CACHE_SLOTS]
    slot_table = torch.full((num_shards,), -1, dtype=torch.int32)
    slot_table[resident] = torch.randperm(CACHE_SLOTS,
                                          generator=host_gen).int()
    slot_table = slot_table.to(device)
    resident = resident.to(device)
    identity = torch.arange(num_shards, dtype=torch.int32, device=device)
    log2r = SHARD_ROWS.bit_length() - 1

    rows = {name: [] for name in KERNELS}
    for n in SHAPES:
        # torus coordinates in [0, K), as the memory layer hands them over
        q = torch.rand(n, 8, generator=gen, device=device) * wrap
        idx, w = k2_row(rows, n, q, spec, values)

        distinct = torch.unique(idx).numel()
        k1_dense_row(rows, n, values, idx, w, "uniform")
        k1_half_row(rows, n, values_bf16, values_wide, idx, w)
        k1_half_row(rows, n, values_f16, values_wide16, idx, w)
        rows["lookup_bwd"] += backward_rows(n, spec, values, q, idx, w, gen)
        rows["lookup_bwd_bf16"] += backward_rows(n, spec, values_bf16, q,
                                                 idx, w, gen,
                                                 wide=values_wide)
        rows["lookup_bwd_f16"] += backward_rows(n, spec, values_f16, q, idx,
                                                w, gen, wide=values_wide16)
        for kind in PAYLOADS:
            tq, ts = tables[kind]
            b4 = measure(
                f"B4 ({kind})", n,
                lambda: gather_interp.gather_interp_quant(tq, ts, idx, w),
                lambda: gather_interp.gather_interp_quant_plain(tq, ts, idx,
                                                                w),
                (2e-5, 1e-6), device_kernel="gather_interp_quant_kernel",
                bound=gather_bound(distinct, M + 4, n),
                extra={"payload": kind, "route": "dense",
                       "distinct_rows": distinct})
            if n <= 2048:  # decode sizes: every split, both variants
                b4["split_device_ms"] = split_ms(
                    "B4", lambda sp, wd: b4_split(tq, ts, idx, w, sp, wd),
                    gather_interp.gather_interp_quant_plain(tq, ts, idx, w),
                    "gather_interp_quant_kernel")
            rows["gather_interp_quant"].append(b4)

        # the same access pattern moved into the resident shards of the
        # 32-slot cache; then the whole table resident, as serve paths (c)
        # and (d) hold it after warm() (128 slots, shard s in slot s), so
        # that B5 and B6 read the rows K1 and B4 read above
        gid = ((resident[(idx >> log2r) % CACHE_SLOTS] << log2r)
               | (idx & (SHARD_ROWS - 1))).int()
        tiered_rows(rows, n, cache, caches, slot_table, gid, w, CACHE_SLOTS)
        tiered_rows(rows, n, values, tables, identity, idx, w, num_shards)
        if n <= 2048:  # serve (e)'s and (f)'s decode tick and prefill
            sharded_tiered_rows(rows, n, values, idx, w, gen)
    # K1 on clustered queries (64 near each of n / 64 points), as
    # training's queries crowd rows
    n = SHAPES[-1]
    q = torch.rand(n // 64, 8, generator=gen, device=device) * wrap
    q = (q.repeat(64, 1) + 1e-3 * torch.rand(n, 8, generator=gen,
                                             device=device)).contiguous()
    idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    k1_dense_row(rows, n, values, idx, w, "clustered")
    for n in ROWS_SHAPES:
        no_scatter_rows(rows, n, spec, values, tables, wrap, gen)
    for n in ROWS_SHAPES[-2:]:  # training's crowded rows
        no_scatter_rows(rows, n, spec, values, tables, wrap, gen,
                        "clustered")
    for n in RANGE_SHAPES:
        range_rows(rows, n, spec, values, tables, wrap, gen,
                   (values_bf16, values_f16))
    h_kernel_rows(rows, spec, values, wrap, gen, values_bf16, values_wide)
    for n in P_SHAPES:  # path (p)'s train steps: K2, K1, the backward
        q = torch.rand(n, 8, generator=gen, device=device) * wrap
        idx, w = k2_row(rows, n, q, spec, values, ties=False)
        k1_dense_row(rows, n, values, idx, w, "uniform")
        rows["lookup_bwd"] += backward_rows(n, spec, values, q, idx, w, gen)
    range_rows(rows, P4A_RANGE_N, spec, values, tables, wrap, gen, (),
               fp32_only=True)
    return rows


def h_kernel_rows(rows, spec, values, wrap, gen, values_bf16, values_wide):
    """K2 and K1 at path (h)'s shapes: its decode tick and yi-9b prompt
    (`k2_row`, `k1_dense_row`), and danube's prefill in one call
    (`big_rows`, K1's bf16 instance there too)."""
    for n in H_SHAPES:
        q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
        idx, w = k2_row(rows, n, q, spec, values)
        k1_dense_row(rows, n, values, idx, w, "uniform")
    big_rows(rows, H_BIG_N, spec, values, wrap, gen, values_bf16,
             values_wide)


def big_rows(rows, n, spec, values, wrap, gen, values_bf16, values_wide):
    """K2 and K1 in one call of n = 1,966,080 queries (danube's 8,192-token
    prefill x 240 memory heads: past every 32-bit count of the old
    shapes' n x k), held against their plain versions on the last
    PLAIN_SLICE queries of the full call's inputs and outputs (K2 bit for
    bit; K1 rtol 2e-5, atol 1e-6), and timed whole; the plain versions
    are timed on the slice (`plain_slice_ms`), the library yardstick
    (`F.embedding_bag`) whole."""
    q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
    k2 = lambda: e8_lookup.lram_query(q, spec, TOP_K)  # noqa: E731
    idx, w = k2()
    tail = slice(n - PLAIN_SLICE, n)
    idx_p, w_p = e8_lookup.lram_query_plain(q[tail], spec, TOP_K)
    torch.cuda.synchronize()
    check(torch.equal(idx[tail], idx_p) and torch.equal(w[tail], w_p),
          f"K2 differs from its plain version at n={n} (last "
          f"{PLAIN_SLICE} queries)")
    b2 = bound_ms(n * 8 * 4 + n * TOP_K * 8,
                  n * 232 * (23 + math.log2(TOP_K)))
    dev, _, seen = device_split(k2, "lram_query_kernel")
    rows["lram_query"].append({
        "n": n, "max_abs_err": 0.0, "w_bit_equal": True,
        "checked_queries": PLAIN_SLICE, "ms": time_ms(k2),
        "device_ms": dev, **seen, "plain_ms": None,
        "plain_slice_ms": time_ms(lambda: e8_lookup.lram_query_plain(
            q[tail], spec, TOP_K)),
        "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None})
    k1 = lambda: gather_interp.gather_interp(values, idx, w)  # noqa: E731
    out = k1()
    want = gather_interp.gather_interp_plain(values, idx[tail], w[tail])
    torch.cuda.synchronize()
    err = (out[tail] - want).abs().max().item()
    check(torch.allclose(out[tail], want, rtol=2e-5, atol=1e-6),
          f"K1 differs from its plain version by {err} at n={n}")
    idx64 = idx.long()
    library = lambda: F.embedding_bag(  # noqa: E731
        idx64, values, per_sample_weights=w, mode="sum")
    check(torch.allclose(library()[tail], want, rtol=1e-5, atol=1e-5),
          f"K1: the library yardstick disagrees at n={n}")
    distinct = torch.unique(idx).numel()
    b1 = gather_bound(distinct, 4 * M, n)
    dev, _, seen = device_split(k1, "gather_interp_kernel")
    rows["gather_interp"].append({
        "n": n, "max_abs_err": err, "checked_queries": PLAIN_SLICE,
        "ms": time_ms(k1), "device_ms": dev, **seen, "plain_ms": None,
        "plain_slice_ms": time_ms(lambda: gather_interp.gather_interp_plain(
            values, idx[tail], w[tail])),
        "bound_ms": b1[0], "bound_by": b1[1], "library_ms": time_ms(library),
        "route": "dense", "queries": "uniform", "distinct_rows": distinct})
    # K1's bf16 instance on the same call: the fp32 instance's output on
    # the widened table bit for bit, the plain version on the last queries
    k1b = lambda: gather_interp.gather_interp(  # noqa: E731
        values_bf16, idx, w)
    out = k1b()
    same = torch.equal(out, gather_interp.gather_interp(values_wide, idx, w))
    want = gather_interp.gather_interp_plain(values_bf16, idx[tail], w[tail])
    torch.cuda.synchronize()
    err = (out[tail] - want).abs().max().item()
    check(same and torch.allclose(out[tail], want, rtol=2e-5, atol=1e-6),
          f"K1 (bf16) at n={n}: bit-equal to the fp32 instance {same}, "
          f"{err} from its plain version")
    b1 = gather_bound(distinct, 2 * M, n)
    dev, _, seen = device_split(k1b, "gather_interp_kernel")
    rows["gather_interp_bf16"].append({
        "n": n, "max_abs_err": err, "checked_queries": PLAIN_SLICE,
        "bit_equal_fp32_instance": same, "ms": time_ms(k1b),
        "device_ms": dev, **seen, "plain_ms": None,
        "plain_slice_ms": time_ms(lambda: gather_interp.gather_interp_plain(
            values_bf16, idx[tail], w[tail])),
        "bound_ms": b1[0], "bound_by": b1[1], "library_ms": None,
        "library_note": BF16_NO_LIBRARY, "distinct_rows": distinct})


def tiered_rows(rows, n, cache, caches, slot_table, gid, w, slots):
    """B5 on the fp32 cache and B6 on each 1-byte one (`caches`: payload
    -> (q, scale)) through `slot_table`, against their plain versions
    (rtol 2e-5 / atol 1e-6); library yardstick for B5 `F.embedding_bag`
    on the rows already translated (the translation not timed); at the
    decode sizes every split (B6: with and without the wide loads)."""
    distinct = torch.unique(gid).numel()
    rows64 = tiered_gather.cache_rows(gid, slot_table, SHARD_ROWS)
    extra = {"cache_slots": slots, "distinct_rows": distinct}

    def b5():
        return tiered_gather.tiered_gather(cache, gid, slot_table, w,
                                           shard_rows=SHARD_ROWS,
                                           resident=True)

    def b5_library():
        return F.embedding_bag(rows64, cache, per_sample_weights=w,
                               mode="sum")
    row = measure(
        f"B5 ({slots} slots)", n, b5,
        lambda: tiered_gather.tiered_gather_plain(
            cache, gid, slot_table, w, shard_rows=SHARD_ROWS),
        (2e-5, 1e-6), device_kernel="tiered_gather_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={**extra, "library_note": "embedding_bag on pre-translated "
                                        "rows; translation not timed"},
        library=b5_library)
    # call ms of B5 and of its yardstick again, in turns
    row["ms_turns"], row["library_ms_turns"] = in_turns(b5, b5_library)
    if n <= 2048:
        row["split_device_ms"] = split_ms(
            f"B5 ({slots} slots)",
            lambda sp, _: b5_split(cache, gid, slot_table, w, sp),
            tiered_gather.tiered_gather_plain(cache, gid, slot_table, w,
                                              shard_rows=SHARD_ROWS),
            "tiered_gather_kernel", wides=(0,))
    rows["tiered_gather"].append(row)
    for kind in PAYLOADS:
        cq, cs = caches[kind]

        def plain():
            return tiered_gather.tiered_gather_quant_plain(
                cq, cs, gid, slot_table, w, shard_rows=SHARD_ROWS)
        row = measure(
            f"B6 ({kind}, {slots} slots)", n,
            lambda: tiered_gather.tiered_gather_quant(
                cq, cs, gid, slot_table, w, shard_rows=SHARD_ROWS,
                resident=True),
            plain, (2e-5, 1e-6), device_kernel="tiered_gather_quant_kernel",
            bound=gather_bound(distinct, M + 4, n),
            extra={**extra, "payload": kind})
        if n <= 2048:
            row["split_device_ms"] = split_ms(
                f"B6 ({kind}, {slots} slots)",
                lambda sp, wd: b6_split(cq, cs, gid, slot_table, w, sp, wd),
                plain(), "tiered_gather_quant_kernel")
        rows["tiered_gather_quant"].append(row)


def k1_dense_row(rows, n, values, idx, w, queries):
    """K1 on the dense table against its plain version to 1e-5; library
    yardstick `F.embedding_bag`."""
    distinct = torch.unique(idx).numel()
    idx64 = idx.long()
    rows["gather_interp"].append(measure(
        "K1", n, lambda: gather_interp.gather_interp(values, idx, w),
        lambda: gather_interp.gather_interp_plain(values, idx, w),
        (1e-5, 1e-5), device_kernel="gather_interp_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={"route": "dense", "queries": queries,
               "distinct_rows": distinct},
        library=lambda: F.embedding_bag(idx64, values,
                                        per_sample_weights=w,
                                        mode="sum")))


def k1_half_row(rows, n, values_half, values_wide, idx, w):
    """K1's bf16 or fp16 instance on the table rounded to that dtype: its
    output equal bit for bit to the fp32 instance's on the same values
    widened (the same adds in the same order), within rtol 2e-5 / atol
    1e-6 of its plain version; the fp32 instance's device time on the
    widened table beside it (the same rows at twice the bytes).  No
    library yardstick (`HALF`)."""
    suffix, why = HALF[values_half.dtype]
    fn = lambda: gather_interp.gather_interp(  # noqa: E731
        values_half, idx, w)
    wide = lambda: gather_interp.gather_interp(  # noqa: E731
        values_wide, idx, w)
    same = torch.equal(fn(), wide())
    check(same, f"K1 ({suffix}) at n={n}: not bit-equal to the fp32 "
                f"instance on the widened table")
    distinct = torch.unique(idx).numel()
    rows[f"gather_interp_{suffix}"].append(measure(
        f"K1 ({suffix})", n, fn,
        lambda: gather_interp.gather_interp_plain(values_half, idx, w),
        (2e-5, 1e-6), device_kernel="gather_interp_kernel",
        bound=gather_bound(distinct, 2 * M, n),
        extra={"route": "dense", "queries": "uniform",
               "distinct_rows": distinct, "bit_equal_fp32_instance": same,
               "fp32_instance_device_ms": device_ms(
                   wide, "gather_interp_kernel"),
               "library_note": why}))


def range_rows(rows, n, spec, values, tables, wrap, gen, halves,
               fp32_only: bool = False):
    """Row 9's kernels at one n, on both halves of the table split over a
    2-way model axis (shards of 2^19 rows at base 0 and 2^19) with K2's
    indices (K2 itself where no other row holds n): the range
    gather over fp32 (to K1's tolerance, 1e-5; library yardstick
    `F.embedding_bag` over the shard with the clamped indices and the
    masked weights) and int8 / e4m3 shards (B4's, rtol 2e-5 / atol 1e-6),
    and the range backward, fp32 (scatter into the shard's dvalues) and
    1-byte (no scatter), each with dq and with dw, against
    `lookup_bwd_plain` with the range mask (dvalues atol 1e-5, atomics;
    dq / dw rtol 1e-4 / atol 1e-5).  `halves`: the table rounded to bf16
    and fp16, whose instances run on the lower half (the range gather bit
    for bit the fp32 instance's on the widened shard, the range backward's
    dq / dw too).  `fp32_only`: the fp32 cells alone (path (p4a)'s
    table)."""
    q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
    if n in SHAPES or n in P_SHAPES:
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    else:
        idx, w = k2_row(rows, n, q, spec, values)
    g = torch.randn(n, M, generator=gen, device=values.device)
    for base in (0, RANGE_ROWS):
        shard = values[base:base + RANGE_ROWS]
        rel, ok = sharded_gather.local_rows(idx, base, RANGE_ROWS)
        wm = (w * ok).contiguous()
        distinct = torch.unique(idx[ok]).numel()
        where = {"base": base, "shard_rows": RANGE_ROWS,
                 "in_range_share": float(ok.float().mean()),
                 "distinct_rows": distinct}
        rows["sharded_gather"].append(measure(
            "range gather (fp32)", n,
            lambda: sharded_gather.sharded_gather(shard, idx, w, base),
            lambda: sharded_gather.sharded_gather_plain(shard, idx, w, base),
            (1e-5, 1e-5), device_kernel="sharded_gather_kernel",
            bound=gather_bound(distinct, 4 * M, n), extra=where,
            library=lambda: F.embedding_bag(rel, shard,
                                            per_sample_weights=wm,
                                            mode="sum")))
        cells = [("fp32", shard, None)]
        for kind in () if fp32_only else PAYLOADS:
            tq, ts = tables[kind]
            sq, ss = tq[base:base + RANGE_ROWS], ts[base:base + RANGE_ROWS]
            cells.append((kind, sq, ss))
            rows["sharded_gather_quant"].append(measure(
                f"range gather ({kind})", n,
                lambda: sharded_gather.sharded_gather_quant(sq, ss, idx, w,
                                                            base),
                lambda: sharded_gather.sharded_gather_quant_plain(
                    sq, ss, idx, w, base),
                (2e-5, 1e-6), device_kernel="sharded_gather_kernel",
                bound=gather_bound(distinct, M + 4, n),
                extra={"payload": kind, **where}))
        for payload, table, scale in cells:
            for stage in ("dq", "dw"):
                rows["lookup_bwd_range"].append(range_backward_row(
                    n, stage, payload, table, scale, base, spec, q, idx, w,
                    g, rel, ok, where))
        if base or fp32_only:  # the 2-byte instances on the lower half
            continue
        for values_half in halves:
            suffix, why = HALF[values_half.dtype]
            shard_h = values_half[base:base + RANGE_ROWS]
            shard_w = shard_h.float()
            fn = lambda: sharded_gather.sharded_gather(  # noqa: E731
                shard_h, idx, w, base)
            same = torch.equal(fn(), sharded_gather.sharded_gather(
                shard_w, idx, w, base))
            check(same, f"range gather ({suffix}) at n={n}: not bit-equal "
                        f"to the fp32 instance on the widened shard")
            rows[f"sharded_gather_{suffix}"].append(measure(
                f"range gather ({suffix})", n, fn,
                lambda: sharded_gather.sharded_gather_plain(shard_h, idx, w,
                                                            base),
                (2e-5, 1e-6), device_kernel="sharded_gather_kernel",
                bound=gather_bound(distinct, 2 * M, n),
                extra={**where, "bit_equal_fp32_instance": same,
                       "library_note": why}))
            for stage in ("dq", "dw"):
                rows[f"lookup_bwd_range_{suffix}"].append(range_backward_row(
                    n, stage, suffix, shard_h, None, base, spec, q, idx, w,
                    g, rel, ok, where,
                    wide=shard_w))
            del shard_w


def range_backward_row(n, stage, payload, table, scale, base, spec, q, idx,
                       w, g, rel, ok, where, wide=None):
    """One instance of the range backward against `lookup_bwd_plain` with
    the range mask; its bound is the function's: each distinct in-range
    row read once, the shard's dvalues written once (fp32), g, idx, w, q
    and the output.  `wide` (a 2-byte shard widened to fp32): dq / dw bit
    for bit the fp32 instance's on it."""
    extra = {"q": q, "spec": spec} if stage == "dq" else {}
    fn = lambda: ops.lookup_bwd_range(  # noqa: E731
        table, idx, w, g, base, scale=scale, **extra)
    plain = lambda: ops.lookup_bwd_plain(  # noqa: E731
        table, idx, w, g, extra.get("q"), spec, scale=scale,
        scatter=scale is None, base=base)
    (dv, small), (dv_p, small_p) = fn(), plain()
    torch.cuda.synchronize()
    err_dv = 0.0 if dv is None else (dv - dv_p).abs().max().item()
    err_small = (small - small_p).abs().max().item()
    check((dv is None or torch.allclose(dv, dv_p, rtol=0, atol=1e-5))
          and torch.allclose(small, small_p, rtol=1e-4, atol=1e-5),
          f"lookup_bwd_range ({payload}, {stage}) differs from its plain "
          f"version at n={n}, base={base}: dvalues {err_dv}, {stage} "
          f"{err_small}")
    notes = {}
    if table.dtype in HALF:
        suffix, why = HALF[table.dtype]
        rounded = rounding_agrees(dv, dv_p, table.dtype)
        check(rounded["ok"], f"lookup_bwd_range ({suffix}, {stage}): "
                             f"dvalues rounded to {suffix} differ: {rounded}")
        notes = {f"dvalues_{suffix}": rounded, "library_note": why}
    if wide is not None:
        same = torch.equal(small, ops.lookup_bwd_range(
            wide, idx, w, g, base, **extra)[1])
        check(same, f"lookup_bwd_range ({payload}, {stage}) at n={n}: "
                    f"{stage} not bit-equal to the fp32 instance on the "
                    f"widened shard")
        notes[f"{stage}_bit_equal_fp32_instance"] = same
    lib_ms = None
    if table.dtype == torch.float32 and stage == "dw":
        # one PyTorch call: the backward of embedding_bag over the shard
        # with the clamped rows and masked weights (its dw, times the mask,
        # is the partial dw)
        vals = table.detach().requires_grad_()
        wm = (w * ok).detach().requires_grad_()
        bag = F.embedding_bag(rel, vals, per_sample_weights=wm, mode="sum")
        lib = lambda: torch.autograd.grad(  # noqa: E731
            bag, (vals, wm), g, retain_graph=True)
        l_dv, l_dw = lib()
        check(torch.allclose(l_dv, dv_p, rtol=0, atol=1e-5)
              and torch.allclose(l_dw * ok, small_p, rtol=1e-4, atol=1e-5),
              f"lookup_bwd_range: the embedding_bag yardstick disagrees at "
              f"n={n}")
        lib_ms = time_ms(lib)
        del vals, wm, bag, l_dv, l_dw
    distinct = where["distinct_rows"]
    row_bytes = table.element_size() * M if scale is None else M + 4
    fill = table.shape[0] * 4 * M if scale is None else 0
    small_bytes = (4 * n * M + 8 * n * TOP_K
                   + (64 * n if stage == "dq" else 4 * n * TOP_K))
    terms = int(ok.sum())  # the in-range (t, k): a dot, and a scatter
    ops_n = (4 if scale is None else 2) * terms * M \
        + (terms * 40 if stage == "dq" else 0)
    b, by = bound_ms(distinct * row_bytes + fill + small_bytes, ops_n)
    dev, rest, seen = device_split(fn, "lookup_bwd")
    out = {**notes, "n": n, "stage": stage, "payload": payload,
           "max_abs_err": max(err_dv, err_small),
           "dvalues_max_abs_err": err_dv if dv is not None else None,
           f"{stage}_max_abs_err": err_small, "ms": time_ms(fn),
           "device_ms": dev, **seen, "fill_device_ms": rest,
           "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by,
           "library_ms": lib_ms, **where}
    del dv, small, dv_p, small_p
    return out


def flat_route(values, idx, resident):
    """A tiered store's flat route over its table `values`: the resident
    shards' rows (the device cache, `resident` in slot order) with the
    other rows appended, one per index, and each index's row in that
    flat table."""
    log2r = SHARD_ROWS.bit_length() - 1
    slots = resident.numel()
    shard, row = idx.long() >> log2r, idx.long() & (SHARD_ROWS - 1)
    slot_of = torch.full((values.shape[0] // SHARD_ROWS,), -1,
                         dtype=torch.long, device=values.device)
    slot_of[resident] = torch.arange(slots, device=values.device)
    slot = slot_of[shard]
    mask = slot >= 0
    rows = torch.where(mask, slot * SHARD_ROWS + row, 0)
    rows[~mask] = slots * SHARD_ROWS + torch.arange(
        int((~mask).sum()), device=values.device)
    cache_rows = (resident[:, None] * SHARD_ROWS + torch.arange(
        SHARD_ROWS, device=values.device)).reshape(-1)
    flat = torch.cat([cache_rows, idx.long()[~mask]])
    return flat, rows.int().contiguous()


def sharded_tiered_rows(rows, n, values, idx, w, gen):
    """The gathers of serve paths (e) and (f) at one of their n (a decode
    tick, a prefill), on K2's indices over the full table split into
    `lram-sharded-tiered`'s 4 row ranges: one range's call as
    `ShardedTieredStore.gather` makes it, every token's k elements with
    those of the other ranges reading the range's first routed row at
    weight 0.  K1 over the range's flat route with 8 of its 32 shards
    cached (path (e)) and B5 on its whole range resident in 32 shuffled
    slots (path (f)), each against its plain version at the tolerance of
    its other rows; library yardstick `F.embedding_bag` on the same rows
    (B5's pre-translated)."""
    rng_rows, r = values.shape[0] // ST_RANGES, 1
    part = values[r * rng_rows:(r + 1) * rng_rows]
    sel = (idx // rng_rows) == r
    local = idx[sel] - r * rng_rows    # the routed elements, in order
    wm = torch.where(sel, w, 0.0).contiguous()
    shards = rng_rows // SHARD_ROWS
    extra = {"range": f"{r} of {ST_RANGES}",
             "routed_share": float(sel.float().mean())}

    cached = torch.randperm(shards, generator=gen,
                            device=values.device)[:ST_CACHE_SLOTS]
    flat, routed = flat_route(part, local, cached)
    table = part[flat].contiguous()
    rws = torch.full_like(idx, int(routed[0]))
    rws[sel] = routed
    distinct = torch.unique(rws).numel()
    rows["gather_interp"].append(measure(
        "K1 (sharded-tiered (e), one range's flat route)", n,
        lambda: gather_interp.gather_interp(table, rws, wm),
        lambda: gather_interp.gather_interp_plain(table, rws, wm),
        (1e-5, 1e-5), device_kernel="gather_interp_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={**extra, "route": "sharded-tiered (e)",
               "cache_slots": ST_CACHE_SLOTS, "distinct_rows": distinct,
               "overflow_share": float(
                   (routed >= ST_CACHE_SLOTS * SHARD_ROWS).float().mean())},
        library=lambda: F.embedding_bag(rws.long(), table,
                                        per_sample_weights=wm, mode="sum")))

    slot_of = torch.randperm(shards, generator=gen, device=values.device)
    cache = torch.empty_like(part)
    cache.view(shards, SHARD_ROWS, M)[slot_of] = part.view(
        shards, SHARD_ROWS, M)
    slot_table = slot_of.int()
    gid = torch.full_like(idx, int(local[0]))
    gid[sel] = local
    distinct = torch.unique(gid).numel()
    rows64 = tiered_gather.cache_rows(gid, slot_table, SHARD_ROWS)
    rows["tiered_gather"].append(measure(
        "B5 (sharded-tiered (f), one range resident)", n,
        lambda: tiered_gather.tiered_gather(cache, gid, slot_table, wm,
                                            shard_rows=SHARD_ROWS,
                                            resident=True),
        lambda: tiered_gather.tiered_gather_plain(
            cache, gid, slot_table, wm, shard_rows=SHARD_ROWS),
        (2e-5, 1e-6), device_kernel="tiered_gather_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={**extra, "route": "sharded-tiered (f)", "cache_slots": shards,
               "distinct_rows": distinct,
               "library_note": "embedding_bag on pre-translated rows; "
                               "translation not timed"},
        library=lambda: F.embedding_bag(rows64, cache,
                                        per_sample_weights=wm, mode="sum")))


def no_scatter_rows(rows, n, spec, values, tables, wrap, gen,
                    queries="uniform"):
    """The tiered train step's kernels at one n, on the flat route of K2's
    indices (32 of 128 shards cached, the other rows appended) for uniform
    or clustered queries (64 near each of n / 64 points): K2 itself where
    the serving shapes do not hold n (uniform queries); the forward
    gathers over the flat table, K1 (fp32) and B4 (int8, e4m3), to the
    serving rows' tolerances; the backward's instances without scatter,
    `lookup_bwd_rows` (fp32) and `lookup_bwd_quant` (int8, e4m3), each with
    dq and with dw, against `lookup_bwd_plain` to rtol 1e-4 / atol 1e-5
    (the scatter instances' tolerance for dq and dw)."""
    q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
    if queries == "clustered":
        q = (q[:n // 64].repeat(64, 1) + 1e-3 * torch.rand(
            n, 8, generator=gen, device=values.device)).contiguous()
    if n in SHAPES or queries == "clustered":
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    else:
        idx, w = k2_row(rows, n, q, spec, values)
    g = torch.randn(n, M, generator=gen, device=values.device)
    resident = torch.randperm(values.shape[0] // SHARD_ROWS,
                              generator=gen, device=values.device)[
                                  :CACHE_SLOTS]
    flat, rws = flat_route(values, idx, resident)
    rws64 = rws.long()
    distinct = torch.unique(rws).numel()
    overflow = float((rws >= CACHE_SLOTS * SHARD_ROWS).float().mean())
    cells = [("lookup_bwd_rows", "fp32", values[flat].contiguous(), None)]
    for kind in PAYLOADS:
        tq, ts = tables[kind]
        # rows taken through the payload's bytes (indexing takes no fp8)
        cells.append(("lookup_bwd_quant", kind,
                      tq.view(torch.uint8)[flat].view(tq.dtype),
                      ts[flat].contiguous()))
    route = {"route": "flat", "queries": queries, "distinct_rows": distinct,
             "overflow_share": overflow}
    for name, payload, table, scale in cells:
        fn = KERNELS[name][0]
        row_bytes = 4 * M if scale is None else M + 4
        if scale is None:
            rows["gather_interp"].append(measure(
                "K1 (flat route)", n,
                lambda: gather_interp.gather_interp(table, rws, w),
                lambda: gather_interp.gather_interp_plain(table, rws, w),
                (1e-5, 1e-5), device_kernel="gather_interp_kernel",
                bound=gather_bound(distinct, row_bytes, n), extra=route,
                library=lambda: F.embedding_bag(rws64, table,
                                                per_sample_weights=w,
                                                mode="sum")))
        else:
            rows["gather_interp_quant"].append(measure(
                f"B4 ({payload}, flat route)", n,
                lambda: gather_interp.gather_interp_quant(table, scale, rws,
                                                          w),
                lambda: gather_interp.gather_interp_quant_plain(
                    table, scale, rws, w),
                (2e-5, 1e-6), device_kernel="gather_interp_quant_kernel",
                bound=gather_bound(distinct, row_bytes, n),
                extra={"payload": payload, **route}))
        for stage in ("dq", "dw"):
            extra = ({"idx": idx, "q": q, "spec": spec} if stage == "dq"
                     else {})
            args = (table, rws) if scale is None else (table, scale, rws)
            call = lambda: fn(*args, w, g, **extra)  # noqa: E731
            plain = lambda: ops.lookup_bwd_plain(  # noqa: E731
                table, idx, w, g, extra.get("q"), spec, scale=scale,
                rows=rws, scatter=False)[1]
            library = None
            if scale is None and stage == "dw":
                # one PyTorch call computing dw alone: the backward of
                # embedding_bag to its per-sample weights, the table
                # taking no gradient
                ww = w.detach().requires_grad_()
                bag = F.embedding_bag(rws64, table, per_sample_weights=ww,
                                      mode="sum")
                library = lambda: torch.autograd.grad(  # noqa: E731
                    bag, ww, g, retain_graph=True)[0]
            rows[name].append(measure(
                f"{name} ({payload}, {stage})", n, call, plain, (1e-4, 1e-5),
                device_kernel="lookup_bwd",
                bound=no_scatter_bound(n, distinct, row_bytes, stage,
                                       n * TOP_K, rows_apart=True),
                extra={"payload": payload, "stage": stage, **route},
                library=library, library_tol=(1e-4, 1e-5)))


def serve_config(args):
    """The model config the serve CLI builds for `args` (its placement and
    cache-slot overrides)."""
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    lram = cfg.lram
    if args.placement:
        lram = dataclasses.replace(lram, interp_impl=args.placement)
    if args.cache_slots:
        lram = dataclasses.replace(lram, tiered=dataclasses.replace(
            lram.tiered, cache_slots=args.cache_slots))
    return dataclasses.replace(cfg, lram=lram)


def serve_trace(args, vocab: int, tenants: int = 0):
    """The serve CLI's trace for `args` (a tenant of `tenants` each)."""
    return synthetic_trace(np.random.default_rng(args.seed), args.requests,
                           vocab_size=vocab, max_prompt=args.prompt_len,
                           max_gen=args.gen, tenants=tenants)


def engine_run(name, model, args, trace, *, cuda_graph=True, rows=0,
               controller=None):
    """`trace` through a new engine over `model` (the CLI's shape, `rows`
    overlay rows a slot) after its warm-up; launch counts reset after the
    warm-up and read after the run; every tick's logits checked finite.
    Returns (engine, report, launches)."""
    engine = ServeEngine(model, EngineConfig(
        slots=args.batch, max_len=args.prompt_len + args.gen,
        cuda_graph=cuda_graph, overlay_rows=rows), controller=controller)
    engine.warmup([r.prompt_len for r in trace])
    finite = []
    reset_counts()
    with checked_ticks(finite):
        report = engine.run(trace)
        _sync(engine.device)
    launches = read_counts()
    check(bool(torch.stack(finite).all()), f"{name}: non-finite logits")
    check(len(report.requests) == len(trace),
          f"{name}: served {len(report.requests)} of {len(trace)} requests")
    return engine, report, launches


def serve_path(name: str):
    """Serve one path at full width; returns (launch counts, report)."""
    argv, needs = PATHS[name]
    finite, fills = [], {}
    reset_counts()
    t0 = time.perf_counter()
    with timed_fills(fills), checked_ticks(finite):
        report = serve.main(argv + SERVE_ARGS)
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    args = serve.build_argparser().parse_args(argv + SERVE_ARGS)
    vocab = serve_config(args).vocab_size
    check(len(report.requests) == 8,
          f"{name}: served {len(report.requests)} of 8 requests")
    for kernel in needs:
        check(launches[kernel] > 0,
              f"{name}: {kernel} never launched on the serve path")
    check(bool(torch.stack(finite).all()), f"{name}: non-finite logits")
    # the dense path's tick is one CUDA graph, captured once in warmup();
    # the tiered paths' lookups work on the host and run eagerly
    graph = name == "dense"
    check(report.cuda_graph == graph
          and report.graph_captures == int(graph)
          and report.graph_ticks == (len(report.step_s) if graph else 0),
          f"{name}: cuda_graph {report.cuda_graph}, "
          f"{report.graph_captures} captures, {report.graph_ticks} graph "
          f"ticks of {len(report.step_s)}")
    for r in report.requests:
        check(np.isfinite(r.first_logits).all()
              and r.first_logits.shape == (vocab,),
              f"{name}: request {r.id}: bad prefill logits")
    cache = report.cache
    if name != "dense":
        check(cache is not None, f"{name}: no cache summary")
        if name.endswith("resident"):
            check(cache["uncached"] == 0 and cache["misses"] == 0,
                  f"{name}: the whole table should be resident: {cache}")
    touched = (cache["hits"] + cache["misses"] + cache["uncached"]
               if cache else 0)
    FILL_MS[name] = {"fill_bytes": fills["fill_bytes"],
                     "fill_ms_per_lookup": _fill_ms(fills)
                     if fills["lookups"] else None}
    print(json.dumps({
        "serve": name, "argv": argv, **FILL_MS[name],
        "requests": len(report.requests),
        "generated_tokens": report.generated_tokens,
        "tokens_per_sec": report.tokens_per_sec,
        "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
        "prefill_median_ms": 1e3 * float(np.median(report.prefill_s)),
        "decode_ticks": len(report.step_s), "wall_s": report.wall_s,
        "serve_s_incl_init": serve_s, "cache": cache,
        "cuda_graph": report.cuda_graph,
        "graph_captures": report.graph_captures,
        "overflow_share": cache["uncached"] / touched if touched else None,
        "launches": launches,
    }), flush=True)
    return launches, report


@contextlib.contextmanager
def checked_ticks(finite: list):
    """Every decode tick's logits, graph replay or eager, checked finite
    on the device (appended to `finite`; no host sync in the tick)."""
    decode = ServeEngine._decode

    def checked(engine, *args):
        logits, next_tok = decode(engine, *args)
        finite.append(torch.isfinite(logits).all())
        return logits, next_tok

    ServeEngine._decode = checked
    try:
        yield
    finally:
        ServeEngine._decode = decode


def graph_vs_eager(dense_report):
    """The dense path's decode tick as one CUDA graph against its eager
    twin, in one process on the same weights and trace: every request's
    tokens equal (and the CLI run's), one capture, and the K2 / K1 launch
    counts of the timed trace (reset after warm-up and capture) equal."""
    args = serve.build_argparser().parse_args(PATHS["dense"][0]
                                              + SERVE_ARGS)
    model = transformer.init(serve_config(args), seed=args.seed).to(
        args.device)
    trace = serve_trace(args, model.cfg.vocab_size)
    _, graph, graph_launches = engine_run("dense (graph)", model, args,
                                          trace)
    _, eager, eager_launches = engine_run("dense (eager)", model, args,
                                          trace, cuda_graph=False)
    del model
    check(graph.cuda_graph and graph.graph_captures == 1
          and graph.graph_ticks == len(graph.step_s),
          f"graph run: cuda_graph {graph.cuda_graph}, "
          f"{graph.graph_captures} captures")
    check(not eager.cuda_graph and eager.graph_captures == 0,
          "the eager twin captured a graph")
    check(len(graph.requests) == len(eager.requests) == 8,
          "graph vs eager: requests lost")
    for a, b, c in zip(graph.requests, eager.requests,
                       dense_report.requests):
        check(a.tokens == b.tokens == c.tokens,
              f"graph vs eager: request {a.id} tokens differ: {a.tokens} "
              f"{b.tokens} (CLI {c.tokens})")
    for kernel in ("lram_query", "gather_interp"):
        check(graph_launches[kernel] == eager_launches[kernel] > 0,
              f"graph vs eager: {kernel} launched {graph_launches[kernel]} "
              f"and {eager_launches[kernel]} times")
    out = {"graph_vs_eager": "dense lram-tiered --placement pallas"}
    for name, r, launches in (("graph", graph, graph_launches),
                              ("eager", eager, eager_launches)):
        out[name] = {
            "decode_p50_ms": r.p50_ms(), "decode_p99_ms": r.p99_ms(),
            "tokens_per_sec": r.tokens_per_sec,
            "decode_ticks": len(r.step_s), "graph_ticks": r.graph_ticks,
            "graph_captures": r.graph_captures, "wall_s": r.wall_s,
            "launches": {k: v for k, v in launches.items() if v}}
    print(json.dumps(out), flush=True)
    return graph_launches


def spill_path(dense_report):
    """Path (g): `serve --placement pallas --spill-at-tick 8` spills the
    dense 2^20 x 64 fp32 table to the arch's own TieredSpec (32 of 128
    shards of 8192 rows cached) between decode ticks with requests in
    flight: one spill event, 8 of 8 requests, each with the dense path's
    tokens (the payload moves exactly), K2 and K1 launched, the graph
    dropped at the swap, the store's hit rate in the report.  Returns the
    launch counts (reset just before, read just after)."""
    argv = ["--arch", "lram-tiered", "--placement", "pallas",
            "--spill-at-tick", "8", "--json"] + SERVE_ARGS
    finite = []
    with checked_ticks(finite):
        report, _, out, launches = _cli(serve.main, argv)
    check(bool(torch.stack(finite).all()), "spill: non-finite logits")
    events = [json.loads(x)["lifecycle"] for x in out.splitlines()
              if x.startswith('{"lifecycle"')]
    check(len(events) == 1 and [e["event"] for e in events[0]] == ["spill"],
          f"spill: lifecycle events {events}")
    (spill,) = events[0]
    check(len(report.requests) == 8,
          f"spill: served {len(report.requests)} of 8 requests")
    for a, b in zip(report.requests, dense_report.requests):
        check(a.tokens == b.tokens,
              f"spill: request {a.id} tokens {a.tokens} != the dense "
              f"path's {b.tokens}")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] > 0, f"spill: {kernel} never launched")
    check(not report.cuda_graph and report.graph_captures == 1
          and 0 < report.graph_ticks < len(report.step_s),
          f"spill: the graph was not dropped at the swap: cuda_graph "
          f"{report.cuda_graph}, {report.graph_captures} captures, "
          f"{report.graph_ticks} of {len(report.step_s)} ticks replayed")
    check(report.cache is not None and "hit_rate" in report.cache,
          f"spill: no store stats in the report: {report.cache}")
    print(json.dumps({
        "serve": "g_dense_spill", "argv": argv, "spill": spill,
        "pause_s": spill["pause_s"], "requests": len(report.requests),
        "tokens_equal_dense": True, "cache": report.cache,
        "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
        "tokens_per_sec": report.tokens_per_sec,
        "decode_ticks": len(report.step_s),
        "graph_ticks": report.graph_ticks, "launches": launches,
    }), flush=True)
    return launches


# ---------------------------------------------------------------------------
# paths (i), (i-g), (j), (k): per-tenant overlays and the mmap backing
# ---------------------------------------------------------------------------

TENANTS = 4
TENANT_ARGS = ["--tenants", str(TENANTS), "--overlay-rows", "8"]
LIFECYCLE_ARGS = ["--overlay-ttl", "4", "--overlay-budget-kb", "64"]


def with_mmap(cfg, backing_dir: str):
    """`cfg` with its TieredSpec backed by memmaps under `backing_dir`."""
    return dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, tiered=dataclasses.replace(
            cfg.lram.tiered, backing="mmap", backing_dir=backing_dir)))


def same_overlays(name: str, a, b, tol: float = 1e-6) -> float:
    """Two managers' tenants hold the same rows in the same order, their
    payloads within `tol`; returns the largest difference."""
    check(set(a.overlays) == set(b.overlays),
          f"{name}: tenants {sorted(a.overlays)} != {sorted(b.overlays)}")
    err = 0.0
    for tid, ov in a.overlays.items():
        twin = b.overlays[tid]
        for layer in range(ov.num_layers):
            check(ov.packed_rows(layer) == twin.packed_rows(layer),
                  f"{name}: tenant {tid} layer {layer}: other rows")
            for r in ov.packed_rows(layer):
                err = max(err, float(np.abs(ov.read(layer, r)
                                            - twin.read(layer, r)).max()))
    check(err <= tol, f"{name}: overlay payloads differ by {err}")
    return err


def tick_numbers(report) -> dict:
    """Decode p50 / p99, tokens/s and the host ms a tick spends in the
    overlays' write-back and pack refresh (median, p99, share of tick +
    write-back)."""
    out = {"decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
           "tokens_per_sec": report.tokens_per_sec,
           "decode_ticks": len(report.step_s), "wall_s": report.wall_s}
    if report.overlay_s:
        ov = 1e3 * np.asarray(report.overlay_s)
        tick = 1e3 * np.asarray(report.step_s)
        out.update({
            "overlay_writeback_ms_p50": float(np.median(ov)),
            "overlay_writeback_ms_p99": float(np.percentile(ov, 99)),
            "host_share_of_tick": float(ov.sum() / (ov.sum() + tick.sum())),
            "overlay": report.overlay})
    return out


def tenant_path(dense_report):
    """Path (i): `lram-tiered --placement pallas --tenants 4 --overlay-rows
    8`, the decode tick one CUDA graph over the overlay packs, then its
    relaunch, twins and lifecycle, and (i-g) its live spill.  Returns the
    launch counts of each run (reset just before, read just after)."""
    argv = PATHS["dense"][0] + TENANT_ARGS + SERVE_ARGS
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_overlays_") as d:
        finite = []
        flags = argv + ["--overlay-dir", os.path.join(d, "parked"),
                        "--json"]
        with checked_ticks(finite):
            cli, _, out, launches["i_tenants"] = _cli(serve.main, flags)
        check(bool(torch.stack(finite).all()), "(i): non-finite logits")
        check(len(cli.requests) == 8,
              f"(i): served {len(cli.requests)} of 8 requests")
        for kernel in ("lram_query", "gather_interp"):
            check(launches["i_tenants"][kernel] > 0,
                  f"(i): {kernel} never launched")
        check(cli.cuda_graph and cli.graph_captures == 1
              and cli.graph_ticks == len(cli.step_s),
              f"(i): cuda_graph {cli.cuda_graph}, {cli.graph_captures} "
              f"captures, {cli.graph_ticks} of {len(cli.step_s)} replayed")
        check(0 < cli.overlay["tenants"] <= TENANTS
              and cli.overlay["writebacks"] > 0,
              f"(i): overlay summary {cli.overlay}")
        check(all(np.isfinite(r.first_logits).all() for r in cli.requests),
              "(i): non-finite prefill logits")
        check('"restored_overlays"' not in out,
              "(i): restored overlays from an empty directory")
        parked = sorted(os.listdir(os.path.join(d, "parked")))
        # the relaunch restores what the run parked
        relaunch, _, out, launches["i_relaunch"] = _cli(serve.main, flags)
        restored = [json.loads(x)["restored_overlays"]
                    for x in out.splitlines()
                    if x.startswith('{"restored_overlays"')]
        check(len(parked) > 0 and restored == [len(parked)],
              f"(i) relaunch: restored {restored} of {parked}")
        check(len(relaunch.requests) == 8, "(i) relaunch: requests lost")
        # the lifecycle through the controller: TTL and byte budget
        flags = argv + LIFECYCLE_ARGS + ["--overlay-dir",
                                         os.path.join(d, "spills"), "--json"]
        life, _, out, launches["i_lifecycle"] = _cli(serve.main, flags)
        events = [e for x in out.splitlines()
                  if x.startswith('{"lifecycle"')
                  for e in json.loads(x)["lifecycle"]]
        check(len(events) > 0
              and all(e["event"].startswith("overlay_")
                      and e["action"] == "spill" for e in events)
              and life.overlay["spills"] == len(events),
              f"(i) lifecycle: events {events}, spills "
              f"{life.overlay['spills']}")
        for a, b in zip(life.requests, cli.requests):
            check(a.tokens == b.tokens,
                  f"(i) lifecycle: request {a.id} tokens differ")

    # the twins, on one model's weights (the CLI's: the same seed)
    args = serve.build_argparser().parse_args(argv)
    cfg = serve_config(args)
    model = transformer.init(cfg, seed=args.seed).to(args.device)
    trace = serve_trace(args, cfg.vocab_size, TENANTS)
    g_engine, g, launches["i_graph"] = engine_run(
        "(i) graph", model, args, trace, rows=8)
    e_engine, e, launches["i_eager"] = engine_run(
        "(i) eager", model, args, trace, cuda_graph=False, rows=8)
    check(g.cuda_graph and g.graph_captures == 1
          and g.graph_ticks == len(g.step_s),
          f"(i) graph: cuda_graph {g.cuda_graph}, {g.graph_captures} "
          f"captures")
    check(not e.cuda_graph and e.graph_captures == 0,
          "(i) eager: the eager twin captured a graph")
    for a, b, c in zip(g.requests, e.requests, cli.requests):
        check(a.tokens == b.tokens == c.tokens,
              f"(i) graph vs eager: request {a.id} tokens differ")
    overlay_err = same_overlays("(i) graph vs eager", g_engine.overlays,
                                e_engine.overlays)
    for kernel in ("lram_query", "gather_interp"):
        check(launches["i_graph"][kernel] == launches["i_eager"][kernel] > 0,
              f"(i) graph vs eager: {kernel} launched differently")
    del e_engine
    # the same engine, no tenants: the dense path's trace and numbers
    reset_counts()
    anon = g_engine.run(serve_trace(args, cfg.vocab_size))
    _sync(g_engine.device)
    launches["i_anonymous"] = read_counts()
    check(g_engine.graph_captures == 1 and anon.graph_captures == 1,
          f"(i): {g_engine.graph_captures} captures after the second trace")
    for a, b in zip(anon.requests, dense_report.requests):
        check(a.tokens == b.tokens
              and np.array_equal(a.first_logits, b.first_logits),
              f"(i) empty packs: request {a.id} differs from the dense "
              f"path")
    g_overlays = g_engine.overlays  # the tenants' rows after (i)
    del g_engine
    # (i-g): the same weights spilled to the tiered store at tick 8
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(spill_at_tick=8))
    s_engine, spill, launches["ig_tenants_spill"] = engine_run(
        "(i-g)", model, args, trace, rows=8, controller=ctl)
    check([ev["event"] for ev in ctl.events] == ["spill"],
          f"(i-g): lifecycle events {ctl.events}")
    check(not spill.cuda_graph and spill.graph_captures == 1
          and 0 < spill.graph_ticks < len(spill.step_s),
          f"(i-g): the graph was not dropped at the swap: "
          f"{spill.graph_captures} captures, {spill.graph_ticks} of "
          f"{len(spill.step_s)} replayed")
    for a, b in zip(spill.requests, g.requests):
        check(a.tokens == b.tokens,
              f"(i-g): request {a.id} tokens differ from (i)'s")
    spill_err = same_overlays("(i-g) vs (i)", s_engine.overlays,
                              g_overlays)
    for kernel in ("lram_query", "gather_interp"):
        check(launches["ig_tenants_spill"][kernel] > 0,
              f"(i-g): {kernel} never launched")
    check(spill.cache is not None, "(i-g): no store stats after the swap")
    print(json.dumps({
        "serve": "i_tenants", "argv": argv,
        "tenants": TENANTS, "overlay_rows": 8,
        "cli": tick_numbers(cli), "graph": tick_numbers(g),
        "eager": tick_numbers(e), "anonymous_overlay_engine":
            tick_numbers(anon),
        "dense_without_tenants": tick_numbers(dense_report),
        "graph_captures": g.graph_captures,
        "overlays_graph_vs_eager_max_abs_err": overlay_err,
        "parked_tenants": len(parked), "restored_overlays": restored[0],
        "lifecycle_args": LIFECYCLE_ARGS, "lifecycle_events": len(events),
        "lifecycle_spills": life.overlay["spills"],
        "launches": launches["i_tenants"],
    }), flush=True)
    print(json.dumps({
        "serve": "ig_tenants_spill", "spill": ctl.events[0],
        "tokens_equal_i": True, "overlays_vs_i_max_abs_err": spill_err,
        "graph_ticks": spill.graph_ticks, "cache": spill.cache,
        **tick_numbers(spill), "launches": launches["ig_tenants_spill"],
    }), flush=True)
    del s_engine, model
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def timed_fills(acc: dict):
    """Host seconds the tiered stores spend filling (shards into the
    cache mirror, `_ensure_resident`, and the copy to the device,
    `_sync_device`), the bytes those copies move (`fill_bytes`), and their
    lookups, added to `acc`.  The ranges of a sharded-tiered store
    prefetch on a thread pool: their seconds add up over threads."""
    names = ("_ensure_resident", "_sync_device")
    saved = {n: getattr(TieredValueStore, n) for n in names}
    saved_map = TieredValueStore._map
    acc.setdefault("fill_s", 0.0)
    acc.setdefault("fill_bytes", 0)
    acc.setdefault("lookups", 0)
    lock, local = threading.Lock(), threading.local()

    def timed(fn):
        def run(self, *a, **kw):
            outer = not getattr(local, "depth", 0)
            local.depth = getattr(local, "depth", 0) + 1
            t0, b0 = time.perf_counter(), self.stats["fill_bytes"]
            try:
                return fn(self, *a, **kw)
            finally:
                local.depth -= 1
                if outer:
                    with lock:
                        acc["fill_s"] += time.perf_counter() - t0
                        acc["fill_bytes"] += self.stats["fill_bytes"] - b0
        return run

    def counted(self, *a, **kw):
        with lock:
            acc["lookups"] += 1
        return saved_map(self, *a, **kw)

    for n in names:
        setattr(TieredValueStore, n, timed(saved[n]))
    TieredValueStore._map = counted
    try:
        yield acc
    finally:
        for n in names:
            setattr(TieredValueStore, n, saved[n])
        TieredValueStore._map = saved_map


def _fill_ms(acc: dict) -> float:
    return 1e3 * acc["fill_s"] / max(acc["lookups"], 1)


def _host_files(store) -> list[str]:
    """The files of a store's memmapped host tier (every range's)."""
    parts = getattr(store, "parts", [store])
    return [a.filename for p in parts
            for a in (p._host, p._host_scale) if a is not None]


def mmap_path(b_report):
    """Path (j): `lram-tiered-q8` on its own TieredSpec backed by memmaps
    in a fresh temporary directory, served with and without tenants,
    against the same config backed by RAM in turns.  Returns the launch
    counts of each run."""
    args = serve.build_argparser().parse_args(PATHS["b_tiered_q8"][0]
                                              + SERVE_ARGS)
    cfg = serve_config(args)
    launches, runs, fills = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mmap_") as d:
        for backing in ("ram", "mmap"):
            c = with_mmap(cfg, d) if backing == "mmap" else cfg
            model = transformer.init(c, seed=args.seed).to(args.device)
            (_, store), = lookup.find_stores(model)
            if backing == "mmap":
                n, m = store.num_rows, store.m
                files = {os.path.basename(f): os.path.getsize(f)
                         for f in _host_files(store)}
                want = {f"values_{n}x{m}.npy": (store._host.offset + n * m),
                        f"scales_{n}x{m}.npy": (store._host_scale.offset
                                                + n * 4)}
                check(files == want and sorted(os.listdir(d)) == sorted(want),
                      f"(j): host files {files}, expected {want}")
                headers = {k: v - (n * m if k.startswith("values") else n * 4)
                           for k, v in files.items()}
            for tenants in (0, TENANTS):
                name = f"j_{backing}" + ("_tenants" if tenants else "")
                fills[name] = {}
                with timed_fills(fills[name]):
                    engine, runs[name], launches[name] = engine_run(
                        name, model, args,
                        serve_trace(args, cfg.vocab_size, tenants),
                        rows=8 if tenants else 0)
                for kernel in ("lram_query", "gather_interp_quant"):
                    check(launches[name][kernel] > 0,
                          f"{name}: {kernel} never launched")
                if tenants:
                    check(engine.overlays.storage == "int8" and all(
                        q.dtype == np.int8 and s is not None
                        for ov in engine.overlays.overlays.values()
                        for od in ov.rows for q, s in od.values()),
                        f"{name}: the overlays are not int8")
                    check(runs[name].overlay["writebacks"] > 0,
                          f"{name}: no write-back")
                del engine
            del model, store
            torch.cuda.empty_cache()
    for a, b, c in zip(runs["j_mmap"].requests, runs["j_ram"].requests,
                       b_report.requests):
        check(np.array_equal(a.first_logits, c.first_logits)
              and np.array_equal(b.first_logits, c.first_logits)
              and a.tokens == b.tokens == c.tokens,
              f"(j): request {a.id}: memmap, RAM and path (b) differ")
    for a, b in zip(runs["j_mmap_tenants"].requests,
                    runs["j_ram_tenants"].requests):
        check(a.tokens == b.tokens,
              f"(j) tenants: request {a.id} tokens differ from the RAM "
              f"store's")
    print(json.dumps({
        "serve": "j_mmap", "arch": args.arch, "files_bytes": files,
        "npy_header_bytes": headers,
        "first_logits_equal_b": True, "tenant_tokens_equal_ram": True,
        **{name: {**tick_numbers(r), "cache": r.cache,
                  "fill_ms_per_lookup": _fill_ms(fills[name]),
                  "lookups": fills[name]["lookups"]}
           for name, r in runs.items()},
        "launches": launches,
    }), flush=True)
    return launches


def sharded_mmap_path(e_report):
    """Path (k): `lram-sharded-tiered` backed by memmaps under a directory,
    one `range_{r:03d}` a range; the first logits of path (e).  Returns
    the launch counts."""
    args = serve.build_argparser().parse_args(PATHS["e_sharded_tiered"][0]
                                              + SERVE_ARGS)
    cfg = serve_config(args)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mmap_") as d:
        model = transformer.init(with_mmap(cfg, d), seed=args.seed).to(
            args.device)
        (_, store), = lookup.find_stores(model)
        ranges = sorted(os.listdir(d))
        want = [f"range_{r:03d}" for r in range(store.num_ranges)]
        layout = {r: sorted(os.listdir(os.path.join(d, r))) for r in ranges}
        check(ranges == want and len(want) == ST_RANGES and all(
            v == [f"values_{store.rows_local}x{store.m}.npy"]
            for v in layout.values()),
            f"(k): range directories {layout}")
        fills = {}
        with timed_fills(fills):
            _, report, launches = engine_run(
                "(k)", model, args, serve_trace(args, cfg.vocab_size))
        del model, store
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] > 0, f"(k): {kernel} never launched")
    for a, b in zip(report.requests, e_report.requests):
        check(np.array_equal(a.first_logits, b.first_logits)
              and a.tokens == b.tokens,
              f"(k): request {a.id} differs from path (e)")
    print(json.dumps({
        "serve": "k_sharded_mmap", "arch": args.arch, "ranges": layout,
        "first_logits_equal_e": True, **tick_numbers(report),
        "cache": report.cache, "fill_ms_per_lookup": _fill_ms(fills),
        "lookups": fills["lookups"], "launches": launches,
    }), flush=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# path (l): obs armed at full width (--metrics-dir, --profile-dir)
# ---------------------------------------------------------------------------

OBS_TRAIN_ARGS = ["--arch", "lram-bert-medium", "--placement", "pallas",
                  "--batch", "8", "--seq", "256", "--steps", "12",
                  "--grow-at", "6:21", "--telemetry", "--json"]
K1_SYMBOL = "gather_interp_kernel"  # K1's kernel in a profile


def _trace_summary(path: str) -> dict:
    """A torch.profiler Chrome trace's bytes, event count and the names
    of its CUDA kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {"bytes": os.path.getsize(path), "events": len(events),
            "kernels": sorted({e["name"] for e in events
                               if e.get("cat") == "kernel"})}


def armed_cli(main, argv, *, profile: bool = False):
    """`main(argv)` (`_cli`: launch counts reset just before, read just
    after) with `--metrics-dir` (and `--profile-dir`) in a fresh temporary
    directory, obs disarmed after it.  Every line of metrics.jsonl is
    validated as it is read (`obs.read_jsonl`), and so is metrics.prom.
    Returns (result, step records, output, launches, events, the last
    metrics snapshot, {profile file: `_trace_summary`})."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        metrics, prof = os.path.join(d, "metrics"), os.path.join(d, "prof")
        flags = ["--metrics-dir", metrics] + (
            ["--profile-dir", prof] if profile else [])
        try:
            result, records, out, launches = _cli(main, argv + flags)
        finally:
            obs.disable()
        events = obs.read_jsonl(os.path.join(metrics, obs.JSONL_NAME))
        with open(os.path.join(metrics, obs.PROM_NAME)) as f:
            obs.export.validate_prometheus_text(f.read())
        traces = ({name: _trace_summary(os.path.join(prof, name))
                   for name in os.listdir(prof)} if profile else {})
    snaps = [e["metrics"] for e in events if e["kind"] == "metrics"]
    check(len(snaps) == 1, f"{argv}: {len(snaps)} metrics snapshots")
    return result, records, out, launches, events, snaps[0], traces


def _value(snap: dict, name: str) -> float:
    """A counter's or gauge's value (0 when never set)."""
    return snap[name]["value"] if name in snap else 0.0


def _spans(events, name: str) -> list[dict]:
    return [e for e in events if e["kind"] == "span" and e["name"] == name]


def _serve_numbers(report) -> dict:
    return {"decode_p50_ms": report.p50_ms(),
            "decode_p99_ms": report.p99_ms(),
            "tokens_per_sec": report.tokens_per_sec,
            "decode_ticks": len(report.step_s),
            "graph_captures": report.graph_captures}


def _check_serve_obs(name, report, out, events, snap, graph: bool) -> dict:
    """What every armed serve holds: the summary's `metrics` is the
    snapshot; `serve.tokens` (decode ticks' tokens) plus `serve.admitted`
    (each prefill's first token) is `generated_tokens`; 8 admitted and
    retired; one `serve.decode_tick` span a tick, each `serve.decode_step_s`
    sample one of them, all under the one `serve.run` span."""
    summary = json.loads(out.splitlines()[-1])
    obs.validate_metrics_doc(summary["metrics"])
    check(summary["metrics"]["metrics"] == snap,
          f"{name}: the summary's metrics are not the snapshot")
    check(_value(snap, "serve.tokens") + _value(snap, "serve.admitted")
          == report.generated_tokens,
          f"{name}: serve.tokens {_value(snap, 'serve.tokens')} + "
          f"admitted against {report.generated_tokens} generated")
    check(_value(snap, "serve.admitted") == _value(snap, "serve.retired")
          == len(report.requests) == 8,
          f"{name}: admitted / retired {_value(snap, 'serve.admitted')} / "
          f"{_value(snap, 'serve.retired')}")
    runs = _spans(events, "serve.run")
    check(len(runs) == 1, f"{name}: {len(runs)} serve.run spans")
    run = runs[0]
    ticks = _spans(events, "serve.decode_tick")
    check(len(ticks) == snap["serve.decode_step_s"]["count"]
          == len(report.step_s) and all(t["parent"] == run["id"]
                                        for t in ticks),
          f"{name}: {len(ticks)} tick spans, "
          f"{snap['serve.decode_step_s']['count']} tick samples, "
          f"{len(report.step_s)} ticks")
    check(report.graph_captures == int(graph),
          f"{name}: {report.graph_captures} captures")
    return {"spans": sum(e["kind"] == "span" for e in events),
            "events": len(events), "serve_run_s": run["dur_s"]}


def obs_dense_path() -> dict:
    """Path (l1): the dense decode graph (`lram-tiered --placement
    pallas`) served with obs off and armed in turns (off, on, on, off),
    then once with `--profile-dir`, then without `--warmup` (the capture
    inside the profiled `serve.run`) off and profiled.  Each armed run
    has the tokens and launch counts of the run without obs and one
    capture; each profile is one trace whose kernel events name K2 and
    K1.  Returns {run: launch counts}."""
    argv = PATHS["dense"][0] + SERVE_ARGS + ["--json"]
    cold = [a for a in argv if a != "--warmup"]
    runs, numbers, launches = {}, {}, {}
    for label, args, mode in (("off", argv, None), ("on", argv, "metrics"),
                              ("on_2", argv, "metrics"), ("off_2", argv, None),
                              ("profiled", argv, "profile"),
                              ("cold_off", cold, None),
                              ("cold_profiled", cold, "profile")):
        finite = []
        with checked_ticks(finite):
            if mode is None:
                report, _, out, counts = _cli(serve.main, args)
                extra = {}
            else:
                report, _, out, counts, events, snap, traces = armed_cli(
                    serve.main, args, profile=mode == "profile")
                extra = _check_serve_obs(f"(l1) {label}", report, out,
                                         events, snap, graph=True)
                if mode == "profile":
                    check(len(traces) == 1,
                          f"(l1) {label}: profile files {sorted(traces)}")
                    (trace,) = traces.values()
                    for kernel in ("lram_query_kernel", K1_SYMBOL):
                        check(any(kernel in k for k in trace["kernels"]),
                              f"(l1) {label}: no {kernel} event in the "
                              f"profile: {trace['kernels'][:20]}")
                    extra.update(trace_bytes=trace["bytes"],
                                 trace_events=trace["events"],
                                 trace_kernel_names=len(trace["kernels"]))
        check(bool(torch.stack(finite).all()),
              f"(l1) {label}: non-finite logits")
        check(len(report.requests) == 8 and report.graph_captures == 1,
              f"(l1) {label}: served {len(report.requests)} of 8, "
              f"{report.graph_captures} captures")
        if mode is not None:
            twin = runs["cold_off" if label.startswith("cold") else "off"]
            for a, b in zip(report.requests, twin[0].requests):
                check(a.tokens == b.tokens,
                      f"(l1) {label}: request {a.id} tokens differ from "
                      f"obs off")
            check(counts == twin[1], f"(l1) {label}: launches {counts} "
                                     f"against obs off {twin[1]}")
        runs[label] = (report, counts)
        launches[f"l1_{label}"] = counts
        numbers[label] = {**_serve_numbers(report), **extra}
    print(json.dumps({"serve": "l1_obs_dense", "argv": argv,
                      "runs": numbers}), flush=True)
    return launches


def _slot_bytes(args) -> int:
    """Bytes of one cache slot of the path's tiered store (payload and
    scales)."""
    lram = serve_config(args).lram
    quantized = lram.table_quant != "none"
    return lram.tiered.shard_rows * (lram.m * (1 if quantized else 4)
                                     + (4 if quantized else 0))


def obs_store_path(name: str) -> dict:
    """Paths (l2) (`lram-tiered-q8`) and (l3) (`lram-sharded-tiered`)
    armed: the `memstore.*` deltas on the `serve.decode_tick` and
    `serve.prefill` spans add up to the summary's cache stats (hits,
    misses, uncached, fills, evictions: the run's, from the reset at its
    start), their fill bytes to their fills' slots; the counters' totals
    exceed them by what the warm-up and the run's warm fill did before
    any span; a sharded store's fan-outs set
    `memstore.prefetch_queue_depth` to its ranges.  Returns the launch
    counts."""
    argv = PATHS[name][0] + SERVE_ARGS + ["--json"]
    report, _, out, launches, events, snap, _ = armed_cli(serve.main, argv)
    label = f"(l) {name}"
    spans = _check_serve_obs(label, report, out, events, snap, graph=False)
    cache = report.cache
    keys = ("hits", "misses", "uncached", "fills", "evictions", "fill_bytes")
    inside = {k: sum(s["metrics"].get(f"memstore.{k}", 0.0)
                     for s in events if s["kind"] == "span"
                     and s["name"] in ("serve.decode_tick", "serve.prefill"))
              for k in keys}
    totals = {k: _value(snap, f"memstore.{k}") for k in keys}
    for k in keys[:5]:
        check(inside[k] == cache[k],
              f"{label}: {k} on the spans {inside[k]} against the "
              f"summary's {cache[k]}")
        check(totals[k] >= inside[k], f"{label}: {k} total {totals[k]}")
    check(cache["hits"] + cache["misses"] + cache["uncached"] > 0,
          f"{label}: no lookup counted")
    args = serve.build_argparser().parse_args(argv)
    check(inside["fill_bytes"] == inside["fills"] * _slot_bytes(args),
          f"{label}: {inside['fill_bytes']} fill bytes for "
          f"{inside['fills']} fills")
    depth = snap.get("memstore.prefetch_queue_depth")
    ranges = serve_config(args).lram.model_shards or 0
    check((depth is not None and depth["value"] == ranges)
          if ranges else depth is None,
          f"{label}: memstore.prefetch_queue_depth {depth}")
    print(json.dumps({
        "serve": f"l_obs_{name}", "argv": argv, "cache": cache,
        "on_spans": inside, "totals": totals,
        "outside_spans": {k: totals[k] - inside[k] for k in keys},
        "prefetch_queue_depth": depth, **spans,
        **_serve_numbers(report), "launches": launches}), flush=True)
    return launches


def obs_tenant_spill_path() -> dict:
    """Path (l4): (i-g) through the CLI (`--placement pallas --tenants 4
    --spill-at-tick 8`) without and with `--metrics-dir`: the same
    tokens; one `memctl.spill` span and event; `memctl.table_device_bytes`
    at the tiered caches' bytes; `serve.overlay_writebacks` the active
    slots summed over the ticks.  Returns the launch counts."""
    argv = (PATHS["dense"][0] + TENANT_ARGS + SERVE_ARGS
            + ["--spill-at-tick", "8", "--json"])
    plain, _, _, off = _cli(serve.main, argv)
    report, _, out, on, events, snap, _ = armed_cli(serve.main, argv)
    spans = _check_serve_obs("(l4)", report, out, events, snap, graph=True)
    for a, b in zip(report.requests, plain.requests):
        check(a.tokens == b.tokens,
              f"(l4): request {a.id} tokens differ from obs off")
    check(on == off, f"(l4): launches {on} against obs off {off}")
    spills = [e for e in events if e.get("name") == "memctl.spill"]
    check(sorted(e["kind"] for e in spills) == ["event", "span"],
          f"(l4): memctl.spill records {spills}")
    lram = serve_config(serve.build_argparser().parse_args(argv)).lram
    caches = lram.tiered.cache_slots * lram.tiered.shard_rows * lram.m * 4
    check(_value(snap, "memctl.table_device_bytes") == caches,
          f"(l4): memctl.table_device_bytes "
          f"{_value(snap, 'memctl.table_device_bytes')} against {caches}")
    active = sum(s["attrs"]["active"]
                 for s in _spans(events, "serve.decode_tick"))
    check(_value(snap, "serve.overlay_writebacks") == active > 0,
          f"(l4): serve.overlay_writebacks "
          f"{_value(snap, 'serve.overlay_writebacks')} against {active}")
    print(json.dumps({
        "serve": "l4_obs_tenants_spill", "argv": argv,
        "spill": [e for e in spills if e["kind"] == "event"][0]["attrs"],
        "memctl_table_device_bytes": caches,
        "overlay_writebacks": active, **spans,
        "off": _serve_numbers(plain), "on": _serve_numbers(report),
        "launches": on}), flush=True)
    return {"l4_off": off, "l4_on": on}


def obs_train_path() -> dict:
    """Path (l5): `train --grow-at 6:21 --telemetry` 12 steps without obs,
    with `--metrics-dir`, and without again: the same launch counts; the
    first step's loss and grad norm bit for bit and every step's within
    rtol 1e-6 of the run without obs (a step's reported loss on the card
    may differ in its last bit, about 1e-7 of it, from run to run, obs or
    not; whether the runs agree bit for bit is printed); one `train.step`
    span a step,
    one `memctl.grow` span and event, `memctl.num_locations` the grown
    size, and the `train.util_*` gauges the last utilisation report's.
    Returns the launch counts."""
    off, _, _, off_launches = _cli(train.main, OBS_TRAIN_ARGS)
    run, _, out, on_launches, events, snap, _ = armed_cli(train.main,
                                                          OBS_TRAIN_ARGS)
    off2, _, _, off2_launches = _cli(train.main, OBS_TRAIN_ARGS)
    runs = (("off", off), ("on", run), ("off_2", off2))
    losses = {k: [r["loss"] for r in r_.records] for k, r_ in runs}
    norms = {k: [r["grad_norm"] for r in r_.records] for k, r_ in runs}
    steps = len(losses["off"])
    check(on_launches == off_launches == off2_launches,
          f"(l5): launches {on_launches}, {off_launches}, {off2_launches}")

    def rel(got, want):
        return max(abs(a - b) / abs(b) if b else abs(a - b)
                   for a, b in zip(got, want))

    for what, vals in (("losses", losses), ("grad norms", norms)):
        check(vals["on"][0] == vals["off"][0]
              and rel(vals["on"], vals["off"]) <= 1e-6,
              f"(l5): {what} with obs {vals['on']} against without "
              f"{vals['off']}")
    step_spans = _spans(events, "train.step")
    check([s["attrs"]["step"] for s in step_spans] == list(range(steps)),
          f"(l5): train.step spans {[s['attrs'] for s in step_spans]}")
    grows = [e for e in events if e.get("name") == "memctl.grow"]
    check(sorted(e["kind"] for e in grows) == ["event", "span"],
          f"(l5): memctl.grow records {grows}")
    log2 = int(OBS_TRAIN_ARGS[OBS_TRAIN_ARGS.index("--grow-at")
                              + 1].split(":")[1])
    check(_value(snap, "memctl.num_locations") == 2**log2,
          f"(l5): memctl.num_locations "
          f"{_value(snap, 'memctl.num_locations')}")
    reports = [json.loads(x)["utilisation_report"] for x in out.splitlines()
               if '"utilisation_report"' in x]
    for row, gauge in zip(reports[-1], ("dead_frac", "hot_mass",
                                        "cold_frac")):
        check(_value(snap, f"train.util_{gauge}") == float(row[2].split()[0]),
              f"(l5): train.util_{gauge} {_value(snap, f'train.util_{gauge}')}"
              f" against the last report's {row}")
    step_s = [s["dur_s"] for s in step_spans]
    print(json.dumps({
        "train": "l5_obs_grow", "argv": OBS_TRAIN_ARGS, "losses": losses,
        "grad_norms": norms,
        "steps_bit_equal_on_vs_off": [a == b for a, b in zip(
            losses["on"], losses["off"])],
        "steps_bit_equal_off_vs_off_2": [a == b for a, b in zip(
            losses["off_2"], losses["off"])],
        "steps_grad_norm_bit_equal_on_vs_off": [a == b for a, b in zip(
            norms["on"], norms["off"])],
        "max_rel_diff_on_vs_off": {"loss": rel(losses["on"], losses["off"]),
                                   "grad_norm": rel(norms["on"],
                                                    norms["off"])},
        "max_rel_diff_off_vs_off_2": {
            "loss": rel(losses["off_2"], losses["off"]),
            "grad_norm": rel(norms["off_2"], norms["off"])},
        "final_eval_loss": {"off": off.final_eval_loss,
                            "on": run.final_eval_loss,
                            "off_2": off2.final_eval_loss},
        "train_step_span_s_median_steps_7_11": float(np.median(step_s[7:])),
        "step_ms_median_on": float(np.median(
            [r["step_ms"] for r in run.records[7:]])),
        "step_ms_median_off": float(np.median(
            [r["step_ms"] for r in off.records[7:]])),
        "spans": sum(e["kind"] == "span" for e in events),
        "grow_event": [e for e in grows if e["kind"] == "event"][0]["attrs"],
        "launches": on_launches}), flush=True)
    del off, run, off2
    return {"l5_off": off_launches, "l5_on": on_launches,
            "l5_off_2": off2_launches}


def obs_path() -> dict:
    """Path (l), every part; prints its seconds.  Returns the launch
    counts of each run."""
    t0 = time.perf_counter()
    launches = obs_dense_path()
    launches["l2_tiered_q8"] = obs_store_path("b_tiered_q8")
    launches["l3_sharded_tiered"] = obs_store_path("e_sharded_tiered")
    launches.update(obs_tenant_spill_path())
    launches.update(obs_train_path())
    print(json.dumps({"path_l_s": time.perf_counter() - t0}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# paths (m) and (q): bfloat16 and float16 memory tables
# ---------------------------------------------------------------------------

BF16, F16 = "bfloat16", "float16"
TORCH_DTYPE = {BF16: torch.bfloat16, F16: torch.float16}
HALF_TABLE_BYTES = 2**LOG2_LOCATIONS * M * 2  # 134,217,728 (fp32: twice)
# serve path -> (its phase-4 twin, the gather that must launch)
BF16_SERVE = {
    "m2a_tiered_bf16": ("a_tiered", "gather_interp"),
    "m2c_tiered_resident_bf16": ("c_tiered_resident", "tiered_gather"),
    "m3e_sharded_tiered_bf16": ("e_sharded_tiered", "gather_interp"),
}
F16_SERVE = {"q2a_tiered_f16": ("a_tiered", "gather_interp")}
BF16_TIERED_TRAIN = ("lram-tiered", TieredValueStore, "gather_interp",
                     "lookup_bwd_rows", 10)
M6_ARGS = ["--arch", "lram-bert-medium", "--placement", "sharded",
           "--batch", "8", "--seq", "256"]
# (m6) and (q4): the table dtypes of the one spawn -> their path's name
MESH_TABLES = {BF16: "m6_mesh_bf16", F16: "q4_mesh_f16"}
FILL_MS: dict = {}  # phase 4's serve paths: fill bytes and host ms a lookup
PHASE6: dict = {}   # phase 6's step-time median and peak memory
P_NUMBERS: dict = {}  # path (p)'s printed numbers, by path; (p4c)'s by rank
PATH_M: dict = {}   # (m4)'s, (q3)'s and the PKM runs', set beside at the end


def table_config(cfg, dtype: str):
    """`cfg` with its memory table in `dtype`."""
    return dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, table_dtype=dtype))


@contextlib.contextmanager
def tables_in(dtype: str):
    """`configs.get_config` (and `get_smoke_config`) with every memory
    table in `dtype`, so the CLIs build the replaced config (the
    reference's CLIs have no flag for the table's dtype either)."""
    get, smoke = configs.get_config, configs.get_smoke_config
    configs.get_config = lambda name, **kw: table_config(get(name, **kw),
                                                         dtype)
    configs.get_smoke_config = lambda name, **kw: table_config(
        smoke(name, **kw), dtype)
    try:
        yield
    finally:
        configs.get_config, configs.get_smoke_config = get, smoke


def memory_tables(model) -> list:
    return [m.values for m in model.modules() if isinstance(m, LRAM)]


def dense_graph_twin(tag: str, dtype: str):
    """(m1) / (q1) The dense `pallas` placement with a bf16 / fp16 table
    under the decode graph, and its fp32 twin (the same weights, the table
    widened): every request's tokens equal and first logits bit for bit
    (K1's 2-byte instance adds the widened rows in the fp32 instance's
    order), the table half the bytes; tick p50 / p99, tokens/s and peak
    memory of both.  Returns (the 2-byte run's launch counts, its
    report)."""
    suffix = HALF[TORCH_DTYPE[dtype]][0]
    args = serve.build_argparser().parse_args(PATHS["dense"][0]
                                              + SERVE_ARGS)
    cfg = serve_config(args)
    trace = serve_trace(args, cfg.vocab_size)
    out, reports, launches, weights = {}, {}, {}, None
    for table_dtype in (dtype, "float32"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if table_dtype == dtype:
            model = transformer.init(table_config(cfg, dtype), seed=args.seed)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        else:  # copy_ widens the 2-byte table exactly
            model = transformer.init(cfg, seed=args.seed)
            model.load_state_dict(weights)
            weights = None
        model = model.to(args.device)
        (table,) = memory_tables(model)
        engine, report, launches[table_dtype] = engine_run(
            f"({tag}) {table_dtype} table", model, args, trace)
        check(report.cuda_graph and report.graph_captures == 1
              and report.graph_ticks == len(report.step_s),
              f"({tag}) {table_dtype}: the tick did not run as one captured "
              f"graph")
        reports[table_dtype] = report
        out[table_dtype] = {
            **tick_numbers(report),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "table_dtype": str(table.dtype),
            "table_bytes": table.numel() * table.element_size(),
            "launches": {k: v for k, v in launches[table_dtype].items()
                         if v}}
        del engine, model, table
    half = launches[dtype]
    check(half[f"gather_interp_{suffix}"] > 0 and half["lram_query"] > 0
          and half["gather_interp"] == 0,
          f"({tag}): K2 and K1's {suffix} instance (alone) must launch: "
          f"{half}")
    check(out[dtype]["table_bytes"] == HALF_TABLE_BYTES
          and out["float32"]["table_bytes"] == 2 * HALF_TABLE_BYTES,
          f"({tag}): table bytes {out[dtype]['table_bytes']} and "
          f"{out['float32']['table_bytes']}")
    for a, b in zip(reports[dtype].requests, reports["float32"].requests):
        check(a.tokens == b.tokens, f"({tag}): request {a.id}'s tokens "
                                    f"differ from the fp32 twin's")
        check(np.array_equal(a.first_logits, b.first_logits),
              f"({tag}): request {a.id}'s first logits differ from the "
              f"fp32 twin's by {np.abs(a.first_logits - b.first_logits).max()}")
    print(json.dumps({"path": f"{tag} dense {suffix} table, decode graph",
                      "tokens_equal_fp32_twin": True,
                      "first_logits_bit_equal_fp32_twin": True, **out}),
          flush=True)
    return half, reports[dtype]


def half_serve_path(name: str, twin_report, dtype: str) -> dict:
    """(m2) / (m3) / (q2) A tiered path of phase 4 through the serve CLI
    with a bf16 / fp16 table: every store's host tier in that dtype
    (2-byte rows) under its fp32 cache, the path's gather launched (fp32,
    on the cache) and no 2-byte one, 8 of 8 requests with the tokens of
    `twin_report` ((m1)'s / (q1)'s: the fp32 twin's bit for bit) and its
    first logits within 1e-5; fill bytes and the fills' host ms a lookup
    beside phase 4's."""
    twin, gather = {**BF16_SERVE, **F16_SERVE}[name]
    torch_dtype = TORCH_DTYPE[dtype]
    suffix = HALF[torch_dtype][0]
    argv = PATHS[twin][0]
    built, acc, finite = [], {}, []
    fill_host = TieredValueStore._fill_host

    def recorded_fill(self, values):
        built.append((str(self.dtype), self.bytes_per_entry()))
        return fill_host(self, values)

    TieredValueStore._fill_host = recorded_fill
    try:
        with tables_in(dtype), timed_fills(acc), checked_ticks(finite):
            reset_counts()
            report = serve.main(argv + SERVE_ARGS)
            torch.cuda.synchronize()
            launches = read_counts()
    finally:
        TieredValueStore._fill_host = fill_host
    check(built and all(b == (str(torch_dtype), 2 * M) for b in built),
          f"({name}): the stores' host tiers are {built}, not {suffix}")
    check(len(report.requests) == 8 and bool(torch.stack(finite).all()),
          f"({name}): {len(report.requests)} of 8 requests, or non-finite")
    check(launches["lram_query"] > 0 and launches[gather] > 0
          and launches[f"gather_interp_{suffix}"] == 0,
          f"({name}): K2 and {gather} must launch (the cache is fp32): "
          f"{launches}")
    for a, b in zip(report.requests, twin_report.requests):
        check(a.tokens == b.tokens, f"({name}): request {a.id}'s tokens "
                                    f"differ from the dense twin's")
    err = same_first_logits(f"({name}) vs the dense twin", report,
                            twin_report)
    print(json.dumps({
        "path": name, "argv": argv, "host_tiers": built,
        "first_logits_max_abs_err_vs_dense_twin": err,
        **tick_numbers(report), "cache": report.cache,
        "fill_bytes": acc["fill_bytes"],
        "fill_ms_per_lookup": _fill_ms(acc), "fill_lookups": acc["lookups"],
        "phase4_fp32": {twin: FILL_MS[twin]},
        "launches": {k: v for k, v in launches.items() if v}}), flush=True)
    return launches


def half_train_path(tag: str, dtype: str) -> dict:
    """(m4) / (q3) `lram-bert-medium --placement pallas` with a bf16 /
    fp16 table, 20 steps at phase 6's `--batch 8 --seq 256`, through
    `train.main` on the replaced config: K2, K1's 2-byte instance and the
    backward's (`lookup_bwd_bf16` / `_f16`, once a step) launched, no
    fp32 one; the loss finite and falling; step 1's backward inputs kept
    and its dvalues, dq (and, the dw instance on them, dw) held against
    the plain version on the card: dvalues to atol 1e-5 in fp32 and once
    rounded to the table's dtype (`rounding_agrees`), dq / dw to rtol
    1e-4 / atol 1e-5.  Step ms and peak memory beside phase 6's at the
    end of the script."""
    suffix = HALF[TORCH_DTYPE[dtype]][0]
    kept: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    reset_counts()  # before the wrapper takes its count over
    with tables_in(dtype), first_call_kept("lookup_bwd", kept):
        run = train.main(TRAIN_ARGS)
        torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    (table,) = memory_tables(run.model)
    check(table.dtype == TORCH_DTYPE[dtype], f"({tag}): a {table.dtype} "
                                             f"table")
    check(launches[f"gather_interp_{suffix}"] >= TRAIN_STEPS
          and launches[f"lookup_bwd_{suffix}"] == TRAIN_STEPS
          and launches["gather_interp"] == launches["lookup_bwd"] == 0,
          f"({tag}): K1 and the backward must launch their {suffix} "
          f"instances (the backward once a step): {launches}")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(len(losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses + norms)
          and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"({tag}): steps missing, non-finite or the loss did not fall: "
          f"{losses}")
    step1 = held_backward(f"({tag})", kept, table.device)
    step_ms = [r["step_ms"] for r in run.records]
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    median_ms = float(np.median(step_ms[5:]))
    PATH_M[tag] = {"step_ms_median_steps_6_20": median_ms,
                   "peak_memory_bytes": peak}
    print(json.dumps({
        "train": f"{tag} lram-bert-medium, {suffix} table",
        "argv": TRAIN_ARGS, "n_step1": step1["n_step1"], "losses": losses,
        "grad_norms": norms, "step1_max_abs_err": step1["max_abs_err"],
        "step1_dvalues_rounded": step1["dvalues_rounded"],
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "allocated_before_bytes": allocated_before,
        "peak_memory_bytes": peak,
        "table_bytes": table.numel() * table.element_size(),
        "launches": {k: v for k, v in launches.items() if v}}), flush=True)
    del run, table, kept
    torch.cuda.empty_cache()
    return launches


def m6_rank(rank: int, port: int, results, argv, device_name) -> None:
    """One rank of (m6) and (q4): a data 2 x model 2 mesh (6b's),
    `lram-bert-medium`'s table row-sharded over model (2^19 rows a rank),
    every rank on the whole batch, once with a bf16 table and once with an
    fp16 one.  For each, the dense `pallas` twin first (the same seed's
    weights, its table whole): its eval logits and the rows of its table
    gradient this rank holds; then the sharded model: 2 eval forwards and
    one train forward and backward (the dense blocks gathered), launch
    counts reset just before and read just after."""
    _rank_env(rank, port)
    mesh, device = mesh_lib.init_mesh(device_name, shape="2x2")
    args = train.build_argparser().parse_args(argv)
    out = {"rank": rank, "mesh": mesh.shape, "backend": dist.get_backend()}
    for dtype in MESH_TABLES:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cfg = table_config(_mesh_config(args, "sharded"), dtype)
        dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch,
                               objective=cfg.objective, seed=args.seed)
        batch = train.batch_to(data.get_batch(dcfg, step=0), device)
        rows = cfg.lram.num_locations // mesh.size("model")
        base = mesh.index("model") * rows
        dense = transformer.init(dataclasses.replace(
            cfg, lram=dataclasses.replace(cfg.lram, interp_impl="pallas")),
            seed=args.seed).to(device)
        with sharding.gathered(dense):
            with torch.no_grad():
                want = transformer.forward(dense, batch)
            transformer.loss_fn(dense, batch, train=True)[0].backward()
        want_dv = memory_tables(dense)[0].grad[base:base + rows].float()
        del dense
        model = transformer.init(cfg, seed=args.seed)
        sharding.shard_params(model, mesh)
        model = model.to(device)
        reset_counts()
        with sharding.gathered(model):
            with torch.no_grad():
                for _ in range(2):
                    got = transformer.forward(model, batch)
            transformer.loss_fn(model, batch, train=True)[0].backward()
        _sync(device)
        launches = read_counts()
        (table,) = memory_tables(model)
        dv = table.grad.float()
        out[dtype] = {
            "shard_rows": table.shape[0],
            "table_rows": cfg.lram.num_locations,
            "table_dtype": str(table.dtype),
            "logits_max_abs_err": (got - want).abs().max().item(),
            "dvalues_max_abs_err": (dv - want_dv).abs().max().item(),
            "dvalues_rounded": rounding_agrees(dv, want_dv, table.dtype),
            "launches": launches,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if device.type == "cuda" else None)}
        del model, table, dv, want_dv, got, want
    results.put(out)
    dist.destroy_process_group()


def m6_mesh_path(argv=M6_ARGS, device_name="cuda") -> dict:
    """(m6) and (q4) in one spawn of 4 gloo ranks on the one card, the
    `sharded` placement with a bf16 table, then with an fp16 one: every
    rank's logits within 1e-5 of the dense twin's of the same dtype and
    its shard of d values (2-byte, rounded once from its fp32 sum) within
    one ulp of the twin's rows (`rounding_agrees`: the two fp32 sums add
    in atomics' order); K2, the 2-byte range gather (3 forwards) and the
    2-byte range backward (once) launched on every rank, no fp32 one.
    Held against the dense twin: the reference's own sharded gradient is
    red under jax 0.9.0 (ROADMAP C1).  Returns, by path, the counts
    summed over ranks."""
    if device_name == "cuda":
        torch.cuda.empty_cache()
    ranks, wall_s = _spawn_ranks(m6_rank, (argv, device_name),
                                 "(m6) and (q4)")
    totals = {}
    for dtype, path in MESH_TABLES.items():
        suffix = HALF[TORCH_DTYPE[dtype]][0]
        for r in ranks:
            got, who = r[dtype], f"({path}) rank {r['rank']}"
            c = got["launches"]
            check(c["lram_query"] >= 3 and c[f"sharded_gather_{suffix}"] >= 3
                  and c[f"lookup_bwd_range_{suffix}"] == 1
                  and c["sharded_gather"] == c["lookup_bwd_range"] == 0,
                  f"{who}: the {suffix} range instances must launch: {c}")
            check(got["table_dtype"] == str(TORCH_DTYPE[dtype])
                  and got["shard_rows"] * 2 == got["table_rows"],
                  f"{who}: a {got['table_dtype']} shard of "
                  f"{got['shard_rows']} rows")
            check(got["logits_max_abs_err"] <= 1e-5,
                  f"{who}: logits differ from the dense twin's by "
                  f"{got['logits_max_abs_err']}")
            check(got["dvalues_rounded"]["ok"],
                  f"{who}: d values differ from the dense twin's rows: "
                  f"{got['dvalues_rounded']}, {got['dvalues_max_abs_err']}")
        print(json.dumps({"path": f"{path} mesh, {suffix} table",
                          "argv": argv,
                          "ranks": [{"rank": r["rank"], "mesh": r["mesh"],
                                     "backend": r["backend"], **r[dtype]}
                                    for r in ranks],
                          "wall_s_incl_spawn_both_tables": wall_s}),
              flush=True)
        totals[path] = {k: sum(r[dtype]["launches"][k] for r in ranks)
                        for k in KERNELS}
    return totals


def bf16_path() -> dict:
    """Path (m), every part, and (q4), which runs in (m6)'s spawn; prints
    its seconds.  Returns the launch counts of each run."""
    t0 = time.perf_counter()
    launches = {}
    launches["m1_dense_bf16"], m1 = dense_graph_twin("m1", BF16)
    for name in BF16_SERVE:
        launches[name] = half_serve_path(name, m1, BF16)
    del m1
    launches["m4_train_bf16"] = half_train_path("m4", BF16)
    with tables_in(BF16):
        launches["m5_train_tiered_bf16"], run = tiered_train_path(
            "m5_train_tiered_bf16", BF16_TIERED_TRAIN)
    (store,) = run.stores
    check(store.dtype == torch.bfloat16 and store.bytes_per_entry() == 2 * M,
          f"(m5): the store's host tier is {store.dtype}")
    del run, store
    launches.update(m6_mesh_path())
    print(json.dumps({"path_m_s": time.perf_counter() - t0}), flush=True)
    return launches


Q5_ARCH = "qwen2-1.5b"
Q5_ARGS = ["--arch", Q5_ARCH, *SERVE_ARGS]  # (h2)'s trace


def overflow_sites(model, toks) -> list[str]:
    """The modules, in call order, whose output holds an inf or a NaN in a
    forward of `toks` (forward hooks on every module)."""
    found: list[str] = []

    def hook(name):
        def check_out(module, args, out):
            t = out[0] if isinstance(out, tuple) else out
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                found.append(name)
        return check_out

    handles = [m.register_forward_hook(hook(n or "model"))
               for n, m in model.named_modules()]
    try:
        with torch.inference_mode():
            transformer.forward(model, {"tokens": toks})
    finally:
        for h in handles:
            h.remove()
    return found


def q5_public_f16() -> dict:
    """(q5) `with_lram(qwen2-1.5b, 20)` with the model and its table in
    float16 (the `pallas` placement), drawn on the card from --seed 0 and
    served through `ServeEngine` at (h2)'s 8 requests under the decode
    graph: K2 and K1's fp16 instance launched (no fp32 K1; counts reset
    after the warm-up), every tick finite, one capture.  A forward of the
    first prompt is checked finite first, and a float16 overflow fails
    there naming the modules whose output overflowed (no re-seed, no
    rescale).  Request 0's first logits are held against a prefill of its
    prompt (padded as the engine pads it) by an fp32 copy of the same
    weights on the card, within 2^-11 x (layers + 1) x the largest.
    Tick p50 / p99 beside the tick's read bound (`tick_read_bytes`).
    Returns the launch counts."""
    args = serve.build_argparser().parse_args(Q5_ARGS)
    cfg = table_config(h_config(Q5_ARCH, dtype=F16), F16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=args.seed, device="cuda").eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trace = synthetic_trace(np.random.default_rng(args.seed), args.requests,
                            vocab_size=cfg.vocab_size,
                            max_prompt=args.prompt_len, max_gen=args.gen,
                            mixed=not args.fixed_len)
    first = torch.from_numpy(trace[0].prompt[None]).long().cuda()
    sites = overflow_sites(model, first)
    check(not sites, f"(q5): float16 overflows at random weights; first in "
                     f"{sites[:5]}")
    report, launches, reads, warm_s, engine = h_engine_run(model, args,
                                                           trace)
    del reads
    peak = torch.cuda.max_memory_allocated()
    check(len(report.requests) == args.requests,
          f"(q5): served {len(report.requests)} of {args.requests}")
    check(launches["lram_query"] > 0 and launches["gather_interp_f16"] > 0
          and launches["gather_interp"] == 0,
          f"(q5): K2 and K1's fp16 instance (alone) must launch: "
          f"{launches}")
    check(report.cuda_graph and report.graph_captures == 1
          and report.graph_ticks == len(report.step_s),
          f"(q5): cuda_graph {report.cuda_graph}, "
          f"{report.graph_captures} captures")
    read_bytes = tick_read_bytes(model, cfg, args)
    s = trace[0].prompt_len
    toks = torch.zeros((1, engine.prefill_len(s)), dtype=torch.long,
                       device="cuda")
    toks[0, :s] = first[0]
    max_len = engine.engine_cfg.max_len
    del engine
    wide_cfg = table_config(dataclasses.replace(cfg, dtype="float32"),
                            "float32")
    state = model.state_dict()
    del model
    torch.cuda.empty_cache()
    wide = transformer.init(wide_cfg, seed=args.seed, device="cuda").eval()
    wide.load_state_dict(state)  # copy_ widens every fp16 leaf exactly
    del state
    with torch.inference_mode():
        want = transformer.prefill(wide, toks, max_len)[0][0, s - 1].float()
    got = torch.from_numpy(report.requests[0].first_logits).to(want.device)
    err = float((got - want).abs().max())
    tol = 2.0**-11 * (cfg.num_layers + 1) * float(want.abs().max())
    check(err <= tol, f"(q5): request 0's first logits differ from the fp32 "
                      f"copy's by {err} (bound {tol})")
    del wide, want
    torch.cuda.empty_cache()
    print(json.dumps({
        "serve": "q5 qwen2-1.5b, model and table float16",
        "config": cfg.name, "argv": Q5_ARGS, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.dtype,
        "table_dtype": cfg.lram.table_dtype, "init_s": init_s,
        "warmup_s": warm_s, "requests": len(report.requests),
        **tick_numbers(report),
        "tick_read_bytes": read_bytes,
        "tick_read_bound_ms": 1e3 * read_bytes / HBM_BYTES_PER_S,
        "first_logits_vs_fp32_copy_max_abs_err": err,
        "first_logits_bound": tol, "peak_memory_bytes": peak,
        "launches": {k: v for k, v in launches.items() if v}}), flush=True)
    return launches


def f16_path(launches: dict) -> None:
    """Path (q) but (q4), which runs in (m6)'s spawn: (q1) the dense graph
    on an fp16 table against its fp32 twin, (q2) path (a) on an fp16 host
    tier through the serve CLI, (q3) lram-bert-medium trained on an fp16
    table, (q5) qwen2-1.5b served in float16, (q6) lram-bert-pkm trained
    in bfloat16; prints its seconds."""
    t0 = time.perf_counter()
    launches["q1_dense_f16"], q1 = dense_graph_twin("q1", F16)
    for name in F16_SERVE:
        launches[name] = half_serve_path(name, q1, F16)
    del q1
    launches["q3_train_f16"] = half_train_path("q3", F16)
    launches["q5_qwen2_f16"] = q5_public_f16()
    launches["q6_pkm_bf16"], run = pkm_train_path(BF16)
    del run
    print(json.dumps({"path_q_s": time.perf_counter() - t0}), flush=True)


def same_first_logits(name: str, got, want, tol: float = 1e-5) -> float:
    err = max(float(np.abs(a.first_logits - b.first_logits).max())
              for a, b in zip(got.requests, want.requests))
    check(err <= tol, f"{name}: first logits differ by {err}")
    return err


def profile_path(name: str, cuda_graph: bool = True):
    """A shorter serve of the path's warmed engine under torch.profiler:
    kernel time by name and the device's busy share of the engine's wall
    time (profiling slows the host, so the share is a lower bound).  Only
    the trace's replay is profiled: model build, warm-up and the graph's
    capture run before.  `cuda_graph=False`: the eager twin."""
    argv, _ = PATHS[name]
    args = serve.build_argparser().parse_args(argv + SERVE_ARGS)
    cfg = serve_config(args)
    model = transformer.init(cfg, seed=args.seed).to(args.device)
    engine = ServeEngine(model, EngineConfig(slots=4, max_len=64 + 16,
                                             cuda_graph=cuda_graph))
    trace = synthetic_trace(np.random.default_rng(0), 4,
                            vocab_size=cfg.vocab_size, max_prompt=64,
                            max_gen=16)
    engine.warmup([r.prompt_len for r in trace])
    report, per_kernel, _ = profile(lambda: engine.run(trace))
    del engine, model
    kernels = {k: v for k, v in per_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    copies = {k: v for k, v in per_kernel.items()
              if k.startswith(("Memcpy", "Memset"))}
    total_ms = sum(kernels.values()) / 1e3
    ours = ("lram_query_kernel", "gather_interp_kernel",
            "gather_interp_quant_kernel", "tiered_gather_kernel",
            "tiered_gather_quant_kernel")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "profile": name, "cuda_graph": report.cuda_graph,
        "requests": 4, "max_gen": 16,
        "wall_ms": 1e3 * report.wall_s, "kernel_ms": total_ms,
        "copy_ms": sum(copies.values()) / 1e3,
        "busy_share": total_ms / (1e3 * report.wall_s),
        "decode_ticks": len(report.step_s),
        "decode_p50_ms": report.p50_ms(),
        "memory_kernels_ms": sum(v for k, v in kernels.items()
                                 if any(o in k for o in ours)) / 1e3,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
        "copies_ms": [[k[:60], v / 1e3] for k, v in copies.items()],
    }), flush=True)


def parity_phase():
    """The smoke configs: tiered on the card against the CPU's plain
    versions (both archs), and tiered against dense on the card."""
    base = ["--smoke", "--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--requests", "3", "--seed", "1"]
    out = {}
    for arch in ("lram-tiered", "lram-tiered-q8"):
        argv = base + ["--arch", arch]
        gpu = serve.main(argv + ["--device", "cuda"])
        cpu = serve.main(argv + ["--device", "cpu"])
        check(len(gpu.requests) == len(cpu.requests) == 3,
              "parity trace lost requests")
        out[arch] = {
            "card_vs_cpu_first_logits_max_abs_err": same_first_logits(
                f"{arch} smoke card vs CPU", gpu, cpu),
            "greedy_tokens_equal": all(
                a.tokens == b.tokens
                for a, b in zip(gpu.requests, cpu.requests)),
            "cache_card": gpu.cache, "cache_cpu": cpu.cache}
    tiered = serve.main(base + ["--arch", "lram-tiered", "--device", "cuda"])
    dense = serve.main(base + ["--arch", "lram-tiered", "--device", "cuda",
                               "--placement", "pallas"])
    out["tiered_vs_dense_card_first_logits_max_abs_err"] = \
        same_first_logits("smoke tiered vs dense on the card", tiered, dense)
    print(json.dumps({"parity": "smoke configs", **out}), flush=True)


TRAIN_STEPS = 20
TRAIN_ARGS = ["--arch", "lram-bert-medium", "--placement", "pallas",
              "--batch", "8", "--seq", "256", "--steps", str(TRAIN_STEPS),
              "--json"]


def train_path():
    """Train lram-bert-medium at full width; returns (launch counts, run).
    The launch counts are reset just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    run = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(run.records) == TRAIN_STEPS, "train: steps missing")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] >= TRAIN_STEPS,
              f"train: {kernel} launched {launches[kernel]} times in "
              f"{TRAIN_STEPS} steps")
    check(launches["lookup_bwd"] == TRAIN_STEPS,
          f"train: the backward kernel launched {launches['lookup_bwd']} "
          f"times in {TRAIN_STEPS} steps (one memory layer: once a step)")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"train: the loss did not fall (steps 1-5 mean "
                        f"{first}, steps 16-20 mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    PHASE6.update(step_ms_median_steps_6_20=median_ms,
                  peak_memory_bytes=peak)
    print(json.dumps({
        "train": "lram-bert-medium", "argv": TRAIN_ARGS,
        "tokens_per_step": tokens, "lookups_per_step": tokens * 32,
        "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_steps_16_20": last,
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "allocated_before_bytes": allocated_before,
        "peak_memory_bytes": peak, "wall_s_incl_init_and_eval": wall_s,
        "final_eval_loss": run.final_eval_loss,
        "final_fact_recall": run.final_fact_recall, "launches": launches,
    }), flush=True)
    return launches, run


def profile_train_step(run, label: str = "train step",
                       ours=("lram_query_kernel", "gather_interp_kernel",
                             "lookup_bwd")) -> None:
    """One more full-width train step under torch.profiler: device busy
    share of the step's wall time and the top kernels; and K1 in that
    step beside its bound on the step's own indices (each distinct row
    they name read once)."""
    batch = train.batch_to(data.get_batch(run.dcfg, step=TRAIN_STEPS),
                           next(run.model.parameters()).device)
    wall, k1_calls = [], []
    k1 = gather_interp.gather_interp

    def recorded_k1(values, idx, w):
        k1_calls.append(idx)
        return k1(values, idx, w)

    def step():
        t0 = time.perf_counter()
        out = run.step_fn(run.opt_state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        return out

    # the wrapper counts its launches through its module's name
    recorded_k1.launches = k1.launches
    gather_interp.gather_interp = recorded_k1
    try:
        _, per_kernel, calls = profile(step)
    finally:
        gather_interp.gather_interp = k1
        k1.launches = recorded_k1.launches
    k1_step = None
    if k1_calls:
        n = sum(idx.numel() // TOP_K for idx in k1_calls)
        distinct = sum(torch.unique(idx).numel() for idx in k1_calls)
        b, by = gather_bound(distinct, 4 * M, n)
        k1_step = {
            "calls": len(k1_calls), "n": n, "distinct_rows": distinct,
            "device_ms": sum(v for k, v in per_kernel.items()
                             if "gather_interp_kernel" in k) / 1e3,
            "device_events": sum(c for k, c in calls.items()
                                 if "gather_interp_kernel" in k),
            "bound_ms": b, "bound_by": by}
        del k1_calls
    kernels = {k: v for k, v in per_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    copies = {k: v for k, v in per_kernel.items()
              if k.startswith(("Memcpy", "Memset"))}
    total_ms = sum(kernels.values()) / 1e3
    mine = {name: sum(v for k, v in kernels.items() if name in k) / 1e3
            for name in ours}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "profile": label, "wall_ms": 1e3 * wall[0],
        "kernel_ms": total_ms, "copy_ms": sum(copies.values()) / 1e3,
        "busy_share": total_ms / (1e3 * wall[0]),
        "kernel_launches": sum(c for k, c in calls.items() if k in kernels),
        "memory_kernels_ms": mine, "k1": k1_step,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
        "copies_ms": [[k[:60], v / 1e3] for k, v in copies.items()],
    }), flush=True)


# path -> (arch, its store's class, its forward gather, its backward
# instance, steps); (a) and (b) cut from 20 steps to 10 to keep the
# script in its time limit (PERF.md section 4)
TIERED_STEPS = 10
TIERED_TRAIN = {
    "a_train_tiered": ("lram-tiered", TieredValueStore, "gather_interp",
                       "lookup_bwd_rows", TIERED_STEPS),
    "b_train_tiered_q8": ("lram-tiered-q8", TieredValueStore,
                          "gather_interp_quant", "lookup_bwd_quant",
                          TIERED_STEPS),
    "c_train_sharded_tiered": ("lram-sharded-tiered", ShardedTieredStore,
                               "gather_interp", "lookup_bwd_rows", 10),
}
TIERED_ARGS = ["--batch", "8", "--seq", "64", "--json"]


def _host_tier(store):
    """A copy of the host tier: its payload as (N, m) rows and its scales
    (or None), every range's for a sharded-tiered store."""
    parts = getattr(store, "parts", [store])
    host = np.concatenate([p._host.reshape(p.num_rows, -1) for p in parts])
    if parts[0]._host_scale is None:
        return host, None
    return host, np.concatenate([p._host_scale.reshape(-1) for p in parts])


def tiered_train_path(name: str, spec=None):
    """Train a tiered arch at full width through the store's write-back;
    returns (launch counts, run).  The launch counts are reset just
    before and read just after.  Inside the timed steps the wrappers only
    read clocks and keep references: the host tier is copied when the
    trainer binds the store, the write-back is timed (the wait for the
    backward, by the synchronize its own copy to the host would make, and
    its host work), the host index arrays it applies are kept and reduced
    to the touched rows after the run, and the flat route's host time and
    stats are read per call.  A sharded-tiered store writes back once a
    step and each of its ranges once a step.  `spec`: (arch, store class,
    gather, backward instance, steps), else TIERED_TRAIN's."""
    arch, cls, gather, bwd, steps = spec or TIERED_TRAIN[name]
    argv = ["--arch", arch, *TIERED_ARGS, "--steps", str(steps)]
    before, applied, wb, fwd = {}, [], [], []
    bind = train.bind_stores
    writeback = cls.writeback
    apply_writeback = cls.apply_writeback
    lookup_rows = cls.lookup_rows

    def bind_and_copy(model, lr):
        stores = bind(model, lr)
        for store in stores:
            before[id(store)] = _host_tier(store)
        return stores

    def timed_writeback(self, idx, w, g):
        t0 = time.perf_counter()
        torch.cuda.synchronize()  # the backward queued ahead of the sink
        t1 = time.perf_counter()
        writeback(self, idx, w, g)
        wb.append({"wait_ms": 1e3 * (t1 - t0),
                   "host_ms": 1e3 * (time.perf_counter() - t1),
                   "to_host_bytes": idx.nbytes + w.nbytes + g.nbytes})

    def kept_apply_writeback(self, idx, wg):
        applied.append(idx)  # the host copy the write-back made; unchanged
        apply_writeback(self, idx, wg)

    def timed_lookup_rows(self, idx):
        prev = dict(self.stats)
        t0 = time.perf_counter()
        out = lookup_rows(self, idx)
        d = {k: self.stats[k] - prev[k] for k in prev}
        seen = d["hits"] + d["misses"] + d["uncached"]
        fwd.append({"host_ms": 1e3 * (time.perf_counter() - t0),
                    "overflow_share": d["uncached"] / seen,
                    "hit_rate": d["hits"] / seen,
                    "fill_bytes": d["fill_bytes"],
                    "overflow_bytes": d["uncached"]
                    * self.bytes_per_entry()})
        return out

    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    train.bind_stores = bind_and_copy
    cls.writeback = timed_writeback
    cls.apply_writeback = kept_apply_writeback
    cls.lookup_rows = timed_lookup_rows
    reset_counts()
    t0 = time.perf_counter()
    try:
        run = train.main(argv)
        torch.cuda.synchronize()
    finally:
        train.bind_stores = bind
        cls.writeback = writeback
        cls.apply_writeback = apply_writeback
        cls.lookup_rows = lookup_rows
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(run.records) == steps, f"{name}: steps missing")
    for kernel in ("lram_query", gather):
        check(launches[kernel] >= steps,
              f"{name}: {kernel} launched {launches[kernel]} times in "
              f"{steps} steps")
    check(launches[bwd] == steps,
          f"{name}: the backward instance {bwd} launched {launches[bwd]} "
          f"times in {steps} steps (one memory layer: once a step)")
    (store,) = run.stores
    ranges = getattr(store, "num_ranges", 1)
    check(store.stats["writebacks"] == steps * ranges
          and steps == len(wb) == len(applied),
          f"{name}: {len(wb)} write-backs ({store.stats['writebacks']} "
          f"range write-backs) in {steps} steps")
    check(not any(p._dirty for p in getattr(store, "parts", [store])),
          f"{name}: dirty slots after the flush")
    host0, scale0 = before[id(store)]
    host1, scale1 = _host_tier(store)
    rows_n = store.num_rows
    changed = (host1 != host0).any(-1)
    if scale0 is not None:
        changed |= scale1 != scale0
    hit = np.zeros(rows_n, bool)
    hit[np.concatenate([i.reshape(-1) for i in applied])] = True
    check(not (changed & ~hit).any(),
          f"{name}: {int((changed & ~hit).sum())} rows the write-back never "
          f"touched changed on the host tier")
    check((changed & hit).any(), f"{name}: no touched row changed")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"{name}: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"{name}: the loss did not fall (steps 1-5 mean "
                        f"{first}, the last 5 steps' mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    steady = lambda recs, key: float(np.median(  # noqa: E731
        [r[key] for r in recs[5:]]))
    print(json.dumps({
        "train": name, "argv": argv, "ranges": ranges,
        "tokens_per_step": tokens, "lookups_per_step": tokens * 32,
        "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_last_5_steps": last,
        "step_ms": step_ms, "step_ms_median_steps_6_on": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "allocated_before_bytes": allocated_before,
        "peak_memory_bytes": peak, "wall_s_incl_init_and_eval": wall_s,
        "writeback_host_ms_median_6_on": steady(wb, "host_ms"),
        "writeback_wait_ms_median_6_on": steady(wb, "wait_ms"),
        "to_host_bytes_per_step": wb[0]["to_host_bytes"],
        "flat_route_host_ms_median_6_on": steady(fwd, "host_ms"),
        "fill_bytes_per_step_median_6_on": steady(fwd, "fill_bytes"),
        "overflow_bytes_per_step_median_6_on": steady(fwd,
                                                      "overflow_bytes"),
        "hit_rate_train": float(np.mean([f["hit_rate"] for f in fwd])),
        "overflow_share_train": float(np.mean([f["overflow_share"]
                                               for f in fwd])),
        "rows_touched": int(hit.sum()), "rows_changed": int(changed.sum()),
        "store_stats": store.stats,
        "final_eval_loss": run.final_eval_loss,
        "final_fact_recall": run.final_fact_recall, "launches": launches,
    }), flush=True)
    return launches, run


MESH_RANKS = 4
MESH_ARGS = ["--arch", "lram-bert-medium", "--placement", "sharded",
             "--use-mesh", "--batch", "8", "--seq", "256", "--steps",
             str(TRAIN_STEPS), "--json"]
MESH_TIMEOUT_S = 600


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_config(args, placement: str, **lram_kw):
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    return dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl=placement, **lram_kw))


def _logits_agree(args, device, mesh) -> float:
    """The eval forward of the run's first eval batch on the dense pallas
    table and on this rank's shard (the dense blocks gathered whole),
    from the same seed's weights: the largest logit difference."""
    cfg = _mesh_config(args, "pallas")
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, objective=cfg.objective,
                           seed=args.seed)
    batch = train.batch_to(data.get_batch(dcfg, step=10_000_000), device)
    out = []
    for placement in ("pallas", "sharded"):
        model = transformer.init(_mesh_config(args, placement),
                                 seed=args.seed)
        if placement == "sharded":
            sharding.shard_params(model, mesh)
        model = model.to(device)
        with torch.no_grad(), sharding.gathered(model):
            out.append(transformer.forward(model, batch))
        del model
    return (out[0] - out[1]).abs().max().item()


def _quant_cells_agree(args, device, mesh) -> dict:
    """The sharded int8 and e4m3 cells' memory layer (`lram_apply`, eval)
    against the dense 1-byte pallas cell (B4) on the same payloads, at the
    run's width (full: a 2^20 x 64 table, 32 heads) on one data rank's
    tokens (full: 1,024, n = 32,768 queries): the largest difference per
    payload."""
    from repro_torch.core import lram as lram_mod

    tokens = args.batch * args.seq // 2
    errs = {}
    for kind in PAYLOADS:
        # one draw on every rank: the model ranks' shards are one table
        dense = lram_mod.LRAM(
            _mesh_config(args, "pallas", table_quant=kind).lram,
            generator=torch.Generator().manual_seed(args.seed))
        shard = lram_mod.LRAM(_mesh_config(args, "sharded",
                                           table_quant=kind).lram)
        shard.load_state_dict(dense.state_dict())
        sharding.shard_params(shard, mesh)
        x = torch.randn(tokens, dense.cfg.in_dim,
                        generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            want = lram_mod.lram_apply(dense.to(device), x.to(device))
            got = lram_mod.lram_apply(shard.to(device), x.to(device))
        errs[kind] = (got - want).abs().max().item()
        del dense, shard
    return errs


def held_dense_bytes(model, opt_state, mesh) -> dict:
    """The bytes of dense parameters and Adam moments this rank holds
    between steps (every leaf but a row-sharded table's), against its
    share: a split leaf's block (its whole / the ranks of its spec's
    axes) and every replicated leaf whole, each with its two Adam
    moments (the parameter in its dtype, mu and nu fp32).  Fails if a
    dense leaf is whole after the step or a rank holds more than its
    share; lists the replicated leaves."""
    tables = set(sharding.sharded_tables(model, mesh))
    blocks = sharding.dense_blocks(model)
    check(blocks is not None and not blocks.whole,
          "mesh: the dense weights are not this rank's blocks between "
          "steps")
    held = share = whole = replicated_bytes = 0
    replicated = {}
    for k, p in model.named_parameters():
        if k in tables:
            continue
        leaf = (p, opt_state["mu"][k], opt_state["nu"][k])
        # bytes an element: the parameter's dtype and both moments' (fp32)
        size = sum(t.element_size() for t in leaf)
        if k in blocks.specs:
            full = math.prod(blocks.shapes[k]) * size
            part = full // math.prod(
                mesh.size(a) for a in sharding.spec_axes(blocks.specs[k]))
        else:
            full = part = p.numel() * size
            replicated[k] = p.numel() * p.element_size()
            replicated_bytes += full
        held += sum(t.numel() * t.element_size() for t in leaf)
        share += part
        whole += full
    check(held <= share, f"mesh: a rank holds {held} B of dense parameters "
                         f"and moments against its share of {share} B")
    return {"held_bytes": held, "share_bytes": share,
            "whole_bytes": whole, "split_leaves": len(blocks.specs),
            "replicated_leaves": replicated,
            "replicated_bytes": replicated_bytes}


def _rank_env(rank: int, port: int) -> None:
    """A spawned rank's torchrun environment (all ranks on the one card),
    and no TF32, as in the parent."""
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(MESH_RANKS),
                       "LOCAL_WORLD_SIZE": str(MESH_RANKS),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _spawn_ranks(fn, args, what: str) -> tuple[list[dict], float]:
    """Run fn(rank, port, results, *args) in MESH_RANKS spawned processes
    (a free port for their rendezvous); fails if a rank fails, dies or
    outlasts MESH_TIMEOUT_S, or fewer than all report.  Returns every
    rank's result, by rank, and the wall seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = mp.start_processes(fn, args=(port, results, *args),
                               nprocs=MESH_RANKS, join=False,
                               start_method="spawn")
    got = []
    try:
        while True:
            while not results.empty():  # a rank blocks on a full pipe
                got.append(results.get())
            if procs.join(timeout=5):
                break
            check(time.perf_counter() - t0 < MESH_TIMEOUT_S,
                  f"{what}: the ranks outlasted {MESH_TIMEOUT_S} s "
                  f"(a missing collective?)")
    except mp.ProcessRaisedException as e:
        fail(f"{what}: a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"{what}: a rank died: {e}")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    wall_s = time.perf_counter() - t0
    while not results.empty():
        got.append(results.get())
    check(len(got) == MESH_RANKS, f"{what}: {len(got)} of {MESH_RANKS} "
                                  f"ranks reported")
    return sorted(got, key=lambda r: r["rank"]), wall_s


def mesh_rank(rank: int, port: int, results, argv, device_name) -> None:
    """One rank of the mesh phase (a spawned process; all ranks on the one
    card): the two forward checks, the mesh training through `train.main`
    with its launch counts reset just before and read just after, then two
    more steps with every sum across ranks timed."""
    _rank_env(rank, port)
    args = train.build_argparser().parse_args(argv)
    mesh, device = mesh_lib.init_mesh(device_name)
    out = {"rank": rank, "coords": mesh.coords, "mesh": mesh.shape,
           "backend": dist.get_backend()}
    out["logits_max_abs_err"] = _logits_agree(args, device, mesh)
    reset_counts()
    out["quant_max_abs_err"] = _quant_cells_agree(args, device, mesh)
    out["quant_launches"] = read_counts()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train.main(argv)
    _sync(device)
    out["launches"] = read_counts()
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                if device.type == "cuda" else None)
    out["records"] = run.records
    out["final_eval_loss"] = run.final_eval_loss
    out["held"] = held_dense_bytes(run.model, run.opt_state, mesh)
    # two more steps, every sum and gather across ranks timed (the device
    # synchronized before and after each, so its time is the collective's
    # alone); a gather's bytes are those it receives
    all_reduce, all_gather = (collectives.all_reduce_,
                              collectives.all_gather_blocks)
    comm = {"sum": [], "gather": []}

    def timed_sum(t, group):
        _sync(device)
        t0 = time.perf_counter()
        all_reduce(t, group)
        _sync(device)
        comm["sum"].append((time.perf_counter() - t0,
                            t.numel() * t.element_size()))
        return t

    def timed_gather(t, group):
        _sync(device)
        t0 = time.perf_counter()
        parts = all_gather(t, group)
        _sync(device)
        comm["gather"].append((time.perf_counter() - t0, sum(
            p.numel() * p.element_size() for p in parts)))
        return parts

    collectives.all_reduce_ = timed_sum
    collectives.all_gather_blocks = timed_gather
    timed = []
    try:
        for step in (args.steps, args.steps + 1):
            batch = train.batch_to(data.get_batch(run.dcfg, step=step),
                                   device)
            for v in comm.values():
                v.clear()
            t0 = time.perf_counter()
            run.step_fn(run.opt_state, batch)
            _sync(device)
            wall = time.perf_counter() - t0
            rec = {"wall_ms": 1e3 * wall}
            for kind, calls in comm.items():
                ms = 1e3 * sum(c for c, _ in calls)
                rec.update({f"{kind}_ms": ms, f"{kind}s": len(calls),
                            f"{kind}_bytes": sum(b for _, b in calls),
                            f"{kind}_share": ms / rec["wall_ms"]})
            timed.append(rec)
    finally:
        collectives.all_reduce_ = all_reduce
        collectives.all_gather_blocks = all_gather
    out["timed_steps"] = timed
    results.put(out)
    dist.destroy_process_group()


def mesh_phase(dense_records, argv=MESH_ARGS, device_name="cuda"):
    """Spawn 4 ranks on the one card (gloo: a data 2 x model 2 mesh, the
    2^20-row table row-sharded over model, 128 MiB a rank) to train
    lram-bert-medium at full width 20 steps; fails unless every rank
    launched K2, the range gather and the range backward (once a step),
    the losses are finite and fall, they match the dense run of phase 6
    (rtol 1e-4 over steps 1-5, 1e-3 over all 20), and the two forward
    checks hold to 1e-5.  Returns the launch counts summed over ranks
    (training, and the 1-byte forward check) and rank 0's losses."""
    if device_name == "cuda":
        torch.cuda.empty_cache()
    steps = train.build_argparser().parse_args(argv).steps
    ranks, wall_s = _spawn_ranks(mesh_rank, (argv, device_name),
                                 "mesh phase")
    dense = [r["loss"] for r in dense_records]
    for r in ranks:
        who = f"mesh rank {r['rank']}"
        c = r["launches"]
        check(c["lram_query"] >= steps and c["sharded_gather"] >= steps,
              f"{who}: K2 / the range gather launched {c['lram_query']} / "
              f"{c['sharded_gather']} times in {steps} steps")
        check(c["lookup_bwd_range"] == steps,
              f"{who}: the range backward launched "
              f"{c['lookup_bwd_range']} times in {steps} steps")
        check(r["quant_launches"]["sharded_gather_quant"] == len(PAYLOADS),
              f"{who}: the 1-byte range gather did not launch")
        losses = [x["loss"] for x in r["records"]]
        norms = [x["grad_norm"] for x in r["records"]]
        check(len(losses) == steps
              and all(math.isfinite(x) for x in losses + norms),
              f"{who}: steps missing or non-finite: {losses} {norms}")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"{who}: the loss did not fall: {losses}")
        check(np.allclose(losses[:5], dense[:5], rtol=1e-4, atol=0)
              and np.allclose(losses, dense, rtol=1e-3, atol=0),
              f"{who}: losses differ from the dense run: {losses} vs "
              f"{dense}")
        check(r["logits_max_abs_err"] <= 1e-5,
              f"{who}: eval logits differ from the dense path by "
              f"{r['logits_max_abs_err']}")
        check(all(e <= 1e-5 for e in r["quant_max_abs_err"].values()),
              f"{who}: the 1-byte sharded cells differ from the dense "
              f"B4 cell: {r['quant_max_abs_err']}")
    r0 = ranks[0]
    args = train.build_argparser().parse_args(argv)
    step_ms = [x["step_ms"] for x in r0["records"]]
    median_ms = float(np.median(step_ms[5:]))
    tokens = args.batch * args.seq
    losses = np.array([x["loss"] for x in r0["records"]])
    print(json.dumps({
        "train": "mesh", "argv": argv, "ranks": MESH_RANKS,
        "mesh": r0["mesh"], "backend": r0["backend"], "device": device_name,
        "tokens_per_step": tokens,
        "lookups_per_rank_step": tokens // 2
        * _mesh_config(args, "sharded").lram.heads,
        "losses": losses.tolist(),
        "grad_norms": [x["grad_norm"] for x in r0["records"]],
        "dense_losses": dense,
        "loss_max_rel_err_steps_1_5": float(np.max(np.abs(
            losses[:5] / np.array(dense[:5]) - 1))),
        "loss_max_rel_err": float(np.max(np.abs(
            losses / np.array(dense) - 1))),
        "loss_mean_steps_1_5": float(np.mean(losses[:5])),
        "loss_mean_steps_16_20": float(np.mean(losses[-5:])),
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                      for r in ranks],
        "held_dense_by_rank": [r["held"] for r in ranks],
        "timed_steps_by_rank": [r["timed_steps"] for r in ranks],
        "logits_max_abs_err_by_rank": [r["logits_max_abs_err"]
                                       for r in ranks],
        "quant_max_abs_err_by_rank": [r["quant_max_abs_err"]
                                      for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "final_eval_loss": r0["final_eval_loss"],
        "wall_s_incl_spawn_init_checks_eval": wall_s,
    }), flush=True)
    total = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
    quant_total = {k: sum(r["quant_launches"][k] for r in ranks)
                   for k in KERNELS}
    return total, quant_total, losses.tolist()


PKM_ARGS = ["--arch", "lram-bert-pkm", "--batch", "8", "--seq", "256",
            "--steps", str(TRAIN_STEPS), "--json"]


@contextlib.contextmanager
def model_dtype(arch: str, dtype: str | None):
    """`configs.get_config(arch)` in `dtype` (None: as it is), so that
    the CLI builds it (the reference's CLI has no dtype flag)."""
    get = configs.get_config
    if dtype is not None:
        configs.get_config = lambda name, **kw: (
            dataclasses.replace(get(name, **kw), dtype=dtype)
            if name == arch else get(name, **kw))
    try:
        yield
    finally:
        configs.get_config = get


def pkm_train_path(dtype: str | None = None):
    """Train the paper's PKM baseline at full width (2^16 x 512 table, 8
    heads, top-32), in float32 (7b) or with the model, the PKM's leaves
    with it, in `dtype` ((q6): bfloat16); returns (launch counts, run).
    The reference computes PKM without a Pallas kernel, so no kernel of
    the port may launch here: the counts are reset just before and read
    just after, and must all be 0."""
    tag = "7b" if dtype is None else "q6"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    with model_dtype("lram-bert-pkm", dtype):
        run = train.main(PKM_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    (layer,) = [m for m in run.model.modules() if isinstance(m, PKM)]
    check(layer.values.dtype == run.model.cfg.torch_dtype
          and run.model.cfg.dtype == (dtype or "float32"),
          f"({tag}) pkm: a {run.model.cfg.dtype} model with a "
          f"{layer.values.dtype} PKM table")
    check(not any(launches.values()),
          f"({tag}) pkm: a kernel of the port launched on the PKM path: "
          f"{launches}")
    check(len(run.records) == TRAIN_STEPS, f"({tag}) pkm: steps missing")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"({tag}) pkm: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"({tag}) pkm: the loss did not fall (steps 1-5 "
                        f"mean {first}, steps 16-20 mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    peak = torch.cuda.max_memory_allocated()
    PATH_M[tag] = {"dtype": run.model.cfg.dtype,
                   "step_ms_median_steps_6_20": median_ms,
                   "peak_memory_bytes": peak}
    print(json.dumps({
        "train": f"{tag} lram-bert-pkm", "dtype": run.model.cfg.dtype,
        "argv": PKM_ARGS,
        "tokens_per_step": tokens, "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_steps_16_20": last,
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "allocated_before_bytes": allocated_before,
        "peak_memory_bytes": peak,
        "wall_s_incl_init_and_eval": wall_s,
        "final_eval_loss": run.final_eval_loss, "launches": launches,
    }), flush=True)
    return launches, run


class _Tee(io.TextIOBase):
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        return self.kept.write(text)

    def flush(self):
        self.out.flush()


class RecordingManager(CheckpointManager):
    """The CLIs' checkpoint manager, kept for its save and restore
    timings; right after a restore it holds every store it streamed into
    against the checkpoint's shard files (payload and scales equal)."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.restored_stores = []
        RecordingManager.made.append(self)

    def restore(self, like, **kw):
        step, tree = super().restore(like, **kw)
        stores = {id(x): x for _, x in _tree_items(like)
                  if lookup.is_store(x)}
        self.restored_stores = list(stores.values())
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.json")) as f:
            metas = [m for m in json.load(f)["leaves"].values()
                     if m.get("kind") == "tiered"]
        check(len(metas) == len(self.restored_stores),
              "restore: one tiered entry a store")
        for store, meta in zip(self.restored_stores, metas):
            shards = os.path.join(d, meta["dir"])
            for i in range(store.num_shards):
                same = np.array_equal(store.shard_host(i), _load(
                    os.path.join(shards, f"shard_{i:06d}.npy")))
                if store.quant != "none":
                    same &= np.array_equal(store.shard_scale_host(i), _load(
                        os.path.join(shards, f"scale_{i:06d}.npy")))
                check(same, f"restore: shard {i} differs from the saved one")
        return step, tree


def _cli(main, argv, *, crash: bool = False):
    """Run a CLI's `main` with the launch counts reset just before and
    read just after; returns (result or the failure, its step records,
    its output, launch counts).  With `crash` it must raise
    SimulatedFailure, and only that is caught."""
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        if crash:
            try:
                main(argv)
            except fault.SimulatedFailure as e:
                # the traceback holds the crashed run's frames, and so its
                # model, in a cycle through this frame: drop it
                result = e.with_traceback(None)
            else:
                fail(f"{argv}: no SimulatedFailure")
        else:
            result = main(argv)
        torch.cuda.synchronize()
    launches = read_counts()
    out = tee.kept.getvalue()
    steps = [json.loads(x) for x in out.splitlines()
             if x.startswith('{"step"')]
    return result, [x for x in steps if "loss" in x], out, launches


def _history(managers) -> list[dict]:
    """Each save's snapshot and write ms and bytes, each restore's ms."""
    return [h for m in managers for h in m.history]


def dense_resume_path(dense_records, ckpt_dir):
    """lram-bert-medium (`--placement pallas`) at full width saves every 10
    steps, fails before step 15 and is relaunched: the relaunch resumes
    from step 10; its step-10 loss is the crashed run's bit for bit (the
    forward's kernels K2 and K1 are deterministic); steps 10-14 within
    rtol 1e-4 and 15-19 within 1e-3 of `train_path`'s uninterrupted run
    (the backward's scatter adds in atomic order).  Returns the launch
    counts of both runs."""
    argv = TRAIN_ARGS + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "10"]
    _, crashed, _, crash_launches = _cli(
        train.main, argv + ["--simulate-failure-at", "15"], crash=True)
    check([r["step"] for r in crashed] == list(range(15)),
          "dense resume: the crashed run's steps")
    run, _, out, resume_launches = _cli(train.main, argv)
    check("resumed from step 10\n" in out and run.start_step == 10,
          "dense resume: the relaunch did not resume from step 10")
    for name, launches in (("crashed", crash_launches),
                           ("resumed", resume_launches)):
        for kernel in ("lram_query", "gather_interp", "lookup_bwd"):
            check(launches[kernel] > 0,
                  f"dense resume: {kernel} never launched in the {name} run")
    got = [r["loss"] for r in run.records]
    want = [r["loss"] for r in dense_records[10:]]
    check(got[0] == crashed[10]["loss"],
          f"dense resume: step 10 loss {got[0]} != the crashed run's "
          f"{crashed[10]['loss']}")
    err = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    check(len(got) == 10 and max(err[:5]) <= 1e-4 and max(err) <= 1e-3,
          f"dense resume: losses {got} against {want}")
    print(json.dumps({
        "resume": "lram-bert-medium", "argv": argv,
        "crashed_losses": [r["loss"] for r in crashed],
        "resumed_losses": got, "uninterrupted_losses": want,
        "rel_err_steps_10_14": max(err[:5]), "rel_err_steps_10_19": max(err),
        "checkpoints": _history(RecordingManager.made),
        "launches_crashed": crash_launches,
        "launches_resumed": resume_launches,
    }), flush=True)
    saved = {"layout": _layout(ckpt_dir, 10), "bytes": next(
        h["bytes"] for h in _history(RecordingManager.made)
        if h["op"] == "save" and h["step"] == 10)}
    return crash_launches, resume_launches, saved


def _layout(ckpt_dir: str, step: int) -> dict:
    """A checkpoint's leaf names, shapes, dtypes and kinds (no checksums)."""
    with open(os.path.join(ckpt_dir, f"step_{step:012d}",
                           "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {n: [m.get("shape"), m.get("dtype"), m.get("kind")]
            for n, m in leaves.items()}


MESH_CKPT_ARGS = ["--arch", "lram-bert-medium", "--placement", "sharded",
                  "--use-mesh", "--batch", "8", "--seq", "256", "--steps",
                  "12", "--ckpt-every", "6", "--json"]
MESH_CRASH_AT = 9
# one process restores the mesh's step-12 checkpoint into the dense table
ELASTIC_ARGS = ["--arch", "lram-bert-medium", "--placement", "pallas",
                "--batch", "8", "--seq", "256", "--steps", "14", "--json"]


def mesh_ckpt_rank(rank: int, port: int, results, argv, device_name,
                   crash: bool) -> None:
    """One rank of phase 6c (a spawned process): `train.main(argv)` with
    its launch counts reset just before and read just after and its
    checkpoint managers recorded; with `crash` it must raise
    SimulatedFailure, and only that is caught.  Reports its peak device
    memory, and after a run that ends its held dense bytes."""
    _rank_env(rank, port)
    train.CheckpointManager = RecordingManager
    RecordingManager.made = []
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        try:
            run = train.main(argv)
        except fault.SimulatedFailure:
            run = None
    _sync(torch.device(device_name))
    launches = read_counts()
    check((run is None) == crash, f"mesh resume rank {rank}: "
          f"{'no' if crash else 'a'} SimulatedFailure")
    out = tee.kept.getvalue().splitlines()
    results.put({
        "rank": rank, "launches": launches,
        "history": _history(RecordingManager.made),
        "steps": [json.loads(x) for x in out if x.startswith('{"step"')],
        "resumed": [x for x in out if x.startswith("resumed from")],
        "start_step": None if run is None else run.start_step,
        "records": [] if run is None else run.records,
        "held": None if run is None else held_dense_bytes(
            run.model, run.opt_state, context.get_mesh()),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                              if device_name == "cuda" else None)})
    dist.destroy_process_group()


# the mesh resume's and the elastic restore's losses against phase 6b's:
# the same steps from the same state, apart in float rounding only (the
# scatter's atomics; one process's sums against the mesh's): 1.3e-7 at
# most measured on an H100
RESUME_RTOL = 1e-5


def mesh_resume_path(mesh_losses, dense_saved, ckpt_dir,
                     argv=MESH_CKPT_ARGS, device_name="cuda",
                     dense_argv=ELASTIC_ARGS):
    """Phase 6c: the mesh run of phase 6b (4 ranks, data 2 x model 2, the
    table row-sharded over model) with a save every 6 steps fails before
    step 9 on every rank and is relaunched on 4 new ranks: rank 0 alone
    prints `resumed from step 6`, the step-6 loss is the crashed run's
    bit for bit, steps 6-11 are within rtol 1e-5 of phase 6b's, K2, the
    range gather and the range backward launched on every rank in both
    runs, and the step-12 checkpoint has phase 6a's leaf names, shapes,
    dtypes and bytes (a one-process checkpoint's).  Then one process
    restores it into the dense pallas table and trains steps 12-13 (rtol
    1e-5 of phase 6b's; K2, K1 and `lookup_bwd` launched).  Returns the
    three runs' launch counts (the mesh runs' summed over ranks)."""
    if device_name == "cuda":
        torch.cuda.empty_cache()
    argv = argv + ["--ckpt-dir", ckpt_dir]
    crashed, crash_s = _spawn_ranks(
        mesh_ckpt_rank, (argv + ["--simulate-failure-at",
                                 str(MESH_CRASH_AT)], device_name, True),
        "mesh crash")
    resumed, resume_s = _spawn_ranks(
        mesh_ckpt_rank, (argv, device_name, False), "mesh resume")
    crash_losses = [x["loss"] for x in crashed[0]["steps"]]
    check(len(crash_losses) == MESH_CRASH_AT,
          f"mesh crash: {len(crash_losses)} steps before the failure")
    check(resumed[0]["resumed"] == ["resumed from step 6"]
          and not any(r["resumed"] for r in resumed[1:])
          and all(r["start_step"] == 6 for r in resumed),
          "mesh resume: rank 0 alone should print resumed from step 6")
    got = [x["loss"] for x in resumed[0]["records"]]
    check(len(got) == 6 and got[0] == crash_losses[6],
          f"mesh resume: step 6 loss {got[:1]} != the crashed run's "
          f"{crash_losses[6]}")
    err = [abs(a - b) / abs(b) for a, b in zip(got, mesh_losses[6:12])]
    check(max(err) <= RESUME_RTOL, f"mesh resume: losses {got} against phase "
                            f"6b's {mesh_losses[6:12]}")
    for name, ranks in (("crashed", crashed), ("resumed", resumed)):
        for r in ranks:
            for kernel in ("lram_query", "sharded_gather",
                           "lookup_bwd_range"):
                check(r["launches"][kernel] > 0,
                      f"mesh {name} rank {r['rank']}: {kernel} never "
                      f"launched")
    layout = _layout(ckpt_dir, 12)
    check(layout == dense_saved["layout"],
          "mesh resume: the step-12 checkpoint's leaves differ from phase "
          "6a's one-process checkpoint")
    saves = [h for h in resumed[0]["history"] if h["op"] == "save"]
    check(abs(saves[-1]["bytes"] - dense_saved["bytes"]) <= 256,
          f"mesh resume: {saves[-1]['bytes']} bytes saved against phase "
          f"6a's {dense_saved['bytes']}")
    run, _, out, dense_launches = _cli(train.main,
                                       dense_argv + ["--ckpt-dir", ckpt_dir])
    check("resumed from step 12\n" in out and run.start_step == 12,
          "mesh elastic restore: one process did not resume from step 12")
    dense_got = [r["loss"] for r in run.records]
    dense_err = [abs(a - b) / abs(b)
                 for a, b in zip(dense_got, mesh_losses[12:14])]
    check(len(dense_got) == 2 and max(dense_err) <= RESUME_RTOL,
          f"mesh elastic restore: losses {dense_got} against phase 6b's "
          f"{mesh_losses[12:14]}")
    for kernel in ("lram_query", "gather_interp", "lookup_bwd"):
        check(dense_launches[kernel] > 0,
              f"mesh elastic restore: {kernel} never launched")
    print(json.dumps({
        "resume": "mesh lram-bert-medium", "argv": argv,
        "crashed_losses": crash_losses, "resumed_losses": got,
        "uninterrupted_losses": mesh_losses[6:12],
        "rel_err_steps_6_11": max(err),
        "checkpoints_by_rank": {
            "crashed": [r["history"] for r in crashed],
            "resumed": [r["history"] for r in resumed]},
        "wall_s_crashed": crash_s, "wall_s_resumed": resume_s,
        "elastic_restore_one_process": {
            "argv": dense_argv, "losses": dense_got,
            "mesh_losses": mesh_losses[12:14], "rel_err": max(dense_err),
            "checkpoints": _history(RecordingManager.made[-1:]),
            "launches": dense_launches},
        "held_dense_resumed_by_rank": [r["held"] for r in resumed],
        "peak_memory_bytes_by_rank": {
            "crashed": [r["peak_memory_bytes"] for r in crashed],
            "resumed": [r["peak_memory_bytes"] for r in resumed]},
        "launches_crashed_by_rank": [r["launches"] for r in crashed],
        "launches_resumed_by_rank": [r["launches"] for r in resumed],
    }), flush=True)
    total = [{k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
             for ranks in (crashed, resumed)]
    return total[0], total[1], dense_launches


# phase 6d: GPipe over a ("pod",) mesh of the 4 ranks, a full-width plain
# layer of lram-bert-medium a stage, x (8, 256, 512) in 4 microbatches
PIPE_SHAPE = (8, 256)
PIPE_MICROBATCHES = 4
PIPE_TOL = 1e-5
PIPE_TIMED = 3


def pipeline_rank(rank: int, port: int, results, device_name) -> None:
    """One rank of phase 6d (a spawned process): the 4 layers (drawn alike
    on every rank from one seed) through `pipeline_apply`, this rank the
    stage at its coordinate along ``pod``, against the 4 applied in
    sequence in this process; both timed (the device synchronized).
    Then the backward of sum(out * r) (r drawn from a seed): x's
    gradient and this rank's stage's parameter gradients through the
    pipeline against the same loss on the 4 layers in sequence, each
    timed once after an untimed first call."""
    _rank_env(rank, port)
    device = torch.device(device_name)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method="env://",
                            world_size=MESH_RANKS, rank=rank)
    mesh = context.Mesh((MESH_RANKS,), ("pod",))
    cfg = configs.get_config("lram-bert-medium")
    gen = torch.Generator().manual_seed(11)
    layers = [transformer.Layer(cfg, generator=gen).to(device)
              for _ in range(MESH_RANKS)]
    x = torch.randn(*PIPE_SHAPE, cfg.d_model,
                    generator=torch.Generator().manual_seed(12)).to(device)

    def stage(layer, h):
        positions = torch.arange(h.shape[1], device=h.device).expand(
            h.shape[0], -1)
        return layer.full(h, positions, causal=False)[0]

    def piped():
        return pipeline.pipeline_apply(stage, layers, x, mesh=mesh,
                                       axis="pod",
                                       num_microbatches=PIPE_MICROBATCHES)

    def sequential():
        h = x
        with torch.no_grad():
            for layer in layers:
                h = stage(layer, h)
        return h

    times = {}
    for name, fn in (("pipeline", piped), ("sequential", sequential)):
        got = fn()  # the first call: set-up
        ms = []
        for _ in range(PIPE_TIMED):
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            got = fn()
            _sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        times[name] = (got, ms)
    out, want = times["pipeline"][0], times["sequential"][0]
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(13)
                    ).to(device)
    mine = layers[mesh.index("pod")]

    def grads(piped: bool):
        """(d x, this stage's parameter gradients, ms) of sum(out * r)."""
        for layer in layers:
            layer.zero_grad(set_to_none=True)
        h = x.clone().requires_grad_()
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        if piped:
            y = pipeline.pipeline_apply(stage, layers, h, mesh=mesh,
                                        axis="pod",
                                        num_microbatches=PIPE_MICROBATCHES)
        else:
            y = h
            for layer in layers:
                y = stage(layer, y)
        (y * r).sum().backward()
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        return h.grad, [p.grad.clone() for p in mine.parameters()], ms

    backward = {}
    for piped in (True, False):
        grads(piped)  # the first call: set-up
        backward[piped] = grads(piped)
    (dx, dps, ms), (dx_s, dps_s, ms_s) = backward[True], backward[False]
    errs = [(dx - dx_s).abs().max().item()] + [
        (a - b).abs().max().item() for a, b in zip(dps, dps_s)]
    # atol scaled to each gradient's largest element: the pipeline adds a
    # stage's parameter gradient microbatch by microbatch, the sequential
    # run over the whole batch at once (fp32 sums in another order)
    close = all(torch.allclose(a, b, rtol=PIPE_TOL,
                               atol=PIPE_TOL * b.abs().max().item())
                for a, b in zip([dx, *dps], [dx_s, *dps_s]))
    results.put({
        "rank": rank, "stage": mesh.index("pod"),
        "shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
        "max_abs_err": (out - want).abs().max().item(),
        "close": bool(torch.allclose(out, want, rtol=PIPE_TOL,
                                     atol=PIPE_TOL)),
        "pipeline_ms": times["pipeline"][1],
        "sequential_ms": times["sequential"][1],
        "grad_finite": all(bool(torch.isfinite(t).all())
                           for t in [dx, *dps]),
        "grad_max_abs_err": max(errs), "grad_close": close,
        "grad_max_abs": max(t.abs().max().item() for t in [dx_s, *dps_s]),
        "stage_leaves": len(dps),
        "backward_ms": {"pipeline": ms, "sequential": ms_s}})
    dist.destroy_process_group()


def pipeline_phase(device_name="cuda") -> None:
    """Phase 6d: 4 ranks on a ("pod",) mesh run `pipeline_apply` with 4
    microbatches over 4 full-width plain layers of lram-bert-medium (w =
    512, d_ff 2048), x (8, 256, 512); fails unless every rank's output is
    finite, of x's shape and within 1e-5 (rtol and atol) of the 4 layers
    applied in sequence on one process, and the backward of a loss on
    the output (x's gradient, whole on every rank, and each rank's
    stage's parameter gradients) is finite and within 1e-5 of the
    sequential layers' on one process (rtol, and atol 1e-5 times each
    gradient's largest element: the pipeline adds a parameter's gradient
    a microbatch at a time, fp32 sums in another order)."""
    if device_name == "cuda":
        torch.cuda.empty_cache()
    ranks, wall_s = _spawn_ranks(pipeline_rank, (device_name,),
                                 "pipeline phase")
    for r in ranks:
        check(r["finite"] and r["shape"] == [*PIPE_SHAPE, 512]
              and r["close"],
              f"pipeline rank {r['rank']}: output {r['shape']} differs from "
              f"the sequential layers by {r['max_abs_err']}")
        check(r["grad_finite"] and r["grad_close"]
              and r["stage_leaves"] > 0,
              f"pipeline rank {r['rank']}: the backward's gradients differ "
              f"from the sequential layers' by {r['grad_max_abs_err']}")
    print(json.dumps({
        "pipeline": "GPipe over pod", "stages": MESH_RANKS,
        "microbatches": PIPE_MICROBATCHES, "x": [*PIPE_SHAPE, 512],
        "stage": "lram-bert-medium Layer (w 512, d_ff 2048)",
        "max_abs_err_by_rank": [r["max_abs_err"] for r in ranks],
        "pipeline_ms_by_rank": [r["pipeline_ms"] for r in ranks],
        "sequential_ms_by_rank": [r["sequential_ms"] for r in ranks],
        "backward": "d x and each stage's parameters of sum(out * r)",
        "grad_max_abs_err_by_rank": [r["grad_max_abs_err"] for r in ranks],
        "grad_max_abs": max(r["grad_max_abs"] for r in ranks),
        "forward_backward_ms_by_rank": [r["backward_ms"] for r in ranks],
        "wall_s_incl_spawn": wall_s}), flush=True)


# phase 6e: the dense training with each gradient codec
COMP_STEPS = 10
COMP_ARGS = ["--arch", "lram-bert-medium", "--placement", "pallas",
             "--batch", "8", "--seq", "256", "--steps", str(COMP_STEPS),
             "--json"]


def compression_path(kind: str) -> dict:
    """Phase 6e: lram-bert-medium at full width, `--compression kind`, 10
    steps, launch counts reset just before and read just after; fails
    unless K2, K1 and `lookup_bwd` launched (the backward once a step),
    every loss is finite and the mean of steps 6-10 is below that of
    steps 1-5.  Returns the launch counts."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    argv = COMP_ARGS + ["--compression", kind]
    run, _, _, launches = _cli(train.main, argv)
    who = f"compression {kind}"
    check(len(run.records) == COMP_STEPS, f"{who}: steps missing")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] >= COMP_STEPS,
              f"{who}: {kernel} launched {launches[kernel]} times")
    check(launches["lookup_bwd"] == COMP_STEPS,
          f"{who}: the backward launched {launches['lookup_bwd']} times")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"{who}: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[5:]))
    check(last < first, f"{who}: the loss did not fall ({losses})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    print(json.dumps({
        "train": f"lram-bert-medium --compression {kind}", "argv": argv,
        "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_steps_6_10": last,
        "step_ms": step_ms, "step_ms_median_steps_6_10": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "allocated_before_bytes": allocated_before,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches}), flush=True)
    del run
    return launches


GROW_LOG2 = 21  # 6f and 7d grow the 2^20-row table to 2^21 rows
GROW_ARGS = TRAIN_ARGS + ["--grow-at", f"10:{GROW_LOG2}", "--telemetry"]


def grow_train_path(dense_records):
    """Phase 6f: phase 6's training with `--grow-at 10:21 --telemetry`:
    the 2^20-row table (and Adam's mu / nu) grows to 2^21 rows before
    step 10.  Fails unless the growth is printed, K2, K1 and `lookup_bwd`
    launched (the backward once a step), steps 0-9 are within rtol 1e-4
    of phase 6's, the losses are finite and fall.  Returns the launch
    counts (reset just before, read just after)."""
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    run, _, out, launches = _cli(train.main, GROW_ARGS)
    peak = torch.cuda.max_memory_allocated()
    grows = [json.loads(x) for x in out.splitlines()
             if x.startswith('{"grow"')]
    check(len(grows) == 1 and grows[0]["grow"] == f"2^{GROW_LOG2}"
          and grows[0]["step"] == 10, f"grow: printed {grows}")
    check(run.model.cfg.lram.num_locations == 2**GROW_LOG2
          and all(t.shape[0] == 2**GROW_LOG2
                  for k, t in run.opt_state["mu"].items()
                  if k.endswith("lram.values")),
          "grow: the table or its moments did not grow")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] >= TRAIN_STEPS,
              f"grow: {kernel} launched {launches[kernel]} times")
    check(launches["lookup_bwd"] == TRAIN_STEPS,
          f"grow: the backward kernel launched {launches['lookup_bwd']} "
          f"times in {TRAIN_STEPS} steps")
    losses = [r["loss"] for r in run.records]
    want = [r["loss"] for r in dense_records]
    check(len(losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses),
          f"grow: losses {losses}")
    err = [abs(a - b) / abs(b) for a, b in zip(losses[:10], want[:10])]
    check(max(err) <= 1e-4,
          f"grow: steps 0-9 {losses[:10]} against phase 6's {want[:10]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"grow: the loss did not fall ({first} -> {last})")
    tel = run.telemetry["seg1"]
    counts = tel["counts"].cpu().numpy()
    half = counts.size // 2
    util = [json.loads(x) for x in out.splitlines()
            if '"utilisation_report"' in x]
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[11:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    print(json.dumps({
        "train": f"lram-bert-medium grown to 2^{GROW_LOG2}",
        "argv": GROW_ARGS,
        "grow": grows[0], "grow_pause_s": grows[0]["pause_s"],
        "losses": losses, "rel_err_steps_0_9": max(err),
        "step_10_loss": losses[10], "phase_6_step_10_loss": want[10],
        "step_10_rel_diff": abs(losses[10] - want[10]) / abs(want[10]),
        "loss_mean_steps_1_5": first, "loss_mean_steps_16_20": last,
        "step_ms": step_ms, "step_ms_median_steps_12_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "allocated_before_bytes": allocated_before,
        "peak_memory_bytes": peak,
        "table_and_moments_bytes": 3 * 2**GROW_LOG2 * M * 4,
        "utilisation": util,
        "dead_share_appended_bins": float((counts[half:] == 0).mean()),
        "dead_share_old_bins": float((counts[:half] == 0).mean()),
        "launches": launches,
    }), flush=True)
    del run
    return launches


TIERED_GROW_ARGS = ["--arch", "lram-tiered", "--batch", "8", "--seq", "64",
                    "--steps", "6", "--grow-at", f"2:{GROW_LOG2}",
                    "--ckpt-every", "2", "--json"]


def tiered_grow_resume_path(ckpt_dir):
    """Phase 7d: lram-tiered at full width grows to 2^21 rows before step
    2 (the host tier appends 128 shards), saves at steps 2 and 4, fails
    before step 5 and is relaunched: `catch_up` grows before the restore,
    which resumes from step 4 with the crashed run's step-4 loss bit for
    bit.  Then `serve --grow-to 21 --ckpt-dir` serves the grown
    checkpoint, 8 of 8 requests through K2 + K1.  Returns the three
    runs' launch counts."""
    argv = TIERED_GROW_ARGS + ["--ckpt-dir", ckpt_dir]
    _, crashed, out, crash_launches = _cli(
        train.main, argv + ["--simulate-failure-at", "5"], crash=True)
    check(f'{{"grow": "2^{GROW_LOG2}", "step": 2' in out,
          "tiered grow: no growth printed at step 2")
    run, _, out, resume_launches = _cli(train.main, argv)
    check("resumed from step 4\n" in out and run.start_step == 4,
          "tiered grow: the relaunch did not resume from step 4")
    check(run.records[0]["loss"] == crashed[4]["loss"],
          f"tiered grow: step 4 loss {run.records[0]['loss']} != the "
          f"crashed run's {crashed[4]['loss']}")
    (store,) = run.stores
    host_bytes = store._host.nbytes
    check(store.num_rows == 2**GROW_LOG2
          and host_bytes == 2**GROW_LOG2 * M * 4,
          f"tiered grow: host tier {store.num_rows} rows, {host_bytes} B")
    for name, launches in (("crashed", crash_launches),
                           ("resumed", resume_launches)):
        for kernel in ("lram_query", "gather_interp", "lookup_bwd_rows"):
            check(launches[kernel] > 0, f"tiered grow: {kernel} never "
                                        f"launched in the {name} run")
    train_managers = list(RecordingManager.made)
    serve_argv = ["--arch", "lram-tiered", "--grow-to", str(GROW_LOG2),
                  "--ckpt-dir", ckpt_dir, "--json"] + SERVE_ARGS
    report, _, out, serve_launches = _cli(serve.main, serve_argv)
    check('{"restored_step": 6}' in out.splitlines(),
          "tiered grow serve: did not restore step 6")
    check(len(report.requests) == 8,
          f"tiered grow serve: served {len(report.requests)} of 8")
    for kernel in ("lram_query", "gather_interp"):
        check(serve_launches[kernel] > 0,
              f"tiered grow serve: {kernel} never launched")
    print(json.dumps({
        "resume": f"lram-tiered grown to 2^{GROW_LOG2}", "argv": argv,
        "crashed_losses": [r["loss"] for r in crashed],
        "resumed_losses": [r["loss"] for r in run.records],
        "host_tier_bytes": host_bytes,
        "checkpoints": _history(train_managers),
        "serve_restore": _history(RecordingManager.made[-1:]),
        "serve_tokens_per_sec": report.tokens_per_sec,
        "serve_decode_p50_ms": report.p50_ms(), "serve_cache": report.cache,
        "launches_crashed": crash_launches,
        "launches_resumed": resume_launches,
        "launches_serve": serve_launches,
    }), flush=True)
    del run
    return crash_launches, resume_launches, serve_launches


Q8_CKPT_ARGS = ["--arch", "lram-tiered-q8", "--batch", "8", "--seq", "64",
                "--steps", "6", "--ckpt-every", "3", "--json"]


def tiered_resume_path(ckpt_dir):
    """lram-tiered-q8 at full width saves at step 3, fails before step 4
    and is relaunched: its step-3 loss is the crashed run's bit for bit,
    and every shard it restored (payload, scales) is the saved one.  Then
    `serve --ckpt-dir` restores step 6 and serves 8 requests through K2 +
    B4 from a table equal to the trained one bit for bit.  Returns the
    three runs' launch counts."""
    argv = Q8_CKPT_ARGS + ["--ckpt-dir", ckpt_dir]
    _, crashed, _, crash_launches = _cli(
        train.main, argv + ["--simulate-failure-at", "4"], crash=True)
    run, _, out, resume_launches = _cli(train.main, argv)
    check("resumed from step 3\n" in out and run.start_step == 3,
          "q8 resume: the relaunch did not resume from step 3")
    check(run.records[0]["loss"] == crashed[3]["loss"],
          f"q8 resume: step 3 loss {run.records[0]['loss']} != the crashed "
          f"run's {crashed[3]['loss']}")
    (trained,) = run.stores
    train_managers = list(RecordingManager.made)
    serve_argv = ["--arch", "lram-tiered-q8", "--ckpt-dir", ckpt_dir,
                  "--json"] + SERVE_ARGS
    report, _, out, serve_launches = _cli(serve.main, serve_argv)
    check('{"restored_step": 6}' in out.splitlines(),
          "q8 serve: did not restore step 6")
    check(len(report.requests) == 8,
          f"q8 serve: served {len(report.requests)} of 8 requests")
    for kernel in ("lram_query", "gather_interp_quant"):
        check(serve_launches[kernel] > 0,
              f"q8 serve: {kernel} never launched")
    (served,) = RecordingManager.made[-1].restored_stores
    served.flush()
    check(np.array_equal(served._host, trained._host)
          and np.array_equal(served._host_scale, trained._host_scale),
          "q8 serve: the served table is not the trained one")
    for name, launches in (("crashed", crash_launches),
                           ("resumed", resume_launches)):
        for kernel in ("lram_query", "gather_interp_quant",
                       "lookup_bwd_quant"):
            check(launches[kernel] > 0,
                  f"q8 resume: {kernel} never launched in the {name} run")
    print(json.dumps({
        "resume": "lram-tiered-q8", "argv": argv,
        "crashed_losses": [r["loss"] for r in crashed],
        "resumed_losses": [r["loss"] for r in run.records],
        "checkpoints": _history(train_managers),
        "serve_restore": _history(RecordingManager.made[-1:]),
        "serve_tokens_per_sec": report.tokens_per_sec,
        "serve_decode_p50_ms": report.p50_ms(),
        "launches_crashed": crash_launches,
        "launches_resumed": resume_launches,
        "launches_serve": serve_launches,
    }), flush=True)
    return crash_launches, resume_launches, serve_launches


@contextlib.contextmanager
def checkpoint_dir():
    """A checkpoint directory under the system temp directory, deleted
    afterwards; meanwhile the CLIs make RecordingManagers."""
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    patched = (train.CheckpointManager, serve.CheckpointManager)
    train.CheckpointManager = serve.CheckpointManager = RecordingManager
    RecordingManager.made = []
    try:
        yield root
    finally:
        train.CheckpointManager, serve.CheckpointManager = patched
        RecordingManager.made = []  # their stores' device caches go too
        shutil.rmtree(root, ignore_errors=True)


BF16_PARITY_ARCHS = ("qwen2-1.5b", "mamba2-1.3b", "phi3.5-moe-42b-a6.6b")


@contextlib.contextmanager
def half_smoke_registry(dtype: str):
    """`configs.get_smoke_config` in `dtype` (bfloat16 or float16) with
    the memory FFN (2^16 rows), as the CPU tests build the public archs'
    2-byte train cells (the smoke configs are float32; the CLI has no
    flag for either)."""
    smoke = configs.get_smoke_config
    configs.get_smoke_config = lambda name, **kw: configs.with_lram(
        smoke(name, **{"dtype": dtype, **kw}), 16)
    try:
        yield
    finally:
        configs.get_smoke_config = smoke


def train_parity(arch: str, extra=(), dtype: str = "float32") -> None:
    """A smoke config, 5 steps on the card and on the CPU (plain versions)
    from the same seed's weights and batches: per-step losses and gradient
    norms to rtol 1e-4 (atomics and another summation order; for the
    tiered archs w (x) g rounds differently, which may flip a stochastic
    floor of the int8 write-back now and then).  A 2-byte `dtype`: the
    smoke config in it with the memory FFN (`half_smoke_registry`), each
    value within `bf16_tol` of the CPU's (one rounding of the dtype x
    (layers + 1) x its magnitude: the CPU tests' bound, as they hold
    these cells against the JAX package)."""
    argv = ["--arch", arch, "--smoke", *extra, "--steps", "5", "--batch",
            "4", "--seq", "32", "--seed", "1"]
    half = dtype != "float32"
    with (half_smoke_registry(dtype) if half
          else contextlib.nullcontext()):
        card = train.main(argv + ["--device", "cuda"])
        cpu = train.main(argv + ["--device", "cpu"])
    out = {"parity": f"smoke train card vs CPU: {arch}", "args": list(extra),
           "dtype": card.model.cfg.dtype}
    for key in ("loss", "grad_norm"):
        pairs = [(a[key], b[key]) for a, b in zip(card.records, cpu.records)]
        err = max(abs(a - b) / abs(b) for a, b in pairs)
        tol = (bf16_tol(cpu.model.cfg, torch.tensor(1.0)) if half
               else 1e-4)
        check(len(pairs) == 5 and err <= tol,
              f"{arch} smoke train {key} differs card vs CPU: {pairs}")
        out.update({key: pairs, f"{key}_max_rel_err": err,
                    f"{key}_rel_tol": tol})
    if card.stores:
        out["writebacks"] = [card.stores[0].stats["writebacks"],
                             cpu.stores[0].stats["writebacks"]]
        out["table_max_abs_diff"] = float(np.abs(
            card.stores[0].to_dense() - cpu.stores[0].to_dense()).max())
    print(json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# paths (h) and (n): the public decoders in bfloat16 with the memory FFN
# ---------------------------------------------------------------------------

# path -> (arch, layers kept or None for all, trace arguments); the model is
# `with_lram(get_config(arch), 20)` on the `pallas` placement, its widths as
# published, drawn on the card from --seed 0.  Path (h): the dense
# decoders; path (n): the MoE and SSM families, the MoE archs cut from 32
# layers to 8 (all 32 fit no 80 GB card)
H_PATHS = {
    "h1_yi_9b": ("yi-9b", None, SERVE_ARGS),
    "h2_qwen2_1_5b": ("qwen2-1.5b", None, SERVE_ARGS),
    "h3_starcoder2_3b": ("starcoder2-3b", None, SERVE_ARGS),
    "h4_danube3_4b": ("h2o-danube-3-4b", None, [
        "--batch", "2", "--prompt-len", "8192", "--gen", "32",
        "--requests", "4", "--seed", "0", "--fixed-len"]),
}
N_PATHS = {
    "n1_phi3_5_moe": ("phi3.5-moe-42b-a6.6b", 8, SERVE_ARGS),
    "n2_mixtral_8x7b": ("mixtral-8x7b", 8, SERVE_ARGS),
    "n3_mamba2_1_3b": ("mamba2-1.3b", None, SERVE_ARGS),
    "n3b_mamba2_chunked": ("mamba2-1.3b", None, [
        "--batch", "4", "--prompt-len", "512", "--gen", "32",
        "--requests", "4", "--seed", "0", "--fixed-len", "--warmup"]),
}
SERVE_PATHS = {**H_PATHS, **N_PATHS}
# also served eagerly: tokens and launch counts equal the graph's
EAGER_TWINS = ("h1_yi_9b", "n1_phi3_5_moe", "n3_mamba2_1_3b")
PLAIN_CHUNK = 131072  # queries a plain memory read takes at once


# one rounding of a 2-byte model dtype (its unit roundoff)
ROUNDING = {"bfloat16": 2.0**-8, "float16": 2.0**-11}


def bf16_tol(cfg, ref: torch.Tensor) -> float:
    """The 2-byte tolerance of the CPU tests (tests/test_torch_archs.py,
    tests/test_torch_fp16.py): one rounding of the model's dtype (2^-8
    bfloat16, 2^-11 float16) times (layers + 1) times the largest
    reference logit; float32 logits to 1e-5."""
    if cfg.dtype == "float32":
        return 1e-5
    return ROUNDING[cfg.dtype] * (cfg.num_layers + 1) * float(
        ref.float().abs().max())


def h_config(arch: str, dtype: str | None = None, smoke: bool = False,
             log2: int = LOG2_LOCATIONS, layers: int | None = None):
    """`with_lram(arch)` on the dense `pallas` placement (the kernels),
    `num_layers` cut to `layers` where given (the memory FFN at layer
    num_layers // 2 of those kept).  A hybrid takes no memory FFN (the
    reference allows none inside its units): its config as it is."""
    get = configs.get_smoke_config if smoke else configs.get_config
    cfg = get(arch) if dtype is None else get(arch, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family == "hybrid":
        return cfg
    cfg = configs.with_lram(cfg, log2)
    return dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))


@contextlib.contextmanager
def plain_memory_reads():
    """The dense `pallas` plan's memory read through the kernels' plain
    versions, on the same tensors (the card's): K2's `lram_query_plain`
    and K1's `gather_interp_plain`, a slice of PLAIN_CHUNK queries at a
    time (the plain top-k holds 232 candidates a query).  The port's
    `reference` placement refuses a table on the card, so that no run
    there skips the kernels unseen; this is its function on the card."""
    real = ops.lram_lookup

    def plain(values, q, spec, top_k, return_access=False):
        flat = q.reshape(-1, 8)
        parts = [e8_lookup.lram_query_plain(flat[i:i + PLAIN_CHUNK], spec,
                                            top_k)
                 for i in range(0, flat.shape[0], PLAIN_CHUNK)]
        idx = torch.cat([p[0] for p in parts])
        w = torch.cat([p[1] for p in parts])
        out = torch.cat([gather_interp.gather_interp_plain(
            values, idx[i:i + PLAIN_CHUNK], w[i:i + PLAIN_CHUNK])
            for i in range(0, idx.shape[0], PLAIN_CHUNK)])
        lead = q.shape[:-1]
        out = out.reshape(*lead, -1)
        idx, w = idx.reshape(*lead, top_k), w.reshape(*lead, top_k)
        return (out, (idx, w)) if return_access else out

    ops.lram_lookup = plain
    try:
        yield
    finally:
        ops.lram_lookup = real


@contextlib.contextmanager
def recorded_reads(reads: dict):
    """Record the memory reads the dense `pallas` plan makes, by n (its
    K2 and K1 calls share it): the last eager call's table, spec and
    copies of its queries and of the kernels' indices, weights and
    output.  A call made while a CUDA graph is captured records its n
    alone (its tensors hold nothing yet); a replay makes no call."""
    real = ops.lram_lookup

    def recording(values, q, spec, top_k=TOP_K, return_access=False):
        out, (idx, w) = real(values, q, spec, top_k, return_access=True)
        n = q.numel() // 8
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            reads.setdefault(n, None)
        else:
            reads[n] = (values, spec, q.detach().reshape(n, 8).clone(),
                        idx.reshape(n, top_k).clone(),
                        w.reshape(n, top_k).clone(),
                        out.detach().reshape(n, -1).clone())
        return (out, (idx, w)) if return_access else out

    ops.lram_lookup = recording
    try:
        yield
    finally:
        ops.lram_lookup = real


def check_reads(name: str, reads: dict) -> dict:
    """Hold every recorded memory read against the kernels' plain versions
    on its own inputs, PLAIN_CHUNK queries at a time: K2's indices and
    weights bit for bit, K1's output to rtol 2e-5 / atol 1e-6 (the kernel
    phase's bounds).  Returns K1's largest error by n."""
    errs = {}
    for n, rec in sorted(reads.items()):
        check(rec is not None, f"{name}: no eager memory read at n={n}")
        values, spec, q, idx, w, out = rec
        values, top_k, err = values.detach(), idx.shape[1], 0.0
        for i in range(0, n, PLAIN_CHUNK):
            part = slice(i, i + PLAIN_CHUNK)
            idx_p, w_p = e8_lookup.lram_query_plain(q[part], spec, top_k)
            check(torch.equal(idx[part], idx_p)
                  and torch.equal(w[part], w_p),
                  f"{name}: K2 differs from its plain version on the "
                  f"path's queries at n={n} (rows {i}+)")
            want = gather_interp.gather_interp_plain(values, idx[part],
                                                     w[part])
            err = max(err, (out[part] - want).abs().max().item())
            check(torch.allclose(out[part], want, rtol=2e-5, atol=1e-6),
                  f"{name}: K1 differs from its plain version by {err} on "
                  f"the path's queries at n={n}")
        errs[n] = err
    return errs


@contextlib.contextmanager
def attn_impl(model, impl: str):
    """Every attention layer of `model` on `attn_impl=impl` (the same
    weights), restored afterwards."""
    layers = [m for m in model.modules()
              if isinstance(m, attention.Attention)]
    old = [m.cfg for m in layers]
    for m in layers:
        m.cfg = dataclasses.replace(m.cfg, attn_impl=impl)
    try:
        yield
    finally:
        for m, cfg in zip(layers, old):
            m.cfg = cfg


@contextlib.contextmanager
def recorded_ticks(ticks: list, from_pos: int):
    """Each decode tick's (positions, tokens fed, logits) once a slot
    reaches `from_pos`, on the host."""
    decode = ServeEngine._decode

    def recording(engine, tok_buf, pos_buf):
        logits, next_tok = decode(engine, tok_buf, pos_buf)
        if pos_buf.max() >= from_pos:
            ticks.append((pos_buf.copy(), tok_buf.copy(),
                          logits[:, -1].float().cpu()))
        return logits, next_tok

    ServeEngine._decode = recording
    try:
        yield
    finally:
        ServeEngine._decode = decode


def h_engine_run(model, args, trace, cuda_graph: bool = True):
    """The trace through a warmed engine (warm-up over the trace's prompt
    lengths, then the capture), launch counts reset after the warm-up and
    read after the run.  Returns (report, launches, the memory reads by n
    (`recorded_reads`, warm-up and capture included), warm-up s, the
    engine)."""
    engine = ServeEngine(model, EngineConfig(
        slots=args.batch, max_len=args.prompt_len + args.gen,
        cuda_graph=cuda_graph))
    finite, reads = [], {}
    with recorded_reads(reads):
        t0 = time.perf_counter()
        engine.warmup([r.prompt_len for r in trace])
        warm_s = time.perf_counter() - t0
        reset_counts()
        with checked_ticks(finite):
            report = engine.run(trace)
            _sync(engine.device)
    launches = read_counts()
    check(bool(torch.stack(finite).all()),
          f"{model.cfg.name}: non-finite logits")
    return report, launches, reads, warm_s, engine


def tick_busy_share(engine, args, ticks: int = 10) -> dict:
    """The decode tick's busy share: its kernels' device time (torch.
    profiler over `ticks` ticks) over its wall time (the same ticks timed
    without the profiler; each tick ends in the host's read of the next
    tokens).  Graph replays where the engine holds a graph."""
    b = args.batch
    tok = np.zeros((b, 1), np.int64)
    pos = np.full((b,), args.prompt_len, np.int64)
    engine._decode(tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine._decode(tok, pos)
    wall_ms = 1e3 * (time.perf_counter() - t0) / ticks
    _, per_kernel, _ = profile(
        lambda: [engine._decode(tok, pos) for _ in range(ticks)])
    kernels = {k: v for k, v in per_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    busy_ms = sum(kernels.values()) / 1e3 / ticks
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"tick_kernel_ms": busy_ms, "tick_wall_ms": wall_ms,
            "tick_busy_share": busy_ms / wall_ms,
            "tick_top_kernels_ms": [[k[:80], v / 1e3 / ticks]
                                    for k, v in top]}



def moe_blocks(cfg) -> int:
    """The MoE blocks one forward runs (the memory FFN's layer runs none)."""
    if not cfg.num_experts:
        return 0
    return sum(seg[1] for seg in transformer.layer_plan(cfg)
               if seg[0] == "run")


@contextlib.contextmanager
def recorded_routes(prefills: list, ticks: list | None = None,
                    drops: list | None = None):
    """Every MoE block's routing, block by block in call order: a batch-1
    call's (a prefill's) (expert ids, probabilities, router logits) on the
    host into `prefills` and the token copies its capacity dropped into
    `drops`; a decode tick's (every slot's) expert ids, on the device,
    into `ticks`.  For untimed runs only: the router runs twice and the
    host waits for each prefill's block."""
    route, dispatch = moe.route, moe.dispatch

    def recording(m, x):
        routed = route(m, x)
        if x.shape[0] == 1:
            logits = m.router(x).float()
            prefills.append(tuple(t.detach().cpu().numpy() for t in (
                routed[2], routed[0], logits)))
        elif ticks is not None:
            ticks.append(routed[2].clone())
        return routed

    def counting(cfg, expert_ids):
        slot, keep = dispatch(cfg, expert_ids)
        if expert_ids.shape[0] == 1 and drops is not None:
            drops.append(int((~keep).sum()))
        return slot, keep

    moe.route, moe.dispatch = recording, counting
    try:
        yield
    finally:
        moe.route, moe.dispatch = route, dispatch


def routing_excused(name: str, k: int, ref, got, s: int) -> list[dict]:
    """The routing rule of the CPU tests (tests/_families.py), one
    prefill of a batch-1 prompt of `s` real tokens: each MoE block's
    top-k experts in `got` against `ref` (its (ids, probs, logits) the
    margin's); a position where they differ is allowed only where the
    k-th probability less the (k+1)-th is below what one bf16 rounding
    of the two logits can move it, 2^-8 (p_k |l_k| + p_k+1 |l_k+1|).
    Returns the allowed differences (block, position, margin, bound)."""
    check(len(ref) == len(got), f"{name}: {len(ref)} and {len(got)} MoE "
          f"blocks routed")
    found = []
    for block, ((ids, probs, logits), (got_ids, _, _)) in enumerate(
            zip(ref, got)):
        order = np.argsort(-probs, axis=-1, kind="stable")
        p = np.take_along_axis(probs, order, -1)[0]
        lg = np.take_along_axis(logits, order, -1)[0]
        margin = p[:, k - 1] - p[:, k]
        bound = 2.0**-8 * (p[:, k - 1] * np.abs(lg[:, k - 1])
                           + p[:, k] * np.abs(lg[:, k]))
        for pos in np.flatnonzero((ids[0] != got_ids[0]).any(-1)):
            check(margin[pos] < bound[pos],
                  f"{name}: MoE block {block} routes position {pos} "
                  f"differently at a margin of {margin[pos]:.3e} (one bf16 "
                  f"rounding moves {bound[pos]:.3e})")
            found.append({"block": block, "position": int(pos),
                          "margin": float(margin[pos]),
                          "bound": float(bound[pos]),
                          "before_first_logits": bool(pos < s)})
    return found


def moe_routes_run(name: str, model, args, trace, report):
    """The trace served again, eagerly and untimed, with every MoE block's
    routing recorded (`recorded_routes`).  Every request arrives at 0, so
    the ticks hold the timed run's slots; its tokens and first logits must
    equal the timed run's, so the routes are that run's.  Returns (each
    request's prefill routes, block by block; each decode tick's experts
    routed to, summed over its blocks (every slot's, idle ones too: the
    tick computes them); the copies each block's capacity dropped in the
    prefills)."""
    n = moe_blocks(model.cfg)
    engine = ServeEngine(model, EngineConfig(
        slots=args.batch, max_len=args.prompt_len + args.gen,
        cuda_graph=False))
    prefills, ticks, drops = [], [], []
    with recorded_routes(prefills, ticks, drops):
        again = engine.run(trace)
    check(len(again.requests) == len(report.requests)
          and all(a.tokens == b.tokens
                  and np.array_equal(a.first_logits, b.first_logits)
                  for a, b in zip(report.requests, again.requests)),
          f"{name}: the recorded eager run's tokens or first logits differ "
          f"from the timed run's")
    check(len(prefills) == n * len(trace) and len(ticks) % n == 0,
          f"{name}: {len(prefills)} prefill and {len(ticks)} tick routings "
          f"for {n} MoE blocks")
    per_tick = torch.stack(ticks).reshape(len(ticks) // n, n, -1).cpu()
    experts = [sum(len(torch.unique(b)) for b in t) for t in per_tick]
    return ([prefills[i * n:(i + 1) * n] for i in range(len(trace))],
            experts, [sum(drops[b::n]) for b in range(n)])


@contextlib.contextmanager
def sequential_scan():
    """Every SSD scan of the Mamba layers through `ssd_sequential`, the
    recurrence step by step, on the same inputs."""
    chunked = mamba2.ssd_chunked

    def sequential(x, B, C, dt, A, *, chunk, h0=None):
        return mamba2.ssd_sequential(x, B, C, dt, A, h0=h0)

    mamba2.ssd_chunked = sequential
    try:
        yield
    finally:
        mamba2.ssd_chunked = chunked


def tick_read_bytes(model, cfg, args, experts_read=None) -> float:
    """The bytes a decode tick of `args.batch` slots must move: every
    weight but the embedding (the tick reads one row a slot), a learned
    position table (one row), the encoder (an enc-dec decode reads its
    cached ck / cv instead) and the memory table (its K1 reads 32 rows a
    head and slot); a hybrid's shared block once a call (its ~157 MB do
    not stay in the 50 MB L2 from one call to the next); the caches up
    to the trace's end, an SSM's float32 state and conv window read and
    written.  Of an MoE's experts, the `experts_read` the tick routed
    to, summed over its blocks; None: every expert of every block, which
    is what the batched expert products read (a decode's capacity of 1
    gives each expert a buffer row)."""
    def nbytes(ps):
        return sum(p.numel() * p.element_size() for p in ps)

    tables = {id(m.values) for m in model.modules() if isinstance(m, LRAM)}
    experts = [p for m in model.modules() if isinstance(m, moe.Experts)
               for p in m.parameters()]
    skip = tables | {id(p) for p in experts} | {id(model.embed.embedding)}
    skip |= {id(p) for p in (model.pos_embed, model.enc_pos_embed)
             if p is not None}
    if model.encoder is not None:
        skip |= {id(p) for p in model.encoder.parameters()}
    weights = nbytes(p for p in model.parameters() if id(p) not in skip)
    if model.shared_attn is not None:  # once more a call after the first
        calls = cfg.num_layers // cfg.hybrid_pattern
        weights += (calls - 1) * nbytes(model.shared_attn.parameters())
    if experts:
        share = (1.0 if experts_read is None else
                 experts_read / (cfg.num_experts * moe_blocks(cfg)))
        weights += share * nbytes(experts)
    rows = (0 if cfg.lram is None
            else args.batch * cfg.lram.heads * TOP_K * cfg.lram.m
            * cfg.lram.torch_table_dtype.itemsize)
    cache = sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
                * (2 if leaf in ("ssm", "conv") else 1)
                for leaves in transformer.cache_shapes(
                    cfg, args.batch, args.prompt_len + args.gen).values()
                for leaf, (shape, dt) in leaves.items())
    return weights + rows + cache


def window_checks(model, cfg, trace, report, ticks, last_pos, args) -> dict:
    """h4: the chunked prefill of one prompt against `attn_impl="dense"`,
    and request 0's last decode tick (past the window: the ring has
    wrapped) against a full forward of its prompt and generated tokens."""
    out = {}
    with torch.inference_mode():
        toks = torch.from_numpy(trace[0].prompt[None]).long().cuda()
        chunked = transformer.forward(model, {"tokens": toks})
        with attn_impl(model, "dense"):
            dense = transformer.forward(model, {"tokens": toks})
        err = float((chunked.float() - dense.float()).abs().max())
        check(err <= bf16_tol(cfg, dense),
              f"h4: the chunked prefill differs from the dense one by {err}")
        out["chunked_vs_dense_prefill_max_abs_err"] = err
        out["chunked_vs_dense_bf16_tol"] = bf16_tol(cfg, dense)
        del chunked, dense
        # request 0's last tick (slot 0, first wave) against a full
        # forward of its prompt and the tokens it was fed
        first = report.requests[0]
        tick = next(t for t in ticks if t[0][0] == last_pos)
        check(int(tick[1][0, 0]) == first.tokens[-2],
              f"h4: slot 0's last tick fed {int(tick[1][0, 0])}, not "
              f"request 0's token {first.tokens[-2]}")
        seq = torch.from_numpy(np.concatenate(
            [trace[0].prompt, first.tokens[:-1]])[None]).long().cuda()
        full = transformer.forward(model, {"tokens": seq})[0, -1]
        err = float((tick[2][0].to(full.device) - full.float()).abs().max())
        check(err <= bf16_tol(cfg, full),
              f"h4: the last decode tick differs from the full forward by "
              f"{err}")
        out["last_tick_vs_forward_max_abs_err"] = err
        out["last_tick_position"] = last_pos
        out["ring_slots"] = transformer.cache_shapes(
            cfg, 1, args.prompt_len + args.gen)["seg0"]["k"][0][2]
    return out


def chunked_scan_check(model, cfg, trace) -> dict:
    """n3b: one prompt's chunked prefill against `ssd_sequential`."""
    s = trace[0].prompt_len
    check(s % cfg.ssm_chunk == 0, f"n3b: a {s}-token prompt does not take "
          f"the chunked scan")
    with torch.inference_mode():
        toks = torch.from_numpy(trace[0].prompt[None]).long().cuda()
        chunked = transformer.forward(model, {"tokens": toks})
        with sequential_scan():
            sequential = transformer.forward(model, {"tokens": toks})
    err = float((chunked.float() - sequential.float()).abs().max())
    check(err <= bf16_tol(cfg, sequential),
          f"n3b: the chunked prefill differs from the sequential scan by "
          f"{err}")
    return {"chunked_vs_sequential_max_abs_err": err,
            "chunked_vs_sequential_bf16_tol": bf16_tol(cfg, sequential),
            "chunks": s // cfg.ssm_chunk}


def public_path(name: str):
    """Paths (h) and (n): one public arch at full width (bfloat16, its
    memory FFN at layer num_layers // 2 on a 2^20 x 64 fp32 table,
    `pallas`), weights drawn on the card, served through `ServeEngine`
    over the path's trace (warm-up, the decode tick one CUDA graph).
    Fails unless K2 and K1 launched (counts reset just before the timed
    run, read just after), every request finished with finite logits, the
    path's own memory reads agree with the plain versions, and every
    request's first logits match a prefill of its prompt (padded as the
    engine pads it) with the kernels' plain versions (`plain_memory_
    reads`) on the same weights within `bf16_tol`, under the routing rule
    for an MoE (`routing_excused`, on the routes of `moe_routes_run`).
    EAGER_TWINS also serve eagerly: tokens and launch counts equal the
    graph's.  h4 adds `window_checks`, n3b `chunked_scan_check`.  Prints
    the tick's read bound (an MoE's on the experts its ticks routed to,
    and on every expert) and an MoE's capacity drops in the prefills, per
    block.  Returns the launch counts."""
    arch, layers, trace_args = SERVE_PATHS[name]
    args = serve.build_argparser().parse_args(["--arch", arch]
                                              + trace_args)
    cfg = h_config(arch, layers=layers)
    started = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=args.seed, device="cuda").eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trace = synthetic_trace(np.random.default_rng(args.seed), args.requests,
                            vocab_size=cfg.vocab_size,
                            max_prompt=args.prompt_len, max_gen=args.gen,
                            mixed=not args.fixed_len)
    last_pos = args.prompt_len + args.gen - 2  # request 0's last tick
    ticks = []
    with (recorded_ticks(ticks, last_pos) if name == "h4_danube3_4b"
          else contextlib.nullcontext()):
        report, launches, reads, warm_s, engine = h_engine_run(
            model, args, trace)
    peak = torch.cuda.max_memory_allocated()
    check(len(report.requests) == args.requests,
          f"{name}: served {len(report.requests)} of {args.requests} "
          f"requests")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    check(report.cuda_graph and report.graph_captures == 1
          and report.graph_ticks == len(report.step_s),
          f"{name}: cuda_graph {report.cuda_graph}, "
          f"{report.graph_captures} captures")
    out = {"serve": name, "arch": arch, "config": cfg.name,
           "argv": trace_args, "layers": cfg.num_layers,
           "published_layers": configs.get_config(arch).num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "memory_layer": cfg.lram_layers[0],
           "memory_heads": cfg.lram.heads, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "init_s": init_s, "warmup_s": warm_s,
           "requests": len(report.requests),
           "generated_tokens": report.generated_tokens,
           "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
           "tokens_per_sec": report.tokens_per_sec,
           "prefill_median_ms": 1e3 * float(np.median(report.prefill_s)),
           "decode_ticks": len(report.step_s), "wall_s": report.wall_s,
           "peak_memory_bytes": peak,
           "launches": {k: v for k, v in launches.items() if v},
           "memory_read_n": sorted(reads),
           # the copies `recorded_reads` held, inside the peak
           "recorded_read_bytes": sum(
               sum(t.numel() * t.element_size() for t in rec[2:])
               for rec in reads.values() if rec is not None)}
    if cfg.family == "ssm":
        out["ssm_heads_state_headdim"] = [cfg.ssm_heads, cfg.ssm_state,
                                          cfg.ssm_headdim]
    out.update(tick_busy_share(engine, args))
    out["k1_vs_plain_on_path_reads_max_abs_err"] = check_reads(name, reads)
    del reads

    n_moe = moe_blocks(cfg)
    routes = [[] for _ in trace]
    read_bytes = tick_read_bytes(model, cfg, args)
    if n_moe:
        routes, experts, drops = moe_routes_run(name, model, args, trace,
                                                report)
        out["experts_top_k_d_ff"] = [cfg.num_experts, cfg.top_k_experts,
                                     cfg.d_ff]
        out["tick_experts_routed_mean_min_max"] = [
            float(np.mean(experts)), min(experts), max(experts)]
        out["tick_read_bound_all_experts_ms"] = 1e3 * read_bytes \
            / HBM_BYTES_PER_S
        read_bytes = tick_read_bytes(model, cfg, args,
                                     float(np.mean(experts)))
        out["capacity_dropped_copies_by_block"] = drops
        out["prefill_copies"] = sum(
            engine.prefill_len(r.prompt_len) * cfg.top_k_experts
            for r in trace) * n_moe
    out["tick_read_bytes"] = read_bytes
    out["tick_read_bound_ms"] = 1e3 * read_bytes / HBM_BYTES_PER_S

    # the kernels against their plain versions, request by request, on
    # the tokens the engine prefilled (padded to `prefill_len`)
    errs, excused = [], []
    with torch.inference_mode():
        for req, done, got_routes in zip(trace, report.requests, routes):
            s = req.prompt_len
            toks = np.zeros((1, engine.prefill_len(s)), np.int64)
            toks[0, :s] = req.prompt
            plain_routes = []
            with plain_memory_reads(), recorded_routes(plain_routes):
                reset_counts()
                logits, _ = transformer.prefill(
                    model, torch.from_numpy(toks).cuda(),
                    engine.engine_cfg.max_len)
                check(not any(read_counts().values()),
                      f"{name}: a kernel launched in the plain prefill")
            found = (routing_excused(name, cfg.top_k_experts, plain_routes,
                                     got_routes, s) if n_moe else [])
            want = logits[0, s - 1].float()
            got = torch.from_numpy(done.first_logits).to(want.device)
            err = float((got - want).abs().max())
            if any(f["before_first_logits"] for f in found):
                excused.append({"request": req.id, "error": err,
                                "routing": found})
            else:
                check(err <= bf16_tol(cfg, want),
                      f"{name}: request {req.id}'s first logits differ from "
                      f"the plain memory read's by {err}")
                errs.append(err)
            del logits
    out["kernel_vs_plain_first_logits_max_abs_err"] = max(errs, default=None)
    out["bf16_tol_of_first"] = bf16_tol(cfg, want)
    if n_moe:
        out["routing_excused"] = excused

    if name in EAGER_TWINS:  # the decode tick with and without its graph
        del engine
        eager, eager_launches, reads, _, engine = h_engine_run(
            model, args, trace, cuda_graph=False)
        out["eager_k1_vs_plain_on_path_reads_max_abs_err"] = check_reads(
            f"{name} eager", reads)
        del reads
        check(not eager.cuda_graph and eager.graph_captures == 0,
              f"{name}: the eager twin captured a graph")
        check(len(eager.requests) == len(report.requests),
              f"{name}: graph vs eager: requests lost")
        for a, b in zip(report.requests, eager.requests):
            check(a.tokens == b.tokens,
                  f"{name}: graph vs eager: request {a.id} tokens differ")
        for kernel in ("lram_query", "gather_interp"):
            check(eager_launches[kernel] == launches[kernel],
                  f"{name}: graph vs eager: {kernel} launched "
                  f"{launches[kernel]} and {eager_launches[kernel]} times")
        out["eager"] = {"decode_p50_ms": eager.p50_ms(),
                        "decode_p99_ms": eager.p99_ms(),
                        "tokens_per_sec": eager.tokens_per_sec,
                        "launches": {k: v for k, v in eager_launches.items()
                                     if v}}
    if name == "h4_danube3_4b":
        out.update(window_checks(model, cfg, trace, report, ticks, last_pos,
                                 args))
    if name == "n3b_mamba2_chunked":
        out.update(chunked_scan_check(model, cfg, trace))
    out["path_s"] = time.perf_counter() - started
    print(json.dumps(out), flush=True)
    del engine, model, report
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# path (o): the hybrid, enc-dec and VLM families
# ---------------------------------------------------------------------------

O1_ARCH = "zamba2-2.7b"
# path -> (arch, layers kept or None for all, prompt tokens); the model is
# `with_lram(get_config(arch), 20)` on `pallas`, its widths as published,
# drawn on the card from seed 0; qwen2-vl cut from 80 layers to 8 (80 of
# ~1.76 GB fit no 80 GB card)
O_PATHS = {
    "o2_whisper_small": ("whisper-small", None, 64),
    "o3_qwen2_vl_72b": ("qwen2-vl-72b", 8, 512),
}
O_SEQS, O_DECODE_STEPS = 4, 32


def o1_hybrid_path():
    """(o1): zamba2-2.7b whole (54 Mamba layers, the shared attention +
    MLP block called after every 6: 9 calls), bfloat16, weights drawn on
    the card from seed 0, no memory layer (the reference allows none in a
    hybrid), served through `ServeEngine` on SERVE_ARGS (warm-up, the
    decode tick one CUDA graph, exact-length prefills) and again eagerly:
    tokens equal.  Fails unless 8 of 8 requests finished with finite
    logits, no kernel of the port launched (neither K2 nor K1: the path
    runs none), the graph served every tick from one capture, and every
    request's first logits match an eager prefill of its prompt within
    `bf16_tol`.  Prints the tick p50 / p99 against its read bound (the
    shared block's weights once a call).  Returns the launch counts."""
    args = serve.build_argparser().parse_args(["--arch", O1_ARCH]
                                              + SERVE_ARGS)
    cfg = h_config(O1_ARCH)
    name = "o1_zamba2_2_7b"
    started = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=args.seed, device="cuda").eval()
    device = model.embed.embedding.device
    _sync(device)
    init_s = time.perf_counter() - t0
    trace = synthetic_trace(np.random.default_rng(args.seed), args.requests,
                            vocab_size=cfg.vocab_size,
                            max_prompt=args.prompt_len, max_gen=args.gen,
                            mixed=not args.fixed_len)
    report, launches, reads, warm_s, engine = h_engine_run(model, args,
                                                           trace)
    peak = torch.cuda.max_memory_allocated()
    check(len(report.requests) == args.requests,
          f"{name}: served {len(report.requests)} of {args.requests} "
          f"requests")
    check(not any(launches.values()) and not reads,
          f"{name}: a kernel of the port launched: "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(report.cuda_graph and report.graph_captures == 1
          and report.graph_ticks == len(report.step_s),
          f"{name}: cuda_graph {report.cuda_graph}, "
          f"{report.graph_captures} captures")
    read_bytes = tick_read_bytes(model, cfg, args)
    out = {"serve": name, "arch": O1_ARCH, "config": cfg.name,
           "argv": SERVE_ARGS, "layers": cfg.num_layers,
           "published_layers": configs.get_config(O1_ARCH).num_layers,
           "hybrid_pattern": cfg.hybrid_pattern,
           "shared_block_calls": cfg.num_layers // cfg.hybrid_pattern,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "ssm_heads_state_headdim": [cfg.ssm_heads, cfg.ssm_state,
                                       cfg.ssm_headdim],
           "dtype": cfg.dtype, "memory_layer": None,
           "params": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "shared_block_bytes": sum(
               p.numel() * p.element_size()
               for p in model.shared_attn.parameters()),
           "init_s": init_s, "warmup_s": warm_s,
           "requests": len(report.requests),
           "generated_tokens": report.generated_tokens,
           "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
           "tokens_per_sec": report.tokens_per_sec,
           "prefill_median_ms": 1e3 * float(np.median(report.prefill_s)),
           "decode_ticks": len(report.step_s), "wall_s": report.wall_s,
           "peak_memory_bytes": peak,
           "k2_k1_launches": [launches["lram_query"],
                              launches["gather_interp"]],
           "tick_read_bytes": read_bytes,
           "tick_read_bound_ms": 1e3 * read_bytes / HBM_BYTES_PER_S}
    out.update(tick_busy_share(engine, args))
    errs = []
    with torch.inference_mode():
        for req, done in zip(trace, report.requests):
            logits, _ = transformer.prefill(
                model, torch.from_numpy(req.prompt[None]).long().to(device),
                engine.engine_cfg.max_len)
            want = logits[0, -1].float()
            got = torch.from_numpy(done.first_logits).to(want.device)
            err = float((got - want).abs().max())
            check(err <= bf16_tol(cfg, want),
                  f"{name}: request {req.id}'s first logits differ from an "
                  f"eager prefill's by {err}")
            errs.append(err)
    out["first_logits_vs_eager_prefill_max_abs_err"] = max(errs)
    out["bf16_tol_of_first"] = bf16_tol(cfg, want)
    del engine
    eager, eager_launches, _, _, engine = h_engine_run(model, args, trace,
                                                       cuda_graph=False)
    check(not eager.cuda_graph and eager.graph_captures == 0,
          f"{name}: the eager twin captured a graph")
    check(len(eager.requests) == len(report.requests)
          and all(a.tokens == b.tokens
                  for a, b in zip(report.requests, eager.requests)),
          f"{name}: graph vs eager: tokens differ")
    check(not any(eager_launches.values()),
          f"{name}: a kernel launched in the eager twin")
    out["eager"] = {"decode_p50_ms": eager.p50_ms(),
                    "decode_p99_ms": eager.p99_ms(),
                    "tokens_per_sec": eager.tokens_per_sec,
                    "tokens_equal_graph": True}
    out["path_s"] = time.perf_counter() - started
    print(json.dumps(out), flush=True)
    del engine, model, report, eager
    torch.cuda.empty_cache()
    return launches


def vision_positions(grid: int, s: int, b: int, device=None) -> torch.Tensor:
    """M-RoPE positions (3, b, s) of one frame of grid x grid patches
    then text: patch i at (t, h, w) = (0, i // grid, i % grid), text
    token j at grid + j on every stream (continuing from the grid's
    largest position, grid - 1)."""
    pos = torch.empty((3, s), dtype=torch.long)
    patch = torch.arange(grid * grid)
    pos[0, :grid * grid] = 0
    pos[1, :grid * grid] = patch // grid
    pos[2, :grid * grid] = patch % grid
    pos[:, grid * grid:] = grid + torch.arange(s - grid * grid)
    return pos[:, None].expand(3, b, s).contiguous().to(device)


def family_inputs(cfg, b: int, s: int, device, seed: int = 0) -> dict:
    """A batch of `b` prompts of `s` tokens and the family's extras,
    drawn from `seed` on the CPU (the same on every device): an enc-dec
    model's `encoder_embeds` (b, encoder_len, d), a VLM's
    `vision_embeds` (b, vision_tokens, d) on one square frame of patches
    and their M-RoPE `positions` (`vision_positions`); unit-scale
    embeddings, the token embedding's own scale."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = torch.randn(
            b, cfg.encoder_len, cfg.d_model, generator=gen).to(
                cfg.torch_dtype)
    if cfg.family == "vlm":
        grid = math.isqrt(cfg.vision_tokens)
        check(grid * grid == cfg.vision_tokens and s > cfg.vision_tokens,
              f"{cfg.name}: {cfg.vision_tokens} vision tokens are no square "
              f"frame inside a {s}-token prompt")
        batch["vision_embeds"] = torch.randn(
            b, cfg.vision_tokens, cfg.d_model, generator=gen).to(
                cfg.torch_dtype)
        batch["positions"] = vision_positions(grid, s, b)
    return {k: v.to(device) for k, v in batch.items()}


def extras(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "tokens"}


def greedy_decode(model, batch: dict, steps: int, max_len: int,
                  times: list | None = None):
    """`transformer.prefill` of the batch, then `steps` greedy
    `decode_step`s at positions s, s + 1, ... (the cache slots; M-RoPE
    turns every stream by them, as the reference's decode does).
    Returns (prefill logits, [each step's logits (B, V), float32], the
    tokens fed (B, steps)).  With `times` each step's seconds (host
    clock, synchronised) are appended."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    logits, cache = transformer.prefill(model, tokens, max_len,
                                        **extras(batch))
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    fed, out = [], []
    for t in range(steps):
        pos = torch.full((b,), s + t, dtype=torch.long, device=tokens.device)
        if times is not None:
            _sync(tokens.device)
            t0 = time.perf_counter()
        step = transformer.decode_step(model, tok, pos, cache)
        fed.append(tok)
        tok = torch.argmax(step[:, -1], dim=-1)[:, None]
        if times is not None:
            _sync(tokens.device)
            times.append(time.perf_counter() - t0)
        out.append(step[:, -1].float())
    return logits, out, torch.cat(fed, dim=1)


def full_forward_of(model, batch: dict, fed: torch.Tensor):
    """The full forward over prompt + the tokens decode fed, at the
    positions decode used (M-RoPE: the prompt's, then the slot indices
    on every stream); logits at the fed tokens (B, steps, V)."""
    s = batch["tokens"].shape[1]
    seq = dict(batch, tokens=torch.cat([batch["tokens"], fed], dim=1))
    if "positions" in batch:
        b, n = fed.shape
        more = torch.arange(s, s + n, device=fed.device).expand(3, b, n)
        seq["positions"] = torch.cat([batch["positions"], more], dim=2)
    return transformer.forward(model, seq)[:, s:]


def o_decoder_path(name: str):
    """(o2) whisper-small (encoder 12 layers over 1,500 frames, decoder
    12, the memory FFN at decoder layer 6, 48 heads) and (o3)
    qwen2-vl-72b cut to 8 of 80 layers (the memory FFN at layer 4, 512
    heads; 256 vision embeddings on a 16 x 16 frame, M-RoPE): bfloat16,
    `with_lram(cfg, 20)` on `pallas`, weights drawn on the card from
    seed 0, inputs from `family_inputs`.  The serve engine refuses both
    families (as the reference's), so the path is the transformer's:
    O_SEQS prompts through `transformer.prefill`, then O_DECODE_STEPS
    greedy `decode_step`s (after one untimed prefill and step).  Fails
    unless K2 and K1 launched (counts reset just before the timed
    prefill, read after the last step), the logits are finite, the
    path's own memory reads agree with the plain versions
    (`check_reads`), the first logits match a prefill through the
    kernels' plain versions (`plain_memory_reads`) and every decoded
    step's logits a full forward over the generated sequence, both
    within `bf16_tol`.  Returns the launch counts."""
    arch, layers, prompt = O_PATHS[name]
    cfg = h_config(arch, layers=layers)
    started = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init(cfg, seed=0, device="cuda").eval()
    device = model.embed.embedding.device
    _sync(device)
    init_s = time.perf_counter() - t0
    batch = family_inputs(cfg, O_SEQS, prompt, device)
    max_len = prompt + O_DECODE_STEPS
    reads, times = {}, []
    with torch.inference_mode(), recorded_reads(reads):
        greedy_decode(model, batch, 1, max_len)  # untimed first calls
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        logits, _ = transformer.prefill(model, batch["tokens"], max_len,
                                        **extras(batch))
        _sync(device)
        prefill_s = time.perf_counter() - t0
        del logits
        logits, steps, fed = greedy_decode(model, batch, O_DECODE_STEPS,
                                           max_len, times)
        _sync(device)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    first = logits[:, -1].float()
    check(bool(torch.isfinite(first).all())
          and all(bool(torch.isfinite(x).all()) for x in steps),
          f"{name}: non-finite logits")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    args = argparse.Namespace(batch=O_SEQS, prompt_len=prompt,
                              gen=O_DECODE_STEPS)
    read_bytes = tick_read_bytes(model, cfg, args)
    out = {"path": name, "arch": arch, "config": cfg.name,
           "layers": cfg.num_layers,
           "published_layers": configs.get_config(arch).num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "memory_layer": cfg.lram_layers[0],
           "memory_heads": cfg.lram.heads, "dtype": cfg.dtype,
           "sequences": O_SEQS, "prompt_tokens": prompt,
           "decode_steps": O_DECODE_STEPS,
           "params": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "init_s": init_s, "prefill_ms": 1e3 * prefill_s,
           "decode_p50_ms": 1e3 * float(np.percentile(times, 50)),
           "decode_p99_ms": 1e3 * float(np.percentile(times, 99)),
           "decode_step_ms": [1e3 * t for t in times],
           "peak_memory_bytes": peak,
           "launches": {k: v for k, v in launches.items() if v},
           "memory_read_n": sorted(reads),
           "decode_read_bytes": read_bytes,
           "decode_read_bound_ms": 1e3 * read_bytes / HBM_BYTES_PER_S}
    if cfg.family == "encdec":
        out["encoder_layers_frames"] = [cfg.encoder_layers,
                                        cfg.encoder_len]
    if cfg.family == "vlm":
        out["vision_tokens_grid"] = [cfg.vision_tokens,
                                     math.isqrt(cfg.vision_tokens)]
        out["mrope_sections"] = list(cfg.mrope_sections)
    out["k1_vs_plain_on_path_reads_max_abs_err"] = check_reads(name, reads)
    del reads
    with torch.inference_mode():
        with plain_memory_reads():
            reset_counts()
            plain, _ = transformer.prefill(model, batch["tokens"], max_len,
                                           **extras(batch))
            check(not any(read_counts().values()),
                  f"{name}: a kernel launched in the plain prefill")
        want = plain[:, -1].float()
        del plain
        err = float((first - want).abs().max())
        check(err <= bf16_tol(cfg, want),
              f"{name}: the first logits differ from the plain memory "
              f"read's by {err}")
        out["kernel_vs_plain_first_logits_max_abs_err"] = err
        out["bf16_tol_of_first"] = bf16_tol(cfg, want)
        full = full_forward_of(model, batch, fed).float()
        got = torch.stack(steps, dim=1)
        err = float((got - full).abs().max())
        check(err <= bf16_tol(cfg, full),
              f"{name}: the decoded logits differ from a full forward's by "
              f"{err}")
        out["decode_vs_forward_max_abs_err"] = err
        out["bf16_tol_of_forward"] = bf16_tol(cfg, full)
        del full, got
    out["path_s"] = time.perf_counter() - started
    print(json.dumps(out), flush=True)
    del model, logits, steps
    torch.cuda.empty_cache()
    return launches


def family_parity(model, devices) -> dict:
    """An enc-dec or VLM smoke model on two devices from the same weights
    and inputs (`family_inputs`, 2 prompts of 8 tokens): the prefill's
    logits at every position and 4 decode steps' fed the same tokens,
    card against CPU, float32 to rtol / atol 1e-5, bfloat16 to
    `bf16_tol`."""
    cfg = model.cfg
    b, s, steps = 2, 8, 4
    fed = torch.randint(0, cfg.vocab_size, (b, steps),
                        generator=torch.Generator().manual_seed(2))
    got = {}
    for device in devices:
        model.to(device)
        batch = family_inputs(cfg, b, s, device)
        with torch.inference_mode():
            logits, cache = transformer.prefill(model, batch["tokens"],
                                                s + steps, **extras(batch))
            outs = [logits.float().cpu()]
            for t in range(steps):
                pos = torch.full((b,), s + t, dtype=torch.long,
                                 device=device)
                outs.append(transformer.decode_step(
                    model, fed[:, t:t + 1].to(device), pos,
                    cache).float().cpu())
        got[device] = outs
    errs, tols = [], []
    for i, (a, ref) in enumerate(zip(*(got[d] for d in devices))):
        err, tol = float((a - ref).abs().max()), bf16_tol(cfg, ref)
        ok = (torch.allclose(a, ref, rtol=tol, atol=tol)
              if cfg.dtype == "float32" else err <= tol)
        check(ok, f"{cfg.name} {cfg.dtype} smoke: card vs CPU "
              f"{'prefill' if i == 0 else f'decode step {i}'} logits "
              f"differ by {err} (tolerance {tol})")
        errs.append(err)
        tols.append(tol)
    return {"card_vs_cpu_prefill_max_abs_err": errs[0],
            "card_vs_cpu_decode_max_abs_err": max(errs[1:]),
            "tolerance": max(tols), "through": "prefill + decode_step"}


def arch_parity_phase(devices=("cuda", "cpu")):
    """Phase 8 for the public archs: each smoke config with its memory
    FFN (2^16 rows, `pallas`; the hybrid without: the reference allows
    none) served on the card and on the CPU from the same seed's weights
    (drawn on the CPU), in float32 and in bfloat16: every request's
    first logits to 1e-5 / to `bf16_tol`, and in float32 the greedy
    tokens equal (the decode graph captured on the served state, no
    warm-up).  A bfloat16 MoE request whose prefill the two route apart
    is held to the routing rule instead (`routing_excused`, the CPU's
    margins).  The enc-dec and VLM archs, which the engine refuses, go
    through `transformer.prefill` and `decode_step` (`family_parity`)."""
    out = {}
    for arch in configs.ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = h_config(arch, dtype, smoke=True, log2=16)
            model = transformer.init(cfg, seed=1).eval()
            if cfg.family in ("encdec", "vlm"):  # the engine refuses them
                out[f"{arch}/{dtype}"] = family_parity(model, devices)
                continue
            reports, routes = {}, {}
            for device in devices:
                trace = synthetic_trace(np.random.default_rng(1), 3,
                                        vocab_size=cfg.vocab_size,
                                        max_prompt=12, max_gen=4)
                routes[device] = []
                with recorded_routes(routes[device]):
                    reports[device] = ServeEngine(
                        model.to(device), EngineConfig(
                            slots=2, max_len=16)).run(trace)
            gpu, cpu = (reports[d] for d in devices)
            check(len(gpu.requests) == len(cpu.requests) == 3,
                  f"{arch} {dtype}: requests lost")
            n = moe_blocks(cfg)
            errs, excused = [], []
            for i, (a, b) in enumerate(zip(gpu.requests, cpu.requests)):
                err = float(np.abs(a.first_logits - b.first_logits).max())
                tol = bf16_tol(cfg, torch.from_numpy(b.first_logits))
                found = (routing_excused(
                    f"{arch} {dtype} smoke", cfg.top_k_experts,
                    routes[devices[1]][i * n:(i + 1) * n],
                    routes[devices[0]][i * n:(i + 1) * n],
                    trace[i].prompt_len)
                    if n and dtype == "bfloat16" else [])
                if any(f["before_first_logits"] for f in found):
                    excused.append({"request": i, "error": err,
                                    "routing": found})
                    continue
                # float32: rtol and atol 1e-5, as the CPU tests hold the
                # archs
                ok = (np.allclose(a.first_logits, b.first_logits, rtol=tol,
                                  atol=tol) if dtype == "float32"
                      else err <= tol)
                check(ok, f"{arch} {dtype} smoke: card vs CPU first logits "
                      f"of request {i} differ by {err} (tolerance {tol})")
                errs.append((err, tol))
            same = all(a.tokens == b.tokens
                       for a, b in zip(gpu.requests, cpu.requests))
            # the card's decode graph is captured at the first tick, on the
            # served state; float32 logits leave no near-tie to flip
            check(same or dtype == "bfloat16", f"{arch} float32 smoke: card "
                  f"vs CPU greedy tokens differ")
            out[f"{arch}/{dtype}"] = {
                "card_vs_cpu_first_logits_max_abs_err": max(
                    (e for e, _ in errs), default=None),
                "tolerance": max((t for _, t in errs), default=None),
                "greedy_tokens_equal": same}
            if n:
                out[f"{arch}/{dtype}"]["routing_excused"] = excused
    print(json.dumps({"parity": "public archs, smoke, with_lram "
                      "(the hybrid without)", **out}),
          flush=True)


# ---------------------------------------------------------------------------
# path (p): the public archs trained in bfloat16 with the memory FFN
# ---------------------------------------------------------------------------

# steps: (p1)-(p3); (p4a) and (p4b) and (p4b)'s twin (a gloo step of
# (p4a) moves 3.5 GB of weights and 3.5 GB of gradients through host
# memory a rank: ~12 s)
# (p1)-(p3) cut from 20 steps to 12 to keep the script in its time limit
# (PERF.md section 4); (p4a) and (p4b) from 5 to 3 for the same reason
# when (p4c) came (a mesh step now gathers every unit twice: (p4a)'s
# took about 10 s, not 7.8)
P_STEPS, P4A_STEPS, P4B_STEPS = 12, 3, 3
# (p4c): (p1)'s config on 4 ranks, data 4 x model 1 (pure FSDP: every
# dense leaf split 4 ways over data, gathered a unit at a time), held
# against (p1)'s first P4C_STEPS losses
P4C_STEPS, P4C_MESH = 3, (4, 1)
# (p4a)'s router term against (p3)'s, relative: at step 1 (same weights,
# same batch: a router loss per rank summed over the 2 data ranks would
# be 2x) and after it.  From step 2 the runs' weights part: even two
# runs of (p3) on one process differ (the atomic sums of the MoE
# dispatch and of the lookup's backward) by 1.8% at step 5 (2.4892 /
# 2.4605 / 2.4438 in three runs of this script), and the router of a
# model at random weights is collapsing (its term rises from 1.26 to
# ~2.5 in 5 steps), which carries such differences on; (p4a) read 2.5%
# from (p3) at step 5.  The bound after step 1 is twice that (a later
# run read 3.9%)
P4A_AUX_TOL = (0.01, 0.05)
P_BATCH, P_SEQ = 8, 256
# path -> (arch, layers kept or None for all); each model is
# `with_lram(get_config(arch), 20)` on `pallas` (`h_config`), its widths as
# published, drawn on the card from --seed 0 (`p_registry`), trained
# through `train.main` on a replaced registry.  phi3.5-moe is cut from 32
# layers to 2: one MoE layer, then the memory FFN at layer 1
P_PATHS = {
    "p1_qwen2_1_5b": ("qwen2-1.5b", None),
    "p2_mamba2_1_3b": ("mamba2-1.3b", None),
    "p3_phi3_5_moe": ("phi3.5-moe-42b-a6.6b", 2),
}
# (p4b): zamba2-2.7b cut to 2 of its 9 units (12 Mamba layers, the shared
# block called twice), no memory layer
P4B_ARCH, P4B_LAYERS = "zamba2-2.7b", 12
# the path whose model is also drawn once on the host, timed
HOST_DRAW_PATH = "p1_qwen2_1_5b"
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 peak (data sheet)


def p_argv(arch: str, steps: int, placement: str = "pallas",
           mesh: bool = False, shape=None) -> list[str]:
    return (["--arch", arch, "--batch", str(P_BATCH), "--seq", str(P_SEQ),
             "--steps", str(steps), "--json"]
            + (["--placement", placement] if placement else [])
            + (["--use-mesh"] if mesh else [])
            + (["--mesh-shape", "x".join(map(str, shape))] if shape
               else []))


@contextlib.contextmanager
def p_registry(arch: str, layers: int | None):
    """`configs.get_config(arch)` replaced by `h_config(arch, layers=)`
    (the memory FFN on `pallas`; a hybrid as it is), so that `train.main`
    builds it: the reference's CLI has no flag for `with_lram`; and
    `transformer.init` drawing on the card (`device=`): the host draw of
    1.3-1.8 B weights a run, four ranks at once on (p4a), would add
    minutes to path (p) (its seconds at (p1)'s size in `host_init_s`)."""
    cfg = h_config(arch, layers=layers)
    get, init = configs.get_config, transformer.init
    configs.get_config = lambda name, **kw: (
        cfg if name == arch and not kw else get(name, **kw))
    transformer.init = functools.partial(
        init, device=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield cfg
    finally:
        configs.get_config, transformer.init = get, init


@contextlib.contextmanager
def first_call_kept(name: str, kept: dict):
    """The arguments of the first launch of `ops.<name>` (a backward
    wrapper) copied to the host into `kept` (positional and keyword),
    through `ops.input_sink`: the wrapper, and its count, stay as they
    are."""
    def host(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    def keep(fn, args, kw):
        if fn == name and not kept:
            kept.update(fn=fn, args=[host(a) for a in args],
                        kw={k: host(v) for k, v in kw.items()})

    ops.input_sink = keep
    try:
        yield
    finally:
        ops.input_sink = None


@contextlib.contextmanager
def counted_drops(drops: list):
    """Each MoE block's dispatch: the token copies its capacity dropped,
    a device scalar a call appended to `drops` (no host sync)."""
    dispatch = moe.dispatch

    def counting(cfg, expert_ids):
        slot, keep = dispatch(cfg, expert_ids)
        drops.append((~keep).sum())
        return slot, keep

    moe.dispatch = counting
    try:
        yield
    finally:
        moe.dispatch = dispatch


def p_train(arch: str, layers: int | None, argv: list[str],
            backward: str | None, drops: list | None = None) -> dict:
    """`train.main(argv)` on the replaced registry with every launch count
    set to 0 just before and read just after; step 1's backward inputs
    kept (`ops.<backward>`), an MoE's dropped copies counted; peak
    memory after a reset, and the steps' own (read as the final
    evaluation starts).  Returns cfg, run, launches, kept, peak bytes
    (the run's and the steps'), the bytes allocated before and the wall
    seconds."""
    kept: dict = {}
    steps_peak = []
    evaluate = train.evaluate

    def peak_then_evaluate(*args, **kw):
        steps_peak.append(torch.cuda.max_memory_allocated())
        return evaluate(*args, **kw)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    reset_counts()  # before the wrapper takes its count over
    with contextlib.ExitStack() as stack:
        cfg = stack.enter_context(p_registry(arch, layers))
        if backward:
            stack.enter_context(first_call_kept(backward, kept))
        if drops is not None:
            stack.enter_context(counted_drops(drops))
        train.evaluate = peak_then_evaluate
        stack.callback(setattr, train, "evaluate", evaluate)
        run = train.main(argv)
        torch.cuda.synchronize()
    launches = read_counts()
    return {"arch": arch, "cfg": cfg, "run": run, "launches": launches,
            "kept": kept,
            "peak": torch.cuda.max_memory_allocated(),
            "steps_peak": steps_peak[0], "before": before,
            "wall_s": time.perf_counter() - t0}


def held_backward(name: str, kept: dict, device) -> dict:
    """Step 1's kept backward inputs back on `device`: the kernel's dq
    and dw instances (the range instances where the path trained through
    them) against `lookup_bwd_plain` on the same inputs: dvalues to atol
    1e-5 (atomics order a row's sum) and, on a 2-byte table, rounded once
    to its dtype (`rounding_agrees`), dq / dw to rtol 1e-4 / atol 1e-5.
    Returns the errors and the step's n."""
    def card(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    fn = getattr(ops, kept["fn"])
    a = inspect.signature(fn).bind(*kept["args"], **kept["kw"]).arguments
    values, idx, w, g, q, spec = (card(a[k]) for k in (
        "values", "idx", "w", "g", "q", "spec"))
    extra = {}
    if "base" in a:  # the range instances
        extra = {"scatter": True, "base": a["base"]}
        fn = functools.partial(fn, base=a["base"])
    dv, dq = fn(values, idx, w, g, q=q, spec=spec)
    dv_p, dq_p = ops.lookup_bwd_plain(values, idx, w, g, q, spec, **extra)
    _, dw = fn(values, idx, w, g)
    _, dw_p = ops.lookup_bwd_plain(values, idx, w, g, None, spec, **extra)
    torch.cuda.synchronize()
    errs = {"dvalues": (dv - dv_p).abs().max().item(),
            "dq": (dq - dq_p).abs().max().item(),
            "dw": (dw - dw_p).abs().max().item()}
    rounded = (rounding_agrees(dv, dv_p, values.dtype)
               if values.dtype in HALF else None)
    check(torch.allclose(dv, dv_p, rtol=0, atol=1e-5)
          and (rounded is None or rounded["ok"])
          and torch.allclose(dq, dq_p, rtol=1e-4, atol=1e-5)
          and torch.allclose(dw, dw_p, rtol=1e-4, atol=1e-5),
          f"{name}: step 1's backward ({kept['fn']}) differs from its "
          f"plain version: {errs}, rounded {rounded}")
    return {"kernel": kept["fn"], "n_step1": int(idx.numel() // TOP_K),
            "max_abs_err": errs, "dvalues_rounded": rounded}


def p_numbers(name: str, out: dict, steps: int, ranks: int = 1) -> dict:
    """The numbers a sub-path prints: losses, router terms, step ms
    (median from step 6 on), tokens/s, the step against its FLOP bound
    (the global batch's products: on a mesh the 4 ranks share the one
    card), peak memory against the reckoning (`train_bytes`, a rank's
    on a mesh), init seconds."""
    cfg, run = out["cfg"], out["run"]
    leaves = whole_leaves(run.model)
    recs = run.records
    losses = [r["loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    check(len(recs) == steps and all(math.isfinite(x)
                                     for x in losses + norms),
          f"{name}: steps missing or non-finite: {losses} {norms}")
    step_ms = [r["step_ms"] for r in recs]
    first = 6 if steps > 5 else 2  # the first steps warm the allocator
    median_ms = float(np.median(step_ms[first - 1:]))
    tokens = P_BATCH * P_SEQ
    blocks = sharding.dense_blocks(run.model)
    data_ranks = (blocks.mesh.size(blocks.batch_axes)
                  if blocks is not None and blocks.batch_axes else 1)
    flops = train_flops(leaves, cfg, run.model.lm_head is None, P_BATCH,
                        P_SEQ)
    bound = 1e3 * flops / BF16_TENSOR_FLOPS
    return {
        "path": name, "config": cfg.name, "dtype": cfg.dtype,
        "layers": cfg.num_layers,
        "published_layers": configs.get_config(out["arch"]).num_layers,
        "d_model": cfg.d_model,
        "memory_layer_heads": cfg.lram.heads if cfg.lram else None,
        "lookups_per_step": tokens * cfg.lram.heads if cfg.lram else 0,
        "reckoning": train_bytes(leaves, cfg, tokens // data_ranks,
                                 run.model if ranks > 1 else None),
        "losses": losses, "grad_norms": norms,
        "aux": [r["aux"] for r in recs],
        "step_ms": step_ms, "step_ms_median": median_ms,
        "median_from_step": first,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "train_flops": flops, "flop_bound_ms": bound,
        "flop_bound_share": bound / median_ms,
        "peak_memory_bytes": out["peak"],
        "steps_peak_memory_bytes": out["steps_peak"],
        "allocated_before_bytes": out["before"],
        **{f"{k}_by_step": [r[k] for r in recs] for k in (
            "gathered_bytes", "summed_bytes", "units_held_peak",
            "shared_held_peak") if k in recs[0]},
        "init_s": run.init_s, "wall_s": out["wall_s"],
        "final_eval_loss": run.final_eval_loss,
        "launches": {k: v for k, v in out["launches"].items() if v}}


def p_path(name: str) -> tuple[dict, list]:
    """(p1)-(p3): P_STEPS of `--batch 8 --seq 256` through `train.main`
    (`--placement pallas`, drawn on the card).  Fails unless K2 and K1
    launched every step (and in the evaluation), the backward kernel
    `lookup_bwd` once a step, the losses are finite and fall (the last 5
    steps below 1-5), and step 1's backward inputs, kept, agree with the
    plain version on the card (`held_backward`).  Prints `p_numbers`,
    the reckoned bytes, an MoE's router term and dropped copies a step,
    (p1) the seconds of one host draw of its model (`host_init_s`), then
    one profiled step's top kernels.  Returns the launch counts and the
    records."""
    arch, layers = P_PATHS[name]
    host_init_s = None
    if name == HOST_DRAW_PATH:  # the host draw the card's replaces
        t0 = time.perf_counter()
        host = transformer.init(h_config(arch, layers=layers), seed=0)
        host_init_s = time.perf_counter() - t0
        del host
    drops: list = []
    out = p_train(arch, layers, p_argv(arch, P_STEPS), "lookup_bwd",
                  drops)
    cfg, run, c = out["cfg"], out["run"], out["launches"]
    check(c["lram_query"] >= P_STEPS and c["gather_interp"] >= P_STEPS
          and c["lookup_bwd"] == P_STEPS,
          f"{name}: K2 / K1 / lookup_bwd launched {c['lram_query']} / "
          f"{c['gather_interp']} / {c['lookup_bwd']} times in {P_STEPS} "
          f"steps (the backward once a step)")
    numbers = p_numbers(name, out, P_STEPS)
    numbers["host_init_s"] = host_init_s
    losses = numbers["losses"]
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"{name}: the loss did not fall: {losses}")
    numbers["step1_backward"] = held_backward(
        name, out["kept"], run.model.embed.embedding.device)
    P_NUMBERS[name] = numbers
    if cfg.num_experts:
        blocks = moe_blocks(cfg)
        per_step = [int(sum(int(d) for d in drops[s * blocks:
                                                  (s + 1) * blocks]))
                    for s in range(P_STEPS)]
        numbers.update(
            experts=[cfg.num_experts, cfg.top_k_experts],
            capacity_per_sequence=moe.capacity(cfg, P_SEQ),
            token_copies_per_step=P_BATCH * P_SEQ * cfg.top_k_experts
            * blocks, dropped_copies_by_step=per_step)
    print(json.dumps(numbers), flush=True)
    profile_train_step(run, f"train step {name}")
    records = run.records
    del run, out
    torch.cuda.empty_cache()
    return c, records


def p4_rank(rank: int, port: int, results, device_name) -> None:
    """One rank of (p4) (a spawned process; all ranks on the one card,
    gloo): on data 2 x model 2 (p4a) (p3)'s config on `--placement
    sharded`, then (p4b) zamba2-2.7b cut to 2 units; then on data 4 x
    model 1 (a mesh of the same ranks) (p4c) (p1)'s config; P4A_STEPS,
    P4B_STEPS and P4C_STEPS steps through `train.main`, launch counts
    reset just before and read just after; (p4a)'s step-1 range backward
    held against its plain version on this rank's shard; each part's
    held bytes against its share."""
    _rank_env(rank, port)
    mesh, device = mesh_lib.init_mesh(device_name)
    res = {"rank": rank, "coords": mesh.coords, "mesh": mesh.shape,
           "backend": dist.get_backend()}
    arch, layers = P_PATHS["p3_phi3_5_moe"]
    p1_arch, p1_layers = P_PATHS["p1_qwen2_1_5b"]
    parts = {
        "p4a": (arch, layers, p_argv(arch, P4A_STEPS, "sharded", True),
                "lookup_bwd_range", P4A_STEPS),
        "p4b": (P4B_ARCH, P4B_LAYERS,
                p_argv(P4B_ARCH, P4B_STEPS, "", True), None, P4B_STEPS),
        "p4c": (p1_arch, p1_layers,
                p_argv(p1_arch, P4C_STEPS, "pallas", True, P4C_MESH),
                None, P4C_STEPS)}
    for part, (arch, layers, argv, backward, steps) in parts.items():
        if part == "p4c":  # the same ranks, another mesh
            mesh = mesh_lib.make_host_mesh(P4C_MESH)
            context.set_mesh(mesh)
            res["p4c_coords"], res["p4c_mesh"] = mesh.coords, mesh.shape
        out = p_train(arch, layers, argv, backward)
        run = out["run"]
        numbers = p_numbers(part, out, steps, MESH_RANKS)
        numbers["held"] = held_dense_bytes(run.model, run.opt_state, mesh)
        if backward:
            numbers["step1_backward"] = held_backward(
                f"({part}) rank {rank}", out["kept"], device)
        res[part] = numbers
        del run, out
        torch.cuda.empty_cache()
    results.put(res)
    dist.destroy_process_group()


def p4_path(p1_records: list, p3_records: list,
            device_name: str = "cuda") -> dict:
    """(p4): (p4b)'s one-process twin first (zamba2-2.7b cut to 2 units,
    P4B_STEPS steps on the card), then one spawn of 4 ranks that runs
    (p4a), (p4b) and (p4c) in turn (`p4_rank`).  Fails unless on every
    rank (p4a) launched K2 and the range gather every step and the range
    backward once a step, its router term is within `P4A_AUX_TOL` of
    (p3)'s (1% at step 1, 5% after it) and its losses within the bf16
    bound of (p3)'s (2^-8 x (layers + 1) x the largest of (p3)'s first
    losses: the CPU tests' bound, the two runs differing in rounding
    alone at step 1: the dense and the row-range sums, the batch split
    over two ranks, the gradients' bf16 sum over them), (p4b) launched
    no kernel of the port and its losses are within that bound of its
    twin's, (p4a) and (p4b)'s losses fall (the last step below the
    first), and (p4c) launched K2 and K1 every step and `lookup_bwd`
    once a step, held at most one unit whole at once beside the shared
    embedding, and its losses are within the bound of (p1)'s first
    P4C_STEPS (the same weights, from the same seed, and batches).
    Every part's losses are finite.  Prints each part's numbers: a
    rank's peak (the run's and the steps') beside its reckoning, step
    ms, and on (p4c) the bytes gathered and summed and the units held
    whole at once, a step.  Returns the launch counts summed over the
    ranks, by part."""
    twin = p_train(P4B_ARCH, P4B_LAYERS,
                   p_argv(P4B_ARCH, P4B_STEPS, ""), None)
    twin_numbers = p_numbers("p4b one-process twin", twin, P4B_STEPS)
    twin_cfg = twin["cfg"]
    print(json.dumps(twin_numbers), flush=True)
    check(not any(twin["launches"].values()),
          f"(p4b) twin: a kernel of the port launched: "
          f"{ {k: v for k, v in twin['launches'].items() if v} }")
    del twin
    torch.cuda.empty_cache()
    ranks, wall_s = _spawn_ranks(p4_rank, (device_name,), "path (p4)")
    p3_arch, p3_layers = P_PATHS["p3_phi3_5_moe"]
    p3_cfg = h_config(p3_arch, layers=p3_layers)
    p1_arch, p1_layers = P_PATHS["p1_qwen2_1_5b"]
    refs = {"p4a": ([r["loss"] for r in p3_records[:P4A_STEPS]],
                    [r["aux"] for r in p3_records[:P4A_STEPS]], p3_cfg),
            "p4b": (twin_numbers["losses"], twin_numbers["aux"], twin_cfg),
            "p4c": ([r["loss"] for r in p1_records[:P4C_STEPS]],
                    [r["aux"] for r in p1_records[:P4C_STEPS]],
                    h_config(p1_arch, layers=p1_layers))}
    totals = {}
    for part, (want, want_aux, cfg) in refs.items():
        tol = bf16_tol(cfg, torch.tensor(want))
        for r in ranks:
            got, who = r[part], f"({part}) rank {r['rank']}"
            c, losses = got["launches"], got["losses"]
            if part == "p4a":
                check(c.get("lram_query", 0) >= P4A_STEPS
                      and c.get("sharded_gather", 0) >= P4A_STEPS
                      and c.get("lookup_bwd_range", 0) == P4A_STEPS,
                      f"{who}: K2 / the range gather / the range backward "
                      f"launched {c} in {P4A_STEPS} steps")
                rel = [abs(a / b - 1) for a, b in zip(got["aux"], want_aux)]
                first, later = P4A_AUX_TOL
                check(rel[0] <= first and max(rel[1:]) <= later,
                      f"{who}: the router term {got['aux']} is not within "
                      f"{first:.0%} of (p3)'s {want_aux} at step 1 or "
                      f"within {later:.0%} after it")
                got.update(aux_rel_err_vs_p3_by_step=rel,
                           aux_rel_bound=P4A_AUX_TOL)
            elif part == "p4c":
                check(c.get("lram_query", 0) >= P4C_STEPS
                      and c.get("gather_interp", 0) >= P4C_STEPS
                      and c.get("lookup_bwd", 0) == P4C_STEPS,
                      f"{who}: K2 / K1 / lookup_bwd launched {c} in "
                      f"{P4C_STEPS} steps (the backward once a step)")
                check(max(got["units_held_peak_by_step"]) == 1
                      and max(got["shared_held_peak_by_step"]) <= 1,
                      f"{who}: more than one unit whole at once: "
                      f"{got['units_held_peak_by_step']} (shared "
                      f"{got['shared_held_peak_by_step']})")
            else:
                check(not c, f"{who}: a kernel of the port launched: {c}")
            err = max(abs(a - b) for a, b in zip(losses, want))
            check(err <= tol, f"{who}: losses {losses} differ from the "
                              f"one-process run's {want} by {err} (bound "
                              f"{tol})")
            check(part == "p4c" or losses[-1] < losses[0],
                  f"{who}: the loss did not fall: {losses}")
            got.update(loss_max_abs_err_vs_one_process=err, loss_bound=tol)
        totals[f"{part}_mesh"] = {k: sum(r[part]["launches"].get(k, 0)
                                         for r in ranks) for k in KERNELS}
    P_NUMBERS["p4c"] = [r["p4c"] for r in ranks]
    print(json.dumps({"path": "p4 mesh", "ranks": MESH_RANKS,
                      "mesh": ranks[0]["mesh"],
                      "backend": ranks[0]["backend"],
                      "wall_s_incl_spawn": wall_s,
                      "p4c_mesh": ranks[0]["p4c_mesh"],
                      "by_rank": [{k: r[k] for k in (
                          "rank", "coords", "p4a", "p4b", "p4c_coords",
                          "p4c")} for r in ranks]}), flush=True)
    return totals


def p_paths(launches: dict) -> None:
    """Path (p): (p1)-(p3) one process each, then (p4) on 4 ranks."""
    t_p = time.perf_counter()
    records = {}
    for name in P_PATHS:
        launches[name], records[name] = p_path(name)
    launches.update(p4_path(records["p1_qwen2_1_5b"],
                            records["p3_phi3_5_moe"]))
    print(json.dumps({"path_p_s": time.perf_counter() - t_p}), flush=True)


# ---------------------------------------------------------------------------
# phase (r): the dry-run on the host (meta tensors, fake worlds)
# ---------------------------------------------------------------------------

# the three subprocesses' wall seconds, together; (r1)'s products against
# (p1)'s reckoning, relative
R_TIMEOUT_S, R_FLOPS_TOL = 60, 0.01
# (r3): arch, shape, memory table 2^N rows
R3_CELL = ("qwen2-1.5b", "train_4k", 20)
R_CODE = """
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
a = json.loads(sys.argv[1])
if "mesh" not in a:
    art = dryrun.run_cell(a["arch"], a["shape"], False, a["log2"])
else:
    cfg = configs.with_lram(configs.get_config(a["arch"]), a["log2"])
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    art = dryrun.run_cell(cfg.name, "train", False, cfg=cfg, cell=ShapeCell(
        "train", a["seq"], a["batch"], "train"), mesh_shape=tuple(a["mesh"]))
print(json.dumps(art))
"""


def dryrun_phase(card: str) -> None:
    """Phase (r): (r1) (p1)'s cell on one rank, (r2) (p4c)'s on a fake
    4-rank world, (r3) `R3_CELL` on the 16 x 16 mesh, each a dry-run in
    a subprocess with no card (CUDA_VISIBLE_DEVICES empty), started
    together.  Fails unless all end within `R_TIMEOUT_S`, (r1)'s
    products less the memory lookup's are within `R_FLOPS_TOL` of (p1)'s
    `train_flops`, and (r2)'s tallied block bytes equal (p4c)'s measured
    ones on every rank and step."""
    arch, _ = P_PATHS["p1_qwen2_1_5b"]
    cells = {
        "r1": {"arch": arch, "log2": LOG2_LOCATIONS, "batch": P_BATCH,
               "seq": P_SEQ, "mesh": [1, 1]},
        "r2": {"arch": arch, "log2": LOG2_LOCATIONS, "batch": P_BATCH,
               "seq": P_SEQ, "mesh": list(P4C_MESH)},
        "r3": dict(zip(("arch", "shape", "log2"), R3_CELL)),
    }
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", R_CODE, json.dumps(a)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, a in cells.items()}
    arts = {}
    try:
        for name, proc in procs.items():
            left = R_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                out, err = proc.communicate(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                fail(f"phase (r): ({name}) outlasted {R_TIMEOUT_S} s")
            check(proc.returncode == 0,
                  f"phase (r): ({name}) failed:\n{err[-3000:]}")
            arts[name] = json.loads(out.strip().splitlines()[-1])
            check(arts[name]["status"] == "ok",
                  f"phase (r): ({name}) {arts[name]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0

    r1 = arts["r1"]
    p1 = P_NUMBERS["p1_qwen2_1_5b"]
    rk, full = r1["reckoned"], r1["full_depth"]
    counted = full["flops_per_device"] - rk["memory_lookup_flops"]
    rel = counted / p1["train_flops"] - 1
    check(abs(rel) <= R_FLOPS_TOL,
          f"(r1): the dry-run's products less the memory lookup's, "
          f"{counted}, are {rel:+.2%} from (p1)'s train_flops "
          f"{p1['train_flops']} (bound {R_FLOPS_TOL:.0%})")
    peak = full["memory_analysis"]["peak_live_bytes"]

    r2 = arts["r2"]
    tallied = r2["dense_blocks_tallied"]
    for rank, got in enumerate(P_NUMBERS["p4c"]):
        for key in ("gathered_bytes", "summed_bytes"):
            check(all(b == tallied[key] for b in got[f"{key}_by_step"]),
                  f"(r2): the tally's {key} {tallied[key]} differ from "
                  f"(p4c) rank {rank}'s measured {got[f'{key}_by_step']}")

    r3 = arts["r3"]
    row = roofline.analyze_artifact(r3)
    check(row is not None and math.isfinite(row["step_time_bound_s"]),
          f"(r3): no roofline row: {r3}")
    print(json.dumps({
        "phase": "r", "card": card, "wall_s": wall_s,
        "r1": {"cell": r1["arch"], "batch": P_BATCH, "seq": P_SEQ,
               "flops": full["flops_per_device"],
               "memory_lookup_flops": rk["memory_lookup_flops"],
               "memory_lookup_flops_by_op": rk["memory_lookup_flops_by_op"],
               "flops_by_op": full["flops_by_op"],
               "flops_less_lookup": counted,
               "p1_train_flops": p1["train_flops"], "rel_err": rel,
               "rel_bound": R_FLOPS_TOL,
               "peak_live_bytes": peak,
               "p1_steps_peak_memory_bytes": p1["steps_peak_memory_bytes"],
               "peak_over_measured": peak / p1["steps_peak_memory_bytes"],
               "memory_analysis": full["memory_analysis"],
               "run_s": r1["run_s"]},
        "r2": {"mesh": r2["mesh_shape"], "tallied": tallied,
               "dense_blocks": r2["dense_blocks"],
               "p4c_gathered_bytes_by_step": [
                   r["gathered_bytes_by_step"] for r in P_NUMBERS["p4c"]],
               "p4c_summed_bytes_by_step": [
                   r["summed_bytes_by_step"] for r in P_NUMBERS["p4c"]],
               "collective_counts": r2["full_depth"]["collective_counts"],
               "run_s": r2["run_s"]},
        "r3": {"cell": f"{r3['arch']} x {r3['shape']} x {r3['mesh']}",
               "run_s": r3["run_s"], "roofline": row,
               "table": roofline.render_table([row]),
               "peak_live_bytes": r3["full_depth"]["memory_analysis"][
                   "peak_live_bytes"]}}), flush=True)


def main() -> None:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}", flush=True)
    print(json.dumps({"ptxas": [dict(r, source=name)
                                for name, log in logs.items()
                                for r in ptxas_report(log)]}), flush=True)

    phase_s: dict[str, float] = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """The seconds since the last lap, under `name` (the script's
        time limit is tight: each lap shows where it went)."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    rows = kernel_phase(device)
    lap("kernel_phase")
    launches, reports = {}, {}
    for name in PATHS:
        launches[name], reports[name] = serve_path(name)
    print(json.dumps({"placements_agree": {
        "a_vs_dense": same_first_logits("(a) vs dense", reports["a_tiered"],
                                        reports["dense"]),
        "c_vs_dense": same_first_logits(
            "(c) vs dense", reports["c_tiered_resident"], reports["dense"]),
        "d_vs_b": same_first_logits(
            "(d) vs (b)", reports["d_tiered_q8_resident"],
            reports["b_tiered_q8"]),
        "e_vs_dense": same_first_logits(
            "(e) vs dense", reports["e_sharded_tiered"], reports["dense"]),
        "f_vs_dense": same_first_logits(
            "(f) vs dense", reports["f_sharded_tiered_resident"],
            reports["dense"]),
    }}), flush=True)
    lap("serve_paths")
    launches["graph_vs_eager"] = graph_vs_eager(reports["dense"])
    launches["g_dense_spill"] = spill_path(reports["dense"])
    launches.update(tenant_path(reports["dense"]))
    launches.update(mmap_path(reports["b_tiered_q8"]))
    launches["k_sharded_mmap"] = sharded_mmap_path(
        reports["e_sharded_tiered"])
    del reports
    lap("g_i_j_k")
    launches.update(obs_path())
    lap("l")
    launches.update(bf16_path())
    lap("m_q4")
    for name in PATHS:
        profile_path(name)
    profile_path("dense", cuda_graph=False)
    lap("profiles")
    for name in H_PATHS:
        launches[name] = public_path(name)
    t_n = time.perf_counter()
    for name in N_PATHS:
        launches[name] = public_path(name)
    print(json.dumps({"path_n_s": time.perf_counter() - t_n}), flush=True)
    t_o = time.perf_counter()
    launches["o1_zamba2_2_7b"] = o1_hybrid_path()
    for name in O_PATHS:
        launches[name] = o_decoder_path(name)
    print(json.dumps({"path_o_s": time.perf_counter() - t_o}), flush=True)
    lap("h_n_o")
    p_paths(launches)
    lap("p")
    dryrun_phase(card)
    lap("r")
    f16_path(launches)
    lap("q")
    launches["train"], run = train_path()
    print(json.dumps({"m4_q3_vs_phase6": {"bf16_table": PATH_M["m4"],
                                          "f16_table": PATH_M["q3"],
                                          "fp32_table": PHASE6}}),
          flush=True)
    profile_train_step(run)
    dense_records = run.records
    del run
    lap("6")
    with checkpoint_dir() as ckpt:
        launches["ckpt_crashed"], launches["ckpt_resumed"], dense_saved = \
            dense_resume_path(dense_records, ckpt)
    lap("6a")
    launches["mesh_train"], launches["mesh_quant_forward"], mesh_losses = \
        mesh_phase(dense_records)
    lap("6b")
    with checkpoint_dir() as ckpt:
        (launches["mesh_ckpt_crashed"], launches["mesh_ckpt_resumed"],
         launches["mesh_ckpt_one_process"]) = mesh_resume_path(
            mesh_losses, dense_saved, ckpt)
    lap("6c")
    pipeline_phase()
    lap("6d")
    for kind in ("int8", "topk"):
        launches[f"compression_{kind}"] = compression_path(kind)
    launches["grow_train"] = grow_train_path(dense_records)
    lap("6e_6f")
    for name, (_, _, gather, _, _) in TIERED_TRAIN.items():
        launches[name], run = tiered_train_path(name)
        profile_train_step(run, f"train step {name}", (
            "lram_query_kernel", f"{gather}_kernel", "lookup_bwd"))
        del run
    lap("7")
    with checkpoint_dir() as ckpt:
        (launches["q8_ckpt_crashed"], launches["q8_ckpt_resumed"],
         launches["q8_ckpt_serve"]) = tiered_resume_path(ckpt)
    with checkpoint_dir() as ckpt:
        (launches["grow_ckpt_crashed"], launches["grow_ckpt_resumed"],
         launches["grow_ckpt_serve"]) = tiered_grow_resume_path(ckpt)
    lap("7a_7d")
    launches["pkm_train"], run = pkm_train_path()
    profile_train_step(run, "train step lram-bert-pkm", ours=())
    del run
    print(json.dumps({"q6_vs_7b": {"bfloat16": PATH_M["q6"],
                                   "float32": PATH_M["7b"]}}), flush=True)
    lap("7b")
    parity_phase()
    arch_parity_phase()
    train_parity("lram-bert-medium", ["--placement", "pallas"])
    for kind in ("int8", "topk"):
        train_parity("lram-bert-medium", ["--placement", "pallas",
                                          "--compression", kind])
    train_parity("lram-bert-pkm")
    train_parity("lram-tiered")
    train_parity("lram-tiered-q8")
    train_parity("lram-sharded-tiered")
    for arch in BF16_PARITY_ARCHS:
        train_parity(arch, ["--placement", "pallas"], dtype=BF16)
    train_parity("qwen2-1.5b", ["--placement", "pallas"], dtype=F16)
    lap("8")
    check(not {"jax", "repro", "ml_dtypes"} & set(sys.modules),
          "the port pulled in JAX, the JAX package or ml_dtypes")

    kernels = kernels_line(rows, launches)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    print(json.dumps({"chip_smoke_s": time.perf_counter() - started}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def kernels_line(rows, launches) -> list[dict]:
    """One entry per kernel: the headline shape's numbers, every shape,
    and its launches summed over the serve and train paths (and by
    path)."""
    kernels = []
    for name, per_shape in rows.items():
        _, source, replaces = KERNELS[name]
        # the decode tick (int8 for B4/B6), the serving path's most frequent
        # call; a train step's shape (the dq instance, int8 for the 1-byte
        # rows) for the backward kernel's instances
        head = next(r for r in per_shape
                    if r["n"] == HEAD_N.get(name, SHAPES[0]))
        by_path = {p: c[name] for p, c in launches.items() if c[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "n": head["n"], "shapes": per_shape,
        })
    check(all(math.isfinite(k["ms"]) and k["launches"] > 0
              for k in kernels), "bad timing or a kernel never launched")
    return kernels


if __name__ == "__main__":
    main()
