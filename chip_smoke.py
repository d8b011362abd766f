"""On-card smoke test of the PyTorch/CUDA port (pt2tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (an H100) and the CUDA toolkit; builds every kernel of
the port from pt2tpu_torch/csrc/ (one nvcc per source, in parallel) and then:

  1. holds K1 (the 2-bit unpack + matmul) against its plain version at the
     four llama-2-7b and the three other llama-3-8b projection shapes, B in
     {1, 2, 4, 16, 512}, bf16 and W2A8, and on a packed[li] view of a
     2-layer stack;
  2. holds K4 (the SSR gather), K3 (the gather fused into K1) and K2 (the
     whole MLP) against their plain versions at the llama-3-8b shapes (K3 at
     qkv, o and gateup), a ragged shape with pad lanes and an MLP whose down
     has pad blocks, rows 1/2/4/16 (K4 1/4/16/512), bf16 and (K3) W2A8, and
     on stacked views;
  3. holds a 2-layer llama-2-7b ("down" layout) and a 2-layer llama-3-8b
     ("ssr" layout: prefill through K4 + K1, decode through K3 + K2, or in
     W2A8 K3 + K1), both at full width, against their reference routes
     ("plain"; for W2A8 the same route with every kernel swapped for its
     plain version), and round-trips each through save_model / load_model;
  4. drives the llama-2-7b main path of the first slice: 8 of its 32
     layers (the run's time budget; 16 before phase 31), "down" layout, 4
     prompts of 128 ids, greedy_generate with max_new 32, bf16 and W2A8;
     K1's launch count must rise by exactly 4 * 8 * 32 per run; one
     decode step is then timed and traced with torch.profiler;
  5. drives this slice's main path: llama-3-8b, 8 of its 32 layers (the
     run's time budget, 16 before phase 31; the lockstep paths of 13b, 16b, 8, 17b, 18b and 20b
     and the engines of run E and 14b too), full-SSR layout,
     the same prompts and max_new, in bf16 ("auto") and W2A8; every kernel's
     launch count must rise by exactly what the routing implies; one decode
     step is traced; then the same model in the "down" layout, where K2 runs
     without its gather and K1 falls by 2 launches per layer and step;
  6. times K1 at the llama-2-7b shapes and K4, K3 and K2 at the llama-3-8b
     shapes (B = 1 and 16; K4 also 512 rows) with cold weights, beside their
     plain versions, a PyTorch yardstick and the memory bound;
  7. (the serving slice) holds K7, the decode attention, against its plain
     version at llama-3-8b heads (32 / 8 KV) and llama-2-7b heads (32 / 32),
     hd 128, B 1/4/8, M 256 and 2048, ragged valid lengths, bf16 and int8
     KV; runs a 2-layer llama-3-8b ServeEngine ("down" layout, bf16 and int8
     KV) with every kernel call held against its plain version; drives the
     llama-3-8b "down" ServeEngine at 4 of its 32 layers (the run's time
     budget: 16 before phase 23, 8 before phase 31; 10c, 11c, 16b's engine
     A/B and 5c's server too) (8 slots,
     max_len 2048, 16
     greedy requests with prompts of 64-512 ids and max_new 32-64) with bf16
     and int8 KV at quantum 1 and 8, where K7's launches must be exactly 32
     per decode step, plus a sampled pair of runs that must agree token for
     token; profiles one engine decode step and times it with K7 on and off;
     holds every answer of both KV types to TOKEN_TOL under a teacher-forced
     plain forward of prompt + answer (int8: through an int8 cache) and runs
     the int8 requests again with K7 off; serves 8 concurrent POSTs through
     the HTTP ServingServer on 127.0.0.1, each answer held the same way; and
     times K7 at B 8, M 2048 beside its plain version,
     scaled_dot_product_attention and its bytes bound;
  8. (the packed-gather slice) holds K5, the packed one-hot gather x @ G,
     bit-exact against its plain version and against K4 (llama-3-8b's
     4096 -> 4096 gather, ragged and interleaved-pad perms, rows
     1/2/4/8/16/64/512, stacked views), and K6, K5 as K1's prologue, within
     KERNEL_TOL at llama-3-8b qkv / o / gateup and a ragged shape, B
     1/2/4/8/16/64, bf16 and W2A8; runs the 2-layer llama-3-8b "ssr" model
     under the P2 flags with every K5 / K6 call held against its plain
     version; drives the llama-3-8b "ssr" main path (8 layers) under the P1
     flags (GATHER_KERNEL "packed": prefill through K5, no K4; tokens equal
     to the default run's) and the P2 flags (also IGATHER_FUSED off,
     FUSED_GATHER on: decode through K6, no K3), bf16 and W2A8, with exact
     launch counts and every P2 answer held to TOKEN_TOL under its
     teacher-forced reference; serves 16 requests through the 32-layer
     "ssr" ServeEngine under the P2 flags (admission buckets <= 64 rows
     through K6, decode K6 at B 8 and K7) with exact counts and every answer
     held; and times K5 and K6 beside their plain versions, a PyTorch call
     and their bytes bound;
  9. (K1's tensor-core slice) holds K1's mma.sync path
     (csrc/ternary_matmul_tc.cu, routed by k1_path at bf16 rows >=
     K1_TC_MIN_ROWS) against the plain version at the llama-2-7b and
     llama-3-8b shapes, rows 16/17/64/100/128/512/1024, on packed[li] views
     and with all-zero alpha blocks, with exact ternary_matmul.launches_tc
     counts (W2A8 and decode rows launch it never); every 32-layer run above
     holds launches_tc to its prefill launches (decode adds none); A/Bs
     lockstep prefill tok/s (llama-2-7b) and the "down" engine's t_admit_s
     with K1_TC_MIN_ROWS rebound above any row count for the "before" runs
     (tc, CUDA cores, CUDA cores, tc, ...); and times both of K1's kernels
     through their C entries at 1-512 rows beside dense torch.matmul;
 10. (K1's W2A8 tensor-core slice) holds K1's s8 mma.sync path
     (csrc/ternary_matmul_tc_a8.cu, routed by k1_path at W2A8 rows >=
     K1_TC_MIN_ROWS) against ternary_matmul_plain_a8 at the llama-2-7b and
     llama-3-8b shapes, rows 9/16/17/64/100/128/512/1024, on packed[li]
     views, with all-zero alpha blocks, an all-zero row and rows whose
     normalised values are half-integers, with exact
     ternary_matmul.launches_tc_a8 counts (decode rows launch it never);
     every 32-layer W2A8 run above holds launches_tc_a8 to its prefill
     launches; A/Bs, in turns (on, off), the lockstep W2A8 prefill
     (llama-2-7b, phase 4); runs the "down" engine under W2A8 at 4 of its 32
     layers (10c: impl "a8", bf16 KV, quantum 1, its off turn dropped for the
     run's time budget, then once with K7 off; every answer held
     to A8_TOLS' pick gap under the teacher-forced W2A8 route on plain
     versions); and times it through its
     C entry at 1-512 rows (phase 6) beside the CUDA-core kernel in W2A8,
     torch._int_mm on int8 xq and the dense int8 codes, and the int8
     operations bound;
 11. (K1's decode slice) holds K1's split-K tensor-core GEMV
     (csrc/ternary_matmul_dec.cu, routed by k1_path at rows <=
     K1_DEC_MAX_ROWS in bf16, and in W2A8 with K1_DEC_A8) against the
     plain versions at the llama-2-7b and llama-3-8b shapes, rows 1/2/4/8
     (phase 1's, 1b's and 10a's decode rows, 11a's) in both modes, on
     packed[li] views, with all-zero alpha blocks, an all-zero row,
     half-integer W2A8 rows and K slices that divide the blocks unevenly,
     every call twice for identical bits, with exact
     ternary_matmul.launches_dec counts, and the CUDA-core kernel at the
     same 8 rows; every 32-layer run above holds launches_dec to exactly
     its bf16 decode launches (the CUDA-core kernel and the tensor-core
     kernels get none of them; W2A8 decode rows stay on the CUDA cores,
     and the P2 W2A8 answers with them on the decode kernel are measured
     beside the held default ones); A/Bs, in turns (on, off; "on"
     sets K1_DEC_A8, "off" rebinds K1_DEC_MAX_ROWS to 0), the lockstep llama-2-7b
     decode (bf16 and W2A8: decode tok/s, step wall, profiled device time;
     11b, in phase 4) and the "down" engine at 4 of its 32 layers, as 10c's
     runs (bf16 and W2A8, quantum 1:
     decode tok/s, t_decode_s, every answer held as in 5b / 10c, and one
     profiled decode step; 11c, in 5b); and times it through its C entry at
     1/2/4/8 rows (phase 6) beside the CUDA-core kernel, the tensor-core
     kernels, dense torch.matmul, torch._int_mm and the bytes bound. The
     engine's tensor-core A/Bs of phases 5b and 10c run in two turns;
 12. (the gemma slice) serves gemma-2b (dim 2048, 8 / 1 KV heads of 256, a
     GeGLU MLP of 16384, vocab 256000, norms by 1 + w, a scaled and tied
     embedding) at full width and its full 18 layers (the engine, the server
     and the profiled engine step at 9 since phase 29), "down" layout: holds
     K1's four kernels at its four projections (qkv 2048 -> 2560, o, gateup
     2048 -> 32768, down 16384 -> 2048; rows 1/2/4/8 on the decode kernel,
     bf16 and W2A8, and on the CUDA cores, 16/64/512 on both tensor-core
     kernels; 12a), K2's GeGLU mode against ternary_mlp_plain(act="gelu") at
     its MLP on packed[li] views, rows 1/2/4/8/16/64, with and without a
     gather, and the relu mode at one shape (phase 2), K7 at its heads (hd
     256, one KV head for 8 queries, scale 1/16; B 1/4/8, M 256 and 2048,
     bf16 and int8 KV; phase 2b), 2-layer gemma-2b models ("down" and "ssr",
     bf16 and W2A8) through the kernels against their reference routes with
     an artifact round trip (phase 3); drives the lockstep path (4 prompts x
     128 ids, 32 new tokens, bf16 and W2A8) and the ServeEngine (8 slots,
     max_len 2048, 16 greedy requests, bf16 and int8 KV, quantum 1) with
     exact launch counts (K2 GeGLU and K7 at hd 256 once per layer of each
     engine decode step), every answer held under its teacher-forced
     reference, a profiled decode step of each, and 8 POSTs through the
     ServingServer (12b, 12c); and times K2's GeGLU and silu instances at
     its MLP, K7 at its heads and K1's decode kernel at its projections
     (phase 6);
 13. (K3's decode slice) holds K3's decode rows, K1's split-K tensor-core
     GEMV with x staged through perm (csrc/ternary_matmul_dec.cu's
     pt2_ternary_matmul_dec_igathered, routed by k3_path where k1_path says
     "dec"), against ternary_matmul_igathered_plain and its own plain
     version ternary_matmul_igathered_dec_plain at llama-3-8b qkv, o and
     gateup, a ragged perm with interleaved pad lanes and a shape with
     uneven K slices, rows 1/2/4/8, bf16 and W2A8 (K1_DEC_A8 set), on
     packed[li] / perm[li] views at bs 128 and 256, with all-zero alpha
     blocks, an all-zero row and half-integer W2A8 rows, every call twice
     for identical bits, with exact launches / launches_dec counts, and the
     CUDA-core K3 at 16 / 64 rows, W2A8 decode rows and with the decode
     kernel off (13a, after 12a); every "ssr" lockstep run holds K3's
     launches: bf16 decode (default and P1) all on the decode path, W2A8
     all on the CUDA-core K3, P2 none; A/Bs, in turns (on, off;
     "off" rebinds K1_DEC_MAX_ROWS to 0), the lockstep llama-3-8b "ssr" bf16
     decode (decode tok/s, step wall, profiled device time; 13b, in phase
     5); and times the decode path through its C entry at 1/2/4/8 rows
     beside the CUDA-core K3 at 1-64 rows, the plain version, dense
     torch.matmul on the gathered x and the bytes bound (13d, in phase 6).
 14. (K3's rows 9-64) holds K3's tensor-core path, a one-pass gather into
     a fragment-order scratch then a split-K mma.sync product
     (csrc/ternary_matmul_igathered_tc.cu's pt2_ternary_matmul_igathered_tc,
     routed by k3_path for rows K1_TC_MIN_ROWS..64), against
     ternary_matmul_igathered_plain and its own plain version
     ternary_matmul_igathered_tc_plain at llama-3-8b qkv, o and gateup, a
     ragged perm with interleaved pad lanes, K in uneven slices, rows
     9/16/32/33/64, bf16 and W2A8, on packed[li] / perm[li] views at bs 128
     and 256, with all-zero alpha blocks and an all-zero row, every call
     twice for identical bits, exact launches / launches_tc counts, and its
     gather alone bit-exact against igathered_tc_gather_plain (14a, after
     13a; phase 2's 16-row K3 checks run it too, and 13a's CUDA-core K3
     checks at 16 / 64 rows run with it off); drives the 32-layer llama-3-8b
     "ssr" ServeEngine under the default flags (8 slots, max_len 2048, bf16
     KV, quantum 1) with 16 greedy requests of 9-64 ids (buckets 16, 32 and
     64), exact counts (per admission K3 2 x L on this path + K2 L; per
     decode step K3 2 x L on the decode path + K2 L + K7 L; no CUDA-core K3,
     no K1), every answer held to TOKEN_TOL, then an A/B over its first 8
     requests in two turns, on then off ("off" rebinds K1_TC_MIN_ROWS to 65:
     the admissions on the CUDA-core K3) with t_admit_s, tok/s, decode
     tok/s and the profiled device time of one 64-row admission (14b, after
     run E); and times the C entry and its
     gather alone at qkv and o, 16/32/64 rows, bf16 and W2A8, beside the
     CUDA-core K3, dense torch.matmul on the gathered x, K4 then K1's
     tensor-core kernel, the plain version and the bytes bound (14c, in
     phase 6).
 15. (K2's rows 9-64) holds K2's tensor-core path, K3's gather, a split-K
     mma.sync gate/up product whose CTAs pair each gate lane with its up
     lane and write mid = bf16(act(gate) * up) in the down product's
     fragment order, then K3's product over mid
     (csrc/ternary_mlp_tc.cu's pt2_ternary_mlp_tc, routed by k2_path for
     rows K2_TC_MIN_ROWS..64), against ternary_mlp_plain and its own plain
     version ternary_mlp_tc_plain at llama-3-8b's MLP (silu, with and
     without the gather) and gemma-2b's (GeGLU, without), rows 9/16/32/64,
     every call twice for identical bits, exact launches / launches_tc /
     launches_gelu counts (15a, after 14a; phase 2's 16- and 64-row K2
     checks run it too); holds launches_tc exact in every run that admits
     <= 64 rows (K2 L per admission); in "engine ssr default" admits one
     16-id and one 64-id prompt alone under torch.profiler in turns on,
     off, off, on ("off" rebinds K2_TC_MIN_ROWS to 1 << 30: the CUDA-core
     K2), counts exact (15b, in 14b, whose 8-request A/B runs with K2 on);
     and times the C entry at both MLPs, 16/32/64 rows, beside the
     CUDA-core K2 (in turns tc, CUDA cores, CUDA cores, tc), the two dense
     torch.matmul with the activation (a yardstick), the plain version and
     the bound, then its three kernels under torch.profiler (15c, in phase
     6).
 16. (K2's decode rows) holds K2's decode path, K1's split-K tensor-core
     GEMV over gateup with x staged through perm (the identity perm without
     a gather), the last CTA of each gate/up tile pair writing
     mid = bf16(act(gate) * up), then K1's decode kernel over mid
     (csrc/ternary_mlp_dec.cu's pt2_ternary_mlp_dec, routed by k2_path for
     rows 1..K2_DEC_MAX_ROWS), against ternary_mlp_plain and its own plain
     version ternary_mlp_dec_plain at llama-3-8b's MLP (silu, with and
     without the gather) and gemma-2b's (GeGLU, without), rows 1/2/4/8,
     every call twice for identical bits, exact launches / launches_dec /
     launches_gelu counts and none of K1's (16a, after 15a; phase 2's
     decode-row K2 checks run on it and again on the CUDA-core K2); holds
     launches_dec to exactly L per decode step in every 32- and 18-layer
     run, so the CUDA-core K2 launches in none of them but the "off" turns;
     in turns on, off ("off" rebinds K2_DEC_MAX_ROWS to 0: the
     CUDA-core K2) profiles one lockstep llama-3-8b "ssr" decode step at B 4
     beside 15 decode steps' tok/s (after 13b), and, in 2 turns, one engine
     decode step beside a short engine run's decode tok/s for llama-3-8b
     "down" (after 11c) and gemma-2b (in 12c), with K2's device time and
     share of each step (16b); and times the C entry at both MLPs, 1/2/4/8
     rows, beside the CUDA-core K2 (in turns decode path, CUDA cores, CUDA
     cores, decode path), the two dense torch.matmul with the activation
     (a yardstick), the plain version and the bound, its gate/up and down
     under torch.profiler and the wrapper's host time per call on either
     path (16c, in phase 6).
 17. (K6's rows 1-64 redesigned) holds K6's decode path, the plane gather
     (csrc/planes_gather.cuh) into lane order then K1's decode kernel as it
     is (csrc/ternary_matmul_gathered_dec.cu's
     pt2_ternary_matmul_gathered_dec, rows 1..K6_DEC_MAX_ROWS where k1_path
     says "dec"), and its tensor-core path, the plane gather into K3's
     fragment order with the block sums then K3's split-K product as it is
     (csrc/ternary_matmul_gathered_tc.cu's pt2_ternary_matmul_gathered_tc,
     rows K6_TC_MIN_ROWS..64, bf16 and W2A8), against
     ternary_matmul_gathered_plain and the path's own plain version at
     llama-3-8b qkv, o and gateup and a ragged perm, rows 1/2/4/8 and
     9/16/32/33/64, every call twice for identical bits, exact launches /
     launches_dec / launches_tc and none of K1's or K3's; the decode path on
     the same perm bit-identical to K1's decode kernel on onehot_gather's
     x, the tensor-core path within KERNEL_TOL of K3's; the plane gather
     alone bit-exact against planes_gather_plain in both orders (17a, after
     16a; phase 2c's K6 checks and phase 3's P2 model run on the new paths
     too); holds launches_dec / launches_tc exact in every P2 run (the
     lockstep decode at B 4 on the decode path, the engine's <= 64-row
     admissions on the tensor-core path and its B 8 steps on the decode
     path); in turns on, off ("off" rebinds K6_DEC_MAX_ROWS to 0
     and K6_TC_MIN_ROWS to 1 << 30: the CUDA-core K6) profiles one lockstep
     llama-3-8b "ssr" decode step under the P2 flags at B 4 beside 15 decode
     steps' tok/s, with K6's device time and share (17b, after phase 8's
     P2 runs); and times each path's C entry at llama-3-8b qkv and o, rows
     1/4/8/16/32/64, beside the CUDA-core K6, the plane gather alone, K3's
     path on the same perm, dense torch.matmul on the gathered x, the plain
     version and the bound, then its two kernels under torch.profiler
     (17c, in phase 6);
  9. (K5's rows path, csrc/onehot_matmul_rows.cu, at rows >= 16: the
     planes decoded once into a lane map, then x's rows staged in shared
     memory and gathered) holds the rows path bit for bit against its plain
     versions and against K4 at rows 16/64/65/128/256/512/1000, three perms'
     shapes, bf16
     and f32, the lane map against onehot_lane_map_plain, planes that are
     not a permutation against the plain version and within 1e-6 of x @ G,
     every call twice for the same bits, launches and launches_rows exact
     (18a, in phase 2c); holds launches_rows exact in every P1 / P2 run (the
     512-row prefills, run E's admissions above 64 rows); in turns on, off
     ("off" rebinds K5_ROWS_MIN_ROWS to 1 << 30: K5's first kernel)
     profiles one 512-row lockstep prefill of the llama-3-8b "ssr" (8 layers)
     model under the P1 flags: device time, K5's part and share, the wall
     (18b, after 17b); and times the rows path's C entry at 4096 -> 4096,
     rows 16/32/64/128/256/512, as calls replayed from a CUDA graph and as
     CUDA events, beside K5's first kernel in turns, the plain versions,
     torch.index_select and the bound, with both launches' device time under
     torch.profiler (18c, in phase 6, in place of K5's old timing).
 19. (K7 redesigned: csrc/decode_attention_tc.cu, every K7 call while
     attention.K7_TC holds: one launch per call whose CTAs find each row's
     last valid slot on the card, a ring of K/V tiles filled by TMA copies,
     scores and P.V on the tensor cores, a row's splits combined in a
     thread-block cluster) holds it against decode_attention_plain at
     ATTN_TOL and against decode_attention_split_plain on its own plan
     (k7_plan) within one bf16 step plus K7_SPLIT_TOL, every call twice for
     the same bits, launches / launches_tc exact, at phase 2b's shapes and
     with masks that have holes, keep only the last slot or leave a row
     empty (output 0), at llama-3-8b's, llama-2-7b's and gemma-2b's heads,
     bf16 and int8 KV; PR 3's kernel (K7_TC off) against the plain version
     as before (19a, in 2b); every engine run holds launches_tc to its K7
     launches; in turns on, off (K7_TC) profiles one llama-3-8b
     "down" engine decode step, bf16 and int8 KV: K7's device ms a step
     beside the bound of that step's valid slots, the step's device time and
     wall (19b, in the phase-11 engine step); and times both kernels through
     their C entries (CUDA events in turns and CUDA-graph replays) at B 8, M
     2048, every slot valid and at engine-like lengths (64-576 valid slots,
     the bound counting their bytes), beside the plain version, SDPA and the
     bound (19c, in phase 6).
 20. (K4's rows path, csrc/onehot_gather_rows.cu, from K4_ROWS_MIN_ROWS
     (1) rows: x's rows staged in shared memory by bulk copies, perm held in
     registers, 16-byte stores) holds the rows path bit for bit against its
     plain version and K4's first kernel at rows 2/5/16/65/128/512/1000, and
     K5 from 16, m 4096 / 8192 / 200 / 300, bf16 and f32, -0.0 and NaN payloads kept (against the
     plain version and the first kernel), on a perm[li] view and replayed
     from a CUDA graph capture, launches and launches_rows exact (20a, in
     phase 2c); holds launches_rows exact in every "ssr" run that gathers
     with K4 (phase 5's prefills, 13b, 16b); in turns on, off ("off"
     rebinds K4_ROWS_MIN_ROWS to 1 << 30: K4's first kernel) profiles one
     512-row lockstep prefill of the llama-3-8b "ssr" model (8 layers) under
     the default flags: the same logits bit for bit every turn, device time,
     K4's part and share, the wall; and once more greedy_generate with K4
     off, its tokens the main run's (20b, after 18b); and times both
     kernels' C entries at 4096 -> 4096, rows 1/16/64/128/256/512, as calls
     replayed from a CUDA graph in turns (rows, first, first, rows) and as
     CUDA events, beside torch.index_select (graph and events), the plain
     version and the bound, with each kernel's device time under
     torch.profiler (20c, in phase 6, in place of K4's old timing).
     For the run's time budget, settled A/Bs of earlier slices take fewer
     turns: 11b, 11c's engine runs and decode steps, 14b's request A/B,
     15b, 16b, 13b, 17b, 18b, 19b, 20b and phase 4's prefill A/B two (on,
     off; 13b, 15b, 17b and 18b since phase 23), and the lockstep paths run
     16 of the 32 layers: llama-2-7b
     in 4, 10b and 11b, llama-3-8b "ssr" in 5, 13b, 16b, 8, 17b, 18b and 20b.
 21. (the quantizer: core/ternary, core/ssr, quant/hessian, quant/gptq,
     quant/pipeline, data/) quantizes llama-3-8b at full width, cut to 2
     layers, dense bf16 weights from a torch.Generator, on the card from 32
     synthetic calibration windows of 512 ids with the default QuantConfig
     (SSR on down only, folded), launching no kernel: (a) prints the seconds
     of each tap's Hessian, each group's damped inverse and GPTQ and each
     layer beside the card's name and power limit; (b) quantizes layer 0's o
     again from the same W, H and H_inv on the card (the artifact's bytes,
     with ITF's stop test read on the host each iteration, as the port does,
     and every 8 iterations, in turns, timed) and on the CPU: >= QUANT_TWIN_CODES of the
     codes equal, the Hessian-weighted relative errors within QUANT_TWIN_ERR;
     (c) holds every group's relative output error finite and below 1; (d)
     round-trips the artifact through save_model / load_model bit for bit;
     (e) greedy_generate over it, 4 prompts x 128 ids, 16 new tokens, every
     K1 / K2 call held against its plain version, launches exact, logits and
     picks held against the plain route (LOGITS_REL_L2, TOKEN_TOL), then a
     ServeEngine answering 4 requests, every K1 / K2 / K7 call and answer
     held; (f) quantizes layer 0 again with ssr_scope "all" and serves it one
     512-row prefill (K4 x3 + K1 x4) and 8 decode steps (K3 x2 + K2), held
     the same way. The int8-KV engine run with K7 off (after 5b's answers)
     holds every K1 / K2 call against its plain version and its answers to
     INT8_K7_OFF_TOKEN_TOL. Since phase 22 its dense weights start as a
     local HuggingFace checkpoint (22d, below).
 22. (every dense family of the JAX registry) serves (a) qwen3-8b
     (qk-norm) at full width and 12 of its 36 layers (36 until phase 29
     was added), "down" layout: the
     lockstep path (4 x 128 ids, 16 new; K1 and K2 on every layer) and a
     ServeEngine (8 slots, max_len 2048, 8 requests of 64-512 ids, 32 new,
     bf16 KV; K7 at hd 128, 4 queries per KV head), launches exact (each
     family's routes written out in family_launches), every answer held to FAMILY_TOKEN_TOL under its
     teacher-forced plain reference, and a 2-layer full-width copy with every
     K1 / K2 / K7 call held against its plain version; (b) gemma3-4b
     (qk-norm, sandwich norms, a window of 1024 on 5 of each 6 layers with
     their own RoPE base, linear RoPE scaling 8 on the global ones, hd 256
     with 2 queries per KV head, vocab 262144) at full width cut to
     GEMMA3_HELD_LAYERS (6) of its 34 layers (since phase 26, which runs
     it at full depth on ring caches): the ServeEngine with bf16 and int8
     KV, two of its 8 requests 1100-1400 ids long (the window binds in the
     admission and in decode), launches exact, every K1 / K7 call and
     answer held (TOKEN_TOL); a 2-layer copy (both layers sliding) whose every K1 / K7
     call is held, every K7 call on a kv_valid whose window starts past
     slot 0 (K7 is also held on windows
     in 2b and timed on them in 6); (c) opt-1.3b, gpt2-xl (n = 1600: every K1
     call on its CUDA-core kernel) and bloom-560m (ALiBi) at full width cut
     to 2 layers: the lockstep path with every K1 call held, an artifact
     round trip, and a 4-request engine with every K1 call and answer held;
     each family's engine decode step profiled; (d) phase 21's llama-3-8b
     weights written as a 2-shard bf16 safetensors checkpoint with its
     config.json, loaded back through hf_loader host-resident (every tensor
     equal), and quantized by streaming its layers to the card.
 23. (mixture of experts: the router, the top-k and all-experts plans,
     K1s / K3s, the MoE quantizer) (a) holds K1s and K3s, K1's and K3's
     decode-row kernels with the expert index read from device memory
     (ternary_matmul_idx, ternary_matmul_igathered_idx: the decode kernel
     in bf16, and in W2A8 with K1_DEC_A8; the CUDA cores in W2A8), per call
     at mixtral-8x7b's and qwen3-30b-a3b's expert shapes, B 1, every slot
     of a stack, bit for bit against the view route and within KERNEL_TOL
     of the plain version; (b) serves mixtral-8x7b at full width and its 32
     layers ("down"): greedy_generate at batch 1 (128 ids + 32 new), bf16
     and W2A8, launches exact (a decode step adds 32 x 2 x 2 device-index
     launches and no host-index expert launch), _moe_mlp at one row under
     set_sync_debug_mode("error"), the answers held under the teacher-forced
     plain forward (bf16 at MIXTRAL_DEEP_TOL beside the plain route's own
     bf16-vs-f32 drift, printed; W2A8 at A8_TOLS' gap), a profiled decode
     step, and the same weights cut to 2 layers with every K1 / K1s call
     and answer held (TOKEN_TOL); (c) the same model at 8 of its 32 layers
     (since phase 29) in a ServeEngine (8
     slots, M 2048, 8 requests of 64-512 ids, 16 new since phase 26, bf16
     KV; all 8 experts a pass), K1 / K7 launches exact, every K7 call held, the
     answers held under one batched teacher-forced plain forward at
     MIXTRAL_DEEP_TOL, a profiled decode step, the 2-layer cut's engine (K7
     off) held at TOKEN_TOL; (d) mixtral cut to 2 layers "ssr" (K3s) and
     qwen3-30b-a3b cut to 4 of 48 layers: lockstep bf16 and W2A8 with every
     K1s / K3s call held, a 4-request engine (K7 off; mixtral's with every
     K1 / K3 / K4 call held), answers at TOKEN_TOL (qwen3-30b-a3b's engine
     at QWEN3_MOE_TOKEN_TOL); (e) quantizes one mixtral layer at
     full width (MOE_CALIB windows, the seconds of Hessians, damped
     inverses and GPTQ printed) and serves its artifact with every K1s call
     held; (f) times the four device-index kernels from CUDA graph replays
     beside the view route, the plain version, torch.matmul on the dense
     bf16 expert and the bytes bound. For K4s, K5s and K6s at a device
     index and K2's ungated mode: (a) also holds K4s (both kernels'
     routes), K5s and K6s per call at mixtral's gathered gateup and a
     1440-wide expert that K3 and K6 refuse, every slot of 2 x 4, the gather
     entries at B 1 and 4 bit for bit the view route's and their plain
     versions', the one-row route under the G4 (K4s, K1s), G5 (K5s, K1s)
     and P2 (K6s) flags bit for bit the view route's in bf16 and W2A8
     (K1_DEC_A8 off, on), K6s within KERNEL_TOL; and K2's ungated mode at
     opt-1.3b's and bloom-560m's MLP widths on its three paths, with and
     without a gather, silu / gelu / relu, within MLP_TOL; (d) also runs
     the 2-layer mixtral "ssr" cut under G4, G5 and P2 (_moe_mlp at one row
     under the sync check; lockstep batch 1, 128 ids + 16 new, bf16 and
     W2A8, launches exact, every K1 / K4 / K5 / K6 and device-index call
     held, answers held to the teacher-forced plain forward), once more under
     G4 with K4's rows path off, and a 2-layer opt-1.3b without biases whose
     up is stored as the fused MLP's gateup (K2's ungated mode through the
     decoder's fused branch, on each of its paths, every call held); (f)
     also times K4s, K5s, K6s and the ungated K2 from CUDA graph replays
     beside the view route (the device-index entries), the plain version,
     torch.index_select (K4s, K5s), torch.matmul on the gathered x (K6s) or
     two dense torch.matmul with the activation (K2), and the bound. (d)
     also runs the 2-layer mixtral "ssr" cut under a8 and floor8 (batch 1,
     32 ids + 4 new) under the default flags, K1_DEC_A8, P2 and P2 with
     K1_DEC_A8, every kernel launched equally by the two (K1s / K3s / K6s in
     their FLOOR instances). (The routers' top-k margins of its W2A8
     lockstep: scripts/torch_moe_router_margins.py.)
 24. (the floor probe, impl="floor8": W2A8 with the 2-bit unpack skipped,
     the raw packed bytes dotted; wrong by design, the same bytes, grids and
     launches) (a) holds every FLOOR instance (K1's decode GEMV, int8 tensor
     cores and CUDA cores; K3's and K6's decode, tensor-core and CUDA-core
     paths; K1s / K3s / K6s) against the floor's plain versions at
     llama-2-7b / llama-3-8b projections, B 1 / 8 / 16 / 64, within
     FLOOR_TOL, the device-index ones bit for bit the view route's; (b) runs
     the 2-layer llama-3-8b "ssr" model under a8 and floor8 (B 4 x 128 and
     B 1 x 40 ids, 8 new) under the default flags, K1_DEC_A8, P2 and P2 with
     K1_DEC_A8: every kernel launched equally by the two; (c) the floor A/B
     of scripts/torch_floor_ab.py, llama-2-7b "ssr" at full width and
     FLOOR_AB_LAYERS layers: ms/step under auto, a8 and floor8, and a8 /
     floor8 with K1_DEC_A8; (6) times every FLOOR instance from CUDA graphs
     beside its W2A8 instance and the bound.
 25. (K7 at hd 384 and 512, bf16 and int8 KV, on both of its kernels)
     (a) holds them per call at B 1 / 8, M 2048 (the tensor-core kernel as
     2b holds it); (b) serves 2-layer llama-3-8b copies with head_dim 384
     and 512 (ModelConfig.with_) in the ServeEngine, bf16 and int8 KV, and
     K7_TC off: K7 launched layers x steps times, every K7 call held, every
     answer at TOKEN_TOL; (6) times both kernels at B 8, M 2048.
 26. (ring KV caches, serve/ring.py) gemma3-4b at full width and its 34
     layers, sliding layers on 1024-slot rings: (a) ring_generate (2 x 1100
     ids, 8 new) and (b) the ServeEngine with make_ring_engine_fns (8
     slots, M 2048), launches exact, every K7 call held, every answer held to
     GEMMA3_DEEP_TOL under the teacher-forced flat plain route, one engine
     step profiled and timed, the ring's KV bytes beside the flat pool's;
     (c) the same engine cut to 6 layers with every K1 / K7 call held and the
     answers at TOKEN_TOL; (d) cut to 2 (both sliding), every K1 / K7 call
     held, each K7 over a 1024-slot ring; (e) a sampled generate pair equal
     under one seed; (6) times K7 on a 1024-slot ring from a CUDA graph.
 27. (K2's floor probe, fused_mlp_apply(impl="floor8"): x and mid rounded
     to int8, the raw packed bytes as codes; wrong by design) (a) direct
     calls at llama-3-8b's MLP ("ssr", with its gather) and gemma-2b's
     GeGLU ("down"), layer 1 of a 2-layer stack, rows 1 / 4 / 8 (decode
     path), 16 / 64 (tensor-core path), 1 / 8 on the CUDA-core kernel: each
     call on its path's FLOOR instance (launches exact), within MLP_TOL of
     ternary_mlp_floor_plain; (b) each instance timed through its C entry
     at llama-3-8b's MLP beside the bf16 instance of its path, in turns.
 28. (the paged engine, serve/paged.py) llama-3-8b "down" cut to 8 of its
     32 layers (32 before phase 31, the run's time budget), 5b's
     16 requests, 8 slots, M 2048, pages of 64, 80 pages: bf16 KV quantum 1,
     int8 KV quantum 1, bf16 KV quantum 8, each beside the flat engine:
     tokens and finish order equal, every page back after the drain,
     launches exact (K7 layers x steps on the gathered view); both pools'
     bytes; a profiled and timed step of each.
 29. (speculative decoding, serve/speculative.py and the engine's draft)
     llama-2-70b (40 of its 80 layers since phase 31, the run's time budget)
     under a llama-2-7b draft (32), "down", full
     width, bf16 KV, spec_k 4: (a) speculative_generate (128 ids + 16 new;
     32 before phase 31, the run's time budget)
     beside the 70b's greedy_generate, launches exact, answers at
     TOKEN_TOL; the 70b's decode step against its bytes bound; (b) the
     ServeEngine with the draft (4 slots, M 1024, 2 requests of 64-256 ids,
     4 before phase 31; 16 new) beside the plain engine, launches exact (verify rows on K1's and
     K2's tensor-core paths), answers at TOKEN_TOL; (c) a perfect draft (the
     7b cut to 2 layers as its own draft): the acceptance rate, not gated.
 30. (K7's wide instance, hd > 512: the width at run time, 16-position
     tiles, one CTA an SM) (a) both kernels per call at hd 640 / 768 / 1024,
     B 1 / 8, M 2048, bf16 and int8 KV (the tensor-core kernel held to the
     plain version, one bf16 step of its split plain version, its own bits
     run to run); (b) 2-layer llama-3-8b-width models with head_dim 640 and
     1024, 8 / 2 heads, in the ServeEngine (8 requests): K7 launched layers x
     steps times on the wide instance, every call held, every answer at
     TOKEN_TOL; (6) times both kernels at B 8, M 2048 beside SDPA.
 31. (tensor parallelism, parallel/tp.py) llama-3-8b at full width, "ssr",
     cut to 8 of its 32 layers, at TP 2: two gloo ranks on the one card
     (``chip_smoke.py --tp-rank``; the kernels built before they start, each
     rank with a timeout): tp_generate (4 x 128 ids + 16 new) and the TP
     engine (kv_heads, multihost, 4 slots, M 1024, 8 requests of 64-512 ids):
     both ranks' tokens equal, K1 / K3 / K5 / K7 launches non-zero and equal,
     a K5 call per rank bit for bit its plain version's, every answer at
     TOKEN_TOL under the single-process port's teacher-forced plain
     reference. A correctness run: gloo through the host gives no speed.

Every phase that fails makes the script exit non-zero. The last two lines
are the kernels' JSON record and the device JSON; the whole record is also
written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# llama-2-7b projections on the first slice's path: (name, K, n); down's K is
# 11008 padded to 96 scale blocks, gateup's n is 2 x 11264 after pad_gateup_blocks.
SHAPES = [("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22528), ("down", 12288, 4096)]
# K1 on the llama-3-8b paths besides o (prefill, W2A8 down, the "down" layout)
SHAPES_8B_K1 = [("8b qkv", 4096, 6144), ("8b gateup", 4096, 28672), ("8b down", 14336, 4096)]
# llama-3-8b gathered projections (name, m, K, n): K3 runs gateup in W2A8
# decode; only qkv and o are timed. Its MLP (D, I, n).
SHAPES_8B = [("qkv", 4096, 4096, 6144), ("o", 4096, 4096, 4096)]
GATEUP_8B = ("gateup", 4096, 4096, 28672)
MLP_8B = (4096, 14336, 4096)
KERNEL_TOL = 1e-4  # K1 / K3 vs plain, same bf16 inputs: f32 summation order only
# K2 vs plain: both round mid = silu(gate) * up to bf16, but gate/up differ in
# their last f32 bits, so a few mid values land on the neighbouring bf16.
MLP_TOL = 1e-3
LOGITS_REL_L2 = 1e-2  # model through the kernels vs plain route: bf16 activations round differently
TOKEN_TOL = 2e-2  # greedy pick must be a max of the plain logits within 2% of max |logit|
# W2A8 route vs the same route on plain versions (logits rel L2, pick gap):
# every row is cast to bf16 (a 0.5 grid above 64) and rounded to int8, so an
# f32 summation-order difference upstream moves a value by a whole int8
# step. The kernels themselves are held per call at KERNEL_TOL on the route.
A8_TOLS = (5e-2, 5e-2)
COLD_BYTES = 150e6  # timing operands rotate over more than the 50 MB L2
K1_ROWS = (1, 2, 4, 8, 12, 16, 64, 128, 512)  # K1's timed rows: decode, then prefill
# K7 vs plain: the kernel rounds the unnormalised probabilities to bf16
# relative to each chunk's maximum, the plain version relative to the row's
# global maximum, so a p may land on the neighbouring bf16.
ATTN_TOL = 1e-2
# K7's tensor-core kernel vs decode_attention_split_plain, which follows its
# schedule: past one bf16 step of each value (two roundings of the same f32
# sum can land on neighbouring bf16s), the f32 summation order only
K7_SPLIT_TOL = 1e-3
ENGINE_M = 2048  # the engine's max_len (the JAX package's default)
# gemma-2b (the GeGLU slice): its projections (name, K, n) with qkv's
# (8 + 2 x 1) heads of 256, its MLP (D, I, n) and its heads (H, Hkv, hd)
SHAPES_GEMMA = [("g qkv", 2048, 2560), ("g o", 2048, 2048), ("g gateup", 2048, 32768),
                ("g down", 16384, 2048)]
MLP_GEMMA = (2048, 16384, 2048)
HEADS_GEMMA = (8, 1, 256)
HEADS_GEMMA3 = (8, 4, 256)  # gemma3-4b's (H, Hkv, hd)
# gemma-2b's 18-layer bf16 answers vs the teacher-forced plain forward: on
# an H100 (scripts/torch_pick_gaps_by_route.py) the lockstep route that never
# launches K2 (FUSED_MLP off: K1 alone) and the one with K2's plain version
# in its place trail that reference by up to 2.2e-2 of max|logit|, and the
# engine's answers by up to 3.7e-2 on every route, those without K2 and
# without K7 included: at this model's depth bf16 rounding flips from any f32
# summation order reach past TOKEN_TOL. So its answers are held to A8_TOLS'
# pick gap, as the W2A8 answers are for the same reason, the lockstep route
# without K2 is measured beside them, and every K2 GeGLU and K7 call of
# 18-layer runs is held against its plain version (MLP_TOL, ATTN_TOL)
GEMMA_TOKEN_TOL = A8_TOLS[1]
# The 32-layer llama-3-8b "down" engine's int8-KV answers with K7 off (the
# plain int8 route; every K1 and K2 call of that run is held against its
# plain version): with the int8 cache's scales the correctly rounded
# quotient (JAX's bytes), one pick on an H100 trailed its teacher-forced
# reference by 3 bf16 steps of max|logit| (2.098e-2 > TOKEN_TOL, in four
# runs), and one ulp of the scales changed 13 of its 16 streams, while over
# 6 other request sets the same route stayed within 2 steps under either
# scale (scripts/torch_pick_gaps_by_route.py --engine --kv-int8 --routes
# k7_off): bf16 flips from f32 summation order at 32 random layers, on a
# route that runs no int8 kernel. So these answers are held to A8_TOLS' pick
# gap, as gemma-2b's and the W2A8 answers are for the same reason
INT8_K7_OFF_TOKEN_TOL = A8_TOLS[1]
# the quantizer's calibration in phase 21: 32 windows of 512 ids (the CLI's
# default is 128 x 2048)
QUANT_CALIB = (32, 512)
# phase 21 (b): layer 0's o quantized on the card and, from the same W, H and
# H_inv, on the CPU: f32 products in other orders move a code only at a
# near-tie and the rest of its row after it, so at least 99 % of the codes
# agree and the two Hessian-weighted relative errors lie within 5 % of each other
QUANT_TWIN_CODES = 0.99
QUANT_TWIN_ERR = 0.05
# phase 22: the qwen3-8b (12 of 36 layers) and gemma3-4b (6 of 34 layers)
# engines' answers vs their teacher-forced plain forwards
FAMILY_TOKEN_TOL = TOKEN_TOL
# gemma3-4b's answers (phase 22b): with random weights its bf16 routes
# drift apart with depth, in the JAX package as in the port (on the CPU at
# full width and 8 layers both packages' bf16 logits sit 0.12 relative L2
# from their own f32 ones, and the port's f32 logits within 1e-5 of JAX's:
# tests/test_torch_families_depth.py). On an H100 at 34 layers the plain
# bf16 route's own picks trailed the same route in f32 by 0.74-0.81 of
# max|logit| (22b prints it each run). So the full-depth answers, bf16 and
# int8 KV, are held to that noise's reach, GEMMA3_DEEP_TOL, and the same
# weights cut to GEMMA3_HELD_LAYERS layers are held to TOKEN_TOL with every
# K1 and K7 call held against its plain version
GEMMA3_HELD_LAYERS = 6
GEMMA3_DEEP_TOL = 1.0
# phase 24: the floor probe's FLOOR instances against the floor's plain
# versions (integer dots exact on both sides; the f32 epilogue in another
# order, of outputs far larger than a product's), and the floor A/B's depth,
# new tokens and rounds (scripts/torch_floor_ab.py; the run's time budget)
FLOOR_TOL = 1e-5
FLOOR_AB_LAYERS, FLOOR_AB_NEW, FLOOR_AB_ROUNDS = 8, 32, 2
# phase 25: the head widths above 256 that K7 is built for
WIDE_HEAD_DIMS = (384, 512)
# K7's wide instance (the width at run time, hd > 512): phase 30's widths
WIDE_RT_HEAD_DIMS = (640, 768, 1024)
# phase 31: llama-3-8b at full width, "ssr", cut to 8 of its 32 layers, on
# two gloo ranks of one card (NCCL takes one rank a card); a rank that has
# not answered within TP_RANK_TIMEOUT_S fails the phase
TP_LAYERS = 8
TP_SEED = 31
TP_RANK_TIMEOUT_S = 300
# phase 26: a gemma3-4b sliding layer's ring (its window)
RING_SLOTS = 1024
# phase 23: the experts' shapes held per call (name, out, in, perm layout):
# mixtral-8x7b's gateup and down ("down" layout), its gateup with a gather
# ("ssr": K3s), qwen3-30b-a3b's gateup and down (768 lanes padded to 2048)
MOE_SHAPES = [("mixtral gateup", 28672, 4096, "identity"), ("mixtral down", 4096, 14336, "folded"),
              ("mixtral gateup ssr", 28672, 4096, "ssr"), ("qwen3-moe gateup", 1536, 2048, "identity"),
              ("qwen3-moe down", 2048, 768, "folded")]
# the quantizer's calibration in phase 23e: 16 windows of 512 ids
MOE_CALIB = (16, 512)
# mixtral-8x7b's 32-layer bf16 answers (phase 23b, 23c) vs their teacher-
# forced plain forwards: with random routers a bf16 rounding upstream of a
# router can swap an expert (their k-th and (k+1)-th weights often lie
# within 1e-3), and a swapped expert moves a token's state by a whole
# expert's output: on an H100 at 2 layers K7's rounding of P (within
# ATTN_TOL of its plain version) swapped one expert of one engine row
# (weights 2.3e-3 and 6.3e-4 apart) and moved that row's picks by 0.386 of
# max|logit|. So the full-depth answers are held to that reach, as
# gemma3-4b's are (GEMMA3_DEEP_TOL), beside the plain route's own bf16
# drift from f32, printed; the same weights cut to 2 layers hold TOKEN_TOL
# on routes whose every call is held (the engines there with K7 off: the
# plain attention of the teacher-forced reference), and K7 is held per
# call in the 8-layer engine
MIXTRAL_DEEP_TOL = 1.0
# qwen3-30b-a3b (128 experts, 8 a token) in phase 23d's engine: its 8th and
# 9th routing weights (each near 1/128) often lie within the f32-order noise
# of K1's kernels, so a swapped expert moves a pick by whole bf16 steps even
# at 4 layers (2.04e-2 of max|logit| on an H100 with every K1 call held; its
# lockstep held TOKEN_TOL); held to A8_TOLS' gap, as gemma-2b's are. Its
# engine holds no call (every pass runs all 128 experts: 1024 K1 calls a
# decode step, 20 s of plain versions); its lockstep holds every K1s call
QWEN3_MOE_TOKEN_TOL = A8_TOLS[1]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(memory bytes/s, bf16 dense op/s, int8 dense op/s) from the data sheet."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 989e12, 1979e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 756e12, 1513e12
    if "H100" in n and "NVL" in n:
        return 3.9e12, 835e12, 1671e12
    if "H100" in n:
        return 3.35e12, 989e12, 1979e12
    fail(f"no data-sheet peaks for {name}")


def kernel_rows(prof):
    """(device ms, count, name) of each kernel in a torch.profiler run, most
    time first (kernels only: CPU ops also carry the device time they
    launched)."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dt > 0:
            rows.append((dt / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


# the kernels of K2's decode rows, by the part of the profile they stand
# for: the decode path's gate/up, K1's decode kernel (the decode path's
# down, and K1's qkv and o in the "down" layout), the CUDA-core K2 and its
# partial sum
K2_PARTS = {"gateup": "mlp_dec_gateup_kernel", "dec_kernel": "ternary_matmul_dec_kernel<false, false>",
            "cuda_core": "ternary_mlp_kernel", "cuda_core_sum": "sum_partials_kernel"}


def k2_parts(rows):
    """Device ms of each of K2_PARTS in a profile's kernel rows."""
    return {k: sum(r[0] for r in rows if pat in r[2]) for k, pat in K2_PARTS.items()}


# the kernels of K6's rows 1-64, by the part of the profile they stand for:
# the plane gather, K1's decode kernel (the decode path's product, and K2's
# decode path's down), K3's product (the tensor-core path's), the CUDA-core
# K6 and its chunk sum
K6_PARTS = {"gather": "planes_gather_kernel", "dec_kernel": "ternary_matmul_dec_kernel<false, false>",
            "tc_product": "igathered_tc_kernel", "cuda_core": "::gathered_kernel<",
            "cuda_core_sum": "chunk_sum_kernel"}


def k6_parts(rows):
    """Device ms of each of K6_PARTS in a profile's kernel rows."""
    return {k: sum(r[0] for r in rows if pat in r[2]) for k, pat in K6_PARTS.items()}


# the kernels of K5, by the part of the profile they stand for: the rows
# path's lane map and its rows kernel, and K5's first kernel
K5_PARTS = {"lane_map": "onehot_rows::lane_map_kernel", "rows": "onehot_rows::rows_kernel",
            "cuda_core": "onehot_matmul_kernel"}


def k5_parts(rows):
    """Device ms of each of K5_PARTS in a profile's kernel rows."""
    return {k: sum(r[0] for r in rows if pat in r[2]) for k, pat in K5_PARTS.items()}


# the kernels of K4, by the part of the profile they stand for: its rows
# path and its first kernel
K4_PARTS = {"rows": "gather_rows::gather_rows_kernel", "cuda_core": "onehot_gather_kernel"}


def k4_parts(rows):
    """Device ms of each of K4_PARTS in a profile's kernel rows."""
    return {k: sum(r[0] for r in rows if pat in r[2]) for k, pat in K4_PARTS.items()}


def profile_decode_step(cfg, params, prompts, Lp, new, dev, label, impl="auto"):
    """Where one decode step's time goes (bf16, or W2A8 with impl "a8"): its
    wall time (unprofiled, host clock around a synchronised step) against the
    device time that torch.profiler attributes to kernels in a second,
    profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pt2tpu_torch.serve.generate import forward_cached
    from pt2tpu_torch.serve.kvcache import init_cache

    B = prompts.shape[0]
    tok = prompts[:, :1].contiguous()
    with torch.inference_mode():
        cache = init_cache(cfg, B, Lp + new, device=dev)
        forward_cached(cfg, params, prompts, cache, 0, impl)
        forward_cached(cfg, params, tok, cache, Lp, impl)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward_cached(cfg, params, tok, cache, Lp + 1, impl)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward_cached(cfg, params, tok, cache, Lp + 2, impl)
            torch.cuda.synchronize()
    rows = kernel_rows(prof)
    device_ms = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy": device_ms / wall_ms if wall_ms else 0.0, "k2_parts": k2_parts(rows),
           "k6_parts": k6_parts(rows),
           "top": [{"ms": ms, "count": c, "name": k[:90]} for ms, c, k in rows[:8]]}
    print(f"one decode step, {label} (B={B}, {cfg.n_layers} layers, {impl}): wall {wall_ms:.2f} "
          f"ms, "
          f"device time {device_ms:.2f} ms (busy {100 * out['device_busy']:.1f} %; profiler)")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:4d}  {t['name']}")
    if not rows:
        print("  torch.profiler saw no device time")
    return out


def profile_engine_admission(eng, prompt, label):
    """One engine admission of ``prompt`` alone (max_new 1: no decode step)
    under torch.profiler, after an unprofiled one timed on the host clock:
    its wall time, device time and the kernels that took it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.submit(prompt, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    eng.submit(prompt, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    device_ms = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "top": [{"ms": ms, "count": c, "name": k[:90]} for ms, c, k in rows[:6]]}
    print(f"one engine admission of {len(prompt)} ids, {label}: wall {wall_ms:.2f} ms, device "
          f"time {device_ms:.2f} ms (profiler)")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:4d}  {t['name']}")
    if not rows:
        print("  torch.profiler saw no device time")
    return out


def profile_engine_step(eng, label):
    """One engine decode step (quantum 1, every slot active) under
    torch.profiler: device time by kernel and K7's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    device_ms = sum(r[0] for r in rows)
    k7_ms = sum(r[0] for r in rows if "decode_attention" in r[2])
    out = {"device_ms": device_ms, "k7_ms": k7_ms,
           "k7_share": k7_ms / device_ms if device_ms else 0.0, "k2_parts": k2_parts(rows),
           "top": [{"ms": ms, "count": c, "name": k[:90]} for ms, c, k in rows[:8]]}
    print(f"one engine decode step, {label} (B=8, M=2048): device time {device_ms:.2f} ms, "
          f"K7 {k7_ms:.3f} ms = {100 * out['k7_share']:.1f} % (profiler)")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:4d}  {t['name']}")
    if not rows:
        print("  torch.profiler saw no device time")
    return out


def tp_prompts(cfg, dev):
    """Phase 31's inputs, drawn alike by each rank and by the reference: 4 x
    128 ids for tp_generate, then 8 engine prompts of 64-512 ids."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(TP_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device=dev)
    lens = torch.randint(64, 513, (8,), generator=gen, device=dev).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).cpu().numpy()
               for n in lens]
    return prompt, prompts


def tp_rank_main(argv) -> None:
    """One rank of phase 31 (``chip_smoke.py --tp-rank RANK PORT OUT``): a
    gloo world of two ranks on cuda:0. Builds llama-3-8b at full width, "ssr",
    TP_LAYERS layers, from TP_SEED, keeps its shard (prepare_tp_params,
    shard_tp_params), then with every kernel count set to 0 just before and
    read just after: tp_generate (4 x 128 ids + 16 new) and the TP engine
    (kv_heads of the rank, multihost, 4 slots, M 1024, 8 requests submitted
    on rank 0, 16 new). Its first K5 call is held bit for bit to K5's plain
    version on the rank's own activations. Writes OUT/tp31_rank<RANK>.json."""
    rank, port, out = int(argv[0]), int(argv[1]), argv[2]
    import torch

    sys.path.insert(0, ROOT)
    from pt2tpu_torch.models.registry import get_config
    from pt2tpu_torch.ops.kernels import attention as k7
    from pt2tpu_torch.ops.kernels import gather as k4
    from pt2tpu_torch.ops.kernels import ternary as k1
    from pt2tpu_torch.parallel import mesh, tp
    from pt2tpu_torch.serve.engine import ServeEngine
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh.initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2, timeout_s=TP_RANK_TIMEOUT_S / 2)
    axis = mesh.make_mesh({"data": 1, "model": 2})["model"]
    cfg = get_config("llama-3-8b").with_(n_layers=TP_LAYERS)
    full = random_ternary_params(cfg, seed=TP_SEED, perm_mode="ssr", device=dev)
    shard = tp.shard_tp_params(tp.prepare_tp_params(cfg, full, axis.size), axis)
    del full
    torch.cuda.empty_cache()
    wrappers = {"K1": k1.ternary_matmul, "K3": k1.ternary_matmul_igathered,
                "K5": k4.onehot_matmul, "K7": k7.decode_attention, "K4": k4.onehot_gather,
                "K2": k1.ternary_mlp}

    def zero():
        for w in wrappers.values():
            w.launches = 0
        tp.collective_stats.update(all_reduce=0, all_gather=0, seconds=0.0)

    def read():
        return {k: w.launches for k, w in wrappers.items()}

    k5_check = {}
    k5 = tp.onehot_matmul

    def k5_held(x, planes):
        got = k5(x, planes)
        if not k5_check:
            want = k4.onehot_matmul_plain(x, planes)
            torch.cuda.synchronize()
            k5_check.update(rows=int(x.shape[0]), lanes=int(planes.shape[-1]),
                            equal=bool(torch.equal(got, want)))
        return got

    tp.onehot_matmul = k5_held
    prompt, prompts = tp_prompts(cfg, dev)
    res = {"rank": rank, "backend": axis.backend, "world": 2}
    with torch.inference_mode():
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = tp.tp_generate(cfg, axis, shard, prompt, 16, max_len=144)
        torch.cuda.synchronize()
        res["generate_s"] = time.perf_counter() - t0
        res["generate_launches"] = read()
        res["generate_collectives"] = dict(tp.collective_stats)
        res["generate"] = toks.cpu().tolist()
        pf, df = tp.make_tp_engine_fns(cfg, axis, shard)
        eng = ServeEngine(cfg, shard, max_batch=4, max_len=1024,
                          kv_heads=cfg.kv_heads // axis.size, prefill_fn=pf, decode_fn=df,
                          multihost=True)
        reqs = [eng.submit(p_, 16) for p_ in prompts] if rank == 0 else []
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        res["engine_s"] = time.perf_counter() - t0
        res["engine_launches"] = read()
        res["engine_collectives"] = dict(tp.collective_stats)
        res["engine_stats"] = {k: float(v) for k, v in eng.stats.items()}
        done = reqs if rank == 0 else sorted(eng.finished, key=lambda r: r.uid)
        res["engine"] = [list(map(int, r.out)) for r in done]
    res["k5_check"] = k5_check
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out, f"tp31_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def tp_phase(dev, get_config, random_ternary_params, answers_held):
    """Phase 31: tensor parallelism at 2 ranks on the card. The kernels are
    built already (by the parent's start-up); two ranks (``--tp-rank``) run
    over gloo, both on cuda:0, each with TP_RANK_TIMEOUT_S to answer. Holds:
    both ranks' tokens equal; every answer within TOKEN_TOL of the
    single-process port's teacher-forced plain reference on the same weights;
    each rank's K1 / K3 / K5 (and in the engine K7) launches non-zero and
    equal between the ranks; each rank's first K5 call bit for bit its plain
    version's. The gloo run checks correctness only: its times are no speed
    figure of tensor parallelism. Returns the record."""
    import socket

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    for r in (0, 1):
        path = os.path.join(out, f"tp31_rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               str(port), out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=ROOT) for r in (0, 1)]
    problems = []
    try:
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=max(1.0, TP_RANK_TIMEOUT_S
                                                   - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                problems.append(f"rank {r} did not answer within {TP_RANK_TIMEOUT_S} s")
                break
            if p.returncode != 0:
                problems.append(f"rank {r} exit {p.returncode}: {log[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if problems:
        fail("31 " + "; ".join(problems))
    wall = time.perf_counter() - t0
    res = []
    for r in (0, 1):
        with open(os.path.join(out, f"tp31_rank{r}.json")) as f:
            res.append(json.load(f))
    for key in ("generate", "engine"):
        if res[0][key] != res[1][key]:
            fail(f"31 the ranks' {key} tokens differ")
    for key, names in (("generate_launches", ("K1", "K3", "K5")),
                       ("engine_launches", ("K1", "K3", "K5", "K7"))):
        if res[0][key] != res[1][key]:
            fail(f"31 the ranks' {key} differ: {res[0][key]} / {res[1][key]}")
        idle = [k for k in names if not res[0][key][k]]
        if idle:
            fail(f"31 {key}: no launch of {idle}")
    for r_ in res:
        if not r_["k5_check"].get("equal"):
            fail(f"31 rank {r_['rank']}: K5's call {r_['k5_check']} is not its plain version's bits")
    cfg = get_config("llama-3-8b").with_(n_layers=TP_LAYERS)
    params = random_ternary_params(cfg, seed=TP_SEED, perm_mode="ssr", device=dev)
    prompt, prompts = tp_prompts(cfg, dev)
    worst_g = answers_held("31 tp_generate answers", cfg, params, list(prompt.cpu().numpy()),
                           res[0]["generate"], False, TOKEN_TOL)
    worst_e = answers_held("31 TP engine answers", cfg, params, prompts, res[0]["engine"], False,
                           TOKEN_TOL)
    del params
    torch.cuda.empty_cache()
    steps = res[0]["engine_stats"]["steps"]
    rec = {"wall_s": wall, "layers": TP_LAYERS, "backend": res[0]["backend"],
           "worst_pick_gap": {"generate": worst_g, "engine": worst_e},
           "collective_s_per_engine_step": res[0]["engine_collectives"]["seconds"] / max(steps, 1),
           "ranks": [{k: v for k, v in r_.items() if k not in ("generate", "engine")}
                     for r_ in res]}
    for r_ in res:
        print(f"31 rank {r_['rank']} ({r_['backend']}, both ranks on cuda:0): tp_generate 4 x 128 "
              f"+ 16 in {r_['generate_s']:.2f} s, launches {r_['generate_launches']}, collectives "
              f"{r_['generate_collectives']}; TP engine (kv_heads {cfg.kv_heads // 2}, multihost, "
              f"4 slots, M 1024, 8 requests) {r_['engine_stats']['steps']:.0f} steps in "
              f"{r_['engine_s']:.2f} s, launches {r_['engine_launches']}, collectives "
              f"{r_['engine_collectives']}; K5 held bit for bit {r_['k5_check']}; peak "
              f"{r_['max_memory_gb']:.2f} GB")
    print(f"31 llama-3-8b \"ssr\" ({TP_LAYERS} of 32 layers) at TP 2: both ranks' tokens equal, "
          f"launches equal; picks within {worst_g:.2e} (tp_generate) / {worst_e:.2e} (engine) of "
          f"the single-process teacher-forced plain max (<= {TOKEN_TOL}); collectives "
          f"{rec['collective_s_per_engine_step'] * 1e3:.2f} ms of host time an engine step (gloo "
          f"through the host: a correctness run, no speed figure); phase wall {wall:.1f} s on "
          f"{smi()}")
    return rec


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from pt2tpu_torch.models.registry import get_config
        from pt2tpu_torch.ops.kernels import _build
        from pt2tpu_torch.ops.kernels import attention as k7
        from pt2tpu_torch.ops.kernels import gather as k4
        from pt2tpu_torch.ops.kernels import ternary as k1
    except ImportError as e:
        fail(f"the pt2tpu_torch package is not beside this script ({e})")
    from pt2tpu_torch.core.packing import pack_ternary
    from pt2tpu_torch.serve.generate import forward_cached, greedy_generate
    from pt2tpu_torch.serve.kvcache import init_cache
    from pt2tpu_torch.utils import checkpoint as ckpt
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"smi": smi(), "device": torch.cuda.get_device_name(0)}
    print(f"card: {record['smi']} | torch: {record['device']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    bw, bf16_peak, int8_peak = card_peaks(record["device"])
    t_start = time.perf_counter()
    record["phase_start_s"] = {}

    def stamp(phase):
        """The seconds since start-up at which ``phase`` begins, printed."""
        record["phase_start_s"][phase] = time.perf_counter() - t_start
        print(f"chip_smoke: phase {phase} begins at {record['phase_start_s'][phase]:.1f} s")

    # launch counters of every kernel wrapper: K1, K3, K2, K4, K7, K5, K6
    wrappers = {"ternary_matmul": k1.ternary_matmul,
                "ternary_matmul_igathered": k1.ternary_matmul_igathered,
                "ternary_mlp": k1.ternary_mlp, "onehot_gather": k4.onehot_gather,
                "decode_attention": k7.decode_attention, "onehot_matmul": k4.onehot_matmul,
                "ternary_matmul_gathered": k1.ternary_matmul_gathered,
                "ternary_matmul_idx": k1.ternary_matmul_idx,
                "ternary_matmul_igathered_idx": k1.ternary_matmul_igathered_idx,
                "ternary_matmul_gathered_idx": k1.ternary_matmul_gathered_idx,
                "onehot_gather_idx": k4.onehot_gather_idx, "onehot_matmul_idx": k4.onehot_matmul_idx}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        k1.ternary_matmul.launches_tc = k1.ternary_matmul.launches_tc_a8 = 0
        k1.ternary_matmul.launches_dec = k1.ternary_matmul_igathered.launches_dec = 0
        k1.ternary_matmul_igathered.launches_tc = k1.ternary_mlp.launches_tc = 0
        k1.ternary_mlp.launches_dec = 0
        k1.ternary_mlp.launches_gelu = k7.decode_attention.launches_hd256 = 0
        k7.decode_attention.launches_tc = 0
        k1.ternary_matmul_gathered.launches_dec = k1.ternary_matmul_gathered.launches_tc = 0
        k4.onehot_matmul.launches_rows = k4.onehot_gather.launches_rows = 0
        k1.ternary_matmul_idx.launches_dec = k1.ternary_matmul_igathered_idx.launches_dec = 0
        k1.ternary_matmul_gathered_idx.launches_dec = k4.onehot_gather_idx.launches_rows = 0
        k1.ternary_mlp.launches_ungated = k1.ternary_mlp.launches_floor = 0
        for w in (k1.ternary_matmul, k1.ternary_matmul_igathered, k1.ternary_matmul_gathered,
                  k1.ternary_matmul_idx, k1.ternary_matmul_igathered_idx,
                  k1.ternary_matmul_gathered_idx):
            w.launches_floor = 0
        k7.decode_attention.launches_wide = 0

    def counts():
        """Every wrapper's launches; K1's bf16 and int8 tensor-core launches
        and its decode launches (also in "ternary_matmul") apart as
        "ternary_matmul_tc", "ternary_matmul_tc_a8" and "ternary_matmul_dec";
        K3's decode and tensor-core launches (also in
        "ternary_matmul_igathered") apart as "ternary_matmul_igathered_dec"
        and "ternary_matmul_igathered_tc"; K2's decode and tensor-core
        launches, its GeGLU launches (any path) and K7's at hd 256 apart as
        "ternary_mlp_dec", "ternary_mlp_tc", "ternary_mlp_gelu" and
        "decode_attention_hd256"; K7's on its tensor-core kernel (also in
        "decode_attention") as "decode_attention_tc"; K6's decode and
        tensor-core launches (also
        in "ternary_matmul_gathered") apart as "ternary_matmul_gathered_dec"
        and "ternary_matmul_gathered_tc"; K5's and K4's rows-path launches
        (also in "onehot_matmul" and "onehot_gather") apart as
        "onehot_matmul_rows" and "onehot_gather_rows"; K1s's and K3s's
        (the device-index entries, counted apart from K1 and K3) on the
        decode kernel (also in "ternary_matmul_idx" and
        "ternary_matmul_igathered_idx") as "ternary_matmul_idx_dec" and
        "ternary_matmul_igathered_idx_dec"; K6s's on its decode path and
        K4s's on its rows path (also in "ternary_matmul_gathered_idx" and
        "onehot_gather_idx") as "ternary_matmul_gathered_idx_dec" and
        "onehot_gather_idx_rows"; K2's ungated launches (any path) as
        "ternary_mlp_ungated". K2's decode path's down launch is K2's, not
        one of K1's. The floor probe's launches of K1, K3, K6, K1s, K3s and
        K6s (also in their wrappers' counts) as "<wrapper>_floor", K2's (any
        path, also in "ternary_mlp") as "ternary_mlp_floor"; K7's at hd 384
        and 512 (also in "decode_attention") as "decode_attention_wide"."""
        c = {name: w.launches for name, w in wrappers.items()}
        c["ternary_matmul_tc"] = k1.ternary_matmul.launches_tc
        c["ternary_matmul_tc_a8"] = k1.ternary_matmul.launches_tc_a8
        c["ternary_matmul_dec"] = k1.ternary_matmul.launches_dec
        c["ternary_matmul_igathered_dec"] = k1.ternary_matmul_igathered.launches_dec
        c["ternary_matmul_igathered_tc"] = k1.ternary_matmul_igathered.launches_tc
        c["ternary_mlp_tc"] = k1.ternary_mlp.launches_tc
        c["ternary_mlp_dec"] = k1.ternary_mlp.launches_dec
        c["ternary_mlp_gelu"] = k1.ternary_mlp.launches_gelu
        c["decode_attention_hd256"] = k7.decode_attention.launches_hd256
        c["decode_attention_tc"] = k7.decode_attention.launches_tc
        c["ternary_matmul_gathered_dec"] = k1.ternary_matmul_gathered.launches_dec
        c["ternary_matmul_gathered_tc"] = k1.ternary_matmul_gathered.launches_tc
        c["onehot_matmul_rows"] = k4.onehot_matmul.launches_rows
        c["onehot_gather_rows"] = k4.onehot_gather.launches_rows
        c["ternary_matmul_idx_dec"] = k1.ternary_matmul_idx.launches_dec
        c["ternary_matmul_igathered_idx_dec"] = k1.ternary_matmul_igathered_idx.launches_dec
        c["ternary_matmul_gathered_idx_dec"] = k1.ternary_matmul_gathered_idx.launches_dec
        c["onehot_gather_idx_rows"] = k4.onehot_gather_idx.launches_rows
        c["ternary_mlp_ungated"] = k1.ternary_mlp.launches_ungated
        c["ternary_mlp_floor"] = k1.ternary_mlp.launches_floor
        for name in ("ternary_matmul", "ternary_matmul_igathered", "ternary_matmul_gathered",
                     "ternary_matmul_idx", "ternary_matmul_igathered_idx",
                     "ternary_matmul_gathered_idx"):
            c[f"{name}_floor"] = wrappers[name].launches_floor
        c["decode_attention_wide"] = k7.decode_attention.launches_wide
        return c

    run_totals = dict.fromkeys(counts(), 0)  # launches over every run counted exactly
    gelu_paths = {"ternary_mlp_tc": 0, "ternary_mlp_dec": 0}  # of them, GeGLU ones by K2's path

    def tally(c):
        for k, v in c.items():
            run_totals[k] += v
        if c["ternary_mlp_gelu"]:  # a gemma-2b run: every K2 launch is GeGLU
            for k in gelu_paths:
                gelu_paths[k] += c[k]

    # ---- build every kernel (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    sources = ["ternary_matmul", "ternary_mlp", "onehot_gather", "decode_attention",
               "onehot_matmul", "ternary_matmul_gathered", "ternary_matmul_tc",
               "ternary_matmul_tc_a8", "ternary_matmul_dec", "ternary_matmul_igathered_tc",
               "ternary_mlp_tc", "ternary_mlp_dec", "ternary_matmul_gathered_dec",
               "ternary_matmul_gathered_tc", "onehot_matmul_rows", "decode_attention_tc",
               "onehot_gather_rows", "ternary_mlp_floor"]
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(src):
        t_ = time.perf_counter()
        return _build.build(src), time.perf_counter() - t_

    with ThreadPoolExecutor(len(sources)) as ex:
        libs, secs = zip(*ex.map(timed_build, sources))
    record["build_s"] = time.perf_counter() - t0
    record["build_s_by_source"] = dict(zip(sources, secs))
    print(f"built {len(sources)} sources in parallel in {record['build_s']:.1f} s: "
          + ", ".join(f"{src} {t_:.1f} s" for src, t_ in zip(sources, secs)))
    for src, so in zip(sources, libs):
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {src}:", line.strip())

    stamp("1")
    # ---- 1. K1 vs its plain version at the llama-2-7b shapes
    g = torch.Generator(device=dev).manual_seed(0)

    def rand_layer(K, n, L=None, gen=None):
        gen = gen or g
        lead = () if L is None else (L,)
        codes = torch.randint(-1, 2, lead + (n, K), generator=gen, device=dev, dtype=torch.int8)
        packed = (pack_ternary(codes) if L is None
                  else torch.stack([pack_ternary(c) for c in codes]))
        nb = K // 128
        alpha = ((0.8 + 0.4 * torch.rand(lead + (nb, n), generator=gen, device=dev))
                 / math.sqrt(K)).bfloat16()
        mu = (0.02 / math.sqrt(K) * torch.randn(lead + (nb, n), generator=gen, device=dev)
              ).bfloat16()
        return packed, alpha, mu

    def rand_perm(m, K, interleave=False, gen=None):
        """Visit lanes over m features padded to K lanes with m; with
        ``interleave`` the pad lanes sit among the valid ones."""
        gen = gen or g
        perm = torch.cat([torch.randperm(m, generator=gen, device=dev),
                          torch.full((K - m,), m, device=dev)])
        if interleave:
            perm = perm[torch.randperm(K, generator=gen, device=dev)]
        return perm.to(torch.int32)

    # the gemma slice's draws come from their own generator, so that every
    # earlier phase draws what it drew before the slice was added
    ggem = torch.Generator(device=dev).manual_seed(12)

    @contextlib.contextmanager
    def k1_dec(on):
        """K1's decode rows on the decode kernel in bf16 and W2A8 (on:
        K1_DEC_A8 set), or on the CUDA-core kernel in both (off:
        K1_DEC_MAX_ROWS rebound to 0). Outside it, bf16 decode rows take the
        decode kernel and W2A8 ones the CUDA cores."""
        saved = k1.K1_DEC_MAX_ROWS, k1.K1_DEC_A8
        if on:
            k1.K1_DEC_A8 = True
        else:
            k1.K1_DEC_MAX_ROWS = 0
        try:
            yield
        finally:
            k1.K1_DEC_MAX_ROWS, k1.K1_DEC_A8 = saved

    @contextlib.contextmanager
    def k3_tc(on):
        """K3's rows 9-64 on its tensor-core path as routed (on), or on the
        CUDA-core K3 (off: K1_TC_MIN_ROWS rebound to 65, which also sends
        K1's rows 9-64 to its CUDA cores)."""
        saved = k1.K1_TC_MIN_ROWS
        if not on:
            k1.K1_TC_MIN_ROWS = 65
        try:
            yield
        finally:
            k1.K1_TC_MIN_ROWS = saved

    @contextlib.contextmanager
    def k2_tc(on):
        """K2's rows 9-64 on its tensor-core path as routed (on), or on the
        CUDA-core K2 (off: K2_TC_MIN_ROWS rebound to 1 << 30)."""
        saved = k1.K2_TC_MIN_ROWS
        if not on:
            k1.K2_TC_MIN_ROWS = 1 << 30
        try:
            yield
        finally:
            k1.K2_TC_MIN_ROWS = saved

    @contextlib.contextmanager
    def k2_dec(on):
        """K2's decode rows on its decode path as routed (on), or on the
        CUDA-core K2 (off: K2_DEC_MAX_ROWS rebound to 0)."""
        saved = k1.K2_DEC_MAX_ROWS
        if not on:
            k1.K2_DEC_MAX_ROWS = 0
        try:
            yield
        finally:
            k1.K2_DEC_MAX_ROWS = saved

    @contextlib.contextmanager
    def k6_paths(on):
        """K6's rows 1-64 on its decode and tensor-core paths as routed (on),
        or on the CUDA-core K6 (off: K6_DEC_MAX_ROWS rebound to 0 and
        K6_TC_MIN_ROWS to 1 << 30)."""
        saved = k1.K6_DEC_MAX_ROWS, k1.K6_TC_MIN_ROWS
        if not on:
            k1.K6_DEC_MAX_ROWS, k1.K6_TC_MIN_ROWS = 0, 1 << 30
        try:
            yield
        finally:
            k1.K6_DEC_MAX_ROWS, k1.K6_TC_MIN_ROWS = saved

    @contextlib.contextmanager
    def k5_rows(on):
        """K5's rows from K5_ROWS_MIN_ROWS on its rows path as routed (on), or
        on K5's first kernel (off: K5_ROWS_MIN_ROWS rebound to 1 << 30)."""
        saved = k4.K5_ROWS_MIN_ROWS
        if not on:
            k4.K5_ROWS_MIN_ROWS = 1 << 30
        try:
            yield
        finally:
            k4.K5_ROWS_MIN_ROWS = saved

    @contextlib.contextmanager
    def k4_rows(on):
        """K4's rows from K4_ROWS_MIN_ROWS on its rows path as routed (on), or
        on K4's first kernel (off: K4_ROWS_MIN_ROWS rebound to 1 << 30)."""
        saved = k4.K4_ROWS_MIN_ROWS
        if not on:
            k4.K4_ROWS_MIN_ROWS = 1 << 30
        try:
            yield
        finally:
            k4.K4_ROWS_MIN_ROWS = saved

    def k2_dec_ab_summary(label, res):
        """16b's turns ({"dec": [...], "cuda_core": [...]}, each a profiled
        step with k2_parts): K2's device time per step, the decode path's
        gate/up plus its down (K1's decode kernel's time in an "on" turn less
        its mean over the "off" turns, where it runs K1's decode rows alone)
        or the CUDA-core K2 with its partial sum, and its share of the
        step's device time; printed with the step's wall and decode tok/s."""
        off = [r["k2_parts"]["dec_kernel"] for r in res["cuda_core"]]
        k1_dec_ms = sum(off) / len(off)
        for k, rows in res.items():
            for r in rows:
                p = r["k2_parts"]
                r["k2_ms"] = (p["gateup"] + p["dec_kernel"] - k1_dec_ms if k == "dec"
                              else p["cuda_core"] + p["cuda_core_sum"])
                r["k2_share"] = r["k2_ms"] / r["device_ms"] if r["device_ms"] else 0.0
        for k, rows in res.items():
            def each(key, scale=1.0, rows=rows):
                return " / ".join(f"{scale * r[key]:.2f}" for r in rows)

            print(f"K2 decode A/B, {label}, K2's decode rows on "
                  f"{'its decode path' if k == 'dec' else 'the CUDA cores'} (turns "
                  f"{'on, off' if len(rows) == 1 else 'on, off, off, on'}): step device time "
                  f"{each('device_ms')} ms, K2 {each('k2_ms')} ms "
                  f"({each('k2_share', 100.0)} %), step wall {each('step_wall_ms')} ms, decode "
                  f"{each('decode_tok_s')} tok/s on {record['smi']}")
        return res

    # K1's CUDA-core kernel; its tensor-core kernels' in tc_err, a8_err, its
    # decode kernel's in dec_err
    max_err = 0.0
    checks = 0
    tc_err, tc_checks = 0.0, 0
    a8_err, a8_checks = 0.0, 0
    dec_err, dec_checks = 0.0, 0
    for name, K, n in SHAPES + SHAPES_8B_K1:
        packed, alpha, mu = rand_layer(K, n)
        for B in (1, 2, 4, 16, 512):
            x = torch.randn((B, K), generator=g, device=dev).bfloat16()
            for a8 in (False, True):
                for dec_on in ((True, False) if B <= 8 else (True,)):  # decode rows: both kernels
                    with k1_dec(dec_on):
                        got = k1.ternary_matmul(x, packed, alpha, mu, a8=a8)
                        path = k1.k1_path(B, n, 128, a8)
                    plain = k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain
                    want = plain(x, packed, alpha, mu)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    if not (err <= KERNEL_TOL * scale) or got.shape != want.shape:
                        fail(f"K1 {name} B={B} a8={a8} path {path}: max|err| {err:.3e} > "
                             f"{KERNEL_TOL} x max|ref| {scale:.3e}")
                    if path == "tc":
                        tc_err = max(tc_err, err)
                    elif path == "tc_a8":
                        a8_err = max(a8_err, err)
                    elif path == "dec":
                        dec_err = max(dec_err, err)
                        dec_checks += 1
                    else:
                        max_err = max(max_err, err)
                    checks += 1
    packed, alpha, mu = rand_layer(4096, 4096, L=2)
    x = torch.randn((16, 4096), generator=g, device=dev).bfloat16()
    for li in (0, 1):
        got = k1.ternary_matmul(x, packed[li], alpha[li], mu[li])
        want = k1.ternary_matmul_plain(x, packed[li], alpha[li], mu[li])
        err = (got - want).abs().max().item()
        if not err <= KERNEL_TOL * want.abs().max().item():
            fail(f"K1 on packed[{li}] view: max|err| {err:.3e}")
        tc_err = max(tc_err, err)
        checks += 1
    record["k1_checks"] = checks
    record["k1_max_abs_err"] = max_err
    print(f"K1 vs plain: {checks} checks (7 shapes x B 1/2/4/16/512 x bf16/a8, B <= 4 with the "
          f"decode kernel on and off, + 2 stacked views) within {KERNEL_TOL} x max|ref|; max|err| "
          f"{max_err:.3e} (CUDA cores: decode rows with the decode kernel off), {dec_err:.3e} "
          f"(decode kernel: bf16 and W2A8 at 1/2/4 rows), {tc_err:.3e} (tensor cores: bf16 at 16 "
          f"and 512 rows), {a8_err:.3e} (int8 tensor cores: W2A8 at 16 and 512 rows)")
    del packed, alpha, mu, x

    stamp("1b")
    # ---- 1b. K1's tensor-core path vs the plain version: the llama-2-7b and
    # llama-3-8b shapes at prefill row counts, a stacked view, all-zero alpha
    # blocks; launches_tc must rise by exactly one per call it routes. Its
    # own generator leaves the later phases' draws as they were
    gt = torch.Generator(device=dev).manual_seed(7)

    def k1_counts():
        return (k1.ternary_matmul.launches, k1.ternary_matmul.launches_tc,
                k1.ternary_matmul.launches_tc_a8, k1.ternary_matmul.launches_dec)

    def tc_held(label, x, packed, alpha, mu, path="tc", a8=False, bs=128):
        """One K1 call, held against the plain version; launches, launches_tc,
        launches_tc_a8 and launches_dec must rise by exactly what ``path``
        implies."""
        nonlocal tc_err, tc_checks, a8_err, a8_checks, dec_err, dec_checks, max_err, cc_checks
        c0 = k1_counts()
        got = k1.ternary_matmul(x, packed, alpha, mu, bs, a8=a8)
        want = (k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain)(x, packed, alpha, mu,
                                                                                bs)
        torch.cuda.synchronize()
        rise = tuple(b - a for a, b in zip(c0, k1_counts()))
        if rise != (1, int(path == "tc"), int(path == "tc_a8"), int(path == "dec")):
            fail(f"K1 {label}: launches / tensor-core / int8 tensor-core / decode rose by {rise}, "
                 f"path {path}")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not (err <= KERNEL_TOL * scale) or got.shape != want.shape:
            fail(f"K1 {label}: max|err| {err:.3e} > {KERNEL_TOL} x max|ref| {scale:.3e}")
        if path == "tc":
            tc_err = max(tc_err, err)
            tc_checks += 1
        elif path == "tc_a8":
            a8_err = max(a8_err, err)
            a8_checks += 1
        elif path == "dec":
            dec_err = max(dec_err, err)
            dec_checks += 1
        else:
            max_err = max(max_err, err)
            cc_checks += 1
        return got

    cc_checks = 0  # 8-row calls on the CUDA-core kernel (the decode A/Bs' "off" turns)
    if not 8 < k1.K1_TC_MIN_ROWS <= 16 or k1.K1_DEC_MAX_ROWS != 8:
        fail(f"K1_TC_MIN_ROWS {k1.K1_TC_MIN_ROWS}, K1_DEC_MAX_ROWS {k1.K1_DEC_MAX_ROWS}: the "
             "checks below expect 8 rows on the decode kernel and 16 on the tensor cores")
    for name, K, n in SHAPES + SHAPES_8B_K1:
        packed, alpha, mu = rand_layer(K, n, gen=gt)
        for B in (16, 17, 64, 100, 128, 512, 1024):
            x = torch.randn((B, K), generator=gt, device=dev).bfloat16()
            tc_held(f"tc {name} rows={B}", x, packed, alpha, mu)
        # W2A8 at 512 rows takes the int8 tensor cores; decode rows the
        # decode kernel, or with it off the CUDA-core kernel
        x = torch.randn((512, K), generator=gt, device=dev).bfloat16()
        tc_held(f"{name} rows=512 a8", x, packed, alpha, mu, path="tc_a8", a8=True)
        tc_held(f"{name} rows=8", x[:8], packed, alpha, mu, path="dec")
        with k1_dec(False):
            tc_held(f"{name} rows=8, decode kernel off", x[:8], packed, alpha, mu,
                    path="cuda_core")
    packed, alpha, mu = rand_layer(4096, 4096, L=2, gen=gt)
    x = torch.randn((512, 4096), generator=gt, device=dev).bfloat16()
    for li in (0, 1):
        tc_held(f"tc packed[{li}] view", x, packed[li], alpha[li], mu[li])
    # all-zero alpha (and mu) blocks, as the pad blocks of a padded layer
    packed, alpha, mu = rand_layer(12288, 4096, gen=gt)
    alpha[::3] = 0
    mu[::6] = 0
    x = torch.randn((100, 12288), generator=gt, device=dev).bfloat16()
    tc_held("tc zero-alpha blocks (down)", x, packed, alpha, mu)
    record["k1_tc_checks"] = tc_checks
    record["k1_tc_max_abs_err"] = tc_err
    print(f"K1 tensor-core path vs plain: {tc_checks} checks (7 shapes x rows "
          f"16/17/64/100/128/512/1024 + 2 stacked views + zero-alpha blocks) within {KERNEL_TOL} x "
          f"max|ref|; max|err| {tc_err:.3e}; launches_tc exact, none for W2A8 or 8 rows (which "
          f"take the decode kernel, or with it off the CUDA cores: {cc_checks} checks, max|err| "
          f"{max_err:.3e} with phase 1's)")
    del packed, alpha, mu, x

    stamp("10a")
    # ---- 10a. K1's int8 tensor-core path (W2A8) vs ternary_matmul_plain_a8:
    # the same shapes from the fewest rows it takes, stacked views, all-zero
    # alpha blocks, an all-zero row (sx's floor) and rows whose normalised
    # values are half-integers (rounded half to even); launches_tc_a8 exact
    # on every call, none for decode rows. Its own generator, as 1b's
    ga8 = torch.Generator(device=dev).manual_seed(8)
    a8_checks_before = a8_checks

    def tie_rows(B, K):
        """Random rows, an all-zero row 1, and rows 2 and 3 whose normalised
        values are half-integers: row 2 holds +-127 and half-integers
        (sx = 1), row 3 is that times 0.25 (sx = 0.25, x / sx exact)."""
        x = torch.randn((B, K), generator=ga8, device=dev)
        x[1] = 0
        x[2] = torch.randint(-127, 127, (K,), generator=ga8, device=dev) + 0.5
        x[2, 5], x[2, 9] = 127.0, -127.0
        x[3] = 0.25 * x[2]
        return x.bfloat16()

    for name, K, n in SHAPES + SHAPES_8B_K1:
        packed, alpha, mu = rand_layer(K, n, gen=ga8)
        for B in (9, 16, 17, 64, 100, 128, 512, 1024):
            x = torch.randn((B, K), generator=ga8, device=dev).bfloat16()
            tc_held(f"tc_a8 {name} rows={B}", x, packed, alpha, mu, path="tc_a8", a8=True)
        x = torch.randn((8, K), generator=ga8, device=dev).bfloat16()
        with k1_dec(True):
            tc_held(f"{name} rows=8 a8", x, packed, alpha, mu, path="dec", a8=True)
        with k1_dec(False):
            tc_held(f"{name} rows=8 a8, decode kernel off", x, packed, alpha, mu,
                    path="cuda_core", a8=True)
    packed, alpha, mu = rand_layer(4096, 4096, L=2, gen=ga8)
    x = tie_rows(300, 4096)
    xn, _ = k1.normalize_rows_a8(x)
    ties = int((xn.float().frac().abs() == 0.5).sum().item())
    if ties < 2 * (4096 - 2):
        fail(f"tc_a8 tie rows: only {ties} normalised values on .5")
    for li in (0, 1):
        got = tc_held(f"tc_a8 packed[{li}] view, zero row, ties", x, packed[li], alpha[li], mu[li],
                      path="tc_a8", a8=True)
        if got[1].abs().max().item() != 0.0:
            fail("tc_a8: the all-zero row's output is not 0")
    packed, alpha, mu = rand_layer(12288, 4096, gen=ga8)
    alpha[::3] = 0
    mu[::6] = 0
    x = tie_rows(100, 12288)
    tc_held("tc_a8 zero-alpha blocks (down), zero row, ties", x, packed, alpha, mu, path="tc_a8",
            a8=True)
    record["k1_tc_a8_checks"] = a8_checks - a8_checks_before
    record["k1_tc_a8_max_abs_err"] = a8_err
    print(f"K1 int8 tensor-core path vs plain (W2A8): {a8_checks - a8_checks_before} checks (7 "
          f"shapes x rows 9/16/17/64/100/128/512/1024 + 2 stacked views + zero-alpha blocks, "
          f"with an all-zero row and {ties} half-integer values) within {KERNEL_TOL} x max|ref|; "
          f"max|err| "
          f"{a8_err:.3e} (phase 1 included); launches_tc_a8 exact, none for 8 rows; CUDA-core "
          f"kernel at 8 rows: {cc_checks} checks with 1b's, max|err| {max_err:.3e} with phase 1's")
    del packed, alpha, mu, x, xn

    stamp("11a")
    # ---- 11a. K1's decode kernel vs the plain versions: rows 1/2/4/8 at the
    # llama-2-7b and llama-3-8b shapes, bf16 and W2A8, each call twice for
    # identical bits (its split-K sums run in a fixed order); stacked views,
    # all-zero alpha blocks, an all-zero row and half-integer W2A8 rows, bs
    # 256, and K slices that divide the blocks unevenly (7b qkv: 32 blocks in
    # slices of 7; 7b gateup: of 11); launches_dec exact on every call. Its
    # own generator, as 1b's
    gd = torch.Generator(device=dev).manual_seed(9)
    dec_checks_before = dec_checks
    with k1_dec(True):  # W2A8 decode rows too
        uneven = 0
        for name, K, n in SHAPES + SHAPES_8B_K1:
            packed, alpha, mu = rand_layer(K, n, gen=gd)
            splits = k1.dec_splits(K, n, 128, k1.dec_wave(dev))
            uneven += (K // 128) % -(-(K // 128) // splits) != 0  # the last slice is shorter
            for B in (1, 2, 4, 8):
                x = torch.randn((B, K), generator=gd, device=dev).bfloat16()
                for a8 in (False, True):
                    got = tc_held(f"dec {name} rows={B} a8={a8}", x, packed, alpha, mu, path="dec",
                                  a8=a8)
                    again = tc_held(f"dec {name} rows={B} a8={a8} again", x, packed, alpha, mu,
                                    path="dec", a8=a8)
                    if not torch.equal(got, again):
                        fail(f"K1 decode {name} rows={B} a8={a8}: two calls differ in their bits")
        if uneven < 2:
            fail(f"K1 decode: only {uneven} shapes with uneven K slices")
        x = tie_rows(8, 4096)
        for bs in (128, 256):
            if bs == 128:
                packed, alpha, mu = rand_layer(4096, 4096, L=2, gen=gd)
            else:
                codes = torch.randint(-1, 2, (2, 4096, 4096), generator=gd, device=dev,
                                      dtype=torch.int8)
                packed = torch.stack([pack_ternary(c, 256) for c in codes])
                alpha = ((0.8 + 0.4 * torch.rand((2, 16, 4096), generator=gd, device=dev)) / 64
                         ).bfloat16()
                mu = (0.02 / 64 * torch.randn((2, 16, 4096), generator=gd, device=dev)).bfloat16()
            for li in (0, 1):
                for a8 in (False, True):
                    got = tc_held(f"dec packed[{li}] bs {bs} a8={a8}, zero row, ties", x,
                                  packed[li], alpha[li], mu[li], path="dec", a8=a8, bs=bs)
                    if got[1].abs().max().item() != 0.0:
                        fail("K1 decode: the all-zero row's output is not 0")
        packed, alpha, mu = rand_layer(12288, 4096, gen=gd)
        alpha[::3] = 0
        mu[::6] = 0
        x = tie_rows(8, 12288)
        for B in (1, 8):
            for a8 in (False, True):
                tc_held(f"dec zero-alpha blocks (down) rows={B} a8={a8}", x[:B], packed, alpha, mu,
                        path="dec", a8=a8)
    record["k1_dec_checks"] = dec_checks
    record["k1_dec_max_abs_err"] = dec_err
    print(f"K1 decode kernel vs plain: {dec_checks - dec_checks_before} checks in 11a (7 shapes x "
          f"rows 1/2/4/8 x bf16/a8, each twice with identical bits; {uneven} shapes with uneven K "
          f"slices; stacked views at bs 128 and 256 with an all-zero row and half-integer rows; "
          f"zero-alpha blocks), {dec_checks} with phases 1, 1b and 10a, within {KERNEL_TOL} x "
          f"max|ref|; max|err| {dec_err:.3e}; launches_dec exact")
    del packed, alpha, mu, x

    stamp("12a")
    # ---- 12a. K1's four kernels at the gemma-2b projections (qkv's n = 2560
    # is a column count no llama shape has): rows 1/2/4/8 on the decode
    # kernel (bf16 and W2A8) and on the CUDA cores (decode kernel off),
    # 16/64/512 on the bf16 and int8 tensor cores; launches, launches_tc,
    # launches_tc_a8 and launches_dec exact on every call. Its own generator
    gg = torch.Generator(device=dev).manual_seed(10)
    g_before = tc_checks + a8_checks + dec_checks + cc_checks
    for name, K, n in SHAPES_GEMMA:
        packed, alpha, mu = rand_layer(K, n, gen=gg)
        for B in (1, 2, 4, 8):
            x = torch.randn((B, K), generator=gg, device=dev).bfloat16()
            for a8 in (False, True):
                with k1_dec(True):
                    tc_held(f"gemma dec {name} rows={B} a8={a8}", x, packed, alpha, mu,
                            path="dec", a8=a8)
                with k1_dec(False):
                    tc_held(f"gemma {name} rows={B} a8={a8}, CUDA cores", x, packed, alpha, mu,
                            path="cuda_core", a8=a8)
        for B in (16, 64, 512):
            x = torch.randn((B, K), generator=gg, device=dev).bfloat16()
            tc_held(f"gemma tc {name} rows={B}", x, packed, alpha, mu)
            tc_held(f"gemma tc_a8 {name} rows={B}", x, packed, alpha, mu, path="tc_a8", a8=True)
    record["k1_gemma_checks"] = tc_checks + a8_checks + dec_checks + cc_checks - g_before
    print(f"K1 at the gemma-2b projections (qkv 2048 -> 2560, o, gateup 2048 -> 32768, down "
          f"16384 -> 2048): {record['k1_gemma_checks']} checks (rows 1/2/4/8 on the decode "
          f"kernel and the CUDA cores, bf16 and W2A8; 16/64/512 on the bf16 and int8 tensor "
          f"cores) within {KERNEL_TOL} x max|ref|, every launch count exact; max|err| with the "
          f"earlier phases: decode {dec_err:.3e}, CUDA cores {max_err:.3e}, tc {tc_err:.3e}, "
          f"tc_a8 {a8_err:.3e}")
    del packed, alpha, mu, x

    stamp("13a")
    # ---- 13a. K3's decode rows (K1's decode kernel with x staged through
    # perm) vs both plain versions: the llama-3-8b K3 shapes (qkv, o,
    # gateup), a ragged perm with interleaved pad lanes in one K slice and one
    # in uneven slices, rows 1/2/4/8, bf16 and W2A8 (K1_DEC_A8 set), each
    # call twice for identical bits; packed[li] / perm[li] views, all-zero
    # alpha blocks, an all-zero row and half-integer W2A8 rows; the CUDA-core
    # K3 at 16 / 64 rows, at W2A8 decode rows (K1_DEC_A8 off) and with the
    # decode kernel off (and the tensor-core path off at 16 / 64 rows);
    # launches, launches_dec and launches_tc exact on every call. Its own
    # generator, as 1b's
    gk3 = torch.Generator(device=dev).manual_seed(13)
    k3dec_err, k3dec_algo_err, k3dec_checks, k3cc_err, k3cc_checks = 0.0, 0.0, 0, 0.0, 0
    k3tc_err, k3tc_algo_err, k3tc_checks = 0.0, 0.0, 0

    def k3_counts():
        return (k1.ternary_matmul_igathered.launches, k1.ternary_matmul_igathered.launches_dec,
                k1.ternary_matmul_igathered.launches_tc, k1.ternary_matmul.launches)

    def k3_held(label, x, perm, packed, alpha, mu, path="dec", a8=False, bs=128):
        """One K3 call (two on the decode and tensor-core paths, which must
        give the same bits) held against ternary_matmul_igathered_plain, the
        decode path also against ternary_matmul_igathered_dec_plain, the
        tensor-core path against ternary_matmul_igathered_tc_plain;
        launches, launches_dec and launches_tc must rise by exactly what
        ``path`` implies."""
        nonlocal k3dec_err, k3dec_algo_err, k3dec_checks, k3cc_err, k3cc_checks
        nonlocal k3tc_err, k3tc_algo_err, k3tc_checks
        if k1.k3_path(x.shape[0], packed.shape[1], bs, a8) != path:
            fail(f"K3 {label}: k3_path is not {path}")
        calls = 1 if path == "cuda_core" else 2
        c0 = k3_counts()
        got = k1.ternary_matmul_igathered(x, perm, packed, alpha, mu, bs, a8=a8)
        again = (k1.ternary_matmul_igathered(x, perm, packed, alpha, mu, bs, a8=a8)
                 if calls == 2 else got)
        want = k1.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, bs, a8)
        torch.cuda.synchronize()
        rise = tuple(b - a for a, b in zip(c0, k3_counts()))
        if rise != (calls, calls if path == "dec" else 0, calls if path == "tc" else 0, 0):
            fail(f"K3 {label}: launches / decode / tensor-core / K1 launches rose by {rise}, "
                 f"path {path}")
        if not torch.equal(got, again):
            fail(f"K3 {label}: two calls differ in their bits")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not (err <= KERNEL_TOL * scale) or got.shape != want.shape:
            fail(f"K3 {label}: max|err| {err:.3e} > {KERNEL_TOL} x max|ref| {scale:.3e}")
        if path == "dec":
            algo = k1.ternary_matmul_igathered_dec_plain(x, perm, packed, alpha, mu, bs, a8,
                                                         wave=k1.dec_wave(dev))
            aerr = (got - algo).abs().max().item()
            if not aerr <= KERNEL_TOL * scale:
                fail(f"K3 {label}: max|err| {aerr:.3e} against the decode path's plain version")
            k3dec_err, k3dec_algo_err = max(k3dec_err, err), max(k3dec_algo_err, aerr)
            k3dec_checks += 1
        elif path == "tc":
            algo = k1.ternary_matmul_igathered_tc_plain(x, perm, packed, alpha, mu, bs, a8,
                                                        wave=k1.igtc_wave(dev))
            aerr = (got - algo).abs().max().item()
            if not aerr <= KERNEL_TOL * scale:
                fail(f"K3 {label}: max|err| {aerr:.3e} against the tensor-core path's plain "
                     f"version")
            k3tc_err, k3tc_algo_err = max(k3tc_err, err), max(k3tc_algo_err, aerr)
            k3tc_checks += 1
        else:
            k3cc_err = max(k3cc_err, err)
            k3cc_checks += 1
        return got

    def k3_rows(B, m, gen=gk3):
        """Random bf16 rows; from 4 rows on, row 1 all zero (W2A8: sx's
        floor), row 2 +-127 and half-integers, row 3 that times 0.25."""
        x = torch.randn((B, m), generator=gen, device=dev)
        if B >= 4:
            x[1] = 0
            x[2] = torch.randint(-127, 127, (m,), generator=gen, device=dev) + 0.5
            x[2, 5], x[2, 9] = 127.0, -127.0
            x[3] = 0.25 * x[2]
        return x.bfloat16()

    k3_uneven = 0
    with k1_dec(True):  # W2A8 decode rows too
        for name, m, K, n in SHAPES_8B + [GATEUP_8B, ("ragged", 200, 256, 256),
                                          ("uneven", 600, 640, 128)]:
            packed, alpha, mu = rand_layer(K, n, gen=gk3)
            perm = rand_perm(m, K, m < K, gen=gk3)
            nb = K // 128
            k3_uneven += nb % -(-nb // k1.dec_splits(K, n, 128, k1.dec_wave(dev))) != 0
            for B in (1, 2, 4, 8):
                x = k3_rows(B, m)
                for a8 in (False, True):
                    got = k3_held(f"dec {name} rows={B} a8={a8}", x, perm, packed, alpha, mu,
                                  a8=a8)
                    if B >= 4 and got[1].abs().max().item() != 0.0:
                        fail(f"K3 decode {name}: the all-zero row's output is not 0")
        if k3_uneven < 1:
            fail("K3 decode: no shape with uneven K slices")
        # packed[li] / perm[li] views of a 2-layer stack at bs 128 and 256,
        # all-zero alpha (and mu) blocks
        m, K, n = 4000, 4096, 4096
        x = k3_rows(8, m)
        for bs in (128, 256):
            codes = torch.randint(-1, 2, (2, n, K), generator=gk3, device=dev, dtype=torch.int8)
            packed = torch.stack([pack_ternary(c, bs) for c in codes])
            alpha = ((0.8 + 0.4 * torch.rand((2, K // bs, n), generator=gk3, device=dev)) / 64
                     ).bfloat16()
            mu = (0.02 / 64 * torch.randn((2, K // bs, n), generator=gk3, device=dev)).bfloat16()
            perms = torch.stack([rand_perm(m, K, True, gen=gk3) for _ in range(2)])
            for li in (0, 1):
                for a8 in (False, True):
                    k3_held(f"dec packed[{li}] bs {bs} a8={a8}", x, perms[li], packed[li],
                            alpha[li], mu[li], a8=a8, bs=bs)
        packed, alpha, mu = rand_layer(K, n, gen=gk3)
        alpha[::3] = 0
        mu[::6] = 0
        for B in (1, 8):
            for a8 in (False, True):
                k3_held(f"dec zero-alpha blocks rows={B} a8={a8}", x[:B], perms[0], packed, alpha,
                        mu, a8=a8)
    # the CUDA-core K3: rows 16 / 64 with the tensor-core path off, W2A8
    # decode rows as routed (K1_DEC_A8 off), and bf16 decode rows with the
    # decode kernel off
    for name, m, K, n in SHAPES_8B:
        packed, alpha, mu = rand_layer(K, n, gen=gk3)
        perm = rand_perm(m, K, gen=gk3)
        for B in (16, 64):
            x = k3_rows(B, m)
            for a8 in (False, True):
                with k3_tc(False):
                    k3_held(f"{name} rows={B} a8={a8}", x, perm, packed, alpha, mu, "cuda_core",
                            a8)
        x = k3_rows(4, m)
        k3_held(f"{name} rows=4 a8", x, perm, packed, alpha, mu, "cuda_core", True)
        with k1_dec(False):
            k3_held(f"{name} rows=4, decode kernel off", x, perm, packed, alpha, mu, "cuda_core")
    record["k3_dec_checks"] = k3dec_checks
    record["k3_dec_max_abs_err"] = k3dec_err
    record["k3_dec_max_abs_err_vs_dec_plain"] = k3dec_algo_err
    print(f"K3 decode path vs plain: {k3dec_checks} checks (5 shapes x rows 1/2/4/8 x bf16/a8, "
          f"{k3_uneven} with uneven K slices, + stacked views at bs 128 and 256 + zero-alpha "
          f"blocks), each called twice with identical bits, within {KERNEL_TOL} x max|ref| of "
          f"ternary_matmul_igathered_plain (max|err| {k3dec_err:.3e}) and of its own plain "
          f"version (max|err| {k3dec_algo_err:.3e}); CUDA-core K3: {k3cc_checks} checks (rows "
          f"16/64 with the tensor-core path off, W2A8 rows 4, decode kernel off) max|err| "
          f"{k3cc_err:.3e}; launches and launches_dec exact")
    del packed, alpha, mu, x, perm, perms, codes

    stamp("14a")
    # ---- 14a. K3's rows 9-64 on its tensor-core path (the one-pass gather,
    # then the split-K mma.sync product) vs both plain versions: the
    # llama-3-8b K3 shapes (qkv's 32 blocks in uneven slices of 7 x 4 + 4),
    # a ragged perm with interleaved pad lanes, rows 9/16/32/33/64, bf16 and
    # W2A8, each call twice for identical bits; packed[li] / perm[li] views
    # at bs 128 and 256, all-zero alpha blocks, an all-zero row; launches
    # and launches_tc exact; the gather alone bit-exact against its plain
    # version. Its own generator
    gk14 = torch.Generator(device=dev).manual_seed(14)
    k3_uneven = 0
    igtc_wave = k1.igtc_wave(dev)
    for name, m, K, n in SHAPES_8B + [GATEUP_8B, ("ragged", 200, 256, 256)]:
        packed, alpha, mu = rand_layer(K, n, gen=gk14)
        perm = rand_perm(m, K, m < K, gen=gk14)
        nb = K // 128
        k3_uneven += nb % -(-nb // k1.igtc_splits(K, n, 128, igtc_wave)) != 0
        for B in (9, 16, 32, 33, 64):
            x = k3_rows(B, m, gk14)
            for a8 in (False, True):
                got = k3_held(f"tc {name} rows={B} a8={a8}", x, perm, packed, alpha, mu, "tc",
                              a8)
                if got[1].abs().max().item() != 0.0:
                    fail(f"K3 tensor cores {name}: the all-zero row's output is not 0")
    if k3_uneven < 1:
        fail("K3 tensor cores: no shape with uneven K slices")
    m, K, n = 4000, 4096, 4096
    x = k3_rows(33, m, gk14)
    for bs in (128, 256):
        codes = torch.randint(-1, 2, (2, n, K), generator=gk14, device=dev, dtype=torch.int8)
        packed = torch.stack([pack_ternary(c, bs) for c in codes])
        alpha = ((0.8 + 0.4 * torch.rand((2, K // bs, n), generator=gk14, device=dev)) / 64
                 ).bfloat16()
        mu = (0.02 / 64 * torch.randn((2, K // bs, n), generator=gk14, device=dev)).bfloat16()
        perms = torch.stack([rand_perm(m, K, True, gen=gk14) for _ in range(2)])
        for li in (0, 1):
            for a8 in (False, True):
                k3_held(f"tc packed[{li}] bs {bs} a8={a8}", x, perms[li], packed[li], alpha[li],
                        mu[li], "tc", a8, bs)
    packed, alpha, mu = rand_layer(K, n, gen=gk14)
    alpha[::3] = 0
    mu[::6] = 0
    for B in (9, 33):
        for a8 in (False, True):
            k3_held(f"tc zero-alpha blocks rows={B} a8={a8}", x[:B], perms[0], packed, alpha, mu,
                    "tc", a8)
    # the gather alone: the fragment-order scratch bit for bit, its block sums
    igtc_lib = k1._igtc_kernel_lib()
    gather_checks = 0
    for B in (9, 32, 64):
        x = k3_rows(B, m, gk14)
        for a8 in (False, True):
            xk = k1.normalize_rows_a8(x)[0].contiguous() if a8 else x
            Bp = k1.igtc_rows_pad(B)
            xg = torch.empty((Bp, K), dtype=torch.bfloat16, device=dev)
            S = torch.empty((K // 128, Bp), dtype=torch.float32, device=dev)
            rc = igtc_lib.pt2_ternary_matmul_igathered_tc_gather(
                xk.data_ptr(), perms[1].data_ptr(), xg.data_ptr(), S.data_ptr(), B, Bp, m, K, 128,
                int(a8), dev.index or 0, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            want_xg, want_S = k1.igathered_tc_gather_plain(xk, perms[1], 128, a8)
            if rc != 0 or not torch.equal(xg, want_xg) or \
                    not (S - want_S).abs().max().item() <= KERNEL_TOL * want_S.abs().max().item():
                fail(f"K3 tensor cores: the gather alone (rc {rc}) at {B} rows a8={a8} differs "
                     f"from igathered_tc_gather_plain")
            gather_checks += 1
    record["k3_tc_checks"] = k3tc_checks
    record["k3_tc_max_abs_err"] = k3tc_err
    record["k3_tc_max_abs_err_vs_tc_plain"] = k3tc_algo_err
    print(f"K3 tensor-core path vs plain: {k3tc_checks} checks (4 shapes x rows 9/16/32/33/64 x "
          f"bf16/a8, {k3_uneven} with uneven K slices, + stacked views at bs 128 and 256 + "
          f"zero-alpha blocks), each called twice with identical bits, within {KERNEL_TOL} x "
          f"max|ref| of ternary_matmul_igathered_plain (max|err| {k3tc_err:.3e}) and of its own "
          f"plain version (max|err| {k3tc_algo_err:.3e}); launches and launches_tc exact; the "
          f"gather alone bit-exact in {gather_checks} checks")
    del packed, alpha, mu, x, perms, codes, xg, S

    stamp("15a")
    # ---- 15a. K2's rows 9-64 on its tensor-core path (K3's gather, the
    # gate/up product with the gated epilogue, K3's product over mid) vs
    # both plain versions: llama-3-8b's MLP (silu; "ssr" with a gather over
    # its 4096 features, "down" without) and gemma-2b's (GeGLU, "down"),
    # rows 9/16/32/64, each call twice for identical bits; launches,
    # launches_tc and launches_gelu exact. Its own generator
    gk15 = torch.Generator(device=dev).manual_seed(15)
    k2tc_err = k2tc_algo_err = 0.0
    k2tc_checks = 0

    def k2_launches():
        return (k1.ternary_mlp.launches, k1.ternary_mlp.launches_tc,
                k1.ternary_mlp.launches_gelu)

    for (D, I, n), act, layouts in ((MLP_8B, "silu", (True, False)),
                                    (MLP_GEMMA, "gelu", (False,))):
        gp, ga, gm = rand_layer(D, 2 * I, gen=gk15)
        dp, da, dm = rand_layer(I, n, gen=gk15)
        for gathered in layouts:
            args = (rand_perm(D, D, gen=gk15) if gathered else None, gp, ga, gm, dp, da, dm, I)
            for B in (9, 16, 32, 64):
                label = f"K2 tensor cores D={D} {act} gather={gathered} rows={B}"
                x = torch.randn((B, D), generator=gk15, device=dev).bfloat16()
                if k1.k2_path(B) != "tc":
                    fail(f"{label}: k2_path says {k1.k2_path(B)}")
                c0 = k2_launches()
                got = k1.ternary_mlp(x, *args, act=act)
                again = k1.ternary_mlp(x, *args, act=act)
                torch.cuda.synchronize()
                rose = tuple(b - a for a, b in zip(c0, k2_launches()))
                if rose != (2, 2, 2 if act == "gelu" else 0):
                    fail(f"{label}: launches, launches_tc, launches_gelu rose by {rose}")
                if not torch.equal(got, again):
                    fail(f"{label}: two calls differ")
                want = k1.ternary_mlp_plain(x, *args, act=act)
                algo = k1.ternary_mlp_tc_plain(x, *args, act=act, wave=igtc_wave)
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                aerr = (got - algo).abs().max().item()
                if got.shape != want.shape or not (err <= MLP_TOL * scale
                                                   and aerr <= MLP_TOL * scale):
                    fail(f"{label}: max|err| {err:.3e} vs ternary_mlp_plain, {aerr:.3e} vs "
                         f"ternary_mlp_tc_plain > {MLP_TOL} x max|ref| {scale:.3e}")
                k2tc_err, k2tc_algo_err = max(k2tc_err, err), max(k2tc_algo_err, aerr)
                k2tc_checks += 1
        del gp, ga, gm, dp, da, dm, args
    record["k2_tc_checks"] = k2tc_checks
    record["k2_tc_max_abs_err"] = k2tc_err
    record["k2_tc_max_abs_err_vs_tc_plain"] = k2tc_algo_err
    print(f"K2 tensor-core path vs plain: {k2tc_checks} checks (llama-3-8b silu with and without "
          f"the gather, gemma-2b GeGLU without, x rows 9/16/32/64), each called twice with "
          f"identical bits, within {MLP_TOL} x max|ref| of ternary_mlp_plain (max|err| "
          f"{k2tc_err:.3e}) and of its own plain version (max|err| {k2tc_algo_err:.3e}); "
          f"launches, launches_tc and launches_gelu exact")

    stamp("16a")
    # ---- 16a. K2's decode rows on its decode path (K1's decode GEMV over
    # gateup with x staged through perm, the gated epilogue in the last CTA
    # of each gate/up tile pair, then K1's decode kernel over mid) vs both
    # plain versions: llama-3-8b's MLP (silu; "ssr" with a gather over its
    # 4096 features, "down" without) and gemma-2b's (GeGLU, "down"), rows
    # 1/2/4/8, each call twice for identical bits; launches, launches_dec
    # and launches_gelu exact, none of them K1's. Its own generator
    gk16 = torch.Generator(device=dev).manual_seed(16)
    k2dec_wave = k1.dec_wave(dev)
    k2dec_err = k2dec_algo_err = 0.0
    k2dec_checks = 0

    def k2_dec_launches():
        return (k1.ternary_mlp.launches, k1.ternary_mlp.launches_dec,
                k1.ternary_mlp.launches_gelu, k1.ternary_matmul.launches)

    for (D, I, n), act, layouts in ((MLP_8B, "silu", (True, False)),
                                    (MLP_GEMMA, "gelu", (False,))):
        gp, ga, gm = rand_layer(D, 2 * I, gen=gk16)
        dp, da, dm = rand_layer(I, n, gen=gk16)
        for gathered in layouts:
            args = (rand_perm(D, D, gen=gk16) if gathered else None, gp, ga, gm, dp, da, dm, I)
            for B in (1, 2, 4, 8):
                label = f"K2 decode path D={D} {act} gather={gathered} rows={B}"
                x = torch.randn((B, D), generator=gk16, device=dev).bfloat16()
                if k1.k2_path(B) != "dec":
                    fail(f"{label}: k2_path says {k1.k2_path(B)}")
                c0 = k2_dec_launches()
                got = k1.ternary_mlp(x, *args, act=act)
                again = k1.ternary_mlp(x, *args, act=act)
                torch.cuda.synchronize()
                rose = tuple(b - a for a, b in zip(c0, k2_dec_launches()))
                if rose != (2, 2, 2 if act == "gelu" else 0, 0):
                    fail(f"{label}: launches, launches_dec, launches_gelu and K1's launches rose "
                         f"by {rose}")
                if not torch.equal(got, again):
                    fail(f"{label}: two calls differ")
                want = k1.ternary_mlp_plain(x, *args, act=act)
                algo = k1.ternary_mlp_dec_plain(x, *args, act=act, wave=k2dec_wave)
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                aerr = (got - algo).abs().max().item()
                if got.shape != want.shape or not (err <= MLP_TOL * scale
                                                   and aerr <= MLP_TOL * scale):
                    fail(f"{label}: max|err| {err:.3e} vs ternary_mlp_plain, {aerr:.3e} vs "
                         f"ternary_mlp_dec_plain > {MLP_TOL} x max|ref| {scale:.3e}")
                k2dec_err, k2dec_algo_err = max(k2dec_err, err), max(k2dec_algo_err, aerr)
                k2dec_checks += 1
        del gp, ga, gm, dp, da, dm, args
    record["k2_dec_checks"] = k2dec_checks
    record["k2_dec_max_abs_err"] = k2dec_err
    record["k2_dec_max_abs_err_vs_dec_plain"] = k2dec_algo_err
    print(f"K2 decode path vs plain: {k2dec_checks} checks (llama-3-8b silu with and without the "
          f"gather, gemma-2b GeGLU without, x rows 1/2/4/8), each called twice with identical "
          f"bits, within {MLP_TOL} x max|ref| of ternary_mlp_plain (max|err| {k2dec_err:.3e}) "
          f"and of its own plain version (max|err| {k2dec_algo_err:.3e}); launches, launches_dec "
          f"and launches_gelu exact, none of K1's")

    stamp("17a")
    # ---- 17a. K6's rows 1-64 on its decode path (the plane gather into lane
    # order, then K1's decode kernel) and its tensor-core path (the plane
    # gather into fragment order with the block sums, then K3's product) vs
    # both plain versions: the llama-3-8b K6 shapes (qkv, o, gateup) and a
    # ragged perm with interleaved pad lanes, rows 1/2/4/8 (W2A8 with
    # K1_DEC_A8 set) and 9/16/32/33/64, bf16 and W2A8, each call twice for
    # identical bits, an all-zero row and half-integer W2A8 rows; launches,
    # launches_dec and launches_tc exact, none of K1's or K3's; the decode
    # path bit-identical to K1's decode kernel on onehot_gather's x, the
    # tensor-core path within KERNEL_TOL of K3's on the same perm; the plane
    # gather alone bit-exact in both orders. Its own generator
    from pt2tpu_torch.ops.gather import make_packed_gather

    gk17 = torch.Generator(device=dev).manual_seed(17)
    k6dec_err = k6dec_algo_err = k6tc_err = k6tc_algo_err = 0.0
    k6dec_checks = k6tc_checks = 0

    def k6_counts():
        return (k1.ternary_matmul_gathered.launches, k1.ternary_matmul_gathered.launches_dec,
                k1.ternary_matmul_gathered.launches_tc, k1.ternary_matmul.launches,
                k1.ternary_matmul_igathered.launches)

    with k1_dec(True):  # W2A8 decode rows on the decode path too
        for name, m, K, n in SHAPES_8B + [GATEUP_8B, ("ragged", 200, 256, 256)]:
            packed, alpha, mu = rand_layer(K, n, gen=gk17)
            perm = rand_perm(m, K, m < K, gen=gk17)
            gp = make_packed_gather(perm, m).packed
            for B in (1, 2, 4, 8, 9, 16, 32, 33, 64):
                x = k3_rows(B, m, gk17)
                for a8 in (False, True):
                    label = f"K6 {name} rows={B} a8={a8}"
                    path = "dec" if B <= 8 else "tc"
                    if k1.k6_path(B, n, 128, a8) != path:
                        fail(f"{label}: k6_path is not {path}")
                    c0 = k6_counts()
                    got = k1.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
                    again = k1.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8)
                    torch.cuda.synchronize()
                    rose = tuple(b - a for a, b in zip(c0, k6_counts()))
                    if rose != (2, 2 * (path == "dec"), 2 * (path == "tc"), 0, 0):
                        fail(f"{label}: launches / decode / tensor-core / K1 / K3 launches rose "
                             f"by {rose}")
                    if not torch.equal(got, again):
                        fail(f"{label}: two calls differ in their bits")
                    want = k1.ternary_matmul_gathered_plain(x, gp, packed, alpha, mu, 128, a8)
                    if path == "dec":
                        algo = k1.ternary_matmul_gathered_dec_plain(
                            x, gp, packed, alpha, mu, 128, a8, wave=k1.dec_wave(dev))
                        twin = k1.ternary_matmul(k4.onehot_gather(x, perm), packed, alpha, mu,
                                                 a8=a8)
                    else:
                        algo = k1.ternary_matmul_gathered_tc_plain(
                            x, gp, packed, alpha, mu, 128, a8, wave=k1.igtc_wave(dev))
                        twin = k1.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
                    scale = want.abs().max().item()
                    err = (got - want).abs().max().item()
                    aerr = (got - algo).abs().max().item()
                    terr = (got - twin).abs().max().item()
                    if got.shape != want.shape or not (err <= KERNEL_TOL * scale
                                                       and aerr <= KERNEL_TOL * scale):
                        fail(f"{label}: max|err| {err:.3e} vs ternary_matmul_gathered_plain, "
                             f"{aerr:.3e} vs the path's plain version > {KERNEL_TOL} x max|ref| "
                             f"{scale:.3e}")
                    if path == "dec" and terr != 0.0:
                        fail(f"{label}: not bit-identical to K1's decode kernel on "
                             f"onehot_gather's x (max|diff| {terr:.3e})")
                    if path == "tc" and not terr <= KERNEL_TOL * scale:
                        fail(f"{label}: max|diff| {terr:.3e} from K3's tensor-core path")
                    if B >= 4 and got[1].abs().max().item() != 0.0:
                        fail(f"{label}: the all-zero row's output is not 0")
                    if path == "dec":
                        k6dec_err, k6dec_algo_err = max(k6dec_err, err), max(k6dec_algo_err, aerr)
                        k6dec_checks += 1
                    else:
                        k6tc_err, k6tc_algo_err = max(k6tc_err, err), max(k6tc_algo_err, aerr)
                        k6tc_checks += 1
    # the plane gather alone through its C entry, both orders, bit for bit
    pg_lib = k1._gathered_tc_kernel_lib()
    pg_checks = 0
    m, K = 4096, 4096
    perm = rand_perm(m, K, gen=gk17)
    gp = make_packed_gather(perm, m).packed
    for B in (1, 4, 8, 16, 33, 64):
        x = k3_rows(B, m, gk17)
        for a8 in (False, True):
            xk = k1.normalize_rows_a8(x)[0].contiguous() if a8 else x
            frag = B > 8
            rows_out = k1.igtc_rows_pad(B) if frag else B
            xg = torch.full((rows_out, K), float("nan"), device=dev).bfloat16()
            S = torch.full((K // 128, rows_out), float("nan"), device=dev)
            rc = pg_lib.pt2_planes_gather(
                xk.data_ptr(), gp.data_ptr(), xg.data_ptr(), S.data_ptr(), B, rows_out, m,
                gp.shape[0], K, int(frag), int(a8), dev.index or 0,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            want = k1.planes_gather_plain(xk, gp, 128, a8, "fragments" if frag else "lanes")
            same = (torch.equal(xg, want[0]) and torch.equal(S, want[1]) if frag
                    else torch.equal(xg, want))
            if rc != 0 or not same:
                fail(f"the plane gather alone (rc {rc}) at {B} rows a8={a8} differs from "
                     f"planes_gather_plain")
            pg_checks += 1
    record["k6_dec_checks"], record["k6_tc_checks"] = k6dec_checks, k6tc_checks
    record["k6_dec_max_abs_err"], record["k6_tc_max_abs_err"] = k6dec_err, k6tc_err
    record["k6_dec_max_abs_err_vs_dec_plain"] = k6dec_algo_err
    record["k6_tc_max_abs_err_vs_tc_plain"] = k6tc_algo_err
    print(f"K6 decode path vs plain: {k6dec_checks} checks, tensor-core path: {k6tc_checks} "
          f"(4 shapes x rows 1/2/4/8 and 9/16/32/33/64 x bf16/a8), each called twice with "
          f"identical bits, within {KERNEL_TOL} x max|ref| of ternary_matmul_gathered_plain "
          f"(max|err| {k6dec_err:.3e} / {k6tc_err:.3e}) and of the path's own plain version "
          f"({k6dec_algo_err:.3e} / {k6tc_algo_err:.3e}); the decode path bit-identical to K1's "
          f"decode kernel on onehot_gather's x, the tensor-core path within {KERNEL_TOL} of K3's; "
          f"launches exact, none of K1's or K3's; the plane gather alone bit-exact in "
          f"{pg_checks} checks")
    del packed, alpha, mu, x, perm, gp, xg, S

    stamp("2")
    # ---- 2. K4, K3 and K2 vs their plain versions
    errs = {"onehot_gather": 0.0, "ternary_matmul_igathered": 0.0,
            "ternary_matmul_igathered_dec": 0.0, "ternary_matmul_igathered_tc": 0.0,
            "ternary_mlp": 0.0, "ternary_mlp_tc": 0.0, "ternary_mlp_dec": 0.0}
    nchecks = dict.fromkeys(errs, 0)

    def held(kernel, label, got, want, tol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        if tol == 0.0 and not torch.equal(got, want):
            fail(f"{label}: not bit-exact (max|err| {err:.3e})")
        if not err <= tol * scale:
            fail(f"{label}: max|err| {err:.3e} > {tol} x max|ref| {scale:.3e}")
        errs[kernel] = max(errs[kernel], err)
        nchecks[kernel] += 1

    for m, K, inter in ((4096, 4096, False), (200, 256, True)):
        perm = rand_perm(m, K, inter)
        for B in (1, 4, 16, 512):
            x = torch.randn((B, m), generator=g, device=dev).bfloat16()
            held("onehot_gather", f"K4 m={m} K={K} rows={B}", k4.onehot_gather(x, perm),
                 k4.onehot_gather_plain(x, perm), 0.0)
    # K3's checks under the name of the path its rows take (decode path:
    # "ternary_matmul_igathered_dec", tensor-core path:
    # "ternary_matmul_igathered_tc", CUDA-core K3: "ternary_matmul_igathered")
    k3_name = lambda B, n, a8: "ternary_matmul_igathered" + {  # noqa: E731
        "dec": "_dec", "tc": "_tc", "cuda_core": ""}[k1.k3_path(B, n, 128, a8)]
    for name, m, K, n in SHAPES_8B + [GATEUP_8B, ("ragged", 200, 256, 256)]:
        packed, alpha, mu = rand_layer(K, n)
        perm = rand_perm(m, K, name == "ragged")
        for B in (1, 2, 4, 16):
            x = torch.randn((B, m), generator=g, device=dev).bfloat16()
            for a8 in (False, True):
                held(k3_name(B, n, a8), f"K3 {name} B={B} a8={a8}",
                     k1.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8),
                     k1.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, a8=a8),
                     KERNEL_TOL)
    # MLPs: llama-3-8b, and I = 1408 (11 blocks) with down padded to 16 blocks
    # (verify_fused_mlp's probe); ssr gathers over D features or no gather
    # (x zero-padded to the gateup's 16-block lane count). K2's checks under
    # the name of the path its rows take (decode path: "ternary_mlp_dec",
    # tensor-core path: "ternary_mlp_tc"); each decode-row call again with
    # the decode path off, on the CUDA-core K2
    k2_name = lambda B, cc: {"cc": cc, "dec": "ternary_mlp_dec",  # noqa: E731
                             "tc": "ternary_mlp_tc"}[k1.k2_path(B)]

    def k2_held(cc, label, xk, args, act="silu"):
        """K2 on the path k2_path names for xk's rows, then (decode rows) on
        the CUDA-core K2 under ``cc``'s name, each against ternary_mlp_plain."""
        want = k1.ternary_mlp_plain(xk, *args, act=act)
        B = xk.shape[0]
        held(k2_name(B, cc), label, k1.ternary_mlp(xk, *args, act=act), want, MLP_TOL)
        if k1.k2_path(B) == "dec":
            with k2_dec(False):
                held(cc, f"{label}, CUDA-core K2", k1.ternary_mlp(xk, *args, act=act), want,
                     MLP_TOL)

    for D, I, n in (MLP_8B, (512, 1408, 512)):
        Kg = -(-D // 2048) * 2048
        gp, ga, gm = rand_layer(Kg, 2 * I)
        dp, da, dm = rand_layer(-(-(I // 128) // 16) * 16 * 128, n)
        for gathered in (True, False):
            perm = rand_perm(D, Kg) if gathered else None
            for B in (1, 2, 4, 16):
                x = torch.randn((B, D), generator=g, device=dev).bfloat16()
                k2_held("ternary_mlp", f"K2 D={D} I={I} gather={gathered} B={B}", x,
                        (perm, gp, ga, gm, dp, da, dm, I))
    del gp, ga, gm, dp, da, dm
    # stacked views: layer li of (L, ...) arrays
    D, I, n = 4096, 1024, 4096
    gp, ga, gm = rand_layer(D, 2 * I, L=2)
    dp, da, dm = rand_layer(2048, n, L=2)
    perms = torch.stack([rand_perm(D, D) for _ in range(2)])
    x = torch.randn((4, D), generator=g, device=dev).bfloat16()
    for li in (0, 1):
        held("onehot_gather", f"K4 perm[{li}]", k4.onehot_gather(x, perms[li]),
             k4.onehot_gather_plain(x, perms[li]), 0.0)
        held(k3_name(4, 2 * I, False), f"K3 packed[{li}]",
             k1.ternary_matmul_igathered(x, perms[li], gp[li], ga[li], gm[li]),
             k1.ternary_matmul_igathered_plain(x, perms[li], gp[li], ga[li], gm[li]), KERNEL_TOL)
        k2_held("ternary_mlp", f"K2 layer {li}", x,
                (perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I))
    del gp, ga, gm, dp, da, dm, x
    # K2's GeGLU mode at the gemma-2b MLP (2048 -> 2 x 16384 -> 2048) on the
    # packed[li] views of a 2-layer stack, without a gather ("down", the
    # gateup's lanes = x's width) and with one (an "ssr" layout), rows
    # 1/2/4/8/16/64 (every row tile; decode rows on both paths); the relu
    # mode at one shape; the GeGLU launches counted apart, exactly
    for kname in ("ternary_mlp_gelu", "ternary_mlp_relu"):
        errs[kname], nchecks[kname] = 0.0, 0
    gelu0, gelu_calls = k1.ternary_mlp.launches_gelu, 0
    D, I, n = MLP_GEMMA
    gp, ga, gm = rand_layer(D, 2 * I, L=2, gen=ggem)
    dp, da, dm = rand_layer(I, n, L=2, gen=ggem)
    for gathered in (False, True):
        perms = [rand_perm(D, D, gen=ggem) for _ in range(2)] if gathered else [None, None]
        for li in (0, 1):
            args = (perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I)
            for B in (1, 2, 4, 8, 16, 64):
                x = torch.randn((B, D), generator=ggem, device=dev).bfloat16()
                k2_held("ternary_mlp_gelu", f"K2 GeGLU gemma-2b gather={gathered} layer {li} "
                        f"B={B}", x, args, "gelu")
                gelu_calls += 2 if B <= 8 else 1
    x = torch.randn((8, D), generator=ggem, device=dev).bfloat16()
    args = (None, gp[0], ga[0], gm[0], dp[0], da[0], dm[0], I)
    k2_held("ternary_mlp_relu", "K2 relu gemma-2b B=8", x, args, "relu")
    if k1.ternary_mlp.launches_gelu - gelu0 != gelu_calls:
        fail(f"K2 GeGLU launches rose by {k1.ternary_mlp.launches_gelu - gelu0} for "
             f"{gelu_calls} calls")
    del gp, ga, gm, dp, da, dm, x, args
    record["new_kernel_checks"] = nchecks
    record["new_kernel_max_abs_err"] = errs
    print(f"K4 vs plain: {nchecks['onehot_gather']} checks bit-exact; K3 vs plain: "
          f"{nchecks['ternary_matmul_igathered']} checks on the CUDA-core K3 (W2A8 rows <= 4; "
          f"max|err| {errs['ternary_matmul_igathered']:.3e}), "
          f"{nchecks['ternary_matmul_igathered_dec']} on its decode path (bf16 rows <= 4; max|err| "
          f"{errs['ternary_matmul_igathered_dec']:.3e}) and "
          f"{nchecks['ternary_matmul_igathered_tc']} on its tensor-core path (16 rows; max|err| "
          f"{errs['ternary_matmul_igathered_tc']:.3e}) within {KERNEL_TOL} x max|ref|; K2 vs "
          f"plain: {nchecks['ternary_mlp']} checks within {MLP_TOL} x max|ref| (max|err| "
          f"{errs['ternary_mlp']:.3e}) on the CUDA-core K2 (decode rows with its decode path "
          f"off), {nchecks['ternary_mlp_dec']} on its decode path (rows <= 8, every activation; "
          f"max|err| {errs['ternary_mlp_dec']:.3e}), {nchecks['ternary_mlp_tc']} on its "
          f"tensor-core path (16 and 64 rows; max|err| {errs['ternary_mlp_tc']:.3e}); K2 GeGLU "
          f"at gemma-2b on the CUDA cores: {nchecks['ternary_mlp_gelu']} checks (max|err| "
          f"{errs['ternary_mlp_gelu']:.3e}), relu {nchecks['ternary_mlp_relu']} (max|err| "
          f"{errs['ternary_mlp_relu']:.3e}) within {MLP_TOL} x max|ref|")

    stamp("2b")
    # ---- 2b. K7 on its tensor-core kernel (the route) against both plain
    # versions: decode_attention_plain at ATTN_TOL, decode_attention_split_plain
    # on the kernel's own plan within one bf16 step of each value plus
    # K7_SPLIT_TOL; llama-3-8b and llama-2-7b heads, B 1/4/8, M 256 and the
    # engine's 2048, ragged lengths, then masks with holes, only the last slot,
    # a row with none (output 0), every call twice for the same bits; then
    # PR 3's kernel (K7_TC off) against the plain version as before
    from pt2tpu_torch.serve.kvcache import quantize_i8

    def attn_inputs(B, M, H, Hkv, quant, ragged=True, hd=128, gen=None, mask=None):
        gen = gen or g
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, M, Hkv, hd), generator=gen, device=dev)
        v = torch.randn((B, M, Hkv, hd), generator=gen, device=dev)
        lens = (torch.randint(1, M + 1, (B,), generator=gen, device=dev) if ragged
                else torch.full((B,), M, device=dev))
        valid = torch.arange(M, device=dev)[None, :] < lens[:, None]
        if mask == "holes":
            valid &= torch.rand((B, M), generator=gen, device=dev) < 0.4
        elif mask == "last_only":
            valid = (torch.arange(M, device=dev) == M - 1).expand(B, M).contiguous()
        elif mask == "empty_row":
            valid[0] = False
        elif mask is not None and mask.startswith("window"):  # "window<W>": (p - W, p]
            W_ = int(mask[6:])
            p_ = torch.randint(W_ // 2, M, (B, 1), generator=gen, device=dev)
            pos_ = torch.arange(M, device=dev)[None, :]
            valid = (pos_ <= p_) & (pos_ > p_ - W_)
        if not quant:
            return q, k.bfloat16(), v.bfloat16(), valid, None, None
        (k8, ks), (v8, vs) = quantize_i8(k), quantize_i8(v)
        return q, k8, v8, valid, ks, vs

    def held_k7(name, label, a, scale_):
        """K7's route (its tensor-core kernel) on ``a``: against the plain
        version, against the split plain version on the kernel's plan, twice
        for the same bits; launches and launches_tc exact."""
        q_, k_, v_, valid_, ks_, vs_ = a
        B_, M_, Hkv_, hd_ = q_.shape[0], k_.shape[1], k_.shape[2], q_.shape[3]
        c0 = (k7.decode_attention.launches, k7.decode_attention.launches_tc)
        got = k7.decode_attention(*a[:4], scale_, *a[4:])
        again = k7.decode_attention(*a[:4], scale_, *a[4:])
        if (k7.decode_attention.launches, k7.decode_attention.launches_tc) != (c0[0] + 2, c0[1] + 2):
            fail(f"{label}: K7's tensor-core kernel did not launch once per call")
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{label}: two runs differ")
        held(name, label, got, k7.decode_attention_plain(*a[:4], scale_, *a[4:]), ATTN_TOL)
        plan = k7.k7_plan(B_, M_, Hkv_, q_.shape[2] // Hkv_, hd_, ks_ is not None)
        want = k7.decode_attention_split_plain(*a[:4], scale_, *a[4:], tile=plan.tile,
                                               splits=plan.splits).float()
        step = torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
        over = ((got.float() - want).abs() - step).max().item() / want.abs().max().item()
        if not over <= K7_SPLIT_TOL:
            fail(f"{label}: {over:.3e} of max|ref| past one bf16 step of the split plain version")
        errs[name + "_split"] = max(errs.get(name + "_split", 0.0), over)
        if a[3].shape[0] > 0 and not a[3][0].any() and got[0].abs().max().item() != 0.0:
            fail(f"{label}: a row with no valid slot is not 0")

    errs["decode_attention"] = 0.0
    nchecks["decode_attention"] = 0
    attn_scale = 1.0 / math.sqrt(128)
    for H, Hkv in ((32, 8), (32, 32)):
        for B in (1, 4, 8):
            for M in (256, ENGINE_M):
                for quant in (False, True):
                    held_k7("decode_attention", f"K7 H={H} Hkv={Hkv} B={B} M={M} int8={quant}",
                            attn_inputs(B, M, H, Hkv, quant), attn_scale)
    # gemma-2b's heads: hd 256, one KV head for 8 query heads, scale 1/16
    errs["decode_attention_hd256"], nchecks["decode_attention_hd256"] = 0.0, 0
    Hg, Hkvg, hdg = HEADS_GEMMA
    scale_g = 1.0 / math.sqrt(hdg)
    hd0 = k7.decode_attention.launches_hd256
    for B in (1, 4, 8):
        for M in (256, ENGINE_M):
            for quant in (False, True):
                held_k7("decode_attention_hd256", f"K7 gemma-2b heads H={Hg} Hkv={Hkvg} hd={hdg} "
                        f"B={B} M={M} int8={quant}", attn_inputs(B, M, Hg, Hkvg, quant, hd=hdg,
                                                                 gen=ggem), scale_g)
    if k7.decode_attention.launches_hd256 - hd0 != 2 * nchecks["decode_attention_hd256"]:
        fail("K7's hd-256 launches do not match its calls")
    # the masks, at the engine's point, every head layout, both cache types
    gk17 = torch.Generator(device=dev).manual_seed(17)  # this slice's draws
    for mask in ("holes", "last_only", "empty_row"):
        for H, Hkv, hd in ((32, 8, 128), (32, 32, 128), HEADS_GEMMA):
            for quant in (False, True):
                name = "decode_attention_hd256" if hd == 256 else "decode_attention"
                held_k7(name, f"K7 mask {mask} H={H} Hkv={Hkv} hd={hd} B=8 M={ENGINE_M} "
                        f"int8={quant}", attn_inputs(8, ENGINE_M, H, Hkv, quant, hd=hd, gen=gk17,
                                                     mask=mask), hd ** -0.5)
    # 22b's windows (sliding-window layers: slots (p - W, p] of each row, so
    # leading tiles and whole splits hold no valid slot): gemma3-4b's heads
    # (2 queries per KV head at hd 256) and qwen3-8b's, W 1024 and 100
    for mask in ("window1024", "window100"):
        for H, Hkv, hd in (HEADS_GEMMA3, (32, 8, 128), HEADS_GEMMA):
            for quant in (False, True):
                name = "decode_attention_hd256" if hd == 256 else "decode_attention"
                held_k7(name, f"K7 {mask} H={H} Hkv={Hkv} hd={hd} B=8 M={ENGINE_M} "
                        f"int8={quant}", attn_inputs(8, ENGINE_M, H, Hkv, quant, hd=hd, gen=gk17,
                                                     mask=mask), hd ** -0.5)
    print(f"K7 on its tensor-core kernel vs plain: {nchecks['decode_attention']} checks within "
          f"{ATTN_TOL} x max|ref| (max|err| {errs['decode_attention']:.3e}); at gemma-2b's heads "
          f"(H {Hg}, Hkv {Hkvg}, hd {hdg}): {nchecks['decode_attention_hd256']} checks (max|err| "
          f"{errs['decode_attention_hd256']:.3e}); vs the split plain version on its plan: past "
          f"one bf16 step by at most {errs['decode_attention_split']:.3e} / "
          f"{errs['decode_attention_hd256_split']:.3e} of max|ref| (<= {K7_SPLIT_TOL}); every "
          f"call twice, same bits")
    # PR 3's kernel, the A/Bs' "off" turns: as before, against the plain version
    errs["decode_attention_cc"], nchecks["decode_attention_cc"] = 0.0, 0
    k7.K7_TC = False
    tc0 = k7.decode_attention.launches_tc
    for H, Hkv, hd in ((32, 8, 128), (32, 32, 128), HEADS_GEMMA, HEADS_GEMMA3):
        for B in (1, 8):
            for quant in (False, True):
                a = attn_inputs(B, ENGINE_M, H, Hkv, quant, hd=hd, gen=gk17,
                                mask="window1024" if (H, Hkv, hd) == HEADS_GEMMA3 else None)
                held("decode_attention_cc", f"PR 3's K7 H={H} Hkv={Hkv} hd={hd} B={B} int8={quant}",
                     k7.decode_attention(*a[:4], hd ** -0.5, *a[4:]),
                     k7.decode_attention_plain(*a[:4], hd ** -0.5, *a[4:]), ATTN_TOL)
                del a
    k7.K7_TC = True
    if k7.decode_attention.launches_tc != tc0:
        fail("K7_TC off launched the tensor-core kernel")
    print(f"PR 3's K7 (K7_TC off) vs plain: {nchecks['decode_attention_cc']} checks (max|err| "
          f"{errs['decode_attention_cc']:.3e})")

    stamp("2c")
    # ---- 2c. K5 bit-exact against its plain version and against K4; K6 vs
    # its plain version: llama-3-8b gathers, ragged and interleaved-pad perms,
    # several K chunks x several column groups
    from pt2tpu_torch.ops.gather import make_packed_gather

    for name in ("onehot_matmul", "ternary_matmul_gathered"):
        errs[name], nchecks[name] = 0.0, 0
    for m, K, inter in ((4096, 4096, False), (200, 256, True), (300, 512, True)):
        perm = rand_perm(m, K, inter)
        gp = make_packed_gather(perm, m).packed
        for B in (1, 2, 4, 8, 16, 64, 512):
            for dt in ((torch.bfloat16, torch.float32) if B in (4, 512) else (torch.bfloat16,)):
                x = torch.randn((B, m), generator=g, device=dev).to(dt)
                got = k4.onehot_matmul(x, gp)
                held("onehot_matmul", f"K5 m={m} K={K} rows={B} {dt}", got,
                     k4.onehot_matmul_plain(x, gp), 0.0)
                held("onehot_matmul", f"K5 vs K4 m={m} K={K} rows={B} {dt}", got,
                     k4.onehot_gather(x, perm), 0.0)
    for name, m, K, n in SHAPES_8B + [GATEUP_8B, ("ragged", 200, 256, 384)]:
        packed, alpha, mu = rand_layer(K, n)
        gp = make_packed_gather(rand_perm(m, K, name == "ragged"), m).packed
        for B in (1, 2, 4, 8, 16, 64):
            x = torch.randn((B, m), generator=g, device=dev).bfloat16()
            for a8 in (False, True):
                held("ternary_matmul_gathered", f"K6 {name} B={B} a8={a8}",
                     k1.ternary_matmul_gathered(x, gp, packed, alpha, mu, a8=a8),
                     k1.ternary_matmul_gathered_plain(x, gp, packed, alpha, mu, a8=a8),
                     KERNEL_TOL)
    del packed, alpha, mu
    gp, ga, gm = rand_layer(4096, 4096, L=2)
    perms = [rand_perm(4096, 4096) for _ in range(2)]
    gps = torch.stack([make_packed_gather(p, 4096).packed for p in perms])
    x = torch.randn((4, 4096), generator=g, device=dev).bfloat16()
    for li in (0, 1):
        held("onehot_matmul", f"K5 planes[{li}]", k4.onehot_matmul(x, gps[li]),
             k4.onehot_gather(x, perms[li]), 0.0)
        held("ternary_matmul_gathered", f"K6 layer {li}",
             k1.ternary_matmul_gathered(x, gps[li], gp[li], ga[li], gm[li]),
             k1.ternary_matmul_gathered_plain(x, gps[li], gp[li], ga[li], gm[li]), KERNEL_TOL)
    del gp, ga, gm, gps, x
    # 18a. K5's rows path (rows >= K5_ROWS_MIN_ROWS: the lane map, then the
    # rows staged in shared memory; its own generator, so that the later
    # phases draw what they drew before): bit-exact against its plain
    # versions and against K4 at rows 16 / 64 / 65 / 128 / 256 / 512 / 1000, bf16 and
    # f32, the same three perms' shapes; the lane map bit-exact; planes that
    # are not a permutation ("few": fields of 2 and extra ones, within the
    # map's E; "dense": every lane walks its column) bit-exact to the plain
    # version and within 1e-6 of x @ G in f32; every call twice for the same
    # bits; launches and launches_rows exact
    g18 = torch.Generator(device=dev).manual_seed(18)
    errs["onehot_matmul_rows"], nchecks["onehot_matmul_rows"] = 0.0, 0
    rows_rb = k4._rows_kernel_lib()
    zero_counts()
    calls = k4_calls = 0
    for m, K, inter in ((4096, 4096, False), (200, 256, True), (300, 512, True)):
        perm = rand_perm(m, K, inter, gen=g18)
        gp = make_packed_gather(perm, m).packed
        lmap = torch.full((5 * K,), 7, dtype=torch.int32, device=dev)
        if rows_rb.pt2_onehot_lane_map(gp.data_ptr(), lmap.data_ptr(), m, gp.shape[0], K,
                                       torch.cuda.current_device(),
                                       torch.cuda.current_stream().cuda_stream):
            fail(f"K5's lane map m={m} K={K}: launch failed")
        held("onehot_matmul_rows", f"K5 lane map m={m} K={K}", lmap,
             k4.onehot_lane_map_plain(gp, m), 0.0)
        for B in (16, 64, 65, 128, 256, 512, 1000):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((B, m), generator=g18, device=dev).to(dt)
                got = k4.onehot_matmul(x, gp)
                again = k4.onehot_matmul(x, gp)
                calls += 2
                held("onehot_matmul_rows", f"K5 rows m={m} K={K} rows={B} {dt}", got,
                     k4.onehot_matmul_rows_plain(x, gp), 0.0)
                held("onehot_matmul_rows", f"K5 rows vs K4 m={m} K={K} rows={B} {dt}", got,
                     k4.onehot_gather(x, perm), 0.0)
                k4_calls += 1
                held("onehot_matmul_rows", f"K5 rows run to run m={m} rows={B} {dt}", again,
                     got, 0.0)
    any_err = 0.0
    for kind in ("few", "dense"):
        m, D, K = 300, 384, 512
        if kind == "dense":
            codes = torch.randint(-1, 1, (K, D), generator=g18, device=dev, dtype=torch.int8)
        else:
            codes = torch.full((K, D), -1, device=dev, dtype=torch.int8)
            for _ in range(3):
                codes[torch.arange(K, device=dev),
                      torch.randint(0, D, (K,), generator=g18, device=dev)] = 0
        codes[::7, 5] = 1
        gp = pack_ternary(codes, 128)
        u64 = (codes.t().double() + 1)[:m]
        for B in (65, 200):
            x = torch.randn((B, m), generator=g18, device=dev)
            got = k4.onehot_matmul(x, gp)
            calls += 1
            held("onehot_matmul_rows", f"K5 rows, {kind} planes, rows={B}", got,
                 k4.onehot_matmul_rows_plain(x, gp), 0.0)
            exact = x.double() @ u64
            err = ((got.double() - exact).abs().max() / exact.abs().max()).item()
            if not err <= 1e-6:
                fail(f"K5 rows, {kind} planes, rows={B}: {err:.3e} of max|x @ G| > 1e-6")
            any_err = max(any_err, err)
    got = counts()
    if got != dict.fromkeys(got, 0) | {"onehot_matmul": calls, "onehot_matmul_rows": calls,
                                       "onehot_gather": k4_calls, "onehot_gather_rows": k4_calls}:
        fail(f"K5's rows-path checks: launches {got}, want {calls} of K5, all on its rows path")
    del gp, x, lmap
    torch.cuda.empty_cache()
    print(f"K5 vs plain and vs K4: {nchecks['onehot_matmul']} checks bit-exact; K5's rows path: "
          f"{nchecks['onehot_matmul_rows']} checks bit-exact (plain versions, K4, the lane map, "
          f"run to run; {calls} launches, all counted in launches_rows), other planes within "
          f"{any_err:.2e} of x @ G; K6 vs plain: "
          f"{nchecks['ternary_matmul_gathered']} checks within {KERNEL_TOL} x max|ref| (max|err| "
          f"{errs['ternary_matmul_gathered']:.3e})")
    # 20a. K4's rows path (rows >= K4_ROWS_MIN_ROWS: x's rows staged in
    # shared memory by bulk copies, perm in registers, 16-byte stores; its
    # own generator, so that the later phases draw what they drew before):
    # bit for bit against its plain version, K4's first kernel (the
    # threshold rebound) at rows 2 / 5 / 16 / 65 / 128 / 512 / 1000 and K5
    # (its rows path) from 16, m 4096 / 8192 / 200 / 300 (the last two with
    # interleaved pad lanes), bf16 and f32, -0.0 in half of row 0; again
    # with NaNs of four payloads in row 1 against the plain version and the
    # first kernel (K5 multiplies, so it is not asked there); on perm[li]
    # views of a stack; a CUDA graph capture replayed on new x; launches and
    # launches_rows exact
    g20 = torch.Generator(device=dev).manual_seed(20)
    errs["onehot_gather_rows"], nchecks["onehot_gather_rows"] = 0.0, 0
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else torch.int32)  # noqa: E731

    def held_bits(label, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or \
                not torch.equal(bits(got), bits(want)):
            fail(f"{label}: not bit-exact")
        nchecks["onehot_gather_rows"] += 1

    zero_counts()
    calls = first_calls = k5_calls = 0
    for m, K in ((4096, 4096), (8192, 8192), (200, 256), (300, 512)):
        perm = rand_perm(m, K, m < K, gen=g20)
        gp = make_packed_gather(perm, m).packed
        for B in (2, 5, 16, 65, 128, 512, 1000):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((B, m), generator=g20, device=dev).to(dt)
                x[0, : m // 2] = -0.0
                xn = x.clone()
                for i, pat in enumerate([0x7FC1, -0x005B, 0x7F81, -0x007F] if dt == torch.bfloat16
                                        else [0x7FC00001, -0x007FFEDD, 0x7F800123, -1]):
                    bits(xn)[1, i::4] = pat
                label = f"K4 rows m={m} K={K} rows={B} {dt}"
                for xk, tag in ((x, ""), (xn, ", NaN payloads")):
                    got = k4.onehot_gather(xk, perm)
                    calls += 1
                    held_bits(label + tag, got, k4.onehot_gather_plain(xk, perm))
                    with k4_rows(False):
                        held_bits(f"{label}{tag} vs K4's first kernel", got,
                                  k4.onehot_gather(xk, perm))
                    first_calls += 1
                if B >= k4.K5_ROWS_MIN_ROWS:  # K5's first kernel sums: -0.0 comes out +0.0
                    held_bits(f"{label} vs K5", k4.onehot_gather(x, perm),
                              k4.onehot_matmul(x, gp))
                    calls, k5_calls = calls + 1, k5_calls + 1
    perms = torch.stack([rand_perm(4096, 4096, gen=g20) for _ in range(2)])
    x = torch.randn((512, 4096), generator=g20, device=dev).bfloat16()
    for li in (0, 1):
        held_bits(f"K4 rows perm[{li}]", k4.onehot_gather(x, perms[li]),
                  k4.onehot_gather_plain(x, perms[li]))
        calls += 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gout = k4.onehot_gather(x, perms[1])
    calls += 1  # counted once, at the capture
    for _ in range(2):
        x.copy_(torch.randn((512, 4096), generator=g20, device=dev).bfloat16())
        graph.replay()
        held_bits("K4 rows replayed from a CUDA graph", gout, k4.onehot_gather_plain(x, perms[1]))
    got = counts()
    if got != dict.fromkeys(got, 0) | {"onehot_gather": calls + first_calls,
                                       "onehot_gather_rows": calls, "onehot_matmul": k5_calls,
                                       "onehot_matmul_rows": k5_calls}:
        fail(f"K4's rows-path checks: launches {got}, want {calls} on its rows path, "
             f"{first_calls} on its first kernel, {k5_calls} of K5")
    del graph, gout, x, xn, perms, gp
    torch.cuda.empty_cache()
    print(f"K4's rows path: {nchecks['onehot_gather_rows']} checks bit-exact (plain version, "
          f"K4's first kernel, K5; -0.0 and NaN payloads; perm[li]; a CUDA graph replay); "
          f"launches exact ({calls} on the rows path, {first_calls} on the first kernel)")

    stamp("3")
    # ---- 3. 2-layer models at full width through the kernels vs their reference
    import pt2tpu_torch.models.common as tcommon
    import pt2tpu_torch.ops.gather as tgather
    import pt2tpu_torch.ops.ternary_matmul as ttm

    def k1_plain(x, p, a, m, bs=128, a8=False):
        if a8 == k1.FLOOR:
            return k1.ternary_matmul_floor_plain(x, p, a, m, bs)
        return (k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain)(x, p, a, m, bs)

    # (wrapper's name in the routing modules, its plain version, tolerance)
    routed = {"ternary_matmul": (ttm, k1_plain, KERNEL_TOL),
              "ternary_matmul_igathered": (ttm, k1.ternary_matmul_igathered_plain, KERNEL_TOL),
              "ternary_mlp": (ttm, k1.ternary_mlp_plain, MLP_TOL),
              "onehot_gather": (tgather, k4.onehot_gather_plain, 0.0),
              "decode_attention": (tcommon, k7.decode_attention_plain, ATTN_TOL),
              "onehot_matmul": (tgather, k4.onehot_matmul_plain, 0.0),
              "ternary_matmul_gathered": (ttm, k1.ternary_matmul_gathered_plain, KERNEL_TOL),
              "ternary_matmul_idx": (ttm, k1.ternary_matmul_idx_plain, KERNEL_TOL),
              "ternary_matmul_igathered_idx": (ttm, k1.ternary_matmul_igathered_idx_plain,
                                               KERNEL_TOL),
              "ternary_matmul_gathered_idx": (ttm, k1.ternary_matmul_gathered_idx_plain,
                                              KERNEL_TOL),
              "onehot_gather_idx": (tgather, k4.onehot_gather_idx_plain, 0.0),
              "onehot_matmul_idx": (tgather, k4.onehot_matmul_idx_plain, 0.0)}
    per_call = dict.fromkeys(routed, 0)

    # the routing flags of the packed-gather slice: (GATHER_KERNEL,
    # IGATHER_FUSED, FUSED_GATHER); P1 gathers with K5, P2 also fuses it as K6
    P1, P2 = ("packed", True, False), ("packed", False, True)

    @contextlib.contextmanager
    def route_flags(flags):
        saved = (tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER)
        tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER = flags
        try:
            yield
        finally:
            tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER = saved

    @contextlib.contextmanager
    def k1_tc(on):
        """K1's tensor-core path as routed (on), or K1_TC_MIN_ROWS rebound
        above any row count so that every K1 call takes the CUDA cores."""
        saved = k1.K1_TC_MIN_ROWS
        if not on:
            k1.K1_TC_MIN_ROWS = 1 << 30
        try:
            yield
        finally:
            k1.K1_TC_MIN_ROWS = saved

    TC_AB = (True, False, False, True, True, False)  # in turns: tc, CUDA cores, ...

    @contextlib.contextmanager
    def swapped(make, names=None):
        """Each routed kernel wrapper (those in ``names``, default all)
        replaced by make(name, wrapper, plain, tol)."""
        chosen = {k: v for k, v in routed.items() if names is None or k in names}
        saved = {name: getattr(mod, name) for name, (mod, _, _) in chosen.items()}
        for name, (mod, plain, tol) in chosen.items():
            setattr(mod, name, make(name, saved[name], plain, tol))
        try:
            yield
        finally:
            for name, (mod, _, _) in chosen.items():
                setattr(mod, name, saved[name])

    def each_call_checked(name, kernel, plain, tol):
        """The kernel's result, after holding it against its plain version on
        the same inputs (the route's own activations)."""
        def call(*args, **kw):
            got, want = kernel(*args, **kw), plain(*args, **kw)
            err = (got.float() - want.float()).abs().max().item()
            if (got.shape != want.shape or (tol == 0.0 and not torch.equal(got, want))
                    or not err <= tol * want.float().abs().max().item()):
                fail(f"{name} inside a model: max|err| {err:.3e} > {tol} x max|ref|")
            per_call[name] += 1
            return got
        return call

    def plain_versions():
        """The routing unchanged, every kernel swapped for its plain version:
        the reference of the W2A8 route, which has no impl of its own."""
        return swapped(lambda name, kernel, plain, tol: plain)

    def reference(impl):
        """(impl, context) of the route a model run is held against."""
        return ("plain", contextlib.nullcontext()) if impl == "auto" else (impl, plain_versions())

    def two_layer_check(name, layout, seed, impls=("auto",), roundtrip=True, tag="", gen=None,
                        built=None, new=16, want=None):
        """``built``: (cfg, params) of a model made elsewhere (the quantizer's),
        else 2 layers of ``name`` from random_ternary_params. ``want(impl)``:
        the exact launches of its greedy_generate of ``new`` tokens."""
        if built is None:
            cfg2 = get_config(name).with_(n_layers=2)
            params2 = random_ternary_params(cfg2, seed=seed, perm_mode=layout, device=dev)
        else:
            cfg2, params2 = built
        prompt = torch.randint(0, cfg2.vocab_size, (4, 128), generator=gen or g, device=dev)

        @torch.inference_mode()
        def prefill_logits(params, impl):
            cache = init_cache(cfg2, 4, 160, device=dev)
            logits, _ = forward_cached(cfg2, params, prompt, cache, 0, impl, all_logits=True)
            return logits.float()

        rec = {}
        for impl in impls:
            rel_tol, tok_tol = (LOGITS_REL_L2, TOKEN_TOL) if impl == "auto" else A8_TOLS
            for k in per_call:
                per_call[k] = 0
            with swapped(each_call_checked):  # the kernel route, every call held
                la = prefill_logits(params2, impl)
                c_g = counts()
                toks = greedy_generate(cfg2, params2, prompt, new, impl=impl)
                rose = {k: v - c_g[k] for k, v in counts().items()}
            if want is not None:
                if rose != want(impl):
                    fail(f"2-layer {name} ({layout}{tag}) {impl}: greedy_generate launched {rose}, "
                         f"want {want(impl)}")
                tally(rose)
            checked = {k: v for k, v in per_call.items() if v}
            c0 = counts()
            ref_impl, ctx = reference(impl)
            with ctx:
                lp = prefill_logits(params2, ref_impl)
            rel = ((la - lp).norm() / lp.norm()).item()
            ref_impl, ctx = reference(impl)
            with ctx, torch.inference_mode():  # teacher-forced reference over the same tokens
                cache = init_cache(cfg2, 4, 128 + new, device=dev)
                logits, _ = forward_cached(cfg2, params2, prompt, cache, 0, ref_impl)
                agree, worst = 0, 0.0
                for s in range(new):
                    lf = logits.float()
                    picked = lf.gather(1, toks[:, s : s + 1].long())[:, 0]
                    gap = (lf.max(dim=1).values - picked).max().item()
                    worst = max(worst, gap / lf.abs().max().item())
                    agree += int((lf.argmax(dim=1) == toks[:, s]).sum().item())
                    if s < new - 1:
                        logits, _ = forward_cached(cfg2, params2, toks[:, s : s + 1].long(),
                                                   cache, 128 + s, ref_impl)
            if counts() != c0:
                fail(f"2-layer {name}: the reference route of {impl} launched a kernel")
            print(f"{cfg2.n_layers}-layer {name} ({layout}{tag}) {impl}: every kernel call of "
                  f"prefill + {new} decode steps held against its plain version on the same "
                  f"inputs {checked}{'; launches exact' if want else ''}; prefill logits vs "
                  f"reference ({ref_impl}{'' if impl == 'auto' else ', plain versions'}) rel L2 "
                  f"{rel:.3e} (<= {rel_tol}); {new} greedy tokens x 4: {agree}/{4 * new} equal to "
                  f"the reference argmax, worst pick gap {worst:.2e} of max|logit| (<= {tok_tol})")
            if not (math.isfinite(rel) and rel <= rel_tol):
                fail(f"2-layer {name} {impl} prefill logits vs reference: rel L2 {rel:.3e} > "
                     f"{rel_tol}")
            if worst > tok_tol:
                fail(f"2-layer {name} {impl} greedy tokens: a pick trails the reference max by "
                     f"{worst:.3e} of max|logit|")
            rec[impl] = {"calls_checked": checked, "prefill_rel_l2": rel, "greedy_agree": agree,
                         "greedy_total": 4 * new, "worst_pick_gap": worst, "launches": rose}
            del cache, logits, lp
        if not roundtrip:
            del params2
            torch.cuda.empty_cache()
            return rec
        la = prefill_logits(params2, "auto")
        art = os.path.join(ROOT, "build", f"smoke_artifact_{layout.replace(' ', '_')}")
        ckpt.save_model(art, cfg2, params2)
        cfg_l, params_l = ckpt.load_model(art, device=dev)
        shutil.rmtree(art)
        fa, sa, fb, sb = {}, {}, {}, {}
        ckpt._flatten("", params2, fa, sa)
        ckpt._flatten("", params_l, fb, sb)
        if cfg_l != cfg2 or sa != sb or any(not torch.equal(fa[k], fb[k]) for k in fa):
            fail(f"{name} save_model/load_model round trip changed the model")
        rt = ((prefill_logits(params_l, "auto") - la).norm() / la.norm()).item()
        if rt > 1e-6:
            fail(f"reloaded {name} model's logits differ: rel L2 {rt:.3e}")
        print(f"2-layer {name} ({layout}): save/load round trip exact ({len(fa)} arrays)")
        rec["roundtrip_rel_l2"] = rt
        del params2, params_l, la
        torch.cuda.empty_cache()
        return rec

    record["model2"] = two_layer_check("llama-2-7b", "down", 1)
    c0 = counts()
    record["model2_8b_ssr"] = two_layer_check("llama-3-8b", "ssr", 3, ("auto", "a8"))
    used = {k: v - c0[k] for k, v in counts().items()
            if k in ("ternary_matmul", "ternary_matmul_igathered", "ternary_mlp", "onehot_gather")}
    if not all(used.values()):
        fail(f"2-layer llama-3-8b ssr did not launch every kernel: {used}")
    # the same model under the P2 flags: prefill through K5 + K1, decode K6
    c0 = counts()
    with route_flags(P2):
        record["model2_8b_ssr_p2"] = two_layer_check("llama-3-8b", "ssr", 3, ("auto", "a8"),
                                                     roundtrip=False, tag=", P2 flags")
    used = {k: v - c0[k] for k, v in counts().items()}
    if not (used["onehot_matmul"] and used["ternary_matmul_gathered"]) or \
            used["onehot_gather"] or used["ternary_matmul_igathered"]:
        fail(f"2-layer llama-3-8b ssr under P2 launched {used}")
    # 2-layer gemma-2b models: "down" (decode through K1's decode kernel
    # and K2 GeGLU without a gather) and "ssr" (decode K3 + K2 GeGLU with
    # its gather, prefill K4 + K1), bf16 and W2A8
    c0 = counts()
    record["model2_gemma_down"] = two_layer_check("gemma-2b", "down", 11, ("auto", "a8"),
                                                  gen=ggem)
    record["model2_gemma_ssr"] = two_layer_check("gemma-2b", "ssr", 12, ("auto", "a8"), gen=ggem)
    used = {k: v - c0[k] for k, v in counts().items()}
    if not (used["ternary_mlp_gelu"] and used["ternary_matmul_dec"]
            and used["ternary_matmul_igathered"] and used["onehot_gather"]) \
            or used["ternary_mlp_gelu"] != used["ternary_mlp"]:
        fail(f"2-layer gemma-2b models launched {used}")

    stamp("3b")
    # ---- 3b. a 2-layer llama-3-8b ServeEngine ("down" layout, 8 slots, max_len
    # 2048, quantum 4): every K1 / K2 / K7 call held against its plain version
    from pt2tpu_torch.serve.engine import ServeEngine, _bucket
    from pt2tpu_torch.serve.sampling import SamplingConfig

    gh = torch.Generator().manual_seed(7)  # host-side lengths

    def host_ints(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=gh).tolist()

    def make_prompts(cfg_, lens, gen=None):
        return [torch.randint(0, cfg_.vocab_size, (n,), generator=gen or g,
                              device=dev).cpu().numpy() for n in lens]

    cfg2 = get_config("llama-3-8b").with_(n_layers=2)
    params2 = random_ternary_params(cfg2, seed=6, perm_mode="down", device=dev)
    prompts2, news2 = make_prompts(cfg2, host_ints(20, 300, 12)), host_ints(8, 24, 12)
    record["engine2"] = {}
    for kvq in (False, True):
        for k in per_call:
            per_call[k] = 0
        eng = ServeEngine(cfg2, params2, max_batch=8, max_len=ENGINE_M, kv_quant=kvq,
                          decode_quantum=4)
        reqs = [eng.submit(p, m) for p, m in zip(prompts2, news2)]
        with swapped(each_call_checked):
            eng.run()
        checked = {k: v for k, v in per_call.items() if v}
        if per_call["decode_attention"] != cfg2.n_layers * eng.stats["steps"]:
            fail(f"2-layer engine int8={kvq}: K7 held {per_call['decode_attention']} times for "
                 f"{eng.stats['steps']} decode steps")
        if not all(r.done and len(r.out) == m and all(0 <= t < cfg2.vocab_size for t in r.out)
                   for r, m in zip(reqs, news2)):
            fail(f"2-layer engine int8={kvq}: a request did not finish with max_new valid tokens")
        print(f"2-layer llama-3-8b ServeEngine (down, int8 KV={kvq}, 12 requests, "
              f"{eng.stats['steps']} decode steps): every kernel call held against its plain "
              f"version on the engine's activations {checked}")
        record["engine2"]["int8" if kvq else "bf16"] = {"calls_checked": checked,
                                                        "steps": eng.stats["steps"]}
    del params2, eng
    torch.cuda.empty_cache()

    from pt2tpu_torch.models import decoder as tdec
    from pt2tpu_torch.models.common import causal_mask

    def set_k7(on):
        tcommon.DECODE_ATTN_KERNEL = tcommon.INT8_DECODE_ATTN_KERNEL = on

    def teacher_forced(prompt, ids, kvq, impl="auto"):
        """f32 logits at the answer's positions from one forward of prompt +
        answer[:-1] through the plain routes (no kernel launches); with kvq
        every layer writes an int8 cache and attends over its raw codes and
        scales, as the engine's layers do. For W2A8 (``impl="a8"``) the
        reference is the W2A8 route with every kernel swapped for its plain
        version."""
        toks = torch.as_tensor(list(prompt) + list(ids[:-1]), device=dev)[None]
        T = toks.shape[1]
        with torch.inference_mode():
            if impl == "a8":
                with plain_versions():
                    logits = tdec.forward(cfg, params, toks, impl="a8")
            elif not kvq:
                logits = tdec.forward(cfg, params, toks, impl="plain")
            else:
                cache = init_cache(cfg, 1, T, quantized=True, device=dev)
                h = tdec.embed_tokens(cfg, params, toks)
                cos, sin, _, _ = tdec.pos_tables(cfg, T, device=dev)
                mask = causal_mask(T, T, device=dev)
                for li in range(cfg.n_layers):
                    h = tdec.layer_forward(cfg, tdec.layer_view(params["layers"], li), h, cos,
                                           sin, mask, cache=cache, cache_pos=0, impl="plain",
                                           layer_idx=li)
                logits = tdec.unembed(cfg, params, h)
        return logits[0, len(prompt) - 1 :].float()

    def answers_held(label, prompts_, answers_, kvq, rivals=None, impl="auto", hold=True,
                     tol=TOKEN_TOL):
        """Each answer's greedy picks held to ``tol`` under its teacher-forced
        reference (``hold`` False: measured, not held). With ``rivals`` (other
        streams for the same prompts), where a rival first differs from the
        answer: the reference's logit margin between the two picks there, over
        max|logit|. Returns (worst pick gap, margins)."""
        c0 = counts()
        worst, margins = 0.0, []
        for i, (p, ids) in enumerate(zip(prompts_, answers_)):
            lf = teacher_forced(p, ids, kvq, impl)
            top = lf.abs().max(dim=1).values
            picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
            worst = max(worst, ((lf.max(dim=1).values - picked) / top).max().item())
            if rivals is not None and rivals[i] != ids:
                j = next(n for n, (a, b) in enumerate(zip(ids, rivals[i])) if a != b)
                margins.append(abs(lf[j, ids[j]] - lf[j, rivals[i][j]]).item() / top[j].item())
            del lf
        if counts() != c0:
            fail(f"{label}: the teacher-forced reference launched a kernel")
        if hold and worst > tol:
            fail(f"{label}: a pick trails the teacher-forced plain max by {worst:.3e} of "
                 f"max|logit| (> {tol})")
        return worst, margins

    stamp("4")
    # ---- 4./5. the main paths: 4 prompts x 128 ids, 32 new tokens
    B, Lp, new = 4, 128, 32
    steps = new - 1  # decode steps after the prefill

    def drive(cfg, params, label, impls, want_fn, prompts):
        """greedy_generate once per impl, every count set to 0 just before and
        read just after; then the prefill alone, timed. Returns per-impl runs."""
        greedy_generate(cfg, params, prompts[:, :16], 2)  # warm-up: allocator, cuBLAS
        torch.cuda.synchronize()
        runs = {}
        for impl in impls:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = greedy_generate(cfg, params, prompts, new, impl=impl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, want = counts(), want_fn(impl)
            if got != want:
                fail(f"main path {label} {impl}: launches {got}, want {want}")
            tally(got)
            if tuple(toks.shape) != (B, new) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
                fail(f"main path {label} {impl}: bad tokens {tuple(toks.shape)}")
            runs[impl] = {"wall_s": wall, "launches": got, "tokens": toks.tolist()}
        for impl in impls:
            with torch.inference_mode():
                cache = init_cache(cfg, B, Lp + new, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = forward_cached(cfg, params, prompts, cache, 0, impl)
                torch.cuda.synchronize()
                pre = time.perf_counter() - t0
            if not bool(torch.isfinite(logits.float()).all()) or tuple(logits.shape) != (B, cfg.vocab_size):
                fail(f"main path {label} {impl}: prefill logits not finite or misshapen")
            r = runs[impl]
            r["prefill_s"] = pre
            r["prefill_tok_s"] = B * Lp / pre
            r["decode_s"] = r["wall_s"] - pre
            r["decode_tok_s"] = B * steps / r["decode_s"]
            print(f"main path {label} {cfg.n_layers}L {impl}: {B}x{Lp} prompt, {new} new: launches "
                  f"{r['launches']}; prefill {r['prefill_tok_s']:.1f} tok/s, decode "
                  f"{r['decode_tok_s']:.1f} tok/s (wall {r['wall_s']:.2f} s) on {record['smi']}")
            del cache, logits
        return runs

    def build(name, layout, seed, n_layers=None):
        cfg = get_config(name)
        if n_layers is not None:
            cfg = cfg.with_(n_layers=n_layers)
        t0 = time.perf_counter()
        params = random_ternary_params(cfg, seed=seed, perm_mode=layout, device=dev)
        torch.cuda.synchronize()
        return cfg, params, time.perf_counter() - t0

    # 4. llama-2-7b, "down" layout, 8 of its 32 layers (the run's time
    # budget, 16 before phase 31; 10b and 11b run the same model): K1 alone, 4 per layer at
    # prefill and each step; the 512-row prefill on the tensor cores (bf16:
    # "tc", W2A8: "tc_a8"), decode (4 rows) on the decode kernel (bf16) or
    # the CUDA cores (W2A8)
    cfg, params, record["model_build_s"] = build("llama-2-7b", "down", 2, n_layers=8)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=g, device=dev)
    L = cfg.n_layers
    none = dict.fromkeys(counts(), 0)
    # the floor probe's routes (phases 23d and 24): (name, routing flags,
    # K1_DEC_A8); P2 with K1_DEC_A8 puts K6's decode rows on its decode path
    FLOOR_FLAG_SETS = (("defaults", None, False), ("K1_DEC_A8", None, True), ("P2", P2, False),
                       ("P2 K1_DEC_A8", P2, True))
    FLOOR_WRAPPERS = (("ternary_matmul", ("dec", "tc_a8")), ("ternary_matmul_igathered", ("dec", "tc")),
                      ("ternary_matmul_gathered", ("dec", "tc")), ("ternary_matmul_idx", ("dec",)),
                      ("ternary_matmul_igathered_idx", ("dec",)),
                      ("ternary_matmul_gathered_idx", ("dec",)))

    def floor_instances(c):
        """A floor8 run's launches by FLOOR instance ("<wrapper>" its CUDA
        cores, "<wrapper>_<path>" the others): every K1 / K3 / K6 / K1s /
        K3s / K6s call of such a run is the floor's."""
        out = {}
        for w, paths in FLOOR_WRAPPERS:
            rest = c[w]
            for p_ in paths:
                out[f"{w}_{p_}"] = c[f"{w}_{p_}"]
                rest -= c[f"{w}_{p_}"]
            out[w] = rest
        return out

    def want_7b(impl, dec_on=None):
        """dec_on None: as routed outside k1_dec (bf16 decode rows on the
        decode kernel, W2A8 ones on the CUDA cores)."""
        dec_on = impl == "auto" if dec_on is None else dec_on
        return dict(none, ternary_matmul=4 * L * new,
                    ternary_matmul_tc=4 * L if impl == "auto" else 0,
                    ternary_matmul_tc_a8=4 * L if impl == "a8" else 0,
                    ternary_matmul_dec=4 * L * steps if dec_on else 0)

    runs = drive(cfg, params, "llama-2-7b", ("auto", "a8"), want_7b, prompts)
    record["main_path"] = runs
    main_launches = {  # K1's CUDA-core and decode launches: at the end, from run_totals
        "ternary_matmul_tc": sum(r["launches"]["ternary_matmul_tc"] for r in runs.values()),
        "ternary_matmul_tc_a8": sum(r["launches"]["ternary_matmul_tc_a8"] for r in runs.values())}
    record["decode_step"] = profile_decode_step(cfg, params, prompts, Lp, new, dev, "llama-2-7b down")

    # lockstep prefill (4 x 128 ids = 512 rows per projection) with K1 on the
    # tensor cores and with every K1 call on the CUDA cores, in turns
    pre_ab = {"tc": [], "cuda_core": []}
    for on in TC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
        zero_counts()
        with k1_tc(on), torch.inference_mode():
            cache = init_cache(cfg, B, Lp + new, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = forward_cached(cfg, params, prompts, cache, 0, "auto")
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
        c = counts()
        if (c["ternary_matmul"], c["ternary_matmul_tc"]) != (4 * L, 4 * L if on else 0) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"prefill A/B tc={on}: launches {c} or logits not finite")
        tally(c)
        pre_ab["tc" if on else "cuda_core"].append(B * Lp / pre_s)
        del cache, logits
    record["prefill_ab"] = pre_ab
    print(f"lockstep prefill llama-2-7b down {B}x{Lp} ids, {L} layers, K1 on the tensor cores / on "
          f"the CUDA cores (in turns tc, cc): "
          f"{' / '.join(f'{v:.1f}' for v in pre_ab['tc'])} tok/s vs "
          f"{' / '.join(f'{v:.1f}' for v in pre_ab['cuda_core'])} tok/s on {record['smi']}")

    stamp("10b")
    # ---- 10b. the lockstep W2A8 prefill with K1 on the int8 tensor cores
    # and on the CUDA cores, in turns on, off
    pre_a8 = {"tc_a8": [], "cuda_core": []}
    for on in TC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
        zero_counts()
        with k1_tc(on), torch.inference_mode():
            cache = init_cache(cfg, B, Lp + new, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = forward_cached(cfg, params, prompts, cache, 0, "a8")
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
        c = counts()
        if c != dict(none, ternary_matmul=4 * L, ternary_matmul_tc_a8=4 * L if on else 0) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"W2A8 prefill A/B tc_a8={on}: launches {c} or logits not finite")
        tally(c)
        pre_a8["tc_a8" if on else "cuda_core"].append(B * Lp / pre_s)
        del cache, logits
    record["prefill_a8_ab"] = pre_a8
    print(f"lockstep W2A8 prefill llama-2-7b down {B}x{Lp} ids, {L} layers, K1 on the int8 tensor "
          f"cores / on the CUDA cores (in turns on, off): "
          f"{' / '.join(f'{v:.1f}' for v in pre_a8['tc_a8'])} tok/s vs "
          f"{' / '.join(f'{v:.1f}' for v in pre_a8['cuda_core'])} tok/s on {record['smi']}")

    stamp("11b")
    # ---- 11b. the lockstep llama-2-7b decode with K1's decode rows on the
    # decode kernel and on the CUDA cores (K1_DEC_MAX_ROWS 0), in two turns,
    # on then off (a settled A/B, cut from four turns to keep the run
    # near its time budget), bf16 and W2A8: greedy_generate with exact counts, the
    # decode's share of its wall (less a separate prefill), then one decode
    # step's wall and its profiled device time
    DEC_AB = (True, False, False, True)
    dec_ab = {}
    for impl in ("auto", "a8"):
        res = {"dec": [], "cuda_core": []}
        for on in DEC_AB[:2]:
            with k1_dec(on):
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = greedy_generate(cfg, params, prompts, new, impl=impl)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = counts()
                if got != want_7b(impl, on):
                    fail(f"lockstep decode A/B {impl} dec={on}: launches {got}, want "
                         f"{want_7b(impl, on)}")
                tally(got)
                with torch.inference_mode():
                    cache = init_cache(cfg, B, Lp + new, device=dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    forward_cached(cfg, params, prompts, cache, 0, impl)
                    torch.cuda.synchronize()
                    pre = time.perf_counter() - t0
                del cache
                prof = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                           f"llama-2-7b down {impl}, K1 decode kernel "
                                           f"{'on' if on else 'off'}", impl)
            dec_s = wall - pre
            res["dec" if on else "cuda_core"].append({
                "decode_tok_s": B * steps / dec_s, "decode_s": dec_s, "wall_s": wall,
                "step_wall_ms": prof["wall_ms"], "step_device_ms": prof["device_ms"],
                "top": prof["top"], "streams_equal_to_main_run": sum(
                    a == b for a, b in zip(toks.tolist(), runs[impl]["tokens"]))})
        dec_ab[impl] = res
        for k, v in res.items():
            each = lambda key: " / ".join(f"{r[key]:.2f}" for r in v)  # noqa: E731
            print(f"lockstep decode A/B llama-2-7b {impl}, K1 decode rows on "
                  f"{'the decode kernel' if k == 'dec' else 'the CUDA cores'}: decode "
                  f"{each('decode_tok_s')} tok/s, step wall {each('step_wall_ms')} ms, step device "
                  f"time {each('step_device_ms')} ms (profiler); streams equal to the main run's "
                  f"{[r['streams_equal_to_main_run'] for r in v]} on {record['smi']}")
    record["lockstep_decode_ab"] = dec_ab
    del params
    torch.cuda.empty_cache()

    # 5. llama-3-8b, full-SSR layout: prefill K4 x3 (its rows path: 512
    # rows) + K1 x4 per layer; each
    # decode step K3 x2 (qkv, o) + K2 per layer ("auto"), or K3 x3 (qkv, o,
    # gateup) + K1 (down) per layer (W2A8: the fused MLP takes "auto" only).
    # bf16 decode rows run K3's decode path, W2A8 ones its CUDA-core kernel
    # Every path on this model (the lockstep paths 5, 13b, 16b, 8, 17b, 18b,
    # 20b and the engines of run E and 14b) runs 8 of its 32 layers (the
    # run's time budget, 16 before phase 31)
    cfg, params, record["model_build_8b_s"] = build("llama-3-8b", "ssr", 4, n_layers=8)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=g, device=dev)
    L = cfg.n_layers
    want_ssr = {  # bf16 decode: every K3 launch on its decode path; W2A8: none
        "auto": dict(none, ternary_matmul=4 * L, ternary_matmul_tc=4 * L,
                     ternary_matmul_igathered=2 * L * steps,
                     ternary_matmul_igathered_dec=2 * L * steps, ternary_mlp=L * steps,
                     ternary_mlp_dec=L * steps, onehot_gather=3 * L, onehot_gather_rows=3 * L),
        "a8": dict(none, ternary_matmul=4 * L + L * steps, ternary_matmul_tc_a8=4 * L,
                   ternary_matmul_igathered=3 * L * steps, onehot_gather=3 * L,
                   onehot_gather_rows=3 * L),
    }
    runs = drive(cfg, params, "llama-3-8b ssr", ("auto", "a8"), want_ssr.get, prompts)
    record["main_path_8b_ssr"] = runs
    main_launches["ternary_matmul_igathered"] = sum(
        r["launches"]["ternary_matmul_igathered"] for r in runs.values())
    # the CUDA-core K3's own: its decode and tensor-core paths' launches are
    # counted apart
    main_launches["ternary_matmul_igathered"] -= sum(
        r["launches"][k] for r in runs.values()
        for k in ("ternary_matmul_igathered_dec", "ternary_matmul_igathered_tc"))
    record["decode_step_8b_ssr"] = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                                       "llama-3-8b ssr")

    stamp("13b")
    # ---- 13b. the lockstep llama-3-8b "ssr" bf16 decode with K3's decode
    # rows on the decode kernel (as routed) and on the CUDA cores
    # (K1_DEC_MAX_ROWS 0), in turns on, off (two: a settled A/B, cut from four
    # for the run's time budget): greedy_generate with
    # exact counts, the decode's share of its wall (less a separate prefill),
    # then one decode step's wall and its profiled device time
    k3_ab = {"dec": [], "cuda_core": []}
    for on in DEC_AB[:2]:  # two turns (settled; the run's time budget)
        want = want_ssr["auto"] if on else dict(want_ssr["auto"], ternary_matmul_igathered_dec=0)
        with contextlib.nullcontext() if on else k1_dec(False):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = greedy_generate(cfg, params, prompts, new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
            if got != want:
                fail(f"lockstep ssr decode A/B dec={on}: launches {got}, want {want}")
            tally(got)
            with torch.inference_mode():
                cache = init_cache(cfg, B, Lp + new, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward_cached(cfg, params, prompts, cache, 0, "auto")
                torch.cuda.synchronize()
                pre = time.perf_counter() - t0
            del cache
            prof = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                       f"llama-3-8b ssr, K3 decode rows on the "
                                       f"{'decode kernel' if on else 'CUDA cores'}")
        dec_s = wall - pre
        k3_ab["dec" if on else "cuda_core"].append({
            "decode_tok_s": B * steps / dec_s, "decode_s": dec_s, "wall_s": wall,
            "step_wall_ms": prof["wall_ms"], "step_device_ms": prof["device_ms"],
            "top": prof["top"], "streams_equal_to_main_run": sum(
                a == b for a, b in zip(toks.tolist(), runs["auto"]["tokens"]))})
    record["lockstep_ssr_k3_ab"] = k3_ab
    for k, v in k3_ab.items():
        each = lambda key: " / ".join(f"{r[key]:.2f}" for r in v)  # noqa: E731
        print(f"lockstep decode A/B llama-3-8b ssr bf16, K3 decode rows on "
              f"{'the decode kernel' if k == 'dec' else 'the CUDA cores'}: decode "
              f"{each('decode_tok_s')} tok/s, step wall {each('step_wall_ms')} ms, step device "
              f"time {each('step_device_ms')} ms (profiler); streams equal to the main run's "
              f"{[r['streams_equal_to_main_run'] for r in v]} on {record['smi']}")

    stamp("16b")
    # ---- 16b. K2's decode rows on its decode path (on) and on the
    # CUDA-core K2 (off: k2_dec(False)), in turns on, off: here the
    # lockstep llama-3-8b "ssr" bf16 decode at B 4 (a short greedy_generate,
    # 16 new tokens, with exact counts; its decode tok/s from 15 decode
    # steps timed back to back after a prefill; then one decode step's wall
    # and its profiled device time); the "down" engine after 11c and
    # gemma-2b's in 12c (engine_k2_ab, in 2 turns)
    new16 = 16
    k2dec_ab = {"dec": [], "cuda_core": []}
    for on in DEC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
        want = dict(none, ternary_matmul=4 * L, ternary_matmul_tc=4 * L,
                    ternary_matmul_igathered=2 * L * (new16 - 1),
                    ternary_matmul_igathered_dec=2 * L * (new16 - 1), ternary_mlp=L * (new16 - 1),
                    ternary_mlp_dec=L * (new16 - 1) if on else 0, onehot_gather=3 * L,
                    onehot_gather_rows=3 * L)
        with k2_dec(on):
            zero_counts()
            greedy_generate(cfg, params, prompts, new16)
            torch.cuda.synchronize()
            got = counts()
            if got != want:
                fail(f"lockstep ssr K2 decode A/B dec={on}: launches {got}, want {want}")
            tally(got)
            with torch.inference_mode():
                cache = init_cache(cfg, B, Lp + new16, device=dev)
                forward_cached(cfg, params, prompts, cache, 0, "auto")
                tok = prompts[:, :1].contiguous()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(new16 - 1):
                    forward_cached(cfg, params, tok, cache, Lp + i, "auto")
                torch.cuda.synchronize()
                dec_s = time.perf_counter() - t0
            del cache
            prof = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                       f"llama-3-8b ssr, K2 decode rows on the "
                                       f"{'decode path' if on else 'CUDA cores'}")
        k2dec_ab["dec" if on else "cuda_core"].append({
            "decode_tok_s": B * (new16 - 1) / dec_s, "step_wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"], "k2_parts": prof["k2_parts"], "top": prof["top"]})
    record["k2_dec_ab"] = {"lockstep llama-3-8b ssr B 4": k2_dec_ab_summary(
        "lockstep llama-3-8b ssr, B 4", k2dec_ab)}

    stamp("8")
    # ---- 8. this slice's main paths, on the same model and prompts. P1
    # (GATHER_KERNEL "packed"): the prefill gathers through K5 where K4 ran;
    # decode as above. P2 (also IGATHER_FUSED off, FUSED_GATHER on): decode
    # runs K6 where K3 ran (qkv and o; gateup too in W2A8)
    default_tokens = {impl: r["tokens"] for impl, r in runs.items()}
    record["main_path_8b_ssr_packed"] = {}
    for flags_name, flags, fused in (("P1", P1, "ternary_matmul_igathered"),
                                     ("P2", P2, "ternary_matmul_gathered")):
        # bf16 decode rows (B 4) on K3's or K6's decode path; W2A8 ones on
        # their CUDA-core kernels
        dec_p = {("ternary_matmul_igathered_dec" if flags_name == "P1"
                  else "ternary_matmul_gathered_dec"): 2 * L * steps}
        want_p = {
            "auto": dict(none, ternary_matmul=4 * L, ternary_matmul_tc=4 * L, ternary_mlp=L * steps,
                         ternary_mlp_dec=L * steps, onehot_matmul=3 * L, onehot_matmul_rows=3 * L,
                         **{fused: 2 * L * steps}, **dec_p),
            "a8": dict(none, ternary_matmul=4 * L + L * steps, ternary_matmul_tc_a8=4 * L,
                       onehot_matmul=3 * L, onehot_matmul_rows=3 * L, **{fused: 3 * L * steps}),
        }
        with route_flags(flags):
            runs_p = drive(cfg, params, f"llama-3-8b ssr {flags_name}", ("auto", "a8"),
                           want_p.get, prompts)
        for impl, r in runs_p.items():
            same = sum(a == b for a, b in zip(r["tokens"], default_tokens[impl]))
            r["streams_equal_to_default"] = same
            if flags_name == "P1" and same != B:
                fail(f"P1 {impl}: {B - same} of {B} streams differ from the default ssr run "
                     "(K5 is bit-exact to K4)")
            if flags_name == "P2":
                r["worst_pick_gap"], _ = answers_held(
                    f"P2 {impl} answers", [p.tolist() for p in prompts], r["tokens"], False,
                    impl=impl)
                print(f"P2 {impl}: {same}/{B} streams equal to the default ssr run's; every pick "
                      f"within {r['worst_pick_gap']:.2e} of the teacher-forced "
                      f"{'W2A8 plain-version' if impl == 'a8' else 'plain'} max (<= {TOKEN_TOL})")
        if flags_name == "P2":
            # the W2A8 route once more with the down projection's decode rows
            # on the decode kernel (K1_DEC_A8, off by default): its answers'
            # gap, measured beside the default route's, not held
            with route_flags(P2), k1_dec(True):
                zero_counts()
                toks = greedy_generate(cfg, params, prompts, new, impl="a8")
                torch.cuda.synchronize()
                got = counts()
                if got != dict(want_p["a8"], ternary_matmul_dec=L * steps,
                               ternary_matmul_gathered_dec=3 * L * steps):
                    fail(f"P2 a8 with the W2A8 decode kernel on: launches {got}")
                tally(got)
            gap_on, _ = answers_held("P2 a8 answers, decode rows on the decode kernel",
                                     [p.tolist() for p in prompts], toks.tolist(), False,
                                     impl="a8", hold=False)
            runs_p["a8"]["worst_pick_gap_w2a8_decode_kernel"] = gap_on
            print(f"P2 a8 with K1's W2A8 decode rows on the decode kernel (K1_DEC_A8, not the "
                  f"default): every pick within {gap_on:.2e} of the teacher-forced W2A8 "
                  f"plain-version max (measured, not held); default route (CUDA cores): "
                  f"{runs_p['a8']['worst_pick_gap']:.2e}")
        if flags_name == "P1":
            print("P1: greedy tokens identical to the default ssr run's (bf16 and W2A8)")
        record["main_path_8b_ssr_packed"][flags_name] = runs_p
    with route_flags(P2):
        record["decode_step_8b_ssr_p2"] = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                                              "llama-3-8b ssr, P2 flags")

    stamp("17b")
    # ---- 17b. the lockstep llama-3-8b "ssr" bf16 decode at B 4 under the P2
    # flags with K6's decode rows on its decode path (on) and on the
    # CUDA-core K6 (off: k6_paths(False)), in turns on, off (cut from four: a
    # settled A/B, the run's time budget): a
    # short greedy_generate (16 new tokens) with exact counts, 15 decode
    # steps timed back to back after a prefill (decode tok/s), then one
    # decode step's wall and its profiled device time with K6's part: in an
    # "on" turn the plane gather plus K1's decode kernel less that kernel's
    # mean over the "off" turns (where it runs K2's down alone), in an "off"
    # turn the CUDA-core K6 and its chunk sum
    k6_ab = {"on": [], "off": []}
    for on in DEC_AB[:2]:  # two turns (settled; the run's time budget)
        want = dict(none, ternary_matmul=4 * L, ternary_matmul_tc=4 * L, onehot_matmul=3 * L,
                    onehot_matmul_rows=3 * L, ternary_matmul_gathered=2 * L * (new16 - 1),
                    ternary_matmul_gathered_dec=2 * L * (new16 - 1) if on else 0,
                    ternary_mlp=L * (new16 - 1), ternary_mlp_dec=L * (new16 - 1))
        with route_flags(P2), k6_paths(on):
            zero_counts()
            greedy_generate(cfg, params, prompts, new16)
            torch.cuda.synchronize()
            got = counts()
            if got != want:
                fail(f"lockstep ssr P2 K6 A/B on={on}: launches {got}, want {want}")
            tally(got)
            with torch.inference_mode():
                cache = init_cache(cfg, B, Lp + new16, device=dev)
                forward_cached(cfg, params, prompts, cache, 0, "auto")
                tok = prompts[:, :1].contiguous()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(new16 - 1):
                    forward_cached(cfg, params, tok, cache, Lp + i, "auto")
                torch.cuda.synchronize()
                dec_s = time.perf_counter() - t0
            del cache
            prof = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                       f"llama-3-8b ssr, P2 flags, K6 decode rows on "
                                       f"{'its decode path' if on else 'the CUDA cores'}")
        k6_ab["on" if on else "off"].append({
            "decode_tok_s": B * (new16 - 1) / dec_s, "step_wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"], "k6_parts": prof["k6_parts"], "top": prof["top"]})
    k2_down_ms = sum(r["k6_parts"]["dec_kernel"] for r in k6_ab["off"]) / len(k6_ab["off"])
    for k, rows in k6_ab.items():
        for r in rows:
            p = r["k6_parts"]
            r["k6_ms"] = (p["gather"] + p["dec_kernel"] - k2_down_ms if k == "on"
                          else p["cuda_core"] + p["cuda_core_sum"])
            r["k6_share"] = r["k6_ms"] / r["device_ms"] if r["device_ms"] else 0.0
        each = lambda key, scale=1.0, rows=rows: " / ".join(  # noqa: E731
            f"{scale * r[key]:.2f}" for r in rows)
        print(f"K6 decode A/B, lockstep llama-3-8b ssr, P2 flags, B 4, K6's decode rows on "
              f"{'its decode path' if k == 'on' else 'the CUDA cores'} (in turns on, off, off, "
              f"on): step device time {each('device_ms')} ms, K6 {each('k6_ms')} ms "
              f"({each('k6_share', 100.0)} %), step wall {each('step_wall_ms')} ms, decode "
              f"{each('decode_tok_s')} tok/s on {record['smi']}")
    record["lockstep_ssr_p2_k6_ab"] = k6_ab

    stamp("18b")
    # ---- 18b. one lockstep prefill (4 x 128 = 512 rows) of the same
    # llama-3-8b "ssr" model (8 layers) under the P1 flags, K5's 512-row
    # gathers on its rows path (on) or on K5's first kernel (off:
    # k5_rows(False)), in turns on, off (cut from four: a settled A/B, the
    # run's time budget; phase 8 ran this prefill
    # already: warm): one with exact counts and its wall (host clock,
    # synchronised), then one under torch.profiler (device activity only):
    # device time, K5's part (the lane map and the rows kernel, or the first
    # kernel) and its share
    from torch.profiler import ProfilerActivity, profile

    k5_ab = {"on": [], "off": []}
    for on in DEC_AB[:2]:  # two turns (settled; the run's time budget)
        want = dict(none, ternary_matmul=4 * L, ternary_matmul_tc=4 * L, onehot_matmul=3 * L,
                    onehot_matmul_rows=3 * L if on else 0)
        with route_flags(P1), k5_rows(on), torch.inference_mode():
            cache = init_cache(cfg, B, Lp + new, device=dev)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            forward_cached(cfg, params, prompts, cache, 0, "auto")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            got = counts()
            if got != want:
                fail(f"lockstep ssr P1 prefill K5 A/B on={on}: launches {got}, want {want}")
            tally(got)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                forward_cached(cfg, params, prompts, cache, 0, "auto")
                torch.cuda.synchronize()
            del cache
        krows = kernel_rows(prof)
        device_ms = sum(r[0] for r in krows)
        parts = k5_parts(krows)
        k5_ms = parts["lane_map"] + parts["rows"] if on else parts["cuda_core"]
        k5_ab["on" if on else "off"].append({
            "wall_ms": wall_ms, "device_ms": device_ms, "k5_parts": parts, "k5_ms": k5_ms,
            "k5_share": k5_ms / device_ms if device_ms else 0.0,
            "top": [{"ms": ms, "count": c, "name": k[:90]} for ms, c, k in krows[:6]]})
    for k, rows_ in k5_ab.items():
        each = lambda key, scale=1.0, rows_=rows_: " / ".join(  # noqa: E731
            f"{scale * r[key]:.3f}" for r in rows_)
        print(f"K5 prefill A/B, lockstep llama-3-8b ssr, P1 flags, 512 rows, K5 on "
              f"{'its rows path' if k == 'on' else 'its first kernel'} (in turns on, off): "
              f"prefill device time {each('device_ms')} ms, K5 {each('k5_ms')} ms "
              f"({each('k5_share', 100.0)} %), prefill wall {each('wall_ms')} ms on "
              f"{record['smi']}")
    record["lockstep_ssr_p1_prefill_k5_ab"] = k5_ab

    stamp("20b")
    # ---- 20b. the same 512-row lockstep prefill under the default flags
    # (phase 5's: K4's three gathers a layer, then K1 on the tensor cores;
    # warm), K4's gathers on its rows path (on) or on K4's first kernel (off:
    # k4_rows(False)), in turns on, off: one with exact counts, its
    # wall (host clock, synchronised) and its logits, the same bits in every
    # turn, then one under torch.profiler (device activity only): device
    # time, K4's part and its share. Then greedy_generate with K4 off: the
    # main run's tokens
    k4_ab = {"on": [], "off": []}
    ref_logits = None
    for on in DEC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
        want = dict(none, ternary_matmul=4 * L, ternary_matmul_tc=4 * L, onehot_gather=3 * L,
                    onehot_gather_rows=3 * L if on else 0)
        with k4_rows(on), torch.inference_mode():
            cache = init_cache(cfg, B, Lp + new, device=dev)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            logits, _ = forward_cached(cfg, params, prompts, cache, 0, "auto")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            got = counts()
            if got != want:
                fail(f"lockstep ssr prefill K4 A/B on={on}: launches {got}, want {want}")
            tally(got)
            if ref_logits is None:
                ref_logits = logits.clone()
            elif not torch.equal(logits, ref_logits):
                fail(f"lockstep ssr prefill K4 A/B on={on}: logits differ from the first turn's")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                forward_cached(cfg, params, prompts, cache, 0, "auto")
                torch.cuda.synchronize()
            del cache, logits
        krows = kernel_rows(prof)
        device_ms = sum(r[0] for r in krows)
        parts = k4_parts(krows)
        k4_ms = parts["rows"] if on else parts["cuda_core"]
        k4_ab["on" if on else "off"].append({
            "wall_ms": wall_ms, "device_ms": device_ms, "k4_parts": parts, "k4_ms": k4_ms,
            "k4_share": k4_ms / device_ms if device_ms else 0.0,
            "top": [{"ms": ms, "count": c, "name": k[:90]} for ms, c, k in krows[:6]]})
    first_tokens = ref_logits.argmax(-1).tolist()
    if first_tokens != [t[0] for t in default_tokens["auto"]]:
        fail(f"lockstep ssr prefill: first tokens {first_tokens} differ from the main run's")
    with k4_rows(False):
        zero_counts()
        toks = greedy_generate(cfg, params, prompts, new)
        torch.cuda.synchronize()
        got = counts()
        if got != dict(want_ssr["auto"], onehot_gather_rows=0):
            fail(f"lockstep ssr with K4's first kernel: launches {got}")
        tally(got)
    if toks.tolist() != default_tokens["auto"]:
        fail("lockstep ssr with K4's first kernel: tokens differ from the main run's "
             "(K4's two kernels copy the same bits)")
    for k, rows_ in k4_ab.items():
        each = lambda key, scale=1.0, rows_=rows_: " / ".join(  # noqa: E731
            f"{scale * r[key]:.3f}" for r in rows_)
        print(f"K4 prefill A/B, lockstep llama-3-8b ssr, default flags, 512 rows, K4 on "
              f"{'its rows path' if k == 'on' else 'its first kernel'} (in turns on, off, off, "
              f"on): prefill device time {each('device_ms')} ms, K4 {each('k4_ms')} ms "
              f"({each('k4_share', 100.0)} %), prefill wall {each('wall_ms')} ms on "
              f"{record['smi']}")
    print("K4 prefill A/B: the same logits bit for bit in every turn; greedy_generate with K4's "
          "first kernel gives the main run's tokens")
    record["lockstep_ssr_prefill_k4_ab"] = k4_ab
    del ref_logits

    # run E: the ServeEngine over the same "ssr" model (8 layers) under the
    # P2 flags: 8 slots, max_len 2048, 16 greedy requests of 64-512 ids (one
    # of exactly 64, whose admission bucket runs K6 at 64 rows), bf16 KV,
    # quantum 1
    e_lens = [64] + host_ints(65, 512, 15)
    e_prompts, e_news = make_prompts(cfg, e_lens), host_ints(32, 64, 16)
    with route_flags(P2):
        eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M)
        reqs = [eng.submit(p, m) for p, m in zip(e_prompts, e_news)]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats["steps"]
    # an admission of <= 64 rows: K6 for qkv and o (its tensor-core path),
    # K2 for the MLP; a longer one: K5 + K1 for qkv, o and gateup, K1 for
    # down. Each decode step (B 8): K6 x2 (its decode path) + K2 + K7 per layer
    short = sum(min(_bucket(n), ENGINE_M) <= 64 for n in e_lens)
    want = dict(none, ternary_matmul_gathered=2 * L * (st + short),
                ternary_matmul_gathered_tc=2 * L * short, ternary_matmul_gathered_dec=2 * L * st,
                ternary_mlp=L * (st + short),
                ternary_mlp_tc=L * short, ternary_mlp_dec=L * st, ternary_matmul=4 * L * (16 - short),
                ternary_matmul_tc=4 * L * (16 - short),
                onehot_matmul=3 * L * (16 - short), onehot_matmul_rows=3 * L * (16 - short),
                decode_attention=L * st, decode_attention_tc=L * st)
    got = counts()
    if got != want:
        fail(f"engine ssr P2: launches {got}, want {want}")
    tally(got)
    if not all(r.done and len(r.out) == m and all(0 <= t < cfg.vocab_size for t in r.out)
               for r, m in zip(reqs, e_news)):
        fail("engine ssr P2: a request did not finish with max_new valid tokens")
    e_stats = dict(eng.stats)
    e_tok = sum(len(r.out) for r in reqs)
    worst, _ = answers_held("engine ssr P2 answers", e_prompts, [r.out for r in reqs], False)
    record["engine_ssr_p2"] = {"wall_s": wall, "tokens": e_tok, "tok_s": e_tok / wall,
                               "decode_tok_s": e_stats["tokens"] / e_stats["t_decode_s"],
                               "steps": st, "t_admit_s": e_stats["t_admit_s"],
                               "t_decode_s": e_stats["t_decode_s"], "launches": got,
                               "short_admissions": short, "worst_pick_gap": worst}
    print(f"engine llama-3-8b ssr, P2 flags, bf16 KV, quantum 1: 16 requests, {e_tok} tokens in "
          f"{wall:.2f} s ({e_tok / wall:.1f} tok/s; decode "
          f"{record['engine_ssr_p2']['decode_tok_s']:.1f} tok/s; t_admit_s "
          f"{e_stats['t_admit_s']:.2f} s), {st} decode steps, launches {got}; every pick within "
          f"{worst:.2e} of the teacher-forced plain max (<= {TOKEN_TOL}) on {record['smi']}")

    stamp("14b")
    # ---- 14b. "engine ssr default": the same "ssr" model (8 layers) under the
    # default flags, 8 slots, max_len 2048, bf16 KV, quantum 1, 16 greedy
    # requests of 9-64 ids (buckets 16, 32 and 64 each at least once), 16-32
    # new tokens. Every admission (<= 64 rows): K3 x2 (qkv, o) on its
    # tensor-core path + K2 per layer; every decode step (8 rows): K3 x2 on
    # its decode path + K2 + K7 per layer; no CUDA-core K3, no K1. Every
    # answer held to TOKEN_TOL. Then an A/B in turns on, off, off, on ("off":
    # k3_tc(False), the admissions' K3 on the CUDA cores) over the first 8
    # requests (one admission wave, every bucket), counts exact, each turn's
    # streams compared with the main run's, one 64-row admission profiled
    gh14 = torch.Generator().manual_seed(14)  # host-side lengths of this run
    d_lens = [9, 16, 17, 32, 33, 64] + torch.randint(9, 65, (10,), generator=gh14).tolist()
    d_news = torch.randint(16, 33, (16,), generator=gh14).tolist()
    d_prompts = make_prompts(cfg, d_lens, gk14)
    for lens in (d_lens, d_lens[:8]):
        buckets = sorted({min(_bucket(n), ENGINE_M) for n in lens})
        if buckets != [16, 32, 64]:
            fail(f"engine ssr default: prompt buckets {buckets}")

    def run_default(label, prompts_, news_, on):
        """One engine run with K3's admission rows on its tensor cores (on) or
        its CUDA cores, counts exact; (result, answers)."""
        with k3_tc(on):
            eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M)
            reqs = [eng.submit(p_, m_) for p_, m_ in zip(prompts_, news_)]
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st, n_adm = eng.stats["steps"], len(prompts_)
            want = dict(none, ternary_matmul_igathered=2 * L * (st + n_adm),
                        ternary_matmul_igathered_dec=2 * L * st,
                        ternary_matmul_igathered_tc=2 * L * n_adm if on else 0,
                        ternary_mlp=L * (st + n_adm), ternary_mlp_tc=L * n_adm,
                        ternary_mlp_dec=L * st, decode_attention=L * st,
                        decode_attention_tc=L * st)
            got = counts()
            if got != want:
                fail(f"{label}: launches {got}, want {want}")
            tally(got)
            if not all(r.done and len(r.out) == m_ and all(0 <= t < cfg.vocab_size for t in r.out)
                       for r, m_ in zip(reqs, news_)):
                fail(f"{label}: a request did not finish with max_new valid tokens")
            e_stats = dict(eng.stats)
            prof = profile_engine_admission(eng, d_prompts[5], f"llama-3-8b ssr, K3's admission "
                                            f"rows on the {'tensor cores' if on else 'CUDA cores'}")
        outs_ = [r.out for r in reqs]
        n_tok = sum(len(o_) for o_ in outs_)
        return {"wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
                "decode_tok_s": e_stats["tokens"] / e_stats["t_decode_s"], "steps": st,
                "t_admit_s": e_stats["t_admit_s"], "t_decode_s": e_stats["t_decode_s"],
                "launches": got, "admission_64_wall_ms": prof["wall_ms"],
                "admission_64_device_ms": prof["device_ms"], "admission_64_top": prof["top"]}, outs_

    d_main, d_outs = run_default("engine ssr default", d_prompts, d_news, True)
    d_main["worst_pick_gap"], _ = answers_held("engine ssr default answers", d_prompts, d_outs,
                                               False)
    print(f"engine ssr default (llama-3-8b, {L} layers, bf16 KV, quantum 1): 16 requests of 9-64 "
          f"ids, {d_main['tokens']} tokens in {d_main['wall_s']:.2f} s ({d_main['tok_s']:.1f} "
          f"tok/s; decode {d_main['decode_tok_s']:.1f} tok/s; t_admit_s "
          f"{d_main['t_admit_s']:.3f} s), {d_main['steps']} decode steps, launches "
          f"{d_main['launches']}; every pick within {d_main['worst_pick_gap']:.2e} of the "
          f"teacher-forced plain max (<= {TOKEN_TOL}) on {record['smi']}")
    d_ab = {"tc": [], "cuda_core": []}
    for on in DEC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
        res, outs_ = run_default(f"engine ssr default A/B tc={on}", d_prompts[:8], d_news[:8], on)
        res["streams_equal_to_main_run"] = sum(a == b for a, b in zip(outs_, d_outs))
        if not on and not d_ab["cuda_core"] and res["streams_equal_to_main_run"] < 8:
            res["worst_pick_gap"], _ = answers_held(  # the CUDA-core route's answers, measured
                "engine ssr default answers, K3 admissions on the CUDA cores", d_prompts[:8],
                outs_, False, hold=False)
        d_ab["tc" if on else "cuda_core"].append(res)
    # 15b. K2's admission rows on its tensor-core path (on) or on the CUDA
    # cores (off: k2_tc(False)), in turns on, off (cut from four: a settled
    # A/B, the run's time budget): one 16-id and
    # one 64-id prompt, each admitted alone twice by profile_engine_admission
    # (the second under torch.profiler), counts exact: per admission K3 x2
    # on its tensor-core path and K2 per layer, K2's on its tensor-core path
    # in the "on" turns only
    k2_ab = {"tc": [], "cuda_core": []}
    eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M)
    for on in DEC_AB[:2]:  # two turns (settled; the run's time budget)
        res = {}
        with k2_tc(on):
            for p_ in (d_prompts[1], d_prompts[5]):  # 16 and 64 ids: buckets 16, 64
                zero_counts()
                prof = profile_engine_admission(
                    eng, p_, f"llama-3-8b ssr, K2's admission rows on the "
                    f"{'tensor cores' if on else 'CUDA cores'}")
                got = counts()
                want = dict(none, ternary_matmul_igathered=4 * L, ternary_matmul_igathered_tc=4 * L,
                            ternary_mlp=2 * L, ternary_mlp_tc=2 * L if on else 0)
                if got != want:
                    fail(f"K2 admission A/B tc={on}, {len(p_)} ids: launches {got}, want {want}")
                tally(got)
                res[len(p_)] = prof
        k2_ab["tc" if on else "cuda_core"].append(res)
    for k, v in k2_ab.items():
        for n_ids in (16, 64):
            each = lambda key: " / ".join(f"{r[n_ids][key]:.2f}" for r in v)  # noqa: E731
            print(f"K2 admission A/B, one {n_ids}-id admission, K2's rows on "
                  f"{'the tensor cores' if k == 'tc' else 'the CUDA cores'}: device time "
                  f"{each('device_ms')} ms (wall {each('wall_ms')} ms) on {record['smi']}")
    record["engine_ssr_default"] = {"main": d_main, "ab": d_ab, "k2_ab": k2_ab}
    for k, v in d_ab.items():
        each = lambda key: " / ".join(f"{r[key]:.3f}" for r in v)  # noqa: E731
        print(f"engine ssr default A/B, 8 requests of 9-64 ids, K3's admission rows on "
              f"{'the tensor cores' if k == 'tc' else 'the CUDA cores'}: t_admit_s "
              f"{each('t_admit_s')} s, {each('tok_s')} tok/s, decode {each('decode_tok_s')} tok/s, "
              f"one 64-row admission {each('admission_64_device_ms')} ms of device time (wall "
              f"{each('admission_64_wall_ms')} ms); streams equal to the main run's "
              f"{[r['streams_equal_to_main_run'] for r in v]}; worst pick gap (measured) "
              f"{[r['worst_pick_gap'] for r in v if 'worst_pick_gap' in r]} on {record['smi']}")
    del params, eng, reqs
    torch.cuda.empty_cache()

    # the same model in the "down" layout: K2 without its gather; K1 runs
    # qkv and o only at each decode step (2 per layer and step fewer)
    cfg, params, _ = build("llama-3-8b", "down", 5)
    L = cfg.n_layers  # the lockstep "down" path at all 32 layers
    want_down = dict(none, ternary_matmul=4 * L + 2 * L * steps, ternary_matmul_tc=4 * L,
                     ternary_matmul_dec=2 * L * steps, ternary_mlp=L * steps,
                     ternary_mlp_dec=L * steps)
    record["main_path_8b_down"] = drive(cfg, params, "llama-3-8b down", ("auto",),
                                        lambda impl: want_down, prompts)

    stamp("5b")
    # ---- 5b. the serving slice's main path: the ServeEngine over the same
    # llama-3-8b "down" model at 4 of its 32 layers (the run's time budget:
    # 16 until phase 23 was added, 8 until phase 31), 8 slots, max_len 2048,
    # 16 greedy requests. 5b's runs and held answers, 10c, 11c, 16b's engine
    # A/B, the server (5c) and 19b's steps run these 4 layers (the first 4
    # of its stacked weights: every loop runs over cfg.n_layers)
    cfg, L = cfg.with_(n_layers=4), 4
    eng_prompts = make_prompts(cfg, host_ints(64, 512, 16))
    eng_news = host_ints(32, 64, 16)

    def engine_want(eng, prompts_, k7_on=True, tc_on=True, impl="auto", dec_on=None,
                    k2_dec_on=True):
        """Launches the routing implies: each admission prefills its bucket
        (>= 64 rows: qkv, o through K1 on the tensor cores; the MLP through
        K2 at <= 64 rows, else K1 x2); each decode step (8 rows) K1 x2 on the
        decode kernel + K2 + K7 per layer (K7 none when it is off; on its
        tensor-core kernel while k7.K7_TC holds). W2A8
        keeps the two-call MLP: K1 x4 per layer at every admission (on the
        int8 tensor cores) and every decode step (on the CUDA cores). K2's
        admission rows (16-64) run its tensor-core path. A
        gemma model's K2 launches are all GeGLU, its K7 launches all at hd
        256. With
        tc_on False (K1_TC_MIN_ROWS rebound) no launch takes the tensor
        cores; dec_on True / False (k1_dec) puts the decode steps' K1 calls
        of both modes on the decode kernel / the CUDA cores; k2_dec_on
        (k2_dec) the decode steps' K2 calls on its decode path, else on the
        CUDA-core K2."""
        dec_on = impl == "auto" if dec_on is None else dec_on
        st = eng.stats["steps"]
        k7n = L * st if k7_on else 0
        k7tc = k7n if k7.K7_TC else 0
        if impl == "a8":
            tc = 4 * L * len(prompts_)
            return dict(none, ternary_matmul=4 * L * st + tc,
                        ternary_matmul_tc_a8=tc if tc_on else 0,
                        ternary_matmul_dec=4 * L * st if dec_on else 0, decode_attention=k7n,
                        decode_attention_tc=k7tc)
        tc, k2n, k2tc = 0, L * st, 0
        for p in prompts_:
            Lb = min(_bucket(len(p)), ENGINE_M)
            tc += 2 * L + (2 * L if Lb > 64 else 0)
            k2tc += L if Lb <= 64 else 0
        k2n += k2tc
        return dict(none, ternary_matmul=2 * L * st + tc, ternary_matmul_tc=tc if tc_on else 0,
                    ternary_matmul_dec=2 * L * st if dec_on else 0, ternary_mlp=k2n,
                    ternary_mlp_tc=k2tc, ternary_mlp_dec=L * st if k2_dec_on else 0,
                    decode_attention=k7n, decode_attention_tc=k7tc,
                    ternary_mlp_gelu=k2n if cfg.act == "gelu" else 0,
                    decode_attention_hd256=k7n if cfg.hd == 256 else 0)

    def run_engine(label, kvq, quantum, prompts_, news_, sampling=None, seed=0, k7_on=True,
                   tc_on=True, impl="auto", dec_on=None, k2_dec_on=True):
        eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M, kv_quant=kvq,
                          decode_quantum=quantum, seed=seed, impl=impl)
        reqs = [eng.submit(p, m, sampling=sampling) for p, m in zip(prompts_, news_)]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want = counts(), engine_want(eng, prompts_, k7_on, tc_on, impl, dec_on, k2_dec_on)
        if got != want:
            fail(f"engine {label}: launches {got}, want {want}")
        tally(got)
        if not all(r.done and len(r.out) == m and all(0 <= t < cfg.vocab_size for t in r.out)
                   for r, m in zip(reqs, news_)):
            fail(f"engine {label}: a request did not finish with max_new valid tokens")
        st = dict(eng.stats)
        n_tok = sum(len(r.out) for r in reqs)
        res = {"wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
               "decode_tok_s": st["tokens"] / st["t_decode_s"], "steps": st["steps"],
               "t_admit_s": st["t_admit_s"], "t_decode_s": st["t_decode_s"], "launches": got}
        print(f"engine {label}: {len(reqs)} requests, {n_tok} tokens in {wall:.2f} s "
              f"({res['tok_s']:.1f} tok/s; decode {res['decode_tok_s']:.1f} tok/s over "
              f"t_decode_s {st['t_decode_s']:.2f} s, t_admit_s {st['t_admit_s']:.2f} s), "
              f"{st['steps']} decode steps, launches {got} on {record['smi']}")
        return res, [r.out for r in reqs]

    def engine_k2_ab(name, prompts_):
        """16b for an engine (bf16 KV, quantum 1): in turns on, off (k2_dec;
        two turns, cut from eight for the run's time budget),
        a short run of 8 requests of ``prompts_`` with 32 new
        tokens each (counts exact) for its decode tok/s, then 6 decode steps
        of a second engine with its 8 slots busy, timed on the host clock,
        and one more under torch.profiler (launches_dec exact)."""
        eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M)
        for p in prompts_[:8]:
            eng.submit(p, 1024)
        eng.step()  # admits all 8; one decode step
        eng.step()
        res = {"dec": [], "cuda_core": []}
        for on in DEC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
            route = "decode path" if on else "CUDA cores"
            with k2_dec(on):
                run, _ = run_engine(f"{name} bf16 KV quantum 1, 8 requests x 32 tokens, K2 decode "
                                    f"rows on the {route}", False, 1, prompts_[:8], [32] * 8,
                                    k2_dec_on=on)
                c0 = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(6):
                    eng.step()
                wall_ms = (time.perf_counter() - t0) / 6 * 1e3
                prof = profile_engine_step(eng, f"{name}, K2 decode rows on the {route}")
                c1 = counts()
            rose = (c1["ternary_mlp"] - c0["ternary_mlp"],
                    c1["ternary_mlp_dec"] - c0["ternary_mlp_dec"])
            if rose != (7 * L, 7 * L if on else 0):
                fail(f"{name} engine decode steps, K2 decode rows on the {route}: launches and "
                     f"launches_dec rose by {rose}")
            res["dec" if on else "cuda_core"].append({
                "decode_tok_s": run["decode_tok_s"], "t_decode_s": run["t_decode_s"],
                "step_wall_ms": wall_ms, **prof})
        del eng
        torch.cuda.empty_cache()
        return k2_dec_ab_summary(f"{name} engine, 8 slots", res)

    record["engine"] = {}
    outs = {}
    k7_main = 0
    for kvq in (False, True):
        for quantum in (1, 8):
            label = f"llama-3-8b down {'int8' if kvq else 'bf16'} KV quantum {quantum}"
            res, outs[(kvq, quantum)] = run_engine(label, kvq, quantum, eng_prompts, eng_news)
            record["engine"][label] = res
            k7_main += res["launches"]["decode_attention_tc"]
        if outs[(kvq, 1)] != outs[(kvq, 8)]:
            fail(f"engine int8={kvq}: quantum 8 tokens differ from quantum 1")
    main_launches["decode_attention"] = k7_main
    print("engine: quantum 8 token-identical to quantum 1 (bf16 and int8 KV)")

    # the same engine run (bf16 KV, quantum 1) with K1's tensor-core path on
    # and off, in two turns: admission prefills are where K1 spends its rows
    eng_ab = {"tc": [], "cuda_core": []}
    for on in TC_AB[:2]:
        with k1_tc(on):
            res, ab_out = run_engine(
                f"llama-3-8b down bf16 KV quantum 1, K1 {'tensor cores' if on else 'CUDA cores'}",
                False, 1, eng_prompts, eng_news, tc_on=on)
        res["admit_share"] = res["t_admit_s"] / res["wall_s"]
        res["streams_equal_to_main_run"] = sum(a == b for a, b in zip(ab_out, outs[(False, 1)]))
        if not on and not eng_ab["cuda_core"]:  # the CUDA-core route's answers, measured
            res["worst_pick_gap"], _ = answers_held("engine bf16 KV answers, K1 on the CUDA cores",
                                                    eng_prompts, ab_out, False, hold=False)
        eng_ab["tc" if on else "cuda_core"].append(res)
    record["engine_ab"] = eng_ab
    for k, v in eng_ab.items():
        each = lambda key, scale=1.0: " / ".join(f"{scale * r[key]:.2f}" for r in v)  # noqa: E731
        print(f"engine A/B, K1 {k}: t_admit_s {each('t_admit_s')} s of a wall of "
              f"{each('wall_s')} s (admission {each('admit_share', 100.0)} %), {each('tok_s')} "
              f"tok/s; streams equal to the main run's: "
              f"{[r['streams_equal_to_main_run'] for r in v]}; worst pick gap under the "
              f"teacher-forced plain max {[r.get('worst_pick_gap') for r in v if 'worst_pick_gap' in r]}")

    stamp("10c")
    # ---- 10c. the same engine under W2A8 (impl "a8", bf16 KV, quantum 1)
    # with K1's int8 tensor-core path on (the off turn of that settled A/B
    # dropped for the run's time budget), then with K7 off;
    # every answer of each route held under the teacher-forced W2A8 route on
    # plain versions (each distinct set of answers once), to A8_TOLS' pick
    # gap, as the 2-layer W2A8 check holds it: over 32 layers the int8
    # rounding of every row amplifies f32-order and attention differences,
    # and on an H100 each of these three routes trailed that reference by
    # 2.2e-2 to 3.9e-2 of max|logit| (TOKEN_TOL is 2e-2), the CUDA-core
    # route, which this slice leaves as it was, included
    eng_a8 = {"tc_a8": [], "cuda_core": []}
    held_a8 = []  # (answers, worst pick gap) already held
    for on in TC_AB[:1]:
        with k1_tc(on):
            res, a8_out = run_engine(
                f"llama-3-8b down W2A8 bf16 KV quantum 1, K1 "
                f"{'int8 tensor cores' if on else 'CUDA cores'}", False, 1, eng_prompts, eng_news,
                tc_on=on, impl="a8")
        res["admit_share"] = res["t_admit_s"] / res["wall_s"]
        res["streams_equal_to_first_run"] = sum(
            a == b for a, b in zip(a8_out, held_a8[0][0] if held_a8 else a8_out))
        same = next((w for o, w in held_a8 if o == a8_out), None)
        if same is None:
            same, _ = answers_held(
                f"engine W2A8 answers, K1 {'int8 tensor cores' if on else 'CUDA cores'}",
                eng_prompts, a8_out, False, impl="a8", tol=A8_TOLS[1])
            held_a8.append((a8_out, same))
        res["worst_pick_gap"] = same
        if on:
            main_launches["ternary_matmul_tc_a8"] += res["launches"]["ternary_matmul_tc_a8"]
        eng_a8["tc_a8" if on else "cuda_core"].append(res)
    record["engine_a8_ab"] = eng_a8
    set_k7(False)
    res, a8_k7off = run_engine("llama-3-8b down W2A8 bf16 KV quantum 1, K7 off", False, 1,
                               eng_prompts, eng_news, k7_on=False, impl="a8")
    set_k7(True)
    res["worst_pick_gap"], _ = answers_held("engine W2A8 answers, K7 off", eng_prompts, a8_k7off,
                                            False, impl="a8", tol=A8_TOLS[1])
    res["streams_equal_to_k7_on"] = sum(a == b for a, b in zip(a8_k7off, held_a8[0][0]))
    print(f"engine W2A8, K7 off: every pick within {res['worst_pick_gap']:.3e} of the "
          f"teacher-forced W2A8 plain-version max (<= {A8_TOLS[1]}); "
          f"{res['streams_equal_to_k7_on']}/16 streams equal to K7 on's")
    record["engine_a8_k7_off"] = res
    for k, v in ((k_, v_) for k_, v_ in eng_a8.items() if v_):
        each = lambda key, scale=1.0: " / ".join(f"{scale * r[key]:.2f}" for r in v)  # noqa: E731
        print(f"engine W2A8 A/B, K1 {k}: t_admit_s {each('t_admit_s')} s of a wall of "
              f"{each('wall_s')} s (admission {each('admit_share', 100.0)} %), {each('tok_s')} "
              f"tok/s, decode {each('decode_tok_s')} tok/s; streams equal to the first run's: "
              f"{[r['streams_equal_to_first_run'] for r in v]}; every pick within "
              f"{[r['worst_pick_gap'] for r in v]} of the teacher-forced W2A8 plain-version max "
              f"(<= {A8_TOLS[1]}) on {record['smi']}, {L} layers")

    # every engine answer (quantum 1) held under its teacher-forced reference:
    # bf16 KV under the plain forward, int8 KV under a forward through an int8
    # cache; where the int8 stream leaves the bf16 one, the bf16 reference's
    # margin between the two picks there
    record["engine_answers"] = {}
    for kvq in (False, True):
        kv = "int8" if kvq else "bf16"
        worst, margins = answers_held(f"engine {kv} KV answers", eng_prompts, outs[(kvq, 1)], kvq,
                                      rivals=outs[(not kvq, 1)])
        record["engine_answers"][kv] = {"worst_pick_gap": worst, "first_split_margins": margins}
        print(f"engine {kv} KV: every pick of 16 answers within {worst:.2e} of the "
              f"teacher-forced {'int8-cache ' if kvq else ''}plain max (<= {TOKEN_TOL}); "
              f"{16 - len(margins)}/16 streams equal to {'bf16' if kvq else 'int8'} KV's, "
              f"where they split the reference margin between the two picks is "
              f"{', '.join(f'{m:.2e}' for m in margins) or '-'} of max|logit|")

    # the int8 requests again with K7 off (the plain int8 route): the same
    # cache, attention without the kernel's int8 query
    set_k7(False)
    for k in per_call:
        per_call[k] = 0
    with swapped(each_call_checked, ("ternary_matmul", "ternary_mlp")):
        res, outs_off = run_engine("llama-3-8b down int8 KV quantum 8, K7 off (plain route)", True,
                                   8, eng_prompts, eng_news, k7_on=False)
    set_k7(True)
    held_off = {k: per_call[k] for k in ("ternary_matmul", "ternary_mlp")}
    if held_off != {k: res["launches"][k] for k in held_off}:
        fail(f"engine int8 KV, K7 off: {held_off} calls held, launches {res['launches']}")
    same_off = sum(a == b for a, b in zip(outs[(True, 8)], outs_off))
    worst_off, _ = answers_held("engine int8 KV answers, K7 off", eng_prompts, outs_off, True,
                                tol=INT8_K7_OFF_TOKEN_TOL)
    res.update(same_as_k7=same_off, worst_pick_gap=worst_off, calls_held=held_off)
    record["engine"]["llama-3-8b down int8 KV quantum 8, K7 off"] = res
    print(f"engine int8 KV, K7 off: every K1 / K2 call held against its plain version "
          f"{held_off}; {same_off}/16 streams equal to K7's; every pick within "
          f"{worst_off:.3e} of the teacher-forced int8-cache plain max "
          f"(<= INT8_K7_OFF_TOKEN_TOL {INT8_K7_OFF_TOKEN_TOL})")
    sc = SamplingConfig(temperature=0.8, top_k=50, top_p=0.95)
    pair = [run_engine(f"llama-3-8b down bf16 KV quantum 8 sampled #{i}", False, 8,
                       eng_prompts[:8], [32] * 8, sampling=sc, seed=1234)[1] for i in (1, 2)]
    if pair[0] != pair[1]:
        fail("two sampled engine runs with the same seed differ")
    print("engine: two sampled runs (T 0.8, top-k 50, top-p 0.95, seed 1234) agree token for token")
    record["engine_sampled_pair_equal"] = True

    record["engine_step"] = {}
    k7_cc_launches = [0]  # PR 3's K7 in the 19b turns: the kernels line's count for it
    for kvq in (False, True):
        eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M, kv_quant=kvq)
        for p in eng_prompts[:8]:
            eng.submit(p, 1024)
        eng.step()  # admits all 8; one decode step
        eng.step()

        def step_ms(n=6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                eng.step()  # ends in the fetch of the step's tokens
            return (time.perf_counter() - t0) / n * 1e3

        c0 = counts()["decode_attention"]
        on1 = step_ms()
        set_k7(False)
        c1 = counts()["decode_attention"]
        off1, off2 = step_ms(), step_ms()
        if counts()["decode_attention"] != c1:
            fail("the plain attention route launched K7")
        set_k7(True)
        on2 = step_ms()
        if counts()["decode_attention"] - c0 != 12 * L:
            fail("the engine's decode steps did not launch K7 once per layer")
        valid = float(eng.positions.mean() + 1) / ENGINE_M
        kv = "int8" if kvq else "bf16"
        prof = profile_engine_step(eng, f"llama-3-8b down engine, {kv} KV")
        rec = {"k7_on_ms": [on1, on2], "plain_ms": [off1, off2], "valid_share": valid, **prof}
        print(f"engine decode step, {kv} KV, 8 rows at positions {int(eng.positions.min())}-"
              f"{int(eng.positions.max())} of {ENGINE_M} ({100 * valid:.1f} % of the slots "
              f"valid): K7 on {on1:.2f} / {on2:.2f} ms, plain route {off1:.2f} / {off2:.2f} ms "
              f"(on, off, off, on) on {record['smi']}")
        # 19b. K7 on its tensor-core kernel / PR 3's kernel (K7_TC), in turns
        # on, off: 6 steps on the host clock, one more profiled (K7's
        # device ms a step and the step's); the bound counts the valid slots'
        # bytes of this step (the slots each row attends over)
        rec["k7_tc_ab"] = {"tc": [], "cuda_core": []}
        for on in (True, False):  # two turns (a settled A/B; the run's time budget)
            k7.K7_TC = on
            c0 = counts()
            wall = step_ms()
            kvb = int((eng.positions + 1).sum()) * cfg.kv_heads * cfg.hd * (1 if kvq else 2) * 2
            step_bound = L * (kvb + (int((eng.positions + 1).sum()) * cfg.kv_heads * 8 if kvq
                                     else 0)) / bw * 1e3
            prof_ab = profile_engine_step(eng, f"llama-3-8b down engine, {kv} KV, K7 on its "
                                          f"{'tensor-core' if on else 'CUDA-core'} kernel")
            c1 = counts()
            rose = (c1["decode_attention"] - c0["decode_attention"],
                    c1["decode_attention_tc"] - c0["decode_attention_tc"])
            if rose != (7 * L, 7 * L if on else 0):
                fail(f"engine step {kv} KV, K7_TC={on}: K7 launches and launches_tc rose by {rose}")
            if not on:
                k7_cc_launches[0] += 7 * L
            rec["k7_tc_ab"]["tc" if on else "cuda_core"].append({
                "step_wall_ms": wall, "device_ms": prof_ab["device_ms"], "k7_ms": prof_ab["k7_ms"],
                "k7_share": prof_ab["k7_share"], "k7_bound_ms": step_bound,
                "valid_slots": int((eng.positions + 1).sum())})
        k7.K7_TC = True
        ab = rec["k7_tc_ab"]
        print(f"19b engine decode step, {kv} KV: K7 a step (profiler) tensor-core kernel "
              + " / ".join(f"{d['k7_ms']:.3f}" for d in ab["tc"]) + " ms vs PR 3's "
              + " / ".join(f"{d['k7_ms']:.3f}" for d in ab["cuda_core"]) + " ms (bound at this "
              f"step's valid slots {ab['tc'][-1]['k7_bound_ms']:.3f} ms); step device time "
              + " / ".join(f"{d['device_ms']:.2f}" for d in ab["tc"]) + " vs "
              + " / ".join(f"{d['device_ms']:.2f}" for d in ab["cuda_core"]) + " ms; wall "
              + " / ".join(f"{d['step_wall_ms']:.1f}" for d in ab["tc"]) + " vs "
              + " / ".join(f"{d['step_wall_ms']:.1f}" for d in ab["cuda_core"])
              + f" ms (turns on, off) on {record['smi']}")
        record["engine_step"][kv] = rec
        del eng
        torch.cuda.empty_cache()

    stamp("11c")
    # ---- 11c. the same engine (bf16 KV, quantum 1), bf16 and W2A8, with K1's
    # decode rows on the decode kernel and on the CUDA cores, in turns on,
    # off, off, on: decode tok/s and t_decode_s, every answer held as 5b and
    # 10c hold it (bf16: TOKEN_TOL under the teacher-forced plain forward;
    # W2A8: A8_TOLS' pick gap under the W2A8 route on plain versions), each
    # distinct set of answers once; then one engine decode step (8 slots
    # busy) timed and profiled in turns
    def answers_key(impl, answers_):
        return impl, tuple(tuple(a) for a in answers_)

    held_answers = {answers_key("a8", o): w for o, w in held_a8}  # held above already
    held_answers[answers_key("auto", outs[(False, 1)])] = record["engine_answers"]["bf16"]["worst_pick_gap"]

    def held_once(label, answers_, impl):
        key = answers_key(impl, answers_)
        if key not in held_answers:
            held_answers[key], _ = answers_held(label, eng_prompts, answers_, False, impl=impl,
                                        tol=TOKEN_TOL if impl == "auto" else A8_TOLS[1])
        return held_answers[key]

    eng_dec = {}
    for impl in ("auto", "a8"):
        mode = "bf16" if impl == "auto" else "W2A8"
        res_ab = {"dec": [], "cuda_core": []}
        first = None
        for on in DEC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
            route = "decode kernel" if on else "CUDA cores"
            with k1_dec(on):
                res, out_ = run_engine(f"llama-3-8b down {mode} bf16 KV quantum 1, K1 decode rows "
                                       f"on the {route}", False, 1, eng_prompts, eng_news,
                                       impl=impl, dec_on=on)
            first = first or out_
            res["streams_equal_to_first_run"] = sum(a == b for a, b in zip(out_, first))
            res["worst_pick_gap"] = held_once(f"engine {mode} answers, K1 decode rows on the "
                                              f"{route}", out_, impl)
            res_ab["dec" if on else "cuda_core"].append(res)
        eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M, impl=impl)
        for p in eng_prompts[:8]:
            eng.submit(p, 1024)
        eng.step()  # admits all 8; one decode step
        eng.step()
        steps_ab = {"dec": [], "cuda_core": []}
        for on in DEC_AB[:2]:  # two turns (a settled A/B; the run's time budget)
            with k1_dec(on):
                c0 = counts()["ternary_matmul_dec"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(6):
                    eng.step()
                wall_ms = (time.perf_counter() - t0) / 6 * 1e3
                prof = profile_engine_step(eng, f"llama-3-8b down engine, {mode}, bf16 KV, K1 "
                                                f"decode rows {'on' if on else 'off'}")
                rose = counts()["ternary_matmul_dec"] - c0
            if rose != (7 * L * (2 if impl == "auto" else 4) if on else 0):
                fail(f"engine decode steps {mode} dec={on}: launches_dec rose by {rose}")
            steps_ab["dec" if on else "cuda_core"].append({"step_wall_ms": wall_ms, **prof})
        del eng
        torch.cuda.empty_cache()
        eng_dec[mode] = {"runs": res_ab, "step": steps_ab}
        for k, v in res_ab.items():
            def each(key, rows=v):
                return " / ".join(f"{r[key]:.2f}" for r in rows)

            where = "the decode kernel" if k == "dec" else "the CUDA cores"
            print(f"engine {mode} A/B, K1 decode rows on {where}: decode {each('decode_tok_s')} "
                  f"tok/s, t_decode_s {each('t_decode_s')} s, {each('tok_s')} tok/s overall; one "
                  f"decode step {each('step_wall_ms', steps_ab[k])} ms wall, "
                  f"{each('device_ms', steps_ab[k])} ms device time (profiler); streams equal to "
                  f"the first run's {[r['streams_equal_to_first_run'] for r in v]}; worst pick gap "
                  f"{[r['worst_pick_gap'] for r in v]} (<= "
                  f"{TOKEN_TOL if impl == 'auto' else A8_TOLS[1]}) on {record['smi']}, {L} "
                  f"layers")
    record["engine_decode_ab"] = eng_dec
    record["k2_dec_ab"]["engine llama-3-8b down"] = engine_k2_ab("llama-3-8b down", eng_prompts)

    stamp("5c")
    # ---- 5c. the HTTP ServingServer over the same model: 8 concurrent POSTs,
    # each answer held to TOKEN_TOL under a teacher-forced plain forward
    import threading
    import urllib.request

    from pt2tpu_torch.serve.server import ServingServer

    srv_prompts = make_prompts(cfg, host_ints(64, 256, 8))
    srv_news = host_ints(16, 32, 8)
    answers = [None] * 8
    srv = ServingServer(cfg, params, host="127.0.0.1", port=0, max_batch=8,
                        max_len=ENGINE_M).start()

    def post(i):
        body = json.dumps({"prompt_ids": srv_prompts[i].tolist(), "max_new": srv_news[i]})
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/generate",
                                     data=body.encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            answers[i] = (r.status, json.loads(r.read()))

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=320)
        srv_wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
    if srv.error is not None or health["status"] != "ok":
        fail(f"the server's engine failed: {srv.error}")
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200 or len(ans[1]["ids"]) != srv_news[i]:
            fail(f"server request {i}: answer {ans}")
    worst, _ = answers_held("server answers", srv_prompts, [a[1]["ids"] for a in answers], False)
    record["server"] = {"requests": 8, "wall_s": srv_wall, "worst_pick_gap": worst,
                        "stats": health["stats"]}
    print(f"ServingServer: 8 concurrent POSTs answered in {srv_wall:.2f} s; every pick within "
          f"{worst:.2e} of the teacher-forced plain max (<= {TOKEN_TOL})")
    del params
    torch.cuda.empty_cache()

    stamp("12b")
    # ---- 12b. gemma-2b's lockstep main path: 18 layers (its real depth),
    # full width, "down" layout, the same 4 x 128-id prompt shape and 32 new
    # tokens. bf16: the 512-row prefill runs K1 x4 per layer on the tensor
    # cores (the MLP on the two-call path: 512 rows > 64); each decode step K1
    # x2 (qkv, o) on the decode kernel and K2 GeGLU per layer. W2A8: K1 x4
    # per layer at the prefill (int8 tensor cores) and at each step (CUDA
    # cores). Every answer held under its teacher-forced reference; one
    # decode step profiled
    cfg, params, record["model_build_gemma_s"] = build("gemma-2b", "down", 13)
    L = cfg.n_layers
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=ggem, device=dev)
    want_gemma = {
        "auto": dict(none, ternary_matmul=4 * L + 2 * L * steps, ternary_matmul_tc=4 * L,
                     ternary_matmul_dec=2 * L * steps, ternary_mlp=L * steps,
                     ternary_mlp_dec=L * steps, ternary_mlp_gelu=L * steps),
        "a8": dict(none, ternary_matmul=4 * L + 4 * L * steps, ternary_matmul_tc_a8=4 * L),
    }
    runs = drive(cfg, params, "gemma-2b down", ("auto", "a8"), want_gemma.get, prompts)
    for impl, r in runs.items():
        tol = GEMMA_TOKEN_TOL if impl == "auto" else A8_TOLS[1]
        r["worst_pick_gap"], _ = answers_held(f"gemma-2b lockstep {impl} answers",
                                              [p.tolist() for p in prompts], r["tokens"], False,
                                              impl=impl, tol=tol)
        print(f"gemma-2b lockstep {impl}: every pick within {r['worst_pick_gap']:.2e} of the "
              f"teacher-forced {'W2A8 plain-version' if impl == 'a8' else 'plain'} max (<= {tol})")
    # the same prompts on the route that never launches K2 (FUSED_MLP off:
    # each decode step runs K1 x4 per layer on the decode kernel): its
    # answers' gap under the same reference, measured beside the route's
    saved_fused, ttm.FUSED_MLP = ttm.FUSED_MLP, False
    try:
        zero_counts()
        toks = greedy_generate(cfg, params, prompts, new)
        torch.cuda.synchronize()
    finally:
        ttm.FUSED_MLP = saved_fused
    got = counts()
    if got != dict(none, ternary_matmul=4 * L + 4 * L * steps, ternary_matmul_tc=4 * L,
                   ternary_matmul_dec=4 * L * steps):
        fail(f"gemma-2b lockstep with FUSED_MLP off: launches {got}")
    tally(got)
    gap_no_k2, _ = answers_held("gemma-2b lockstep answers, FUSED_MLP off",
                                [p.tolist() for p in prompts], toks.tolist(), False, hold=False)
    runs["auto"]["worst_pick_gap_without_k2"] = gap_no_k2
    print(f"gemma-2b lockstep, FUSED_MLP off (no K2): every pick within {gap_no_k2:.2e} of the "
          f"teacher-forced plain max (measured, not held); through K2: "
          f"{runs['auto']['worst_pick_gap']:.2e}")
    # every K2 GeGLU call of an 18-layer lockstep run (8 new tokens) held
    # against its plain version on the model's own activations
    for k in per_call:
        per_call[k] = 0
    with swapped(each_call_checked, ("ternary_mlp",)):
        greedy_generate(cfg, params, prompts, 8)
    if per_call["ternary_mlp"] != L * 7:
        fail(f"gemma-2b lockstep: {per_call['ternary_mlp']} K2 calls held, want {L * 7}")
    print(f"gemma-2b lockstep, 8 new tokens: all {per_call['ternary_mlp']} K2 GeGLU calls (18 "
          f"layers x 7 decode steps) held against ternary_mlp_plain(act='gelu') within {MLP_TOL} "
          f"x max|ref| on the model's activations")
    record["main_path_gemma"] = runs
    record["decode_step_gemma"] = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                                      "gemma-2b down")

    stamp("12c")
    # ---- 12c. gemma-2b's serving path: the ServeEngine (8 slots, max_len
    # 2048, 16 greedy requests of 64-512 ids, max_new 32-64), bf16 and int8
    # KV, quantum 1: each decode step runs K1 x2 on the decode kernel, K2
    # GeGLU and K7 at hd 256 per layer, each admission its bucket (K2 GeGLU
    # at <= 64 rows); every answer held to TOKEN_TOL under the teacher-forced
    # plain forward (int8 KV: through an int8 cache); one engine decode step
    # timed and profiled; then 8 concurrent POSTs through the ServingServer
    g_prompts = make_prompts(cfg, host_ints(64, 512, 16), ggem)
    g_news = host_ints(32, 64, 16)
    # the engine, the server and the profiled step at 9 of the 18 layers (the
    # same stacked weights; the run's time budget since phase 29)
    cfg, L = cfg.with_(n_layers=9), 9
    record["engine_gemma"] = {}
    for kvq in (False, True):
        kv = "int8" if kvq else "bf16"
        res, g_out = run_engine(f"gemma-2b down {kv} KV quantum 1", kvq, 1, g_prompts, g_news)
        res["worst_pick_gap"], _ = answers_held(f"gemma-2b engine {kv} KV answers", g_prompts,
                                                g_out, kvq, tol=GEMMA_TOKEN_TOL)
        print(f"gemma-2b engine {kv} KV: every pick of 16 answers within "
              f"{res['worst_pick_gap']:.2e} of the teacher-forced {'int8-cache ' if kvq else ''}"
              f"plain max (<= {GEMMA_TOKEN_TOL})")
        record["engine_gemma"][kv] = res
        # every K2 GeGLU and K7 call of a short run of the same engine (4
        # requests, 8 new tokens each) held against its plain version
        for k in per_call:
            per_call[k] = 0
        eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M, kv_quant=kvq)
        for p_ in g_prompts[:4]:
            eng.submit(p_, 8)
        with swapped(each_call_checked, ("ternary_mlp", "decode_attention")):
            eng.run()
        st = eng.stats["steps"]
        short = sum(min(_bucket(len(p_)), ENGINE_M) <= 64 for p_ in g_prompts[:4])
        if (per_call["decode_attention"], per_call["ternary_mlp"]) != (L * st, L * (st + short)):
            fail(f"gemma-2b engine {kv} KV: held {per_call} over {st} decode steps")
        print(f"gemma-2b engine {kv} KV, 4 requests x 8 tokens: all {per_call['ternary_mlp']} K2 "
              f"GeGLU and {per_call['decode_attention']} K7 (hd 256) calls held against their "
              f"plain versions on the engine's activations")
        del eng
    eng = ServeEngine(cfg, params, max_batch=8, max_len=ENGINE_M)
    for p in g_prompts[:8]:
        eng.submit(p, 1024)
    eng.step()  # admits all 8; one decode step
    eng.step()
    c0 = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        eng.step()  # ends in the fetch of the step's tokens
    wall_ms = (time.perf_counter() - t0) / 6 * 1e3
    prof = profile_engine_step(eng, "gemma-2b down engine, bf16 KV")
    rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
    want = {k: 7 * L * m for k, m in (("ternary_matmul", 2), ("ternary_matmul_dec", 2),
                                      ("ternary_mlp", 1), ("ternary_mlp_dec", 1),
                                      ("ternary_mlp_gelu", 1),
                                      ("decode_attention", 1), ("decode_attention_hd256", 1),
                                      ("decode_attention_tc", 1))}
    if rose != want:
        fail(f"gemma-2b engine decode steps launched {rose}, want {want}")
    record["engine_step_gemma"] = {"step_wall_ms": wall_ms, **prof}
    print(f"gemma-2b engine decode step, bf16 KV, 8 rows at positions {int(eng.positions.min())}-"
          f"{int(eng.positions.max())} of {ENGINE_M}: wall {wall_ms:.2f} ms (6 steps), device "
          f"time {prof['device_ms']:.2f} ms (profiler) on {record['smi']}")
    del eng
    torch.cuda.empty_cache()
    record["k2_dec_ab"]["engine gemma-2b down"] = engine_k2_ab("gemma-2b down", g_prompts)
    srv_prompts = make_prompts(cfg, host_ints(64, 256, 8), ggem)
    srv_news = host_ints(16, 32, 8)
    answers = [None] * 8
    srv = ServingServer(cfg, params, host="127.0.0.1", port=0, max_batch=8,
                        max_len=ENGINE_M).start()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=320)
        srv_wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
    if srv.error is not None or health["status"] != "ok":
        fail(f"the gemma-2b server's engine failed: {srv.error}")
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200 or len(ans[1]["ids"]) != srv_news[i]:
            fail(f"gemma-2b server request {i}: answer {ans}")
    worst, _ = answers_held("gemma-2b server answers", srv_prompts,
                            [a[1]["ids"] for a in answers], False, tol=GEMMA_TOKEN_TOL)
    record["server_gemma"] = {"requests": 8, "wall_s": srv_wall, "worst_pick_gap": worst,
                              "stats": health["stats"]}
    print(f"gemma-2b ServingServer: 8 concurrent POSTs answered in {srv_wall:.2f} s; every pick "
          f"within {worst:.2e} of the teacher-forced plain max (<= {GEMMA_TOKEN_TOL})")
    del params
    torch.cuda.empty_cache()

    stamp("21")
    # ---- 21. the quantizer on the card: llama-3-8b at full width cut to 2
    # layers, dense bf16 weights from a torch.Generator, quantized from 32
    # synthetic calibration windows of 512 ids with the default QuantConfig
    # ("auto", at this width SSR on down only, folded): (a) the seconds of
    # each tap's Hessian, each group's damped inverse and GPTQ and each
    # layer; (b) layer 0's o quantized again on the CPU from the same W, H and
    # H_inv; (c) every group's relative output error finite and below 1;
    # (d) the artifact's save / load round trip bit for bit; (e)
    # greedy_generate over it held against the plain route (every kernel
    # call, logits, picks) with exact launches, then a ServeEngine answering
    # 4 requests, every call and answer held; (f) layer 0 quantized again
    # with ssr_scope "all" and served one prefill and 8 decode steps through
    # K4 / K3 / K2, held the same way
    from pt2tpu_torch.core import ternary as tatq
    from pt2tpu_torch.data import get_calibration_data
    from pt2tpu_torch.quant import gptq as tgptq
    from pt2tpu_torch.quant import hessian as thess
    from pt2tpu_torch.quant import pipeline as tpipe

    from pt2tpu_torch.models.hf_loader import config_from_hf, load_hf_model, write_safetensors

    cfg_prev, L_prev = cfg, L
    cfg = get_config("llama-3-8b").with_(n_layers=2)
    L = cfg.n_layers
    t0 = time.perf_counter()
    dense_card = tdec.init_params(cfg, torch.Generator(device=dev).manual_seed(21),
                                  dtype=torch.bfloat16, device=dev)
    calib, calib_prov = get_calibration_data("synthetic", cfg.vocab_size,
                                             num_samples=QUANT_CALIB[0], seq_len=QUANT_CALIB[1],
                                             seed=21)
    torch.cuda.synchronize()
    rec21 = {"init_s": time.perf_counter() - t0, "calibration": calib_prov,
             "calib_shape": list(calib.shape)}

    # 22d. the dense weights as a local HuggingFace checkpoint (config.json
    # from the registry entry, two bf16 safetensors shards written by the
    # port's own writer: this machine has no safetensors package), loaded
    # through hf_loader host-resident, so quantize_model streams it to the
    # card one layer at a time
    def write_hf_llama(d, cfg_, p_):
        os.makedirs(d, exist_ok=True)
        lay_ = p_["layers"]

        def layer_tensors(i):
            pre = f"model.layers.{i}."
            t = {pre + "input_layernorm.weight": lay_["ln1_w"][i],
                 pre + "post_attention_layernorm.weight": lay_["ln2_w"][i]}
            for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                                 ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                                 ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                                 ("down", "mlp.down_proj")):
                t[pre + theirs + ".weight"] = lay_[ours].w[i]
            return t

        half = cfg_.n_layers // 2
        first = {"model.embed_tokens.weight": p_["embed"]}
        second = {"model.norm.weight": p_["lnf_w"], "lm_head.weight": p_["lm_head"].w}
        for i in range(cfg_.n_layers):
            (first if i < half else second).update(layer_tensors(i))
        for j, t in enumerate((first, second)):
            write_safetensors(os.path.join(d, f"model-{j + 1:05d}-of-00002.safetensors"), t)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                       "vocab_size": cfg_.vocab_size, "hidden_size": cfg_.dim,
                       "intermediate_size": cfg_.intermediate,
                       "num_hidden_layers": cfg_.n_layers,
                       "num_attention_heads": cfg_.n_heads,
                       "num_key_value_heads": cfg_.kv_heads,
                       "max_position_embeddings": cfg_.max_seq_len,
                       "rms_norm_eps": cfg_.norm_eps, "rope_theta": cfg_.rope_theta,
                       "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, f, indent=1)

    hf_dir = os.path.join(ROOT, "build", "smoke_hf_llama3")
    t0 = time.perf_counter()
    write_hf_llama(hf_dir, cfg, dense_card)
    rec21["hf_write_s"] = time.perf_counter() - t0
    rec21["hf_bytes"] = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in os.listdir(hf_dir))
    cfg_hf = config_from_hf(hf_dir)
    if cfg_hf.with_(family=cfg.family) != cfg.with_(n_kv_heads=cfg.kv_heads):
        fail(f"22d config_from_hf gave {cfg_hf}, not the registry's {cfg}")
    t0 = time.perf_counter()
    cfg_hf, dense = load_hf_model(hf_dir, device="cpu")  # host residency, as the CLI picks it
    rec21["hf_load_s"] = time.perf_counter() - t0
    fa, sa, fb, sb = {}, {}, {}, {}
    ckpt._flatten("", dense_card, fa, sa)
    ckpt._flatten("", dense, fb, sb)
    bad = [k for k in fb if fb[k].device.type != "cpu" or not torch.equal(fb[k], fa[k].cpu())]
    if bad or set(fb) - set(fa) or any(fa[k] is not None for k in set(fa) - set(fb)):
        fail(f"22d the HF checkpoint did not load back the dense weights on the host: {bad}")
    del dense_card, fa, fb
    shutil.rmtree(hf_dir)
    torch.cuda.empty_cache()
    print(f"22d llama-3-8b ({L} layers, full width) written as a 2-shard bf16 HF checkpoint "
          f"({rec21['hf_bytes'] / 2**30:.2f} GiB) in {rec21['hf_write_s']:.1f} s and loaded back "
          f"host-resident through hf_loader in {rec21['hf_load_s']:.1f} s: every tensor equal")
    twin = {}
    quantize_linear = tpipe.quantize_linear

    def spy(lin, H_acc, qcfg, use_ssr=None, **kw):
        """Keeps layer 0's o (the first dim x dim group): its W and H."""
        if "W" not in twin and tuple(lin.w.shape) == (cfg.dim, cfg.n_heads * cfg.hd):
            twin.update(W=lin.w.float().clone(), H=H_acc.normalized(), use_ssr=use_ssr)
        return quantize_linear(lin, H_acc, qcfg, use_ssr=use_ssr, **kw)

    zero_counts()
    tpipe.quantize_linear = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qparams, qrep = tpipe.quantize_model(cfg_hf, dense, calib, tpipe.QuantConfig(),
                                             device=dev)  # streams the host-resident layers
        torch.cuda.synchronize()
        rec21["quantize_s"] = time.perf_counter() - t0
    finally:
        tpipe.quantize_linear = quantize_linear
    if any(counts().values()):
        fail(f"the quantizer launched a kernel: {counts()}")
    stray = [k for k, v in qparams.items() if k != "layers" and v is not None
             and getattr(v, "w", v).device.type != "cuda"]
    if stray or dense["embed"].device.type != "cpu":
        fail(f"22d the streamed quantization left {stray} off the card")
    cfg = cfg_hf
    rec21["timing"], rec21["stats"] = qrep["timing"], qrep["layers"]
    for t in qrep["timing"]:
        each = lambda d: ", ".join(f"{k} {v:.3f}" for k, v in d.items())  # noqa: E731
        print(f"21a quantize llama-3-8b layer {t['layer']} (full width, {calib.shape[0]} x "
              f"{calib.shape[1]} calibration ids): Hessians {each(t['hessian_s'])} s; damped "
              f"inverse {each(t['inverse_s'])} s; GPTQ {each(t['gptq_s'])} s; whole layer "
              f"{t['layer_s']:.2f} s on {record['smi']}")
    print(f"21a quantize_model of 2 layers: {rec21['quantize_s']:.2f} s (dense init and "
          f"calibration ids {rec21['init_s']:.2f} s), {qrep['bits_per_weight']:.3f} bits/weight, "
          f"no kernel launched")
    for li, lrep in enumerate(qrep["layers"]):  # (c)
        for gname, st in lrep.items():
            if not (math.isfinite(st["rel_out_err"]) and 0.0 <= st["rel_out_err"] < 1.0):
                fail(f"quantized layer {li} {gname}: relative output error {st['rel_out_err']}")
    print("21c relative output errors (tr(dW H dW^T) / tr(W H W^T)): " + "; ".join(
        f"layer {li} " + ", ".join(f"{k} {v['rel_out_err']:.4f}" for k, v in lrep.items())
        for li, lrep in enumerate(qrep["layers"])))
    lay = qparams["layers"]
    if not (lay["qkv"].identity_perm and lay["o"].identity_perm and lay["gateup"].out_folded
            and lay["down"].input_folded and lay["qkv"].gather is None):
        fail("the quantized llama-3-8b is not in the \"down\" layout (ssr_scope auto at dim 4096)")

    # (b) the CPU twin; the card's GPTQ of the captured inputs first gives the
    # artifact's bytes (so the capture is the pipeline's run), in turns with
    # ITF as the port runs it (JAX's loop: the stop test read on the host
    # each iteration) and with the test read every 8 iterations (the body is
    # idempotent at its fixed point: the same bits), each one's seconds
    W, H = twin["W"], twin["H"]
    _, H_inv = thess.damped_inverse(H, tpipe.QuantConfig().percdamp)
    itf_each = tatq.itf

    def itf_every_8(W_, alpha, mu, T, mask=None, max_iter=100):
        T_prev = torch.zeros_like(T)
        it = 0
        while it < max_iter and bool((T != T_prev).any()):
            for _ in range(min(8, max_iter - it)):
                alpha, mu = tatq.optimal_grid(W_, T, mask)
                T, T_prev = tatq.flexible_round(W_, alpha, mu, mask), T
                it += 1
        return alpha, mu, T

    itf_ab = {"each": [], "every_8": []}
    for arm in ("each", "every_8", "every_8", "each"):
        tatq.itf = itf_each if arm == "each" else itf_every_8
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q_card = tgptq.ternary_gptq(W, H, H_inv, use_ssr=twin["use_ssr"])
            torch.cuda.synchronize()
        finally:
            tatq.itf = itf_each
        itf_ab[arm].append(time.perf_counter() - t0)
        if not torch.equal(ttm.pack_layer(q_card, W.shape[1]).packed, lay["o"].packed[0]):
            fail(f"layer 0's o quantized again on the card (ITF check {arm}) differs from the "
                 "artifact's")
    t0 = time.perf_counter()
    q_cpu = tgptq.ternary_gptq(W.cpu(), H.cpu(), H_inv.cpu(), use_ssr=twin["use_ssr"])
    cpu_s = time.perf_counter() - t0
    same = (q_card.T.cpu() == q_cpu.T).float().mean().item()
    e_card = tpipe.rel_out_err(W, tgptq.dequantize_layer(q_card, W.shape[1]), H)
    e_cpu = tpipe.rel_out_err(W.cpu(), tgptq.dequantize_layer(q_cpu, W.shape[1]), H.cpu())
    rec21["cpu_twin"] = {"codes_equal": same, "rel_out_err_card": e_card, "rel_out_err_cpu": e_cpu,
                         "cpu_s": cpu_s, "itf_check_ab_s": itf_ab}
    print(f"21b layer 0's o (4096 x 4096) quantized again from the same W, H, H_inv: card "
          f"GPTQ {' / '.join(f'{v:.3f}' for v in itf_ab['each'])} s with ITF's stop test read "
          f"each iteration (the port), {' / '.join(f'{v:.3f}' for v in itf_ab['every_8'])} s "
          f"every 8 iterations (turns each, 8, 8, each; the artifact's bytes every time); on "
          f"the CPU {cpu_s:.1f} s: {100 * same:.3f} % of codes equal "
          f"(>= {100 * QUANT_TWIN_CODES:.0f} %), Hessian-weighted relative errors card "
          f"{e_card:.5f} / CPU {e_cpu:.5f} (within {100 * QUANT_TWIN_ERR:.0f} %) on {record['smi']}")
    if same < QUANT_TWIN_CODES or not abs(e_card - e_cpu) <= QUANT_TWIN_ERR * e_cpu:
        fail(f"21b the CPU twin: {same:.4f} of codes equal, errors {e_card:.5f} / {e_cpu:.5f}")
    del W, H, H_inv, q_card, q_cpu, twin

    # (d) + (e): the artifact round trip and greedy_generate (prefill 512 rows:
    # K1 x4 a layer on the tensor cores; each decode step K1 x2 on its decode
    # kernel and K2 on its decode path a layer; max_len 144: no K7)
    steps16 = 15
    want_q = dict(none, ternary_matmul=4 * L + 2 * L * steps16, ternary_matmul_tc=4 * L,
                  ternary_matmul_dec=2 * L * steps16, ternary_mlp=L * steps16,
                  ternary_mlp_dec=L * steps16)
    rec21["serve"] = two_layer_check("llama-3-8b", "quantized", 0, built=(cfg, qparams),
                                     want=lambda impl: want_q)
    params = qparams
    for k in per_call:
        per_call[k] = 0
    with swapped(each_call_checked, ("ternary_matmul", "ternary_mlp", "decode_attention")):
        res, q_out = run_engine("quantized llama-3-8b (2 layers) bf16 KV quantum 1, 4 requests",
                                False, 1, eng_prompts[:4], eng_news[:4])
    held_q = {k: v for k, v in per_call.items() if v}
    if held_q != {k: res["launches"][k] for k in held_q} or len(held_q) != 3:
        fail(f"quantized engine: {held_q} calls held, launches {res['launches']}")
    worst_q, _ = answers_held("quantized engine answers", eng_prompts[:4], q_out, False)
    rec21["engine"] = dict(res, calls_held=held_q, worst_pick_gap=worst_q)
    print(f"21e quantized llama-3-8b ServeEngine: 4 requests, every K1 / K2 / K7 call held "
          f"against its plain version {held_q}, launches exact; every pick within "
          f"{worst_q:.2e} of the teacher-forced plain max (<= {TOKEN_TOL})")
    del qparams, params

    # (f) layer 0 again, every group through SSR: prefill K4 x3 (rows path) +
    # K1 x4; each decode step K3 x2 on its decode path and K2 on its decode path
    cfg1 = cfg.with_(n_layers=1)
    dense1 = dict(dense, layers=tdec.stack_layers([tdec.layer_slice(dense["layers"], 0)]))
    del dense
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp1, rep1 = tpipe.quantize_model(cfg1, dense1, calib, tpipe.QuantConfig(ssr_scope="all"),
                                     device=dev)
    torch.cuda.synchronize()
    rec21["ssr_all_layer_s"] = time.perf_counter() - t0
    rec21["ssr_all_timing"] = rep1["timing"]
    lay1 = qp1["layers"]
    if not (all(lay1[k].gather is not None for k in ("qkv", "o", "gateup"))
            and lay1["down"].input_folded):
        fail("the ssr_scope \"all\" layer does not carry its gathers")
    t = rep1["timing"][0]
    print(f"21f one llama-3-8b layer quantized with ssr_scope all in {rec21['ssr_all_layer_s']:.2f} "
          f"s (GPTQ " + ", ".join(f"{k} {v:.3f}" for k, v in t["gptq_s"].items()) + f" s) on "
          f"{record['smi']}")
    steps9 = 8
    want_s = dict(none, ternary_matmul=4, ternary_matmul_tc=4,
                  ternary_matmul_igathered=2 * steps9, ternary_matmul_igathered_dec=2 * steps9,
                  ternary_mlp=steps9, ternary_mlp_dec=steps9, onehot_gather=3,
                  onehot_gather_rows=3)
    rec21["serve_ssr_all"] = two_layer_check("llama-3-8b", "quantized, ssr_scope all", 0,
                                             built=(cfg1, qp1), new=steps9 + 1, roundtrip=False,
                                             want=lambda impl: want_s)
    record["quantizer"] = rec21
    del dense1, qp1
    cfg, L = cfg_prev, L_prev
    torch.cuda.empty_cache()
    stamp("22")
    # ---- 22. every dense family of the JAX registry: (a) qwen3-8b (qk-norm)
    # at full width and 12 of its 36 layers, "down" layout: the lockstep path
    # (4 x 128 ids, 16 new) and a ServeEngine (8 slots, M 2048, 8 requests of
    # 64-512 ids, 32 new each, bf16 KV), launches exact, every answer held to
    # FAMILY_TOKEN_TOL under its teacher-forced plain reference; a 2-layer
    # full-width copy with every K1 / K2 / K7 call held against its plain
    # version. (b) gemma3-4b (qk-norm by 1 + w, sandwich norms, a window of
    # 1024 on 5 of each 6 layers with their own RoPE base, hd 256 with 2
    # queries per KV head) at full width and its full 34 layers: the
    # ServeEngine with bf16 and int8 KV, two of its 8 requests 1100-1400 ids
    # long so that the window binds in the admission and in decode; a 2-layer
    # copy (both layers sliding) whose every K1 / K7 call is held, K7's on
    # windowed kv_valid. (c) opt-1.3b (learned positions with OPT's offset,
    # relu, an ungated MLP, biases, LayerNorm), gpt2-xl (the same with gelu;
    # n = 1600: every K1 call on the CUDA cores) and bloom-560m (ALiBi, the
    # embedding LayerNorm) at full width cut to 2 layers: the lockstep path
    # with every K1 call held, an artifact round trip, and a 4-request engine
    # with every K1 call and answer held. Each family's engine decode step is
    # profiled (device time, wall). (d) is phase 21's start from an HF
    # directory.
    rec22 = {}
    g22 = torch.Generator(device=dev).manual_seed(22)
    gh22 = torch.Generator().manual_seed(22)

    def ints22(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=gh22).tolist()

    # the routes of phase 22's families on the card, written out (no routing
    # predicate consulted): the gated MLP through K2 at <= 64 rows (qwen3-8b;
    # gemma3-4b's gateup has more input lanes than its 128-padded x, and
    # opt, gpt2 and bloom have no gated MLP), every K1 call on the CUDA cores
    # (gpt2-xl: n = 1600 / 4800, scale blocks of 64), K7 at each decode step
    # (not opt and gpt2: hd 64; not bloom: ALiBi), at hd 256 (gemma3-4b)
    K2_FAMILIES = ("qwen3-8b",)
    K1_CUDA_CORE_FAMILIES = ("gpt2-xl",)
    K7_FAMILIES = ("qwen3-8b", "gemma3-4b")
    HD256_FAMILIES = ("gemma3-4b",)

    def family_launches(fam, L_, passes, k7_steps=0):
        """The launches of forward passes of ``passes`` rows each (a
        prefill's B x L, an admission's bucket, a decode step's B) through
        ``L_`` layers of family ``fam`` without gathers: per layer K1 for qkv
        and o, on its decode kernel at <= 8 rows and its tensor cores from 9;
        the MLP through K2 (decode path <= 8 rows, tensor cores 9-64) where
        the family takes it, else K1 for gateup (or the ungated up) and
        down; K7 once a layer for each of ``k7_steps`` decode steps."""
        c = dict(none)

        def k1_calls(rows, n_calls):
            c["ternary_matmul"] += n_calls * L_
            if fam not in K1_CUDA_CORE_FAMILIES:
                c["ternary_matmul_dec" if rows <= 8 else "ternary_matmul_tc"] += n_calls * L_

        for rows in passes:
            if fam in K2_FAMILIES and rows <= 64:
                k1_calls(rows, 2)
                c["ternary_mlp"] += L_
                c["ternary_mlp_dec" if rows <= 8 else "ternary_mlp_tc"] += L_
            else:
                k1_calls(rows, 4)
        steps_ = k7_steps if fam in K7_FAMILIES else 0
        c["decode_attention"] = c["decode_attention_tc"] = L_ * steps_
        c["decode_attention_hd256"] = L_ * steps_ if fam in HD256_FAMILIES else 0
        return c

    def family_reference(cfg_, params_, prompt, ids, kvq):
        """f32 logits at the answer's positions from one plain forward of
        prompt + answer[:-1] through forward_cached (a bf16 or int8 cache,
        the family's masks, windows and positions), no kernel launched."""
        toks = torch.as_tensor(list(prompt) + list(ids[:-1]), device=dev)[None]
        with torch.inference_mode():
            cache = init_cache(cfg_, 1, toks.shape[1], quantized=kvq, device=dev)
            logits, _ = forward_cached(cfg_, params_, toks, cache, 0, "plain", all_logits=True)
        return logits[0, len(prompt) - 1 :].float()

    def family_answers_held(label, cfg_, params_, prompts_, answers_, kvq, tol):
        """Each answer's picks within ``tol`` of max|logit| of its teacher-
        forced plain reference's max. Returns the worst pick gap."""
        c0 = counts()
        worst = 0.0
        for p_, ids in zip(prompts_, answers_):
            lf = family_reference(cfg_, params_, p_, ids, kvq)
            picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
            worst = max(worst, ((lf.max(dim=1).values - picked)
                                / lf.abs().max(dim=1).values).max().item())
            del lf
        if counts() != c0:
            fail(f"{label}: the teacher-forced reference launched a kernel")
        if not worst <= tol:
            fail(f"{label}: a pick trails the teacher-forced plain max by {worst:.3e} of "
                 f"max|logit| (> {tol})")
        return worst

    def family_engine(fam, label, cfg_, params_, prompts_, new_, kvq=False, M_=ENGINE_M,
                      held=None, tol=TOKEN_TOL):
        """A ServeEngine run (8 slots, quantum 1) of family ``fam``, counts set
        to 0 just before and read just after, held to family_launches;
        ``held`` names the wrappers whose every call is held against its plain
        version; the answers held to ``tol``. Returns (result, answers)."""
        eng = ServeEngine(cfg_, params_, max_batch=8, max_len=M_, kv_quant=kvq)
        reqs = [eng.submit(p_, new_) for p_ in prompts_]
        for k in per_call:
            per_call[k] = 0
        with swapped(each_call_checked, held) if held else contextlib.nullcontext():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
        st_ = eng.stats["steps"]
        want = family_launches(fam, cfg_.n_layers, [min(_bucket(len(p_)), M_) for p_ in prompts_]
                               + [8] * st_, st_)
        if got != want:
            fail(f"engine {label}: launches {got}, want {want}")
        tally(got)
        if not all(r.done and len(r.out) == new_ and all(0 <= t < cfg_.vocab_size for t in r.out)
                   for r in reqs):
            fail(f"engine {label}: a request did not finish with max_new valid tokens")
        outs_ = [r.out for r in reqs]
        checked = {k: v for k, v in per_call.items() if v}
        if held and checked != {k: got[k] for k in held if got[k]}:
            fail(f"engine {label}: {checked} calls held, launches {got}")
        worst = family_answers_held(f"engine {label} answers", cfg_, params_, prompts_, outs_,
                                    kvq, tol)
        n_tok = sum(len(o) for o in outs_)
        stt = dict(eng.stats)
        res = {"wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall, "steps": st_,
               "decode_tok_s": stt["tokens"] / stt["t_decode_s"], "t_admit_s": stt["t_admit_s"],
               "t_decode_s": stt["t_decode_s"], "launches": got, "worst_pick_gap": worst,
               "calls_held": checked}
        print(f"engine {label}: {len(reqs)} requests, {n_tok} tokens in {wall:.2f} s "
              f"({res['tok_s']:.1f} tok/s; decode {res['decode_tok_s']:.1f} tok/s; t_admit_s "
              f"{stt['t_admit_s']:.2f} s), {st_} decode steps, launches exact {got}"
              + (f", every call of {sorted(checked)} held {checked}" if held else "")
              + f"; every pick within {worst:.2e} of the teacher-forced plain max (<= {tol}) "
              f"on {record['smi']}")
        del eng
        return res, outs_

    def family_step(label, cfg_, params_, prompts_, kvq=False, M_=ENGINE_M):
        """One engine decode step with 8 busy slots: 6 steps on the host
        clock, one more under torch.profiler."""
        eng = ServeEngine(cfg_, params_, max_batch=8, max_len=M_, kv_quant=kvq)
        for p_ in prompts_[:8]:
            eng.submit(p_, min(64, M_ - len(p_)))
        eng.step()  # admits all 8; one decode step
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            eng.step()
        wall_ms = (time.perf_counter() - t0) / 6 * 1e3
        prof = profile_engine_step(eng, label)
        del eng
        return dict(prof, step_wall_ms=wall_ms)

    # (a) qwen3-8b at 12 of its 36 layers (the run's time budget since phase
    # 29 was added)
    cfg22, params22, build_s = build("qwen3-8b", "down", 22, n_layers=12)
    L22 = cfg22.n_layers
    prompts22 = torch.randint(0, cfg22.vocab_size, (B, Lp), generator=g22, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks22 = greedy_generate(cfg22, params22, prompts22, 16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, want = counts(), family_launches("qwen3-8b", L22, [B * Lp] + [B] * 15)
    if got != want:
        fail(f"qwen3-8b lockstep: launches {got}, want {want}")
    tally(got)
    worst = family_answers_held("qwen3-8b lockstep answers", cfg22, params22,
                                prompts22.tolist(), toks22.tolist(), False, FAMILY_TOKEN_TOL)
    rec22["qwen3_lockstep"] = {"build_s": build_s, "wall_s": wall, "launches": got,
                               "worst_pick_gap": worst}
    print(f"22a qwen3-8b lockstep ({L22} layers, full width, down): {B}x{Lp} ids + 16 new in "
          f"{wall:.2f} s, launches exact {got}; every pick within {worst:.2e} of the "
          f"teacher-forced plain max (<= {FAMILY_TOKEN_TOL}) on {record['smi']}")
    q_prompts = make_prompts(cfg22, ints22(64, 512, 8), g22)
    rec22["qwen3_engine"], _ = family_engine("qwen3-8b", "qwen3-8b down bf16 KV", cfg22, params22,
                                             q_prompts, 32, tol=FAMILY_TOKEN_TOL)
    rec22["qwen3_step"] = family_step("qwen3-8b down engine, bf16 KV", cfg22, params22, q_prompts)
    del params22
    torch.cuda.empty_cache()
    cfg2 = get_config("qwen3-8b").with_(n_layers=2)
    params2 = random_ternary_params(cfg2, seed=23, perm_mode="down", device=dev)
    rec22["qwen3_2layer"] = two_layer_check(
        "qwen3-8b", "down", 0, built=(cfg2, params2), roundtrip=False,
        want=lambda impl: family_launches("qwen3-8b", 2, [4 * 128] + [4] * 15))
    rec22["qwen3_2layer_engine"], _ = family_engine(
        "qwen3-8b", "2-layer qwen3-8b down bf16 KV", cfg2, params2, q_prompts, 16,
        held=("ternary_matmul", "ternary_mlp", "decode_attention"))
    del params2
    torch.cuda.empty_cache()

    # (b) gemma3-4b cut to GEMMA3_HELD_LAYERS of its 34 layers (phase 26 runs
    # it at full depth on ring caches, held to this flat route): two prompts
    # over its window, six under it, bf16 and int8 KV, every K1 and K7 call
    # held against its plain version and every answer to TOKEN_TOL; one
    # engine decode step profiled for each (the 2-layer copy after it holds
    # K7 on windows)
    cfg22, params22, build_s = build("gemma3-4b", "down", 24, n_layers=GEMMA3_HELD_LAYERS)
    L22 = cfg22.n_layers
    lens = ints22(1100, 1400, 2) + ints22(64, 512, 6)
    g_prompts = make_prompts(cfg22, lens, g22)
    rec22["gemma3_build_s"] = build_s
    for kvq in (False, True):
        kv = "int8" if kvq else "bf16"
        res, _ = family_engine(
            "gemma3-4b", f"gemma3-4b down {kv} KV ({L22} of its 34 layers, prompts {lens})",
            cfg22, params22, g_prompts, 32, kvq=kvq, held=("ternary_matmul", "decode_attention"),
            tol=TOKEN_TOL)
        if res["launches"]["decode_attention_hd256"] == 0 or res["launches"]["ternary_mlp"]:
            fail(f"gemma3-4b engine: launches {res['launches']} (K7 at hd 256, no K2)")
        rec22[f"gemma3_engine_{kv}_cut"] = res
        rec22[f"gemma3_step_{kv}"] = family_step(f"gemma3-4b down engine ({L22} layers), {kv} KV",
                                                 cfg22, params22, g_prompts, kvq=kvq)
    # the 2-layer cut of the same weights: both layers sliding (the pattern
    # starts with 5 local layers), every K1 / K7 call held, K7's on windows
    cfg2 = cfg22.with_(n_layers=2)
    if any(cfg2.globals_list()):
        fail("the 2-layer gemma3-4b copy has a global layer")
    windowed = [0]

    def window_spy(name, kernel, plain, tol):
        held_call = each_call_checked(name, kernel, plain, tol)
        if name != "decode_attention":
            return held_call

        def call(q_, k_, v_, valid, *a, **kw):
            first = valid.float().argmax(dim=1)  # each row's first valid slot
            windowed[0] += int((first > 0).any().item())
            return held_call(q_, k_, v_, valid, *a, **kw)
        return call

    rec22["gemma3_2layer"] = {}
    for kvq in (False, True):
        kv = "int8" if kvq else "bf16"
        windowed[0] = 0
        held_names = ("ternary_matmul", "decode_attention")
        eng = ServeEngine(cfg2, params22, max_batch=8, max_len=ENGINE_M, kv_quant=kvq)
        reqs = [eng.submit(p_, 16) for p_ in g_prompts[:4]]
        for k in per_call:
            per_call[k] = 0
        with swapped(window_spy, held_names):
            zero_counts()
            eng.run()
            torch.cuda.synchronize()
            got = counts()
        st_ = eng.stats["steps"]
        want = family_launches("gemma3-4b", 2, [min(_bucket(len(p_)), ENGINE_M)
                                                 for p_ in g_prompts[:4]] + [8] * st_, st_)
        checked = {k: v for k, v in per_call.items() if v}
        if got != want or checked != {k: got[k] for k in held_names}:
            fail(f"2-layer gemma3-4b engine {kv} KV: launches {got}, want {want}, held {checked}")
        tally(got)
        # every decode step's two K7 calls (both layers sliding) carry the long
        # prompts' rows, whose windows start past slot 0
        if windowed[0] != 2 * st_:
            fail(f"2-layer gemma3-4b engine {kv} KV: {windowed[0]} of {2 * st_} K7 calls saw "
                 "a windowed kv_valid")
        worst = family_answers_held(f"2-layer gemma3-4b engine {kv} KV answers", cfg2, params22,
                                    g_prompts[:4], [r.out for r in reqs], kvq, TOKEN_TOL)
        rec22["gemma3_2layer"][kv] = {"launches": got, "calls_held": checked,
                                      "k7_windowed_calls": windowed[0], "worst_pick_gap": worst}
        print(f"22b 2-layer gemma3-4b ServeEngine ({kv} KV, both layers sliding, prompts "
              f"{[len(p_) for p_ in g_prompts[:4]]}): every K1 / K7 call held against its plain "
              f"version {checked}, {windowed[0]} K7 calls on a kv_valid that starts past slot 0; "
              f"launches exact; every pick within {worst:.2e} (<= {TOKEN_TOL})")
        del eng
    del params22
    torch.cuda.empty_cache()

    # (c) the ungated, biased, learned-position and ALiBi families, 2 layers
    for name, seed, M_ in (("opt-1.3b", 26, ENGINE_M), ("gpt2-xl", 27, 1024),
                           ("bloom-560m", 28, ENGINE_M)):
        cfg2 = get_config(name).with_(n_layers=2)
        params2 = random_ternary_params(cfg2, seed=seed, perm_mode="down", device=dev)
        lock_want = family_launches(name, 2, [4 * 128] + [4] * 15)
        rec = two_layer_check(name, "down", 0, built=(cfg2, params2),
                              want=lambda impl, w=lock_want: w)
        prompts_c = make_prompts(cfg2, ints22(64, 300, 4), g22)
        rec["engine"], _ = family_engine(name, f"2-layer {name} down bf16 KV", cfg2, params2,
                                         prompts_c, 16, M_=M_, held=("ternary_matmul",))
        rec["step"] = family_step(f"2-layer {name} down engine, bf16 KV", cfg2, params2,
                                  prompts_c * 2, M_=M_)
        rec22[name] = rec
        del params2
        torch.cuda.empty_cache()
    record["families"] = rec22

    stamp("23")
    # ---- 23. mixture of experts: mixtral-8x7b (8 experts, 2 a token) and
    # qwen3-30b-a3b (128, 8 a token) through K1s and K3s, K1's and K3s's
    # decode-row kernels with the expert index read from device memory (the
    # router's top-k pick, never read on the host; one row's top-k plan).
    # (a) every device-index entry held per call at the experts' shapes,
    # B 1, bf16 and W2A8 (K1_DEC_A8 off: the CUDA-core instances; on: the
    # decode kernel's W2A8 instances), bit for bit against the view route
    # (the host-index slot) and within KERNEL_TOL of its plain version,
    # every slot of a stack once. (b) mixtral-8x7b at its full width and 32
    # layers, "down": greedy_generate at batch 1 (128 ids + 32 new), bf16 and
    # W2A8, launches exact (a decode step adds 32 x 2 x 2 device-index
    # launches and no host-index expert launch), _moe_mlp at one row under
    # set_sync_debug_mode("error"), the answers held under the teacher-forced
    # plain forward (bf16: MIXTRAL_DEEP_TOL; W2A8: A8_TOLS' gap under the
    # W2A8 route on plain versions), the plain bf16 route's own drift from
    # f32 at this depth, one decode step profiled; the same weights cut to
    # 2 layers with every K1 / K1s call held, answers at TOKEN_TOL. (c) the
    # same model in a ServeEngine (8 slots, M 2048, 8 requests of 64-512
    # ids, 16 new, bf16 KV; every pass runs all 8 experts): K1 and K7
    # launches exact, every K7 call held, answers held under one batched
    # teacher-forced plain forward at MIXTRAL_DEEP_TOL; one decode step
    # profiled; the 2-layer cut's engine with K7 off (the reference's plain
    # attention: see MIXTRAL_DEEP_TOL), answers at TOKEN_TOL. (d) mixtral
    # cut to 2 layers in the "ssr" layout (K3s for gate/up) and
    # qwen3-30b-a3b cut to 4 of its 48 layers (depth cuts): lockstep bf16
    # and W2A8 with every K1s / K3s call held, and a 4-request engine (K7
    # off), every answer held and (mixtral) every K1 / K3 / K4 call. (e) the
    # quantizer on one mixtral layer at full width (seeded dense bf16
    # weights, MOE_CALIB windows: a cut from the CLI's 128 x 2048), its
    # artifact served, every K1s call held. (f) the entries' C calls timed
    # from CUDA graph replays over stacks larger than L2, beside the view
    # route, the plain version, torch.matmul on the dense bf16 expert and
    # the bytes bound.
    import torch.nn.functional as F

    from pt2tpu_torch.utils.randmodel import random_expert_stack

    rec23 = {}
    g23 = torch.Generator(device=dev).manual_seed(23)
    gh23 = torch.Generator().manual_seed(23)
    idx_names = ("ternary_matmul_idx", "ternary_matmul_igathered_idx")
    idx_err = dict.fromkeys(idx_names, 0.0)

    # (a) per-call holds: (label, out, in, perm mode) of mixtral's and
    # qwen3-30b-a3b's experts, stacks of 2 layers x 4 experts
    checks23 = 0
    for label, n_out, n_in, mode in MOE_SHAPES:
        flat = tdec._flatten_expert_stack(
            random_expert_stack(g23, 2, 4, n_out, n_in, mode, device=dev))
        S, K = flat.packed.shape[0], flat.packed.shape[1] * 4
        name = "ternary_matmul_igathered_idx" if mode == "ssr" else "ternary_matmul_idx"
        sel = torch.arange(4, dtype=torch.int32, device=dev)
        for impl, dec_a8 in (("auto", False), ("a8", False), ("a8", True)):
            k1.K1_DEC_A8 = dec_a8
            a8 = impl == "a8"
            x = torch.randn((1, n_in), generator=g23, device=dev).bfloat16()
            xk = F.pad(x, (0, K - n_in))
            for s in range(S):
                e, base = sel[s % 4], (s // 4) * 4
                c0 = counts()
                if mode == "ssr":
                    got = k1.ternary_matmul_igathered_idx(x, flat.perm, flat.packed, flat.alpha,
                                                          flat.mu, e, base, a8=a8)
                    want = k1.ternary_matmul_igathered_idx_plain(
                        x, flat.perm, flat.packed, flat.alpha, flat.mu, e, base, a8=a8)
                else:
                    got = k1.ternary_matmul_idx(xk, flat.packed, flat.alpha, flat.mu, e, base,
                                                a8=a8)
                    want = k1.ternary_matmul_idx_plain(xk, flat.packed, flat.alpha, flat.mu, e,
                                                       base, a8=a8)
                dec_path = not a8 or dec_a8
                rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
                if rose != {name: 1, **({f"{name}_dec": 1} if dec_path else {})}:
                    fail(f"23a {label} {impl}: launches {rose}")
                err = ((got - want).abs().max() / want.abs().max()).item()
                if not err <= KERNEL_TOL:
                    fail(f"23a {name} {label} {impl} slot {s}: max|err| {err:.3e} > {KERNEL_TOL}")
                idx_err[name] = max(idx_err[name], err)
                on = ttm.ternary_linear_apply_stacked(flat, x, e, impl=impl, base=base,
                                                      out_dtype=torch.float32)
                view = ttm.ternary_linear_apply_stacked(flat, x, s, impl=impl,
                                                        out_dtype=torch.float32)
                if not (torch.equal(on, view) and torch.equal(on, got)):
                    fail(f"23a {label} {impl} slot {s}: the device index is not the view "
                         "route bit for bit")
                checks23 += 1
        k1.K1_DEC_A8 = False
        del flat
    rec23["per_call"] = {"checks": checks23, "max_rel_err": dict(idx_err)}
    print(f"23a K1s / K3s at the experts' shapes {[s_[0] for s_ in MOE_SHAPES]}, B 1, bf16 and "
          f"W2A8 (decode kernel and CUDA cores): {checks23} calls, each bit for bit the view "
          f"route's, max|err| vs plain {idx_err} (<= {KERNEL_TOL}), every slot of 2 x 4")

    # (a, continued) K4s, K5s and K6s per call: mixtral's gateup with its
    # gather and an expert whose out width K3 and K6 refuse (1440: the
    # gather kernel then K1s), every slot of a 2 x 4 stack: the gather
    # entries at B 1 and 4 bit for bit the view route's and their plain
    # versions'; then the whole one-row route under each flag set (G4: K4s,
    # G5: K5s, then K1s; P2: K6s), bf16 and W2A8 (K1_DEC_A8 off, on), bit
    # for bit the host-index view route's, each wrapper launched once and
    # K6s within KERNEL_TOL of its plain version. Their own generator, so
    # that the phases after draw what they drew before
    gx23 = torch.Generator(device=dev).manual_seed(2302)
    G4, G5 = ("iota", False, False), ("packed", False, False)
    ROUTE_FLAGS = {"G4": G4, "G5": G5, "P2": P2}
    gidx_names = ("onehot_gather_idx", "onehot_matmul_idx", "ternary_matmul_gathered_idx")
    gidx_err = dict.fromkeys(gidx_names, 0.0)
    gchecks = 0
    for label, n_out, n_in in (("mixtral gateup ssr", 28672, 4096), ("odd gateup ssr", 1440, 2048)):
        flat = tdec._flatten_expert_stack(
            random_expert_stack(gx23, 2, 4, n_out, n_in, "ssr", device=dev))
        S, gp, pm = flat.packed.shape[0], flat.gather.packed, flat.gather.perm
        sel = torch.arange(4, dtype=torch.int32, device=dev)
        for B in (1, 4):
            x = torch.randn((B, n_in), generator=gx23, device=dev).bfloat16()
            for s in range(S):
                e, base = sel[s % 4], (s // 4) * 4
                c0 = counts()
                g4 = k4.onehot_gather_idx(x, pm, e, base)
                g5 = k4.onehot_matmul_idx(x, gp, e, base)
                rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
                if rose != {"onehot_gather_idx": 1, "onehot_gather_idx_rows": 1,
                            "onehot_matmul_idx": 1}:
                    fail(f"23a K4s / K5s {label} B={B}: launches {rose}")
                if not (torch.equal(g4, k4.onehot_gather(x, pm[s]))
                        and torch.equal(g4, k4.onehot_gather_idx_plain(x, pm, e, base))
                        and torch.equal(g5, k4.onehot_matmul(x, gp[s]))
                        and torch.equal(g5, k4.onehot_matmul_idx_plain(x, gp, e, base))):
                    fail(f"23a K4s / K5s {label} B={B} slot {s}: not bit for bit the view "
                         "route's and the plain version's")
                gchecks += 2
        for fname, flags in ROUTE_FLAGS.items():
            with route_flags(flags):
                for impl, dec_a8 in (("auto", False), ("a8", False), ("a8", True)):
                    k1.K1_DEC_A8 = dec_a8
                    a8 = impl == "a8"
                    x = torch.randn((1, n_in), generator=gx23, device=dev).bfloat16()
                    route = ttm.linear_route(flat, 1, impl, dev, device_index=True)
                    for s in range(S):
                        e, base = sel[s % 4], (s // 4) * 4
                        c0 = counts()
                        on = ttm.ternary_linear_apply_stacked(flat, x, e, impl=impl, base=base,
                                                              out_dtype=torch.float32)
                        rose = {k: v - c0[k] for k, v in counts().items()
                                if v != c0[k] and k in wrappers}
                        if rose != dict.fromkeys(route, 1):
                            fail(f"23a {fname} {label} {impl}: launches {rose}, route {route}")
                        view = ttm.ternary_linear_apply_stacked(flat, x, s, impl=impl,
                                                                out_dtype=torch.float32)
                        if not torch.equal(on, view):
                            fail(f"23a {fname} {label} {impl} slot {s}: the device index is not "
                                 "the view route bit for bit")
                        if route == ("ternary_matmul_gathered_idx",):
                            want = k1.ternary_matmul_gathered_idx_plain(
                                x, gp, flat.packed, flat.alpha, flat.mu, e, base, a8=a8)
                            err = ((on - want).abs().max() / want.abs().max()).item()
                            if not err <= KERNEL_TOL:
                                fail(f"23a K6s {label} {impl} slot {s}: max|err| {err:.3e} > "
                                     f"{KERNEL_TOL}")
                            gidx_err["ternary_matmul_gathered_idx"] = max(
                                gidx_err["ternary_matmul_gathered_idx"], err)
                        gchecks += 1
                    k1.K1_DEC_A8 = False
        del flat, gp, pm
    rec23["per_call_gather"] = {"checks": gchecks, "max_rel_err": dict(gidx_err)}
    print(f"23a K4s / K5s (B 1 and 4) and K6s, K4s / K5s then K1s under G4 / G5 / P2 at mixtral's "
          f"gateup and a 1440-wide expert, bf16 and W2A8 (K1_DEC_A8 off, on): {gchecks} calls, "
          f"each bit for bit the view route's (K4s / K5s their plain versions' too), K6s within "
          f"{gidx_err['ternary_matmul_gathered_idx']:.3e} of its plain version (<= {KERNEL_TOL}), "
          f"every slot of 2 x 4")

    # (a, continued) K2's ungated mode per call: opt-1.3b's and
    # bloom-560m's MLP widths (biases aside: neither model routes to K2),
    # up alone I wide, rows 1 / 8 on the decode path, 16 / 64 on the
    # tensor-core path, 1 / 16 on the CUDA-core kernel (the other two paths
    # rebound away), with and without the gather, silu, gelu and relu,
    # within MLP_TOL of ternary_mlp_plain; launches_ungated exact
    gk22 = torch.Generator(device=dev).manual_seed(2322)
    ung_err, ung_checks = 0.0, 0
    for label, (D, I, n) in (("opt-1.3b", (2048, 8192, 2048)),
                             ("bloom-560m", (1024, 4096, 1024))):
        ulayer = rand_layer(D, I, gen=gk22) + rand_layer(I, n, gen=gk22)
        uperm = rand_perm(D, D, gen=gk22)
        for gathered in (True, False):
            for act in k1.MLP_ACTS:
                for B, path in ((1, "dec"), (8, "dec"), (16, "tc"), (64, "tc"), (1, "cc"),
                                (16, "cc")):
                    x = torch.randn((B, D), generator=gk22, device=dev).bfloat16()
                    with k2_dec(path != "cc"), k2_tc(path != "cc"):
                        if k1.k2_path(B) != path:
                            fail(f"23a ungated K2 {label} rows {B}: k2_path {k1.k2_path(B)}")
                        c0 = counts()
                        got = k1.ternary_mlp(x, uperm if gathered else None, *ulayer, I, act=act)
                    rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
                    want_rose = {"ternary_mlp": 1, "ternary_mlp_ungated": 1}
                    if path != "cc":
                        want_rose[f"ternary_mlp_{path}"] = 1
                    if act == "gelu":
                        want_rose["ternary_mlp_gelu"] = 1
                    if rose != want_rose:
                        fail(f"23a ungated K2 {label} {act} rows {B} ({path}): launches {rose}")
                    want = k1.ternary_mlp_plain(x, uperm if gathered else None, *ulayer, I,
                                                act=act)
                    err = ((got - want).abs().max() / want.abs().max()).item()
                    if got.shape != want.shape or not err <= MLP_TOL:
                        fail(f"23a ungated K2 {label} {act} gather={gathered} rows {B} ({path}): "
                             f"max|err| {err:.3e} > {MLP_TOL}")
                    ung_err = max(ung_err, err)
                    ung_checks += 1
        del ulayer, uperm
    rec23["per_call_ungated"] = {"checks": ung_checks, "max_rel_err": ung_err}
    print(f"23a K2 ungated at opt-1.3b's and bloom-560m's MLP widths: {ung_checks} calls (rows "
          f"1 / 8 decode path, 16 / 64 tensor cores, 1 / 16 CUDA cores; with and without the "
          f"gather; silu, gelu, relu), max|err| vs plain {ung_err:.3e} (<= {MLP_TOL})")

    def mixtral_launches(L_, passes, a8=False, k7_steps=0, E_=8, k_=2, gathered=False,
                         flags=("iota", True, False), k4_rows=True):
        """The launches of forward passes of ``passes`` rows each through
        ``L_`` layers of a mixture-of-experts model (E_ experts, k_ a token):
        qkv and o, then with more than one row every expert's gateup and
        down, with one row its top k_ experts' through the device-index
        entries. ``gathered`` (the "ssr" layout): qkv, o and gateup gather,
        down is folded; at <= 64 rows through K3 (K3s) or, under ``flags``
        (GATHER_KERNEL, IGATHER_FUSED, FUSED_GATHER) with IGATHER_FUSED off,
        K6 (K6s), else the gather kernel (K4 on its rows path, or its first
        kernel without ``k4_rows``; K5 on its rows path from 16 rows) then
        K1 (K4s / K5s then K1s). Paths by rows: the decode kernels (bf16)
        or the CUDA cores (W2A8) at <= 8 rows, the tensor cores from 9."""
        gk, igf, fg = flags
        c = dict(none)

        def calls(kind, n, rows):
            c[kind] += n * L_
            if rows >= 9:
                tc = "ternary_matmul_tc_a8" if a8 else "ternary_matmul_tc"
                c[tc if kind == "ternary_matmul" else f"{kind}_tc"] += n * L_
            elif not a8:
                c[f"{kind}_dec"] += n * L_

        def gather_calls(n, rows, idx=""):
            kind = ("onehot_gather" if gk == "iota" else "onehot_matmul") + idx
            c[kind] += n * L_
            if gk == "iota" and k4_rows:
                c[f"{kind}_rows" if idx else "onehot_gather_rows"] += n * L_
            elif gk != "iota" and rows >= 16:
                c["onehot_matmul_rows"] += n * L_

        def projections(n, rows, gather, idx=""):
            if gather and rows <= 64 and (igf or fg):
                calls(("ternary_matmul_igathered" if igf else "ternary_matmul_gathered") + idx, n,
                      rows)
            else:
                if gather:
                    gather_calls(n, rows, idx)
                calls("ternary_matmul" + idx, n, rows)

        for rows in passes:
            projections(2, rows, gathered)  # qkv, o
            if rows == 1:
                projections(k_, 1, gathered, "_idx")  # the top k experts' gateup
                calls("ternary_matmul_idx", k_, 1)  # and down
            else:
                projections(E_, rows, gathered)  # every expert's gateup
                calls("ternary_matmul", E_, rows)  # and down
        c["decode_attention"] = c["decode_attention_tc"] = L_ * k7_steps
        return c

    def moe_reference(cfg_, params_, prompts_, answers_, impl="auto"):
        """f32 logits at each answer's positions from ONE batched forward of
        the prompts + answers[:-1] (right-padded; causal, so the padding
        moves no earlier position) through the plain route, or for W2A8 the
        W2A8 route with every kernel swapped for its plain version."""
        rows = [list(p_) + list(a_[:-1]) for p_, a_ in zip(prompts_, answers_)]
        T = max(len(r) for r in rows)
        toks = torch.tensor([r + [0] * (T - len(r)) for r in rows], device=dev)
        c0 = counts()
        with torch.inference_mode(), (plain_versions() if impl == "a8"
                                      else contextlib.nullcontext()):
            logits = tdec.forward(cfg_, params_, toks, impl="plain" if impl == "auto" else "a8")
        if counts() != c0:
            fail("the teacher-forced MoE reference launched a kernel")
        return [logits[i, len(p_) - 1 : len(p_) - 1 + len(a_)].float()
                for i, (p_, a_) in enumerate(zip(prompts_, answers_))]

    def pick_gap(lf, ids):
        picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
        return ((lf.max(dim=1).values - picked) / lf.abs().max(dim=1).values).max().item()

    def moe_answers_held(label, cfg_, params_, prompts_, answers_, tol, impl="auto"):
        refs = moe_reference(cfg_, params_, prompts_, answers_, impl)
        worst = max(pick_gap(lf, ids) for lf, ids in zip(refs, answers_))
        del refs
        if not worst <= tol:
            fail(f"{label}: a pick trails the teacher-forced plain max by {worst:.3e} of "
                 f"max|logit| (> {tol})")
        return worst

    def moe_greedy(label, cfg_, params_, prompt_, new_, impl, want, held=None, tol=TOKEN_TOL,
                   ref=None):
        """greedy_generate with counts set to 0 just before and read just
        after, held to ``want``; ``held`` names the wrappers whose every call
        is held against its plain version; the answers held to ``tol``
        against the teacher-forced plain forward of ``ref`` (default
        ``params_``: the same weights)."""
        for k in per_call:
            per_call[k] = 0
        with swapped(each_call_checked, held) if held else contextlib.nullcontext():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = greedy_generate(cfg_, params_, prompt_, new_, impl=impl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
        if got != want:
            fail(f"{label}: launches {got}, want {want}")
        tally(got)
        checked = {k: v for k, v in per_call.items() if v}
        if held and checked != {k: got[k] for k in held if got[k]}:
            fail(f"{label}: {checked} calls held, launches {got}")
        ids = toks.tolist()
        worst = moe_answers_held(f"{label} answers", cfg_, params_ if ref is None else ref,
                                 prompt_.tolist(), ids, tol, impl)
        res = {"wall_s": wall, "launches": got, "worst_pick_gap": worst, "calls_held": checked,
               "decode_tok_s": prompt_.shape[0] * (new_ - 1) / wall}
        print(f"{label}: {prompt_.shape[0]} x {prompt_.shape[1]} ids + {new_} new in {wall:.2f} s, "
              f"launches exact {got}" + (f", every call of {sorted(checked)} held {checked}"
                                         if held else "")
              + f"; every pick within {worst:.3e} of the teacher-forced {impl} plain max "
              f"(<= {tol}) on {record['smi']}")
        return res, ids

    def moe_engine(label, cfg_, params_, prompts_, new_, want_fn, held=None, tol=TOKEN_TOL):
        eng = ServeEngine(cfg_, params_, max_batch=8, max_len=ENGINE_M)
        reqs = [eng.submit(p_, new_) for p_ in prompts_]
        for k in per_call:
            per_call[k] = 0
        with swapped(each_call_checked, held) if held else contextlib.nullcontext():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
        st_ = eng.stats["steps"]
        want = want_fn([min(_bucket(len(p_)), ENGINE_M) for p_ in prompts_] + [8] * st_, st_)
        if got != want:
            fail(f"engine {label}: launches {got}, want {want}")
        tally(got)
        if not all(r.done and len(r.out) == new_ for r in reqs):
            fail(f"engine {label}: a request did not finish with max_new tokens")
        checked = {k: v for k, v in per_call.items() if v}
        if held and checked != {k: got[k] for k in held if got[k]}:
            fail(f"engine {label}: {checked} calls held, launches {got}")
        outs_ = [r.out for r in reqs]
        worst = moe_answers_held(f"engine {label} answers", cfg_, params_, prompts_, outs_, tol)
        stt = dict(eng.stats)
        res = {"wall_s": wall, "steps": st_, "launches": got, "worst_pick_gap": worst,
               "decode_tok_s": stt["tokens"] / stt["t_decode_s"], "t_admit_s": stt["t_admit_s"],
               "calls_held": checked}
        print(f"engine {label}: {len(reqs)} requests ({[len(p_) for p_ in prompts_]} ids, "
              f"{new_} new) in {wall:.2f} s (decode {res['decode_tok_s']:.1f} tok/s, t_admit_s "
              f"{stt['t_admit_s']:.2f} s), {st_} steps, launches exact {got}"
              + (f", every call of {sorted(checked)} held {checked}" if held else "")
              + f"; every pick within {worst:.3e} of the batched teacher-forced plain max "
              f"(<= {tol}) on {record['smi']}")
        del eng
        return res, outs_

    stamp("23b")
    # (b) mixtral-8x7b at 32 layers, "down"
    cfg23, params23, rec23["build_s"] = build("mixtral-8x7b", "down", 23)
    L23 = cfg23.n_layers
    rec23["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    lp23 = tdec.layer_view(params23["layers"], 5)
    h23 = torch.randn((1, 1, cfg23.dim), generator=g23, device=dev).bfloat16()
    want_mlp = tdec._moe_mlp(cfg23, lp23, h23, "auto", 5)
    torch.cuda.synchronize()
    c0 = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = tdec._moe_mlp(cfg23, lp23, h23, "auto", 5)
    except RuntimeError as exc:
        fail(f"23b _moe_mlp at one row synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
    if not torch.equal(again, want_mlp) or rose != {"ternary_matmul_idx": 4,
                                                    "ternary_matmul_idx_dec": 4}:
        fail(f"23b _moe_mlp at one row: launches {rose}, or not its own result")
    print("23b _moe_mlp at one row (layer 5) under torch.cuda.set_sync_debug_mode('error'): no "
          f"host synchronisation, launches {rose}")
    prompt23 = torch.randint(0, cfg23.vocab_size, (1, 128), generator=g23, device=dev)
    passes = [128] + [1] * 31
    for impl in ("auto", "a8"):
        rec23[f"lockstep_{impl}"], ids23 = moe_greedy(
            f"23b mixtral-8x7b lockstep {impl} ({L23} layers, down)", cfg23, params23, prompt23,
            32, impl, mixtral_launches(L23, passes, a8=impl == "a8"),
            tol=MIXTRAL_DEEP_TOL if impl == "auto" else A8_TOLS[1])
        if impl == "auto":
            bf16_ids = ids23
    # the plain bf16 route's own drift from f32 at this depth, on the bf16 answer
    p32 = tdec._map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, params23)
    lb = moe_reference(cfg23, params23, prompt23.tolist(), bf16_ids)[0]
    lf = moe_reference(cfg23, p32, prompt23.tolist(), bf16_ids)[0]
    del p32
    rec23["bf16_noise"] = {"rel_l2_bf16_f32": ((lb - lf).norm() / lf.norm()).item(),
                           "pick_gap_bf16_vs_f32": pick_gap(lf, lb.argmax(dim=1).tolist())}
    del lb, lf
    torch.cuda.empty_cache()
    print(f"23b mixtral-8x7b bf16 noise ({L23} layers, the lockstep request's 128 + 31 ids "
          f"through the plain route): bf16 vs f32 relative L2 "
          f"{rec23['bf16_noise']['rel_l2_bf16_f32']:.3f}, the bf16 picks trail the f32 max by "
          f"{rec23['bf16_noise']['pick_gap_bf16_vs_f32']:.3e} of max|logit| on {record['smi']}")
    zero_counts()
    rec23["decode_step"] = profile_decode_step(cfg23, params23, prompt23, 128, 4, dev,
                                               "mixtral-8x7b down")
    got = counts()
    if got != mixtral_launches(L23, [128, 1, 1, 1]):
        fail(f"23b profiled decode steps: launches {got}")
    tally(got)
    cut23 = cfg23.with_(n_layers=2)
    rec23["lockstep_2layer"], _ = moe_greedy(
        "23b mixtral-8x7b lockstep, the same weights cut to 2 layers", cut23, params23, prompt23,
        32, "auto", mixtral_launches(2, passes), held=("ternary_matmul", "ternary_matmul_idx"))

    stamp("23c")
    # (c) the engine
    lens23 = torch.randint(64, 513, (8,), generator=gh23).tolist()
    prompts23 = make_prompts(cfg23, lens23, g23)
    # the engine at 8 of the 32 layers (the same stacked weights; the run's
    # time budget since phase 29 was added)
    eng23, L23e = cfg23.with_(n_layers=8), 8
    rec23["engine"], _ = moe_engine(
        f"23c mixtral-8x7b down bf16 KV ({L23e} of its {L23} layers)", eng23, params23,
        prompts23, 16, lambda passes_, st_: mixtral_launches(L23e, passes_, k7_steps=st_),
        held=("decode_attention",), tol=MIXTRAL_DEEP_TOL)
    rec23["engine_step"] = family_step(f"mixtral-8x7b down engine ({L23e} layers), bf16 KV",
                                       eng23, params23, prompts23)
    set_k7(False)  # the 2-layer engines: plain attention, as their reference's
    rec23["engine_2layer"], _ = moe_engine(
        "23c mixtral-8x7b, the same weights cut to 2 layers, K7 off", cut23, params23,
        prompts23[:4], 16, lambda passes_, st_: mixtral_launches(2, passes_),
        held=("ternary_matmul",))
    set_k7(True)
    del params23, want_mlp, again, lp23
    torch.cuda.empty_cache()

    ROUTED_HELD = ("ternary_matmul", "onehot_gather", "onehot_matmul", "ternary_matmul_gathered",
                   "ternary_matmul_idx", "onehot_gather_idx", "onehot_matmul_idx",
                   "ternary_matmul_gathered_idx")

    def routed_decode(cfg_d, params_d, pr):
        """(d) the 2-layer mixtral "ssr" cut under the G4, G5 and P2
        flags: _moe_mlp at one row under set_sync_debug_mode("error") with
        the device-index launches of its route; greedy_generate at batch 1
        (128 ids + 16 new), bf16 and W2A8, launches exact, every K1 / K4 /
        K5 / K6 call and every device-index call held against its plain
        version, the answers against the teacher-forced plain forward; G4
        once more with K4's rows path off (K4s on its first kernel)."""
        res = {}
        lp_d = tdec.layer_view(params_d["layers"], 1)
        g_h = torch.Generator(device=dev).manual_seed(2304)  # its own: later draws unchanged
        h_d = torch.randn((1, 1, cfg_d.dim), generator=g_h, device=dev).bfloat16()
        E_d, k_d = cfg_d.n_experts, cfg_d.experts_per_token
        for fname, flags in ROUTE_FLAGS.items():
            with route_flags(flags):
                want_mlp = tdec._moe_mlp(cfg_d, lp_d, h_d, "auto", 1)
                torch.cuda.synchronize()
                c0 = counts()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    again = tdec._moe_mlp(cfg_d, lp_d, h_d, "auto", 1)
                except RuntimeError as exc:
                    fail(f"23d _moe_mlp at one row under {fname} synchronised with the host: {exc}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
                full = mixtral_launches(1, [1], gathered=True, flags=flags)
                attn = mixtral_launches(1, [1], gathered=True, flags=flags, k_=0)
                want_rose = {k: full[k] - attn[k] for k in full if full[k] != attn[k]}
                if not torch.equal(again, want_mlp) or rose != want_rose:
                    fail(f"23d _moe_mlp at one row under {fname}: launches {rose}, want "
                         f"{want_rose}, or not its own result")
                print(f"23d _moe_mlp at one row (layer 1) under {fname} and "
                      f"set_sync_debug_mode('error'): no host synchronisation, launches {rose}")
                for impl in ("auto", "a8"):
                    res[f"{fname}_{impl}"], _ = moe_greedy(
                        f"23d mixtral-8x7b lockstep {impl} under {fname} (2 layers, ssr)", cfg_d,
                        params_d, pr, 16, impl,
                        mixtral_launches(2, [128] + [1] * 15, a8=impl == "a8", E_=E_d, k_=k_d,
                                         gathered=True, flags=flags),
                        held=ROUTED_HELD, tol=TOKEN_TOL if impl == "auto" else A8_TOLS[1])
        with route_flags(G4), k4_rows(False):
            res["G4_k4_first_auto"], _ = moe_greedy(
                "23d mixtral-8x7b lockstep auto under G4, K4's rows path off (2 layers, ssr)",
                cfg_d, params_d, pr, 16, "auto",
                mixtral_launches(2, [128] + [1] * 15, E_=E_d, k_=k_d, gathered=True, flags=G4,
                                 k4_rows=False), held=ROUTED_HELD)
        return res

    def ungated_k2_model():
        """(d) K2's ungated mode on a model's path: opt-1.3b cut to 2
        layers with its linear biases off and its up stored as the fused
        MLP's gateup, so that the decoder's fused branch routes its MLP to
        K2 (as JAX's routes such a layout on the TPU); greedy_generate at
        batch 1 (32 ids + 16 new: K2's tensor cores at the prefill, its
        decode path after), batch 16 (4 ids + 8 new: the tensor cores
        throughout) and batch 1 with both paths off (the CUDA-core K2),
        launches exact, every K1 and K2 call held, the answers against the
        teacher-forced plain forward of the same weights with up as up."""
        cfg_u = get_config("opt-1.3b").with_(n_layers=2, linear_bias=False)
        params_ref = random_ternary_params(cfg_u, seed=29, perm_mode="down", device=dev)
        lay = dict(params_ref["layers"])
        lay["gateup"] = lay.pop("up")
        params_u = dict(params_ref, layers=lay)
        L_ = cfg_u.n_layers

        def want(passes, k2_on=True):
            c = dict(none)
            for rows in passes:
                c["ternary_matmul"] += 2 * L_
                c["ternary_matmul_dec" if rows <= 8 else "ternary_matmul_tc"] += 2 * L_
                c["ternary_mlp"] += L_
                c["ternary_mlp_ungated"] += L_
                if k2_on:
                    c["ternary_mlp_dec" if rows <= 8 else "ternary_mlp_tc"] += L_
            return c

        res = {}
        g_u = torch.Generator(device=dev).manual_seed(229)
        for key, B_, Lp_, new_, k2_on in (("dec", 1, 32, 16, True), ("tc", 16, 4, 8, True),
                                          ("cuda_core", 1, 32, 16, False)):
            pr_u = torch.randint(0, cfg_u.vocab_size, (B_, Lp_), generator=g_u, device=dev)
            with k2_dec(k2_on), k2_tc(k2_on):
                res[key], _ = moe_greedy(
                    f"23d ungated K2: opt-1.3b, 2 layers, no biases, batch {B_}"
                    + ("" if k2_on else ", K2's decode and tensor-core paths off"), cfg_u,
                    params_u, pr_u, new_, "auto", want([B_ * Lp_] + [B_] * (new_ - 1), k2_on),
                    held=("ternary_matmul", "ternary_mlp"), ref=params_ref)
        del params_ref, params_u, lay
        torch.cuda.empty_cache()
        return res

    def moe_floor_pairs(cfg_d, params_d):
        """The 2-layer mixtral "ssr" cut under a8 and floor8, lockstep at
        batch 1 (32 ids, 4 new: one-row decode through K3s and K1s, under P2
        K6s), under the default flags, K1_DEC_A8, P2 and P2 with K1_DEC_A8:
        every kernel launched equally by the two. Its own generator. Returns
        each flag set's floor8 launches by FLOOR instance."""
        gfl = torch.Generator(device=dev).manual_seed(2307)
        pr_ = torch.randint(0, cfg_d.vocab_size, (1, 32), generator=gfl, device=dev)
        floor_keys = [f"{w}_floor" for w, _ in FLOOR_WRAPPERS]
        out = {}
        for fname, flags, dec_a8 in FLOOR_FLAG_SETS:
            k1.K1_DEC_A8 = dec_a8
            pair = {}
            with route_flags(flags) if flags else contextlib.nullcontext():
                for impl in ("a8", "floor8"):
                    zero_counts()
                    greedy_generate(cfg_d, params_d, pr_, 4, impl=impl)
                    torch.cuda.synchronize()
                    pair[impl] = counts()
            k1.K1_DEC_A8 = False
            a8c, flc = pair["a8"], pair["floor8"]
            if ({k_: v_ for k_, v_ in a8c.items() if k_ not in floor_keys}
                    != {k_: v_ for k_, v_ in flc.items() if k_ not in floor_keys}
                    or any(a8c[k_] for k_ in floor_keys)
                    or any(flc[f"{w}_floor"] != flc[w] for w, _ in FLOOR_WRAPPERS)):
                fail(f"23d mixtral ssr floor8 vs a8, {fname}: a8 launched {a8c}, floor8 {flc}")
            out[fname] = floor_instances(flc)
            print(f"23d 2-layer mixtral-8x7b ssr, {fname}: floor8 and a8 launch every kernel "
                  f"equally (1 x 32 ids, 4 new): {out[fname]}")
        return out

    stamp("23d")
    # (d) depth cuts: mixtral at 2 layers "ssr" (K3s), qwen3-30b-a3b at 4 "down"
    for name, layout, n_l, seed in (("mixtral-8x7b", "ssr", 2, 24),
                                    ("qwen3-30b-a3b", "down", 4, 25)):
        cfg_d, params_d, _ = build(name, layout, seed, n_layers=n_l)
        gathered = layout == "ssr"
        E_d, k_d = cfg_d.n_experts, cfg_d.experts_per_token
        pr = torch.randint(0, cfg_d.vocab_size, (1, 128), generator=g23, device=dev)
        for impl in ("auto", "a8"):
            rec23[f"{name}_{layout}_{impl}"], _ = moe_greedy(
                f"23d {name} lockstep {impl} ({n_l} layers, {layout})", cfg_d, params_d, pr, 16,
                impl, mixtral_launches(n_l, [128] + [1] * 15, a8=impl == "a8", E_=E_d, k_=k_d,
                                       gathered=gathered),
                held=idx_names, tol=TOKEN_TOL if impl == "auto" else A8_TOLS[1])
        set_k7(False)
        rec23[f"{name}_{layout}_engine"], _ = moe_engine(
            f"23d {name} {layout} ({n_l} layers), K7 off", cfg_d, params_d,
            make_prompts(cfg_d, torch.randint(64, 513, (4,), generator=gh23).tolist(), g23), 16,
            lambda passes_, st_: mixtral_launches(n_l, passes_, E_=E_d, k_=k_d,
                                                  gathered=gathered),
            held=(None if name == "qwen3-30b-a3b"  # 1024 K1 calls a step: time budget
                  else ("ternary_matmul", "ternary_matmul_igathered", "onehot_gather")),
            tol=QWEN3_MOE_TOKEN_TOL if name == "qwen3-30b-a3b" else TOKEN_TOL)
        set_k7(True)
        if name == "mixtral-8x7b":
            rec23["routed"] = routed_decode(cfg_d, params_d, pr)
            rec23["floor_pairs"] = moe_floor_pairs(cfg_d, params_d)
        del params_d
        torch.cuda.empty_cache()
    rec23["ungated_k2"] = ungated_k2_model()

    stamp("23e")
    # (e) the quantizer: one mixtral layer at full width, then served
    cfg_q = get_config("mixtral-8x7b").with_(n_layers=1)
    dense_q = tdec.init_params(cfg_q, torch.Generator(device=dev).manual_seed(21),
                               dtype=torch.bfloat16, device=dev)
    calib_q, _ = get_calibration_data("synthetic", cfg_q.vocab_size, num_samples=MOE_CALIB[0],
                                      seq_len=MOE_CALIB[1], seed=23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, qrep = tpipe.quantize_model(cfg_q, dense_q, calib_q, tpipe.QuantConfig())
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    del dense_q
    tm = qrep["timing"][0]
    rec23["quantize"] = {"seconds": q_s, "hessian_s": sum(tm["hessian_s"].values()),
                         "inverse_s": sum(tm["inverse_s"].values()),
                         "gptq_s": sum(tm["gptq_s"].values()), "layer_s": tm["layer_s"],
                         "report": qrep["layers"][0], "bits_per_weight": qrep["bits_per_weight"]}
    lay = qparams["layers"]
    if not (lay["gateup"].packed.shape[:2] == (1, 8) and lay["down"].input_folded
            and lay["gateup"].gather is None):
        fail("23e the quantized mixtral layer's experts are not the folded (1, 8, ...) stacks")
    art = os.path.join(ROOT, "build", "moe_artifact")
    ckpt.save_model(art, cfg_q, qparams, tpipe.QuantConfig(), qrep)
    del qparams
    cfg_a, params_a = ckpt.load_model(art, device=dev)
    shutil.rmtree(art)
    print(f"23e the quantizer, one mixtral-8x7b layer at full width, {MOE_CALIB[0]} x "
          f"{MOE_CALIB[1]} ids: {q_s:.2f} s (Hessians {rec23['quantize']['hessian_s']:.2f} s, "
          f"damped inverses {rec23['quantize']['inverse_s']:.2f} s, GPTQ "
          f"{rec23['quantize']['gptq_s']:.2f} s); gateup x8 rel_out_err "
          f"{qrep['layers'][0]['gateup']['rel_out_err']:.4f}, down x8 "
          f"{qrep['layers'][0]['down']['rel_out_err']:.4f}; bits/weight "
          f"{qrep['bits_per_weight']:.3f} on {record['smi']}")
    rec23["quantized_served"], _ = moe_greedy(
        "23e the quantized mixtral layer, served from its artifact", cfg_a, params_a,
        torch.randint(0, cfg_a.vocab_size, (1, 128), generator=g23, device=dev), 16, "auto",
        mixtral_launches(1, [128] + [1] * 15), held=("ternary_matmul", "ternary_matmul_idx"))
    del params_a
    torch.cuda.empty_cache()

    stamp("23f")
    # (f) the entries' C calls, B 1, from CUDA graph replays over stacks
    # larger than L2 (the slot rotating with the call), beside the view
    # route (the same kernel on the host slot), the plain version, the dense
    # bf16 expert through torch.matmul and the bytes bound
    dlib23, clib23 = k1._dec_kernel_lib(), k1._kernel_lib()
    cnt23 = torch.zeros(1024, dtype=torch.int32, device=dev)
    dix23 = dev.index or 0
    ev23 = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def graph23_ms(fn, calls=48, replays=4):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        s_, e_ = ev23(), ev23()
        s_.record()
        for _ in range(replays):
            graph.replay()
        e_.record()
        torch.cuda.synchronize()
        return s_.elapsed_time(e_) / (calls * replays)

    def events23_ms(fn, iters=6):
        fn(0)
        torch.cuda.synchronize()
        s_, e_ = ev23(), ev23()
        s_.record()
        for i in range(iters):
            fn(i)
        e_.record()
        torch.cuda.synchronize()
        return s_.elapsed_time(e_) / iters

    def rc23(rc, what):
        if rc:
            fail(f"23f {what}: launch failed ({rc})")

    moe_timing = []
    for label, n_out, n_in, mode in MOE_SHAPES[:3]:
        K, n = n_in, n_out
        slot_bytes = K * n // 4 + 4 * (K // 128) * n
        S = max(4, math.ceil(COLD_BYTES / slot_bytes))
        st23 = random_expert_stack(g23, 1, S, n, K, mode, device=dev)
        flat = tdec._flatten_expert_stack(st23)
        sel = torch.arange(S, dtype=torch.int32, device=dev)
        dense_w = torch.randn((K, n), generator=g23, device=dev).bfloat16()
        x = torch.randn((1, K), generator=g23, device=dev).bfloat16()
        xn, _ = k1.normalize_rows_a8(x)
        out = torch.empty((1, n), dtype=torch.float32, device=dev)
        splits = k1.dec_splits(K, n, 128, k1.dec_wave(dev))
        part = torch.empty((splits, 1, n), dtype=torch.float32, device=dev)
        pk, al, mu_, pm = flat.packed, flat.alpha, flat.mu, flat.perm
        gath = mode == "ssr"
        for a8 in (False, True):
            xa = (xn if a8 else x)
            kname = ("ternary_matmul_igathered_idx" if gath else "ternary_matmul_idx") + (
                "" if a8 else "_dec")

            def kern(i, view=False):
                s_ = i % S
                if view:
                    args = (pk[s_].data_ptr(), al[s_].data_ptr(), mu_[s_].data_ptr())
                else:
                    args = (pk.data_ptr(), al.data_ptr(), mu_.data_ptr())
                stream23 = torch.cuda.current_stream().cuda_stream
                if not a8 and not gath:
                    rc = (dlib23.pt2_ternary_matmul_dec(xa.data_ptr(), *args, part.data_ptr(),
                                                        out.data_ptr(), cnt23.data_ptr(), 1, K, n,
                                                        128, splits, 0, dix23, stream23)
                          if view else dlib23.pt2_ternary_matmul_dec_idx(
                              xa.data_ptr(), *args, part.data_ptr(), out.data_ptr(),
                              cnt23.data_ptr(), sel[s_:].data_ptr(), 0, S, 1, K, n, 128, splits,
                              0, dix23, stream23))
                elif not a8:
                    pp = pm[s_].data_ptr() if view else pm.data_ptr()
                    rc = (dlib23.pt2_ternary_matmul_dec_igathered(
                        xa.data_ptr(), pp, *args, part.data_ptr(), out.data_ptr(),
                        cnt23.data_ptr(), 1, K, K, n, 128, splits, 0, dix23, stream23)
                          if view else dlib23.pt2_ternary_matmul_dec_igathered_idx(
                              xa.data_ptr(), pp, *args, part.data_ptr(), out.data_ptr(),
                              cnt23.data_ptr(), sel[s_:].data_ptr(), 0, S, 1, K, K, n, 128,
                              splits, 0, dix23, stream23))
                elif not gath:
                    rc = (clib23.pt2_ternary_matmul(xa.data_ptr(), *args, out.data_ptr(), 1, K, n,
                                                    128, 1, dix23, stream23)
                          if view else clib23.pt2_ternary_matmul_idx(
                              xa.data_ptr(), *args, out.data_ptr(), sel[s_:].data_ptr(), 0, S, 1,
                              K, n, 128, 1, dix23, stream23))
                else:
                    pp = pm[s_].data_ptr() if view else pm.data_ptr()
                    rc = (clib23.pt2_ternary_matmul_igathered(
                        xa.data_ptr(), pp, *args, out.data_ptr(), 1, K, K, n, 128, 1, dix23,
                        stream23)
                          if view else clib23.pt2_ternary_matmul_igathered_idx(
                              xa.data_ptr(), pp, *args, out.data_ptr(), sel[s_:].data_ptr(), 0, S,
                              1, K, K, n, 128, 1, dix23, stream23))
                rc23(rc, kname)

            ms = graph23_ms(kern)
            view_ms = graph23_ms(lambda i: kern(i, view=True))
            plain = (k1.ternary_matmul_igathered_plain if gath else
                     (k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain))
            if gath:
                plain_ms = events23_ms(lambda i: plain(x, pm[i % S], pk[i % S], al[i % S],
                                                       mu_[i % S], a8=a8))
            else:
                plain_ms = events23_ms(lambda i: plain(x, pk[i % S], al[i % S], mu_[i % S]))
            lib_ms = graph23_ms(lambda i: torch.matmul(x, dense_w), calls=24)
            nbytes = slot_bytes + 2 * K + 4 * n + 4 + (4 * K if gath else 0)
            b_ms = max(nbytes / bw * 1e3, 2 * K * n / bf16_peak * 1e3)
            d = {"kernel": kname, "shape": label, "B": 1, "a8": a8, "ms": ms, "view_ms": view_ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes, "bound_ms": b_ms,
                 "bound_by": "bytes" if nbytes / bw >= 2 * K * n / bf16_peak else "operations"}
            moe_timing.append(d)
            print(f"23f {kname} {label} B=1: {ms * 1e3:.2f} us (view route {view_ms * 1e3:.2f} "
                  f"us) | plain {plain_ms * 1e3:.1f} us | torch.matmul dense bf16 "
                  f"{lib_ms * 1e3:.2f} us | bound {b_ms * 1e3:.2f} us ({100 * b_ms / ms:.1f} % "
                  f"of it; graph replays over {S} slots) on {record['smi']}")
        del st23, flat, dense_w
        torch.cuda.empty_cache()

    def timed(kname, label, B, a8, ms, view_ms, plain_ms, lib_ms, nbytes, ops, lib_name):
        b_ms = max(nbytes / bw * 1e3, ops / bf16_peak * 1e3)
        d = {"kernel": kname, "shape": label, "B": B, "a8": a8, "ms": ms, "view_ms": view_ms,
             "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes, "bound_ms": b_ms,
             "bound_by": "bytes" if nbytes / bw >= ops / bf16_peak else "operations"}
        moe_timing.append(d)
        print(f"23f {kname} {label} B={B}{' W2A8' if a8 else ''}: {ms * 1e3:.2f} us"
              + ("" if view_ms is None else f" (view route {view_ms * 1e3:.2f} us)")
              + f" | plain {plain_ms * 1e3:.1f} us | {lib_name} {lib_ms * 1e3:.2f} us | bound "
              f"{b_ms * 1e3:.2f} us ({100 * b_ms / ms:.1f} % of it; graph replays over > L2) on "
              f"{record['smi']}")

    # (f) K4s (both kernels) and K5s at mixtral's gateup gather
    # (4096 features, 4096 lanes, B 1) over perm / planes stacks > L2 (K4s:
    # one replay walks all 4096 perm slots, 64 MB, each call its own),
    # beside the view route, the plain version, torch.index_select and the
    # bytes bound
    gf23 = torch.Generator(device=dev).manual_seed(2306)
    glib, grows_lib, mmlib = k4._kernel_lib(), k4._gather_rows_kernel_lib(), k4._mm_kernel_lib()
    m_g, K_g = 4096, 4096
    x_g = torch.randn((1, m_g), generator=gf23, device=dev).bfloat16()
    o_g = torch.empty((1, K_g), dtype=torch.bfloat16, device=dev)
    S4 = 4096
    perms4 = torch.argsort(torch.rand((S4, m_g), generator=gf23, device=dev), dim=1).to(torch.int32)
    sel4 = torch.arange(S4, dtype=torch.int32, device=dev)
    for kname, idx_fn, view_fn in (
            ("onehot_gather_rows_idx", grows_lib.pt2_onehot_gather_rows_idx,
             grows_lib.pt2_onehot_gather_rows),
            ("onehot_gather_idx", glib.pt2_onehot_gather_idx, glib.pt2_onehot_gather)):
        def kern(i, view=False, idx_fn=idx_fn, view_fn=view_fn):
            s_, st_ = i % S4, torch.cuda.current_stream().cuda_stream
            if view:
                rc = view_fn(x_g.data_ptr(), perms4[s_].data_ptr(), o_g.data_ptr(), 1, m_g, K_g, 2,
                             dix23, st_)
            else:
                rc = idx_fn(x_g.data_ptr(), perms4.data_ptr(), o_g.data_ptr(), 1, m_g, K_g, 2,
                            sel4[s_:].data_ptr(), 0, S4, dix23, st_)
            rc23(rc, kname)

        timed(kname, "mixtral gateup gather", 1, False, graph23_ms(kern, S4, 2),
              graph23_ms(lambda i: kern(i, view=True), S4, 2),
              events23_ms(lambda i: k4.onehot_gather_idx_plain(x_g, perms4, sel4[i % S4], 0)),
              graph23_ms(lambda i: torch.index_select(x_g, 1, perms4[i % S4]), S4, 2),
              2 * m_g + 4 * K_g + 2 * K_g + 4, 0, "torch.index_select")
    del perms4, sel4
    S5 = math.ceil(COLD_BYTES / (m_g // 4 * K_g))
    perms5 = torch.argsort(torch.rand((S5, m_g), generator=gf23, device=dev), dim=1).to(torch.int32)
    planes5 = torch.stack([tgather.make_packed_gather(p_, m_g).packed for p_ in perms5])
    sel5 = torch.arange(S5, dtype=torch.int32, device=dev)

    def kern5(i, view=False):
        s_, st_ = i % S5, torch.cuda.current_stream().cuda_stream
        if view:
            rc = mmlib.pt2_onehot_matmul(x_g.data_ptr(), planes5[s_].data_ptr(), o_g.data_ptr(), 1,
                                         m_g, m_g // 4, K_g, 2, dix23, st_)
        else:
            rc = mmlib.pt2_onehot_matmul_idx(x_g.data_ptr(), planes5.data_ptr(), o_g.data_ptr(), 1,
                                             m_g, m_g // 4, K_g, 2, sel5[s_:].data_ptr(), 0, S5,
                                             dix23, st_)
        rc23(rc, "onehot_matmul_idx")

    timed("onehot_matmul_idx", "mixtral gateup gather", 1, False, graph23_ms(kern5),
          graph23_ms(lambda i: kern5(i, view=True)),
          events23_ms(lambda i: k4.onehot_matmul_idx_plain(x_g, planes5, sel5[i % S5], 0)),
          graph23_ms(lambda i: torch.index_select(x_g, 1, perms5[i % S5])),
          2 * m_g + m_g // 4 * K_g + 2 * K_g + 4, 2 * K_g, "torch.index_select")
    del perms5, planes5, sel5

    # (f) K6s at mixtral's gateup with its gather (4096 -> 28672,
    # B 1): its decode path (bf16) and its CUDA-core kernel (W2A8) over
    # stacks > L2, beside the view route, the plain version, the dense bf16
    # expert through torch.matmul on the gathered x, and the bytes bound
    gdlib, gclib = k1._gathered_dec_kernel_lib(), k1._gathered_kernel_lib()
    m6, n6 = 4096, 28672
    slot6 = m6 // 4 * m6 + m6 * n6 // 4 + 4 * (m6 // 128) * n6
    S6 = max(4, math.ceil(COLD_BYTES / slot6))
    flat6 = tdec._flatten_expert_stack(random_expert_stack(gf23, 1, S6, n6, m6, "ssr", device=dev))
    gp6, pk6, al6, mu6 = flat6.gather.packed, flat6.packed, flat6.alpha, flat6.mu
    K6 = pk6.shape[1] * 4
    sel6 = torch.arange(S6, dtype=torch.int32, device=dev)
    x6 = torch.randn((1, m6), generator=gf23, device=dev).bfloat16()
    xn6, _ = k1.normalize_rows_a8(x6)
    xg6 = torch.empty((1, K6), dtype=torch.bfloat16, device=dev)
    splits6 = k1.dec_splits(K6, n6, 128, k1.dec_wave(dev))
    part6 = torch.empty((max(splits6, K6 // 128), 1, n6), dtype=torch.float32, device=dev)
    out6 = torch.empty((1, n6), dtype=torch.float32, device=dev)
    dense6 = torch.randn((K6, n6), generator=gf23, device=dev).bfloat16()
    for a8 in (False, True):
        xa = xn6 if a8 else x6
        kname = "ternary_matmul_gathered_idx" + ("" if a8 else "_dec")

        def kern6(i, view=False, xa=xa, a8=a8):
            s_, st_ = i % S6, torch.cuda.current_stream().cuda_stream
            w = ((gp6[s_], pk6[s_], al6[s_], mu6[s_]) if view else (gp6, pk6, al6, mu6))
            w = tuple(t.data_ptr() for t in w)
            tail = (1, m6, m6 // 4, K6, n6)
            if not a8:
                head = (xa.data_ptr(), *w, xg6.data_ptr(), part6.data_ptr(), out6.data_ptr(),
                        cnt23.data_ptr())
                rc = (gdlib.pt2_ternary_matmul_gathered_dec(*head, *tail, splits6, 0, dix23, st_)
                      if view else gdlib.pt2_ternary_matmul_gathered_dec_idx(
                          *head, sel6[s_:].data_ptr(), 0, S6, *tail, splits6, 0, dix23, st_))
            else:
                head = (xa.data_ptr(), *w, part6.data_ptr(), out6.data_ptr())
                rc = (gclib.pt2_ternary_matmul_gathered(*head, *tail, 1, dix23, st_) if view
                      else gclib.pt2_ternary_matmul_gathered_idx(
                          *head, sel6[s_:].data_ptr(), 0, S6, *tail, 1, dix23, st_))
            rc23(rc, kname)

        nbytes6 = slot6 + 2 * m6 + 4 * n6 + 4
        timed(kname, "mixtral gateup ssr", 1, a8, graph23_ms(kern6),
              graph23_ms(lambda i: kern6(i, view=True)),
              events23_ms(lambda i: k1.ternary_matmul_gathered_idx_plain(
                  x6, gp6, pk6, al6, mu6, sel6[i % S6], 0, a8=a8)),
              graph23_ms(lambda i: torch.matmul(xg6, dense6), calls=24), nbytes6, 2 * K6 * n6,
              "torch.matmul dense bf16 on gathered x")
    if cnt23.any():
        fail("23f K6s's decode path left a counter set")
    del flat6, gp6, pk6, al6, mu6, dense6, part6
    torch.cuda.empty_cache()

    # (f) K2's ungated mode at opt-1.3b's MLP (relu) and bloom-560m's
    # (gelu), "down" layout (the identity perm): the decode path at B 1,
    # the tensor-core path at B 16, the CUDA-core kernel at B 1, over
    # copies > L2, beside the plain version, the two dense bf16
    # torch.matmul with the activation (a yardstick) and the bytes bound
    udlib, utlib, uclib = k1._mlp_dec_kernel_lib(), k1._mlp_tc_kernel_lib(), k1._mlp_kernel_lib()
    dwave, twave = k1.dec_wave(dev), k1.igtc_wave(dev)
    for label, (D, I, n), act in (("opt-1.3b", (2048, 8192, 2048), 2),
                                  ("bloom-560m", (1024, 4096, 1024), 1)):
        act_name = k1.MLP_ACTS[act]
        wbytes = D * I // 4 + 4 * (D // 128) * I + I * n // 4 + 4 * (I // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        ulayers = [rand_layer(D, I, gen=gf23) + rand_layer(I, n, gen=gf23) for _ in range(copies)]
        ident = k1._identity_perm(D, dev)
        w_up = torch.randn((D, I), generator=gf23, device=dev).bfloat16()
        w_dn = torch.randn((I, n), generator=gf23, device=dev).bfloat16()
        for kname, B in (("ternary_mlp_dec_ungated", 1), ("ternary_mlp_tc_ungated", 16),
                         ("ternary_mlp_ungated", 1)):
            x = torch.randn((B, D), generator=gf23, device=dev).bfloat16()
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            Bp = k1.igtc_rows_pad(B) if kname == "ternary_mlp_tc_ungated" else B
            if kname == "ternary_mlp_dec_ungated":
                gs, ds = k1.dec_splits(D, I, 128, dwave), k1.dec_splits(I, n, 128, dwave)
            else:
                gs, ds = k1.igtc_splits(D, I, 128, twave), k1.igtc_splits(I, n, 128, twave)
            f32 = dict(dtype=torch.float32, device=dev)
            gpart = torch.empty((gs, Bp, I), **f32)
            dpart = torch.empty((max(ds, I // 128), B, n), **f32)
            mid = torch.empty((Bp, I), dtype=torch.bfloat16, device=dev)
            xg = torch.empty((Bp, D), dtype=torch.bfloat16, device=dev)
            sums = torch.empty((D // 128, Bp), **f32)
            msums = torch.empty((I // 64 + I // 128, Bp), **f32)

            def kern2(i, kname=kname, B=B, x=x, out=out, gs=gs, ds=ds, gpart=gpart, dpart=dpart,
                      mid=mid, xg=xg, sums=sums, msums=msums):
                w = tuple(t.data_ptr() for t in ulayers[i % copies])
                st_ = torch.cuda.current_stream().cuda_stream
                if kname == "ternary_mlp_dec_ungated":
                    rc = udlib.pt2_ternary_mlp_dec_ungated(
                        x.data_ptr(), ident.data_ptr(), *w, gpart.data_ptr(), dpart.data_ptr(),
                        mid.data_ptr(), out.data_ptr(), cnt23.data_ptr(), B, D, D, I, n, gs, ds,
                        act, dix23, st_)
                elif kname == "ternary_mlp_tc_ungated":
                    rc = utlib.pt2_ternary_mlp_tc_ungated(
                        x.data_ptr(), ident.data_ptr(), *w, xg.data_ptr(), sums.data_ptr(),
                        gpart.data_ptr(), mid.data_ptr(), msums.data_ptr(), dpart.data_ptr(),
                        out.data_ptr(), cnt23.data_ptr(), B, D, D, I, n, gs, ds, act, dix23,
                        st_)
                else:
                    rc = uclib.pt2_ternary_mlp(
                        x.data_ptr(), None, *w, dpart.data_ptr(), out.data_ptr(), B, D, D, I, I,
                        I, n, act, dix23, st_)
                rc23(rc, kname)

            def library(i, x=x):
                return torch.matmul(k1.mlp_activation(act_name, torch.matmul(x, w_up)), w_dn)

            timed(kname, label, B, False, graph23_ms(kern2), None,
                  events23_ms(lambda i, x=x: k1.ternary_mlp_plain(x, None, *ulayers[i % copies], I,
                                                                  act=act_name)),
                  graph23_ms(library, calls=24), wbytes + 2 * B * D + 4 * B * n,
                  2 * B * (D * I + I * n), "two dense torch.matmul with the activation")
        if cnt23.any():
            fail("23f K2's ungated paths left a counter set")
        del ulayers, w_up, w_dn
        torch.cuda.empty_cache()
    rec23["timing"] = moe_timing
    record["moe"] = rec23

    stamp("24")
    # ---- 24. the floor probe (impl="floor8": W2A8 with the 2-bit unpack
    # skipped in K1, K3 and K6, the raw packed bytes dotted; wrong by design,
    # with the same bytes, grids and launches). (a) every FLOOR instance held
    # against the floor's plain versions at llama-2-7b / llama-3-8b
    # projections, B 1, 8, 16 and 64 (K1_DEC_A8 off and on at decode rows),
    # and K1s / K3s / K6s at B 1 bit for bit the view route's; (b) the
    # 2-layer llama-3-8b "ssr" model under a8 and floor8, lockstep at B 4
    # (a 512-row prefill: the gather, then K1 on its int8 tensor cores) and
    # B 1 (a 40-row prefill: K3 or K6 on its tensor-core path), under the
    # default flags, K1_DEC_A8, P2 and P2 with K1_DEC_A8: the launches of
    # every kernel equal between the two; (c) the floor A/B of
    # scripts/torch_floor_ab.py, llama-2-7b "ssr" at full width and
    # FLOOR_AB_LAYERS of its 32 layers: ms/step under auto, a8 and floor8
    # (K1_DEC_A8 off: W2A8 decode rows on the CUDA cores), then a8 and floor8
    # with K1_DEC_A8 (on the decode GEMV). Its own generator: later phases
    # draw what they drew before.
    rec24 = {}
    gf = torch.Generator(device=dev).manual_seed(24)
    # launches by FLOOR instance over every floor8 run (23d's and 24b's)
    floor_launches = dict.fromkeys(floor_instances(none), 0)
    for inst in record["moe"]["floor_pairs"].values():
        for k_, v_ in inst.items():
            floor_launches[k_] += v_
    floor_err = dict.fromkeys(floor_launches, 0.0)
    floor_abs = dict.fromkeys(floor_launches, 0.0)
    checks24 = 0
    paths_of = {"ternary_matmul": k1.k1_path, "ternary_matmul_igathered": k1.k3_path,
                "ternary_matmul_gathered": k1.k6_path}
    plains_of = {"ternary_matmul": k1.ternary_matmul_floor_plain,
                 "ternary_matmul_igathered": k1.ternary_matmul_igathered_floor_plain,
                 "ternary_matmul_gathered": k1.ternary_matmul_gathered_floor_plain}
    for label, K, n in (("7b qkv", 4096, 12288), ("8b qkv", 4096, 6144), ("8b down", 14336, 4096)):
        T = torch.randint(-1, 2, (n, K), generator=gf, device=dev, dtype=torch.int8)
        packed = pack_ternary(T, 128)
        del T
        alpha = (0.05 + 0.01 * torch.rand((K // 128, n), generator=gf, device=dev)).bfloat16()
        mu = (0.01 * torch.randn((K // 128, n), generator=gf, device=dev)).bfloat16()
        perm = torch.randperm(K, generator=gf, device=dev).to(torch.int32)
        gp = tgather.make_packed_gather(perm, K).packed
        operands = {"ternary_matmul": (packed, alpha, mu),
                    "ternary_matmul_igathered": (perm, packed, alpha, mu),
                    "ternary_matmul_gathered": (gp, packed, alpha, mu)}
        for B in (1, 8, 16, 64):
            x = torch.randn((B, K), generator=gf, device=dev).bfloat16()
            for dec_a8 in ((False, True) if B <= 8 else (False,)):
                k1.K1_DEC_A8 = dec_a8
                for w, fn in (("ternary_matmul", k1.ternary_matmul),
                              ("ternary_matmul_igathered", k1.ternary_matmul_igathered),
                              ("ternary_matmul_gathered", k1.ternary_matmul_gathered)):
                    path = paths_of[w](B, n, 128, True)
                    sub = None if path == "cuda_core" else path
                    c0 = counts()
                    got = fn(x, *operands[w], a8=k1.FLOOR)
                    rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
                    want_rose = {w: 1, f"{w}_floor": 1, **({f"{w}_{sub}": 1} if sub else {})}
                    if rose != want_rose:
                        fail(f"24a {w} floor {label} B={B} K1_DEC_A8={dec_a8}: launches {rose}, "
                             f"want {want_rose}")
                    want = plains_of[w](x, *operands[w])
                    err = ((got - want).abs().max() / want.abs().max()).item()
                    if not err <= FLOOR_TOL:
                        fail(f"24a {w} floor ({path}) {label} B={B}: max|err| {err:.3e} > "
                             f"{FLOOR_TOL} x max|ref|")
                    key = f"{w}_{sub}" if sub else w
                    floor_err[key] = max(floor_err[key], err)
                    floor_abs[key] = max(floor_abs[key], (got - want).abs().max().item())
                    checks24 += 1
            k1.K1_DEC_A8 = False
        del packed, alpha, mu, perm, gp, operands
        torch.cuda.empty_cache()
    # K1s / K3s / K6s: slot 1 + 1 of 3-slot stacks at 8b qkv, B 1, on the
    # decode kernel (K1_DEC_A8) and the CUDA cores, bit for bit the view
    # route's (the same kernel on the host slot) and within FLOOR_TOL of the
    # floor's plain version
    K, n, S = 4096, 6144, 3
    lay = [(pack_ternary(torch.randint(-1, 2, (n, K), generator=gf, device=dev,
                                       dtype=torch.int8), 128),
            (0.05 + 0.01 * torch.rand((K // 128, n), generator=gf, device=dev)).bfloat16(),
            (0.01 * torch.randn((K // 128, n), generator=gf, device=dev)).bfloat16())
           for _ in range(S)]
    sp, sa, sm = (torch.stack([l_[j] for l_ in lay]).contiguous() for j in range(3))
    sperm = torch.stack([torch.randperm(K, generator=gf, device=dev).to(torch.int32)
                         for _ in range(S)]).contiguous()
    sgp = torch.stack([tgather.make_packed_gather(sperm[s_], K).packed for s_ in range(S)])
    sel24 = torch.tensor(1, dtype=torch.int32, device=dev)
    x = torch.randn((1, K), generator=gf, device=dev).bfloat16()
    for dec_a8 in (False, True):
        k1.K1_DEC_A8 = dec_a8
        for w, fn, extra, view_fn in (
                ("ternary_matmul_idx", k1.ternary_matmul_idx, (), k1.ternary_matmul),
                ("ternary_matmul_igathered_idx", k1.ternary_matmul_igathered_idx, (sperm,),
                 k1.ternary_matmul_igathered),
                ("ternary_matmul_gathered_idx", k1.ternary_matmul_gathered_idx, (sgp,),
                 k1.ternary_matmul_gathered)):
            c0 = counts()
            got = fn(x, *extra, sp, sa, sm, sel24, 1, a8=k1.FLOOR)
            rose = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
            want_rose = {w: 1, f"{w}_floor": 1, **({f"{w}_dec": 1} if dec_a8 else {})}
            if rose != want_rose:
                fail(f"24a {w} floor K1_DEC_A8={dec_a8}: launches {rose}, want {want_rose}")
            view = view_fn(x, *(e_[2] for e_ in extra), sp[2], sa[2], sm[2], a8=k1.FLOOR)
            plain = plains_of[w[:-4]](x, *(e_[2] for e_ in extra), sp[2], sa[2], sm[2])
            err = ((got - plain).abs().max() / plain.abs().max()).item()
            if not (torch.equal(got, view) and err <= FLOOR_TOL):
                fail(f"24a {w} floor K1_DEC_A8={dec_a8}: not the view route bit for bit, or "
                     f"max|err| {err:.3e} > {FLOOR_TOL}")
            key = f"{w}_dec" if dec_a8 else w
            floor_err[key] = max(floor_err[key], err)
            floor_abs[key] = max(floor_abs[key], (got - plain).abs().max().item())
            checks24 += 1
    k1.K1_DEC_A8 = False
    del lay, sp, sa, sm, sperm, sgp
    torch.cuda.empty_cache()
    rec24["per_call"] = {"checks": checks24, "max_rel_err": dict(floor_err),
                         "max_abs_err": dict(floor_abs)}
    print(f"24a the floor's FLOOR instances (K1 decode GEMV / int8 tensor cores / CUDA cores, K3 "
          f"decode / tensor-core product / CUDA cores, K6 the same, K1s / K3s / K6s decode and "
          f"CUDA cores) at llama-2-7b / llama-3-8b shapes, B 1 / 8 / 16 / 64: {checks24} calls "
          f"within {FLOOR_TOL} x max|ref| of the floor's plain versions, max {floor_err}")

    # (b) floor8 against a8 on the 2-layer llama-3-8b "ssr" model: equal launches
    cfg24, params24, _ = build("llama-3-8b", "ssr", 3, n_layers=2)
    prompts24 = {(4, 128): torch.randint(0, cfg24.vocab_size, (4, 128), generator=gf, device=dev),
            (1, 40): torch.randint(0, cfg24.vocab_size, (1, 40), generator=gf, device=dev)}
    floor_keys = [f"{w}_floor" for w, _ in FLOOR_WRAPPERS]
    rec24["pairs"] = {}
    for fname, flags, dec_a8 in FLOOR_FLAG_SETS:
        k1.K1_DEC_A8 = dec_a8
        pair = {}
        with route_flags(flags) if flags else contextlib.nullcontext():
            for impl in ("a8", "floor8"):
                tot = dict(none)
                for prompt_ in prompts24.values():
                    zero_counts()
                    greedy_generate(cfg24, params24, prompt_, 8, impl=impl)
                    torch.cuda.synchronize()
                    c = counts()
                    tally(c)
                    for k_, v_ in c.items():
                        tot[k_] += v_
                pair[impl] = tot
        k1.K1_DEC_A8 = False
        a8c, flc = pair["a8"], pair["floor8"]
        same = {k_: v_ for k_, v_ in a8c.items() if k_ not in floor_keys} == {
            k_: v_ for k_, v_ in flc.items() if k_ not in floor_keys}
        if not same or any(a8c[k_] for k_ in floor_keys) or any(
                flc[f"{w}_floor"] != flc[w] for w, _ in FLOOR_WRAPPERS):
            fail(f"24b 2-layer llama-3-8b ssr {fname}: a8 launched {a8c}, floor8 {flc}")
        inst = floor_instances(flc)
        for k_, v_ in inst.items():
            floor_launches[k_] += v_
        rec24["pairs"][fname] = {"launches": flc, "floor_instances": inst}
        print(f"24b 2-layer llama-3-8b ssr, {fname}: floor8 and a8 launch every kernel equally "
              f"(B 4 x 128 and B 1 x 40 ids, 8 new each): {inst}")
    del params24
    torch.cuda.empty_cache()

    # (c) the floor A/B at full width (scripts/torch_floor_ab.py's slopes)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_floor_ab", os.path.join(ROOT, "scripts", "torch_floor_ab.py"))
    floor_ab_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(floor_ab_mod)
    cfg_f, params_f, _ = build("llama-2-7b", "ssr", 2, n_layers=FLOOR_AB_LAYERS)
    prompt_f = torch.randint(0, cfg_f.vocab_size, (1, 32), generator=gf, device=dev)
    rec24["ab"] = floor_ab_mod.floor_ab(cfg_f, params_f, prompt_f, FLOOR_AB_NEW, FLOOR_AB_ROUNDS)
    k1.K1_DEC_A8 = True
    rec24["ab_dec_a8"] = floor_ab_mod.floor_ab(cfg_f, params_f, prompt_f, FLOOR_AB_NEW,
                                               FLOOR_AB_ROUNDS, impls=("a8", "floor8"))
    k1.K1_DEC_A8 = False
    del params_f
    torch.cuda.empty_cache()
    for tag, r_ in (("K1_DEC_A8 off", rec24["ab"]), ("K1_DEC_A8 on", rec24["ab_dec_a8"])):
        print(f"24c floor A/B, llama-2-7b ssr ({FLOOR_AB_LAYERS} of 32 layers, full width), B 1, "
              f"{tag}: " + ", ".join(f"{i} {r_[i]['ms_step']:.3f} ms/step ({r_[i]['tok_s']:.1f} "
                                     f"tok/s)" for i in ("auto", "a8", "floor8") if i in r_)
              + f"; a8 - floor8 {r_['unpack_ms_step']:.3f} ms/step, floor8 / a8 "
              f"{100 * r_['floor8_over_a8']:.1f} % on {record['smi']}")
    rec24["launches"] = floor_launches
    record["floor"] = rec24

    stamp("25")
    # ---- 25. K7 at the head widths above 256 that JAX's kernel takes (hd
    # 384 and 512: 16 / 32-position tiles, two stages of the ring at hd
    # 512). (a) both of its kernels at B 1 and 8, M 2048, bf16 and int8 KV,
    # ragged lengths, 8 / 2 KV heads: the tensor-core kernel held as phase
    # 2b holds it (the plain version, the split plain version on its plan,
    # the same bits twice), the CUDA-core kernel against the plain version; (b) a
    # 2-layer llama-3-8b with head_dim 384 and one with 512 (ModelConfig.with_,
    # "down" layout) in the ServeEngine (8 slots, M 2048, 4 requests, 16 new),
    # bf16 and int8 KV, and at hd 384 bf16 with K7_TC off: K7 launched
    # layers x steps times (all of them at the wide width), every K7 call held
    # against its plain version, every answer held to TOKEN_TOL under its
    # teacher-forced plain reference. Its own generator.
    rec25 = {}
    gw = torch.Generator(device=dev).manual_seed(25)
    errs["decode_attention_wide"] = errs["decode_attention_cc_wide"] = 0.0
    errs["decode_attention_wide_split"] = 0.0
    nchecks["decode_attention_wide"] = nchecks["decode_attention_cc_wide"] = 0

    for hd in WIDE_HEAD_DIMS:
        for B in (1, 8):
            for quant in (False, True):
                a = attn_inputs(B, ENGINE_M, 8, 2, quant, hd=hd, gen=gw)
                label = f"25a K7 hd={hd} B={B} M={ENGINE_M} int8={quant}"
                plain = k7.decode_attention_plain(*a[:4], hd ** -0.5, *a[4:])
                c0 = (k7.decode_attention.launches, k7.decode_attention.launches_tc,
                      k7.decode_attention.launches_wide)
                got = k7.decode_attention(*a[:4], hd ** -0.5, *a[4:])
                again = k7.decode_attention(*a[:4], hd ** -0.5, *a[4:])
                k7.K7_TC = False
                got_cc = k7.decode_attention(*a[:4], hd ** -0.5, *a[4:])
                k7.K7_TC = True
                rose = (k7.decode_attention.launches - c0[0], k7.decode_attention.launches_tc - c0[1],
                        k7.decode_attention.launches_wide - c0[2])
                if rose != (3, 2, 3):
                    fail(f"{label}: launches (all, tensor-core, wide) rose by {rose}, not (3, 2, 3)")
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"{label}: two runs differ")
                held("decode_attention_wide", label, got, plain, ATTN_TOL)
                held("decode_attention_cc_wide", f"{label} (CUDA-core kernel)", got_cc, plain,
                     ATTN_TOL)
                plan = k7.k7_plan(B, ENGINE_M, 2, 4, hd, quant)
                want = k7.decode_attention_split_plain(*a[:4], hd ** -0.5, *a[4:], tile=plan.tile,
                                                       splits=plan.splits).float()
                step = torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                over = ((got.float() - want).abs() - step).max().item() / want.abs().max().item()
                if not over <= K7_SPLIT_TOL:
                    fail(f"{label}: {over:.3e} of max|ref| past one bf16 step of the split plain "
                         "version")
                errs["decode_attention_wide_split"] = max(errs["decode_attention_wide_split"], over)
                del a, plain
    rec25["per_call"] = {k_: {"checks": nchecks[k_], "max_abs_err": errs[k_]}
                         for k_ in ("decode_attention_wide", "decode_attention_cc_wide")}
    print(f"25a K7 at hd {WIDE_HEAD_DIMS}, B 1 / 8, M {ENGINE_M}, bf16 and int8: tensor-core "
          f"kernel {nchecks['decode_attention_wide']} checks (max|err| "
          f"{errs['decode_attention_wide']:.3e}, past one bf16 step of its split plain version by "
          f"at most {errs.get('decode_attention_wide_split', 0.0):.3e} of max|ref|), the CUDA-core "
          f"kernel "
          f"{nchecks['decode_attention_cc_wide']} (max|err| {errs['decode_attention_cc_wide']:.3e}),"
          f" each within {ATTN_TOL} x max|ref| of the plain version")

    # (b) 2-layer models at head_dim 384 / 512 in the engine
    wide_launches = {f"decode_attention{'' if tc_ else '_cc'}_hd{hd_}": 0
                     for hd_ in WIDE_HEAD_DIMS for tc_ in (True, False)}
    rec25["engines"] = {}
    for hd, kvq, tc in ((384, False, True), (384, True, True), (384, False, False),
                        (512, False, True), (512, True, False)):
        cfg_w = get_config("llama-3-8b").with_(n_layers=2, head_dim=hd)
        if cfg_w.hd != hd:
            fail(f"25b a head_dim {hd} config has hd {cfg_w.hd}")
        params_w = random_ternary_params(cfg_w, seed=hd, perm_mode="down", device=dev)
        prompts_w = make_prompts(cfg_w, torch.randint(64, 513, (4,), generator=gw,
                                                      device=dev).tolist(), gw)
        k7.K7_TC = tc
        eng = ServeEngine(cfg_w, params_w, max_batch=8, max_len=ENGINE_M, kv_quant=kvq)
        reqs = [eng.submit(p_, 16) for p_ in prompts_w]
        for k_ in per_call:
            per_call[k_] = 0
        with swapped(each_call_checked, ("decode_attention",)):
            zero_counts()
            eng.run()
            torch.cuda.synchronize()
            got = counts()
        k7.K7_TC = True
        st_ = eng.stats["steps"]
        L_ = cfg_w.n_layers
        want = {"decode_attention": L_ * st_, "decode_attention_wide": L_ * st_,
                "decode_attention_tc": L_ * st_ if tc else 0,
                "held": L_ * st_}
        have = {"decode_attention": got["decode_attention"],
                "decode_attention_wide": got["decode_attention_wide"],
                "decode_attention_tc": got["decode_attention_tc"],
                "held": per_call["decode_attention"]}
        if have != want:
            fail(f"25b 2-layer hd {hd} engine (int8 KV={kvq}, K7_TC={tc}): {have}, want {want}")
        tally(got)
        if not all(r.done and len(r.out) == 16 for r in reqs):
            fail(f"25b 2-layer hd {hd} engine: a request did not finish")
        worst = family_answers_held(f"25b 2-layer hd {hd} engine answers", cfg_w, params_w,
                                    prompts_w, [r.out for r in reqs], kvq, TOKEN_TOL)
        wide_launches[f"decode_attention{'' if tc else '_cc'}_hd{hd}"] += got["decode_attention_wide"]
        tag = f"hd {hd} {'int8' if kvq else 'bf16'} KV{'' if tc else ', K7_TC off'}"
        rec25["engines"][tag] = {"steps": st_, "launches": got, "worst_pick_gap": worst}
        print(f"25b 2-layer llama-3-8b at head_dim {hd} ServeEngine ({tag}): {st_} decode steps, "
              f"K7 launched {got['decode_attention']} = {L_} layers x {st_} steps, every call "
              f"held against its plain version; every pick within {worst:.2e} of the teacher-"
              f"forced plain max (<= {TOKEN_TOL})")
        del eng, params_w
        torch.cuda.empty_cache()
    rec25["launches"] = wide_launches
    record["k7_wide"] = rec25

    stamp("26")
    # ---- 26. ring KV caches (serve/ring.py): gemma3-4b at full width and
    # its 34 layers (5 global, 29 sliding with a window of 1024), seeded as
    # phase 22b's. (a) ring_generate at B 2 (1100 ids each, 8 new): launches
    # exact (K7 at every layer of every decode step: the
    # sliding layers on their 1024-slot rings), every answer held to
    # GEMMA3_DEEP_TOL under its teacher-forced plain reference (the flat
    # route); (b) the ServeEngine with make_ring_engine_fns (8 slots, M 2048;
    # two requests over the window, six under it, 16 new): launches exact,
    # every K7 call held against its plain version, every answer held to
    # GEMMA3_DEEP_TOL; one decode step profiled (device time) and timed on
    # the host clock; the KV bytes of ring and flat pools; (c) the same
    # engine on the weights cut to GEMMA3_HELD_LAYERS layers, answers held to
    # TOKEN_TOL; (d) cut to 2 layers (both sliding): every K1 and K7 call
    # held against its plain version, K7's on 1024-slot rings; (e) a sampled
    # generate pair (temperature 0.8, top-k 40, top-p 0.95) on the 6-layer
    # cut, equal under one seed. Its own generators.
    from pt2tpu_torch.serve import ring as tring
    from pt2tpu_torch.serve.generate import generate as tgenerate
    from pt2tpu_torch.serve.sampling import SamplingConfig as TSamplingConfig

    rec26 = {}
    gr = torch.Generator(device=dev).manual_seed(26)
    ghr = torch.Generator().manual_seed(26)
    cfg26, params26, rec26["build_s"] = build("gemma3-4b", "down", 24)
    L26 = cfg26.n_layers
    W26 = cfg26.sliding_window
    gl26 = cfg26.globals_list()

    # (a) the lockstep ring decode
    prompt26 = torch.randint(0, cfg26.vocab_size, (2, 1100), generator=gr, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks26 = tring.ring_generate(cfg26, params26, prompt26, 8, max_len=ENGINE_M)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = family_launches("gemma3-4b", L26, [2 * 1100] + [2] * 7, 7)
    if got != want:
        fail(f"26a gemma3-4b ring_generate: launches {got}, want {want}")
    tally(got)
    worst = family_answers_held("26a gemma3-4b ring_generate answers", cfg26, params26,
                                prompt26.tolist(), toks26.tolist(), False, GEMMA3_DEEP_TOL)
    rec26["lockstep"] = {"wall_s": wall, "launches": got, "worst_pick_gap": worst}
    print(f"26a gemma3-4b ring_generate ({L26} layers: {sum(gl26)} global, {L26 - sum(gl26)} "
          f"sliding on {W26}-slot rings), 2 x 1100 ids + 8 new in {wall:.2f} s, launches exact "
          f"{got}; every pick within {worst:.2e} of the teacher-forced plain (flat) max (<= "
          f"{GEMMA3_DEEP_TOL}) on {record['smi']}")

    def ring_engine(cfg_, params_):
        pf, df, fac = tring.make_ring_engine_fns(cfg_, device=dev)
        return ServeEngine(cfg_, params_, max_batch=8, max_len=ENGINE_M, prefill_fn=pf,
                           decode_fn=df, cache_factory=fac)

    lens26 = torch.randint(1100, 1401, (2,), generator=ghr).tolist() + torch.randint(
        64, 513, (6,), generator=ghr).tolist()
    prompts26 = make_prompts(cfg26, lens26, gr)

    def ring_engine_run(label, cfg_, params_, new_, held, tol):
        eng = ring_engine(cfg_, params_)
        if not isinstance(eng.cache, tring.RingCaches) or eng.cache.window != W26:
            fail(f"{label}: the pool is not the ring's")
        reqs = [eng.submit(p_, new_) for p_ in prompts26]
        for k_ in per_call:
            per_call[k_] = 0
        with swapped(each_call_checked, held):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall_ = time.perf_counter() - t0
            got_ = counts()
        st_ = eng.stats["steps"]
        want_ = family_launches("gemma3-4b", cfg_.n_layers,
                                [min(_bucket(len(p_)), ENGINE_M) for p_ in prompts26] + [8] * st_,
                                st_)
        checked = {k_: v_ for k_, v_ in per_call.items() if v_}
        if got_ != want_ or checked != {k_: got_[k_] for k_ in held}:
            fail(f"{label}: launches {got_}, want {want_}, held {checked}")
        tally(got_)
        if not all(r.done and len(r.out) == new_ for r in reqs):
            fail(f"{label}: a request did not finish with max_new tokens")
        worst_ = family_answers_held(f"{label} answers", cfg_, params_, prompts26,
                                     [r.out for r in reqs], False, tol)
        stt = dict(eng.stats)
        res = {"wall_s": wall_, "steps": st_, "launches": got_, "calls_held": checked,
               "worst_pick_gap": worst_, "decode_tok_s": stt["tokens"] / stt["t_decode_s"],
               "t_admit_s": stt["t_admit_s"], "t_decode_s": stt["t_decode_s"],
               "kv_bytes_ring": eng.cache.nbytes,
               "kv_bytes_flat": 2 * cfg_.n_layers * 8 * ENGINE_M * cfg_.kv_heads * cfg_.hd * 2}
        print(f"{label}: prompts {lens26}, {new_} new: {st_} decode steps in {wall_:.2f} s (decode "
              f"{res['decode_tok_s']:.1f} tok/s, t_admit_s {stt['t_admit_s']:.2f} s), launches "
              f"exact {got_}, every call of {sorted(held)} held {checked}; every pick within "
              f"{worst_:.2e} of the teacher-forced plain (flat) max (<= {tol}); KV pool "
              f"{res['kv_bytes_ring'] / 2**20:.1f} MiB against the flat pool's "
              f"{res['kv_bytes_flat'] / 2**20:.1f} MiB on {record['smi']}")
        return eng, res

    # (b) 34 layers, every K7 call held
    eng, rec26["engine"] = ring_engine_run(f"26b gemma3-4b ring engine ({L26} layers, bf16)",
                                           cfg26, params26, 16, ("decode_attention",),
                                           GEMMA3_DEEP_TOL)
    del eng
    eng = ring_engine(cfg26, params26)
    for p_ in prompts26:
        eng.submit(p_, 64)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        eng.step()
    step_wall = (time.perf_counter() - t0) / 6 * 1e3
    rec26["engine_step"] = dict(profile_engine_step(eng, "gemma3-4b ring engine, bf16 KV"),
                                step_wall_ms=step_wall)
    print(f"26b gemma3-4b ring engine step (8 busy slots): wall {step_wall:.2f} ms on the host "
          f"clock, device {rec26['engine_step']['device_ms']:.2f} ms (profiler) on {record['smi']}")
    del eng
    torch.cuda.empty_cache()
    # (c) the 6-layer cut and (d) the 2-layer cut of the same weights
    cut26 = cfg26.with_(n_layers=GEMMA3_HELD_LAYERS)
    eng, rec26["engine_cut"] = ring_engine_run(
        f"26c gemma3-4b ring engine ({GEMMA3_HELD_LAYERS} of its {L26} layers)", cut26, params26,
        16, ("ternary_matmul", "decode_attention"), TOKEN_TOL)
    del eng
    cfg2 = cfg26.with_(n_layers=2)
    if any(cfg2.globals_list()):
        fail("the 2-layer gemma3-4b copy has a global layer")
    ring_shapes = []
    held_attn = each_call_checked

    def ring_spy(name, kernel, plain, tol):
        call_ = held_attn(name, kernel, plain, tol)
        if name != "decode_attention":
            return call_

        def spy(q_, k_, v_, *a_, **kw):
            ring_shapes.append(k_.shape[1])
            return call_(q_, k_, v_, *a_, **kw)
        return spy

    eng = ring_engine(cfg2, params26)
    reqs = [eng.submit(p_, 16) for p_ in prompts26[:4]]
    for k_ in per_call:
        per_call[k_] = 0
    with swapped(ring_spy, ("ternary_matmul", "decode_attention")):
        zero_counts()
        eng.run()
        torch.cuda.synchronize()
        got = counts()
    st_ = eng.stats["steps"]
    want = family_launches("gemma3-4b", 2, [min(_bucket(len(p_)), ENGINE_M)
                                             for p_ in prompts26[:4]] + [8] * st_, st_)
    checked = {k_: v_ for k_, v_ in per_call.items() if v_}
    if got != want or checked != {k_: got[k_] for k_ in ("ternary_matmul", "decode_attention")} \
            or set(ring_shapes) != {W26}:
        fail(f"26d 2-layer gemma3-4b ring engine: launches {got}, want {want}, held {checked}, "
             f"K7 over {sorted(set(ring_shapes))} slots")
    tally(got)
    worst = family_answers_held("26d 2-layer gemma3-4b ring engine answers", cfg2, params26,
                                prompts26[:4], [r.out for r in reqs], False, TOKEN_TOL)
    rec26["engine_2layer"] = {"launches": got, "calls_held": checked, "worst_pick_gap": worst,
                              "k7_slots": W26}
    print(f"26d 2-layer gemma3-4b ring engine (both layers sliding): every K1 / K7 call held "
          f"against its plain version {checked}, every K7 call over a {W26}-slot ring; "
          f"launches exact; every pick within {worst:.2e} (<= {TOKEN_TOL})")
    del eng
    # (e) a sampled generate pair, one seed
    sc26 = TSamplingConfig(temperature=0.8, top_k=40, top_p=0.95)
    pair26 = []
    for _ in range(2):
        gen26 = torch.Generator(device=dev).manual_seed(2626)
        pair26.append(tgenerate(cut26, params26, prompt26[:, :256], 8, sampling=sc26,
                                generator=gen26).tolist())
    if pair26[0] != pair26[1]:
        fail("26e the sampled generate pair differs under one seed")
    rec26["sampled_pair_equal"] = True
    print(f"26e sampled generate ({GEMMA3_HELD_LAYERS}-layer gemma3-4b, 2 x 256 ids, 8 new, "
          f"temperature 0.8, top-k 40, top-p 0.95), two runs under one seed: the same "
          f"{len(pair26[0][0])} x 2 tokens")
    del params26
    torch.cuda.empty_cache()
    record["ring"] = rec26

    stamp("27")
    # ---- 27. K2's floor probe (fused_mlp_apply(..., impl="floor8"): x and mid
    # rounded and clipped to int8, every plane's code the raw packed byte;
    # wrong by design, the bf16 K2's bytes, grids and launches). No route
    # picks it (fused_mlp_ok answers False for floor8, as JAX's), so these
    # direct calls are its main path. (a) llama-3-8b's MLP in the "ssr"
    # layout (with its gather, silu) and gemma-2b's in the "down" layout (the
    # identity perm, GeGLU), each a 2-layer stack called at layer 1: rows 1, 4
    # and 8 (the decode path), 16 and 64 (the tensor-core path), then rows 1
    # and 8 on the CUDA-core kernel with both other paths off; counts set to
    # 0 before each call and read after, each call held to
    # ternary_mlp_floor_plain within MLP_TOL (K2's own) and far from the bf16
    # MLP; (b) each path's FLOOR instance timed through its C entry at
    # llama-3-8b's MLP with its gather beside the bf16 instance of the same
    # path (in turns floor, bf16, bf16, floor; weights rotated over
    # COLD_BYTES): the unpack's share of K2
    rec27 = {"calls": [], "launches": {}, "max_abs_err": {}, "max_rel_err": {}, "timing": []}
    g27 = torch.Generator(device=dev).manual_seed(27)
    path_key27 = {"dec": "ternary_mlp_dec_floor", "tc": "ternary_mlp_tc_floor",
                  "cc": "ternary_mlp_floor"}
    for key_ in path_key27.values():
        rec27["launches"][key_] = 0
        rec27["max_abs_err"][key_] = rec27["max_rel_err"][key_] = 0.0

    def floor_rows27(rows, width):
        """bf16 rows whose scales run geometrically from 8 down to 0.05 (one
        row: 8): mid from the clip to small integers."""
        scale = torch.logspace(math.log10(8.0), math.log10(0.05), rows, device=dev)[:, None]
        return (torch.randn((rows, width), generator=g27, device=dev) * scale).bfloat16()

    for name27, layout27, act27, seed27 in (("llama-3-8b", "ssr", "silu", 27),
                                            ("gemma-2b", "down", "gelu", 28)):
        cfg27, params27, _ = build(name27, layout27, seed27, n_layers=2)
        gu27, dn27 = params27["layers"]["gateup"], params27["layers"]["down"]
        if not ttm.fused_mlp_ok(gu27, dn27, "auto", 8, dev) or ttm.fused_mlp_ok(
                gu27, dn27, "floor8", 8, dev):
            fail(f"27a {name27}: fused_mlp_ok should take the bf16 MLP and refuse floor8")
        gu1, dn1 = gu27.layer(1), dn27.layer(1)
        perm1 = gu1.perm if layout27 == "ssr" else None
        args1 = (perm1, gu1.packed, gu1.alpha, gu1.mu, dn1.packed, dn1.alpha, dn1.mu)
        for path, rows_list in (("dec", (1, 4, 8)), ("tc", (16, 64)), ("cc", (1, 8))):
            with k2_dec(path != "cc"), k2_tc(path != "cc"):
                for rows in rows_list:
                    x = floor_rows27(rows, cfg27.dim)
                    zero_counts()
                    with torch.inference_mode():
                        got = ttm.fused_mlp_apply(gu27, dn27, x, act27, layer_idx=1,
                                                  out_dtype=torch.float32, impl="floor8")
                    torch.cuda.synchronize()
                    c = counts()
                    want_c = dict(none, ternary_mlp=1, ternary_mlp_floor=1,
                                  ternary_mlp_dec=int(path == "dec"),
                                  ternary_mlp_tc=int(path == "tc"),
                                  ternary_mlp_gelu=int(act27 == "gelu"))
                    if c != want_c:
                        fail(f"27a {name27} floor8 at {rows} rows ({path}): launches {c}, "
                             f"want {want_c}")
                    rec27["launches"][path_key27[path]] += 1
                    want = k1.ternary_mlp_floor_plain(x, *args1, intermediate=dn1.in_features,
                                                      act=act27)
                    bf16 = k1.ternary_mlp_plain(x, *args1, intermediate=dn1.in_features,
                                                act=act27)
                    top = want.abs().max().item()
                    err = (got - want).abs().max().item()
                    far = (bf16 - want).abs().max().item() / top
                    if not err <= MLP_TOL * top or far < 0.1:
                        fail(f"27a {name27} floor8 at {rows} rows ({path}): {err / top:.3e} of "
                             f"max|plain| (> {MLP_TOL}), or the bf16 MLP within {far:.3e}")
                    key_ = path_key27[path]
                    rec27["max_abs_err"][key_] = max(rec27["max_abs_err"][key_], err)
                    rec27["max_rel_err"][key_] = max(rec27["max_rel_err"][key_], err / top)
                    rec27["calls"].append({"model": name27, "path": path, "rows": rows,
                                           "rel_err": err / top, "bf16_far": far})
        del params27, gu27, dn27, gu1, dn1, args1
        torch.cuda.empty_cache()
    print(f"27a K2's floor (fused_mlp_apply impl=floor8) at llama-3-8b's MLP (ssr, silu) and "
          f"gemma-2b's (down, GeGLU), layer 1 of 2: {len(rec27['calls'])} calls, each on the "
          f"path it was sent to, held within {MLP_TOL} x max|plain| of ternary_mlp_floor_plain "
          f"(max {rec27['max_rel_err']}), far from the bf16 MLP; launches {rec27['launches']}")

    stamp("27b")
    # (b) the C entries of each path, FLOOR and bf16 instances in turns
    mlp_dec_lib27, mlp_tc_lib27 = k1._mlp_dec_kernel_lib(), k1._mlp_tc_kernel_lib()
    mlp_lib27, mlp_floor_lib27 = k1._mlp_kernel_lib(), k1._mlp_floor_kernel_lib()
    stream27 = torch.cuda.current_stream().cuda_stream
    dix27 = dev.index or 0
    ctr27 = torch.zeros(1024, dtype=torch.int32, device=dev)
    D, I, n = MLP_8B
    wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + I * n // 4 + 4 * (I // 128) * n
    copies = max(1, math.ceil(COLD_BYTES / wbytes))
    layers27 = [rand_layer(D, 2 * I, gen=g27) + rand_layer(I, n, gen=g27)
                + (rand_perm(D, D, gen=g27),) for _ in range(copies)]
    ev27 = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def time27(fn, iters):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        s, e = ev27(), ev27()
        s.record()
        for i in range(iters):
            fn(i)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def ok27(rc, what):
        if rc:
            fail(f"27b {what} launch failed in timing: {rc}")

    # the library yardstick: torch._int_mm of int8 rows (24: it takes > 16
    # rows in multiples of 8) by the dense int8 gateup codes, then of int8
    # mid by the dense down codes (each past L2 on its own)
    g8_27 = torch.randint(-1, 2, (2 * I, D), generator=g27, device=dev, dtype=torch.int8).t()
    d8_27 = torch.randint(-1, 2, (n, I), generator=g27, device=dev, dtype=torch.int8).t()
    xq27 = torch.randint(-127, 128, (24, D), generator=g27, device=dev, dtype=torch.int8)
    mq27 = torch.randint(-127, 128, (24, I), generator=g27, device=dev, dtype=torch.int8)
    try:
        torch._int_mm(xq27, g8_27), torch._int_mm(mq27, d8_27)
    except RuntimeError:
        g8_27, d8_27 = g8_27.contiguous(), d8_27.contiguous()
    int_mm27 = time27(lambda i: (torch._int_mm(xq27, g8_27), torch._int_mm(mq27, d8_27)), 20)
    del g8_27, d8_27
    # (the CUDA-core FLOOR instance is built for 8-row tiles only: both at 8)
    for path, B27 in (("dec", 1), ("tc", 16), ("cc", 8)):
        x = floor_rows27(B27, D)
        out = torch.empty((B27, n), dtype=torch.float32, device=dev)
        if path == "dec":
            wave = k1.dec_wave(dev)
            gs, ds = k1.dec_splits(D, 2 * I, 128, wave), k1.dec_splits(I, n, 128, wave)
            gpart = torch.empty((gs, B27, 2 * I), dtype=torch.float32, device=dev)
            dpart = torch.empty((ds, B27, n), dtype=torch.float32, device=dev)
            mid = torch.empty((B27, I), dtype=torch.bfloat16, device=dev)

            def kern(i, floor):
                gp, ga, gm, dp, da, dm, pm = layers27[i % copies]
                fn = (mlp_dec_lib27.pt2_ternary_mlp_dec_floor if floor
                      else mlp_dec_lib27.pt2_ternary_mlp_dec)
                ok27(fn(x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                        dp.data_ptr(), da.data_ptr(), dm.data_ptr(), gpart.data_ptr(),
                        dpart.data_ptr(), mid.data_ptr(), out.data_ptr(), ctr27.data_ptr(), B27,
                        D, D, I, n, gs, ds, 0, dix27, stream27), "K2 dec")
        elif path == "tc":
            wave = k1.igtc_wave(dev)
            gs, ds = k1.igtc_splits(D, 2 * I, 128, wave), k1.igtc_splits(I, n, 128, wave)
            Bp = k1.igtc_rows_pad(B27)
            xg = torch.empty((Bp, D), dtype=torch.bfloat16, device=dev)
            S = torch.empty((D // 128, Bp), dtype=torch.float32, device=dev)
            gpart = torch.empty((gs, Bp, 2 * I), dtype=torch.float32, device=dev)
            mid = torch.empty((Bp, I), dtype=torch.bfloat16, device=dev)
            msums = torch.empty((I // 64 + I // 128, Bp), dtype=torch.float32, device=dev)
            dpart = torch.empty((ds, B27, n), dtype=torch.float32, device=dev)

            def kern(i, floor):
                gp, ga, gm, dp, da, dm, pm = layers27[i % copies]
                fn = (mlp_tc_lib27.pt2_ternary_mlp_tc_floor if floor
                      else mlp_tc_lib27.pt2_ternary_mlp_tc)
                ok27(fn(x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                        dp.data_ptr(), da.data_ptr(), dm.data_ptr(), xg.data_ptr(), S.data_ptr(),
                        gpart.data_ptr(), mid.data_ptr(), msums.data_ptr(), dpart.data_ptr(),
                        out.data_ptr(), ctr27.data_ptr(), B27, D, D, I, n, gs, ds, 0, dix27,
                        stream27), "K2 tc")
        else:
            partial = torch.empty((I // 128, B27, n), dtype=torch.float32, device=dev)

            def kern(i, floor):
                gp, ga, gm, dp, da, dm, pm = layers27[i % copies]
                fn = (mlp_floor_lib27.pt2_ternary_mlp_floor if floor
                      else mlp_lib27.pt2_ternary_mlp)
                ok27(fn(x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                        dp.data_ptr(), da.data_ptr(), dm.data_ptr(), partial.data_ptr(),
                        out.data_ptr(), B27, D, D, 2 * I, I, I, n, 0, dix27, stream27), "K2")
        iters = 50 if path != "cc" else 20
        turns = [time27(lambda i: kern(i, True), iters), time27(lambda i: kern(i, False), iters),
                 time27(lambda i: kern(i, False), iters), time27(lambda i: kern(i, True), iters)]
        gp, ga, gm, dp, da, dm, pm = layers27[0]
        plain_ms = time27(lambda i: k1.ternary_mlp_floor_plain(x, pm, gp, ga, gm, dp, da, dm, I),
                          3)
        nbytes = wbytes + 2 * B27 * D + 4 * B27 * n + 4 * D
        ops = 2.0 * B27 * (D * 2 * I + I * n)
        t_bytes, t_ops = nbytes / bw * 1e3, ops / bf16_peak * 1e3
        d27 = {"kernel": path_key27[path], "B": B27, "D": D, "I": I, "n": n,
               "ms": min(turns[0], turns[3]), "bf16_ms": min(turns[1], turns[2]),
               "turns_ms": turns, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": int_mm27}
        d27["unpack_share"] = 1.0 - d27["ms"] / d27["bf16_ms"]
        rec27["timing"].append(d27)
        print(f"27b K2 floor, {path} path, llama-3-8b MLP (gather, silu) at {B27} rows: "
              f"{' / '.join(f'{t * 1e3:.1f}' for t in turns)} us in turns floor, bf16, bf16, "
              f"floor (the unpack {100 * d27['unpack_share']:.1f} % of the bf16 instance) | plain "
              f"{plain_ms * 1e3:.1f} us | torch._int_mm x2 (24 rows) {int_mm27 * 1e3:.1f} us | "
              f"bound {d27['bound_ms'] * 1e3:.2f} us "
              f"({d27['bound_by']}) on {record['smi']}")
    if ctr27.any():
        fail("27b a K2 floor timing left a counter set")
    del layers27
    torch.cuda.empty_cache()
    record["k2_floor"] = rec27

    stamp("28")
    # ---- 28. the paged engine (serve/paged.py) on llama-3-8b "down", cut to
    # 8 of its 32 layers (the run's time budget since phase 31), with phase
    # 5b's requests (8 slots, M 2048, 16 greedy requests
    # of 64-512 ids): page_size 64, kv_pages 80 (31 % of the flat pool's 256
    # pages; 8 slots x 9 pages is the worst case of these requests). Runs:
    # bf16 KV at quantum 1, int8 KV at quantum 1, bf16 KV at quantum 8, each
    # beside the flat engine with the same settings: tokens and finish order
    # equal, every page back on the free list after the drain, launches exact
    # (K7 once a layer of every decode step, on the gathered view); both
    # pools' bytes; one decode step of each engine profiled and timed on the
    # host clock
    from pt2tpu_torch.serve.paged import PagedServeEngine

    rec28 = {"runs": {}}
    cfg28, params28, rec28["build_s"] = build("llama-3-8b", "down", 5, n_layers=8)
    L28, PS28, PAGES28 = cfg28.n_layers, 64, 80

    def llama_launches(L_, passes, k7_steps, k2):
        """The launches of forward passes of ``passes`` rows each through
        ``L_`` layers of a llama model in the "down" layout, routes written
        out: K1 for qkv and o (decode kernel at <= 8 rows, tensor cores from
        9); the MLP through K2 at <= 64 rows where ``k2`` (decode path <= 8,
        tensor cores 9-64), else K1 for gateup and down; K7 once a layer for
        each of ``k7_steps`` decode steps."""
        c = dict(none)
        for rows in passes:
            n_k1 = 2 if k2 and rows <= 64 else 4
            c["ternary_matmul"] += n_k1 * L_
            c["ternary_matmul_dec" if rows <= 8 else "ternary_matmul_tc"] += n_k1 * L_
            if n_k1 == 2:
                c["ternary_mlp"] += L_
                c["ternary_mlp_dec" if rows <= 8 else "ternary_mlp_tc"] += L_
        c["decode_attention"] = c["decode_attention_tc"] = L_ * k7_steps
        return c

    def engine28(paged, kvq, quantum):
        kw = dict(max_batch=8, max_len=ENGINE_M, kv_quant=kvq, decode_quantum=quantum)
        if paged:
            return PagedServeEngine(cfg28, params28, page_size=PS28, kv_pages=PAGES28, **kw)
        return ServeEngine(cfg28, params28, **kw)

    def run28(label, paged, kvq, quantum):
        eng = engine28(paged, kvq, quantum)
        reqs = [eng.submit(p_, m_) for p_, m_ in zip(eng_prompts, eng_news)]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        got_ = counts()
        st_ = eng.stats["steps"]
        buckets = [min(_bucket(len(p_), PS28 if paged else 16), ENGINE_M) for p_ in eng_prompts]
        want_ = llama_launches(L28, buckets + [8] * st_, st_, True)
        if got_ != want_:
            fail(f"28 {label}: launches {got_}, want {want_}")
        tally(got_)
        if not all(r.done and len(r.out) == m_ for r, m_ in zip(reqs, eng_news)):
            fail(f"28 {label}: a request did not finish with max_new tokens")
        stt = dict(eng.stats)
        res = {"wall_s": wall_, "steps": st_, "launches": got_,
               "decode_tok_s": stt["tokens"] / stt["t_decode_s"], "t_admit_s": stt["t_admit_s"],
               "t_decode_s": stt["t_decode_s"],
               "kv_bytes": sum(t.numel() * t.element_size() for t in eng.cache.leaves())}
        if paged:
            if sorted(eng._free) != list(range(1, PAGES28 + 1)):
                fail(f"28 {label}: pages {sorted(set(range(1, PAGES28 + 1)) - set(eng._free))} "
                     f"not back on the free list after the drain")
            res["free_after_drain"] = len(eng._free)
        return eng, res, [r.out for r in reqs], [r.uid for r in eng.finished]

    for kvq, quantum in ((False, 1), (True, 1), (False, 8)):
        kv = "int8" if kvq else "bf16"
        tag = f"{kv} KV quantum {quantum}"
        eng_p, res_p, out_p, ord_p = run28(f"paged {tag}", True, kvq, quantum)
        del eng_p
        eng_f, res_f, out_f, ord_f = run28(f"flat {tag}", False, kvq, quantum)
        del eng_f
        if out_p != out_f or ord_p != ord_f:
            fail(f"28 paged {tag}: {sum(a != b for a, b in zip(out_p, out_f))} streams or the "
                 f"finish order differ from the flat engine's")
        rec28["runs"][tag] = {"paged": res_p, "flat": res_f}
        print(f"28 llama-3-8b down ({L28} layers) paged engine, {tag}: 16 requests, tokens and "
              f"finish order equal to the flat engine's, every page back; {res_p['steps']} decode "
              f"steps in {res_p['wall_s']:.2f} s (flat {res_f['wall_s']:.2f}), decode "
              f"{res_p['decode_tok_s']:.1f} tok/s (flat {res_f['decode_tok_s']:.1f}); KV pool "
              f"{res_p['kv_bytes'] / 2**20:.1f} MiB against {res_f['kv_bytes'] / 2**20:.1f} MiB; "
              f"launches exact {res_p['launches']} on {record['smi']}")
    stamp("28b")
    for paged in (True, False):  # one decode step with 8 busy slots, each pool
        eng = engine28(paged, False, 1)
        for p_ in eng_prompts[:8]:
            eng.submit(p_, 64)
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            eng.step()
        step_wall = (time.perf_counter() - t0) / 6 * 1e3
        name_ = "paged" if paged else "flat"
        rec28[f"step_{name_}"] = dict(profile_engine_step(eng, f"llama-3-8b {name_} engine"),
                                      step_wall_ms=step_wall)
        print(f"28 llama-3-8b {name_} engine step (8 busy slots, {L28} layers): wall "
              f"{step_wall:.2f} ms on the host clock, device "
              f"{rec28[f'step_{name_}']['device_ms']:.2f} ms (profiler) on {record['smi']}")
        del eng
    del params28
    torch.cuda.empty_cache()
    record["paged"] = rec28

    stamp("29")
    # ---- 29. speculative decoding: llama-2-70b (the registry's largest dense
    # model) as the target under a llama-2-7b draft, both "down" at full
    # width, the 70b cut to 40 of its 80 layers (the run's time budget since
    # phase 31), the 7b at its 32 (they share the 32000-token
    # vocabulary), bf16 KV, spec_k 4. The 70b's K2 takes its MLP at <= 64
    # rows (its gateup needs no pad blocks), the 7b's gateup is padded (no K2).
    # (a) speculative_generate: one prompt of 128 ids, 16 new (32 before
    # phase 31, the run's time budget); launches
    # exact (per round: k + 1 one-row draft forwards, one k + 1-row verify;
    # M 165: no K7), every answer held to TOKEN_TOL under its teacher-forced
    # plain reference, beside the 70b's greedy_generate on the card (equal
    # tokens counted, not gated: a near-tie may break apart between the
    # 1-row and the 5-row kernels); the 70b's first decode step profiled
    # against its bytes bound. (b) the ServeEngine with the 7b as its draft
    # (4 slots, M 1024, 2 greedy requests of 64-256 ids (4 before phase 31,
    # the run's time budget), 16 new): launches
    # exact (each step k + 1 draft steps at 4 rows with K7, then a 20-row
    # verify on K1's and K2's tensor-core paths), answers held to TOKEN_TOL,
    # beside the non-speculative engine (held too). (c) a perfect draft
    # (target = draft = the 7b cut to 2 layers), lockstep and engine: the
    # acceptance rate, reported, not gated (a near-tie between the 1-row and
    # 20-row kernels may flip a vote).
    from pt2tpu_torch.serve.speculative import speculative_generate

    rec29 = {}
    K29, NEW29 = 4, 16
    g29 = torch.Generator(device=dev).manual_seed(29)
    gh29 = torch.Generator().manual_seed(29)
    cfg70, p70, rec29["build_70b_s"] = build("llama-2-70b", "down", 70, n_layers=40)
    cfg7, p7, rec29["build_7b_s"] = build("llama-2-7b", "down", 7)
    L70, L7 = cfg70.n_layers, cfg7.n_layers

    def tree_bytes(t, skip=()):
        """The bytes of every tensor in a parameter tree, less the dict keys
        and dataclass fields named in ``skip``."""
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        if isinstance(t, dict):
            return sum(tree_bytes(v_, skip) for k_, v_ in t.items() if k_ not in skip)
        if isinstance(t, (list, tuple)):
            return sum(tree_bytes(v_, skip) for v_ in t)
        if dataclasses.is_dataclass(t):
            return sum(tree_bytes(getattr(t, f_.name), skip) for f_ in dataclasses.fields(t)
                       if f_.name not in skip)
        return 0

    rec29["weights_gb"] = {name_: tree_bytes(p_) / 1e9
                           for name_, p_ in (("llama-2-70b", p70), ("llama-2-7b", p7))}
    print(f"29 llama-2-70b ({L70} layers) built in {rec29['build_70b_s']:.1f} s, llama-2-7b "
          f"({L7}) in {rec29['build_7b_s']:.1f} s; weights {rec29['weights_gb']} GB")

    def spec_launches(Lt, Ld, t_passes, d_passes, rounds_rows, d_k7_steps=0, t_k2=True):
        """Launches of a speculative run: the target's passes (its admissions
        or prefill) and the draft's, then per round k + 1 draft forwards of
        ``rows`` rows (K7 in each where ``d_k7_steps``) and one target verify
        of rows x (k + 1) rows."""
        c = llama_launches(Lt, t_passes, 0, t_k2)
        for k_, v_ in llama_launches(Ld, d_passes, 0, False).items():
            c[k_] += v_
        for rows in rounds_rows:
            for k_, v_ in llama_launches(Ld, [rows] * (K29 + 1), 0, False).items():
                c[k_] += v_
            for k_, v_ in llama_launches(Lt, [rows * (K29 + 1)], 0, t_k2).items():
                c[k_] += v_
        c["decode_attention"] = c["decode_attention_tc"] = Ld * d_k7_steps
        return c

    # (a) lockstep
    prompt29 = torch.randint(0, cfg70.vocab_size, (1, 128), generator=g29, device=dev)
    with torch.inference_mode():
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks29, stats29 = speculative_generate(cfg70, p70, cfg7, p7, prompt29, NEW29, k=K29)
        torch.cuda.synchronize()
        wall_spec = time.perf_counter() - t0
        got = counts()
        want = spec_launches(L70, L7, [128], [128], [1] * stats29.rounds)
        if got != want:
            fail(f"29a speculative_generate: launches {got}, want {want}")
        tally(got)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy29 = greedy_generate(cfg70, p70, prompt29, NEW29)
        torch.cuda.synchronize()
        wall_greedy = time.perf_counter() - t0
        got_g = counts()
        want_g = llama_launches(L70, [128] + [1] * (NEW29 - 1), 0, True)
        if got_g != want_g:
            fail(f"29a greedy_generate: launches {got_g}, want {want_g}")
        tally(got_g)
    worst_spec = family_answers_held("29a llama-2-70b speculative answers", cfg70, p70,
                                     prompt29.tolist(), toks29.tolist(), False, TOKEN_TOL)
    worst_greedy = family_answers_held("29a llama-2-70b greedy answers", cfg70, p70,
                                       prompt29.tolist(), greedy29.tolist(), False, TOKEN_TOL)
    same = int((toks29 == greedy29).all(dim=1).sum())
    rec29["lockstep"] = {"stats": vars(stats29), "acceptance": stats29.acceptance_rate,
                         "wall_s": wall_spec, "tok_s": NEW29 / wall_spec,
                         "greedy_wall_s": wall_greedy, "greedy_tok_s": NEW29 / wall_greedy,
                         "launches": got, "worst_pick_gap": worst_spec,
                         "greedy_worst_pick_gap": worst_greedy, "equal_to_greedy": same,
                         "round_launches": spec_launches(L70, L7, [], [], [1])}
    print(f"29a speculative_generate llama-2-70b <- llama-2-7b (k {K29}), 128 ids + {NEW29} new: "
          f"{stats29} in {wall_spec:.2f} s ({NEW29 / wall_spec:.2f} tok/s) against greedy "
          f"{wall_greedy:.2f} s ({NEW29 / wall_greedy:.2f} tok/s); launches exact {got} (a round: "
          f"{rec29['lockstep']['round_launches']}); picks within {worst_spec:.2e} (greedy "
          f"{worst_greedy:.2e}) of the teacher-forced plain max (<= {TOKEN_TOL}); tokens equal to "
          f"greedy_generate's: {bool(same)} on {record['smi']}")
    # a decode step reads every layer's codes, scales and norms and the
    # lm_head (one embedding row; the "down" layout reads no perm)
    bytes70 = tree_bytes(p70, skip=("embed", "perm"))
    rec29["step_70b"] = dict(profile_decode_step(cfg70, p70, prompt29, 128, 4, dev,
                                                 "llama-2-70b down"),
                             bound_ms=bytes70 / bw * 1e3, bound_bytes=bytes70)
    print(f"29a llama-2-70b decode step (B 1): device "
          f"{rec29['step_70b']['device_ms']:.2f} ms, wall {rec29['step_70b']['wall_ms']:.2f} ms, "
          f"against its bytes bound {rec29['step_70b']['bound_ms']:.2f} ms ({bytes70 / 1e9:.2f} GB "
          f"of weights read) on {record['smi']}")

    stamp("29b")
    # (b) the engines, 4 slots, M 1024
    lens29 = torch.randint(64, 257, (2,), generator=gh29).tolist()
    prompts29 = make_prompts(cfg70, lens29, g29)
    M29 = 1024

    def engine29(label, cfg_t, p_t, draft, want_fn):
        eng = ServeEngine(cfg_t, p_t, max_batch=4, max_len=M29, draft=draft, spec_k=K29)
        reqs = [eng.submit(p_, 16) for p_ in prompts29]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            eng.run()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        got_ = counts()
        want_ = want_fn(eng)
        if got_ != want_:
            fail(f"29 {label}: launches {got_}, want {want_}")
        tally(got_)
        if not all(r.done and len(r.out) == 16 for r in reqs):
            fail(f"29 {label}: a request did not finish with max_new tokens")
        stt = dict(eng.stats)
        n_tok = sum(len(r.out) for r in reqs)
        res = {"wall_s": wall_, "tok_s": n_tok / wall_, "steps": stt["steps"],
               "decode_tok_s": stt["tokens"] / stt["t_decode_s"], "t_admit_s": stt["t_admit_s"],
               "t_decode_s": stt["t_decode_s"], "launches": got_,
               "stats_spec": getattr(eng, "stats_spec", None)}
        return res, [r.out for r in reqs]

    buckets29 = [min(_bucket(n_), M29) for n_ in lens29]
    res_plain, out_plain = engine29(
        "llama-2-70b engine", cfg70, p70, None,
        lambda e: llama_launches(L70, buckets29 + [4] * e.stats["steps"], e.stats["steps"], True))
    res_spec, out_spec = engine29(
        "llama-2-70b engine under a llama-2-7b draft", cfg70, p70, (cfg7, p7),
        lambda e: spec_launches(L70, L7, buckets29, buckets29, [4] * e.stats["steps"],
                                (K29 + 1) * e.stats["steps"]))
    for label_, out_, res_ in (("speculative", out_spec, res_spec),
                               ("plain", out_plain, res_plain)):
        res_["worst_pick_gap"] = family_answers_held(
            f"29b llama-2-70b {label_} engine answers", cfg70, p70, prompts29, out_, False,
            TOKEN_TOL)
    rec29["engine"] = {"speculative": res_spec, "plain": res_plain,
                       "streams_equal": sum(a == b for a, b in zip(out_spec, out_plain))}
    sp = res_spec["stats_spec"]
    print(f"29b llama-2-70b engine (4 slots, M {M29}, prompts {lens29}, 16 new): speculative "
          f"{res_spec['steps']} steps in {res_spec['wall_s']:.2f} s ({res_spec['tok_s']:.2f} "
          f"tok/s; drafted {sp['drafted']}, accepted {sp['accepted']}), plain "
          f"{res_plain['steps']} steps in {res_plain['wall_s']:.2f} s ({res_plain['tok_s']:.2f} "
          f"tok/s); launches exact; picks within {res_spec['worst_pick_gap']:.2e} / "
          f"{res_plain['worst_pick_gap']:.2e} (<= {TOKEN_TOL}); streams equal "
          f"{rec29['engine']['streams_equal']} of 4 on {record['smi']}")
    del p70
    torch.cuda.empty_cache()

    stamp("29c")
    # (c) a perfect draft: the 7b cut to 2 layers as target and draft
    cfg2 = cfg7.with_(n_layers=2)
    with torch.inference_mode():
        _, st_perfect = speculative_generate(cfg2, p7, cfg2, p7, prompt29, NEW29, k=K29)
    res_perfect, _ = engine29(
        "2-layer llama-2-7b engine, its own draft", cfg2, p7, (cfg2, p7),
        lambda e: spec_launches(2, 2, buckets29, buckets29, [4] * e.stats["steps"],
                                (K29 + 1) * e.stats["steps"], t_k2=False))
    sp = res_perfect["stats_spec"]
    rec29["perfect"] = {"lockstep": vars(st_perfect),
                        "lockstep_acceptance": st_perfect.acceptance_rate,
                        "engine": res_perfect, "engine_acceptance": sp["accepted"] / sp["drafted"]}
    print(f"29c a perfect draft (2-layer llama-2-7b as its own draft): lockstep {st_perfect}, "
          f"engine accepted {sp['accepted']} of {sp['drafted']} drafted "
          f"({rec29['perfect']['engine_acceptance']:.3f}); not gated")
    del p7
    torch.cuda.empty_cache()
    record["speculative"] = rec29

    record["paths_s"] = time.perf_counter() - t_start

    stamp("30")
    # ---- 30. K7's wide instance (hd > 512, the width at run time: 16-position
    # tiles, one CTA an SM, each warp streaming its own 128-lane chunks of K
    # and V). (a) both kernels at hd 640 / 768 / 1024, B 1 and 8, M 2048,
    # bf16 and int8 KV, ragged lengths, 8 / 2 KV heads: the tensor-core
    # kernel held to the plain version, to one bf16 step of its split plain
    # version on its plan and to its own bits run to run, the CUDA-core
    # kernel to the plain version; (b) 2-layer llama-3-8b-width models with
    # head_dim 640 and 1024, cut to 8 / 2 heads ("down" layout), in the
    # ServeEngine (8 slots, M 2048, 8 requests of 64-512 ids, 16 new): hd 640
    # bf16 KV, hd 1024 int8 KV, hd 1024 bf16 with K7_TC off; K7 launched
    # layers x steps times, all on the wide instance, every call held against
    # its plain version, every answer held to TOKEN_TOL under its
    # teacher-forced plain reference. Timed in phase 6. Its own generator.
    rec30 = {}
    g30 = torch.Generator(device=dev).manual_seed(30)
    errs["decode_attention_wide_rt"] = errs["decode_attention_cc_wide_rt"] = 0.0
    errs["decode_attention_wide_rt_split"] = 0.0
    nchecks["decode_attention_wide_rt"] = nchecks["decode_attention_cc_wide_rt"] = 0
    for hd in WIDE_RT_HEAD_DIMS:
        for B in (1, 8):
            for quant in (False, True):
                a = attn_inputs(B, ENGINE_M, 8, 2, quant, hd=hd, gen=g30)
                label = f"30a K7 hd={hd} B={B} M={ENGINE_M} int8={quant}"
                plain = k7.decode_attention_plain(*a[:4], hd ** -0.5, *a[4:])
                d7 = k7.decode_attention
                c0 = (d7.launches, d7.launches_tc, d7.launches_wide_rt)
                got = k7.decode_attention(*a[:4], hd ** -0.5, *a[4:])
                again = k7.decode_attention(*a[:4], hd ** -0.5, *a[4:])
                k7.K7_TC = False
                got_cc = k7.decode_attention(*a[:4], hd ** -0.5, *a[4:])
                k7.K7_TC = True
                rose = (d7.launches - c0[0], d7.launches_tc - c0[1], d7.launches_wide_rt - c0[2])
                if rose != (3, 2, 3):
                    fail(f"{label}: launches (all, tensor-core, wide) rose by {rose}, not (3, 2, 3)")
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"{label}: two runs differ")
                held("decode_attention_wide_rt", label, got, plain, ATTN_TOL)
                held("decode_attention_cc_wide_rt", f"{label} (CUDA-core kernel)", got_cc, plain,
                     ATTN_TOL)
                plan = k7.k7_plan(B, ENGINE_M, 2, 4, hd, quant)
                want = k7.decode_attention_split_plain(*a[:4], hd ** -0.5, *a[4:], tile=plan.tile,
                                                       splits=plan.splits).float()
                step = torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                over = ((got.float() - want).abs() - step).max().item() / want.abs().max().item()
                if not over <= K7_SPLIT_TOL:
                    fail(f"{label}: {over:.3e} of max|ref| past one bf16 step of the split plain "
                         "version")
                errs["decode_attention_wide_rt_split"] = max(
                    errs["decode_attention_wide_rt_split"], over)
                del a, plain
    rec30["per_call"] = {k_: {"checks": nchecks[k_], "max_abs_err": errs[k_]}
                         for k_ in ("decode_attention_wide_rt", "decode_attention_cc_wide_rt")}
    rec30["occupancy"] = {hd_: k7.wide_max_active_clusters(ENGINE_M, hd_, False, 8)
                          for hd_ in WIDE_RT_HEAD_DIMS}
    print(f"30a K7's wide instance at hd {WIDE_RT_HEAD_DIMS}, B 1 / 8, M {ENGINE_M}, bf16 and "
          f"int8: tensor-core kernel {nchecks['decode_attention_wide_rt']} checks (max|err| "
          f"{errs['decode_attention_wide_rt']:.3e}, past one bf16 step of its split plain version "
          f"by at most {errs['decode_attention_wide_rt_split']:.3e} of max|ref|), the CUDA-core "
          f"kernel {nchecks['decode_attention_cc_wide_rt']} (max|err| "
          f"{errs['decode_attention_cc_wide_rt']:.3e}), each within {ATTN_TOL} x max|ref| of the "
          f"plain version; 8-CTA clusters resident at once {rec30['occupancy']}")

    wide_rt_launches = {"decode_attention_wide_rt_hd640": 0, "decode_attention_wide_rt_hd1024": 0,
                        "decode_attention_cc_wide_rt_hd1024": 0}
    rec30["engines"] = {}
    for hd, kvq, tc in ((640, False, True), (1024, True, True), (1024, False, False)):
        cfg_w = get_config("llama-3-8b").with_(n_layers=2, head_dim=hd, n_heads=8, n_kv_heads=2)
        if cfg_w.hd != hd:
            fail(f"30b a head_dim {hd} config has hd {cfg_w.hd}")
        params_w = random_ternary_params(cfg_w, seed=hd + 30, perm_mode="down", device=dev)
        prompts_w = make_prompts(cfg_w, torch.randint(64, 513, (8,), generator=g30,
                                                      device=dev).tolist(), g30)
        k7.K7_TC = tc
        eng = ServeEngine(cfg_w, params_w, max_batch=8, max_len=ENGINE_M, kv_quant=kvq)
        reqs = [eng.submit(p_, 16) for p_ in prompts_w]
        for k_ in per_call:
            per_call[k_] = 0
        with swapped(each_call_checked, ("decode_attention",)):
            zero_counts()
            k7.decode_attention.launches_wide_rt = 0
            eng.run()
            torch.cuda.synchronize()
            got = counts()
            wide_rt = k7.decode_attention.launches_wide_rt
        k7.K7_TC = True
        st_ = eng.stats["steps"]
        L_ = cfg_w.n_layers
        want = {"decode_attention": L_ * st_, "decode_attention_wide_rt": L_ * st_,
                "decode_attention_tc": L_ * st_ if tc else 0, "held": L_ * st_}
        have = {"decode_attention": got["decode_attention"], "decode_attention_wide_rt": wide_rt,
                "decode_attention_tc": got["decode_attention_tc"],
                "held": per_call["decode_attention"]}
        if have != want:
            fail(f"30b 2-layer hd {hd} engine (int8 KV={kvq}, K7_TC={tc}): {have}, want {want}")
        tally(got)
        if not all(r.done and len(r.out) == 16 for r in reqs):
            fail(f"30b 2-layer hd {hd} engine: a request did not finish")
        worst = family_answers_held(f"30b 2-layer hd {hd} engine answers", cfg_w, params_w,
                                    prompts_w, [r.out for r in reqs], kvq, TOKEN_TOL)
        wide_rt_launches[f"decode_attention{'' if tc else '_cc'}_wide_rt_hd{hd}"] += wide_rt
        tag = f"hd {hd} {'int8' if kvq else 'bf16'} KV{'' if tc else ', K7_TC off'}"
        rec30["engines"][tag] = {"steps": st_, "launches": got, "wide_rt": wide_rt,
                                 "worst_pick_gap": worst}
        print(f"30b 2-layer llama-3-8b width, head_dim {hd}, 8 / 2 heads, ServeEngine ({tag}): "
              f"{st_} decode steps, K7 launched {wide_rt} = {L_} layers x {st_} steps on the wide "
              f"instance, every call held against its plain version; every pick within "
              f"{worst:.2e} of the teacher-forced plain max (<= {TOKEN_TOL})")
        del eng, params_w
        torch.cuda.empty_cache()
    rec30["launches"] = wide_rt_launches
    record["k7_wide_rt"] = rec30

    stamp("31")
    record["tp"] = tp_phase(dev, get_config, random_ternary_params, family_answers_held)

    stamp("6")
    # ---- 6. timings (cold weights: rotate > L2), CUDA events over back-to-back
    # launches of the C entry points (no Python wrapper in the loop)
    import torch.nn.functional as F

    lib = k1._kernel_lib()
    tc_lib = k1._tc_kernel_lib()
    tc_a8_lib = k1._tc_a8_kernel_lib()
    dec_lib = k1._dec_kernel_lib()
    dec_counters = torch.zeros(1024, dtype=torch.int32, device=dev)
    mlp_lib = k1._mlp_kernel_lib()
    gather_lib = k4._kernel_lib()
    mm_lib = k4._mm_kernel_lib()
    gathered_lib = k1._gathered_kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    dix = dev.index or 0
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def time_ms(fn, iters):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        s, e = ev(), ev()
        s.record()
        for i in range(iters):
            fn(i)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def ok(rc, what):
        if rc:
            fail(f"{what} launch failed in timing: {rc}")

    def bound(nbytes, ops, peak):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / peak * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def row(kernel, name, B, ms, plain_ms, lib_ms, nbytes, ops, peak=bf16_peak, **shape):
        """One timing; its bound counts ops at ``peak`` (bf16 unless given)."""
        b_ms, b_by = bound(nbytes, ops, peak)
        d = {"kernel": kernel, "shape": name, "B": B, **shape, "ms": ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
             "GBps": nbytes / ms / 1e6}
        print(f"{kernel} {name:7s} B={B:3d} {shape}: {ms * 1e3:8.1f} us | plain {plain_ms * 1e3:9.1f} us"
              f" | library {lib_ms * 1e3:7.1f} us | bound {b_ms * 1e3:6.2f} us ({b_by}) | "
              f"{d['GBps']:.0f} GB/s | {100 * b_ms / ms:.1f} % of bound")
        return d

    def dense(K, n, gen=None):
        copies = max(1, math.ceil(COLD_BYTES / (2 * K * n)))
        return [torch.randn((K, n), generator=gen or g, device=dev).bfloat16()
                for _ in range(copies)]

    # K1's kernels through their C entries at decode and prefill rows: "K1"
    # the CUDA cores, "K1tc" the tensor cores (its row sums included); in
    # W2A8 (10d) "K1a8" the CUDA cores and "K1tca8" the int8 tensor cores
    # (its prepass included), both on the normalised rows xn, beside the
    # int8 operations bound and torch._int_mm of int8 xq by the dense int8
    # codes (it takes > 16 rows in multiples of 8: below that, 24 rows);
    # at decode rows (11d) "K1dec" and, in W2A8, "K1deca8" the decode
    # kernel (its slice sum included)
    detail, tc_detail, a8_detail, tc_a8_detail = [], [], [], []
    dec_detail, dec_a8_detail = [], []
    for name, K, n in SHAPES:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(K, n) for _ in range(copies)]
        dn = dense(K, n)
        # the dense int8 codes as the (K, n) view of an (n, K) matrix (the
        # layout cuBLASLt's int8 product takes), or (K, n) rows if refused
        dn8 = [torch.randint(-1, 2, (n, K), generator=g, device=dev, dtype=torch.int8).t()
               for _ in range(max(1, math.ceil(COLD_BYTES / (K * n))))]
        try:
            torch._int_mm(torch.zeros((24, K), dtype=torch.int8, device=dev), dn8[0])
        except RuntimeError:
            dn8 = [w.contiguous() for w in dn8]
        for B in K1_ROWS:
            x = torch.randn((B, K), generator=g, device=dev).bfloat16()
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            sums = torch.empty((K // 128, -(-B // 128) * 128), dtype=torch.float32, device=dev)

            def kern(i):
                p, a, m = layers[i % copies]
                ok(lib.pt2_ternary_matmul(x.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(),
                                          out.data_ptr(), B, K, n, 128, 0, dix, stream), "K1")

            def kern_tc(i):
                p, a, m = layers[i % copies]
                ok(tc_lib.pt2_ternary_matmul_tc(
                    x.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(), sums.data_ptr(),
                    out.data_ptr(), B, sums.shape[1], K, n, 128, dix, stream), "K1 tc")

            iters = 50 if B <= 16 else 20
            ms = time_ms(kern, iters)
            tc_ms = time_ms(kern_tc, iters)
            plain_ms = time_ms(lambda i: k1.ternary_matmul_plain(x, *layers[i % copies]), 3)
            lib_ms = time_ms(lambda i: torch.matmul(x, dn[i % len(dn)]), iters)
            nbytes = K * n / 4 + 4 * (K // 128) * n + 2 * B * K + 4 * B * n
            detail.append(row("K1", name, B, ms, plain_ms, lib_ms, nbytes, 2.0 * B * K * n,
                              K=K, n=n))
            tc_detail.append(row("K1tc", name, B, tc_ms, plain_ms, lib_ms, nbytes,
                                 2.0 * B * K * n, K=K, n=n))

            xn, _ = k1.normalize_rows_a8(x)
            xq = torch.empty((B, K), dtype=torch.int8, device=dev)
            isums = torch.empty((K // 128, -(-B // 128) * 128), dtype=torch.int32, device=dev)
            xq_mm = torch.randint(-127, 128, (B if B > 16 else 24, K), generator=g, device=dev,
                                  dtype=torch.int8)

            def kern_a8(i):
                p, a, m = layers[i % copies]
                ok(lib.pt2_ternary_matmul(xn.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(),
                                          out.data_ptr(), B, K, n, 128, 1, dix, stream), "K1 a8")

            def kern_tc_a8(i):
                p, a, m = layers[i % copies]
                ok(tc_a8_lib.pt2_ternary_matmul_tc_a8(
                    xn.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(), xq.data_ptr(),
                    isums.data_ptr(), out.data_ptr(), B, isums.shape[1], K, n, 128, dix, stream),
                    "K1 tc_a8")

            a8_ms = time_ms(kern_a8, iters)
            tc_a8_ms = time_ms(kern_tc_a8, iters)
            plain_a8_ms = time_ms(lambda i: k1.ternary_matmul_plain_a8(x, *layers[i % copies]), 3)
            int_mm_ms = time_ms(lambda i: torch._int_mm(xq_mm, dn8[i % len(dn8)]), iters)
            a8_detail.append(row("K1a8", name, B, a8_ms, plain_a8_ms, int_mm_ms, nbytes,
                                 2.0 * B * K * n, int8_peak, K=K, n=n))
            tc_a8_detail.append(row("K1tca8", name, B, tc_a8_ms, plain_a8_ms, int_mm_ms, nbytes,
                                    2.0 * B * K * n, int8_peak, K=K, n=n))
            if B > k1.K1_DEC_MAX_ROWS:
                continue
            splits = k1.dec_splits(K, n, 128, k1.dec_wave(dev))
            partial = torch.empty((splits, B, n), dtype=torch.float32, device=dev)

            def kern_dec(i, xk=x, a8=0):
                p, a, m = layers[i % copies]
                ok(dec_lib.pt2_ternary_matmul_dec(
                    xk.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), dec_counters.data_ptr(), B, K, n, 128, splits, a8, dix,
                    stream), "K1 dec")

            dec_ms = time_ms(kern_dec, iters)
            dec_a8_ms = time_ms(lambda i: kern_dec(i, xn, 1), iters)
            dec_detail.append(row("K1dec", name, B, dec_ms, plain_ms, lib_ms, nbytes,
                                  2.0 * B * K * n, K=K, n=n, splits=splits))
            dec_a8_detail.append(row("K1deca8", name, B, dec_a8_ms, plain_a8_ms, int_mm_ms,
                                     nbytes, 2.0 * B * K * n, int8_peak, K=K, n=n, splits=splits))
        del layers, dn, dn8
    record["k1_timing"] = detail
    record["k1_tc_timing"] = tc_detail
    record["k1_a8_timing"] = a8_detail
    record["k1_tc_a8_timing"] = tc_a8_detail
    record["k1_dec_timing"] = dec_detail
    record["k1_dec_a8_timing"] = dec_a8_detail
    if dec_counters.any():
        fail("the decode kernel left a column tile's counter set")
    per_layer = {}
    for B in K1_ROWS:
        at_b = lambda rows: [d for d in rows if d["B"] == B]  # noqa: E731
        per_layer[B] = {k: sum(d[k] for d in at_b(detail))
                        for k in ("ms", "library_ms", "bound_ms")}
        v = per_layer[B]
        v["tc_ms"] = sum(d["ms"] for d in at_b(tc_detail))
        v["a8_ms"] = sum(d["ms"] for d in at_b(a8_detail))
        v["tc_a8_ms"] = sum(d["ms"] for d in at_b(tc_a8_detail))
        v["int_mm_ms"] = sum(d["library_ms"] for d in at_b(tc_a8_detail))
        v["a8_bound_ms"] = sum(d["bound_ms"] for d in at_b(tc_a8_detail))
        dec_b = at_b(dec_detail)
        if dec_b:
            v["dec_ms"] = sum(d["ms"] for d in dec_b)
            v["dec_a8_ms"] = sum(d["ms"] for d in at_b(dec_a8_detail))
        dec_s = f"decode kernel {v['dec_ms'] * 1e3:8.1f} us | " if dec_b else ""
        dec_a8_s = f"decode kernel {v['dec_a8_ms'] * 1e3:8.1f} us | " if dec_b else ""
        print(f"K1, one llama-2-7b layer (4 projections) at {B:3d} rows: {dec_s}tensor cores "
              f"{v['tc_ms'] * 1e3:8.1f} us | CUDA cores {v['ms'] * 1e3:9.1f} us | torch.matmul "
              f"{v['library_ms'] * 1e3:7.1f} us | bound {v['bound_ms'] * 1e3:7.1f} us")
        print(f"K1 W2A8, one llama-2-7b layer at {B:3d} rows: {dec_a8_s}int8 tensor cores "
              f"{v['tc_a8_ms'] * 1e3:8.1f} us | CUDA cores {v['a8_ms'] * 1e3:9.1f} us | "
              f"torch._int_mm{' (24 rows)' if B <= 16 else ''} {v['int_mm_ms'] * 1e3:7.1f} us | "
              f"int8 bound {v['a8_bound_ms'] * 1e3:7.1f} us")
        if dec_b and not (v["dec_ms"] < min(v["ms"], v["library_ms"])):
            print(f"  note: at {B} rows the decode kernel is not below both the CUDA-core "
                  f"kernel and torch.matmul")
    # the W2A8 wrapper's own work around K1 at 512 x 4096 (o's input): the
    # rows' normalisation before the kernel, their scales after it
    x = torch.randn((512, 4096), generator=g, device=dev).bfloat16()
    xn, sx = k1.normalize_rows_a8(x)
    o = torch.empty((512, 4096), dtype=torch.float32, device=dev)
    record["a8_wrapper_ms"] = {"normalize_rows_a8": time_ms(lambda i: k1.normalize_rows_a8(x), 50),
                               "out_times_sx": time_ms(lambda i: o * sx, 50)}
    print(f"W2A8 wrapper at 512 x 4096: normalize_rows_a8 "
          f"{record['a8_wrapper_ms']['normalize_rows_a8'] * 1e3:.1f} us, out * sx "
          f"{record['a8_wrapper_ms']['out_times_sx'] * 1e3:.1f} us per call")
    del x, xn, sx, o
    # the fewest rows from which the tensor cores win at every timed row count
    wins = [B for B in K1_ROWS if all(per_layer[b]["tc_ms"] < per_layer[b]["ms"]
                                      for b in K1_ROWS if b >= B)]
    record["k1_per_layer"] = per_layer
    record["k1_tc_from_rows"] = min(wins) if wins else None
    print(f"K1: the tensor cores win from {record['k1_tc_from_rows']} rows on (timed rows "
          f"{K1_ROWS}); K1_TC_MIN_ROWS = {k1.K1_TC_MIN_ROWS}")

    # K3 at llama-3-8b qkv / o; library: one dense bf16 matmul on pre-gathered
    # x. "K3" the CUDA-core kernel (rows 9-64 and W2A8 decode rows on the main
    # paths) at rows 1-64; "K3dec" (13d) its decode path (the decode kernel
    # with x staged through perm, its slice sum included) at 1/2/4/8 rows,
    # timed before and after the CUDA-core K3 (the least of the two kept).
    # The rows besides 1 and 16 draw from gk3, so that the later phases draw
    # what they drew before
    k3_detail, k3dec_detail = [], []
    for name, m, K, n in SHAPES_8B:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(K, n) + (rand_perm(m, K),) for _ in range(copies)]
        dn = dense(K, n)
        splits = k1.dec_splits(K, n, 128, k1.dec_wave(dev))
        for B in (1, 2, 4, 8, 16, 64):
            x = (torch.randn((B, m), generator=g if B in (1, 16) else gk3, device=dev)
                 .bfloat16())
            out = torch.empty((B, n), dtype=torch.float32, device=dev)

            def kern(i):
                p, a, mu_, pm = layers[i % copies]
                ok(lib.pt2_ternary_matmul_igathered(
                    x.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                    out.data_ptr(), B, m, K, n, 128, 0, dix, stream), "K3")

            partial = torch.empty((splits, B, n), dtype=torch.float32, device=dev)

            def kern_dec(i):
                p, a, mu_, pm = layers[i % copies]
                ok(dec_lib.pt2_ternary_matmul_dec_igathered(
                    x.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), dec_counters.data_ptr(), B, m, K, n, 128,
                    splits, 0, dix, stream), "K3 dec")

            dec = B <= k1.K1_DEC_MAX_ROWS  # the decode path in turns: dec, K3, dec
            dec_ms = [time_ms(kern_dec, 50)] if dec else []
            ms = time_ms(kern, 50)
            dec_ms += [time_ms(kern_dec, 50)] if dec else []
            plain_ms = time_ms(lambda i: k1.ternary_matmul_igathered_plain(
                x, layers[i % copies][3], *layers[i % copies][:3]), 5)
            xg = k4.onehot_gather_plain(x, layers[0][3])
            lib_ms = time_ms(lambda i: torch.matmul(xg, dn[i % len(dn)]), 50)
            nbytes = K * n / 4 + 4 * (K // 128) * n + 2 * B * m + 4 * K + 4 * B * n
            k3_detail.append(row("K3", name, B, ms, plain_ms, lib_ms, nbytes, 2.0 * B * K * n,
                                 m=m, K=K, n=n))
            if dec:
                d = row("K3dec", name, B, min(dec_ms), plain_ms, lib_ms, nbytes, 2.0 * B * K * n,
                        m=m, K=K, n=n, splits=splits)
                d["turns_ms"] = dec_ms
                k3dec_detail.append(d)
        del layers, dn
    if dec_counters.any():
        fail("K3's decode path left a column tile's counter set")
    record["k3_timing"] = k3_detail
    record["k3_dec_timing"] = k3dec_detail
    for B in (1, 2, 4, 8, 16, 64):
        at_b = lambda rows: [d for d in rows if d["B"] == B]  # noqa: E731
        tot = lambda rows, key="ms": sum(d[key] for d in at_b(rows)) * 1e3  # noqa: E731
        dec_s = f"decode path {tot(k3dec_detail):7.1f} us | " if at_b(k3dec_detail) else ""
        print(f"K3, llama-3-8b qkv + o at {B:2d} rows: {dec_s}CUDA-core K3 {tot(k3_detail):7.1f} "
              f"us | plain {tot(k3_detail, 'plain_ms'):8.1f} us | torch.matmul on gathered x "
              f"{tot(k3_detail, 'library_ms'):6.1f} us | bound {tot(k3_detail, 'bound_ms'):5.2f} "
              f"us on {record['smi']}")

    # 14c. K3's tensor-core path through its C entry (the gather, then the
    # split-K product, scratch allocated outside the loop) at llama-3-8b qkv
    # and o, 16 / 32 / 64 rows, bf16 and W2A8; its gather alone; beside it
    # the CUDA-core K3 (the "off" turns' route), dense torch.matmul on the
    # gathered x (library), K4 then K1's tensor-core kernel (bf16: the
    # composition a route without K3 would take), the plain version and the
    # bytes bound, in turns tc, CUDA cores, K4 + K1, tc; then the path's two
    # kernels' device time under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    igtc_counters = torch.zeros(1024, dtype=torch.int32, device=dev)
    k3tc_detail = []
    for name, m, K, n in SHAPES_8B:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(K, n, gen=gk14) + (rand_perm(m, K, gen=gk14),)
                  for _ in range(copies)]
        dn = dense(K, n, gk14)
        splits = k1.igtc_splits(K, n, 128, k1.igtc_wave(dev))
        for B in (16, 32, 64):
            Bp = k1.igtc_rows_pad(B)
            x = torch.randn((B, m), generator=gk14, device=dev).bfloat16()
            xg = torch.empty((Bp, K), dtype=torch.bfloat16, device=dev)
            S = torch.empty((K // 128, Bp), dtype=torch.float32, device=dev)
            partial = torch.empty((splits, B, n), dtype=torch.float32, device=dev)
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            xk4 = torch.empty((B, K), dtype=torch.bfloat16, device=dev)
            sums = torch.empty((K // 128, 128), dtype=torch.float32, device=dev)
            for a8 in (False, True):
                xk = k1.normalize_rows_a8(x)[0].contiguous() if a8 else x

                def kern_tc(i):
                    p, a, mu_, pm = layers[i % copies]
                    ok(igtc_lib.pt2_ternary_matmul_igathered_tc(
                        xk.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                        xg.data_ptr(), S.data_ptr(), partial.data_ptr(), out.data_ptr(),
                        igtc_counters.data_ptr(), B, m, K, n, 128, splits, int(a8), dix, stream),
                       "K3 tc")

                def kern_gather(i):
                    ok(igtc_lib.pt2_ternary_matmul_igathered_tc_gather(
                        xk.data_ptr(), layers[i % copies][3].data_ptr(), xg.data_ptr(),
                        S.data_ptr(), B, Bp, m, K, 128, int(a8), dix, stream), "K3 tc gather")

                def kern_cc(i):
                    p, a, mu_, pm = layers[i % copies]
                    ok(lib.pt2_ternary_matmul_igathered(
                        xk.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                        out.data_ptr(), B, m, K, n, 128, int(a8), dix, stream), "K3")

                def kern_k4_k1(i):
                    p, a, mu_, pm = layers[i % copies]
                    ok(gather_lib.pt2_onehot_gather(x.data_ptr(), pm.data_ptr(), xk4.data_ptr(),
                                                    B, m, K, 2, dix, stream), "K4")
                    ok(tc_lib.pt2_ternary_matmul_tc(
                        xk4.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                        sums.data_ptr(), out.data_ptr(), B, sums.shape[1], K, n, 128, dix,
                        stream), "K1 tc")

                turns = [time_ms(kern_tc, 50), time_ms(kern_cc, 20)]
                comp_ms = None if a8 else time_ms(kern_k4_k1, 50)
                turns.append(time_ms(kern_tc, 50))
                gather_ms = time_ms(kern_gather, 50)
                plain_ms = time_ms(lambda i: k1.ternary_matmul_igathered_plain(
                    x, layers[i % copies][3], *layers[i % copies][:3], 128, a8), 5)
                xgd = k4.onehot_gather_plain(x, layers[0][3])
                lib_ms = time_ms(lambda i: torch.matmul(xgd, dn[i % len(dn)]), 50)
                nbytes = K * n / 4 + 4 * (K // 128) * n + 2 * B * m + 4 * K + 4 * B * n
                d = row("K3tc", name, B, min(turns[0], turns[2]), plain_ms, lib_ms, nbytes,
                        2.0 * B * K * n, m=m, K=K, n=n, a8=a8, splits=splits)
                # the device's own time per launch of each of the path's
                # kernels, without the host's launch rate (20 calls under
                # torch.profiler; the mean over the launches it recorded)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for i in range(20):
                        kern_tc(i)
                    torch.cuda.synchronize()
                krows = kernel_rows(prof)

                def per_launch(key):
                    hit = [r for r in krows if key in r[2]]
                    return sum(r[0] for r in hit) / max(1, sum(r[1] for r in hit))

                d.update(turns_ms=[turns[0], turns[2]], gather_ms=gather_ms, cuda_core_ms=turns[1],
                         k4_k1_tc_ms=comp_ms, gather_device_ms=per_launch("gather_rows"),
                         product_device_ms=per_launch("igathered_tc"))
                k3tc_detail.append(d)
        del layers, dn
    if igtc_counters.any():
        fail("K3's tensor-core path left a column tile's counter set")
    record["k3_tc_timing"] = k3tc_detail
    for a8 in (False, True):
        for B in (16, 32, 64):
            at = [d for d in k3tc_detail if d["B"] == B and d["a8"] == a8]
            tot = lambda key: sum(d[key] for d in at) * 1e3  # noqa: E731
            comp = "" if a8 else f"K4 + K1 tc {tot('k4_k1_tc_ms'):6.1f} us | "
            print(f"K3 tensor-core path, llama-3-8b qkv + o at {B:2d} rows, "
                  f"{'W2A8' if a8 else 'bf16'}: {tot('ms'):6.1f} us (its gather alone "
                  f"{tot('gather_ms'):5.1f} us; device time by the profiler: gather "
                  f"{tot('gather_device_ms'):5.1f} us + product {tot('product_device_ms'):5.1f} "
                  f"us) | CUDA-core K3 {tot('cuda_core_ms'):7.1f} us | "
                  f"{comp}torch.matmul on gathered x {tot('library_ms'):5.1f} us | plain "
                  f"{tot('plain_ms'):8.1f} us | bound {tot('bound_ms'):5.2f} us on {record['smi']}")

    # K2 at llama-3-8b (gather over 4096 lanes); library: the two dense bf16
    # matmuls x @ W_gateup and mid @ W_down (a yardstick: no single call exists)
    D, I, n = MLP_8B
    Kd = -(-(I // 128) // 16) * 16 * 128
    wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + Kd * n // 4 + 4 * (Kd // 128) * n
    copies = max(1, math.ceil(COLD_BYTES / wbytes))
    layers = [rand_layer(D, 2 * I) + rand_layer(Kd, n) + (rand_perm(D, D),) for _ in range(copies)]
    w_gu = torch.randn((D, 2 * I), generator=g, device=dev).bfloat16()
    w_dn = torch.randn((I, n), generator=g, device=dev).bfloat16()
    k2_detail = []
    for B in (1, 16):
        x = torch.randn((B, D), generator=g, device=dev).bfloat16()
        mid = torch.randn((B, I), generator=g, device=dev).bfloat16()
        partial = torch.empty((I // 128, B, n), dtype=torch.float32, device=dev)
        out = torch.empty((B, n), dtype=torch.float32, device=dev)

        def kern(i):
            gp, ga, gm, dp, da, dm, pm = layers[i % copies]
            ok(mlp_lib.pt2_ternary_mlp(
                x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                dp.data_ptr(), da.data_ptr(), dm.data_ptr(), partial.data_ptr(), out.data_ptr(),
                B, D, D, 2 * I, I, Kd, n, 0, dix, stream), "K2")

        ms = time_ms(kern, 50)
        plain_ms = time_ms(lambda i: k1.ternary_mlp_plain(
            x, layers[i % copies][6], *layers[i % copies][:6], I), 3)
        lib_ms = time_ms(lambda i: (torch.matmul(x, w_gu), torch.matmul(mid, w_dn)), 20)
        nbytes = (D * 2 * I / 4 + 4 * (D // 128) * 2 * I + I * n / 4 + 4 * (I // 128) * n
                  + 2 * B * D + 4 * D + 4 * B * n)
        k2_detail.append(row("K2", "mlp", B, ms, plain_ms, lib_ms, nbytes,
                             2.0 * B * (D * 2 * I + I * n), D=D, I=I, n=n))
    del layers, w_gu, w_dn
    record["k2_timing"] = k2_detail

    # K2 at gemma-2b's MLP (2048 -> 2 x 16384 -> 2048, no gather: the
    # "down" layout), its GeGLU instance beside its silu instance on the same
    # operands, at 1 and 8 rows; library: the two dense bf16 matmuls with
    # F.gelu (tanh form) between them (a yardstick: no single call exists)
    D, I, n = MLP_GEMMA
    wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + I * n // 4 + 4 * (I // 128) * n
    copies = max(1, math.ceil(COLD_BYTES / wbytes))
    layers = [rand_layer(D, 2 * I, gen=ggem) + rand_layer(I, n, gen=ggem)
              for _ in range(copies)]
    w_gu = torch.randn((D, 2 * I), generator=ggem, device=dev).bfloat16()
    w_dn = torch.randn((I, n), generator=ggem, device=dev).bfloat16()
    k2g_detail, k2g_silu_detail = [], []
    for B in (1, 8):
        x = torch.randn((B, D), generator=ggem, device=dev).bfloat16()
        partial = torch.empty((I // 128, B, n), dtype=torch.float32, device=dev)
        out = torch.empty((B, n), dtype=torch.float32, device=dev)

        def kern(i, act=1):
            gp, ga, gm, dp, da, dm = layers[i % copies]
            ok(mlp_lib.pt2_ternary_mlp(
                x.data_ptr(), None, gp.data_ptr(), ga.data_ptr(), gm.data_ptr(), dp.data_ptr(),
                da.data_ptr(), dm.data_ptr(), partial.data_ptr(), out.data_ptr(), B, D, D, 2 * I,
                I, I, n, act, dix, stream), "K2")

        def library(i):
            gu = torch.matmul(x, w_gu)
            return torch.matmul(F.gelu(gu[:, :I], approximate="tanh") * gu[:, I:], w_dn)

        gelu_ms = [time_ms(kern, 50)]
        silu_ms = [time_ms(lambda i: kern(i, 0), 50)]
        silu_ms.append(time_ms(lambda i: kern(i, 0), 50))
        gelu_ms.append(time_ms(kern, 50))  # in turns gelu, silu, silu, gelu
        plain_ms = time_ms(lambda i: k1.ternary_mlp_plain(x, None, *layers[i % copies], I,
                                                          act="gelu"), 3)
        plain_silu_ms = time_ms(lambda i: k1.ternary_mlp_plain(x, None, *layers[i % copies], I), 3)
        lib_ms = time_ms(library, 20)
        nbytes = wbytes + 2 * B * D + 4 * B * n
        ops = 2.0 * B * (D * 2 * I + I * n)
        d = row("K2gelu", "gemma", B, min(gelu_ms), plain_ms, lib_ms, nbytes, ops, D=D, I=I, n=n)
        d["turns_ms"] = gelu_ms
        k2g_detail.append(d)
        d = row("K2silu", "gemma", B, min(silu_ms), plain_silu_ms, lib_ms, nbytes, ops, D=D, I=I,
                n=n)
        d["turns_ms"] = silu_ms
        k2g_silu_detail.append(d)
        print(f"K2 at gemma-2b's MLP, B={B}: GeGLU {' / '.join(f'{t * 1e3:.1f}' for t in gelu_ms)}"
              f" us, silu {' / '.join(f'{t * 1e3:.1f}' for t in silu_ms)} us (in turns gelu, "
              f"silu, silu, gelu) on {record['smi']}")
    del layers, w_gu, w_dn
    record["k2_gelu_timing"] = k2g_detail
    record["k2_silu_gemma_timing"] = k2g_silu_detail

    # 15c. K2's tensor-core path through its C entry (the gather, gate/up with
    # the gated epilogue, the down product; scratch allocated outside the
    # loop) at llama-3-8b's MLP ("ssr": the gather over its 4096 features,
    # silu) and gemma-2b's ("down": the identity perm, GeGLU), 16 / 32 / 64
    # rows, beside the CUDA-core K2 (the "off" turns' route), in turns tc,
    # CUDA cores, CUDA cores, tc; the two dense bf16 torch.matmul with the
    # activation between them (library: a yardstick, no single call
    # exists), the plain version and the bound; then the path's three
    # kernels' device time under torch.profiler
    mlp_tc_lib = k1._mlp_tc_kernel_lib()
    mlp_counters = torch.zeros(1024, dtype=torch.int32, device=dev)
    k2tc_detail = []
    for label, (D, I, n), act in (("llama-3-8b", MLP_8B, 0), ("gemma-2b", MLP_GEMMA, 1)):
        gathered = act == 0
        wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + I * n // 4 + 4 * (I // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(D, 2 * I, gen=gk15) + rand_layer(I, n, gen=gk15)
                  + (rand_perm(D, D, gen=gk15) if gathered else k1._identity_perm(D, dev),)
                  for _ in range(copies)]
        w_gu = torch.randn((D, 2 * I), generator=gk15, device=dev).bfloat16()
        w_dn = torch.randn((I, n), generator=gk15, device=dev).bfloat16()
        act_name = ("silu", "gelu")[act]
        wave = k1.igtc_wave(dev)
        gs, ds = k1.igtc_splits(D, 2 * I, 128, wave), k1.igtc_splits(I, n, 128, wave)
        for B in (16, 32, 64):
            Bp = k1.igtc_rows_pad(B)
            x = torch.randn((B, D), generator=gk15, device=dev).bfloat16()
            xg = torch.empty((Bp, D), dtype=torch.bfloat16, device=dev)
            S = torch.empty((D // 128, Bp), dtype=torch.float32, device=dev)
            gpart = torch.empty((gs, Bp, 2 * I), dtype=torch.float32, device=dev)
            mid = torch.empty((Bp, I), dtype=torch.bfloat16, device=dev)
            msums = torch.empty((I // 64 + I // 128, Bp), dtype=torch.float32, device=dev)
            dpart = torch.empty((ds, B, n), dtype=torch.float32, device=dev)
            partial = torch.empty((I // 128, B, n), dtype=torch.float32, device=dev)
            out = torch.empty((B, n), dtype=torch.float32, device=dev)

            def kern_tc(i):
                gp, ga, gm, dp, da, dm, pm = layers[i % copies]
                ok(mlp_tc_lib.pt2_ternary_mlp_tc(
                    x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                    dp.data_ptr(), da.data_ptr(), dm.data_ptr(), xg.data_ptr(), S.data_ptr(),
                    gpart.data_ptr(), mid.data_ptr(), msums.data_ptr(), dpart.data_ptr(),
                    out.data_ptr(), mlp_counters.data_ptr(), B, D, D, I, n, gs, ds, act, dix,
                    stream), "K2 tc")

            def kern_cc(i):
                gp, ga, gm, dp, da, dm, pm = layers[i % copies]
                ok(mlp_lib.pt2_ternary_mlp(
                    x.data_ptr(), pm.data_ptr() if gathered else None, gp.data_ptr(),
                    ga.data_ptr(), gm.data_ptr(), dp.data_ptr(), da.data_ptr(), dm.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), B, D, D, 2 * I, I, I, n, act, dix,
                    stream), "K2")

            def library(i):
                gu = torch.matmul(x, w_gu)
                return torch.matmul(k1.mlp_activation(act_name, gu[:, :I]) * gu[:, I:], w_dn)

            turns = [time_ms(kern_tc, 50), time_ms(kern_cc, 20), time_ms(kern_cc, 20),
                     time_ms(kern_tc, 50)]
            plain_ms = time_ms(lambda i: k1.ternary_mlp_plain(
                x, layers[i % copies][6] if gathered else None, *layers[i % copies][:6], I,
                act=act_name), 3)
            lib_ms = time_ms(library, 20)
            nbytes = wbytes + 2 * B * D + 4 * B * n + (4 * D if gathered else 0)
            d = row("K2tc", label, B, min(turns[0], turns[3]), plain_ms, lib_ms, nbytes,
                    2.0 * B * (D * 2 * I + I * n), D=D, I=I, n=n, act=act_name, splits=[gs, ds])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(20):
                    kern_tc(i)
                torch.cuda.synchronize()
            krows = kernel_rows(prof)

            def per_launch(key):
                hit = [r for r in krows if key in r[2]]
                return sum(r[0] for r in hit) / max(1, sum(r[1] for r in hit))

            d.update(turns_ms=[turns[0], turns[3]], cuda_core_turns_ms=[turns[1], turns[2]],
                     cuda_core_ms=min(turns[1], turns[2]), gather_device_ms=per_launch("gather_rows"),
                     gateup_device_ms=per_launch("mlp_gateup"),
                     down_device_ms=per_launch("igathered_tc"))
            k2tc_detail.append(d)
            print(f"K2 tensor-core path, {label} MLP ({act_name}, "
                  f"{'gather' if gathered else 'identity perm'}) at {B:2d} rows: "
                  f"{' / '.join(f'{t * 1e3:.1f}' for t in turns)} us in turns tc, CUDA cores, "
                  f"CUDA cores, tc (device time by the profiler: gather "
                  f"{d['gather_device_ms'] * 1e3:.1f} + gate/up {d['gateup_device_ms'] * 1e3:.1f} "
                  f"+ down {d['down_device_ms'] * 1e3:.1f} us) | dense pair {lib_ms * 1e3:.1f} us | "
                  f"plain {plain_ms * 1e3:.1f} us | bound {d['bound_ms'] * 1e3:.2f} us on "
                  f"{record['smi']}")
        # the host's cost of one whole wrapper call (checks, scratch, launches)
        # on either path: the enqueue time of 30 calls after a synchronise
        gp, ga, gm, dp, da, dm, pm = layers[0]
        for B in (16, 64):
            x = torch.randn((B, D), generator=gk15, device=dev).bfloat16()
            host = {}
            for on in (True, False, False, True):
                with k2_tc(on):
                    k1.ternary_mlp(x, pm if gathered else None, gp, ga, gm, dp, da, dm, I,
                                   act=act_name)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(30):
                        k1.ternary_mlp(x, pm if gathered else None, gp, ga, gm, dp, da, dm, I,
                                       act=act_name)
                    host.setdefault("tc" if on else "cuda_core", []).append(
                        (time.perf_counter() - t0) / 30 * 1e3)
                    torch.cuda.synchronize()
            next(d for d in k2tc_detail if d["shape"] == label and d["B"] == B)[
                "wrapper_host_ms"] = host
            print(f"K2 wrapper, {label} at {B} rows: host time per call "
                  f"{' / '.join(f'{t * 1e3:.1f}' for t in host['tc'])} us on the tensor-core "
                  f"path, {' / '.join(f'{t * 1e3:.1f}' for t in host['cuda_core'])} us on the "
                  f"CUDA cores (enqueue of 30 calls)")
        del layers, w_gu, w_dn, gp, ga, gm, dp, da, dm, pm
    if mlp_counters.any():
        fail("K2's tensor-core path left a counter set")
    record["k2_tc_timing"] = k2tc_detail

    # 16c. K2's decode path through its C entry (gate/up with the gated
    # epilogue, then K1's decode kernel over mid; scratch allocated outside
    # the loop) at llama-3-8b's MLP ("ssr": the gather over its 4096
    # features, silu) and gemma-2b's ("down": the identity perm, GeGLU),
    # 1 / 2 / 4 / 8 rows, beside the CUDA-core K2 (the "off" turns' route),
    # in turns decode path, CUDA cores, CUDA cores, decode path; the two
    # dense bf16 torch.matmul with the activation between them (library: a
    # yardstick, no single call exists), the plain version and the bound;
    # then the path's two kernels' device time under torch.profiler, and
    # the wrapper's host time per call on either path
    mlp_dec_lib = k1._mlp_dec_kernel_lib()
    k2dec_detail = []
    for label, (D, I, n), act in (("llama-3-8b", MLP_8B, 0), ("gemma-2b", MLP_GEMMA, 1)):
        gathered = act == 0
        wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + I * n // 4 + 4 * (I // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(D, 2 * I, gen=gk16) + rand_layer(I, n, gen=gk16)
                  + (rand_perm(D, D, gen=gk16) if gathered else k1._identity_perm(D, dev),)
                  for _ in range(copies)]
        w_gu = torch.randn((D, 2 * I), generator=gk16, device=dev).bfloat16()
        w_dn = torch.randn((I, n), generator=gk16, device=dev).bfloat16()
        act_name = ("silu", "gelu")[act]
        gs, ds = k1.dec_splits(D, 2 * I, 128, k2dec_wave), k1.dec_splits(I, n, 128, k2dec_wave)
        for B in (1, 2, 4, 8):
            x = torch.randn((B, D), generator=gk16, device=dev).bfloat16()
            gpart = torch.empty((gs, B, 2 * I), dtype=torch.float32, device=dev)
            dpart = torch.empty((ds, B, n), dtype=torch.float32, device=dev)
            mid = torch.empty((B, I), dtype=torch.bfloat16, device=dev)
            partial = torch.empty((I // 128, B, n), dtype=torch.float32, device=dev)
            out = torch.empty((B, n), dtype=torch.float32, device=dev)

            def kern_dec(i):
                gp, ga, gm, dp, da, dm, pm = layers[i % copies]
                ok(mlp_dec_lib.pt2_ternary_mlp_dec(
                    x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                    dp.data_ptr(), da.data_ptr(), dm.data_ptr(), gpart.data_ptr(),
                    dpart.data_ptr(), mid.data_ptr(), out.data_ptr(), dec_counters.data_ptr(), B,
                    D, D, I, n, gs, ds, act, dix, stream), "K2 dec")

            def kern_cc(i):
                gp, ga, gm, dp, da, dm, pm = layers[i % copies]
                ok(mlp_lib.pt2_ternary_mlp(
                    x.data_ptr(), pm.data_ptr() if gathered else None, gp.data_ptr(),
                    ga.data_ptr(), gm.data_ptr(), dp.data_ptr(), da.data_ptr(), dm.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), B, D, D, 2 * I, I, I, n, act, dix,
                    stream), "K2")

            def library(i):
                gu = torch.matmul(x, w_gu)
                return torch.matmul(k1.mlp_activation(act_name, gu[:, :I]) * gu[:, I:], w_dn)

            turns = [time_ms(kern_dec, 50), time_ms(kern_cc, 30), time_ms(kern_cc, 30),
                     time_ms(kern_dec, 50)]
            plain_ms = time_ms(lambda i: k1.ternary_mlp_plain(
                x, layers[i % copies][6] if gathered else None, *layers[i % copies][:6], I,
                act=act_name), 3)
            lib_ms = time_ms(library, 20)
            nbytes = wbytes + 2 * B * D + 4 * B * n + (4 * D if gathered else 0)
            d = row("K2dec", label, B, min(turns[0], turns[3]), plain_ms, lib_ms, nbytes,
                    2.0 * B * (D * 2 * I + I * n), D=D, I=I, n=n, act=act_name, splits=[gs, ds])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(20):
                    kern_dec(i)
                torch.cuda.synchronize()
            krows = kernel_rows(prof)

            def per_launch(key):
                hit = [r for r in krows if key in r[2]]
                return sum(r[0] for r in hit) / max(1, sum(r[1] for r in hit))

            d.update(turns_ms=[turns[0], turns[3]], cuda_core_turns_ms=[turns[1], turns[2]],
                     cuda_core_ms=min(turns[1], turns[2]),
                     gateup_device_ms=per_launch(K2_PARTS["gateup"]),
                     down_device_ms=per_launch(K2_PARTS["dec_kernel"]))
            k2dec_detail.append(d)
            print(f"K2 decode path, {label} MLP ({act_name}, "
                  f"{'gather' if gathered else 'identity perm'}) at {B} rows: "
                  f"{' / '.join(f'{t * 1e3:.1f}' for t in turns)} us in turns decode path, CUDA "
                  f"cores, CUDA cores, decode path (device time by the profiler: gate/up "
                  f"{d['gateup_device_ms'] * 1e3:.1f} + down {d['down_device_ms'] * 1e3:.1f} us) | "
                  f"dense pair {lib_ms * 1e3:.1f} us | plain {plain_ms * 1e3:.1f} us | bound "
                  f"{d['bound_ms'] * 1e3:.2f} us on {record['smi']}")
        # the host's cost of one whole wrapper call (checks, scratch, launches)
        # on either path: the enqueue time of 100 calls after a synchronise
        gp, ga, gm, dp, da, dm, pm = layers[0]
        for B in (1, 8):
            x = torch.randn((B, D), generator=gk16, device=dev).bfloat16()
            host = {}
            for on in DEC_AB:
                with k2_dec(on):
                    k1.ternary_mlp(x, pm if gathered else None, gp, ga, gm, dp, da, dm, I,
                                   act=act_name)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(100):
                        k1.ternary_mlp(x, pm if gathered else None, gp, ga, gm, dp, da, dm, I,
                                       act=act_name)
                    host.setdefault("dec" if on else "cuda_core", []).append(
                        (time.perf_counter() - t0) / 100 * 1e3)
                    torch.cuda.synchronize()
            next(d for d in k2dec_detail if d["shape"] == label and d["B"] == B)[
                "wrapper_host_ms"] = host
            print(f"K2 wrapper, {label} at {B} rows: host time per call "
                  f"{' / '.join(f'{t * 1e3:.1f}' for t in host['dec'])} us on the decode path, "
                  f"{' / '.join(f'{t * 1e3:.1f}' for t in host['cuda_core'])} us on the CUDA cores "
                  f"(enqueue of 100 calls, turns on, off, off, on)")
        del layers, w_gu, w_dn, gp, ga, gm, dp, da, dm, pm
    if dec_counters.any():
        fail("K2's decode path left a counter set")
    record["k2_dec_timing"] = k2dec_detail

    # K1's decode kernel at gemma-2b's four projections, 1 and 8 rows, beside
    # the plain version, dense torch.matmul and the bytes bound
    k1g_detail = []
    for name, K, n in SHAPES_GEMMA:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(K, n, gen=ggem) for _ in range(copies)]
        dn = dense(K, n, ggem)
        splits = k1.dec_splits(K, n, 128, k1.dec_wave(dev))
        for B in (1, 8):
            x = torch.randn((B, K), generator=ggem, device=dev).bfloat16()
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            partial = torch.empty((splits, B, n), dtype=torch.float32, device=dev)

            def kern_dec(i):
                p, a, m = layers[i % copies]
                ok(dec_lib.pt2_ternary_matmul_dec(
                    x.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), dec_counters.data_ptr(), B, K, n, 128, splits, 0, dix,
                    stream), "K1 dec")

            ms = time_ms(kern_dec, 50)
            plain_ms = time_ms(lambda i: k1.ternary_matmul_plain(x, *layers[i % copies]), 3)
            lib_ms = time_ms(lambda i: torch.matmul(x, dn[i % len(dn)]), 50)
            k1g_detail.append(row("K1dec", name, B, ms, plain_ms, lib_ms,
                                  wbytes + 2 * B * K + 4 * B * n, 2.0 * B * K * n, K=K, n=n,
                                  splits=splits))
        del layers, dn
    if dec_counters.any():
        fail("the decode kernel left a column tile's counter set")
    record["k1_dec_gemma_timing"] = k1g_detail
    for B in (1, 8):
        at_b = [d for d in k1g_detail if d["B"] == B]
        print(f"K1 decode kernel, one gemma-2b layer (4 projections) at {B} rows: "
              f"{sum(d['ms'] for d in at_b) * 1e3:.1f} us | torch.matmul "
              f"{sum(d['library_ms'] for d in at_b) * 1e3:.1f} us | bound "
              f"{sum(d['bound_ms'] for d in at_b) * 1e3:.1f} us on {record['smi']}")

    m = K = 4096
    perms = [rand_perm(m, K) for _ in range(4)]

    # 18c. K5 at the same 4096 -> 4096 gather (planes of 4 MB) at 16 / 32 /
    # 64 / 128 / 256 / 512 rows: the rows path's C entry (both launches; at
    # 16 to 64 rows as well, which the threshold keeps on the first kernel)
    # and K5's first kernel, each as 50 calls replayed from a CUDA graph (the
    # card's time per call, launch gaps included: CUDA events over
    # back-to-back ctypes calls of a few-us kernel measure the host's launch
    # rate, and are kept beside them), in turns rows, first, first, rows; the
    # library call torch.index_select, replayed the same way; each path's
    # plain version; then both paths under torch.profiler, device time per
    # launch of the lane map, the rows kernel (a programmatic dependant of
    # the lane map: it counts from its early start) and the first kernel.
    # The products it must do are one per nonzero field
    k5_detail, k5rows_detail = [], []
    rows_lib = k4._rows_kernel_lib()
    gps = [make_packed_gather(p, m).packed for p in perms]
    nnz = int(k4.onehot_planes(gps[0]).count_nonzero())
    lmap = torch.empty(5 * K, dtype=torch.int32, device=dev)
    lperm = [p.long() for p in perms]
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (a capture's own)

    def graph_ms(fn, calls=50, replays=4):
        """fn(0..calls-1) captured into a CUDA graph, then replayed: ms per call."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        s, e = ev(), ev()
        s.record()
        for _ in range(replays):
            graph.replay()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / (calls * replays)

    for B in (16, 32, 64, 128, 256, 512):
        per_call = m * K // 4 + 2 * B * m + 2 * B * K
        copies = max(4, math.ceil(COLD_BYTES / per_call))
        planes_c = [gps[i % 4] if i < 4 else gps[i % 4].clone() for i in range(copies)]
        xs = [torch.randn((B, m), generator=g, device=dev).bfloat16() for _ in range(copies)]
        outs = [torch.empty((B, K), dtype=torch.bfloat16, device=dev) for _ in range(copies)]

        def kern(i):
            c = i % copies
            ok(mm_lib.pt2_onehot_matmul(xs[c].data_ptr(), planes_c[c].data_ptr(),
                                        outs[c].data_ptr(), B, m, m // 4, K, 2, dix, cur()), "K5")

        def kern_rows(i):
            c = i % copies
            ok(rows_lib.pt2_onehot_matmul_rows(
                xs[c].data_ptr(), planes_c[c].data_ptr(), lmap.data_ptr(), outs[c].data_ptr(), B,
                m, m // 4, K, 2, dix, cur()), "K5 rows")

        library = lambda i: torch.index_select(xs[i % copies], 1, lperm[i % copies % 4])  # noqa: E731
        events = [time_ms(kern_rows, 50), time_ms(kern, 50)]  # warm: built, attributes set
        turns = [graph_ms(kern_rows), graph_ms(kern), graph_ms(kern), graph_ms(kern_rows)]
        plain_ms = time_ms(lambda i: k4.onehot_matmul_plain(xs[i % copies], planes_c[i % copies]), 5)
        rows_plain_ms = time_ms(lambda i: k4.onehot_matmul_rows_plain(
            xs[i % copies], planes_c[i % copies]), 5)
        lib_events_ms = time_ms(library, 50)
        lib_ms = graph_ms(library)
        d_old = row("K5", "gather", B, min(turns[1], turns[2]), plain_ms, lib_ms, per_call,
                    2.0 * B * nnz, m=m, K=K)
        d = row("K5rows", "gather", B, min(turns[0], turns[3]), rows_plain_ms, lib_ms, per_call,
                2.0 * B * nnz, m=m, K=K)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                kern_rows(i)
            for i in range(20):
                kern(i)
            torch.cuda.synchronize()
        krows = kernel_rows(prof)

        def per_launch(key):
            hit = [r for r in krows if key in r[2]]
            return sum(r[0] for r in hit) / max(1, sum(r[1] for r in hit))

        d.update(turns_ms=[turns[0], turns[3]], events_ms=events[0],
                 lane_map_device_ms=per_launch(K5_PARTS["lane_map"]),
                 rows_device_ms=per_launch(K5_PARTS["rows"]), library_events_ms=lib_events_ms,
                 routed=k4.k5_path(B, m, 2))
        d_old.update(turns_ms=[turns[1], turns[2]], events_ms=events[1],
                     device_ms=per_launch(K5_PARTS["cuda_core"]), library_events_ms=lib_events_ms)
        k5_detail.append(d_old)
        k5rows_detail.append(d)
        print(f"K5, 4096 -> 4096 at {B:3d} rows (routed: {d['routed']}; us per call from a CUDA "
              f"graph): rows path {d['ms'] * 1e3:6.2f} (turns {turns[0] * 1e3:.2f} / "
              f"{turns[3] * 1e3:.2f}; CUDA events {events[0] * 1e3:.1f}; device time by the "
              f"profiler: lane map {d['lane_map_device_ms'] * 1e3:5.2f} + rows "
              f"{d['rows_device_ms'] * 1e3:5.2f}) | first kernel {d_old['ms'] * 1e3:6.2f} (turns "
              f"{turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f}; events {events[1] * 1e3:.1f}; device "
              f"{d_old['device_ms'] * 1e3:5.2f}) | torch.index_select {lib_ms * 1e3:5.2f} (events "
              f"{lib_events_ms * 1e3:.1f}) | plain {rows_plain_ms * 1e3:7.1f} | bound "
              f"{d['bound_ms'] * 1e3:5.2f} on {record['smi']}")
        del xs, outs, planes_c
    record["k5_timing"] = k5_detail
    record["k5_rows_timing"] = k5rows_detail

    # 20c. K4 at the same 4096 -> 4096 gather (no pad lanes) at 1 / 16 / 64 /
    # 128 / 256 / 512 rows: the rows path's C entry (at 1 row as well, which
    # the threshold keeps on the first kernel) and K4's first kernel, each as
    # calls replayed from a CUDA graph (operands rotated over >= 150 MB, at
    # least 50 calls a graph and one per operand copy), in turns rows, first,
    # first, rows; CUDA events over back-to-back calls beside them (they read
    # the host's launch rate at a few us a call); torch.index_select replayed
    # the same way, and its events; the plain version; the bound; then both
    # kernels under torch.profiler, device time per launch
    k4_detail, k4rows_detail = [], []
    grows_lib = k4._gather_rows_kernel_lib()
    for B in (1, 16, 64, 128, 256, 512):
        per_call = 2 * B * m + 4 * K + 2 * B * K
        copies = max(4, math.ceil(COLD_BYTES / per_call))
        ncalls = max(50, copies)
        xs = [torch.randn((B, m), generator=g, device=dev).bfloat16() for _ in range(copies)]
        outs = [torch.empty((B, K), dtype=torch.bfloat16, device=dev) for _ in range(copies)]

        def kern(i):
            c = i % copies
            ok(gather_lib.pt2_onehot_gather(xs[c].data_ptr(), perms[i % 4].data_ptr(),
                                            outs[c].data_ptr(), B, m, K, 2, dix, cur()), "K4")

        def kern_rows(i):
            c = i % copies
            ok(grows_lib.pt2_onehot_gather_rows(xs[c].data_ptr(), perms[i % 4].data_ptr(),
                                                outs[c].data_ptr(), B, m, K, 2, dix, cur()),
               "K4 rows")

        library = lambda i: torch.index_select(xs[i % copies], 1, lperm[i % 4])  # noqa: E731
        events = [time_ms(kern_rows, 50), time_ms(kern, 50)]
        turns = [graph_ms(kern_rows, ncalls), graph_ms(kern, ncalls), graph_ms(kern, ncalls),
                 graph_ms(kern_rows, ncalls)]
        plain_ms = time_ms(lambda i: k4.onehot_gather_plain(xs[i % copies], perms[i % 4]), 20)
        lib_events_ms = time_ms(library, 50)
        lib_ms = graph_ms(library, ncalls)
        d_old = row("K4", "gather", B, min(turns[1], turns[2]), plain_ms, lib_ms, per_call, 0.0,
                    m=m, K=K)
        d = row("K4rows", "gather", B, min(turns[0], turns[3]), plain_ms, lib_ms, per_call, 0.0,
                m=m, K=K)
        def per_launch(fn, key):
            """Device ms per launch of the kernel named by ``key`` over the
            calls of fn that torch.profiler records (device activity only;
            a window of its own for each kernel): 100 calls, then 20 more
            (the first launches of a window can go unrecorded: a window that
            began with 20 of these short calls saw none of them); None, with
            the names seen, where it records none."""
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(100):
                    fn(i)
                torch.cuda.synchronize()
                for i in range(20):
                    fn(i)
                torch.cuda.synchronize()
            seen = kernel_rows(prof)
            hit = [r for r in seen if key in r[2]]
            if not hit:
                print(f"  20c: torch.profiler saw no {key} launch; it saw "
                      f"{[r[2][:70] for r in seen]}")
                return None
            return sum(r[0] for r in hit) / sum(r[1] for r in hit)

        d.update(turns_ms=[turns[0], turns[3]], events_ms=events[0],
                 device_ms=per_launch(kern_rows, K4_PARTS["rows"]),
                 library_events_ms=lib_events_ms, routed=k4.k4_path(B, m, K, 2))
        d_old.update(turns_ms=[turns[1], turns[2]], events_ms=events[1],
                     device_ms=per_launch(kern, K4_PARTS["cuda_core"]),
                     library_events_ms=lib_events_ms)
        dev_us = lambda v: "not measured" if v is None else f"{v * 1e3:5.2f}"  # noqa: E731
        k4_detail.append(d_old)
        k4rows_detail.append(d)
        print(f"K4, 4096 -> 4096 at {B:3d} rows (routed: {d['routed']}; us per call from a CUDA "
              f"graph): rows path {d['ms'] * 1e3:6.2f} (turns {turns[0] * 1e3:.2f} / "
              f"{turns[3] * 1e3:.2f}; CUDA events {events[0] * 1e3:.1f}; device time by the "
              f"profiler {dev_us(d['device_ms'])}) | first kernel {d_old['ms'] * 1e3:6.2f} "
              f"(turns {turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f}; events {events[1] * 1e3:.1f}; "
              f"device {dev_us(d_old['device_ms'])}) | torch.index_select {lib_ms * 1e3:5.2f} "
              f"(events {lib_events_ms * 1e3:.1f}) | plain {plain_ms * 1e3:7.1f} | bound "
              f"{d['bound_ms'] * 1e3:5.2f} on {record['smi']}")
        del xs, outs
    record["k4_timing"] = k4_detail
    record["k4_rows_timing"] = k4rows_detail

    # K6 at llama-3-8b qkv / o (K3's layers, with the planes in place of the
    # perm); library: one dense bf16 matmul on pre-gathered x, as for K3.
    # "K6" the CUDA-core kernel at rows 1-64; 17c: "K6dec" (rows 1 / 4 / 8)
    # and "K6tc" (16 / 32 / 64) K6's decode and tensor-core paths through
    # their C entries (scratch allocated outside the loop), in turns path,
    # CUDA-core K6, path; beside them the plane gather alone, K3's path on
    # the same perm (its decode or tensor-core path), and the path's two
    # kernels' device time per launch under torch.profiler (CUDA events over
    # back-to-back ctypes calls of a ~2 us kernel measure the host's launch
    # rate). Rows besides 1 and 16 draw from gk17, so that the later phases
    # draw what they drew before
    k6_detail, k6dec_detail, k6tc_detail, wrapper_detail = [], [], [], []
    gd_lib, gt_lib = k1._gathered_dec_kernel_lib(), k1._gathered_tc_kernel_lib()
    k6_counters = torch.zeros(1024, dtype=torch.int32, device=dev)
    for name, m, K, n in SHAPES_8B:
        wbytes = K * n // 4 + 4 * (K // 128) * n + m * K // 4
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        perms = [rand_perm(m, K) for _ in range(copies)]
        layers = [rand_layer(K, n) + (make_packed_gather(p, m).packed, p) for p in perms]
        nnz = int(k4.onehot_planes(layers[0][3]).count_nonzero())
        D4 = layers[0][3].shape[0]
        dn = dense(K, n)
        for B in (1, 4, 8, 16, 32, 64):
            x = torch.randn((B, m), generator=g if B in (1, 16) else gk17, device=dev).bfloat16()
            partial = torch.empty((K // 128, B, n), dtype=torch.float32, device=dev)
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            path = "dec" if B <= 8 else "tc"
            if path == "dec":
                splits, rows_out = k1.dec_splits(K, n, 128, k1.dec_wave(dev)), B
            else:
                splits, rows_out = k1.igtc_splits(K, n, 128, k1.igtc_wave(dev)), k1.igtc_rows_pad(B)
            xg = torch.empty((rows_out, K), dtype=torch.bfloat16, device=dev)
            S = torch.empty((K // 128, rows_out), dtype=torch.float32, device=dev)
            ppart = torch.empty((splits, B, n), dtype=torch.float32, device=dev)

            def kern(i):
                p, a, mu_, gpl, _ = layers[i % copies]
                ok(gathered_lib.pt2_ternary_matmul_gathered(
                    x.data_ptr(), gpl.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), B, m, m // 4, K, n, 0, dix, stream), "K6")

            def kern_path(i):
                p, a, mu_, gpl, _ = layers[i % copies]
                head = (x.data_ptr(), gpl.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                        xg.data_ptr())
                tail = (ppart.data_ptr(), out.data_ptr(), k6_counters.data_ptr(), B, m, D4, K, n,
                        splits, 0, dix, stream)
                if path == "dec":
                    ok(gd_lib.pt2_ternary_matmul_gathered_dec(*head, *tail), "K6 dec")
                else:
                    ok(gt_lib.pt2_ternary_matmul_gathered_tc(*head, S.data_ptr(), *tail), "K6 tc")

            def kern_gather(i):
                ok(gt_lib.pt2_planes_gather(
                    x.data_ptr(), layers[i % copies][3].data_ptr(), xg.data_ptr(), S.data_ptr(),
                    B, rows_out, m, D4, K, int(path == "tc"), 0, dix, stream), "plane gather")

            def kern_k3(i):
                p, a, mu_, _, pm = layers[i % copies]
                if path == "dec":
                    ok(dec_lib.pt2_ternary_matmul_dec_igathered(
                        x.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                        ppart.data_ptr(), out.data_ptr(), k6_counters.data_ptr(), B, m, K, n, 128,
                        splits, 0, dix, stream), "K3 dec")
                else:
                    ok(igtc_lib.pt2_ternary_matmul_igathered_tc(
                        x.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                        xg.data_ptr(), S.data_ptr(), ppart.data_ptr(), out.data_ptr(),
                        k6_counters.data_ptr(), B, m, K, n, 128, splits, 0, dix, stream), "K3 tc")

            turns = [time_ms(kern_path, 50), time_ms(kern, 50 if B <= 16 else 20),
                     time_ms(kern_path, 50)]
            ms = turns[1]
            k3_ms = time_ms(kern_k3, 50)
            gather_ms = time_ms(kern_gather, 50)
            plain_ms = time_ms(lambda i: k1.ternary_matmul_gathered_plain(
                x, layers[i % copies][3], *layers[i % copies][:3]), 5)
            xgd = k4.onehot_matmul_plain(x, layers[0][3])
            lib_ms = time_ms(lambda i: torch.matmul(xgd, dn[i % len(dn)]), 50)
            nbytes, ops = wbytes + 2 * B * m + 4 * B * n, 2.0 * B * (K * n + nnz)
            k6_detail.append(row("K6", name, B, ms, plain_ms, lib_ms, nbytes, ops, m=m, K=K, n=n))
            path_plain = (k1.ternary_matmul_gathered_dec_plain if path == "dec"
                          else k1.ternary_matmul_gathered_tc_plain)
            wave = k1.dec_wave(dev) if path == "dec" else k1.igtc_wave(dev)
            path_plain_ms = time_ms(lambda i: path_plain(
                x, layers[i % copies][3], *layers[i % copies][:3], wave=wave), 3)
            d = row("K6" + path, name, B, min(turns[0], turns[2]), path_plain_ms, lib_ms, nbytes,
                    ops, m=m, K=K, n=n, splits=splits)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(20):
                    kern_path(i)
                torch.cuda.synchronize()
            krows = kernel_rows(prof)

            def per_launch(key):
                hit = [r for r in krows if key in r[2]]
                return sum(r[0] for r in hit) / max(1, sum(r[1] for r in hit))

            d.update(turns_ms=[turns[0], turns[2]], cuda_core_ms=ms, k3_path_ms=k3_ms,
                     gather_ms=gather_ms, gather_device_ms=per_launch("planes_gather_kernel"),
                     product_device_ms=per_launch("ternary_matmul_dec_kernel" if path == "dec"
                                                  else "igathered_tc_kernel"))
            (k6dec_detail if path == "dec" else k6tc_detail).append(d)
        # the whole Python wrappers of K3 and K6 back to back at the lockstep
        # decode's B = 4 (checks, allocations, launches): K3, K6, K6, K3
        x = torch.randn((4, m), generator=g, device=dev).bfloat16()

        def k3w(i):
            p, a, mu_, _, pm = layers[i % copies]
            return k1.ternary_matmul_igathered(x, pm, p, a, mu_)

        def k6w(i):
            p, a, mu_, gpl, _ = layers[i % copies]
            return k1.ternary_matmul_gathered(x, gpl, p, a, mu_)

        w = [time_ms(k3w, 50), time_ms(k6w, 50), time_ms(k6w, 50), time_ms(k3w, 50)]
        wrapper_detail.append({"shape": name, "B": 4, "k3_wrapper_ms": [w[0], w[3]],
                               "k6_wrapper_ms": [w[1], w[2]]})
        print(f"{name} B=4, whole wrapper per call: K3 {w[0] * 1e3:.1f} / {w[3] * 1e3:.1f} us, "
              f"K6 {w[1] * 1e3:.1f} / {w[2] * 1e3:.1f} us (K3, K6, K6, K3)")
        del layers, dn, perms
    if k6_counters.any():
        fail("K6's decode or tensor-core path left a column tile's counter set")
    record["k6_timing"] = k6_detail
    record["k6_dec_timing"] = k6dec_detail
    record["k6_tc_timing"] = k6tc_detail
    record["k3_k6_wrapper_timing"] = wrapper_detail
    for B in (1, 4, 8, 16, 32, 64):
        at = [d for d in k6dec_detail + k6tc_detail if d["B"] == B]
        tot = lambda key: sum(d[key] for d in at) * 1e3  # noqa: E731
        print(f"K6, llama-3-8b qkv + o at {B:2d} rows: {'decode' if B <= 8 else 'tensor-core'} "
              f"path {tot('ms'):6.1f} us (device time by the profiler: plane gather "
              f"{tot('gather_device_ms'):5.1f} us + product {tot('product_device_ms'):5.1f} us; the "
              f"gather alone {tot('gather_ms'):5.1f} us of CUDA events) | CUDA-core K6 "
              f"{tot('cuda_core_ms'):6.1f} us | K3's path {tot('k3_path_ms'):6.1f} us | "
              f"torch.matmul on gathered x {tot('library_ms'):5.1f} us | bound "
              f"{tot('bound_ms'):5.2f} us on {record['smi']}")

    # K7 at the engine's point: B 8, M 2048, llama-3-8b heads and gemma-2b's
    # (hd 256, one KV head): its tensor-core kernel (the route, on its plan)
    # and PR 3's kernel through their C entries, as CUDA events over 50
    # back-to-back launches and as 50 calls replayed from a CUDA graph, the
    # cache rotated over >= 150 MB; every slot valid (the function needs the
    # whole cache), then engine-like lengths (64-576 valid slots a row: the
    # bound counts the valid slots' bytes, what the function needs). Library:
    # scaled_dot_product_attention on the (B, heads, M, hd) layout it wants,
    # made outside the timed call (int8: dequantise, then SDPA).
    attn_lib = k7._kernel_lib()
    tc_lib = k7._tc_kernel_lib()
    record["k7_cc_timing"] = []

    def k7_timing(H7, Hkv7, hd7, attn_scale, label, modes=("all", "engine"), M7=ENGINE_M):
        """K7 at B 8, M ``M7`` (2048; a ring's 1024) over valid slots by
        ``modes``: "all" every slot, "engine" prefixes of 64-576 slots (the
        engine's lengths), "window" gemma3's window of 1024 slots ending at
        1100-2047 (rows whose slots before the window are invalid)."""
        B7 = 8
        chunk = k7.chunk_len(B7, M7, Hkv7, H7 // Hkv7, hd7)
        nchunk = -(-M7 // chunk)
        part_acc = torch.empty((B7, H7, nchunk, hd7), dtype=torch.float32, device=dev)
        part_ml = torch.empty((B7, H7, nchunk, 2), dtype=torch.float32, device=dev)
        out7 = torch.empty((B7, 1, H7, hd7), dtype=torch.bfloat16, device=dev)
        k7_detail = []
        for quant in (False, True):
            plan = k7.k7_plan(B7, M7, Hkv7, H7 // Hkv7, hd7, quant)
            eb = 1 if quant else 2
            kv_bytes = 2 * B7 * M7 * Hkv7 * hd7 * eb + (2 * B7 * M7 * Hkv7 * 4 if quant else 0)
            copies = max(2, math.ceil(COLD_BYTES / kv_bytes))
            for lengths in modes:
                sets = [attn_inputs(B7, M7, H7, Hkv7, quant, ragged=False, hd=hd7)
                        for _ in range(copies)]
                pos7 = torch.arange(M7, device=dev)[None, :]
                for st_ in sets:
                    if lengths == "engine":
                        st_[3].copy_(pos7 < torch.randint(64, 577, (B7, 1), generator=g,
                                                          device=dev))
                    elif lengths == "window":
                        p7 = torch.randint(1100, M7, (B7, 1), generator=g, device=dev)
                        st_[3].copy_((pos7 <= p7) & (pos7 > p7 - 1024))
                q7 = sets[0][0]
                ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

                def kern_tc(i):
                    _, kk, vv, vd, ks_, vs_ = sets[i % copies]
                    ok(tc_lib.pt2_decode_attention_tc(
                        q7.data_ptr(), kk.data_ptr(), vv.data_ptr(), vd.data_ptr(), ptr(ks_),
                        ptr(vs_), out7.data_ptr(), attn_scale, B7, M7, H7, Hkv7, hd7, plan.splits,
                        int(quant), dix, cur()), "K7 (tensor cores)")

                def kern_cc(i):
                    _, kk, vv, vd, ks_, vs_ = sets[i % copies]
                    ok(attn_lib.pt2_decode_attention(
                        q7.data_ptr(), kk.data_ptr(), vv.data_ptr(), vd.data_ptr(),
                        ptr(ks_), ptr(vs_), part_acc.data_ptr(), part_ml.data_ptr(),
                        out7.data_ptr(), attn_scale, B7, M7, H7, Hkv7, hd7, chunk, int(quant), dix,
                        cur()), "K7 (PR 3)")

                # in turns: tensor cores, PR 3's, PR 3's, tensor cores
                ev_ms = {"tc": [], "cc": []}
                for which in ("tc", "cc", "cc", "tc"):
                    ev_ms[which].append(time_ms(kern_tc if which == "tc" else kern_cc, 50))
                gr_ms = {"tc": graph_ms(kern_tc), "cc": graph_ms(kern_cc)}
                wrapper_ms = time_ms(lambda i: k7.decode_attention(
                    q7, *sets[i % copies][1:4], attn_scale, *sets[i % copies][4:]), 50)
                plain_ms = time_ms(lambda i: k7.decode_attention_plain(
                    q7, *sets[i % copies][1:4], attn_scale, *sets[i % copies][4:]), 3)
                qh = q7.transpose(1, 2).contiguous()  # (B, H, 1, hd)
                lib_sets = []
                for _, kk, vv, vd, ks_, vs_ in sets:
                    heads_first = lambda t: None if t is None else t.permute(0, 2, 1, 3).contiguous()  # noqa: E731
                    lib_sets.append((heads_first(kk), heads_first(vv), vd[:, None, None, :],
                                     heads_first(ks_), heads_first(vs_)))

                def library(i):
                    kh, vh, mask, ksh, vsh = lib_sets[i % copies]
                    if quant:
                        kh, vh = (kh.float() * ksh).bfloat16(), (vh.float() * vsh).bfloat16()
                    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                          scale=attn_scale, enable_gqa=True)

                lib_ms = time_ms(library, 20)
                # the yardstick computes the same function: within K7's tolerance of
                # the plain version on the cache it attends over (int8: the cache
                # dequantised to bf16, as the yardstick dequantises it)
                _, kk, vv, vd, ks_, vs_ = sets[0]
                if quant:
                    kk, vv = (kk.float() * ks_).bfloat16(), (vv.float() * vs_).bfloat16()
                want = k7.decode_attention_plain(q7, kk, vv, vd, attn_scale).float()
                got = library(0).transpose(1, 2).float()
                err = (got - want).abs().max().item()
                if not err <= ATTN_TOL * want.abs().max().item():
                    fail(f"SDPA yardstick disagrees with K7's plain version (int8={quant}): "
                         f"max|err| {err:.3e}, max|ref| {want.abs().max().item():.3e}")
                # what the function needs: the valid slots' K/V (and scales) once,
                # q, kv_valid and the output; its operations on those slots
                slots = sum(int(st_[3].sum()) for st_ in sets) / copies  # the valid slots only
                need = slots * Hkv7 * (2 * hd7 * eb + (8 if quant else 0))
                nbytes = need + 2 * B7 * H7 * hd7 + B7 * M7 + 2 * B7 * H7 * hd7
                shape = ("int8" if quant else "bf16") + {"all": "", "engine": " eng",
                                                         "window": " window"}[lengths]
                d = row(label, shape, B7, gr_ms["tc"], plain_ms, lib_ms, nbytes,
                        4.0 * H7 * slots * hd7, M=M7, H=H7, Hkv=Hkv7, hd=hd7, splits=plan.splits,
                        lengths=lengths, valid_slots=slots)
                d.update(events_ms=ev_ms, graph_ms=gr_ms, wrapper_ms=wrapper_ms)
                record["k7_cc_timing"].append(dict(d, kernel=label + " PR 3", ms=gr_ms["cc"]))
                print(f"{label} {shape}: tensor-core kernel (plan {plan.splits} splits) "
                      f"{gr_ms['tc'] * 1e3:.1f} us from a CUDA graph, "
                      + " / ".join(f"{x * 1e3:.1f}" for x in ev_ms["tc"]) + " us of CUDA events | "
                      f"PR 3's kernel {gr_ms['cc'] * 1e3:.1f} us, "
                      + " / ".join(f"{x * 1e3:.1f}" for x in ev_ms["cc"]) + " us | whole wrapper "
                      f"{wrapper_ms * 1e3:.1f} us | {slots:.0f} valid slots of {B7 * M7}")
                k7_detail.append(d)
                del sets, lib_sets
        return k7_detail

    record["k7_timing"] = k7_timing(32, 8, 128, attn_scale, "K7")
    Hg, Hkvg, hdg = HEADS_GEMMA
    record["k7_gemma_timing"] = k7_timing(Hg, Hkvg, hdg, 1.0 / math.sqrt(hdg), "K7gemma")
    # K7 at gemma3-4b's heads (8 / 4 KV of 256) on the windowed kv_valid of
    # its sliding layers: the bound counts the window's slots
    H3, Hkv3, hd3 = HEADS_GEMMA3
    record["k7_gemma3_window_timing"] = k7_timing(H3, Hkv3, hd3, 1.0 / math.sqrt(hd3),
                                                  "K7gemma3", modes=("window",))
    # K7 at the wide heads (8 / 2 KV heads, hd 384 and 512), every slot
    # valid, and on a gemma3-4b ring: 1024 slots (W), all valid, as every
    # sliding layer's decode attends once past the window
    for hd_w in WIDE_HEAD_DIMS:
        record[f"k7_hd{hd_w}_timing"] = k7_timing(8, 2, hd_w, hd_w ** -0.5, f"K7hd{hd_w}",
                                                  modes=("all",))
    record["k7_gemma3_ring_timing"] = k7_timing(H3, Hkv3, hd3, 1.0 / math.sqrt(hd3), "K7gemma3ring",
                                                modes=("all",), M7=RING_SLOTS)
    # K7's wide instance (phase 30) at 8 / 2 KV heads, hd 640 / 768 / 1024,
    # every slot valid
    for hd_w in WIDE_RT_HEAD_DIMS:
        record[f"k7_hd{hd_w}_timing"] = k7_timing(8, 2, hd_w, hd_w ** -0.5, f"K7hd{hd_w}",
                                                  modes=("all",))

    # the floor's FLOOR instances through their C entries (a8 mode 2, K1's
    # int8 tensor cores through pt2_ternary_matmul_tc_a8_floor) at
    # llama-3-8b's qkv (4096 -> 6144), B 1 on the decode kernels and the CUDA
    # cores, B 16 on the tensor-core paths, K1s / K3s / K6s on slot 1 of
    # their stacks, each from a CUDA graph over copies larger than L2, beside
    # the same kernel's W2A8 instance (the unpack's: the floor's yardstick;
    # no library call computes the floor) and the floor's plain version. The
    # bound: the bytes the call must move (codes, scales, x, out; K3 its
    # perm, K6 its planes) against its operations at the tensor cores' peak
    # (int8 for K1's int8 tensor cores, bf16 for the rest).
    gft = torch.Generator(device=dev).manual_seed(2406)
    Kf, nf, Sf = 4096, 6144, 3
    wbytes = Kf * nf // 4 + 2 * 2 * (Kf // 128) * nf
    copies_f = max(2, math.ceil(COLD_BYTES / (wbytes + Kf * Kf // 4)))
    fl_layers = []
    for _ in range(copies_f):
        T = torch.randint(-1, 2, (nf, Kf), generator=gft, device=dev, dtype=torch.int8)
        pf_ = torch.randperm(Kf, generator=gft, device=dev).to(torch.int32)
        fl_layers.append((pack_ternary(T, 128),
                          (0.05 + 0.01 * torch.rand((Kf // 128, nf), generator=gft,
                                                    device=dev)).bfloat16(),
                          (0.01 * torch.randn((Kf // 128, nf), generator=gft, device=dev)).bfloat16(),
                          pf_, tgather.make_packed_gather(pf_, Kf).packed))
        del T
    st_f = [tuple(torch.stack([fl_layers[(c_ + s_) % copies_f][j] for s_ in range(Sf)]).contiguous()
                  for j in range(5)) for c_ in range(0, copies_f, Sf)]
    cnt_f = torch.zeros(1024, dtype=torch.int32, device=dev)
    sel_f = torch.tensor(1, dtype=torch.int32, device=dev)
    fdec, fcc, ftc, figtc = (k1._dec_kernel_lib(), k1._kernel_lib(), k1._tc_a8_kernel_lib(),
                             k1._igtc_kernel_lib())
    fgd, fgc, fgt = (k1._gathered_dec_kernel_lib(), k1._gathered_kernel_lib(),
                     k1._gathered_tc_kernel_lib())
    D4f = Kf // 4
    floor_timing = []
    for B in (1, 16):
        x = torch.randn((B, Kf), generator=gft, device=dev).bfloat16()
        xn = k1.normalize_rows_a8(x)[0].contiguous()
        out = torch.empty((B, nf), dtype=torch.float32, device=dev)
        dsp = k1.dec_splits(Kf, nf, 128, k1.dec_wave(dev))
        isp = k1.igtc_splits(Kf, nf, 128, k1.igtc_wave(dev))
        Bp = k1.igtc_rows_pad(B) if B >= 9 else B
        part = torch.empty((max(dsp, isp, Kf // 128), B, nf), dtype=torch.float32, device=dev)
        xg = torch.empty((Bp, Kf), dtype=torch.bfloat16, device=dev)
        sums = torch.empty((Kf // 128, Bp), dtype=torch.float32, device=dev)
        xq = torch.empty((B, Kf), dtype=torch.int8, device=dev)
        isums = torch.empty((Kf // 128, 128), dtype=torch.int32, device=dev)
        P = lambda t: t.data_ptr()  # noqa: E731
        # the library yardstick: torch._int_mm of int8 rows (24 below 17: it
        # takes > 16 rows in multiples of 8) by the dense int8 codes, over
        # copies past L2, from CUDA events, as phase 6 times the W2A8 rows
        xq_f = torch.randint(-127, 128, (B if B > 16 else 24, Kf), generator=gft, device=dev,
                             dtype=torch.int8)
        dn8_f = [torch.randint(-1, 2, (nf, Kf), generator=gft, device=dev, dtype=torch.int8).t()
                 for _ in range(max(1, math.ceil(COLD_BYTES / (Kf * nf))))]
        try:
            torch._int_mm(xq_f, dn8_f[0])
        except RuntimeError:
            dn8_f = [t_.contiguous() for t_ in dn8_f]
        int_mm_f = time_ms(lambda i: torch._int_mm(xq_f, dn8_f[i % len(dn8_f)]), 50)
        print(f"floor library yardstick B={B}: torch._int_mm ({xq_f.shape[0]} rows) at llama-3-8b "
              f"qkv {int_mm_f * 1e3:.2f} us on {record['smi']}")

        def w(i):
            return fl_layers[i % copies_f]

        def stk(i):
            return st_f[i % len(st_f)]

        kinds = ([("ternary_matmul_dec", "dec"), ("ternary_matmul", "cc"),
                  ("ternary_matmul_igathered_dec", "dec"), ("ternary_matmul_igathered", "cc"),
                  ("ternary_matmul_gathered_dec", "dec"), ("ternary_matmul_gathered", "cc"),
                  ("ternary_matmul_idx_dec", "dec"), ("ternary_matmul_idx", "cc"),
                  ("ternary_matmul_igathered_idx_dec", "dec"),
                  ("ternary_matmul_igathered_idx", "cc"),
                  ("ternary_matmul_gathered_idx_dec", "dec"), ("ternary_matmul_gathered_idx", "cc")]
                 if B == 1 else
                 [("ternary_matmul_tc_a8", "tc"), ("ternary_matmul_igathered_tc", "tc"),
                  ("ternary_matmul_gathered_tc", "tc")])
        for kname, path in kinds:
            def call(i, mode, kname=kname):
                pk, al, mu_, pm, gp = w(i)
                if kname.endswith("_idx") or kname.endswith("_idx_dec"):
                    pk, al, mu_, pm, gp = stk(i)
                s_ = cur()
                if kname == "ternary_matmul_dec":
                    rc = fdec.pt2_ternary_matmul_dec(P(xn), P(pk), P(al), P(mu_), P(part), P(out),
                                                     P(cnt_f), B, Kf, nf, 128, dsp, mode, dix, s_)
                elif kname == "ternary_matmul":
                    rc = fcc.pt2_ternary_matmul(P(xn), P(pk), P(al), P(mu_), P(out), B, Kf, nf,
                                                128, mode, dix, s_)
                elif kname == "ternary_matmul_tc_a8":
                    fn_ = (ftc.pt2_ternary_matmul_tc_a8_floor if mode == 2
                           else ftc.pt2_ternary_matmul_tc_a8)
                    rc = fn_(P(xn), P(pk), P(al), P(mu_), P(xq), P(isums), P(out), B, 128, Kf, nf,
                             128, dix, s_)
                elif kname == "ternary_matmul_igathered_dec":
                    rc = fdec.pt2_ternary_matmul_dec_igathered(
                        P(xn), P(pm), P(pk), P(al), P(mu_), P(part), P(out), P(cnt_f), B, Kf, Kf,
                        nf, 128, dsp, mode, dix, s_)
                elif kname == "ternary_matmul_igathered":
                    rc = fcc.pt2_ternary_matmul_igathered(P(xn), P(pm), P(pk), P(al), P(mu_),
                                                          P(out), B, Kf, Kf, nf, 128, mode, dix, s_)
                elif kname == "ternary_matmul_igathered_tc":
                    rc = figtc.pt2_ternary_matmul_igathered_tc(
                        P(xn), P(pm), P(pk), P(al), P(mu_), P(xg), P(sums), P(part), P(out),
                        P(cnt_f), B, Kf, Kf, nf, 128, isp, mode, dix, s_)
                elif kname == "ternary_matmul_gathered_dec":
                    rc = fgd.pt2_ternary_matmul_gathered_dec(
                        P(xn), P(gp), P(pk), P(al), P(mu_), P(xg), P(part), P(out), P(cnt_f), B,
                        Kf, D4f, Kf, nf, dsp, mode, dix, s_)
                elif kname == "ternary_matmul_gathered":
                    rc = fgc.pt2_ternary_matmul_gathered(P(xn), P(gp), P(pk), P(al), P(mu_),
                                                         P(part), P(out), B, Kf, D4f, Kf, nf, mode,
                                                         dix, s_)
                elif kname == "ternary_matmul_gathered_tc":
                    rc = fgt.pt2_ternary_matmul_gathered_tc(
                        P(xn), P(gp), P(pk), P(al), P(mu_), P(xg), P(sums), P(part), P(out),
                        P(cnt_f), B, Kf, D4f, Kf, nf, isp, mode, dix, s_)
                elif kname == "ternary_matmul_idx_dec":
                    rc = fdec.pt2_ternary_matmul_dec_idx(
                        P(xn), P(pk), P(al), P(mu_), P(part), P(out), P(cnt_f), P(sel_f), 0, Sf, B,
                        Kf, nf, 128, dsp, mode, dix, s_)
                elif kname == "ternary_matmul_idx":
                    rc = fcc.pt2_ternary_matmul_idx(P(xn), P(pk), P(al), P(mu_), P(out), P(sel_f),
                                                    0, Sf, B, Kf, nf, 128, mode, dix, s_)
                elif kname == "ternary_matmul_igathered_idx_dec":
                    rc = fdec.pt2_ternary_matmul_dec_igathered_idx(
                        P(xn), P(pm), P(pk), P(al), P(mu_), P(part), P(out), P(cnt_f), P(sel_f), 0,
                        Sf, B, Kf, Kf, nf, 128, dsp, mode, dix, s_)
                elif kname == "ternary_matmul_igathered_idx":
                    rc = fcc.pt2_ternary_matmul_igathered_idx(
                        P(xn), P(pm), P(pk), P(al), P(mu_), P(out), P(sel_f), 0, Sf, B, Kf, Kf, nf,
                        128, mode, dix, s_)
                elif kname == "ternary_matmul_gathered_idx_dec":
                    rc = fgd.pt2_ternary_matmul_gathered_dec_idx(
                        P(xn), P(gp), P(pk), P(al), P(mu_), P(xg), P(part), P(out), P(cnt_f),
                        P(sel_f), 0, Sf, B, Kf, D4f, Kf, nf, dsp, mode, dix, s_)
                else:  # ternary_matmul_gathered_idx
                    rc = fgc.pt2_ternary_matmul_gathered_idx(
                        P(xn), P(gp), P(pk), P(al), P(mu_), P(part), P(out), P(sel_f), 0, Sf, B,
                        Kf, D4f, Kf, nf, mode, dix, s_)
                ok(rc, f"{kname} (a8 mode {mode})")

            base_name = kname.replace("_dec", "").replace("_tc_a8", "").replace("_tc", "")
            plain = {"ternary_matmul": k1.ternary_matmul_floor_plain,
                     "ternary_matmul_idx": k1.ternary_matmul_floor_plain,
                     "ternary_matmul_igathered": k1.ternary_matmul_igathered_floor_plain,
                     "ternary_matmul_igathered_idx": k1.ternary_matmul_igathered_floor_plain,
                     "ternary_matmul_gathered": k1.ternary_matmul_gathered_floor_plain,
                     "ternary_matmul_gathered_idx": k1.ternary_matmul_gathered_floor_plain}[
                base_name]
            extra = (lambda l_: (l_[3],)) if "igathered" in kname else (
                (lambda l_: (l_[4],)) if "gathered" in kname else (lambda l_: ()))
            fl_ms = graph_ms(lambda i: call(i, 2))
            a8_ms = graph_ms(lambda i: call(i, 1))
            pl_ms = time_ms(lambda i: plain(x, *extra(w(i)), *w(i)[:3]), 3)
            nbytes = (wbytes + 2 * B * Kf + 4 * B * nf + (4 * Kf if "igathered" in kname else 0)
                      + (D4f * Kf if "gathered" in kname and "igathered" not in kname else 0))
            ops = 2.0 * B * Kf * nf
            b_ms, b_by = bound(nbytes, ops, int8_peak if kname == "ternary_matmul_tc_a8"
                               else bf16_peak)
            d = {"kernel": f"{kname}_floor", "shape": "llama-3-8b qkv", "B": B, "ms": fl_ms,
                 "a8_ms": a8_ms, "plain_ms": pl_ms, "library_ms": int_mm_f, "bytes": nbytes,
                 "bound_ms": b_ms, "bound_by": b_by}
            floor_timing.append(d)
            print(f"floor {kname} B={B}: FLOOR instance {fl_ms * 1e3:.2f} us, its W2A8 (unpack) "
                  f"instance {a8_ms * 1e3:.2f} us ({100 * (a8_ms - fl_ms) / a8_ms:.1f} % of it "
                  f"the unpack's), plain {pl_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}; "
                  f"{100 * b_ms / fl_ms:.1f} % of the floor's time) from CUDA graphs over "
                  f"{copies_f} copies on {record['smi']}")
        del x, xn, out, part, xg, sums, xq, isums
    del fl_layers, st_f
    torch.cuda.empty_cache()
    record["floor_timing"] = floor_timing

    # ---- the record: per kernel, one layer of one step of its main path
    # (K1's tensor-core kernels at the 512-row prefill, 4 projections, the
    # int8 one in W2A8 beside torch._int_mm and the int8 bound; K1's decode
    # kernel and its CUDA-core kernel (which decode rows take with the
    # decode kernel off) at B = 1, 4 projections; their launches: every
    # 32-layer run counted exactly;
    # K3 / K2 at B = 1 decode (K3's tensor-core path at B = 16, the
    # engine's smallest admission bucket); K4 and K5 at the 512-row prefill, 3
    # gathers; the CUDA-core K6 at B = 1, qkv + o; K7 at the engine's B = 8,
    # M = 2048 with a bf16 cache)
    def entry(name, source, replaces, rows, err, mult=1):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": err,
            "ms": mult * sum(d["ms"] for d in rows),
            "plain_ms": mult * sum(d["plain_ms"] for d in rows),
            "bound_ms": mult * sum(d["bound_ms"] for d in rows),
            "bound_by": "bytes" if all(d["bound_by"] == "bytes" for d in rows) else "operations",
            "library_ms": mult * sum(d["library_ms"] for d in rows),
        }

    b1 = lambda rows: [d for d in rows if d["B"] == 1]  # noqa: E731
    # K2's ungated launches (23d's opt-1.3b runs) by path, kept apart
    # from the gated MLP's
    ung = record["moe"]["ungated_k2"]
    ung_launches = {"ternary_mlp_dec_ungated": sum(r["launches"]["ternary_mlp_dec"]
                                                   for r in ung.values()),
                    "ternary_mlp_tc_ungated": sum(r["launches"]["ternary_mlp_tc"]
                                                  for r in ung.values()),
                    "ternary_mlp_ungated": ung["cuda_core"]["launches"]["ternary_mlp"]}
    if sum(ung_launches.values()) != run_totals["ternary_mlp_ungated"]:
        fail(f"K2's ungated launches {ung_launches} are not all of "
             f"{run_totals['ternary_mlp_ungated']}")
    # the CUDA-core K2's launches, silu and GeGLU: the llama and gemma-2b runs'
    # K2 launches on neither its decode nor its tensor-core path (since
    # K2's decode rows took the decode path, only 16b's "off" turns)
    main_launches["ternary_mlp_gelu"] = run_totals["ternary_mlp_gelu"] - sum(gelu_paths.values())
    main_launches["ternary_mlp"] = run_totals["ternary_mlp"] - sum(
        run_totals[k] for k in ("ternary_mlp_tc", "ternary_mlp_dec")) - main_launches[
        "ternary_mlp_gelu"] - ung_launches["ternary_mlp_ungated"]
    main_launches["ternary_matmul_dec"] = run_totals["ternary_matmul_dec"]
    main_launches["ternary_matmul"] = run_totals["ternary_matmul"] - sum(
        run_totals[k] for k in ("ternary_matmul_tc", "ternary_matmul_tc_a8", "ternary_matmul_dec"))
    main_launches["ternary_matmul_gathered"] = run_totals["ternary_matmul_gathered"] - sum(
        run_totals[k] for k in ("ternary_matmul_gathered_dec", "ternary_matmul_gathered_tc"))
    # K4's first kernel: the 512-row "ssr" prefill A/B's "off" turns and its
    # greedy_generate with K4 off (20b); its rows path: every other "ssr"
    # prefill under the default flags
    main_launches["onehot_gather_rows"] = run_totals["onehot_gather_rows"]
    main_launches["onehot_gather"] = run_totals["onehot_gather"] - run_totals["onehot_gather_rows"]
    # K5's first kernel: the P1 prefill A/B's "off" turns (18b); its rows
    # path: every P1 / P2 prefill and run E's admissions above 64 rows
    main_launches["onehot_matmul_rows"] = run_totals["onehot_matmul_rows"]
    main_launches["onehot_matmul"] = run_totals["onehot_matmul"] - run_totals["onehot_matmul_rows"]
    kernels = [
        entry("ternary_matmul", "pt2tpu_torch/csrc/ternary_matmul.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1354", b1(detail), max_err),
        entry("ternary_matmul_dec", "pt2tpu_torch/csrc/ternary_matmul_dec.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1354", b1(dec_detail), dec_err),
        entry("ternary_matmul_tc", "pt2tpu_torch/csrc/ternary_matmul_tc.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1354", [d for d in tc_detail if d["B"] == 512],
              tc_err),
        entry("ternary_matmul_tc_a8", "pt2tpu_torch/csrc/ternary_matmul_tc_a8.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1354",
              [d for d in tc_a8_detail if d["B"] == 512], a8_err),
        entry("ternary_mlp", "pt2tpu_torch/csrc/ternary_mlp.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1106", b1(k2_detail), errs["ternary_mlp"]),
        entry("ternary_matmul_igathered", "pt2tpu_torch/csrc/ternary_matmul.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:735", b1(k3_detail),
              max(errs["ternary_matmul_igathered"], k3cc_err)),
        entry("onehot_gather", "pt2tpu_torch/csrc/onehot_gather.cu",
              "pt2tpu/ops/kernels/pallas_gather.py:239",
              [d for d in k4_detail if d["B"] == 512], errs["onehot_gather"], mult=3),
        entry("decode_attention", "pt2tpu_torch/csrc/decode_attention_tc.cu",
              "pt2tpu/ops/kernels/pallas_attention.py:249",
              [d for d in record["k7_timing"] if d["shape"] == "bf16"], errs["decode_attention"]),
        entry("onehot_matmul", "pt2tpu_torch/csrc/onehot_matmul.cu",
              "pt2tpu/ops/kernels/pallas_gather.py:127",
              [d for d in k5_detail if d["B"] == 512], errs["onehot_matmul"], mult=3),
        entry("ternary_matmul_gathered", "pt2tpu_torch/csrc/ternary_matmul_gathered.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:443", b1(k6_detail),
              errs["ternary_matmul_gathered"]),
    ]
    # the gemma slice's instances: K2 GeGLU at gemma-2b's MLP, B = 1; K7 at
    # its heads, B = 8, M = 2048, bf16 cache; their launches: every gemma-2b
    # run counted exactly
    main_launches["decode_attention_hd256"] = run_totals["decode_attention_hd256"]
    kernels += [
        entry("ternary_mlp_gelu", "pt2tpu_torch/csrc/ternary_mlp.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1106", b1(k2g_detail),
              errs["ternary_mlp_gelu"]),
        entry("decode_attention_hd256", "pt2tpu_torch/csrc/decode_attention_tc.cu",
              "pt2tpu/ops/kernels/pallas_attention.py:249",
              [d for d in record["k7_gemma_timing"] if d["shape"] == "bf16"],
              errs["decode_attention_hd256"]),
    ]
    # PR 3's K7 (K7_TC off) at llama-3-8b's heads, B = 8, M = 2048, bf16
    # cache; its launches: 19b's "off" turns, counted exactly
    main_launches["decode_attention_cc"] = k7_cc_launches[0]
    kernels.append(entry("decode_attention_cc", "pt2tpu_torch/csrc/decode_attention.cu",
                         "pt2tpu/ops/kernels/pallas_attention.py:249",
                         [d for d in record["k7_cc_timing"]
                          if d["kernel"] == "K7 PR 3" and d["shape"] == "bf16"],
                         errs["decode_attention_cc"]))
    # K3's tensor-core path at B = 16 (the engine's smallest admission
    # bucket), bf16, qkv + o; its launches: every engine run counted exactly
    main_launches["ternary_matmul_igathered_tc"] = run_totals["ternary_matmul_igathered_tc"]
    kernels.append(entry("ternary_matmul_igathered_tc",
                         "pt2tpu_torch/csrc/ternary_matmul_igathered_tc.cu",
                         "pt2tpu/ops/kernels/pallas_ternary.py:735",
                         [d for d in k3tc_detail if d["B"] == 16 and not d["a8"]],
                         max(k3tc_err, errs["ternary_matmul_igathered_tc"])))
    # K3's decode path at B = 1, qkv + o; its launches: every 32-layer run
    # counted exactly
    main_launches["ternary_matmul_igathered_dec"] = run_totals["ternary_matmul_igathered_dec"]
    kernels.append(entry("ternary_matmul_igathered_dec", "pt2tpu_torch/csrc/ternary_matmul_dec.cu",
                         "pt2tpu/ops/kernels/pallas_ternary.py:735", b1(k3dec_detail),
                         max(k3dec_err, errs["ternary_matmul_igathered_dec"])))
    # K2's tensor-core path at 16 rows (the engine's smallest admission
    # bucket), llama-3-8b's MLP with its gather; its launches: every engine
    # run counted exactly (GeGLU ones included)
    main_launches["ternary_mlp_tc"] = (run_totals["ternary_mlp_tc"]
                                       - ung_launches["ternary_mlp_tc_ungated"])
    kernels.append(entry("ternary_mlp_tc", "pt2tpu_torch/csrc/ternary_mlp_tc.cu",
                         "pt2tpu/ops/kernels/pallas_ternary.py:1106",
                         [d for d in k2tc_detail if d["B"] == 16 and d["shape"] == "llama-3-8b"],
                         max(k2tc_err, errs["ternary_mlp_tc"])))
    # K2's decode path at B = 1, llama-3-8b's MLP with its gather; its
    # launches: every llama and gemma-2b run counted exactly (GeGLU ones
    # included)
    main_launches["ternary_mlp_dec"] = (run_totals["ternary_mlp_dec"]
                                        - ung_launches["ternary_mlp_dec_ungated"])
    kernels.append(entry("ternary_mlp_dec", "pt2tpu_torch/csrc/ternary_mlp_dec.cu",
                         "pt2tpu/ops/kernels/pallas_ternary.py:1106",
                         [d for d in k2dec_detail if d["B"] == 1 and d["shape"] == "llama-3-8b"],
                         max(k2dec_err, errs["ternary_mlp_dec"])))
    # K6's decode path at B = 1 and its tensor-core path at B = 16 (the
    # engine's smallest admission bucket), bf16, qkv + o; their launches:
    # every P2 run counted exactly. The CUDA-core K6's own launches: the P2
    # runs' W2A8 decode rows and the A/B's "off" turns
    for k in ("ternary_matmul_gathered_dec", "ternary_matmul_gathered_tc"):
        main_launches[k] = run_totals[k]
    kernels.append(entry("ternary_matmul_gathered_dec",
                         "pt2tpu_torch/csrc/ternary_matmul_gathered_dec.cu",
                         "pt2tpu/ops/kernels/pallas_ternary.py:443", b1(k6dec_detail),
                         k6dec_err))
    kernels.append(entry("ternary_matmul_gathered_tc",
                         "pt2tpu_torch/csrc/ternary_matmul_gathered_tc.cu",
                         "pt2tpu/ops/kernels/pallas_ternary.py:443",
                         [d for d in k6tc_detail if d["B"] == 16], k6tc_err))
    # K5's rows path at the 512-row prefill, 3 gathers
    kernels.append(entry("onehot_matmul_rows", "pt2tpu_torch/csrc/onehot_matmul_rows.cu",
                         "pt2tpu/ops/kernels/pallas_gather.py:127",
                         [d for d in k5rows_detail if d["B"] == 512], errs["onehot_matmul_rows"],
                         mult=3))
    # K4's rows path at the 512-row prefill, 3 gathers
    kernels.append(entry("onehot_gather_rows", "pt2tpu_torch/csrc/onehot_gather_rows.cu",
                         "pt2tpu/ops/kernels/pallas_gather.py:239",
                         [d for d in k4rows_detail if d["B"] == 512], errs["onehot_gather_rows"],
                         mult=3))
    # K1s / K3s, the device-index entries (phase 23): one expert of one
    # layer at B = 1, its gateup and down (K3s: gateup with its gather),
    # bf16 on the decode kernel, W2A8 on the CUDA cores; their launches:
    # every lockstep decode row of phase 23's runs, counted exactly
    for name, src in (("ternary_matmul_idx", "ternary_matmul"),
                      ("ternary_matmul_igathered_idx", "ternary_matmul_igathered")):
        main_launches[f"{name}_dec"] = run_totals[f"{name}_dec"]
        main_launches[name] = run_totals[name] - run_totals[f"{name}_dec"]
        replaces = ("pt2tpu/ops/kernels/pallas_ternary.py:805" if "igathered" in name
                    else "pt2tpu/ops/kernels/pallas_ternary.py:316")
        for kname, source in ((f"{name}_dec", "pt2tpu_torch/csrc/ternary_matmul_dec.cu"),
                              (name, "pt2tpu_torch/csrc/ternary_matmul.cu")):
            kernels.append(entry(kname, source, replaces,
                                 [d for d in record["moe"]["timing"] if d["kernel"] == kname],
                                 record["moe"]["per_call"]["max_rel_err"][name]))
    # K4s (its rows path and its first kernel) and K5s at mixtral's gateup
    # gather, K6s's decode path (bf16) and CUDA-core kernel (W2A8) at its
    # gateup, B 1; their launches: 23d's routed decode runs under
    # G4 / G5 / P2 (K4s's first kernel: the run with K4's rows path off),
    # counted exactly
    main_launches["onehot_gather_rows_idx"] = run_totals["onehot_gather_idx_rows"]
    main_launches["onehot_gather_idx"] = (run_totals["onehot_gather_idx"]
                                          - run_totals["onehot_gather_idx_rows"])
    main_launches["onehot_matmul_idx"] = run_totals["onehot_matmul_idx"]
    main_launches["ternary_matmul_gathered_idx_dec"] = run_totals["ternary_matmul_gathered_idx_dec"]
    main_launches["ternary_matmul_gathered_idx"] = (
        run_totals["ternary_matmul_gathered_idx"] - run_totals["ternary_matmul_gathered_idx_dec"])
    gerr = record["moe"]["per_call_gather"]["max_rel_err"]
    for kname, source, replaces, err in (
            ("onehot_gather_rows_idx", "onehot_gather_rows.cu", "pallas_gather.py:274",
             gerr["onehot_gather_idx"]),
            ("onehot_gather_idx", "onehot_gather.cu", "pallas_gather.py:274",
             gerr["onehot_gather_idx"]),
            ("onehot_matmul_idx", "onehot_matmul.cu", "pallas_gather.py:330",
             gerr["onehot_matmul_idx"]),
            ("ternary_matmul_gathered_idx_dec", "ternary_matmul_gathered_dec.cu",
             "pallas_ternary.py:534", gerr["ternary_matmul_gathered_idx"]),
            ("ternary_matmul_gathered_idx", "ternary_matmul_gathered.cu", "pallas_ternary.py:534",
             gerr["ternary_matmul_gathered_idx"])):
        kernels.append(entry(kname, f"pt2tpu_torch/csrc/{source}",
                             f"pt2tpu/ops/kernels/{replaces}",
                             [d for d in record["moe"]["timing"] if d["kernel"] == kname], err))
    # K2's ungated mode at opt-1.3b's MLP: its decode path at B 1, its
    # tensor-core path at B 16, its CUDA-core kernel at B 1; their
    # launches: 23d's ungated opt-1.3b runs, counted exactly
    main_launches.update(ung_launches)
    for kname, source in (("ternary_mlp_dec_ungated", "ternary_mlp_dec.cu"),
                          ("ternary_mlp_tc_ungated", "ternary_mlp_tc.cu"),
                          ("ternary_mlp_ungated", "ternary_mlp.cu")):
        kernels.append(entry(kname, f"pt2tpu_torch/csrc/{source}",
                             "pt2tpu/ops/kernels/pallas_ternary.py:1106",
                             [d for d in record["moe"]["timing"]
                              if d["kernel"] == kname and d["shape"] == "opt-1.3b"],
                             record["moe"]["per_call_ungated"]["max_rel_err"]))
    # the floor probe's FLOOR instances (phase 24): each at llama-3-8b's qkv,
    # B 1 (decode kernels, CUDA cores) or 16 (tensor-core paths); their
    # launches: every floor8 run of 23d and 24b, counted exactly (equal to
    # a8's); no library call computes the floor (its yardstick, the W2A8
    # instance's time, is in record["floor_timing"])
    floor_src = {"ternary_matmul_dec": "ternary_matmul_dec.cu", "ternary_matmul": "ternary_matmul.cu",
                 "ternary_matmul_tc_a8": "ternary_matmul_tc_a8.cu",
                 "ternary_matmul_igathered_dec": "ternary_matmul_dec.cu",
                 "ternary_matmul_igathered": "ternary_matmul.cu",
                 "ternary_matmul_igathered_tc": "ternary_matmul_igathered_tc.cu",
                 "ternary_matmul_gathered_dec": "ternary_matmul_gathered_dec.cu",
                 "ternary_matmul_gathered": "ternary_matmul_gathered.cu",
                 "ternary_matmul_gathered_tc": "ternary_matmul_gathered_tc.cu",
                 "ternary_matmul_idx_dec": "ternary_matmul_dec.cu",
                 "ternary_matmul_idx": "ternary_matmul.cu",
                 "ternary_matmul_igathered_idx_dec": "ternary_matmul_dec.cu",
                 "ternary_matmul_igathered_idx": "ternary_matmul.cu",
                 "ternary_matmul_gathered_idx_dec": "ternary_matmul_gathered_dec.cu",
                 "ternary_matmul_gathered_idx": "ternary_matmul_gathered.cu"}
    for d in record["floor_timing"]:
        inst = d["kernel"][: -len("_floor")]
        kernels.append({"name": d["kernel"], "route": "cuda",
                        "source": f"pt2tpu_torch/csrc/{floor_src[inst]}",
                        "replaces": "pt2tpu/ops/kernels/pallas_ternary.py:112",
                        "launches": record["floor"]["launches"][inst],
                        "max_abs_err": record["floor"]["per_call"]["max_abs_err"][inst],
                        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                        "bound_by": d["bound_by"], "library_ms": d["library_ms"]})
    # K2's floor probe (phase 27): each path's FLOOR instance at llama-3-8b's
    # MLP with its gather, B 1 (decode path), 16 (tensor-core path) or 8 (the
    # CUDA cores, whose FLOOR instance has 8-row tiles only); its launches: 27a's direct fused_mlp_apply(impl="floor8") calls,
    # counted exactly; no library call computes the floor (its yardstick, the
    # bf16 instance of the same path, is in record["k2_floor"]["timing"])
    k2_floor_src = {"ternary_mlp_dec_floor": "ternary_mlp_dec.cu",
                    "ternary_mlp_tc_floor": "ternary_mlp_tc.cu", "ternary_mlp_floor": "ternary_mlp.cu"}
    for d in record["k2_floor"]["timing"]:
        kernels.append({"name": d["kernel"], "route": "cuda",
                        "source": f"pt2tpu_torch/csrc/{k2_floor_src[d['kernel']]}",
                        "replaces": "pt2tpu/ops/kernels/pallas_ternary.py:1106",
                        "launches": record["k2_floor"]["launches"][d["kernel"]],
                        "max_abs_err": record["k2_floor"]["max_abs_err"][d["kernel"]],
                        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                        "bound_by": d["bound_by"], "library_ms": d["library_ms"]})
    # K7 at hd 384 and 512 (phase 25), both kernels, at 8 / 2 KV heads, B 8,
    # M 2048, bf16 cache; their launches: 25b's engine runs, counted exactly
    main_launches.update(record["k7_wide"]["launches"])
    for hd_w in WIDE_HEAD_DIMS:
        kernels.append(entry(f"decode_attention_hd{hd_w}", "pt2tpu_torch/csrc/decode_attention_tc.cu",
                             "pt2tpu/ops/kernels/pallas_attention.py:249",
                             [d for d in record[f"k7_hd{hd_w}_timing"] if d["shape"] == "bf16"],
                             errs["decode_attention_wide"]))
        kernels.append(entry(f"decode_attention_cc_hd{hd_w}", "pt2tpu_torch/csrc/decode_attention.cu",
                             "pt2tpu/ops/kernels/pallas_attention.py:249",
                             [d for d in record["k7_cc_timing"]
                              if d["kernel"].startswith(f"K7hd{hd_w} ") and d["shape"] == "bf16"],
                             errs["decode_attention_cc_wide"]))
    # K7's wide instance (phase 30), both kernels, at 8 / 2 KV heads, B 8,
    # M 2048, bf16 cache; their launches: 30b's engine runs, counted exactly
    main_launches.update(record["k7_wide_rt"]["launches"])
    for hd_w, cc in ((640, False), (1024, False), (1024, True)):
        kernels.append(entry(f"decode_attention{'_cc' if cc else ''}_wide_rt_hd{hd_w}",
                             "pt2tpu_torch/csrc/decode_attention.cu" if cc
                             else "pt2tpu_torch/csrc/decode_attention_tc.cu",
                             "pt2tpu/ops/kernels/pallas_attention.py:249",
                             [d for d in (record["k7_cc_timing"] if cc
                                          else record[f"k7_hd{hd_w}_timing"])
                              if d["kernel"].startswith(f"K7hd{hd_w}") and d["shape"] == "bf16"],
                             errs["decode_attention_cc_wide_rt" if cc
                                  else "decode_attention_wide_rt"]))
    record["kernels"] = kernels
    record["launches_all_runs"] = run_totals
    print(f"launches over every run counted exactly: {run_totals}")
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        fail(f"no launch on the main paths for {idle}")
    record["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"chip_smoke: all phases passed in {record['total_s']:.1f} s after start-up; phases "
          f"began at (s) " + ", ".join(f"{k} {v:.0f}" for k, v in record["phase_start_s"].items()))
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--tp-rank":
        tp_rank_main(sys.argv[2:])
    else:
        main()
