#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`ldpc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: requires a CUDA device (never runs on the CPU) and prints the
   card's `nvidia-smi` name and power limit;
2. build: compiles the four kernel libraries fresh with nvcc for sm_90a,
   at the same time (`microbench.cu`: the six microbenchmark kernels S1-S6;
   `minsum_flood.cu`: K1/K1-IO, K2, K5 flooding and the flooding K1-MC
   instances, in the packed kernel `flood_packed_kernel`; `minsum_layered.cu`:
   K3, K5 layered and the layered K1-MC instances, in the packed kernel
   `layered_packed_kernel`; each packed kernel wherever a block of four
   lanes fits (min* up to rows of 24), else its two-lane instance
   (`flood_two_lane_kernel`, `layered_two_lane_kernel`, since slice 12)
   where a block of two fits, the one-lane template elsewhere; each
   decoder libraries each build as three units at once; both
   include
   `cn_minstar.cuh`, the min* update K5 that doubles their instances,
   `cn_packed.cuh` (the packed parts both libraries share), `mc_stage.cuh`
   and `philox.cuh`; `minsum_stream.cu`: the streaming layered decoders
   that answer K6b-K6f, the pipelined kernel, the packed resident kernel
   and the template they began with), and prints each build's time and
   ptxas' register/spill report,
   and `cuobjdump -sass` counts of the packed flooding instances (K1
   beside K2 and K5's loops), of the
   packed layered instances of the main paths beside the one-lane
   template's (their layer loops) and of every streaming instance (the
   pipelined kernel's and the packed resident kernel's layer loops beside
   the template's);
3. kernel vs plain: each CUDA kernel against its plain torch version on
   the card, tolerance 0 on every output (an integer program), and every
   decoder a sweep launches below at that sweep's batch, B=16,384.
   Flooding, fixed iterations (K1, K1-IO): 802.11n n=648 at B=16,384 in
   hard-output and fused-IO modes, offset beta=2, normalized alpha=3/4,
   n=1944 rate 3/4. Flooding with early termination (K2, in the packed
   kernel): n=648 at 2.0 dB fused-IO B=16,384, min-sum and
   `wifi-648-oms-flood-et`'s decoder (OMS beta=2), offset beta=2 with
   max_iter 1, at the ragged batches 1, 3, 5, 4,099, 16,385, 6 bits, NMS,
   n=1944 rate 3/4 and 5/6, the (3,30) array code (rows read twice) and NR
   BG1 Z=384 (two lanes a thread); with K5 flooding, ET and fixed, at
   the same ragged batches and n=1944, max_iter 1, T=(), min* on rows of 30
   and on DVB-S2 n=16,200 (two lanes a thread). Layered (K3): n=1944
   rate 5/6 OMS at 3.0 dB fused-IO B=16,384 with early termination, the
   same code at 20 fixed iterations with B=4,099, n=648 normalized
   alpha=3/4 with max_iter 7, and n=1944 rate 3/4 OMS with early
   termination on the 16-QAM chain's own LLRs at 5.5 dB, B=16,384 (slice
   4b's decoder). An all-zero noiseless batch through K2 and K3 must give
   iters 0 and converged on every lane. min* (K5), the same way: n=648
   layered with early termination at 2.0 dB fused-IO B=16,384 (slice 4a's
   decoder), layered fixed-20 hard, flooding fixed-20 and flooding with
   early termination fused-IO B=16,384 (the latter the flooding min*
   sweep's decoder), flooding with early termination hard; n=1944 rate
   5/6 (row degree 20) layered with early termination fused-IO and
   flooding fixed hard; thresholds T=(8,3,0), T=() (scale 0.5) and a
   6-bit quantizer on both codes; all-zero batches. The packed layered
   instance besides: K3 (n=1944 rate 5/6 OMS with early termination) and
   K5 (n=648 layered with early termination) at the ragged and tiny
   batches 1, 3, 5, 4,099, 16,385; fixed-20 K3 fused-IO at B=16,384 (the
   20-entry register row), on n=1944 rate 3/4 (the 16-entry row) and on
   n=648 hard; fixed-20 K5 fused-IO at B=16,384; the (3,30) array code
   layered (rows of 30: the row read twice), and min* on it (the one-lane
   template); the one-lane template's min-sum family on NR BG1 Z=384 rate
   1/3 (no block of two lanes fits), flooding min-sum and layered OMS,
   fixed-20 and with early termination, B = 3 and 5; every case's packed
   launches are counted, one exactly when its decoder is packed;
4. K1-MC kernel vs plain, tolerance 0 on the four per-lane outputs
   (then slice 12's two-lane instances, below);
   n=648 flooding fixed-20 at 2.0 dB with injected words and with Philox
   words, and n=1944 rate 5/6 layered OMS with early termination at
   3.5 dB (Philox), at B=16,384 (the batch of the rng=device steps); the
   per-lane-sigma form with the six sigmas of 1.0-3.5 dB at B=18,432 (the
   fused sweep's batch) against the plain version and, stripe by stripe,
   against the scalar form at each sigma and the same batch; the min*
   MC instances with injected words (n=648 layered, early termination)
   and with Philox (n=648 layered and flooding with early termination,
   the two instances the min* device-RNG sweeps launch, and flooding
   fixed-20), B=16,384, the flooding min* MC instance at B = 1, 3, 5,
   4,099 and with injected words at 5; K2's megakernel
   (`wifi-648-oms-flood-et` with rng=device) with injected words and
   Philox at B=16,384 and at the ragged batches, NMS at 4,099; the packed
   layered MC instances at B = 1, 3, 5 and 4,099 (n=1944 rate 5/6 OMS and n=648 min*, with early termination,
   Philox), fixed-20 at 4,099, and min* with injected words at 5; the
   flooding fixed-20 and the layered OMS ET instances at lane0 = 8,192
   (the first lane of rank 1 of slice 9b's two, B = 8,192), also == the
   second half of a launch of 16,384 lanes from lane 0; then the
   streaming library (K6b-K6f) against its
   plain version, tolerance 0 on hard bits, iters and conv, 10 iterations:
   DVB-S2 n=64,800 (B=32), n=16,200 (B=128) and NR BG1 Z=384 (B=64, its
   punctured variables at LLR 0), OMS beta=2 and NMS alpha=3/4, fixed and
   with early termination: the template's streamed placement, the
   pipelined kernel (NR BG1's rows of 22 at its 24-entry register row) and
   the resident instance (the packed resident kernel where its block fits,
   else the template), and on DVB-S2 n=64,800 rate 8/9 (B=32) and n=16,200
   rate 8/9 (B=64; rows of 27-28 at the pipelined kernel's 28-entry
   register row) and the (3,30) array code (B=64, rows of 30 at its
   32-entry row; LLRs of the all-zeros word), each code's set of instances
   stated (`STREAM_INSTANCES`), equal the plain version and each other, and K3
   behind its batch-first transposes where K3 admits the code; an odd
   batch (B - 1 codewords) and an all-zero noiseless batch (with early
   termination: iters 0). The packed resident kernel (K6d, K6e) on NR BG1
   Z=384, n=16,200 and n=16,200 rate 8/9, fixed and with early
   termination, at B = 1, 3, 5, 256 (two lanes a thread), 1,024 and 4,099
   (four lanes, the last block partial): its lanes follow the batch.
   Then every decoder a slice-5 sweep launches, as `select_decoder` builds it,
   at that sweep's batch on its step's own LLRs (n=64,800 at B=1,024 among
   them), and the pipelined instance at the CLI preset's batch of 8,192
   against the template's `stream-resident` instance (kernel against
   kernel: the plain version would take a quarter of a minute there). On
   the DVB-S2
   codes the C oracle (`ldpc_tpu_torch/oracle.py`, built with the system
   compiler) is the third witness: the first 8 frames of every instance's
   kernel output equal `oracle.decode_batch`. Then the microbenchmark
   library (`kernels/microbench.py`, S1-S6) against its plain versions,
   tolerance 0: the sweep with and without the shift at 44 sweeps (the
   int32 totals wrap) and the min-sum sweep with int32 and int16 messages
   at 20, at B = 512, 1,024, 1,001 and 16,384; the packed int16 expression
   on the script's inputs, on the int16 extremes and fed back 3 times, also
   against numpy; the int32 chain at 1, 2 and 4 elements a thread; `grid32`
   == `grid1` == plain at (27, 32 x 512) and at ragged shapes (1 and 26
   rows, 1, 3, 31 and 33 tiles, tiles of 100 and 13 columns, 400 steps and
   the runtime instance's 7: GRID1_SHAPES); the library's shared-memory
   size against the wrapper's. Then slice 10's decoders, each as
   `select_decoder` builds it for its sweep, at the sweep's batch, on the
   sweep's own input at its first point (`check_recorded_kernels`): K2 at
   3, 4, 5 and 6 bits (qmax 3-31, its in-kernel quantizer at scales 0.75,
   0.875, 1.25, 1.9375), the packed resident kernel's ET instance (K6e) on
   8PSK and 16APSK rate 2/3 LLRs of DVB-S2 n=16,200 at B=4,096, K3 behind
   its transposes on NR BG2 Z=128 rate 1/5 at B=4,096 and K3 fused-IO on
   802.11n n=1296 rates 1/2 and 3/4 and n=1944 rate 1/2; and slice 11b-11d's
   the same way (K3 fused-IO on the 802.11n set, 16-QAM at B=4,096, the
   check-node variants and the QC-PEG codes, K3 behind its transposes on
   the punctured 802.11n and PBRL codes; rows of 11 and 21-22 in the 16- and
   24-entry register rows), each instance once (`instance_of`, the batch)
   with its kernel instance and launch shape printed; then the demap of
   the seven modulations (`check_demap`): equal bits and standard-normal
   draws through modulate/AWGN/demap, batch first and batch last, on the
   card and on the CPU, equal symbols, quantized LLRs at most one LSB apart
   on at most 1e-4 of the entries. Then the entry point `python -m
   ldpc_tpu_torch.kernels.microbench`, driven in process for every variant
   at the reference's iteration counts (`rot`, `base`, `minsum`, `minsum16`
   at B = 512, 1,024 and 16,384; `int16`; `opshape`; `gridstep`), its JSON
   lines printed, with its launches counted from 0 and no plain call;
5. slices 1, 2, 4 and 5, one table (SLICES), one path: each row is a
   `Sweep(cfg, device="cuda", batch=..., decoder_backend=...).run(points)`
   (batch 16,384 and the route `auto` unless the row says otherwise) whose
   backend label must be the row's `expect` and whose launch counters,
   reset just before it, must show the route's kernel only (the
   schedule's on-chip library, its MC instance exactly with rng="device",
   min* launches exactly for min*, its packed instance exactly where a
   block of four or two lanes takes the code and the one-lane template
   elsewhere;
   or one instance of the streaming library, in its packed resident kernel
   exactly when the decoder is packed) and 0 plain calls; then each
   is held to its reference: FER and
   the converged rate by Wilson intervals (z=2.576), BER and average
   iterations by per-frame z-tests with the variances of batch 0,
   re-drawn (the bit-error variance from further batches, until they hold
   failed frames, where batch 0 holds no bit error).
   `wifi-648-r12-minsum` at 1.5, 2.0, 2.5 dB (32,768 frames a point)
   against `results/wifi648_minsum.json`; `wifi-full-oms` (AUTO
   two-phase) at 3.0 and 3.5 dB (131,072) against
   `results/wifi12_1944_r56.json`, and again with rng="device" (the
   layered K1-MC instance); `wifi-648-minstar` (the canonical code, 8-bit
   min*, layered, early termination, beta_lsb=0; 4a) at 1.5 and 2.0 dB
   against `results/cn_variants_minstar.json`, and `qam16-1944-chain`
   (preset `multihost-qam-chain` without its mesh: n=1944 rate 3/4, Gray
   16-QAM, OMS beta=2, layered, early termination; 4b) at 5.5 and 6.0 dB
   against `results/qam16_1944_r34_oms.json`, 131,072 frames a point; the
   other min* instances on their steps, 32,768 frames at 2.0 dB each: 4a
   with rng="device" (the layered min* MC instance) against the same
   file, and flooding min* with host and with device RNG, which no file
   records, each held to the other's rows; `wifi-648-oms-flood-et` (K2's
   main path: the canonical code, 8-bit offset min-sum beta_lsb=2,
   flooding, early termination, at most 20 iterations) at 1.0, 1.5 and
   2.0 dB (131,072 frames; the file has 16,384) and 2.5 dB (229,376, the
   file's), one run a point, against `results/wifi648_oms.json`, with host
   RNG and again with rng=device (K2's megakernel); their 8 BER and
   iteration rows at the family-wise z = 3.227 (the file's 1.0 dB point
   lies 2.3 of its standard errors below the reference package's own
   131,072-frame estimate). Slice 5, the batch-first step
   on long and rate-matched codes: `dvbs2-64800-r12-stream` (preset
   `dvbs2-64800-r12`: n=64,800, batch 1,024, 20 fixed iterations; 8,192
   frames at 1.0 and 1.25 dB against `results/dvbs2_r12_stream.json`) and
   `-stream-et` (early termination; 1.0, 1.25 and 1.5 dB against
   `results/dvbs2_64800_et.json`), through the pipelined kernel only;
   `dvbs2-16200-r12-resident-et` (16,384 frames at 1.4 and 2.2 dB against
   `results/dvbs2_16200_et.json`) on the route `auto` picks (the packed
   resident kernel's ET instance, four lanes a thread at this batch: no
   block of four lanes of K3 takes the code,
   `pipeline.stream_first`) and forced to K3 (backend "pallas": the
   two-lane instance behind transposes), equal counters on equal draws;
   `nr-bg1-z384-stream` (preset
   `nr-bg1-layered`, batch 256), which no file records: auto (the packed
   resident kernel, `pipeline.stream_first`), K3 forced (`pallas`: the
   two-lane instance behind transposes) and the plain QC decoder give
   equal counters on equal draws; NR BG1 Z=128 rate 1/3 with early termination against
   `results/nr_bg1_z128_r13.json` (32,768 frames at 0.5 and 1.0 dB);
   DVB-S2 n=64,800 rate 8/9 (rows of 27-28, which the pipelined kernel's
   28-entry register row takes: `stream-pipelined` and
   `stream-pipelined-et`, the pipelined kernel only), fixed and with
   early termination, batch 256, 512 frames at 3.0 and 3.5 dB, and DVB-S2
   n=16,200 rate 8/9 forced through the library (at batch 256 the
   pipelined kernel's 28-entry row too: the packed resident kernel would
   run two lanes a thread), 512 frames at 3.5 and 4.0 dB, each equal to
   the plain QC
   decoder's counters on equal draws. Slice 10, recorded configurations
   built from their files (`recorded_config`: a file's own `config` header,
   or the bit-width study as scripts/make_bits_study.py:40-60 builds it),
   each file's rows at the family-wise z of its rows (`family_z`): the
   study at 3-6 bits, 2.0-3.0 dB, 131,072 frames a point
   (`results/bits_wifi648.json`, `cuda-minsum`); DVB-S2 n=16,200 8PSK and
   16APSK rate 2/3 (`results/dvbs2_16200_8psk.json`, `_16apsk.json`, batch
   4,096, `cuda-stream-resident-et`); NR BG2 Z=128 rate 1/5
   (`results/nr_bg2_z128_r15.json`, batch 4,096,
   `cuda-minsum-layered-bf`); 802.11n n=1296 rates 1/2 and 3/4 and n=1944
   rate 1/2 OMS (`results/wifi1296_r12_oms.json`, `_r34_oms.json`,
   `wifi1944_r12_oms.json`, `cuda-minsum-layered`); the float decoders
   (`results/wifi648_oms_float.json`, `cn_variants_sp_float.json`,
   `cn_variants_oms_float.json`, `torch-float`), at the files' frame
   counts. Slice 11b-11d (`RECORDED_11`), every row of the file at its frame
   count and at the family-wise z of its rows, the BER variance at least
   the least either row allows (`least_bit_variance`): the 802.11n set
   (`results/wifi12_{648,1296,1944}_r{12,23,34,56}.json` but n=1944 r5/6,
   held in slice 2; `wifi1944_r56_oms.json`; `wifi1944_r34_16qam.json`, the
   unfused 16-QAM chain at its batch of 4,096), the check-node variants
   (`cn_variants_minsum`, `_nms_a34`, `_oms_b1`..`_b3`), the puncturing
   ladders (`rate_ladder_wifi648.r0.50`..`r0.75`, `pbrl_ladder.r0.50`..
   `r0.75`: `codes/rate_compat`, `codes/peg.pbrl_construct`) and the
   designed codes (`designed_648.qcpeg-uniform-4`, `.qcpeg-wifi-profile`,
   `.wifi648-standard`: `codes/peg`'s QC-PEG from the header's seed), batch
   16,384 (`cuda-minsum-layered`, `-bf` where rate matched).
   Then each sweep's decoder
   must be the instance (library, code, decoder and quantizer
   configuration, thresholds, IO mode, batch) that phases 3 and 4 held to
   its plain version;
6. slice 3: `Sweep(PRESETS["wifi-648-r12-minsum"] with rng="device",
   device="cuda", batch=18432).run_fused([1.0, ..., 3.5],
   target_frame_errors=300, max_frames=2_000_000)` through the flooding
   K1-MC instance only (0 plain calls), against
   `results/wifi648_fused_mc.json` at all six points (FER and converged
   rate by Wilson intervals, BER by the per-frame z-test, average
   iterations exactly 20), on the decoder instance that phase 4 checked;
   slice 10g, `results/wifi648_deep_tail.json` the same way under its own
   configuration and stop rule (3.5-5.0 dB, 100 frame errors, at most
   50,000,000 frames a point, batch 18,432: about 8,800 launches), its four
   rows at the family-wise z, each BER variance at least the least its own
   row allows (the file has no error at 4.5 and 5.0 dB);
   then slice 6, the hard-decision path (the port's counterpart of
   `scripts/make_hard_curve.py`): 802.11n n=648 rate 1/2 at full width,
   batch 2,048, 4,096 frames at each of p = 0.005, 0.01, 0.02, 0.03, 0.04,
   0.06: info bits -> encoder -> `channel.bsc` -> Gallager-B and
   bit-flipping (`ops/decode_hard`, 30 iterations, plain torch: the
   reference has no kernel there) and, over `bsc_llr` + `quantize`, the
   soft decoder that `select_decoder` gives (K1 behind the batch-first
   transposes, held to its plain version on a batch of these LLRs first;
   0 plain calls in the run); the (3,6)-regular array code on the
   all-zeros word. Every curve of `results/bsc_hard_wifi648.json` at all
   six p: FER by Wilson intervals, BER by the per-frame z-test (with
   this run's per-frame variance or, where larger, the least the file's
   row allows; the 36 rows share the 1% between them, z = 3.63);
7. CLI: `python -m ldpc_tpu_torch.cli sweep --preset wifi-648-r12-minsum
   --rng device --fused --ebn0 1.0:3.5:0.5 --batch 18432 --target-errors
   300 --max-frames 2000000 --out <tmp>` in a subprocess; its JSON
   counters must equal slice 3's;
   Then the long-codeword command lines: `sweep --preset dvbs2-64800-r12
   --ebn0 1.5 --max-frames 8192` (the streaming library, no frame error)
   and `sweep --puncture-frac 0.25` (K1 behind the batch-first step),
   whose counters must equal `--decoder-backend qc`'s;
8. slice 7, error floor (`sim/impsamp.py`, `analysis/`, the CLI's
   `floor`; `check_floor`), on `scripts/make_error_floor.py`'s
   normalized-min-sum configuration (802.11n n=648 rate 1/2, 8 bits,
   beta_lsb 0, layered, early termination, batch 8,192): harvest 131,072
   frames at 2.2 dB, refine and search the supports, the exact census
   (a <= 8, b <= 3, dv <= 3; its 2,295 absorbing sets must be the file's),
   64 supports at depths 1.2-2.4. 7a: one batch each of `make_is_run`,
   the stratified form and `make_symmetric_run` with injected draws, the
   decoder (`cuda-minsum-layered-bf`, K3's packed instance behind the
   batch-first transposes) == its plain version on the batch's own
   quantized LLRs and the sums == with tolerance 0, then the three runs
   launch the packed instance three times, nothing plain. 7b: MC
   (2,007,040 frames) and stratified IS (1,007,616 and 4,005,888) at 2.6
   and 3.0 dB, each row held to the file's by a two-sided z-test on the
   difference, both standard errors in quadrature, at z = 3.02 (four rows,
   1% family-wise), and IS to MC the same way; one launch an IS batch;
   the IS batch's host-clock time at 3.0 dB beside its pieces' CUDA-event
   times (chain, weights, decode with and without the transposes, tally)
   and the kernel's bound. 7c: plain MC through the IS chain on NR BG1
   Z=128 rate 1/3 (rate matching) at 0.5 dB, 65,536 frames, batch 4,096,
   against `results/nr_bg1_z128_r13.json` by Wilson intervals. 7d: `python
   -m ldpc_tpu_torch.cli floor` stratified with `--exact-sets 8,3,3` and
   with `--symmetric --seeds 1,2`, at small frame counts, one after the
   other: exit 0, the decoder label `cuda-`, the reference's JSON keys;
9. slice 8, the design funnel and the table registry (`analysis/de.py`,
   `exit.py`, `proto_de.py`, `codes/imported.py`, the CLI's `analyze`,
   `construct`, `import-standard`; `check_design`). 8a: `python -m
   ldpc_tpu_torch.cli analyze --preset wifi-648-r12-minsum`, and the DE
   rows of `results/de_thresholds.json` for OMS beta 1, min* and DVB-S2
   n=64,800 rate 1/2 with `scripts/make_de_thresholds.py`'s calls, each
   sigma* within 2 * tol = 4e-3 of the file's. 8b: PEXIT on NR BG1 Z=384
   rate 1/3 and DVB-S2 n=64,800 rate 1/2 within 4e-3 of
   `results/pexit_screen.json`'s production anchors. 8c: `construct
   --census 8,3,3` on wifi-648: girth 6, full rank, 2,295 absorbing sets.
   8d: `import-standard` into a temporary registry (each command line in a
   process of its own that prints its kernel counters after it): the
   port's own 802.11n n=648 rate 1/2 table, validated and smoke-decoded on
   the card by one launch of K3's packed layered kernel, nothing plain;
   the smoke decode's own batch of 128 then goes through K3 and its plain
   version in this process, equal with tolerance 0; under the registry
   the code is `ieee80211n_n648_r12_std`, and a sweep of two batches of
   4,096 at 2.0 dB on the card holds FER to `results/wifi648_minsum.json`;
   `--remove`. NR BG1 Z=384's full graph: `imported.smoke_decode` in this
   process, one launch of the streaming kernel `auto` picks and nothing
   plain, its batch held to plain the same way; the table stored with
   `imported.store` (its numpy validation, minutes of one host core, is
   held to the reference's on the CPU by tier-1), the `_std` code under
   `nr-bg1-layered`, a two-batch sweep, `--remove`. A table with a
   4-cycle exits 1 with REJECTED, and the default registry
   `imported_tables/` gains no file;
10. slice 9, the process mesh (`parallel/mesh.py`; `check_mesh`). 9a: a
   world of one rank over NCCL (TCP coordinator on localhost):
   `wifi-648-r12-minsum` at B = 16,384, host RNG, 2.0 dB, two batches,
   == the same `Sweep` with no process group, two K1-IO launches. 9b: two
   processes on the card over gloo (`chip_smoke.py --mesh-rank R 2
   HOST:PORT`), 8,192 lanes a rank: host RNG (K1-IO), rng=device (K1-MC,
   rank 1 from lane 8,192) and the two-point fused device-RNG sweep, each
   == this process's run, each rank two launches and nothing plain. 9c:
   `sweep --preset multihost-qam-chain --mesh 2x4 --num-processes 8
   --coordinator ... --process-id i`, eight processes on the card (gloo),
   the preset's batch of 4,096 (512 lanes a rank), three batches at
   5.5 dB: rank 0's JSON == the one-process run without --mesh, each
   rank's stderr line three packed K3 launches and nothing plain. 9d:
   `floor --mesh 2` (two processes from torchrun's environment) on
   wifi-648-nms-floor's configuration, two stratified IS batches at
   3.0 dB: frames and raw hits ==, FER, rel_std and BER within rtol 1e-6
   of one process. 9e: the step of 9a with and without the process group
   in turns, and the global draw's share of a rank's step at W = 1 and 2
   (host clock, median of 10, synced). 9f: `python -m
   ldpc_tpu_torch.parallel.dryrun --world 2 --device cuda` (the flagship
   step on K1-IO, the fused step and the streaming seam, a toy Z=8 code
   forced onto the streaming library, over a 1x2 mesh, each == one
   process), beside 9c and 9d. W ranks on one card share its SMs: no
   scaling is measured;
11. slice 11a, the deep floors, after slice 9. 11a.1
   (`hold_wifi_floor_sym`): `results/wifi_floor_sym.json`, the census's
   absorbing-orbit cover (`sim/floor_proposals.py`) at three depths,
   `make_symmetric_run` at B=8,192 on K3 behind its transposes (held to
   plain first), OMS beta 1 and NMS at 4.6 and 5.0 dB, seeds 31-33,
   2,097,152 frames each: each point's pooled seeds within family_z(4) of
   the file's (`floor_z`), three distinct estimates a point, seed 31 at
   5.0 dB again with equal counters. 11a.2 (`hold_nr_floor_sym`):
   `results/nr_floor_sym.json`'s MC anchors (4,096,000 frames at 1.2 and
   1.5 dB, K3 behind its transposes at B=16,384) by Wilson intervals, its
   symmetric 1.2 dB row through `python -m ldpc_tpu_torch.cli floor
   --symmetric --seeds 61,62` pooled against the 1.2 dB anchor, both at
   family_z(2). 11a.3 (`hold_dvb_floor_mc`): `results/dvb_floor_summary.json`
   at 1.2 dB, 999,424 frames of the all-zeros word on the streaming ET
   kernel (B=1,024), fails_info and fails_any by Wilson intervals. 11a.4
   (`hold_dvb_floor_sym`): the symmetric run on DVB-S2 n=64,800 with
   `results/dvb_floor_r5.json`'s proposal (109 orbits, 327 components) on
   the streaming ET kernel, one batch of injected draws == the plain QC
   route's (decoder outputs and tally), two seeds of 65,536 frames at
   1.3 dB finite. Slice 11d's soft BSC (`check_bsc_soft`) runs after slice
   6: `results/bsc_wifi648.json`'s eight p, 16,384 frames each, through
   `bsc` -> `bsc_llr` -> quantize -> K1 behind its transposes;
12. two-phase == single-phase counters on two batches of `wifi-full-oms`
   at 3.5 dB;
13. times: kernels with CUDA events (warm-up, median, plain and kernel in
   turns), each of the decoder object its main path launched and at that
   batch (run_fused's per-lane megakernel at 18,432, K3 of
   `qam16-1944-chain` on 16-QAM LLRs at 6.0 dB; K2 as the min-sum ET
   decoder at 2.0 dB, as `wifi-648-oms-flood-et` launched it and its
   megakernel as the device-RNG twin launched it); K5 beside the min-sum
   instance on the same inputs in turns (layered and flooding with early
   termination at 2.0 dB, layered and flooding fixed-20); steps with the
   host clock and a sync (info bits/s), the device-RNG steps against the
   host-RNG steps in turns, slice 4's steps with their decode kernel's
   share; the streaming library's kernels in turns (old, new, new, old;
   `probe_stream.in_turns`, the resident instance's kernels forced
   beside the instances) at n=64,800, n=16,200 (with K3 behind its
   transposes, fixed-20 and with early termination: the two-lane instance
   there since slice 12), B=1,024, fixed-20 and with early termination, NR BG1 Z=384 and
   n=16,200 rate 8/9 at B = 1,024 and 256 (with K3 behind its transposes;
   the mean of a block's most iterations beside the mean iterations; the
   packed resident kernel's operation and message-traffic bounds),
   n=64,800 rate 5/6 fixed-20, and n=64,800 rate 8/9 at B = 256 (slice
   5f's input) and 1,024, fixed-20 and with early termination (the
   pipelined kernel's 28-entry row beside the template's `stream`,
   `stream-et` it replaces on that route, with its bounds): what
   `minsum_stream.instance_auto` and
   `pipeline.stream_first` rest on; each instance as its sweep launched
   it (K6d as slice 5d launched it, beside K3 forced, K6e as slice 5c
   did; the template's
   `stream`, `stream-et` as a forced `resident=False` call on slice 5f's
   input launches them), and slice 5's steps with their kernel's share; the
   six
   microbenchmark kernels against their plain versions in turns, each at
   the shape the entry point gives it (the sweeps at B = 16,384 and the
   entry point's smaller iteration count, 200; the int32 chain at 2,000
   iterations, where its plain version takes a second), and the min-sum
   sweep's time a sweep beside K1's time an iteration. S3-S6 are also timed
   on the device alone (`utils.profiling.device_ms`: the host's dispatch
   hidden behind a spin kernel), printed beside their event times, and held
   to three floors beside the operation bound (`register_row`): the launch
   floor (an empty kernel of the call's grid, device-only), the
   integer-issue floor (each pipe's instructions a link of the chain, read
   from the kernel's main loop in `cuobjdump -sass`, over 64 lanes an SM a
   clock at `clocks.max.sm`) and the chain floor (one element's dependent
   instructions times the latency measured with clock64 on one thread's
   chain, `microbench.chain_probe`); the row's bound is the largest, and
   its record carries it (`floor_ms`, `floor_by`) beside the event time
   (`event_ms`). Slices 10 and 11b-11d's decoders, one for each (instance,
   batch) held to plain, on its first sweep's input, and the deep floors'
   and the soft BSC's decoders on the batch each was held to plain with,
   kernel against plain (one plain run a turn). Slice 12's forms
   (`kernels/probe_two_lane.py`'s cells at B = 1,024 on NR BG1 Z=384 and
   DVB-S2 n=16,200 r1/2: flooding min-sum, OMS and min*, layered OMS and
   min*, fixed-20 and with early termination) by events and on the device
   alone with each call's bound; the main paths' two-lane decoders against
   plain (the route cells, the other shapes and the parent's template:
   `python -m ldpc_tpu_torch.kernels.probe_two_lane`).

Slice 12 (the two-lane packed instances, `flood_two_lane_kernel` and
`layered_two_lane_kernel`: two lanes a thread, one block of Z threads,
where four lanes exceed a block's shared memory): every two-lane instance
== plain, tolerance 0 on every output, on NR BG1 Z=384, Z=256 and Z=128
rate 1/3 (flooding; its layered state takes four lanes) and DVB-S2
n=16,200 rates 1/2 and 8/9 (rows of 27-28: the row read twice; min* there
stays the one-lane template's, held too), both schedules, OMS fixed, OMS
with early termination in fused IO, min* fixed and with early termination,
at 6 iterations and B = 3, 1,000, 1,024 and 1,027, each against one plain
run of 1,027 lanes, and the megakernel at two lanes a thread refused on the
card (not built: no step reaches it) (`check_two_lane`); the one-lane
template where no block of two lanes fits (NR BG1 Z=384 rate 1/3: flooding
min-sum and layered OMS, fixed and with early termination, B = 3 and 5, no
packed launch) in the kernel-vs-plain phase;
then the CLI's main paths in process (`check_two_lane_cli`): `sweep
--preset nr-bg1-layered --schedule flooding --auto-two-phase` (OMS with
early termination) and `sweep --preset dvbs2-64800-r12 --n 16200
--algorithm min-star` (layered min*, 20 fixed iterations), batch 1,024, two
points, each with rng=host and rng=device (n > 4,096: the batch-first
chain, the host run's draws) launching the two-lane instance only, and
their counters equal to `--decoder-backend qc`'s.

Each kernel record carries `launches` of the main path named beside it
(K3's and the streaming kernel's that slice 8d's smoke decodes launched
also `smoke_decode_launches`),
the kernel template instance that path launched (`instance`; slice 10's
instances and the deep tail's launches have records of their own, named by
the kernel and the slice's file, `launched_by` the slice; slice 11b-11d's
one for each (instance, batch) they launched, named by its first file,
its sweeps' launches summed; the deep floors' and the soft BSC's one each;
the streaming library's records also name the path, `launched_by`: for the
template's `stream`, `stream-et` a forced `resident=False` call on slice
5f's input), and `ms`, `plain_ms`, `bound_ms` of the decoder that path
launched.
`bound_ms` is the least time the card could take for the timed call: the
larger of its bytes (every input tensor read once, every output written
once) over 3.35 TB/s and its integer operations over 67e12/s, the data
sheet's rate outside the tensor cores (the int32 units have half the
float32 lanes, so the true floor is higher). Operations are counted for
the iterations this call's lanes ran (the sum of the `iters` output): 12
per edge and iteration for the min-sum row (subtract, |.|, the clip, two
merges of min1/min2, the sign XOR to reduce; subtract, compare, select,
negate, store and the posterior update to emit), and for a min* row of
degree d, 3d - 6 combines of 12 + 4 * nthr operations plus 4 per edge.
`library_ms` is null: no single PyTorch call decodes an LDPC code, and
none computes a sweep over 88 shifted gathers or a dependent chain of
hundreds of integer steps. The microbenchmarks' operations are counted by
`kernels/microbench.py` (`sweep_cost` and the like: one add an entry, 12 an
edge, 6 a pair of chain statements, 4 a grid step); the arithmetic of the
bound itself is `utils.profiling.bound`.

Ends with one JSON line of kernel records, the nvidia-smi line, and, last,
the device line {"ok": true, "device": {"platform": "gpu", ...}}.
"""
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types
import typing

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
STARTED = time.perf_counter()
BATCH = 16384
MINSTAR_REF = "cn_variants_minstar.json"
STREAM_BATCH = 1024         # the long-codeword cells' batch


def family_z(rows):
    """The z of each of `rows` two-sided tests that share 1% (Bonferroni):
    a file's rows held at once fail a right port 1 time in 100, as one row
    at z = 2.576 would."""
    return statistics.NormalDist().inv_cdf(1 - 0.005 / rows)


class Slice(typing.NamedTuple):
    """One sweep of the main paths: `Sweep(cfg, device="cuda", batch=batch,
    decoder_backend=backend).run(points, max_frames=frames)`; with frames a
    tuple (one count a point), one run a point on the same sweep."""
    label: str
    what: str               # the configuration (see slice_config)
    schedule: typing.Optional[str]    # None: the configuration's own
    rng: str
    ref: str                # a file of results/ or another slice's label
    points: tuple
    frames: typing.Union[int, tuple]    # per point
    backend: str = "auto"   # the decoder route to force
    batch: int = BATCH
    expect: typing.Optional[str] = None     # the sweep's backend label
    equal_to: typing.Optional[str] = None   # a slice with the same draws
    z: float = 2.576        # of the per-frame z-tests (BER, iterations)
    # the BER test's variance at least the least either row allows
    # (`least_bit_variance`): a deep row may meet no failed frame in the
    # batches its variance is taken from
    least_row: bool = False


OMS_ET = "wifi-648-oms-flood-et"   # results/wifi648_oms.json's configuration
OMS_ET_Z = family_z(8)             # 3.227
# The bit-width study, results/bits_wifi648.json, has no config header: its
# configurations are built as scripts/make_bits_study.py:40-60 builds them,
# a width's LLR clip range (CLIP, :56) giving scale = qmax / clip and
# beta_lsb = max(1, round(0.5 * qmax / clip)); its rows hold 131,072 frames
# a point. A slice's `what` and `ref` name a width as "bits_wifi648.json:b".
BITS_REF = "bits_wifi648.json"
BITS_CLIP = {2: 2.0, 3: 4.0, 4: 8.0, 5: 12.0, 6: 16.0, 7: 24.0, 8: 31.75}
BITS_FRAMES = 131072
DEEP_TAIL = "wifi648_deep_tail.json"
# Slice 11b-11d: the rest of the recorded waterfalls, a sweep a file at
# every row of the file and its frame count (`recorded_slice`): (sub-slice,
# file stem, rate matched: the batch-first step). 11b, the 802.11n set (OMS
# beta 2 LSB, layered, early termination): n=648, 1296 and 1944 at rates
# 1/2-5/6, n=1944 rate 5/6's own file and rate 3/4 over 16-QAM; 11c, the
# check-node variants on n=648 (min-sum, NMS alpha 3/4, OMS beta 1-3 LSB);
# 11d, 802.11n n=648 punctured to rates 0.57-0.75 (`codes/rate_compat`), the
# PBRL family (n=756, Z=27, `codes/peg.pbrl_construct`) punctured to rates
# 0.50-0.75, and n=648 codes built by QC-PEG beside the standard's. The
# batch is 16,384, which divides every frame count; the 16-QAM file keeps
# its own 4,096.
QAM16_FILE = "wifi1944_r34_16qam"
RECORDED_11 = (
    *(("11b", f"wifi12_{n}_r{r}", False) for n in (648, 1296, 1944)
      for r in (12, 23, 34, 56) if (n, r) != (1944, 56)),
    ("11b", "wifi1944_r56_oms", False),
    ("11b", QAM16_FILE, False),
    *(("11c", f"cn_variants_{v}", False)
      for v in ("minsum", "nms_a34", "oms_b1", "oms_b2", "oms_b3")),
    *(("11d", f"rate_ladder_wifi648.r{r}", r != "0.50")
      for r in ("0.50", "0.57", "0.67", "0.75")),
    *(("11d", f"pbrl_ladder.r{r}", True)
      for r in ("0.50", "0.57", "0.67", "0.75")),
    *(("11d", f"designed_648.{c}", False)
      for c in ("qcpeg-uniform-4", "qcpeg-wifi-profile", "wifi648-standard")),
)


def read_ref(ref_name):
    """A recorded file's rows by Eb/N0 ("bits_wifi648.json:b": width b's)."""
    name, _, bits = ref_name.partition(":")
    with open(os.path.join(HERE, "results", name)) as f:
        d = json.load(f)
    rows = ([r for r in d["rows"] if r["bits"] == int(bits)] if bits
            else d["results"])
    return {r["ebn0_db"]: r for r in rows}


def recorded_slice(sub, name, bf):
    """Slice 11b-11d's sweep of results/<name>.json: every row at its frame
    count, held at the family-wise z of its rows; K3, fused IO or (rate
    matched) behind the batch-first transposes. A file whose rows share one
    frame count is one run over its points, as slices 1-10 are."""
    ref = read_ref(f"{name}.json")
    frames = tuple(r["frames"] for r in ref.values())
    return Slice(f"{sub} {name}", f"{name}.json", None, "host",
                 f"{name}.json", tuple(ref),
                 frames if len(set(frames)) > 1 else frames[0],
                 batch=4096 if name == QAM16_FILE else BATCH,
                 expect=("cuda-minsum-layered-bf" if bf
                         else "cuda-minsum-layered"),
                 z=family_z(len(ref)), least_row=True)


S64800, S16200 = "dvbs2-64800-r12-stream", "dvbs2-16200-r12-resident-et"
S89 = "dvbs2-64800-r89"     # rows of degree 27-28: the 28-entry register row
S1689 = "dvbs2-16200-r89"   # rows of 27-28, posteriors of 32 KB
NR384, NR128 = "nr-bg1-z384-stream", "nr-bg1-z128-r13"
SLICES = (
    Slice("wifi-648-r12-minsum", "wifi-648-r12-minsum", None, "host",
          "wifi648_minsum.json", (1.5, 2.0, 2.5), 32768),
    Slice("wifi-full-oms", "wifi-full-oms", None, "host",
          "wifi12_1944_r56.json", (3.0, 3.5), 131072),
    Slice("wifi-full-oms, MC", "wifi-full-oms", None, "device",
          "wifi12_1944_r56.json", (3.0, 3.5), 131072),
    Slice("4a wifi-648-minstar", "wifi-648-minstar", "layered", "host",
          MINSTAR_REF, (1.5, 2.0), 131072),
    Slice("4b qam16-1944-chain", "multihost-qam-chain", None, "host",
          "qam16_1944_r34_oms.json", (5.5, 6.0), 131072),
    Slice("4a wifi-648-minstar, MC", "wifi-648-minstar", "layered", "device",
          MINSTAR_REF, (2.0,), 32768),
    # flooding min* has no recorded waterfall: its host-RNG and device-RNG
    # runs are held to each other
    Slice("min* flooding", "wifi-648-minstar", "flooding", "host",
          "min* flooding, MC", (2.0,), 32768),
    Slice("min* flooding, MC", "wifi-648-minstar", "flooding", "device",
          "min* flooding", (2.0,), 32768),
    # K2's main path: flooding offset min-sum with early termination, host
    # RNG and the device-RNG megakernel. The file has 16,384 frames at
    # 1.0-2.0 dB and 229,376 at 2.5 dB. Its 1.0 dB point (BER 4.6396e-2)
    # lies about 2.3 of its own standard errors below what the reference
    # package itself gives on 131,072 frames (4.735e-2: `python -m
    # ldpc_tpu.cli sweep` on the CPU, PERF.md section 7), so these
    # slices run 131,072 frames there and hold their 8 BER and iteration
    # rows at the family-wise z of 8 rows sharing 1%, as slice 6 holds its
    # 36 rows
    Slice(OMS_ET, OMS_ET, None, "host", "wifi648_oms.json",
          (1.0, 1.5, 2.0, 2.5), (131072, 131072, 131072, 229376),
          z=OMS_ET_Z),
    Slice(OMS_ET + ", MC", OMS_ET, None, "device", "wifi648_oms.json",
          (1.0, 1.5, 2.0, 2.5), (131072, 131072, 131072, 229376),
          z=OMS_ET_Z),
    # slice 5, the long-codeword regime: the batch-first step, decoded by
    # the streaming library where no on-chip kernel takes the code
    Slice("5a " + S64800, S64800, None, "host", "dvbs2_r12_stream.json",
          (1.0, 1.25), 8192, batch=STREAM_BATCH,
          expect="cuda-stream-pipelined"),
    Slice("5b " + S64800 + "-et", S64800 + "-et", None, "host",
          "dvbs2_64800_et.json", (1.0, 1.25, 1.5), 8192, batch=STREAM_BATCH,
          expect="cuda-stream-pipelined-et"),
    # n=16,200 admits no block of four lanes: `auto` streams it through the
    # packed resident kernel (pipeline.stream_first; four lanes a thread at
    # this batch); "pallas" forces K3, the two-lane instance behind the
    # batch-first transposes
    Slice("5c " + S16200, S16200, None, "host", "dvbs2_16200_et.json",
          (1.4, 2.2), 16384, batch=STREAM_BATCH,
          expect="cuda-stream-resident-et"),
    Slice("5c " + S16200 + ", K3", S16200, None, "host",
          "dvbs2_16200_et.json", (1.4, 2.2), 16384, backend="pallas",
          batch=STREAM_BATCH, expect="cuda-minsum-layered-bf",
          equal_to="5c " + S16200),
    # NR BG1 Z=384 (rate matching: 768 punctured variables) has no recorded
    # waterfall: auto (the packed resident kernel, pipeline.stream_first),
    # K3 (forced "pallas": the two-lane instance behind transposes) and the
    # plain QC decoder are held to each other on equal draws
    Slice("5d " + NR384, NR384, None, "host", "5d " + NR384 + ", K3",
          (1.0, 2.0), 512, batch=256, expect="cuda-stream-resident"),
    Slice("5d " + NR384 + ", K3", NR384, None, "host", "5d " + NR384,
          (1.0, 2.0), 512, backend="pallas", batch=256,
          expect="cuda-minsum-layered-bf", equal_to="5d " + NR384),
    Slice("5d " + NR384 + ", plain", NR384, None, "host", "5d " + NR384,
          (1.0, 2.0), 512, backend="qc", batch=256, expect="torch-qc",
          equal_to="5d " + NR384),
    # the statistical anchor of rate matching: NR BG1 Z=128 rate 1/3
    Slice("5e " + NR128, NR128, None, "host", "nr_bg1_z128_r13.json",
          (0.5, 1.0), 32768, batch=4096, expect="cuda-minsum-layered-bf"),
    # DVB-S2 n=64,800 rate 8/9 (rows of 27-28: the pipelined kernel's
    # 28-entry register row) has no recorded waterfall: the pipelined
    # kernel, fixed and with early termination, is held to the plain QC
    # decoder on equal draws
    Slice("5f " + S89, S89, None, "host", "5f " + S89 + ", plain",
          (3.0, 3.5), 512, batch=256, expect="cuda-stream-pipelined"),
    Slice("5f " + S89 + ", plain", S89, None, "host", "5f " + S89,
          (3.0, 3.5), 512, backend="qc", batch=256, expect="torch-qc",
          equal_to="5f " + S89),
    Slice("5f " + S89 + "-et", S89 + "-et", None, "host",
          "5f " + S89 + "-et, plain", (3.0, 3.5), 512, batch=256,
          expect="cuda-stream-pipelined-et"),
    Slice("5f " + S89 + "-et, plain", S89 + "-et", None, "host",
          "5f " + S89 + "-et", (3.0, 3.5), 512, backend="qc", batch=256,
          expect="torch-qc", equal_to="5f " + S89 + "-et"),
    # DVB-S2 n=16,200 rate 8/9 (rows of 27-28) forced through the library:
    # at this batch the pipelined kernel's 28-entry row (the packed
    # resident kernel would run two lanes a thread), held to the plain QC
    # decoder on equal draws
    Slice("5g " + S1689, S1689, None, "host", "5g " + S1689 + ", plain",
          (3.5, 4.0), 512, backend="stream", batch=256,
          expect="cuda-stream-pipelined"),
    Slice("5g " + S1689 + ", plain", S1689, None, "host", "5g " + S1689,
          (3.5, 4.0), 512, backend="qc", batch=256, expect="torch-qc",
          equal_to="5g " + S1689),
    Slice("5g " + S1689 + "-et", S1689 + "-et", None, "host",
          "5g " + S1689 + "-et, plain", (3.5, 4.0), 512, backend="stream",
          batch=256, expect="cuda-stream-pipelined-et"),
    Slice("5g " + S1689 + "-et, plain", S1689 + "-et", None, "host",
          "5g " + S1689 + "-et", (3.5, 4.0), 512, backend="qc", batch=256,
          expect="torch-qc", equal_to="5g " + S1689 + "-et"),
    # slice 10, recorded configurations the card had not run, each built
    # from its file (recorded_config) and held to it at the family-wise z of
    # that file's rows, at the file's frame counts; the batch is the file's,
    # or 16,384 for the batch-last steps. 10a: the bit-width study, K2 with
    # its in-kernel quantizer at qmax 3, 7, 15 and 31
    *(Slice(f"10a bits {b}", f"{BITS_REF}:{b}", None, "host",
            f"{BITS_REF}:{b}", (2.0, 2.5, 3.0), BITS_FRAMES,
            expect="cuda-minsum", z=family_z(12)) for b in (3, 4, 5, 6)),
    # 10b, 10c: DVB-S2 n=16,200 over 8PSK (rate 1/2) and 16APSK (rate 2/3),
    # the generic max-log demap, then K6e
    Slice("10b dvbs2_16200_8psk", "dvbs2_16200_8psk.json", None, "host",
          "dvbs2_16200_8psk.json", (2.3, 2.65), (65536, 131072), batch=4096,
          expect="cuda-stream-resident-et", z=family_z(2)),
    Slice("10c dvbs2_16200_16apsk", "dvbs2_16200_16apsk.json", None, "host",
          "dvbs2_16200_16apsk.json", (4.5, 5.0), (65536, 131072),
          batch=4096, expect="cuda-stream-resident-et", z=family_z(2)),
    # 10d: NR BG2 Z=128 rate 1/5 (n=6,656, punctured), K3 behind transposes
    Slice("10d nr_bg2_z128_r15", "nr_bg2_z128_r15.json", None, "host",
          "nr_bg2_z128_r15.json", (1.5, 2.0, 2.5), (65536, 65536, 114688),
          batch=4096, expect="cuda-minsum-layered-bf", z=family_z(3)),
    # 10e: 802.11n n=1296 (Z=54) and n=1944 rate 1/2 OMS, K3 fused IO
    Slice("10e wifi1296_r12_oms", "wifi1296_r12_oms.json", None, "host",
          "wifi1296_r12_oms.json", (1.5, 2.0), (65536, 262144),
          expect="cuda-minsum-layered", z=family_z(2)),
    Slice("10e wifi1296_r34_oms", "wifi1296_r34_oms.json", None, "host",
          "wifi1296_r34_oms.json", (2.5, 3.0), 65536,
          expect="cuda-minsum-layered", z=family_z(2)),
    Slice("10e wifi1944_r12_oms", "wifi1944_r12_oms.json", None, "host",
          "wifi1944_r12_oms.json", (1.25, 1.5, 1.75), (65536, 65536, 262144),
          expect="cuda-minsum-layered", z=family_z(3)),
    # 10f: the float decoders, plain torch (the reference has no kernel
    # there either)
    *(Slice(f"10f {name}", f"{name}.json", None, "host", f"{name}.json",
            (2.0, 2.5), frames, expect="torch-float", z=family_z(2))
      for name, frames in (("wifi648_oms_float", (16384, 245760)),
                           ("cn_variants_sp_float", (262144, 524288)),
                           ("cn_variants_oms_float", (262144, 524288)))),
    # slice 11b-11d
    *(recorded_slice(*row) for row in RECORDED_11),
)
# The streaming library's instances (`minsum_stream.StreamDecoder.variant`,
# fixed form) that take each code of check_stream_kernels: the template's
# two placements, and the pipelined kernel where its register row holds the
# code's rows (32 entries; ARRAY30: the (3,30) array code).
ARRAY30 = "array-3x30"
STREAM_INSTANCES = {
    S64800: {"stream", "stream-pipelined", "stream-resident"},
    S16200: {"stream", "stream-pipelined", "stream-resident"},
    NR384: {"stream", "stream-pipelined", "stream-resident"},
    S89: {"stream", "stream-pipelined", "stream-resident"},
    S1689: {"stream", "stream-pipelined", "stream-resident"},
    ARRAY30: {"stream", "stream-pipelined", "stream-resident"},
}
FUSED = dict(preset="wifi-648-r12-minsum", ref="wifi648_fused_mc.json",
             points=(1.0, 1.5, 2.0, 2.5, 3.0, 3.5), batch=18432,
             target=300, max_frames=2_000_000)
# slice 6, the hard-decision path, as scripts/make_hard_curve.py runs it
HARD = dict(preset="wifi-648-r12-minsum", ref="bsc_hard_wifi648.json",
            ps=(0.005, 0.01, 0.02, 0.03, 0.04, 0.06), batch=2048,
            frames=4096, max_iter=30, seed=13)
# slice 7, error floor: scripts/make_error_floor.py's normalized-min-sum run
# (its 2.6 and 3.0 dB rows of results/error_floor_wifi648.json, the file's
# frame counts), its four rows held at the Bonferroni z of four two-sided
# tests at 1% family-wise; 7c, the IS chain's plain Monte Carlo on NR BG1
# Z=128 rate 1/3 against results/nr_bg1_z128_r13.json at 0.5 dB
FLOOR = dict(ref="error_floor_wifi648.json", alg="normalized-min-sum",
             batch=8192, harvest_ebn0=2.2, harvest_frames=131072,
             harvest_seed=11, points=(2.6, 3.0), mc_frames=2_000_000,
             is_frames=1_000_000, depths=(1.2, 1.6, 2.0, 2.4), pi0=0.25,
             mc_seed=21, is_seed=31,
             z=statistics.NormalDist().inv_cdf(1 - 0.01 / 8))   # 3.023
FLOOR_NR = dict(ref="nr_bg1_z128_r13.json", ebn0=0.5, frames=65536,
                batch=4096)
# the JSON keys `floor` writes (ldpc_tpu/cli.py cmd_floor, _floor_symmetric)
FLOOR_KEYS = {
    "is": {"config", "code", "proposal", "points"},
    "is proposal": {"n_sets", "classes", "delta", "pi0", "stratified",
                    "allocation"},
    "is point": {"ebn0_db", "fer", "rel_std", "frames", "raw_hits",
                 "fer_plain_ci95", "ber"},
    "symmetric proposal": {"n_orbit_reps", "orbit_multiplier", "delta",
                           "pi0", "estimator"},
    "symmetric point": {"ebn0_db", "seeds", "seed_repeatable"},
    "symmetric seed": {"ebn0_db", "fer", "rel_std", "fer_attributed_zfold",
                       "fer_unattributed", "rel_std_unattributed",
                       "raw_hits", "raw_hits_attributed", "frames",
                       "orbit_multiplier", "fer_plain_ci95", "top_orbits",
                       "seed"},
}
# Slice 11a, the deep floors. WIFI_SYM: results/wifi_floor_sym.json as
# scripts/make_wifi_floor_sym.py makes it: the census's absorbing-orbit
# cover of 802.11n n=648 rate 1/2 at three depths, pi0 0.25, batch 8,192,
# OMS beta 1 LSB and NMS alpha 3/4 (layered, early termination, 20
# iterations), 2,097,152 frames a seed; each (algorithm, Eb/N0) row's three
# seeds pooled, its four rows held at family_z(4).
WIFI_SYM = dict(ref="wifi_floor_sym.json",
                algs=(("oms_b1", "offset-min-sum", 1),
                      ("nms_a34", "normalized-min-sum", 0)),
                points=(4.6, 5.0), seeds=(31, 32, 33), frames=2_097_152,
                batch=8192, depths=(1.2, 1.6, 2.0), pi0=0.25)
# NR_SYM: results/nr_floor_sym.json's configuration (its header). Its MC
# anchors (4,096,000 frames of the all-zeros word at 1.2 and 1.5 dB) held
# by Wilson intervals; its symmetric row at 1.2 dB through the CLI (the
# file's delta, pi0, seeds and 2,000,000 frames a seed, whole batches of
# 4,096: 2,002,944) pooled and held to the 1.2 dB anchor (relative error
# 1/sqrt(32)); both at family_z(2). The harvest is the CLI's own at 0.8 dB,
# the waterfall's knee between the file's neighbour points (0.5 dB FER 0.14,
# 1.0 dB 3.5e-5, results/nr_bg1_z128_r13.json).
NR_SYM = dict(ref="nr_floor_sym.json", mc_batch=16384, mc_frames=4_096_000,
              mc_points=(1.2, 1.5), sym_ebn0=1.2,
              argv=["floor", "--family", "5gnr", "--base-graph", "1", "--Z",
                    "128", "--rate", "1/3", "--algorithm", "offset-min-sum",
                    "--schedule", "layered", "--beta-lsb", "2", "--batch",
                    "4096", "--ebn0", "1.2", "--frames", "2000000",
                    "--harvest-ebn0", "0.8", "--delta", "1.2,1.6,2.0",
                    "--pi0", "0.25", "--symmetric", "--seeds", "61,62"])
# DVB_FLOOR: DVB-S2 n=64,800 rate 1/2, OMS beta 2 LSB, layered, early
# termination (scripts/diag_dvb_mc_deep.py, make_dvb_floor_r5.py). 11a.3:
# results/dvb_floor_summary.json's 1.2 dB point, plain MC of the all-zeros
# word, its frames at the file's batch (976 x 1,024), fails_info and
# fails_any by Wilson intervals at family_z(2). 11a.4: the symmetric run
# on results/dvb_floor_r5.json's proposal (the harvested info-failure
# orbits of results/dvb_mc_deep.json and the (7,3) orbit of
# results/dvb_census.json: 109 reps, 327 components), whose numbers fail
# the file's own convergence bar: the route and one batch against the
# plain QC route, then two seeds at 1.3 dB held to be finite.
DVB_FLOOR = dict(summary="dvb_floor_summary.json", ebn0=1.2, frames=999_424,
                 batch=1024, seed=71, mc_deep="dvb_mc_deep.json",
                 census="dvb_census.json", reps=109, components=327,
                 depths=(1.2, 1.6, 2.0), pi0=0.25, sym_ebn0=1.3,
                 sym_seeds=(71, 72), sym_frames=65536)
# Slice 11d's soft BSC: results/bsc_wifi648.json as scripts/make_bsc_curve.py
# makes it (the canonical preset's decoder over bsc -> bsc_llr -> quantize,
# batch 4,096, 16,384 frames a p); its eight BER rows at family_z(8)
BSC = dict(preset="wifi-648-r12-minsum", ref="bsc_wifi648.json",
           ps=(0.005, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.08), batch=4096,
           frames=16384, seed=17)
MICRO_BATCHES = (512, 1024, BATCH)   # the reference's two tiles, and K1's
RAGGED = (1, 3, 5, 4099, 16385)      # batches of the packed flooding kernel
# Slice 12: the codes of the two-lane packed instances (state of 57-115 KB
# a lane: four lanes exceed a block's shared memory, two fit), each with
# the sigma of its held LLRs (lanes finish apart within TWO_LANE_ITERS
# iterations); DVB-S2 rate 8/9's min* (rows of 27-28) stays on the one-lane
# template and is held with them
TWO_LANE_CODES = (
    ("NR BG1 Z=384", "nr-bg1-layered", {}, 0.66),
    ("NR BG1 Z=256", "nr-bg1-layered", dict(Z=256), 0.66),
    ("NR BG1 Z=128 r1/3", "nr-bg1-layered", dict(Z=128, rate="1/3"), 0.8),
    ("DVB-S2 n=16,200 r1/2", "dvbs2-64800-r12", dict(n=16200), 0.72),
    ("DVB-S2 n=16,200 r8/9", "dvbs2-64800-r12", dict(n=16200, rate="8/9"),
     0.45))
TWO_LANE_BATCHES = (3, 1000, 1024, 1027)   # each held to one plain run
TWO_LANE_ITERS = 6
# (rows, tiles, tile width, steps) of S6's ragged checks
GRID1_SHAPES = tuple((rows, n_tiles, 512, inner) for rows in (1, 26)
                     for n_tiles in (1, 3, 33) for inner in (400, 7)) + (
    (27, 32, 512, 7), (27, 31, 512, 400), (3, 5, 100, 400), (5, 9, 13, 400))
# the SASS memory instructions counted (LDGSTS: cp.async; BAR: barriers)
SASS_OPS = ("LDS", "STS", "LDC", "ULDC", "LD", "LDG", "STG", "LDGSTS", "BAR")
# the layered library's functions whose SASS is counted: the packed
# instances of the main paths (<LPT, DMAX, STAR, ET, MC>: K3 with early
# termination at the 20-entry row, n=1944 rate 5/6; K3 and K5 with early
# termination at the 8-entry row, n=648) and the one-lane template's
# early-terminating min-sum instance (<ET, MC, STAR>), K3's layout before
# the flooding library's functions whose SASS is counted: the packed
# instances at n=648's 8-entry row, fixed min-sum (K1: <LPT, DMAX, MC>),
# and <LPT, DMAX, STAR, ET, MC> min-sum with early termination (K2), min*
# fixed and with early termination (K5), and the one-lane template's fixed
# min-sum instance (<ET, MC, STAR>), K1's layout before the packed kernel
# and slice 12's two-lane instances (<DMAX, STAR, ET>) of its main
# paths and cells: flooding fixed and with early termination at NR BG1's
# 24-entry row and DVB-S2's 8-entry row, min* with early termination; layered
# fixed at the 24-entry row, with early termination (slice 5c's forced K3)
# and min* fixed (the CLI's) at the 8-entry row
SASS_FLOOD = ("flood_packed_kernelILi4ELi8ELb0EE",
              "flood_packed_kernelILi4ELi8ELb0ELb1ELb0E",
              "flood_packed_kernelILi4ELi8ELb1ELb0ELb0E",
              "flood_packed_kernelILi4ELi8ELb1ELb1ELb0E",
              "minsum_flood_kernelILb0ELb0ELb0E",
              "flood_two_lane_kernelILi24ELb0ELb0EE",
              "flood_two_lane_kernelILi24ELb0ELb1EE",
              "flood_two_lane_kernelILi8ELb0ELb0EE",
              "flood_two_lane_kernelILi24ELb1ELb1EE")
SASS_LAYERED = ("layered_packed_kernelILi4ELi20ELb0ELb1ELb0E",
                "layered_packed_kernelILi4ELi8ELb0ELb1ELb0E",
                "layered_packed_kernelILi4ELi8ELb1ELb1ELb0E",
                "minsum_layered_kernelILb1ELb0ELb0E",
                "layered_two_lane_kernelILi24ELb0ELb0EE",
                "layered_two_lane_kernelILi8ELb0ELb1EE",
                "layered_two_lane_kernelILi8ELb1ELb0EE")


def phase(name):
    """Prints a phase's heading with the seconds since the script began,
    so that each phase's share of the time limit reads off the log."""
    print(f"== {name} (t = {time.perf_counter() - STARTED:.1f} s)",
          flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def import_port():
    sys.path.insert(0, HERE)
    import ldpc_tpu_torch
    pkg = os.path.dirname(os.path.abspath(ldpc_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"ldpc_tpu_torch imported from {pkg}, not from "
                           f"the checkout at {HERE}")
    return ldpc_tpu_torch


def mixed_llrs(rng, n, B, qmax=127):
    """int8 LLRs (n, B): half easy lanes (large |LLR|), half noisy."""
    x = rng.normal(0, 40, size=(n, B))
    x[:, : B // 2] = rng.normal(30, 25, size=(n, B // 2))
    return np.clip(np.round(x), -qmax, qmax).astype(np.int8)


def channel_llrs(rng, ct, B, scale, sigma=0.8):
    """float32 LLRs (n, B) of the all-zeros codeword over BPSK/AWGN, the
    first 64 values set to exact half-LSB points of the quantizer, and
    info bits (k, B): zeros for half the lanes (the sent word), random for
    the rest (scored against a different word)."""
    y = 1.0 + sigma * rng.standard_normal((ct.n, B))
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    llr.flat[:64] = (np.arange(64) - 32 + 0.5) / scale
    info = rng.integers(0, 2, (ct.k, B), dtype=np.uint8)
    info[:, : B // 2] = 0
    return llr, info


def chain_args(ct, cfg, ebn0_db, B, gen):
    """The decoder's arguments as the host step of `cfg` makes them: info
    bits from `gen`, encoded, modulated, AWGN at `ebn0_db`, demapped.
    Returns float32 LLRs (nb, Z, B) and the info bits (kb, Z, B)."""
    from ldpc_tpu_torch.ops import channel as ch
    from ldpc_tpu_torch.ops.encode import make_encoder_t
    mod = cfg.channel.modulation
    sigma = np.float32(ch.sigma_for(ebn0_db, ct.code.rate, mod))
    info = torch.randint(0, 2, (ct.k, B), generator=gen, device=ct.device,
                         dtype=torch.uint8)
    x = ch.modulate_t(make_encoder_t(ct)(info), mod)
    llr = ch.demap_t(ch.awgn_t(gen, x, sigma), sigma, mod)
    return llr.reshape(ct.nb, ct.Z, B), info.reshape(ct.kb, ct.Z, B)


def shape_text(d):
    """The launch shape of decoder d's instance, as its library reports it."""
    lanes, smem, lpt, blocks = d.launch_shape()
    return (f"{lanes} lanes/block, {lpt} lanes/thread, {blocks} blocks/SM, "
            f"{smem} B smem")


def bare_tensors(code, dev):
    """CodeTensors of a code whose parity-check matrix has no systematic
    form (the array codes): enough for a decoder, which reads the entries
    only."""
    from ldpc_tpu_torch.codes import CodeTensors, qc_entries
    qc, entries = qc_entries(code)
    return CodeTensors(code=code, device=dev, n=int(code.n), k=int(code.k),
                       Z=int(qc.Z), nb=int(qc.nb), mb=int(qc.mb), kb=0,
                       entries=entries, P=None, perm=None,
                       info_positions=torch.zeros(0, dtype=torch.int64,
                                                  device=dev),
                       ident_info=False)


def sass_functions(path):
    """Per kernel function of a built library, from `cuobjdump -sass`: its
    instructions (address, opcode without modifiers, the rest of the line)
    in address order."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)"
                      r"([^;]*)", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def innermost_loops(ins):
    """(first, last) addresses of each innermost loop of a function's
    instructions: those between a backward branch's target and the branch,
    holding no other backward branch, in address order."""
    back = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            back.append((int(t.group(1), 16), addr))
    return sorted((lo, hi) for lo, hi in back
                  if not any(lo <= a < b <= hi and (a, b) != (lo, hi)
                             for a, b in back))


def sass_counts(path):
    """Per kernel function of a built library (`sass_functions`): its
    shared-memory loads and stores (LDS, STS), constant-bank loads (LDC,
    ULDC), generic loads (LD), device-memory loads and stores (LDG, STG),
    asynchronous copies (LDGSTS) and barriers (BAR) in the whole function
    ("all") and in each innermost loop (`innermost_loops`)."""
    out = {}
    for name, ins in sass_functions(path).items():
        def count(lo, hi):
            c = dict.fromkeys(SASS_OPS, 0)
            for addr, op, _ in ins:
                if lo <= addr <= hi and op in c:
                    c[op] += 1
            return c
        out[name] = {"all": count(0, 1 << 62),
                     "loops": [dict(count(lo, hi), span=[hex(lo), hex(hi)])
                               for lo, hi in innermost_loops(ins)]}
    return out


def print_sass(minsum, stream, micro):
    """Shared-memory and constant-bank loads of the flooding library's
    functions of SASS_FLOOD (the packed instances at row degree 8, the
    canonical code's: K1 beside the new K2 and K5 loops, and the one-lane
    template's fixed instance), in the whole function and in each innermost
    loop;
    the layered library's functions of SASS_LAYERED (the packed kernel's
    layer loop beside the one-lane template's); and every instance of the
    streaming library, the pipelined kernel's (its layer loop: LDGSTS, LDS,
    STS, STG, LDC) beside the template's; and the microbenchmark library's
    packed S1 and S2 instances (`sweep_kernel`, `minsum_kernel`)."""
    path = minsum.load_library("minsum_flood").path
    for fn, c in sass_counts(path).items():
        if any(k in fn for k in SASS_FLOOD):
            print(f"  sass {fn}: {json.dumps(c)}", flush=True)
    for fn, c in sass_counts(minsum.load_library("minsum_layered").path
                             ).items():
        if any(k in fn for k in SASS_LAYERED):
            print(f"  sass {fn}: {json.dumps(c)}", flush=True)
    for fn, c in sass_counts(stream.load_library().path).items():
        print(f"  sass {fn}: {json.dumps(c)}", flush=True)
    for fn, c in sass_counts(micro.load_library().path).items():
        if "sweep_kernel" in fn or "minsum_kernel" in fn:
            print(f"  sass {fn}: {json.dumps(c)}", flush=True)


def tally_key(d):
    """The kernels line's record a min-sum decoder's worst error goes to:
    its library's, or for the early-terminating min-sum family on the
    flooding schedule (K2) `minsum_flood_et`; min* keys by library in its
    own tally."""
    if (d.library == "minsum_flood" and d.dec.early_term
            and d.minstar is None):
        return "minsum_flood_et"
    return d.library


def max_abs_err(a, b):
    return max(float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0.0 for x, y in zip(a, b))


def kernel_vs_plain_ms(d, args, kw, gpu, what, kernel_reps=10, plain_reps=3):
    """Median ms of d.kernel and d.plain on (*args, **kw), in turns (plain,
    kernel, kernel, plain) after a warm-up; prints and returns both."""
    from ldpc_tpu_torch.utils.profiling import event_ms
    for _ in range(3):
        d.kernel(*args, **kw)
    d.plain(*args, **kw)
    torch.cuda.synchronize()
    plain_t, kern_t = [], []
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            plain_t += event_ms(lambda: d.plain(*args, **kw), plain_reps)
        else:
            kern_t += event_ms(lambda: d.kernel(*args, **kw), kernel_reps)
    kern_ms, plain_ms = statistics.median(kern_t), statistics.median(plain_t)
    print(f"[{gpu}] {what}: kernel {kern_ms:.4f} ms (runs {len(kern_t)}, "
          f"min {min(kern_t):.4f}, max {max(kern_t):.4f}), plain "
          f"{plain_ms:.4f} ms (runs {len(plain_t)}, min {min(plain_t):.4f}, "
          f"max {max(plain_t):.4f})", flush=True)
    return kern_ms, plain_ms


def ops_per_iteration(d):
    """Integer operations one codeword needs for one iteration of decoder
    d (the counting rule of the module docstring)."""
    from ldpc_tpu_torch.kernels import minsum
    dec = getattr(d, "inner", d)
    dec = getattr(dec, "decoder", dec)
    return minsum.iteration_ops(dec.ct, getattr(dec, "minstar", None))


def bound_of(d, args, kw):
    """(bound_ms, bound_by) of one call d.kernel(*args, **kw): bytes moved
    once over the memory rate against the operations this call's lanes
    need over the CUDA cores' rate."""
    from ldpc_tpu_torch.utils.profiling import bound, tensor_bytes
    out = d.kernel(*args, **kw)
    torch.cuda.synchronize()
    ops = int(out[-2].to(torch.int64).sum()) * ops_per_iteration(d)
    return bound(tensor_bytes(args, kw, out), ops)


def kernels_in_turns_ms(decs, args, gpu, what, reps=10):
    """Median kernel ms of several decoders on the same arguments, in turns
    (a, b, b, a) after a warm-up; prints and returns them by name."""
    from ldpc_tpu_torch.utils.profiling import in_turns_ms
    names = list(decs)
    times = in_turns_ms({name: (lambda d=d: d.kernel(*args))
                         for name, d in decs.items()}, reps)
    med = {name: statistics.median(t) for name, t in times.items()}
    print(f"[{gpu}] {what}: " + ", ".join(
        f"{name} {med[name]:.4f} ms (runs {len(times[name])}, min "
        f"{min(times[name]):.4f}, max {max(times[name]):.4f})"
        for name in names), flush=True)
    return med


def step_seconds(rb, draw, sigma, reps=10):
    for _ in range(3):
        rb(draw, sigma)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rb(draw, sigma).tolist()
        out.append(time.perf_counter() - t0)
    return out


def lane_variances(sweep, snr_idx, ebn0_db, need_failed, min_failed=10,
                   max_batches=200):
    """Per-frame variances (info-bit errors, iterations) of one sweep
    point, with the frames and failed frames they come from: batch 0,
    re-drawn from the sweep's own generator through the step's own parts
    (fails unless its sums are the step's own counters). With `need_failed`
    and no bit error in batch 0 (a variance of 0 would make the z-test
    demand equal counts), the bit-error variance comes from further
    batches, at indices the sweep never uses, until they hold `min_failed`
    failed frames or `max_batches` ran, as `fused_lane_variances` does."""
    from ldpc_tpu_torch.sim.pipeline import make_lane_step
    step = make_lane_step(sweep.ct, sweep.cfg, batch=sweep.batch,
                          backend=sweep.decoder_backend)
    sigma = sweep._sigma(ebn0_db)
    bits, frame, iters, _ = step(sweep.draw(snr_idx, 0), sigma)
    want = sweep.run_batch(sweep.draw(snr_idx, 0), sigma).tolist()
    if [int(bits.sum()), int(iters.sum())] != [want[1], want[3]]:
        raise AssertionError("re-drawn batch differs from the step's own")
    bits = bits.double()
    sums = torch.stack([bits.sum(), (bits * bits).sum()])
    count, failed, n = bits.numel(), int(frame.sum()), 0
    more = need_failed and not bool(bits.any())
    while more and failed < min_failed and n < max_batches:
        bb, ff, _, _ = step(sweep.draw(snr_idx, (1 << 20) + n), sigma)
        bb = bb.double()
        sums += torch.stack([bb.sum(), (bb * bb).sum()])
        count += bb.numel()
        failed += int(ff.sum())
        n += 1
    s1, s2 = (float(x) / count for x in sums.tolist())
    return s2 - s1 * s1, float(iters.double().var()), count, failed


def recorded_config(port, what):
    """The configuration of a recorded file of results/: "name.json" is the
    file's own `config` header, read by the port's SimConfig.from_json;
    "bits_wifi648.json:b" the bit-width study's width b, built as
    scripts/make_bits_study.py:40-60 builds it (batch 16,384, the file's
    131,072 frames a point)."""
    name, _, bits = what.partition(":")
    if not bits:
        with open(os.path.join(HERE, "results", name)) as f:
            return port.SimConfig.from_json(json.dumps(json.load(f)["config"]))
    b = int(bits)
    base = port.PRESETS["wifi-648-r12-minsum"]
    base = dataclasses.replace(
        base, decoder=dataclasses.replace(
            base.decoder, algorithm="offset-min-sum", early_term=True),
        run=dataclasses.replace(base.run, batch=BATCH,
                                max_frames=BITS_FRAMES))
    qmax = (1 << (b - 1)) - 1
    clip = BITS_CLIP.get(b, 31.75)
    return dataclasses.replace(base, quant=dataclasses.replace(
        base.quant, bits=b, scale=qmax / clip,
        beta_lsb=max(1, round(0.5 * qmax / clip))))


def slice_config(port, what, rng, schedule=None, **run):
    """A recorded file's configuration (`recorded_config`: `what` names a
    file of results/), taken as it is: its rng must be `rng`. Else a
    preset with `rng` (and `run` fields), or one of bench.py's
    extended workloads, built as it builds them: `multihost-qam-chain`
    without its mesh (`qam16-1944-chain`); `wifi-648-minstar`, the canonical
    preset with the min* update, beta_lsb=0 and early termination; the
    long-codeword cells on `dvbs2-64800-r12` (fixed 20 iterations, with
    early termination, and n=16,200 with early termination; rate 8/9,
    fixed and with early termination, at n=64,800 and n=16,200);
    `nr-bg1-z384-stream` (preset `nr-bg1-layered`); and NR BG1 Z=128 rate
    1/3 with early termination, the configuration of
    results/nr_bg1_z128_r13.json; `wifi-648-oms-flood-et`, the canonical
    preset with offset min-sum beta_lsb=2 and early termination (flooding,
    20 iterations at most), the configuration of results/wifi648_oms.json.
    `schedule` replaces the configuration's own."""
    if ".json" in what:
        cfg = recorded_config(port, what)
        if cfg.run.rng != rng or schedule or run:
            raise ValueError(f"{what} is run as its file records it, with "
                             f"rng {cfg.run.rng!r}")
        return cfg
    star = what == "wifi-648-minstar"
    code_kw, dec_kw, quant_kw = {}, {}, {}
    if star:
        preset = "wifi-648-r12-minsum"
        dec_kw = dict(algorithm="min-star", schedule="layered",
                      early_term=True)
        quant_kw = dict(beta_lsb=0)
    elif what == OMS_ET:
        preset = "wifi-648-r12-minsum"
        dec_kw = dict(algorithm="offset-min-sum", early_term=True)
        quant_kw = dict(beta_lsb=2)
    elif what.startswith("dvbs2-"):
        preset = "dvbs2-64800-r12"
        dec_kw = dict(early_term=what.endswith("-et"))
        code_kw = (dict(n=16200) if what == S16200
                   else dict(rate="8/9") if what.startswith(S89)
                   else dict(n=16200, rate="8/9") if what.startswith(S1689)
                   else {})
    elif what in (NR384, NR128):
        preset = "nr-bg1-layered"
        if what == NR128:
            code_kw, dec_kw = dict(Z=128, rate="1/3"), dict(early_term=True)
    else:
        preset = what
    cfg = port.PRESETS[preset]
    cfg = dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, **quant_kw))
    if schedule:
        dec_kw["schedule"] = schedule
    if what == "multihost-qam-chain":
        run["mesh_shape"] = None
    return dataclasses.replace(
        cfg, code=dataclasses.replace(cfg.code, **code_kw),
        decoder=dataclasses.replace(cfg.decoder, **dec_kw),
        run=dataclasses.replace(cfg.run, rng=rng, **run))


def rows_compatible(row, r, k, var_bits, var_iters, z=2.576):
    """(ok_b, ok_f, ok_i, ok_c, bits_wilson) of one port row against one
    reference row: FER and converged rate by Wilson intervals, BER and
    iterations by per-frame z-tests at `z` with the per-frame variances
    given."""
    from ldpc_tpu_torch.sim.stats import mean_compatible, rates_compatible
    ok_f = rates_compatible(row["frame_errs"], row["frames"],
                            r["frame_errs"], r["frames"])
    ok_c = rates_compatible(round(row["early_term_rate"] * row["frames"]),
                            row["frames"],
                            round(r["early_term_rate"] * r["frames"]),
                            r["frames"])
    bits_wilson = rates_compatible(row["bit_errs"], row["frames"] * k,
                                   r["bit_errs"], r["frames"] * k)
    # BER and iterations cluster in failed frames: compare per-frame
    # means with their per-frame variance, from batches that hold failed
    # frames (the caller's).
    ok_b = mean_compatible(row["bit_errs"], row["frames"],
                           r["bit_errs"], r["frames"], var_bits, z=z)
    ok_i = mean_compatible(row["avg_iters"] * row["frames"],
                           row["frames"], r["avg_iters"] * r["frames"],
                           r["frames"], var_iters, z=z)
    return ok_b, ok_f, ok_i, ok_c, bits_wilson


def print_row(row, r, var_bits, var_iters, oks, extra=""):
    from ldpc_tpu_torch.sim.stats import wilson_interval
    ok_b, ok_f, ok_i, ok_c, bits_wilson = oks
    ref_lo, ref_hi = wilson_interval(r["frame_errs"], r["frames"])
    print(f"  Eb/N0 {row['ebn0_db']} dB: frames {row['frames']} "
          f"BER {row['ber']:.4e} ref {r['ber']:.4e} compatible {ok_b} "
          f"(per-frame z-test, sd {var_bits ** 0.5:.2f} "
          f"bits/frame; Wilson over bits {bits_wilson}); FER "
          f"{row['fer']:.4e} [{row['fer_lo']:.4e}, {row['fer_hi']:.4e}] "
          f"ref {r['fer']:.4e} [{ref_lo:.4e}, {ref_hi:.4e}] "
          f"compatible {ok_f}; avg_iters {row['avg_iters']:.4f} ref "
          f"{r['avg_iters']:.4f} compatible {ok_i} (sd "
          f"{var_iters ** 0.5:.2f}); converged "
          f"{row['early_term_rate']:.6f} ref {r['early_term_rate']:.6f} "
          f"compatible {ok_c}" + extra, flush=True)


def instance_of(d):
    """What picks a decoder's kernel instance and its launch shape. On-chip
    libraries: the library, ET, MC and min* (with its thresholds and
    quantizer), the code (its name and its entries: two QC-PEG codes of
    one shape share a name), fused IO, whether it stands behind the
    batch-first transposes, and for the megakernel the batch and the
    per-lane form. The streaming library: its instance, the code, the CN
    parameters and the resident instances' kernel (its lanes a thread
    follow the batch, which every caller here holds equal)."""
    if hasattr(d, "variant"):
        return ("minsum_stream", d.variant, d.packed,
                d.ct.code.name, d.ct.entries, d.max_iter, d.beta, d.alpha,
                d.qmax)
    behind_transposes = hasattr(d, "inner")
    if behind_transposes:
        d = d.inner
    inner = getattr(d, "decoder", d)
    return (inner.library, inner.ct.code.name, inner.ct.entries, inner.dec,
            inner.quant,
            inner.minstar, inner.input_scale, inner.count_info_cols,
            d is not inner, getattr(d, "batch", None),
            getattr(d, "lane_sigma", None), behind_transposes)


def instance_name(d):
    """The kernel template instance decoder d launches: the packed kernel
    of its library <lanes a thread, register row, min*, ET, MC> (the
    flooding library's fixed min-sum family: <lanes a thread, register row,
    MC>), its two-lane instance <register row, min*, ET> or the one-lane
    template <ET, MC, min*>."""
    from ldpc_tpu_torch.kernels import minsum
    mc = hasattr(d, "cb")                  # the megakernel (McDecoder)
    d = getattr(d, "inner", d)             # behind the batch-first transposes
    d = getattr(d, "decoder", d)
    lib = d.library[len("minsum_"):]
    et, star = d.dec.early_term, d.minstar is not None

    def b(x):
        return "true" if x else "false"
    if not d.packed:
        return f"minsum_{lib}_kernel<{b(et)}, {b(mc)}, {b(star)}>"
    dmax = minsum.row_degree_instance(d.ct, d.dec.schedule)
    if d.lanes_per_thread == minsum.TWO_LANES:
        return f"{lib}_two_lane_kernel<{dmax}, {b(star)}, {b(et)}>"
    args = ((minsum.LANES_PER_THREAD, dmax, b(mc))
            if lib == "flood" and not (et or star) else
            (minsum.LANES_PER_THREAD, dmax, b(star), b(et), b(mc)))
    return f"{lib}_packed_kernel<{', '.join(map(str, args))}>"


def same_instance(driven, checked, label):
    """Fails unless the decoder a main path launched is the kernel instance
    and shape that was held to its plain version."""
    if instance_of(driven) != instance_of(checked):
        raise AssertionError(f"{label} ran {instance_of(driven)}; held to "
                             f"plain was {instance_of(checked)}")


def launch_counts(minsum, stream, sweep, label, mc):
    """The launch counters of the run just made. An on-chip route must
    have gone through the schedule's library only, in its MC instance
    exactly when `mc`, in its packed instance (four lanes a thread) exactly
    when a block of four lanes takes the code (`minsum.is_packed`), else in
    the one-lane template; a streaming route through its instance of the
    streaming library only, in the packed resident kernel exactly when the
    decoder is packed; both with no plain call. A plain route (forced,
    to compare with) launches no kernel. Returns the route's launches."""
    launches = dict(minsum.library_launches)
    mc_launches = dict(minsum.mc_launches)
    star_launches = dict(minsum.star_launches)
    packed = dict(minsum.packed_launches)
    inst = dict(stream.instance_launches)
    plain = minsum.plain_calls + stream.plain_calls
    print(f"{label}: backend {sweep.backend}; kernel launches {launches}, "
          f"of them MC {mc_launches}, min* {star_launches}, packed "
          f"{packed}, streaming library {inst}, plain_calls {plain}",
          flush=True)
    backend = sweep.backend
    if backend.startswith("torch-"):
        if any(launches.values()) or stream.kernel_launches:
            raise AssertionError(f"{label}: a plain route launched kernels")
        return 0
    if backend.startswith("cuda-stream"):
        variant = backend[len("cuda-"):]
        packed = getattr(sweep.run_batch.decoder, "packed", False)
        print(f"  of them the packed resident kernel's: "
              f"{stream.packed_launches}", flush=True)
        if (inst[variant] <= 0 or plain != 0 or any(launches.values())
                or stream.kernel_launches != inst[variant]
                or stream.packed_launches != (inst[variant] if packed
                                              else 0)):
            raise AssertionError(f"{label} did not run through the "
                                 f"{variant} instance "
                                 f"({'packed' if packed else 'template'}) "
                                 f"only")
        return inst[variant]
    dc = sweep.cfg.decoder
    lib = minsum.LIBRARIES[dc.schedule]
    star = dc.algorithm == "min-star"
    is_packed = minsum.is_packed(sweep.ct, dc.schedule,
                                 minsum.star_degree(sweep.ct, dc),
                                 dc.early_term)
    want_mc = {name: launches[name] if mc else 0 for name in launches}
    want_star = {name: launches[name] if star else 0 for name in launches}
    want_packed = {name: launches[name] if is_packed else 0
                   for name in launches}
    if (launches[lib] <= 0 or plain != 0 or mc_launches != want_mc
            or star_launches != want_star or packed != want_packed
            or stream.kernel_launches
            or any(v for name, v in launches.items() if name != lib)):
        raise AssertionError(
            f"{label} did not run through {lib}"
            f"{' (min*)' if star else ''}{' (MC)' if mc else ''}"
            f"{' (packed)' if is_packed else ' (one lane a thread)'} only")
    return launches[lib]


def run_slice(port, minsum, stream, sl):
    """Runs one row of SLICES on the card; returns (sweep, launches of its
    kernel in this run, the result's rows by Eb/N0). Fails unless the step
    is the megakernel exactly when rng == "device", the backend is the
    row's, every launch went through the route's kernel with no plain
    call, and every point has its frames and finite rates."""
    from ldpc_tpu_torch.sim import Sweep
    sweep = Sweep(slice_config(port, sl.what, sl.rng, sl.schedule),
                  device="cuda", batch=sl.batch, decoder_backend=sl.backend)
    if sweep.run_batch.mc != (sl.rng == "device"):
        raise AssertionError(f"{sl.label}: run_batch.mc is "
                             f"{sweep.run_batch.mc}")
    if sl.expect and sweep.backend != sl.expect:
        raise AssertionError(f"{sl.label}: backend {sweep.backend}, "
                             f"expected {sl.expect}")
    frames = (dict(zip(sl.points, sl.frames)) if isinstance(sl.frames, tuple)
              else dict.fromkeys(sl.points, sl.frames))
    runs = ([[pt] for pt in sl.points] if isinstance(sl.frames, tuple)
            else [list(sl.points)])
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    rows = {}
    for pts in runs:
        res = sweep.run(pts, target_frame_errors=10 ** 9,
                        max_frames=frames[pts[0]])
        rows.update((row["ebn0_db"], row) for row in res.rows())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(minsum, stream, sweep, sl.label,
                             sl.rng == "device")
    print(f"  {len(sl.points)} points of {sl.frames} frames in {wall:.2f} s",
          flush=True)
    for row in rows.values():
        if not (np.isfinite(row["ber"]) and np.isfinite(row["fer"])
                and row["frames"] >= frames[row["ebn0_db"]]):
            raise AssertionError(f"{sl.label}: rates not finite or frames "
                                 f"short at {row['ebn0_db']} dB")
    return sweep, launches, rows


COUNTERS = ("frames", "bit_errs", "frame_errs", "avg_iters",
            "early_term_rate")


def least_bit_variance(row):
    """The least per-frame variance of bit errors a row of counters allows:
    its bit errors spread evenly over its failed frames (mu^2 / FER -
    mu^2); 0 without a failed frame."""
    if not row["frame_errs"]:
        return 0.0
    mu = row["bit_errs"] / row["frames"]
    return mu * mu * row["frames"] / row["frame_errs"] - mu * mu


def hold_slice(label, sweep, rows, ref, ref_name, equal=None, z=2.576,
               least_row=False):
    """Holds a slice's rows to the reference rows `ref` (by Eb/N0; a
    recorded waterfall or another slice's run, named `ref_name`): FER and
    converged rate by Wilson intervals, BER and iterations by per-frame
    z-tests with the variances of `lane_variances` (batch 0 re-drawn, and
    further batches where one of the rows holds bit errors and batch 0
    none); `z`, that of the per-frame z-tests. With `least_row` the BER
    variance is at least the least either row allows (`least_bit_variance`),
    which a row's test needs where failed frames are too rare for further
    batches to meet. `equal`: the rows of a slice that saw the same draws,
    whose counters must be these exactly."""
    print(f"{label} against {ref_name}"
          + (f" (per-frame z-tests at z = {z:.3f})" if z != 2.576 else "")
          + ":", flush=True)
    for si, row in enumerate(rows.values()):
        r = ref[row["ebn0_db"]]
        var_b, var_i, count, failed = lane_variances(
            sweep, si, row["ebn0_db"],
            need_failed=bool(row["bit_errs"] or r["bit_errs"]))
        if least_row:
            var_b = max(var_b, least_bit_variance(row),
                        least_bit_variance(r))
        oks = rows_compatible(row, r, sweep.code.k_eff, var_b, var_i, z)
        auto = sweep.auto_choice.get(si)
        print_row(row, r, var_b, var_i, oks,
                  f"; bit-error variance from {count} frames, {failed} "
                  f"failed" + (f"; AUTO (p1, cap) = {auto}" if auto else ""))
        if not all(oks[:4]):
            raise AssertionError(f"{label} disagrees with {ref_name} at "
                                 f"{row['ebn0_db']} dB")
        if equal is not None:
            other = equal[row["ebn0_db"]]
            same = all(row[c] == other[c] for c in COUNTERS)
            print(f"    counters equal the other route's on equal draws: "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError(
                    f"{label}: {[row[c] for c in COUNTERS]} != "
                    f"{[other[c] for c in COUNTERS]}")


def build_libraries(minsum, stream, micro):
    """Builds the four libraries fresh, at the same time."""
    libs = list(minsum.SOURCES)
    sources = dict(minsum.SOURCES, **{stream.LIBRARY: stream.SOURCE,
                                      micro.LIBRARY: micro.SOURCE})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        jobs = {name: pool.submit(minsum.load_library, name, rebuild=True)
                for name in libs}
        jobs[stream.LIBRARY] = pool.submit(stream.load_library, rebuild=True)
        jobs[micro.LIBRARY] = pool.submit(micro.load_library, rebuild=True)
        built = {name: job.result() for name, job in jobs.items()}
    for name, lib in built.items():
        print(f"nvcc sm_90a build of {sources[name]}: "
              f"{lib.build_seconds:.2f} s -> "
              f"{os.path.relpath(lib.path, HERE)}", flush=True)
        for line in lib.ptxas_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print("  ptxas:", line.strip())
    return libs


def check_mc_kernels(port, minsum, dev):
    """K1-MC kernel == plain (tolerance 0) in inject, Philox and per-lane
    sigma modes, both schedules, each at the batch its main path runs:
    B=16,384 for the scalar forms, the fused sweep's batch for the
    per-lane form. The min* MC instances the same way (inject and Philox,
    scalar sigma; layered and flooding with early termination, as slice 4
    drives them, and flooding fixed-20), and the flooding min-sum family's
    early-terminating instance (K2's megakernel: `wifi-648-oms-flood-et`
    with rng=device) with injected words and Philox at B=16,384 and at the
    ragged batches. Returns (worst error per library and `tally_key`,
    name -> (decoder, arguments, keyword arguments) to time, worst error
    per library of the min* instances)."""
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.ops.mc import gain_for
    cfg648 = port.PRESETS["wifi-648-r12-minsum"]
    oms = port.PRESETS["wifi-full-oms"]
    wifi = from_reference(build_code(cfg648), dev)
    r56 = from_reference(build_code(oms), dev)
    rng = np.random.default_rng(31)
    worst, star_worst = {}, {}
    timed = {}

    def make(ct, cfg, batch=BATCH, **kw):
        return minsum.make_decoder(ct, cfg.decoder, cfg.quant,
                                   input_scale=cfg.quant.scale,
                                   count_info_cols=ct.kb, mc_batch=batch,
                                   **kw)

    def compare(label, d, out_k, out_p):
        torch.cuda.synchronize()
        err = max_abs_err(out_k, out_p)
        same = all(torch.equal(a.to(torch.int64), b.to(torch.int64))
                   for a, b in zip(out_k, out_p))
        print(f"{label} B={d.batch}: max_abs_err {err:g} equal {same} "
              f"(frame errors {int(out_k[1].sum())}/{d.batch}, converged "
              f"{int(out_k[3].sum())}, mean iters "
              f"{float(out_k[2].double().mean()):.3f}, {d.library} "
              f"{shape_text(d)})", flush=True)
        if not same:
            raise AssertionError(f"K1-MC kernel != plain on {label}")
        tally = star_worst if d.decoder.minstar is not None else worst
        key = tally_key(d.decoder)
        tally[key] = max(tally.get(key, 0.0), err)

    s20 = np.float32(sigma_for(2.0, wifi.code.rate, "bpsk"))
    g20 = gain_for(s20, cfg648.quant.scale)
    d = make(wifi, cfg648, inject_random=True)
    words = torch.as_tensor(rng.integers(
        0, 1 << 32, (d.n_words, BATCH), dtype=np.uint32).view(np.int32)
    ).to(dev)
    compare("K1-MC n648 flooding fixed-20 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=words),
            d.plain(0, s20, g20, words=words))
    d = make(wifi, cfg648)
    seed = 0x5EED0FC0FFEE
    compare("K1-MC n648 flooding fixed-20 2.0 dB Philox", d,
            d.kernel(seed, s20, g20), d.plain(seed, s20, g20))
    timed["flood"] = (d, (seed, s20, g20), {})
    s35 = np.float32(sigma_for(3.5, r56.code.rate, "bpsk"))
    g35 = gain_for(s35, oms.quant.scale)
    d = make(r56, oms)
    compare("K1-MC n1944 r5/6 layered OMS ET 3.5 dB Philox", d,
            d.kernel(seed + 1, s35, g35), d.plain(seed + 1, s35, g35))
    timed["layered"] = (d, (seed + 1, s35, g35), {})
    # lane0: the first lane of a rank's share of a batch split over a
    # process mesh (slice 9b: rank 1 of two at B = 16,384 counts Philox from
    # lane 8,192); its lanes are also the second half of the launch of the
    # whole batch from lane 0
    half = BATCH // 2
    for what, ct, cfg, s, g in (
            ("n648 flooding fixed-20 2.0 dB", wifi, cfg648, s20, g20),
            ("n1944 r5/6 layered OMS ET 3.5 dB", r56, oms, s35, g35)):
        d = make(ct, cfg, batch=half)
        out_k = d.kernel(seed + 3, s, g, lane0=half)
        compare(f"K1-MC {what} Philox lane0={half}", d, out_k,
                d.plain(seed + 3, s, g, lane0=half))
        whole = make(ct, cfg).kernel(seed + 3, s, g)
        same = all(torch.equal(a[half:], b) for a, b in zip(whole, out_k))
        print(f"  == lanes [{half}, {BATCH}) of the launch of {BATCH} "
              f"lanes from lane 0: {same}", flush=True)
        if not same:
            raise AssertionError("K1-MC at lane0 != the whole batch's lanes")
    # per-lane sigma, as run_fused runs it: the fused batch, six points,
    # lane b at point b % 6
    sig6 = np.asarray([sigma_for(e, wifi.code.rate, "bpsk")
                       for e in FUSED["points"]], np.float32)
    point = np.arange(FUSED["batch"]) % len(sig6)
    sl = torch.as_tensor(sig6[point]).to(dev)
    gl = gain_for(sl, cfg648.quant.scale)
    d = make(wifi, cfg648, batch=FUSED["batch"], mc_lane_sigma=True)
    lane_k = d.kernel(seed + 2, sigma_lane=sl, gain_lane=gl)
    compare("K1-MC n648 flooding per-lane sigma (6 points) Philox", d,
            lane_k, d.plain(seed + 2, sigma_lane=sl, gain_lane=gl))
    timed["flood lanes"] = (d, (seed + 2,), dict(sigma_lane=sl, gain_lane=gl))
    scalar = make(wifi, cfg648, batch=FUSED["batch"])
    for i, sg in enumerate(sig6):
        ref = scalar.kernel(seed + 2, sg, gain_for(sg, cfg648.quant.scale))
        sel = torch.as_tensor(point == i).to(dev)
        same = all(torch.equal(a[sel], b[sel]) for a, b in zip(lane_k, ref))
        print(f"  stripe {i} (sigma {sg:.6f}): per-lane form == scalar "
              f"form {same}", flush=True)
        if not same:
            raise AssertionError("per-lane sigma != scalar sigma")
    # the packed flooding instance at ragged and tiny batches: Philox,
    # injected words and per-lane sigma
    for B in RAGGED:
        d = make(wifi, cfg648, batch=B)
        compare("K1-MC n648 flooding fixed-20 2.0 dB Philox", d,
                d.kernel(seed + B, s20, g20), d.plain(seed + B, s20, g20))
    d = make(wifi, cfg648, batch=5, inject_random=True)
    w5 = words[:, :5].contiguous()
    compare("K1-MC n648 flooding fixed-20 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=w5), d.plain(0, s20, g20, words=w5))
    d = make(wifi, cfg648, batch=4099, mc_lane_sigma=True)
    sl5, gl5 = sl[:4099].contiguous(), gl[:4099].contiguous()
    compare("K1-MC n648 flooding per-lane sigma Philox", d,
            d.kernel(seed + 6, sigma_lane=sl5, gain_lane=gl5),
            d.plain(seed + 6, sigma_lane=sl5, gain_lane=gl5))
    # the packed MC instances of the longer register rows: n=1944 r3/4 (row
    # degree 15: DMAX 16) and r5/6 (20: DMAX 24), offset min-sum, fixed-20
    for rate, db in (("3/4", 2.5), ("5/6", 3.0)):
        cfg = dataclasses.replace(
            oms, code=dataclasses.replace(oms.code, rate=rate),
            decoder=dataclasses.replace(oms.decoder, schedule="flooding",
                                        early_term=False, max_iter=20))
        ct = from_reference(build_code(cfg), dev)
        s = np.float32(sigma_for(db, ct.code.rate, "bpsk"))
        g = gain_for(s, cfg.quant.scale)
        d = make(ct, cfg, batch=4099)
        compare(f"K1-MC n1944 r{rate} flooding OMS fixed-20 {db} dB Philox "
                f"(register row {minsum.row_degree_instance(ct)})", d,
                d.kernel(seed + 7, s, g), d.plain(seed + 7, s, g))
    # K2's megakernel (the flooding min-sum family with early termination):
    # the decoder of wifi-648-oms-flood-et with rng=device, injected words
    # and Philox at its batch and at ragged batches; NMS at 4,099
    oms_et = slice_config(port, OMS_ET, "device")
    d = make(wifi, oms_et, inject_random=True)
    compare("K1-MC n648 flooding OMS ET 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=words),
            d.plain(0, s20, g20, words=words))
    d = make(wifi, oms_et)
    compare("K1-MC n648 flooding OMS ET 2.0 dB Philox", d,
            d.kernel(seed + 20, s20, g20), d.plain(seed + 20, s20, g20))
    timed["oms flood et"] = (d, (seed + 20, s20, g20), {})
    for B in RAGGED:
        d = make(wifi, oms_et, batch=B)
        compare("K1-MC n648 flooding OMS ET 2.0 dB Philox", d,
                d.kernel(seed + 21 + B, s20, g20),
                d.plain(seed + 21 + B, s20, g20))
    d = make(wifi, oms_et, batch=5, inject_random=True)
    compare("K1-MC n648 flooding OMS ET 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=w5), d.plain(0, s20, g20, words=w5))
    nms_et = dataclasses.replace(oms_et, decoder=dataclasses.replace(
        oms_et.decoder, algorithm="normalized-min-sum"))
    d = make(wifi, nms_et, batch=4099)
    compare("K1-MC n648 flooding NMS ET 2.0 dB Philox", d,
            d.kernel(seed + 22, s20, g20), d.plain(seed + 22, s20, g20))
    # the min* MC instances (K5 inside K1-MC)
    star = {sched: slice_config(port, "wifi-648-minstar", "device", sched)
            for sched in ("layered", "flooding")}
    d = make(wifi, star["layered"], inject_random=True)
    compare("K1-MC min* n648 layered ET 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=words),
            d.plain(0, s20, g20, words=words))
    d = make(wifi, star["layered"])
    compare("K1-MC min* n648 layered ET 2.0 dB Philox", d,
            d.kernel(seed + 3, s20, g20), d.plain(seed + 3, s20, g20))
    timed["star layered"] = (d, (seed + 3, s20, g20), {})
    d = make(wifi, star["flooding"])
    compare("K1-MC min* n648 flooding ET 2.0 dB Philox", d,
            d.kernel(seed + 4, s20, g20), d.plain(seed + 4, s20, g20))
    timed["star flood"] = (d, (seed + 4, s20, g20), {})
    fixed = dataclasses.replace(star["flooding"], decoder=dataclasses.replace(
        star["flooding"].decoder, early_term=False))
    d = make(wifi, fixed)
    compare("K1-MC min* n648 flooding fixed-20 2.0 dB Philox", d,
            d.kernel(seed + 5, s20, g20), d.plain(seed + 5, s20, g20))
    # the packed flooding min* MC instances at ragged batches, and with
    # injected words
    for B in RAGGED[:-1]:
        d = make(wifi, star["flooding"], batch=B)
        compare("K1-MC min* n648 flooding ET 2.0 dB Philox", d,
                d.kernel(seed + 15 + B, s20, g20),
                d.plain(seed + 15 + B, s20, g20))
    d = make(wifi, star["flooding"], batch=5, inject_random=True)
    compare("K1-MC min* n648 flooding ET 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=w5), d.plain(0, s20, g20, words=w5))
    # the packed layered MC instances at ragged and tiny batches, with
    # early termination and fixed, min-sum and min*, Philox and injected
    # words
    oms_fixed = dataclasses.replace(oms, decoder=dataclasses.replace(
        oms.decoder, early_term=False))
    star_fixed = dataclasses.replace(star["layered"], decoder=(
        dataclasses.replace(star["layered"].decoder, early_term=False)))
    for B in RAGGED[:-1]:
        d = make(r56, oms, batch=B)
        compare("K1-MC n1944 r5/6 layered OMS ET 3.5 dB Philox", d,
                d.kernel(seed + 11 + B, s35, g35),
                d.plain(seed + 11 + B, s35, g35))
        d = make(wifi, star["layered"], batch=B)
        compare("K1-MC min* n648 layered ET 2.0 dB Philox", d,
                d.kernel(seed + 12 + B, s20, g20),
                d.plain(seed + 12 + B, s20, g20))
    d = make(r56, oms_fixed, batch=4099)
    compare("K1-MC n1944 r5/6 layered OMS fixed-20 3.5 dB Philox", d,
            d.kernel(seed + 13, s35, g35), d.plain(seed + 13, s35, g35))
    d = make(wifi, star_fixed, batch=4099)
    compare("K1-MC min* n648 layered fixed-20 2.0 dB Philox", d,
            d.kernel(seed + 14, s20, g20), d.plain(seed + 14, s20, g20))
    d = make(wifi, star["layered"], batch=5, inject_random=True)
    compare("K1-MC min* n648 layered ET 2.0 dB inject", d,
            d.kernel(0, s20, g20, words=w5), d.plain(0, s20, g20, words=w5))
    return worst, timed, star_worst


def bf_chain(ct, cfg, ebn0_db, B, gen, backend="auto"):
    """The decoder's input (B, n) as the batch-first step of `cfg` makes it
    at `ebn0_db`: info bits from `gen`, encoded, rate matched, modulated,
    AWGN, demapped, scattered back and quantized."""
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim.pipeline import make_lane_step
    step = make_lane_step(ct, cfg, batch=B, backend=backend)
    sigma = np.float32(sigma_for(ebn0_db, ct.code.rate,
                                 cfg.channel.modulation))
    return step.chain(gen, sigma)[1]


def hold_to_plain(label, d, q, worst):
    """d.kernel(q) == d.plain(q), tolerance 0, for a batch-first decoder
    (a streaming instance, or K3 behind its transposes); the worst error
    goes to `worst` under the instance's or the library's name."""
    out_k = d.kernel(q)
    torch.cuda.synchronize()
    out_p = d.plain(q)
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    key = getattr(d, "variant", None) or d.library
    B = q.shape[0]
    if hasattr(d, "variant"):
        smem, dmax, blocks = d.launch_shape(B)
        if smem != d.smem_bytes(B):
            raise AssertionError(f"{key}: the library's {smem} B is not "
                                 f"the wrapper's {d.smem_bytes(B)} B")
        what = "lanes/thread" if d.packed else "register row"
        shape = f"{d.kernel_name(B)}, {smem} B smem/block" + (
            f", {what} {dmax}, {blocks} blocks/SM" if dmax else "")
    else:
        shape = f"{d.inner.launch_config()[0]} lanes/block"
    print(f"{label} B={q.shape[0]}: max_abs_err {err:g} equal {same} "
          f"(converged {int(out_k[2].sum())}/{q.shape[0]}, mean iters "
          f"{float(out_k[1].double().mean()):.3f}, {key}, {shape})",
          flush=True)
    if not same:
        raise AssertionError(f"kernel != plain on {label}")
    worst[key] = max(worst.get(key, 0.0), err)
    return out_k


def two_lane_forms(port, cfg, schedule):
    """Slice 12's forms of one schedule on a code's preset `cfg`, at
    TWO_LANE_ITERS iterations (OMS beta 2 fixed and with early termination,
    min* fixed and with early termination): form -> (decoder config,
    quantizer, input: "int8" (hard output) or "fused" (float32 LLRs and
    info bits, counting))."""
    oms = dataclasses.replace(cfg.quant, beta_lsb=2)
    star = dataclasses.replace(cfg.quant, beta_lsb=0)
    base = dataclasses.replace(cfg.decoder, schedule=schedule,
                               algorithm="offset-min-sum",
                               max_iter=TWO_LANE_ITERS, early_term=False,
                               phase1_iters=None)
    et = dataclasses.replace(base, early_term=True)
    return {"OMS fixed": (base, oms, "int8"),
            "OMS ET fused-IO": (et, oms, "fused"),
            "min* fixed": (dataclasses.replace(base, algorithm="min-star"),
                           star, "int8"),
            "min* ET": (dataclasses.replace(et, algorithm="min-star"), star,
                        "int8")}


def check_two_lane(port, minsum, dev):
    """Slice 12: every two-lane packed instance (flood_two_lane_kernel,
    layered_two_lane_kernel) == its plain version, tolerance 0 on every
    output: on each code of TWO_LANE_CODES, both schedules, in the forms of
    `two_lane_forms` (fixed, early termination with fused IO, min* fixed
    and with early termination), at each batch of TWO_LANE_BATCHES against
    one plain run at the largest (the decoders are per-lane programs: the
    first B lanes of a run are the run of those lanes). A (code, schedule)
    that a block of four lanes takes (NR BG1 Z=128 rate 1/3, layered) is
    not a two-lane instance and is left out; min* on rows of 27-28 is the
    one-lane template's, held here too. Each launch must count as packed
    exactly when it is a two-lane instance. The megakernel is not built at
    two lanes a thread (no step reaches it: n > 4,096 takes the
    batch-first chain); asking for it on the card raises, for each code and
    schedule. Returns the worst error by instance name."""
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.ops.quantize import quantize
    from ldpc_tpu_torch.ops.rng import word_layout
    rng = np.random.default_rng(12)
    big = max(TWO_LANE_BATCHES)
    worst = {}
    for label, preset, code_kw, sigma in TWO_LANE_CODES:
        cfg = port.PRESETS[preset]
        cfg = dataclasses.replace(cfg, code=dataclasses.replace(
            cfg.code, **code_kw))
        ct = from_reference(build_code(cfg), dev)
        llr, info = channel_llrs(rng, ct, big, cfg.quant.scale, sigma)
        f32 = torch.as_tensor(llr).reshape(ct.nb, ct.Z, big).to(dev)
        bits = torch.as_tensor(info).reshape(ct.kb, ct.Z, big).to(dev)
        for schedule in ("flooding", "layered"):
            if minsum.packed_shape(ct, schedule)[1] == minsum.LANES_PER_THREAD:
                continue
            forms = two_lane_forms(port, cfg, schedule)
            dc, qc, _ = forms["OMS ET fused-IO"]
            mc = minsum.make_decoder(ct, dc, qc, input_scale=qc.scale,
                                     count_info_cols=ct.kb, mc_batch=3,
                                     inject_random=True)
            words = torch.zeros((word_layout(ct.kb, ct.nb, ct.Z)[2], 3),
                                dtype=torch.int32, device=dev)
            launches0 = minsum.kernel_launches
            try:
                mc.kernel(0, np.float32(sigma),
                          np.float32(2 * qc.scale / sigma ** 2), words=words)
            except RuntimeError as e:
                if "not supported" not in str(e):
                    raise
                print(f"12 {label} {schedule} the megakernel at two lanes a "
                      f"thread: refused ({e})", flush=True)
            else:
                raise AssertionError(f"{label} {schedule}: a two-lane "
                                     f"megakernel launched")
            if minsum.kernel_launches != launches0:
                raise AssertionError(f"{label} {schedule}: a refused "
                                     f"megakernel counted as launched")
            for form, (dc, qc, kind) in forms.items():
                fused = kind == "fused"
                chan = f32 if fused else quantize(f32, qc)

                def run(fn, B):
                    """fn on the first B lanes of the held input."""
                    return fn(chan[..., :B].contiguous(),
                              *((bits[..., :B].contiguous(),) if fused
                                else ()))
                d = minsum.make_decoder(
                    ct, dc, qc, input_scale=qc.scale if fused else None,
                    count_info_cols=ct.kb if fused else None)
                two = d.lanes_per_thread == minsum.TWO_LANES
                if d.packed != two or (not two and d.minstar is None):
                    raise AssertionError(f"{label} {schedule} {form}: neither "
                                         f"a two-lane instance nor min* on "
                                         f"the one-lane template")
                want = run(d.plain, big)
                torch.cuda.synchronize()
                oks, err = [], 0.0
                for B in TWO_LANE_BATCHES:
                    packed0 = minsum.packed_launches[d.library]
                    got = run(d.kernel, B)
                    torch.cuda.synchronize()
                    if minsum.packed_launches[d.library] - packed0 != int(
                            two):
                        raise AssertionError(f"{label} {schedule} {form} "
                                             f"B={B}: packed launches")
                    ref = tuple(x[..., :B] for x in want)
                    err = max(err, max_abs_err(got, ref))
                    oks.append(all(torch.equal(a, b)
                                   for a, b in zip(got, ref)))
                name = instance_name(d)
                worst[name] = max(worst.get(name, 0.0), err)
                its = want[-2].double()
                held = zip(TWO_LANE_BATCHES, oks)
                print(f"12 {label} {schedule} {form} ({name}, "
                      f"{shape_text(d)}): max_abs_err {err:g}, equal at "
                      f"B = {', '.join(f'{B} {ok}' for B, ok in held)} "
                      f"(converged {int(want[-1].sum())}/{big}, iters "
                      f"{float(its.min()):.0f}-{float(its.max()):.0f}, mean "
                      f"{float(its.mean()):.3f})", flush=True)
                if not all(oks):
                    raise AssertionError(f"kernel != plain on 12 {label} "
                                         f"{schedule} {form}")
    return worst


# Slice 12's main paths through the CLI (`sweep`, batch 1,024, two points,
# one batch a point): name -> (code, schedule, the instance's min* and
# early termination, argv)
TWO_LANE_CLI = {
    "NR BG1 Z=384 flooding OMS ET": (
        ("nr-bg1-layered", {}), "flooding", False, True,
        ["--preset", "nr-bg1-layered", "--schedule", "flooding",
         "--auto-two-phase", "--ebn0", "1.25,1.5"]),
    "DVB-S2 n=16,200 r1/2 layered min*": (
        ("dvbs2-64800-r12", dict(n=16200)), "layered", True, False,
        ["--preset", "dvbs2-64800-r12", "--n", "16200", "--algorithm",
         "min-star", "--ebn0", "0.9,1.1"]),
}


def check_two_lane_cli(port, minsum, stream):
    """Slice 12's main paths, `python -m ldpc_tpu_torch.cli sweep` driven in
    process (TWO_LANE_CLI; the preset's early_term=False turned on by
    `--auto-two-phase` for the flooding run): each with rng=host and
    rng=device on `auto`, and with rng=host on `--decoder-backend qc` (the
    plain QC decoder). Fails unless each `auto` run launched the schedule's
    library only, every launch packed at two lanes a thread, no plain call,
    and the three runs' counters are equal (n > 4,096, so rng=device takes
    the batch-first chain with the host run's draws, as the reference's
    rule has it: no megakernel). Returns name -> the auto runs' launches."""
    from ldpc_tpu_torch import cli
    from ldpc_tpu_torch.codes import build_code, from_reference
    common = ["--batch", str(STREAM_BATCH), "--max-frames", str(STREAM_BATCH),
              "--target-errors", "1000000000", "--no-checkpoint"]
    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ((preset, code_kw), schedule, star, et, argv) in (
                TWO_LANE_CLI.items()):
            cfg = port.PRESETS[preset]
            ct = from_reference(build_code(dataclasses.replace(
                cfg, code=dataclasses.replace(cfg.code, **code_kw))), "cpu")
            star_deg = max(len(row) for row in ct.entries) if star else 0
            if minsum.packed_shape(ct, schedule, star_deg, et)[1] != (
                    minsum.TWO_LANES):
                raise AssertionError(f"{name}: not a two-lane instance")
            lib = minsum.LIBRARIES[schedule]
            got, launched[name] = {}, 0
            for rng, backend in (("host", "auto"), ("device", "auto"),
                                 ("host", "qc")):
                minsum.reset_counters()
                stream.reset_counters()
                out = os.path.join(tmp, f"{len(launched)}-{len(got)}")
                t0 = time.perf_counter()
                rc = cli.main(["sweep", *argv, *common, "--rng", rng,
                               "--decoder-backend", backend, "--out", out])
                torch.cuda.synchronize()
                with open(out + ".json") as fh:
                    res = json.load(fh)
                libs = dict(minsum.library_launches)
                packed = dict(minsum.packed_launches)
                plain = minsum.plain_calls + stream.plain_calls
                print(f"12 CLI {name} rng={rng} --decoder-backend {backend} "
                      f"({time.perf_counter() - t0:.1f} s, rc {rc}): backend "
                      f"{res['decoder_backend']}, launches {libs}, packed "
                      f"{packed}, streaming {stream.kernel_launches}, plain "
                      f"calls {plain}; " + "; ".join(
                          f"{r['ebn0_db']} dB frames {r['frames']} "
                          f"frame_errs {r['frame_errs']} bit_errs "
                          f"{r['bit_errs']} avg_iters {r['avg_iters']:.4f}"
                          for r in res["results"]), flush=True)
                if rc != 0:
                    raise AssertionError(f"CLI {name}: rc {rc}")
                if backend == "auto":
                    if not (libs[lib] > 0 and packed[lib] == libs[lib]
                            and sum(libs.values()) == libs[lib]
                            and not stream.kernel_launches and not plain
                            and res["decoder_backend"].startswith(
                                "cuda-min")
                            and "-bf" in res["decoder_backend"]):
                        raise AssertionError(f"CLI {name} rng={rng}: not "
                                             f"the two-lane {lib} only")
                    launched[name] += libs[lib]
                elif any(libs.values()) or stream.kernel_launches:
                    raise AssertionError(f"CLI {name} qc: kernels launched")
                got[rng, backend] = [[r[c] for c in COUNTERS]
                                     for r in res["results"]]
            if not (got["host", "auto"] == got["device", "auto"]
                    == got["host", "qc"]):
                raise AssertionError(f"CLI {name}: counters differ: {got}")
            if any(r[0] < STREAM_BATCH for r in got["host", "auto"]):
                raise AssertionError(f"CLI {name}: frames short")
            print(f"  counters equal across auto host, auto device and qc: "
                  f"True", flush=True)
    return launched


def time_two_lane(port, minsum, gpu, dev):
    """Slice 12's times on the card: every form of
    `kernels.probe_two_lane` on NR BG1 Z=384 and DVB-S2 n=16,200 at B =
    1,024, fixed and with early termination, by events and on the device
    alone, with each call's bound; then the decoders of the main paths (the
    CLI runs' K2 and layered min* instances behind their transposes, which
    the kernels line records) and the fixed flooding instance on NR BG1
    Z=384 against their plain versions. Returns timing key -> (ms, plain
    ms, bound ms, bound by) and key -> the decoder timed."""
    from ldpc_tpu_torch.kernels import probe_two_lane as probe
    from ldpc_tpu_torch.sim.pipeline import select_decoder
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    cts = {}
    for code in probe.CODES:
        cts[code] = probe.code_tensors(code, dev)
        probe.kernel_cells(cts[code], code, STREAM_BATCH, gen, 2, None, gpu,
                           lambda rec: print(json.dumps(rec), flush=True))
    timing, decs = {}, {}
    nr = "NR BG1 Z=384"
    for key, code, form, et in (
            ("K2 two-lane", nr, "flooding OMS", True),
            ("K5 layered two-lane", "DVB-S2 n=16,200 r1/2", "layered min*",
             False),
            ("K1 two-lane", nr, "flooding OMS", False)):
        cfg = probe.config(code, form, et)
        d, label = select_decoder(cts[code], cfg, batch=STREAM_BATCH,
                                  backend="pallas")
        args = (probe.channel_q(cts[code], cfg, probe.CODES[code][2],
                                STREAM_BATCH, gen),)
        t = kernel_vs_plain_ms(d, args, {}, gpu, f"{key} ({label}, "
                               f"{instance_name(d)}) on {code}, {form}, "
                               f"{STREAM_BATCH} codewords", plain_reps=1)
        b_ms, b_by = bound_of(d, args, {})
        print(f"  bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / t[0]:.1f}% "
              f"of the kernel's time)", flush=True)
        timing[key], decs[key] = t + (b_ms, b_by), d
    return timing, decs


def check_stream_kernels(port, minsum, stream, dev, worst):
    """The streaming library (K6b-K6f) == its plain version, tolerance 0.
    The matrix, at 10 iterations: DVB-S2 n=64,800 (B=32), n=16,200 (B=128)
    and NR BG1 Z=384 (B=64, 768 punctured variables at LLR 0), OMS beta=2
    and NMS alpha=3/4, fixed iterations and early termination, DVB-S2
    n=64,800 rate 8/9 (B=32), n=16,200 rate 8/9 (B=64) and the (3,30) array
    code (B=64, LLRs of the all-zeros word): every instance that takes the
    code, which must be the set `STREAM_INSTANCES` states (the template's
    streamed placement; the pipelined kernel where its register row holds
    the rows, NR BG1's rows of 22 at its 24-entry row, rate 8/9's 27-28 at
    its 28-entry row, the array code's 30 at its 32-entry row; the
    resident instance, on the packed resident kernel where its block fits,
    else the template) against the plain
    version, hence against each other, and against K3 behind its
    transposes where K3 admits the code;
    an odd batch (B - 1 codewords); an all-zero noiseless batch
    (converged, iters 0 with early termination). Then the packed resident
    kernel on NR BG1 Z=384, n=16,200 and n=16,200 rate 8/9, fixed and with
    early termination, at B = 1, 3, 5, 256 (two lanes a thread), 1,024 and
    4,099 (four), against plain. Then every decoder a
    sweep of slice 5 launches, as `select_decoder` builds it, at that
    sweep's batch and on its step's own LLRs; and the pipelined instance at
    the batch the CLI's preset gives it, 8,192 codewords of n=64,800,
    against the template's `stream-resident` instance on the same input
    (both were held to plain above). Fills `worst` (by instance, and by
    library for K3); returns label -> (the decoder held, its input)."""
    from ldpc_tpu_torch import oracle
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.codes.toy import array_qc
    from ldpc_tpu_torch.config import cn_params
    from ldpc_tpu_torch.kernels import probe_stream
    from ldpc_tpu_torch.sim.pipeline import BatchFirstDecoder, select_decoder
    gen = torch.Generator(device=dev)
    gen.manual_seed(55)
    cfgs = {w: slice_config(port, w, "host")
            for w in (S64800, S64800 + "-et", S16200, NR384, NR128, S89,
                      S89 + "-et", S1689, S1689 + "-et")}
    cts = {w: from_reference(build_code(cfgs[w]), dev)
           for w in (S64800, S16200, NR384, NR128, S89, S1689)}
    for w in (S64800, S89, S1689):
        cts[w + "-et"] = cts[w]
    # the (3,30) array code has no systematic form: LLRs of the all-zeros
    # word, decoded as rate 8/9's configuration decodes
    cts[ARRAY30] = bare_tensors(array_qc(3, 30, 31), dev)
    cfgs[ARRAY30] = cfgs[S1689]
    iters = 10
    for what, db, B in ((S64800, 1.6, 32), (S16200, 1.6, 128),
                        (NR384, 1.5, 64), (S89, 3.0, 32), (S1689, 4.0, 64),
                        (ARRAY30, 2.5, 64)):
        ct, cfg = cts[what], cfgs[what]
        q = (probe_stream.channel_q(ct, cfg, db, B, gen) if what == ARRAY30
             else bf_chain(ct, cfg, db, B, gen))
        zero = torch.full((B, ct.n), 8, dtype=torch.int8, device=dev)
        for alg in ("offset-min-sum", "normalized-min-sum"):
            for et in (False, True):
                dc = dataclasses.replace(cfg.decoder, algorithm=alg,
                                         early_term=et, max_iter=iters)
                what_dec = (f"{what} {alg} {'ET' if et else 'fixed'}-{iters} "
                            f"{db} dB")
                beta, alpha = cn_params(dc, cfg.quant)
                decs = probe_stream.decoders(ct, iters, beta,
                                             cfg.quant.qmax, alpha, et)
                want_set = {v + "-et" if et else v
                            for v in STREAM_INSTANCES[what]}
                got_set = {d.variant for d in decs.values()}
                if got_set != want_set:
                    raise AssertionError(f"{what_dec}: the instances that "
                                         f"take the code are {got_set}, "
                                         f"expected {want_set}")
                plain = next(iter(decs.values())).plain(q)
                for name, d in decs.items():
                    ids = "/".join(k for k, _ in stream.REPLACES[d.variant])
                    out = hold_to_plain(f"{ids} {name} {what_dec}", d, q,
                                        worst)
                    if not all(torch.equal(a, b) for a, b in zip(out, plain)):
                        raise AssertionError(f"{d.variant} differs from the "
                                             f"other instance on {what_dec}")
                    if what not in (NR384, ARRAY30):
                        want = oracle.decode_batch(
                            q[:8].cpu().numpy(), ct.code, max_iter=iters,
                            beta=d.beta, qmax=d.qmax, schedule="layered",
                            early_term=et, alpha=d.alpha)
                        ok = all(np.array_equal(a[:8].cpu().numpy(), b)
                                 for a, b in zip(out, want))
                        print(f"  the C oracle on the first 8 frames == the "
                              f"kernel {ok}", flush=True)
                        if not ok:
                            raise AssertionError(f"{d.variant} != the C "
                                                 f"oracle on {what_dec}")
                    hz, iz, cz = d.kernel(zero)
                    want = 0 if et else iters
                    ok = (int(hz.sum()) == 0 and bool(cz.all())
                          and bool((iz == want).all()))
                    print(f"  all-zero noiseless batch: hard 0, converged, "
                          f"iters {want} on every lane {ok}", flush=True)
                    if not ok:
                        raise AssertionError(f"{d.variant} all-zero batch")
                    odd = d.kernel(q[: B - 1].contiguous())
                    ok = all(torch.equal(a, b[: B - 1])
                             for a, b in zip(odd, plain))
                    print(f"  odd batch of {B - 1}: == plain {ok}",
                          flush=True)
                    if not ok:
                        raise AssertionError(f"{d.variant} odd batch")
                if minsum.onchip_domain(ct, dc, cfg.quant) is None:
                    k3 = BatchFirstDecoder(
                        minsum.make_decoder(ct, dc, cfg.quant)).kernel(q)
                    ok = all(torch.equal(a, b) for a, b in zip(k3, plain))
                    print(f"  K3 behind its transposes == the streaming "
                          f"instances {ok}", flush=True)
                    if not ok:
                        raise AssertionError(f"K3 != stream on {what_dec}")
    # the packed resident kernel (K6d, K6e) on the codes it takes, at the
    # main paths' batches 256 (two lanes a thread) and 1,024 (four) and the
    # ragged batches 1, 3, 5 (two) and 4,099 (four, the last block
    # partial): == plain on hard bits, iters and conv (its own draws: the
    # slices' inputs below stay those of the parent commit's script)
    gen_r = torch.Generator(device=dev)
    gen_r.manual_seed(56)
    for what, db in ((NR384, 1.25), (S16200, 1.6), (S1689, 3.75)):
        ct, cfg = cts[what], cfgs[what]
        beta, alpha = cn_params(cfg.decoder, cfg.quant)
        for et in (False, True):
            d = stream.make_stream_decoder(
                ct, max_iter=iters, beta=beta, qmax=cfg.quant.qmax,
                alpha=alpha, early_term=et, resident=True)
            for B in (1, 3, 5, 256, 1024, 4099):
                q = bf_chain(ct, cfg, db, B, gen_r)
                lanes = d.lanes_for(B, dev)
                if lanes != (2 if B <= 256 else 4):
                    raise AssertionError(f"{what}: {lanes} lanes a thread at "
                                         f"B = {B}")
                hold_to_plain(
                    f"{'K6e' if et else 'K6d'} lanes={lanes} {what} OMS "
                    f"{'ET' if et else 'fixed'}-{iters} {db} dB", d, q,
                    worst)
    held = {}
    for sl in SLICES:
        if not sl.label.startswith("5") or sl.backend == "qc":
            continue
        ct, cfg = cts[sl.what], cfgs[sl.what]
        d, label = select_decoder(ct, cfg, batch=sl.batch,
                                  backend=sl.backend)
        if label != sl.expect:
            raise AssertionError(f"{sl.label}: {label}, expected {sl.expect}")
        q = bf_chain(ct, cfg, sl.points[0], sl.batch, gen, sl.backend)
        hold_to_plain(f"{sl.label} ({label}) {sl.points[0]} dB", d, q, worst)
        held[sl.label] = (d, q)
    # the CLI's launch: `--preset dvbs2-64800-r12` decodes 8,192 codewords a
    # batch (2.9 GB of kernel scratch, indexed with size_t)
    ct, cfg = cts[S64800], cfgs[S64800]
    B = port.PRESETS["dvbs2-64800-r12"].run.batch
    q = bf_chain(ct, cfg, 1.0, B, gen)
    d, label = select_decoder(ct, cfg, batch=B)
    other = stream.make_decoder(ct, cfg.decoder, cfg.quant, resident=True)
    if (label, other.variant) != ("cuda-stream-pipelined",
                                  "stream-resident"):
        raise AssertionError(f"the preset's decoder is {label}")
    out, want = d.kernel(q), other.kernel(q)
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(out, want))
    print(f"{label} at the preset's batch B={B}, 1.0 dB: == stream-resident "
          f"{ok} (converged {int(out[2].sum())}/{B})", flush=True)
    if not ok or not 0 < int(out[2].sum()) < B:
        raise AssertionError("stream-pipelined != stream-resident at the "
                             "CLI's batch")
    del d, other, out, want, q
    torch.cuda.empty_cache()
    return held


def check_recorded_kernels(port, dev):
    """Slices 10 and 11b-11d's decoders against their plain versions,
    tolerance 0 on every output, each as `select_decoder` builds it for its
    sweep (label the row's `expect`), at the row's batch, on the row's own
    input at its first point: the float LLRs and info bits of the
    batch-last fused-IO step (K2 at qmax 3, 7, 15, 31, its in-kernel
    quantizer at the study's scales; K3 on 802.11n n=648, 1296 and 1944 at
    rates 1/2-5/6, BPSK and 16-QAM, the check-node variants and the QC-PEG
    codes), else the quantized LLRs of the batch-first step (K6e on 8PSK
    and on 16APSK rate 2/3, K3 behind its transposes on NR BG2 and on the
    punctured 802.11n and PBRL codes). A decoder whose instance
    (`instance_of`) and batch an earlier row's was is held once, on that
    row's input. Prints each one's kernel instance and launch shape.
    Returns label -> (decoder, arguments, worst error); the float route has
    no kernel."""
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.sim.pipeline import select_decoder
    gen = torch.Generator(device=dev)
    gen.manual_seed(57)
    held, by_instance = {}, {}
    for sl in SLICES:
        if not sl.label.startswith(("10", "11")):
            continue
        cfg = slice_config(port, sl.what, sl.rng)
        ct = from_reference(build_code(cfg), dev)
        d, label = select_decoder(ct, cfg, batch=sl.batch)
        if label != sl.expect:
            raise AssertionError(f"{sl.label}: {label}, expected {sl.expect}")
        if label == "torch-float":
            continue
        key = (instance_of(d), sl.batch)
        if key in by_instance:
            first, entry = by_instance[key]
            held[sl.label] = entry
            print(f"{sl.label} ({label}): the instance held on {first}'s "
                  f"input", flush=True)
            continue
        what = f"{sl.label} ({label}) {sl.points[0]} dB"
        worst = {}
        if hasattr(d, "inner") or hasattr(d, "variant"):    # batch first
            args = (bf_chain(ct, cfg, sl.points[0], sl.batch, gen),)
            hold_to_plain(what, d, args[0], worst)
            if hasattr(d, "inner"):
                print(f"  {instance_name(d)}, {shape_text(d.inner)}",
                      flush=True)
        else:
            args = chain_args(ct, cfg, sl.points[0], sl.batch, gen)
            out_k = d.kernel(*args)
            torch.cuda.synchronize()
            out_p = d.plain(*args)
            torch.cuda.synchronize()
            worst[d.library] = max_abs_err(out_k, out_p)
            same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
            print(f"{what} B={sl.batch}: max_abs_err {worst[d.library]:g} "
                  f"equal {same} (frame errors {int(out_k[1].sum())}, "
                  f"converged {int(out_k[3].sum())}, mean iters "
                  f"{float(out_k[2].double().mean()):.3f}; qmax "
                  f"{d.quant.qmax}, scale {d.input_scale}; {d.library} "
                  f"{instance_name(d)}, {shape_text(d)})", flush=True)
            if not same:
                raise AssertionError(f"kernel != plain on {what}")
        held[sl.label] = (d, args, max(worst.values()))
        by_instance[key] = (sl.label, held[sl.label])
    return held


def demapped(mod, bits, noise, sigma, where, first):
    """(symbols, LLRs, LLRs quantized at 8 bits and scale 4) of bits (B, n)
    and standard-normal draws in the batch-first layout, computed on device
    `where`, batch first (`modulate`, `awgn`, `demap`) or batch last
    (`modulate_t`, `awgn_t`, `demap_t`), each brought to the CPU."""
    from ldpc_tpu_torch.config import QuantConfig
    from ldpc_tpu_torch.ops import channel as ch
    from ldpc_tpu_torch.ops.quantize import quantize
    if not first:
        bits, noise = bits.T, np.moveaxis(noise, 0, -1)
    b = torch.as_tensor(np.ascontiguousarray(bits)).to(where)
    z = torch.as_tensor(np.ascontiguousarray(noise)).to(where)
    if first:
        x = ch.modulate(b, mod)
        llr = ch.demap(ch.awgn(None, x, sigma, noise=z), sigma, mod)
    else:
        x = ch.modulate_t(b, mod)
        llr = ch.demap_t(ch.awgn_t(None, x, sigma, noise=z), sigma, mod)
    return x.cpu(), llr.cpu(), quantize(llr, QuantConfig()).cpu()


def check_demap(dev):
    """The channel's seven modulations on the card against the CPU: equal
    bits (numpy, a seed) modulated batch first and batch last must give
    equal symbols; with equal standard-normal draws at the modulation's
    sigma for rate 1/2 at 3.0 dB, the demapped LLRs quantized at 8 bits may
    differ by one LSB on at most 1e-4 of the entries (the tolerance of the
    megakernel's float stage against XLA's libm)."""
    from ldpc_tpu_torch.ops import channel as ch
    rng = np.random.default_rng(58)
    n, B = 1920, 2048           # 1,920 bits fill symbols of 1 to 6 bits
    for mod, m in ch.BITS_PER_SYM.items():
        sigma = np.float32(ch.sigma_for(3.0, 0.5, mod))
        bits = rng.integers(0, 2, (B, n), dtype=np.uint8)
        noise = rng.standard_normal(
            (B, n) if m == 1 else (B, n // m, 2)).astype(np.float32)
        for first in (True, False):
            (xc, lc, qc), (xh, lh, qh) = (
                demapped(mod, bits, noise, sigma, where, first)
                for where in (dev, torch.device("cpu")))
            diff = (qc.to(torch.int32) - qh.to(torch.int32)).abs()
            off, worst = int((diff > 0).sum()), int(diff.max())
            same_x = torch.equal(xc, xh)
            ok = same_x and worst <= 1 and off <= 1e-4 * diff.numel()
            print(f"demap {mod} {'batch first' if first else 'batch last'} "
                  f"{tuple(lc.shape)}: symbols equal {same_x}; float LLRs "
                  f"max |diff| {float((lc - lh).abs().max()):g}; quantized "
                  f"LLRs off by one LSB {off} of {diff.numel()}, worst "
                  f"{worst}: {ok}", flush=True)
            if not ok:
                raise AssertionError(f"the {mod} demap on the card differs "
                                     f"from the CPU's")


def fused_lane_variances(sweep, rb, sigmas, min_failed=100,
                         max_batches=200):
    """Per-frame variances (bit errors, iterations) of each point: from
    fused batch 0, re-drawn through the step's own parts (fails unless its
    sums are the step's), and, for a point whose stripe holds fewer than
    `min_failed` failed frames, from further single-point megakernel
    batches at its sigma (seeds (seed, 1 + point, b), which the sweep
    never uses) until it does or `max_batches` ran: at low FER the bit
    errors of batch 0 are all zero, which would make the z-test exact."""
    from ldpc_tpu_torch.sim.pipeline import make_lane_step
    from ldpc_tpu_torch.sim.sweep import batch_seed
    P = len(sigmas)
    step = make_lane_step(sweep.ct, sweep.cfg, batch=sweep.batch,
                          n_points=P)
    bits, frame, iters, _ = step(sweep.draw(0, 0), sigmas)
    want = rb(sweep.draw(0, 0), sigmas)
    got = bits.to(torch.int64).reshape(-1, P).sum(dim=0)
    if not torch.equal(got, want[1]):
        raise AssertionError("re-drawn fused batch differs from the step's")
    single = make_lane_step(sweep.ct, sweep.cfg, batch=sweep.batch)
    out = []
    for i, sg in enumerate(sigmas):
        b, it = bits[i::P].double(), iters[i::P].double()
        sums = torch.stack([b.sum(), (b * b).sum(), it.sum(),
                            (it * it).sum()])
        count, failed, n = b.numel(), int(frame[i::P].sum()), 0
        while failed < min_failed and n < max_batches:
            bb, ff, ii, _ = single(batch_seed(sweep.cfg.run.seed, 1 + i, n),
                                   sg)
            bb, ii = bb.double(), ii.double()
            sums += torch.stack([bb.sum(), (bb * bb).sum(), ii.sum(),
                                 (ii * ii).sum()])
            count += bb.numel()
            failed += int(ff.sum())
            n += 1
        s1, s2, t1, t2 = (float(x) / count for x in sums.tolist())
        out.append((s2 - s1 * s1, t2 - t1 * t1, count, failed))
    return out


def check_fused(port, minsum, stream, checked):
    """Slice 3: the fused device-RNG sweep against its recorded waterfall,
    through a decoder of the shape `checked` (phase 4's per-lane-sigma
    decoder); returns (result, flooding MC launches, the sweep's decoder)."""
    f = FUSED
    cfg = slice_config(port, f["preset"], "device", batch=f["batch"],
                       target_frame_errors=f["target"],
                       max_frames=f["max_frames"])
    return run_fused_slice("slice 3 run_fused", minsum, stream, cfg,
                           f["points"], f["ref"], checked)


def check_deep_tail(port, minsum, stream, checked):
    """Slice 10g: results/wifi648_deep_tail.json's own configuration (the
    canonical min-sum, flooding, fixed-20, rng="device", batch 18,432) and
    stop rule (100 frame errors, at most 50,000,000 frames a point: nothing
    cut) through `run_fused` at the file's four points, on the instance
    slice 3 runs. Its rows are held at the family-wise z of four. The file
    has no error in 50M frames at 4.5 and 5.0 dB, nor need this run's
    variance batches (at most 1,000 a point, until 10 failed frames) see
    any: each BER variance is the larger of theirs and the least this run's
    own row allows (its bit errors spread evenly over its failed frames), so
    a row's BER test asks what its FER test asks where failures are few."""
    cfg = recorded_config(port, DEEP_TAIL)
    rc = cfg.run
    points = tuple(read_ref(DEEP_TAIL))
    res = run_fused_slice("slice 10g run_fused", minsum, stream, cfg, points,
                          DEEP_TAIL, checked, z=family_z(len(points)),
                          least_row=True,
                          var_kw=dict(min_failed=10, max_batches=1000))
    for p in res[0].points:
        if p.frame_errs < rc.target_frame_errors and p.frames < rc.max_frames:
            raise AssertionError(f"slice 10g stopped at {p.ebn0_db} dB "
                                 f"before its stop rule")
    return res


def run_fused_slice(label, minsum, stream, cfg, points, ref_name, checked,
                    z=2.576, least_row=False, var_kw=None):
    """`Sweep(cfg, device="cuda").run_fused(points)` through the flooding
    K1-MC instance only, on a decoder of the shape `checked`, against the
    recorded rows of `ref_name`: FER and the converged rate by Wilson
    intervals, BER by the per-frame z-test at `z` (variances from
    `fused_lane_variances(**var_kw)`; with `least_row`, at least the least
    the row itself allows), iterations exactly 20. Returns (result,
    launches, the sweep's decoder)."""
    from ldpc_tpu_torch.sim import Sweep
    from ldpc_tpu_torch.sim.stats import wilson_interval
    ref = read_ref(ref_name)
    sweep = Sweep(cfg, device="cuda")
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    res = sweep.run_fused(list(points))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(minsum, stream, sweep, label, True)
    rb = sweep.fused_run_batch(len(points))
    same_instance(rb.decoder, checked, label)
    sig = np.asarray([sweep._sigma(e) for e in points], np.float32)
    var = fused_lane_variances(sweep, rb, sig, **(var_kw or {}))
    k = sweep.code.k_eff
    frames = sum(p.frames for p in res.points)
    print(f"{label}: {launches} launches of {sweep.batch} codewords, "
          f"{frames} frames in {wall:.3f} s; against {ref_name}"
          + (f" (per-frame z-tests at z = {z:.3f})" if z != 2.576 else ""),
          flush=True)
    for i, row in enumerate(res.rows()):
        r = ref[row["ebn0_db"]]
        var_b, var_i, count, failed = var[i]
        if least_row:
            var_b = max(var_b, least_bit_variance(row))
        oks = rows_compatible(row, r, k, var_b, var_i, z)
        lo, hi = wilson_interval(r["frame_errs"], r["frames"])
        print_row(row, r, var_b, var_i, oks, f"; variances from {count} "
                  f"frames, {failed} failed; FER inside the file's interval "
                  f"{lo <= row['fer'] <= hi}")
        if not all(oks[:4]) or row["avg_iters"] != 20.0 or row["frames"] <= 0:
            raise AssertionError(f"{label} disagrees with {ref_name} at "
                                 f"{row['ebn0_db']} dB")
    return res, launches, rb.decoder


def check_cli(res):
    """The CLI's fused device-RNG sweep must give slice 3's counters."""
    f = FUSED
    keys = ("ebn0_db", "frames", "bit_errs", "frame_errs", "avg_iters",
            "early_term_rate")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fused_mc")
        cmd = [sys.executable, "-m", "ldpc_tpu_torch.cli", "sweep",
               "--preset", f["preset"], "--rng", "device", "--fused",
               "--ebn0", "1.0:3.5:0.5", "--batch", str(f["batch"]),
               "--target-errors", str(f["target"]), "--max-frames",
               str(f["max_frames"]), "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
        with open(out + ".json") as fh:
            got = json.load(fh)
    want = [{k: row[k] for k in keys} for row in res.rows()]
    got_rows = [{k: row[k] for k in keys} for row in got["results"]]
    print(f"CLI ({time.perf_counter() - t0:.1f} s, backend "
          f"{got['decoder_backend']}): counters equal slice 3's "
          f"{got_rows == want}", flush=True)
    if got_rows != want:
        raise AssertionError(f"CLI counters {got_rows} != {want}")


def check_cli_long():
    """The long-codeword command lines on the card, at once: `sweep
    --preset dvbs2-64800-r12` with nothing but a point and a frame limit
    (the preset's batch of 8,192) must run on the pipelined kernel and, at
    1.5 dB, decode every frame; `--puncture-frac 0.25` on the default code
    must run on K1 behind the batch-first step, and give the plain QC
    decoder's counters on equal draws (`--decoder-backend qc`)."""
    punct = ["--puncture-frac", "0.25", "--ebn0", "2.0,3.0", "--batch",
             "4096", "--max-frames", "16384", "--target-errors", "1000000"]
    runs = {"dvbs2": ["--preset", "dvbs2-64800-r12", "--ebn0", "1.5",
                      "--max-frames", "8192"],
            "punctured": punct,
            "punctured, plain": punct + ["--decoder-backend", "qc"]}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, argv) in enumerate(runs.items()):
            cmd = [sys.executable, "-m", "ldpc_tpu_torch.cli", "sweep",
                   *argv, "--no-checkpoint", "--out",
                   os.path.join(tmp, f"run{i}")]
            procs[name] = (i, subprocess.Popen(
                cmd, cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        got = {}
        try:
            for name, (i, proc) in procs.items():
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(
                        f"CLI {name} failed ({proc.returncode}):\n"
                        f"{err[-3000:]}")
                with open(os.path.join(tmp, f"run{i}.json")) as fh:
                    got[name] = json.load(fh)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
    for name, res in got.items():
        print(f"CLI {name}: backend {res['decoder_backend']}, k {res['k']}, "
              + "; ".join(f"{r['ebn0_db']} dB frames {r['frames']} frame_errs "
                          f"{r['frame_errs']} bit_errs {r['bit_errs']} "
                          f"avg_iters {r['avg_iters']:.4f}"
                          for r in res["results"]), flush=True)
    print(f"  three command lines in {time.perf_counter() - t0:.1f} s",
          flush=True)
    row = got["dvbs2"]["results"][0]
    if (got["dvbs2"]["decoder_backend"] != "cuda-stream-pipelined"
            or row["frames"] < 8192 or row["frame_errs"] != 0):
        raise AssertionError("CLI --preset dvbs2-64800-r12 at 1.5 dB")
    a, b = got["punctured"], got["punctured, plain"]
    if (a["decoder_backend"], b["decoder_backend"]) != ("cuda-minsum-bf",
                                                        "torch-qc"):
        raise AssertionError("CLI --puncture-frac: backends")
    if [[r[c] for c in COUNTERS] for r in a["results"]] != [
            [r[c] for c in COUNTERS] for r in b["results"]]:
        raise AssertionError("CLI --puncture-frac: K1 behind the batch-first "
                             "step and the plain QC decoder differ")
    if a["results"][0]["frames"] < 16384:
        raise AssertionError("CLI --puncture-frac: frames short")


def floor_config(port):
    """scripts/make_error_floor.py's normalized-min-sum configuration:
    802.11n n=648 rate 1/2, 8 bits at scale 4, beta_lsb 0, layered, at
    most 20 iterations, early termination."""
    return port.SimConfig(
        quant=port.QuantConfig(bits=8, scale=4.0, beta_lsb=0),
        decoder=port.DecoderConfig(algorithm=FLOOR["alg"], max_iter=20,
                                   schedule="layered"))


def floor_z(a, b):
    """|a - b| over both standard errors in quadrature (dicts with fer and
    rel_std; an estimate with no error, rel_std None, holds to nothing)."""
    if a["rel_std"] is None or b["rel_std"] is None:
        return float("inf")
    se = math.hypot(a["fer"] * a["rel_std"], b["fer"] * b["rel_std"])
    return abs(a["fer"] - b["fer"]) / se


def only_launches(minsum, stream, label, want, kernel="minsum_layered"):
    """Fails unless the runs since the counters' reset launched `kernel`
    `want` times and nothing else, with no plain call: an on-chip library
    (its packed instance, no min* and no MC) or a streaming library
    instance (`StreamDecoder.variant`)."""
    launches, packed = dict(minsum.library_launches), dict(
        minsum.packed_launches)
    inst = dict(stream.instance_launches)
    plain = minsum.plain_calls + stream.plain_calls
    print(f"{label}: kernel launches {launches}, packed {packed}, min* "
          f"{dict(minsum.star_launches)}, MC {dict(minsum.mc_launches)}, "
          f"streaming {inst}, plain_calls {plain}", flush=True)
    on_chip = kernel in launches
    got = {**launches, **inst}
    if (got[kernel] != want or plain
            or any(v for k, v in got.items() if k != kernel)
            or (on_chip and packed[kernel] != want)
            or minsum.kernel_launches != (want if on_chip else 0)
            or stream.kernel_launches != (0 if on_chip else want)
            or any(minsum.star_launches.values())
            or any(minsum.mc_launches.values())):
        raise AssertionError(f"{label}: expected {want} launches of "
                             f"{kernel} and nothing else")
    return want


def check_floor(port, minsum, stream, gpu):
    """Slice 7, error floor (`sim/impsamp.py`, `analysis/`, the CLI's
    `floor`). 7a: one batch each of `make_is_run`, its stratified form and
    `make_symmetric_run` on 7b's radial-ladder proposal with injected
    draws: the decoder (`cuda-...`, K3's packed layered kernel behind the
    batch-first transposes) equals its plain version on the batch's own
    quantized LLRs, and so do the sums with tolerance 0; the three runs
    launch the packed instance three times, nothing plain. 7b: the
    protocol of scripts/make_error_floor.py for normalized min-sum, at
    full size, against results/error_floor_wifi648.json (MC and IS at 2.6
    and 3.0 dB, the file's frames; each row to the file's at z = 3.02, and
    IS to MC at each point), and the IS batch's time at 3.0 dB beside its
    decode kernel's. 7c: plain MC through the IS chain on NR BG1 Z=128 rate
    1/3 at 0.5 dB against results/nr_bg1_z128_r13.json. 7d: the CLI's
    `floor`, stratified with `--exact-sets 8,3,3` and `--symmetric
    --seeds 1,2`, at small frame counts. Returns K3's launches on 7b."""
    from ldpc_tpu_torch.analysis import (classify, dominant_sets,
                                         enumerate_sets, refine_support,
                                         search_trapping_sets)
    from ldpc_tpu_torch.codes import build_code
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import impsamp
    from ldpc_tpu_torch.sim.stats import rates_compatible
    from ldpc_tpu_torch.utils.profiling import event_ms
    f, dev = FLOOR, torch.device("cuda")
    B = f["batch"]
    cfg = floor_config(port)
    code = build_code(cfg)
    with open(os.path.join(HERE, "results", f["ref"])) as fh:
        ref = json.load(fh)["algorithms"][f["alg"]]
    secs = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sup = impsamp.harvest_error_supports(
        code, cfg, f["harvest_ebn0"], frames=f["harvest_frames"], batch=B,
        seed=f["harvest_seed"], device=dev, max_supports=512)
    lap("harvest", t0)
    t0 = time.perf_counter()
    cores = sorted({refine_support(code, s) for s in sup[:128]
                    if len(s) <= 24}, key=lambda s: sorted(s))
    found = search_trapping_sets(code, a_max=10, b_max=4, seeds=cores,
                                 max_sets=768)
    lap("refine + search", t0)
    t0 = time.perf_counter()
    census = enumerate_sets(code, a_max=8, b_max=3, dv_cap=3, emit_min_a=4,
                            emit_cap=200_000)
    absorbing = sorted([(a, b, S) for (a, b, fl, S) in census.sets if fl],
                       key=lambda t: (t[0] + t[1], t[0]))
    lap("census", t0)
    dom = list(dict.fromkeys(
        [frozenset(S) for (_, _, S) in absorbing[:40]]
        + [c for c in cores if 3 <= len(c) <= 16]
        + dominant_sets(found, k=48, min_a=4)))[:64]
    classes = sorted({classify(code, s) for s in dom})
    is_sets, is_deltas = impsamp.expand_radial([sorted(s) for s in dom],
                                               f["depths"])
    print(f"7b proposal: {len(sup)} harvested failures -> {len(cores)} "
          f"cores; {len(absorbing)} exact absorbing sets (a<=8 b<=3 dv<=3; "
          f"the file: {ref['harvest']['exact_absorbing_a8b3']}) -> "
          f"{len(dom)} supports x {len(f['depths'])} depths = "
          f"{len(is_sets)} components; classes {classes}", flush=True)
    if (len(absorbing) != ref["harvest"]["exact_absorbing_a8b3"]
            or census.emit_truncated or len(dom) != 64 or not sup):
        raise AssertionError("slice 7: the proposal is not the file's")

    t0 = time.perf_counter()
    run_mc = impsamp.make_is_run(code, cfg, [], batch=B, device=dev)
    run_is = impsamp.make_is_run(code, cfg, is_sets, delta=is_deltas,
                                 batch=B, pi0=f["pi0"], stratify=True,
                                 device=dev)
    run_multi = impsamp.make_is_run(code, cfg, is_sets, delta=is_deltas,
                                    batch=B, pi0=f["pi0"], device=dev)
    reps = sorted({impsamp.canonical_rotation(code, s) for s in dom})
    reps_x, reps_d = impsamp.expand_radial(reps, f["depths"])
    run_sym = impsamp.make_symmetric_run(code, cfg, reps_x, delta=reps_d,
                                         pi0=f["pi0"], batch=B, device=dev)
    lap("build runs", t0)
    for name, run in (("MC", run_mc), ("IS", run_is), ("IS multinomial",
                                                       run_multi),
                      ("symmetric", run_sym)):
        print(f"  {name} run: decoder {run.backend_label} "
              f"({instance_name(run.decoder)}, {shape_text(run.decoder.inner)}"
              f")", flush=True)
        if (run.backend_label != "cuda-minsum-layered-bf"
                or not run.decoder.inner.packed):
            raise AssertionError(f"slice 7 {name}: not K3's packed kernel")

    # 7a: the datapath, kernel against plain on each run's own LLRs
    rng = np.random.default_rng(77)
    sigma = np.float32(sigma_for(3.0, code.rate, "bpsk"))
    eps = torch.as_tensor(rng.standard_normal((B, code.n)).astype(
        np.float32), device=dev)

    def comps(run):
        """Each lane's mixture component, drawn from the run's mixture."""
        return torch.as_tensor(rng.choice(run.K + 1, size=B, p=run.pis),
                               device=dev)
    cases = {"make_is_run": (run_multi, None, comps(run_multi)),
             "make_is_run stratified": (
                 run_is, impsamp._apportion(run_is.pis, B), None),
             "make_symmetric_run": (run_sym, None, comps(run_sym))}
    sums = {}
    for name, (run, counts, comp) in cases.items():
        q, w, c = run.chain(None, sigma, counts, eps=eps, comp=comp)
        out_k = run.decoder.kernel(q)
        out_p = run.decoder.plain(q)
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        s_k, s_p = run.tally(out_k[0], w, c), run.tally(out_p[0], w, c)
        torch.cuda.synchronize()
        equal = torch.equal(s_k, s_p)
        print(f"7a {name} at 3.0 dB, B={B} ({run.backend_label}): hard "
              f"bits, iters, conv == plain {same} (max_abs_err "
              f"{max_abs_err(out_k, out_p):g}; failed frames "
              f"{int(out_k[0].any(dim=1).sum())}, shifted lanes "
              f"{int((c > 0).sum())}); sums == plain {equal}: "
              f"{(s_k[:, -1] if name == 'make_symmetric_run' else s_k.sum(dim=1) if s_k.ndim == 2 else s_k).tolist()}",
              flush=True)
        if not (same and equal) or int(out_k[0].any(dim=1).sum()) == 0:
            raise AssertionError(f"slice 7a {name}: kernel != plain")
        sums[name] = s_k
    minsum.reset_counters()
    stream.reset_counters()
    for name, (run, counts, comp) in cases.items():
        if not torch.equal(run(None, sigma, counts, eps=eps, comp=comp),
                           sums[name]):
            raise AssertionError(f"slice 7a {name}: the run's sums differ")
    torch.cuda.synchronize()
    only_launches(minsum, stream, "7a the three IS batches", len(cases))

    # 7b: the recorded floor, the file's frames
    minsum.reset_counters()
    stream.reset_counters()
    rows = {"mc": {}, "is": {}}
    n_batches = 0
    for kind, run, seed in (("mc", run_mc, f["mc_seed"]),
                            ("is", run_is, f["is_seed"])):
        t0 = time.perf_counter()
        for e in f["points"]:
            frames = (f["mc_frames"] if kind == "mc" else f["is_frames"]
                      * (4 if 2.8 <= e <= 3.9 else 1))
            est = impsamp.estimate_fer(code, cfg, [] if kind == "mc"
                                       else is_sets, e, frames, batch=B,
                                       seed=seed, run=run)
            rows[kind][e] = est.to_dict()
            n_batches += est.frames // B
        lap(f"{kind.upper()} estimates", t0)
    k3_launches = only_launches(minsum, stream, "7b MC and IS",
                                 n_batches)
    file_rows = {kind: {r["ebn0_db"]: r for r in ref[kind]}
                 for kind in ("mc", "is")}
    bad = []
    for e in f["points"]:
        for kind in ("mc", "is"):
            got, want = rows[kind][e], file_rows[kind][e]
            z = floor_z(got, want)
            ok = z <= f["z"] and got["frames"] == want["frames"]
            print(f"7b {kind.upper()} {e} dB: FER {got['fer']:.4e} (rel. "
                  f"{got['rel_std']}, {got['frames']} frames, "
                  f"{got['raw_hits']} raw hits, BER {got['ber']:.4e}); file "
                  f"{want['fer']:.4e} (rel. {want['rel_std']:.4f}, "
                  f"{want['frames']} frames); z {z:.3f} <= {f['z']:.3f} {ok}",
                  flush=True)
            if not ok:
                bad.append(f"{kind} {e}")
        z = floor_z(rows["is"][e], rows["mc"][e])
        print(f"7b IS against MC at {e} dB: z {z:.3f} <= {f['z']:.3f} "
              f"{z <= f['z']}", flush=True)
        if not z <= f["z"]:
            bad.append(f"is-mc {e}")
    if bad:
        raise AssertionError(f"slice 7b disagrees: {bad}")

    # the IS batch at 3.0 dB: host clock (synced) beside its decode kernel
    sig30 = np.float32(sigma_for(3.0, code.rate, "bpsk"))
    cj = torch.as_tensor(impsamp._apportion(run_is.pis, B), device=dev)

    def is_batch(i):
        return run_is(impsamp._generator(dev, f["is_seed"], 3.0, i), sig30,
                      cj).tolist()
    for i in range(3):
        is_batch(i)
    host = []
    for i in range(10):
        t0 = time.perf_counter()
        is_batch(i)
        host.append((time.perf_counter() - t0) * 1e3)
    q, w, c = run_is.chain(impsamp._generator(dev, f["is_seed"], 3.0, 0),
                           sig30, cj)
    inner = run_is.decoder.inner
    q_t = q.T.reshape(inner.ct.nb, inner.ct.Z, B).contiguous()
    hard = run_is.decoder.kernel(q)[0]
    z = torch.randn((B, code.n), device=dev)
    parts = {   # the batch's pieces on the same inputs, CUDA events
        "chain (draws, shift, weights, demap, quantize)": lambda: (
            run_is.chain(impsamp._generator(dev, f["is_seed"], 3.0, 0),
                         sig30, cj)),
        "of it the weights (matmul, logsumexp)": lambda: (
            impsamp.mixture_log_weight(z, run_is.M, run_is.sizes,
                                       run_is.log_pi, 1.0, sig30)),
        "decode with its batch-first transposes": lambda: (
            run_is.decoder.kernel(q)),
        "of it the decode kernel": lambda: inner.kernel(q_t),
        "tally (errors, sums per stratum)": lambda: run_is.tally(hard, w, c),
    }
    part_ms = {}
    for name, fn in parts.items():
        for _ in range(3):
            fn()
        part_ms[name] = statistics.median(event_ms(fn, 10))
    k_ms = part_ms["of it the decode kernel"]
    bf_ms = part_ms["decode with its batch-first transposes"]
    b_ms, b_by = bound_of(inner, (q_t,), {})
    h_ms = statistics.median(host)
    print(f"[{gpu}] 7b IS batch pieces (CUDA events, median of 10): "
          + "; ".join(f"{n} {t:.4f} ms" for n, t in part_ms.items()),
          flush=True)
    print(f"[{gpu}] 7b IS batch at 3.0 dB, B={B}, {run_is.n_comp} "
          f"components, stratified: {h_ms:.4f} ms host clock, synced, "
          f"median of 10 (min {min(host):.4f}, max {max(host):.4f}); the "
          f"decode kernel {instance_name(inner)} {k_ms:.4f} ms (CUDA "
          f"events, median of 10; {100 * k_ms / h_ms:.1f}% of the batch), "
          f"with its batch-first transposes {bf_ms:.4f} ms; the remainder "
          f"(noise, mixture shift, weights, demap, quantize, counting, "
          f"transposes) {h_ms - k_ms:.4f} ms; the kernel's bound {b_ms:.4f} "
          f"ms by {b_by}", flush=True)

    # 7c: rate matching, plain MC through the IS chain
    nf = FLOOR_NR
    nr_cfg = slice_config(port, NR128, "host")
    nr_code = build_code(nr_cfg)
    run_nr = impsamp.make_is_run(nr_code, nr_cfg, [], batch=nf["batch"],
                                 device=dev)
    if run_nr.backend_label != "cuda-minsum-layered-bf":
        raise AssertionError(f"slice 7c: decoder {run_nr.backend_label}")
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    est = impsamp.estimate_fer(nr_code, nr_cfg, [], nf["ebn0"], nf["frames"],
                               batch=nf["batch"], seed=nr_cfg.run.seed,
                               run=run_nr)
    lap("7c NR MC", t0)
    only_launches(minsum, stream, "7c NR BG1 Z=128",
                   nf["frames"] // nf["batch"])
    r = read_ref(nf["ref"])[nf["ebn0"]]
    ok = (est.frames == nf["frames"] and est.raw_hits == round(
        est.fer * est.frames) and rates_compatible(
        est.raw_hits, est.frames, r["frame_errs"], r["frames"]))
    print(f"7c NR BG1 Z=128 r1/3 (n_tx {nr_code.n_tx}, "
          f"{len(nr_code.punct_vns)} punctured), {run_nr.backend_label}, "
          f"{nf['ebn0']} dB: FER {est.fer:.5f} ({est.raw_hits}/{est.frames}) "
          f"against the file's {r['fer']:.5f} ({r['frame_errs']}/"
          f"{r['frames']}): Wilson intervals (z = 2.576) overlap {ok}",
          flush=True)
    if not ok:
        raise AssertionError("slice 7c disagrees with the file")

    # 7d: the CLI's floor, both estimators, one after the other (the
    # census's OpenMP threads and a second process's would share the cores)
    common = ["floor", "--algorithm", FLOOR["alg"], "--beta-lsb", "0",
              "--schedule", "layered", "--harvest-frames", "16384",
              "--batch", "4096", "--frames", "16384", "--ebn0", "2.6,3.0",
              "--delta", "1.2,1.6,2.0,2.4"]
    runs = {"stratified, --exact-sets 8,3,3": ["--stratified",
                                               "--exact-sets", "8,3,3"],
            "--symmetric --seeds 1,2": ["--symmetric", "--seeds", "1,2"]}
    t0 = time.perf_counter()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, extra) in enumerate(runs.items()):
            out = os.path.join(tmp, f"floor{i}.json")
            proc = subprocess.run(
                [sys.executable, "-m", "ldpc_tpu_torch.cli", *common, *extra,
                 "--out", out], cwd=HERE, capture_output=True, text=True,
                timeout=300)
            label = [ln for ln in proc.stderr.splitlines()
                     if ln.startswith("# decoder ")]
            if proc.returncode != 0 or label != [
                    "# decoder cuda-minsum-layered-bf"]:
                raise AssertionError(
                    f"CLI floor {name} failed ({proc.returncode}, "
                    f"{label}):\n{proc.stderr[-3000:]}")
            with open(out) as fh:
                got[name] = json.load(fh)
    lap("7d CLI", t0)
    k = FLOOR_KEYS
    a, s = got["stratified, --exact-sets 8,3,3"], got[
        "--symmetric --seeds 1,2"]
    keys_ok = (set(a) == set(s) == k["is"]
               and set(a["proposal"]) == k["is proposal"]
               and all(set(p) == k["is point"] for p in a["points"])
               and set(s["proposal"]) == k["symmetric proposal"]
               and all(set(p) == k["symmetric point"]
                       and len(p["seeds"]) == 2
                       and all(set(r) == k["symmetric seed"]
                               for r in p["seeds"]) for p in s["points"]))
    print(f"7d CLI floor: both command lines exit 0 on "
          f"cuda-minsum-layered-bf; the reference's keys {keys_ok}; "
          + "; ".join(f"{p['ebn0_db']} dB FER {p['fer']:.4e} (rel. "
                      f"{p['rel_std']})" for p in a["points"]) + "; "
          + "; ".join(f"{p['ebn0_db']} dB by seed "
                      f"{[r['fer'] for r in p['seeds']]} repeatable "
                      f"{p['seed_repeatable']}" for p in s["points"]),
          flush=True)
    if not keys_ok:
        raise AssertionError("slice 7d: the CLI's JSON keys")
    print("7 seconds: " + ", ".join(f"{n} {t:.2f}" for n, t in secs.items()),
          flush=True)
    print(f"K3 launches on the floor path (7b): {k3_launches}, one an IS "
          f"batch", flush=True)
    return k3_launches


def wifi_sym_config(port, algorithm, beta_lsb):
    """scripts/make_wifi_floor_sym.py's configuration of one algorithm: the
    default code (802.11n n=648 rate 1/2), 8 bits at scale 4, layered, at
    most 20 iterations, early termination."""
    return port.SimConfig(
        code=port.CodeConfig(),
        quant=port.QuantConfig(bits=8, scale=4.0, beta_lsb=beta_lsb),
        decoder=port.DecoderConfig(algorithm=algorithm, max_iter=20,
                                   schedule="layered", early_term=True))


def dvb_floor_config(port):
    """scripts/diag_dvb_mc_deep.py's and make_dvb_floor_r5.py's
    configuration: DVB-S2 n=64,800 rate 1/2, 8 bits at scale 4, OMS beta 2
    LSB, layered, at most 20 iterations, early termination."""
    return port.SimConfig(
        code=port.CodeConfig(family="dvbs2", n=64800, rate="1/2"),
        quant=port.QuantConfig(bits=8, scale=4.0, beta_lsb=2),
        decoder=port.DecoderConfig(algorithm="offset-min-sum", max_iter=20,
                                   schedule="layered", early_term=True))


def pooled_seeds(rows):
    """One point's estimates over its seeds (dicts with fer and rel_std) as
    one: their mean, with the standard error sqrt(sum (fer_i rel_i)^2) / n;
    a dict `floor_z` takes."""
    n = len(rows)
    fer = sum(r["fer"] for r in rows) / n
    se = math.sqrt(sum((r["fer"] * r["rel_std"]) ** 2
                       for r in rows if r["fer"])) / n
    return {"fer": fer, "rel_std": se / fer if fer > 0 else None}


def hold_wifi_floor_sym(port, minsum, stream):
    """Slice 11a.1: results/wifi_floor_sym.json (WIFI_SYM). The proposal is
    the census's absorbing-orbit cover (`floor_proposals.
    absorbing_orbit_cover`, the script's call on one census thread) at
    three depths; each
    algorithm's run is `make_symmetric_run` at batch 8,192 on K3 behind its
    transposes, held to plain on a batch of its own chain first. Then the
    file's 12 runs (two algorithms, 4.6 and 5.0 dB, seeds 31-33, 2,097,152
    frames each) and seed 31 at 5.0 dB again on OMS: the three seeds of a
    point give three estimates, the rerun the same counters, and each
    (algorithm, Eb/N0)'s pooled seeds lie within family_z(4) of the file's
    pooled seeds (`floor_z`). Philox is not threefry: equal seed numbers
    draw different streams, so the hold is statistical. Returns (decoder,
    its held input, launches, worst error)."""
    from ldpc_tpu_torch.codes import build_code
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import impsamp
    from ldpc_tpu_torch.sim.floor_proposals import absorbing_orbit_cover
    w, dev = WIFI_SYM, torch.device("cuda")
    code = build_code(port.SimConfig())
    t0 = time.perf_counter()
    reps = absorbing_orbit_cover(code)
    reps_x, deltas = impsamp.expand_radial(reps, w["depths"])
    print(f"11a.1 proposal: the census's absorbing sets (a <= 8, b <= 3, "
          f"dv <= 3) -> {len(reps)} orbits of {code.Z} rotations x "
          f"{len(w['depths'])} depths = {len(reps_x)} components "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    with open(os.path.join(HERE, "results", w["ref"])) as f:
        ref = json.load(f)["rows"]
    runs, worst, held = {}, {}, None
    e_last = w["points"][-1]
    sigma = np.float32(sigma_for(e_last, code.rate, "bpsk"))
    for alg, algorithm, beta in w["algs"]:
        cfg = wifi_sym_config(port, algorithm, beta)
        run = impsamp.make_symmetric_run(code, cfg, reps_x, delta=deltas,
                                         pi0=w["pi0"], batch=w["batch"],
                                         device=dev)
        if (run.backend_label != "cuda-minsum-layered-bf"
                or not run.decoder.inner.packed):
            raise AssertionError(f"11a.1 {alg}: {run.backend_label}, not "
                                 f"K3's packed kernel")
        # a batch of a seed the counted runs do not use
        q = run.chain(impsamp._generator(dev, 0, e_last, 0), sigma)[0]
        hold_to_plain(f"11a.1 {alg} ({run.backend_label}) {e_last} dB",
                      run.decoder, q, worst)
        print(f"  {instance_name(run.decoder)}, "
              f"{shape_text(run.decoder.inner)}", flush=True)
        runs[alg] = (cfg, run)
        held = held or (run.decoder, q)
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()

    def estimate(alg, e, seed):
        cfg, run = runs[alg]
        return dict(impsamp.estimate_fer_symmetric(
            code, cfg, reps_x, e, w["frames"], delta=deltas, pi0=w["pi0"],
            batch=w["batch"], seed=seed, run=run), seed=seed)
    ests = {(alg, e, seed): estimate(alg, e, seed) for alg in runs
            for e in w["points"] for seed in w["seeds"]}
    again = (w["algs"][0][0], e_last, w["seeds"][0])
    rerun = estimate(*again)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = only_launches(minsum, stream, "11a.1 the symmetric runs",
                              (len(ests) + 1) * (w["frames"] // w["batch"]))
    print(f"11a.1: {len(ests) + 1} runs of {w['frames']} frames in "
          f"{wall:.2f} s", flush=True)
    z, bad = family_z(len(w["algs"]) * len(w["points"])), []
    for alg, _, _ in w["algs"]:
        for e in w["points"]:
            mine = [ests[alg, e, seed] for seed in w["seeds"]]
            theirs = [r for r in ref if r["alg"] == alg and r["ebn0_db"] == e]
            for who, rows in (("port", mine), ("file", theirs)):
                print(f"11a.1 {alg} {e} dB {who}: " + "; ".join(
                    f"seed {r['seed']} FER {r['fer']:.4e} rel. "
                    f"{r['rel_std']:.3f} raw hits {r['raw_hits']}"
                    for r in rows), flush=True)
            got, want = pooled_seeds(mine), pooled_seeds(theirs)
            zz = floor_z(got, want)
            distinct = len({r["fer"] for r in mine}) == len(mine)
            ok = (zz <= z and distinct and len(theirs) == len(mine)
                  and all(r["frames"] == w["frames"] for r in mine))
            print(f"  pooled: port {got['fer']:.4e} (rel. "
                  f"{got['rel_std'] or 0:.3f}), file {want['fer']:.4e} (rel. "
                  f"{want['rel_std']:.3f}): z {zz:.3f} <= {z:.3f}; the seeds' "
                  f"estimates distinct {distinct}: {ok}", flush=True)
            if not ok:
                bad.append(f"{alg} {e}")
    same = rerun == ests[again]
    print(f"11a.1 {again[0]} seed {again[2]} at {again[1]} dB again: the "
          f"same counters {same} (FER {rerun['fer']:.6e}, raw hits "
          f"{rerun['raw_hits']})", flush=True)
    if not same:
        bad.append("rerun")
    if bad:
        raise AssertionError(f"slice 11a.1 disagrees: {bad}")
    return held + (launches, max(worst.values()))


def hold_nr_floor_sym(port, minsum, stream):
    """Slice 11a.2: results/nr_floor_sym.json (NR_SYM), its configuration
    from its header (NR BG1 Z=128 rate 1/3, OMS beta 2 LSB, layered, early
    termination). Its two MC anchors through the IS chain with no sets
    (plain MC of the all-zeros word) on K3 behind its transposes at batch
    16,384 (250 batches a point), the decoder held to plain on a batch of
    that chain first; each by Wilson intervals at family_z(2). Then the
    symmetric row at 1.2 dB through the CLI (`floor --symmetric --seeds
    61,62`), its two seeds pooled and held to the 1.2 dB anchor by `floor_z`
    at family_z(2). Returns (decoder, its held input, launches, worst
    error)."""
    from ldpc_tpu_torch.codes import build_code
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import impsamp
    from ldpc_tpu_torch.sim.stats import rates_compatible, wilson_interval
    nf, dev = NR_SYM, torch.device("cuda")
    with open(os.path.join(HERE, "results", nf["ref"])) as f:
        ref = json.load(f)
    cfg = recorded_config(port, nf["ref"])
    code = build_code(cfg)
    run = impsamp.make_is_run(code, cfg, [], batch=nf["mc_batch"],
                              device=dev)
    if run.backend_label != "cuda-minsum-layered-bf":
        raise AssertionError(f"11a.2: decoder {run.backend_label}")
    worst = {}
    e0 = nf["mc_points"][0]
    q = run.chain(impsamp._generator(dev, cfg.run.seed + 1, e0, 0),
                  np.float32(sigma_for(e0, code.rate, "bpsk")))[0]
    hold_to_plain(f"11a.2 NR BG1 Z=128 r1/3 ({run.backend_label}) {e0} dB",
                  run.decoder, q, worst)
    print(f"  {instance_name(run.decoder)}, {shape_text(run.decoder.inner)}",
          flush=True)
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    ests = {e: impsamp.estimate_fer(code, cfg, [], e, nf["mc_frames"],
                                    batch=nf["mc_batch"], seed=cfg.run.seed,
                                    run=run)
            for e in nf["mc_points"]}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = only_launches(minsum, stream, "11a.2 the MC anchors",
                              len(ests) * nf["mc_frames"] // nf["mc_batch"])
    z, anchors, bad = family_z(2), ref["mc_anchors"], []
    for e, est in ests.items():
        a = anchors[str(e)]
        a_errs = round(a["fer"] * a["frames"])
        ok = (est.frames == a["frames"]
              and est.raw_hits == round(est.fer * est.frames)
              and rates_compatible(est.raw_hits, est.frames, a_errs,
                                   a["frames"], z))
        lo, hi = wilson_interval(est.raw_hits, est.frames, z)
        alo, ahi = wilson_interval(a_errs, a["frames"], z)
        print(f"11a.2 MC {e} dB: FER {est.fer:.4e} ({est.raw_hits}/"
              f"{est.frames}) [{lo:.3e}, {hi:.3e}] against the file's "
              f"{a['fer']:.4e} ({a_errs}/{a['frames']}) [{alo:.3e}, "
              f"{ahi:.3e}] (Wilson, z = {z:.3f}): {ok}", flush=True)
        if not ok:
            bad.append(f"mc {e}")
    print(f"11a.2: {len(ests)} MC points in {wall:.2f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "nr_floor_sym.json")
        proc = subprocess.run(
            [sys.executable, "-m", "ldpc_tpu_torch.cli", *nf["argv"],
             "--out", out], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("# ")]
        if (proc.returncode != 0
                or "# decoder cuda-minsum-layered-bf" not in notes):
            raise AssertionError(f"11a.2 CLI floor --symmetric failed "
                                 f"({proc.returncode}, {notes}):\n"
                                 f"{proc.stderr[-3000:]}")
        with open(out) as fh:
            got = json.load(fh)
    pt = got["points"][0]
    file_pt = next(p for p in ref["points"] if p["ebn0_db"] == pt["ebn0_db"])
    for who, p in (("port", pt), ("file", file_pt)):
        print(f"11a.2 symmetric {p['ebn0_db']} dB {who}: " + "; ".join(
            f"seed {r['seed']} FER {r['fer']:.4e} rel. {r['rel_std']:.3f} "
            f"raw hits {r['raw_hits']} frames {r['frames']}"
            for r in p["seeds"]) + f"; seed_repeatable "
            f"{p['seed_repeatable']}", flush=True)
    a = anchors[str(nf["sym_ebn0"])]
    a_errs = round(a["fer"] * a["frames"])
    anchor = {"fer": a["fer"], "rel_std": 1 / math.sqrt(a_errs)}
    mine = pooled_seeds(pt["seeds"])
    zz = floor_z(mine, anchor)
    ok = (zz <= z and [r["frames"] for r in pt["seeds"]]
          == [r["frames"] for r in file_pt["seeds"]])
    print(f"11a.2 CLI ({time.perf_counter() - t0:.1f} s; {notes}): pooled "
          f"{mine['fer']:.4e} (rel. {mine['rel_std'] or 0:.3f}) against the "
          f"1.2 dB anchor {anchor['fer']:.4e} (rel. "
          f"{anchor['rel_std']:.3f}): z "
          f"{zz:.3f} <= {z:.3f}; {got['proposal']['n_orbit_reps']} orbit "
          f"reps (the file's {ref['proposal']['n_orbit_reps']}): {ok}",
          flush=True)
    if not ok:
        bad.append("symmetric")
    if bad:
        raise AssertionError(f"slice 11a.2 disagrees: {bad}")
    return run.decoder, q, launches, max(worst.values())


def hold_dvb_floor_mc(port, minsum, stream):
    """Slice 11a.3: results/dvb_floor_summary.json's 1.2 dB point (DVB_FLOOR):
    plain MC of the all-zeros word through the IS chain with no sets, at
    the file's batch on `auto`'s route (the pipelined kernel's ET instance,
    K6f), its decoder held to plain on a batch of that chain first.
    fails_info is the IS tally's raw count (`ISRun.tally`: frames with a
    wrong information bit, the sweeps' frame errors), fails_any the frames
    with any wrong bit (`hard.any`, as `harvest_error_supports` reads a
    failure), scripts/diag_dvb_mc_deep.py's rule; each held to the file by
    Wilson intervals at family_z(2). Returns (decoder, its held input,
    launches, worst error)."""
    from ldpc_tpu_torch.codes import build_code
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import impsamp
    from ldpc_tpu_torch.sim.stats import rates_compatible, wilson_interval
    f, dev = DVB_FLOOR, torch.device("cuda")
    cfg = dvb_floor_config(port)
    code = build_code(cfg)
    run = impsamp.make_is_run(code, cfg, [], batch=f["batch"], device=dev)
    if run.backend_label != "cuda-stream-pipelined-et":
        raise AssertionError(f"11a.3: decoder {run.backend_label}")
    sigma = np.float32(sigma_for(f["ebn0"], code.rate, "bpsk"))
    worst = {}
    q = run.chain(impsamp._generator(dev, f["seed"] + 1, f["ebn0"], 0),
                  sigma)[0]
    hold_to_plain(f"11a.3 DVB-S2 n=64,800 ({run.backend_label}) "
                  f"{f['ebn0']} dB", run.decoder, q, worst)
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    nb = f["frames"] // f["batch"]
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    for i in range(nb):
        qi, w, _ = run.chain(impsamp._generator(dev, f["seed"], f["ebn0"], i),
                             sigma)
        hard = run.decoder(qi)[0]
        acc += torch.stack([run.tally(hard, w, None)[2].to(torch.int64),
                            hard.any(dim=1).sum()])
    fails_info, fails_any = acc.tolist()
    wall = time.perf_counter() - t0
    launches = only_launches(minsum, stream, "11a.3 the MC batches", nb,
                             "stream-pipelined-et")
    with open(os.path.join(HERE, "results", f["summary"])) as fh:
        r = next(p for p in json.load(fh)["points"]
                 if p["ebn0_db"] == f["ebn0"])
    N, z, bad = nb * f["batch"], family_z(2), []
    for key, got in (("fails_info", fails_info), ("fails_any", fails_any)):
        ok = N == r["frames"] and rates_compatible(got, N, r[key],
                                                   r["frames"], z)
        lo, hi = wilson_interval(got, N, z)
        rlo, rhi = wilson_interval(r[key], r["frames"], z)
        print(f"11a.3 {f['ebn0']} dB {key}: {got}/{N} [{lo:.3e}, {hi:.3e}] "
              f"against the file's {r[key]}/{r['frames']} [{rlo:.3e}, "
              f"{rhi:.3e}] (Wilson, z = {z:.3f}): {ok}", flush=True)
        if not ok:
            bad.append(key)
    print(f"11a.3: {N} frames in {wall:.2f} s", flush=True)
    if bad:
        raise AssertionError(f"slice 11a.3 disagrees: {bad}")
    return run.decoder, q, launches, max(worst.values())


def hold_dvb_floor_sym(port, minsum, stream):
    """Slice 11a.4: the symmetric estimator on DVB-S2 n=64,800 (DVB_FLOOR),
    the path of results/dvb_floor_r5.json, whose numbers fail its own
    convergence bar and are not held. The proposal as
    scripts/make_dvb_floor_r5.py:57-100 builds it (`floor_proposals.
    harvested_orbit_reps`): 109 orbits, 327 components. `make_symmetric_run`
    at batch 1,024 must take `auto`'s streaming ET kernel; on one batch of
    injected draws its decoder and tally (hard decisions, weights, the
    per-orbit Z-folded shares and hits) must equal the plain QC route's
    (`torch-qc`) exactly. Then two seeds of 65,536 frames at 1.3 dB, each
    estimate finite. Returns (decoder, the batch's input, launches, worst
    error)."""
    from ldpc_tpu_torch.codes import build_code
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import impsamp
    from ldpc_tpu_torch.sim.floor_proposals import harvested_orbit_reps
    f, dev = DVB_FLOOR, torch.device("cuda")
    cfg = dvb_floor_config(port)
    code = build_code(cfg)
    with open(os.path.join(HERE, "results", f["mc_deep"])) as fh:
        mc = json.load(fh)
    with open(os.path.join(HERE, "results", f["census"])) as fh:
        census = json.load(fh)
    reps = harvested_orbit_reps(code, mc["points"],
                                census["example_73_sets"][:1])
    reps_x, deltas = impsamp.expand_radial(reps, f["depths"])
    print(f"11a.4 proposal: {len(reps)} orbits (the probe's info-failure "
          f"supports of 1-48 positions and the (7,3) orbit) x "
          f"{len(f['depths'])} depths = {len(reps_x)} components; mean matrix "
          f"{len(reps_x)} x {code.n} float32", flush=True)
    if (len(reps), len(reps_x)) != (f["reps"], f["components"]):
        raise AssertionError("11a.4: the proposal is not the file's")
    B = f["batch"]
    kw = dict(delta=deltas, pi0=f["pi0"], batch=B, device=dev)
    run = impsamp.make_symmetric_run(code, cfg, reps_x, **kw)
    run_qc = impsamp.make_symmetric_run(code, cfg, reps_x, backend="qc", **kw)
    print(f"11a.4 routes: {run.backend_label} "
          f"({run.decoder.kernel_name(B)}), forced qc {run_qc.backend_label}",
          flush=True)
    if (run.backend_label, run_qc.backend_label) != (
            "cuda-stream-pipelined-et", "torch-qc"):
        raise AssertionError("11a.4: the routes are not the streaming ET "
                             "kernel and the plain QC decoder")
    sigma = np.float32(sigma_for(f["sym_ebn0"], code.rate, "bpsk"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(79)
    eps = torch.randn((B, code.n), generator=gen, device=dev)
    comp = torch.as_tensor(np.random.default_rng(79).choice(
        run.K + 1, size=B, p=run.pis), device=dev)
    q, w, c = run.chain(None, sigma, eps=eps, comp=comp)
    out_k, out_p = run.decoder(q), run_qc.decoder(q)
    s_k, s_p = run.tally(out_k[0], w, c), run.tally(out_p[0], w, c)
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    equal = torch.equal(s_k, s_p)
    failed = int(out_k[0].any(dim=1).sum())
    hit = int((s_k[2, :run.K] > 0).sum())
    print(f"11a.4 one batch at {f['sym_ebn0']} dB, B={B}: hard bits, iters, "
          f"conv == torch-qc {same} (max_abs_err {err:g}; failed frames "
          f"{failed}, shifted lanes {int((c > 0).sum())}); tally == "
          f"torch-qc {equal} (orbit components hit {hit} of {run.K}, "
          f"totals {s_k[:, -1].tolist()})", flush=True)
    if not (same and equal) or failed == 0:
        raise AssertionError("slice 11a.4: the streaming kernel's batch "
                             "differs from the plain QC route's")
    del run_qc, eps
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    ests = [impsamp.estimate_fer_symmetric(
        code, cfg, reps_x, f["sym_ebn0"], f["sym_frames"], delta=deltas,
        pi0=f["pi0"], batch=B, seed=seed, run=run) for seed in f["sym_seeds"]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = only_launches(minsum, stream, "11a.4 the symmetric runs",
                             len(ests) * f["sym_frames"] // B,
                             "stream-pipelined-et")
    for seed, est in zip(f["sym_seeds"], ests):
        print(f"11a.4 {f['sym_ebn0']} dB seed {seed}: FER {est['fer']:.4e} "
              f"rel. {est['rel_std']:.3f} raw hits {est['raw_hits']} "
              f"(attributed {est['raw_hits_attributed']}), frames "
              f"{est['frames']}", flush=True)
    print(f"11a.4: {len(ests)} runs in {wall:.2f} s", flush=True)
    if not all(np.isfinite(est["fer"]) and np.isfinite(est["rel_std"])
               for est in ests):
        raise AssertionError("slice 11a.4: an estimate is not finite")
    return run.decoder, q, launches, err


def check_bsc_soft(port, minsum, stream, dev):
    """Slice 11d's soft BSC: results/bsc_wifi648.json (BSC) as
    scripts/make_bsc_curve.py chains it: info bits -> encoder ->
    `channel.bsc` -> `bsc_llr` -> quantize -> the canonical preset's decoder
    as `select_decoder` gives it batch first (K1 behind its transposes,
    held to plain on a batch of these LLRs first, 0 plain calls in the run),
    16,384 frames at each of the file's eight p. FER and the converged rate
    by Wilson intervals; BER by the per-frame z-test at family_z(8), the
    variance this run's or, where larger, the least either row allows (the
    file records rates, from which its counts are taken back). Returns
    (decoder, its held input, launches, worst error)."""
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.ops import channel as ch
    from ldpc_tpu_torch.ops.encode import make_encoder
    from ldpc_tpu_torch.ops.quantize import quantize
    from ldpc_tpu_torch.sim.pipeline import select_decoder
    from ldpc_tpu_torch.sim.stats import (mean_compatible, rates_compatible,
                                          wilson_interval)
    b = BSC
    cfg = port.PRESETS[b["preset"]]
    ct = from_reference(build_code(cfg), dev)
    B, n_batches = b["batch"], b["frames"] // b["batch"]
    soft, label = select_decoder(ct, cfg, batch=B, batch_first=True)
    if label != "cuda-minsum-bf":
        raise AssertionError(f"11d BSC: the decoder is {label}")
    enc = make_encoder(ct)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b["seed"])

    def received(p):
        info = torch.randint(0, 2, (B, ct.k), generator=gen, device=dev,
                             dtype=torch.uint8)
        rx = ch.bsc(gen, enc(info), p)
        return info, quantize(ch.bsc_llr(rx, p), cfg.quant)

    worst = {}
    q = received(np.float32(0.05))[1]
    hold_to_plain(f"11d BSC ({label}) p=0.05", soft, q, worst)
    print(f"  {instance_name(soft)}, {shape_text(soft.inner)}", flush=True)
    with open(os.path.join(HERE, "results", b["ref"])) as f:
        ref = {r["p"]: r for r in json.load(f)["results"]}
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    runs = {}
    for p in b["ps"]:
        p32, errs, conv = np.float32(p), [], 0
        for _ in range(n_batches):
            info, qb = received(p32)
            hard, _, ok = soft(qb)
            errs.append((hard[:, ct.info_positions] != info).sum(dim=1))
            conv += ok.sum()
        runs[p] = (torch.cat(errs).double(), int(conv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"11d BSC: {len(b['ps'])} points of {b['frames']} frames in "
          f"{wall:.2f} s", flush=True)
    launches = only_launches(minsum, stream, "11d BSC",
                             len(b["ps"]) * n_batches, "minsum_flood")
    z, bad = family_z(len(b["ps"])), []
    for p, (errs, conv) in runs.items():
        r, frames = ref[p], errs.numel()
        rf = r["frames"]
        mine = {"frames": frames, "bit_errs": int(errs.sum()),
                "frame_errs": int((errs > 0).sum())}
        theirs = {"frames": rf, "bit_errs": round(r["ber"] * rf * ct.k),
                  "frame_errs": round(r["fer"] * rf)}
        var = max(float(errs.var()), least_bit_variance(mine),
                  least_bit_variance(theirs))
        ok_f = rates_compatible(mine["frame_errs"], frames,
                                theirs["frame_errs"], rf)
        ok_c = rates_compatible(conv, frames, round(r["conv_rate"] * rf), rf)
        ok_b = mean_compatible(mine["bit_errs"], frames, theirs["bit_errs"],
                               rf, var, z=z)
        lo, hi = wilson_interval(mine["frame_errs"], frames)
        print(f"  p {p}: frames {frames} FER {mine['frame_errs'] / frames:.4e}"
              f" [{lo:.4e}, {hi:.4e}] ref {r['fer']:.4e} compatible {ok_f}; "
              f"BER {mine['bit_errs'] / (frames * ct.k):.4e} ref "
              f"{r['ber']:.4e} compatible {ok_b} (per-frame z-test at z = "
              f"{z:.3f}, sd {var ** 0.5:.2f} bits/frame); converged "
              f"{conv / frames:.6f} ref {r['conv_rate']:.6f} compatible "
              f"{ok_c}", flush=True)
        if not (ok_f and ok_b and ok_c and frames == rf):
            bad.append(p)
    if bad:
        raise AssertionError(f"11d BSC disagrees with {b['ref']} at p = "
                             f"{bad}")
    return soft, q, launches, max(worst.values())


# Slice 8: the design funnel and the table registry. DE rows of
# results/de_thresholds.json, each with scripts/make_de_thresholds.py's
# call (iters 120, tol 2e-3, target 1e-7): (code, decoder label, code
# builder arguments, beta, beta_lsb, min*, bracket)
DE_ROWS = (
    ("wifi648_r12", "oms beta=1 8-bit", ("ieee80211n", 648, "1/2"), 1, 1,
     False, (0.6, 1.3)),
    ("wifi648_r12", "min-star 8-bit", ("ieee80211n", 648, "1/2"), 0, 0,
     True, (0.6, 1.3)),
    ("dvbs2_64800_r12", "oms beta=2 8-bit", ("dvbs2", 64800, "1/2"), 2, 2,
     False, (0.6, 1.3)),
)
DE_TOL = 2e-3
DE_HOLD = 2 * DE_TOL          # a bisection's result lies within tol of sigma*
# results/pexit_screen.json's production anchors
# (scripts/make_pexit_screen.py:162-168: iters 400, tol 2e-3)
PEXIT_ROWS = (("nr_bg1_z384_r12", ("5gnr", 1, 384, "1/3")),
              ("dvbs2_64800_r12", ("dvbs2", 64800, "1/2")))
CENSUS = "8,3,3"
# the registry commands, each in a process of its own: the command line
# through cli.main, then the kernel counters of that process as one JSON
# line (its counters start at 0 with the process)
IMPORT_JOB = """
import json, sys, time
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.kernels import minsum, minsum_stream as stream
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                  "library": minsum.library_launches,
                  "packed": minsum.packed_launches,
                  "plain": minsum.plain_calls + stream.plain_calls,
                  "stream": stream.kernel_launches,
                  "stream_instances": {k: v for k, v in
                                       stream.instance_launches.items() if v},
                  "stream_packed": stream.packed_launches}))
"""
REGISTRY_REPORT_KEYS = {"family", "mb", "nb", "Z", "enc_struct", "rank",
                        "girth", "smoke", "stored", "key"}
SMOKE_KEYS = {"frames", "ebn0_db", "ber", "uncoded_ber", "conv_rate"}


def cli_cmd(*argv):
    return [sys.executable, "-m", "ldpc_tpu_torch.cli", *argv]


def start(cmd, env=None):
    return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=None if env is None else {**os.environ,
                                                          **env})


def finish(proc, what, timeout=900, ok_codes=(0,)):
    """(stdout, stderr) of a started command; fails unless its exit code is
    one of ok_codes."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode not in ok_codes:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{err[-3000:]}")
    return out, err


def import_job(argv, what):
    """Run one registry command line in a process of its own (IMPORT_JOB);
    returns (the command's JSON line, the process's counters)."""
    out, _ = finish(start([sys.executable, "-c", IMPORT_JOB, *argv]), what)
    lines = out.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def in_process_counts(minsum, stream, seconds):
    """This process's kernel counters, with IMPORT_JOB's keys."""
    return {"rc": 0, "seconds": seconds,
            "library": dict(minsum.library_launches),
            "packed": dict(minsum.packed_launches),
            "plain": minsum.plain_calls + stream.plain_calls,
            "stream": stream.kernel_launches,
            "stream_instances": {k: v for k, v in
                                 stream.instance_launches.items() if v},
            "stream_packed": stream.packed_launches}


def smoke_report(label, sm, counts):
    """Prints a smoke decode's report and the launches its process (or its
    window of this process) made; fails unless it passed."""
    if set(sm) != SMOKE_KEYS:
        raise AssertionError(f"{label}: smoke report keys {sorted(sm)}")
    print(f"8d {label}: smoke decode on the card: {sm['frames']} frames at "
          f"{sm['ebn0_db']} dB, BER {sm['ber']:.4e} against uncoded "
          f"{sm['uncoded_ber']:.4e}, conv_rate {sm['conv_rate']:.4f}; "
          f"{counts['seconds']:.1f} s, kernel launches {counts['library']}, "
          f"packed {counts['packed']}, streaming {counts['stream']} "
          f"{counts['stream_instances']} (packed resident "
          f"{counts['stream_packed']}), plain calls {counts['plain']}",
          flush=True)
    if sm["ber"] > sm["uncoded_ber"] / 10 or counts["rc"] != 0:
        raise AssertionError(f"{label}: smoke decode")


def hold_smoke(label, Z, base, sm, worst):
    """The smoke decode's own batch (`imported.smoke_llrs` at its operating
    point and seed, on the card) through the decoder it picks
    (`imported.smoke_decoder`): the kernel == the plain version, tolerance
    0 (hard bits, iterations, convergence flags), and the kernel's BER is
    the smoke report `sm`'s. Its launches are not counted as the main
    path's."""
    from ldpc_tpu_torch.codes import from_reference, imported
    from ldpc_tpu_torch.codes.code import expand_qc
    code = expand_qc(base, Z, name="import_smoke")
    ct = from_reference(code, "cuda")
    _, sigma = imported.smoke_operating_point(code.k / code.n, sm["ebn0_db"])
    q = imported.smoke_llrs(ct, sm["frames"], sigma, imported.SMOKE_SEED)
    dec, name = imported.smoke_decoder(ct, q.shape[0])
    hard = hold_to_plain(f"8d {label} smoke batch ({name})", dec, q,
                         worst)[0]
    ber = float(hard.to(torch.float64).mean())
    if ber != sm["ber"]:
        raise AssertionError(f"8d {label}: the held batch's BER {ber} is "
                             f"not the smoke decode's {sm['ber']}")


@contextlib.contextmanager
def tables_env(path):
    """LDPC_TPU_TABLES = path in this process, restored after."""
    old = os.environ.get("LDPC_TPU_TABLES")
    os.environ["LDPC_TPU_TABLES"] = path
    try:
        yield
    finally:
        if old is None:
            del os.environ["LDPC_TPU_TABLES"]
        else:
            os.environ["LDPC_TPU_TABLES"] = old


def listing(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else None


def check_registry_sweep(label, argv, env, want_code, ref_name=None):
    """A short sweep (`python -m ldpc_tpu_torch.cli sweep`) on the code the
    registry now builds: it must be the `_std` code, run a kernel, decode
    every frame asked for and, where ref_name is given, hold FER at each
    point to that result file by Wilson intervals."""
    from ldpc_tpu_torch.sim.stats import rates_compatible
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "std")
        finish(start(cli_cmd("sweep", *argv, "--no-checkpoint", "--out",
                             out), env=env), f"8d sweep {label}")
        with open(out + ".json") as f:
            got = json.load(f)
    ref = read_ref(ref_name) if ref_name else {}
    oks = []
    for r in got["results"]:
        want = ref.get(r["ebn0_db"])
        ok = want is None or rates_compatible(
            r["frame_errs"], r["frames"], want["frame_errs"], want["frames"])
        oks.append(ok)
        print(f"8d sweep {label} ({got['code']}, {got['decoder_backend']}): "
              f"{r['ebn0_db']} dB frames {r['frames']} frame_errs "
              f"{r['frame_errs']} FER {r['fer']:.4e} BER {r['ber']:.4e}"
              + (f" against {ref_name}'s FER {want['fer']:.4e}: {ok}"
                 if want else ""), flush=True)
    if (got["code"] != want_code
            or not got["decoder_backend"].startswith("cuda-")
            or not all(oks)):
        raise AssertionError(f"8d sweep {label}: {got['code']}, "
                             f"{got['decoder_backend']}, {oks}")
    return got


def check_design(port, minsum, stream, gpu, worst):
    """Slice 8, the design funnel and the table registry (`analysis/de.py`,
    `exit.py`, `proto_de.py`, `codes/imported.py`, the CLI's `analyze`,
    `construct` and `import-standard`). 8a: `python -m ldpc_tpu_torch.cli
    analyze --preset wifi-648-r12-minsum` with its default flags, and in
    process the DE rows of results/de_thresholds.json for OMS beta 1, min*
    (LUT (8, 3, 0)) and DVB-S2 n=64,800 rate 1/2 single-edge, with
    scripts/make_de_thresholds.py's calls: sigma* within 2 * tol (4e-3) of
    the file's. 8b: `pexit_threshold_awgn(code, iters=400, tol=2e-3)` on
    NR BG1 Z=384 rate 1/3 and DVB-S2 n=64,800 rate 1/2 within 4e-3 of
    results/pexit_screen.json's production anchors. 8c: `construct --preset
    wifi-648-r12-minsum --census 8,3,3`: girth 6, full rank, the census's
    classes (2,295 absorbing sets, slice 7's census). 8d: `import-standard`
    into a temporary registry (`--tables-dir`; the default registry must
    gain no file): the port's own 802.11n n=648 rate 1/2 table, validated
    and smoke-decoded on the card by K3's packed layered kernel (one launch,
    nothing plain); under the registry the built code is the `_std` one,
    and a two-batch sweep on the card at 2.0 dB holds FER to
    results/wifi648_minsum.json; `--remove`. For NR BG1 Z=384's full graph
    `imported.smoke_decode` in process, on the instance `auto` streams it
    to (one launch of a kernel, nothing plain), then `imported.store`, the
    `_std` code under `nr-bg1-layered`'s configuration, a two-batch sweep,
    `--remove`. Each smoke decode's batch is held to plain with tolerance
    0, its error going to `worst`. A table with a 4-cycle exits non-zero
    with REJECTED. Returns the smoke decodes' launches by kernel record
    name."""
    from ldpc_tpu_torch.analysis import (de, exact_absorbing_census,
                                         pexit_threshold_awgn)
    from ldpc_tpu_torch.codes import dvbs2, ieee80211n, nr_bg
    from ldpc_tpu_torch.config import QuantConfig, minstar_thresholds
    secs = {}
    t_all = time.perf_counter()
    # the two host commands, beside the in-process rows
    analyze = start(cli_cmd("analyze", "--preset", "wifi-648-r12-minsum"))
    construct = start(cli_cmd("construct", "--preset", "wifi-648-r12-minsum",
                              "--census", CENSUS))

    def make(spec):
        if spec[0] == "ieee80211n":
            return ieee80211n.make_code(spec[1], spec[2])
        if spec[0] == "dvbs2":
            return dvbs2.make_code(spec[1], spec[2])
        return nr_bg.make_code(spec[1], spec[2], rate=spec[3])

    with open(os.path.join(HERE, "results", "de_thresholds.json")) as f:
        de_file = {(r["code"], r["decoder"]): r
                   for r in json.load(f)["thresholds"]}
    t0 = time.perf_counter()
    out, _ = finish(analyze, "8a analyze")
    got = json.loads(out)
    want = de_file["wifi648_r12", "min-sum 8-bit"]
    rows = [("analyze --preset wifi-648-r12-minsum (CLI)", got["sigma_star"],
             got["ebn0_star_db"], want)]
    if set(got) != {"channel", "code", "rate", "bits", "algorithm",
                    "sigma_star", "ebn0_star_db", "pe_target", "max_dv",
                    "max_dc", "note"} or got["code"] != "ieee80211n_n648_r12":
        raise AssertionError(f"8a analyze: {got}")
    for name, label, spec, beta, beta_lsb, star, bracket in DE_ROWS:
        quant = QuantConfig(bits=8, scale=4.0, beta_lsb=beta_lsb)
        code = make(spec)
        ms = minstar_thresholds(quant) if star else None
        want = de_file[name, label]
        if star and list(ms) != want["lut_thresholds"]:
            raise AssertionError(f"8a min* LUT {ms}")
        sigma = de.de_threshold_awgn_spectra(
            de.spectra_from_code(code), quant, beta=beta, iters=120,
            tol=DE_TOL, bracket=bracket, target=1e-7, minstar=ms)
        rate = code.k / code.n
        rows.append((f"{name} {label}", sigma,
                     -20.0 * math.log10(sigma * math.sqrt(2 * rate)), want))
    secs["8a"] = time.perf_counter() - t0
    for what, sigma, ebn0, want in rows:
        print(f"8a {what}: sigma* {sigma:.6f} ({ebn0:.3f} dB) against "
              f"results/de_thresholds.json's {want['sigma_star']} "
              f"({want['ebn0_star_db']} dB): |diff| "
              f"{abs(sigma - want['sigma_star']):.2e}", flush=True)
    if any(abs(sigma - want["sigma_star"]) > DE_HOLD
           for _, sigma, _, want in rows):
        raise AssertionError("slice 8a: a DE threshold is off the file's")

    t0 = time.perf_counter()
    with open(os.path.join(HERE, "results", "pexit_screen.json")) as f:
        anchors = {r["code"]: r for r in json.load(f)["production_anchors"]}
    held = []
    for name, spec in PEXIT_ROWS:
        code = make(spec)
        t1 = time.perf_counter()
        sigma, ebn0 = pexit_threshold_awgn(code, iters=400, tol=DE_TOL)
        want = anchors[name]
        held.append(abs(sigma - want["pexit_sigma"]) <= DE_HOLD)
        print(f"8b PEXIT {name} ({code.name}): sigma* {sigma:.6f} "
              f"({ebn0:.3f} dB) in {time.perf_counter() - t1:.2f} s against "
              f"results/pexit_screen.json's {want['pexit_sigma']} "
              f"({want['pexit_ebn0_db']} dB): |diff| "
              f"{abs(sigma - want['pexit_sigma']):.2e}", flush=True)
    secs["8b"] = time.perf_counter() - t0
    if not all(held):
        raise AssertionError("slice 8b: a PEXIT threshold is off the file's")

    t0 = time.perf_counter()
    out, _ = finish(construct, "8c construct")
    got = json.loads(out)
    cen = got["absorbing_census"]
    want_cen = exact_absorbing_census(ieee80211n.make_code(648, "1/2"),
                                      *(int(x) for x in CENSUS.split(",")))
    secs["8c"] = time.perf_counter() - t0
    print(f"8c construct --census {CENSUS}: {got['code']} girth "
          f"{got['girth']} full_rank {got['full_rank']}; census total "
          f"{cen['total']} classes {cen['classes']}", flush=True)
    if (got["girth"] != 6 or not got["full_rank"] or cen["total"] != 2295
            or cen["classes"] != want_cen["classes"]):
        raise AssertionError(f"slice 8c: {got}")

    # 8d: the registry, on the card, in a temporary directory
    default = os.path.join(HERE, "imported_tables")
    default_before = listing(default)
    with tempfile.TemporaryDirectory(prefix="ldpc_tables_") as tmp:
        tables = os.path.join(tmp, "tables")
        launched = import_standard_on_card(port, minsum, stream, tmp, tables,
                                           worst, secs)
    after = listing(default)
    print(f"8d the default registry {default}: before {default_before}, "
          f"after {after}", flush=True)
    if after != default_before:
        raise AssertionError("slice 8 wrote to the default registry")
    secs["slice 8"] = time.perf_counter() - t_all
    print(f"[{gpu}] 8 seconds: " + ", ".join(f"{n} {t:.2f}"
                                            for n, t in secs.items()),
          flush=True)
    return launched


def import_standard_on_card(port, minsum, stream, tmp, tables, worst, secs):
    """Slice 8d in the temporary registry `tables`: the 802.11n import
    through the CLI, NR BG1 Z=384's smoke decode in process, each smoke
    batch held to plain, the `_std` sweeps, `--remove`, the 4-cycle
    table. Returns the smoke decodes' launches by kernel record name."""
    from ldpc_tpu_torch.codes import build_code, ieee80211n, imported
    from ldpc_tpu_torch.codes.nr_bg import full_graph
    t0 = time.perf_counter()
    env = {"LDPC_TPU_TABLES": tables}
    wifi = ieee80211n.make_code(648, "1/2")
    wifi_file = os.path.join(tmp, "wifi648.json")
    with open(wifi_file, "w") as f:
        json.dump({"Z": wifi.Z, "base": wifi.base.tolist()}, f)
    wifi_argv = ["import-standard", "--family", "ieee80211n", "--n", "648",
                 "--rate", "1/2", "--file", wifi_file, "--tables-dir",
                 tables]
    rep, counts = import_job(wifi_argv, "8d import-standard 802.11n")
    if set(rep) != REGISTRY_REPORT_KEYS:
        raise AssertionError(f"8d 802.11n: report keys {sorted(rep)}")
    print(f"8d 802.11n n=648 rate 1/2: validated (rank {rep['rank']}, girth "
          f"{rep['girth']}, enc_struct {rep['enc_struct']}); stored "
          f"{os.path.basename(rep['stored'])}", flush=True)
    smoke_report("802.11n n=648 rate 1/2", rep["smoke"], counts)
    lib = "minsum_layered"
    if (counts["library"][lib] != 1 or counts["packed"][lib] != 1
            or sum(counts["library"].values()) != 1 or counts["plain"]
            or counts["stream"]):
        raise AssertionError("8d 802.11n: the smoke decode must launch K3's "
                             "packed instance once and nothing else")
    launched = {"minsum_layered": counts["library"][lib]}
    hold_smoke("802.11n n=648 rate 1/2", wifi.Z, wifi.base, rep["smoke"],
               worst)
    with tables_env(tables):
        std = build_code(port.PRESETS["wifi-648-r12-minsum"])
    print(f"8d under the registry: {std.name} standard_exact "
          f"{std.standard_exact}", flush=True)
    if not (std.name.endswith("_std") and std.standard_exact):
        raise AssertionError("8d: the built code is not the imported one")
    check_registry_sweep(
        "802.11n", ["--preset", "wifi-648-r12-minsum", "--ebn0", "2.0",
                          "--batch", "4096", "--max-frames", "8192",
                          "--target-errors", "100000000"],
        env, "ieee80211n_n648_r12_std", ref_name="wifi648_minsum.json")
    rm, _ = finish(start(cli_cmd(*wifi_argv[:7], "--remove", "--tables-dir",
                                 tables)), "8d --remove")
    if not json.loads(rm)["removed"]:
        raise AssertionError("8d: --remove")
    secs["8d 802.11n"] = time.perf_counter() - t0

    # NR BG1 Z=384's full graph (as tests/test_import_standard.py:114):
    # its smoke decode through `imported.smoke_decode` in this process, the
    # counters zeroed just before it; the table then stored as
    # import-standard stores it (its validation, minutes of numpy GF(2)
    # rank on one host core, is the copy that tier-1 holds to the
    # reference's on the CPU)
    t0 = time.perf_counter()
    g = full_graph(1, 384)
    minsum.reset_counters()
    stream.reset_counters()
    t1 = time.perf_counter()
    sm = imported.smoke_decode(384, g.base, device="cuda")
    torch.cuda.synchronize()
    counts = in_process_counts(minsum, stream, time.perf_counter() - t1)
    label = "NR BG1 Z=384 (full graph)"
    smoke_report(label, sm, counts)
    picked = counts["stream_instances"]
    print(f"8d the instance auto streams NR BG1 Z=384's smoke decode to: "
          f"{picked} (packed resident kernel launches "
          f"{counts['stream_packed']})", flush=True)
    if (counts["stream"] != 1 or sum(picked.values()) != 1
            or sum(counts["library"].values()) or counts["plain"]):
        raise AssertionError("8d NR: the smoke decode must launch one "
                             "streaming kernel and nothing else")
    (variant, n), = picked.items()
    prefix = ("minsum_stream_pipelined_" if "pipelined" in variant
              else "minsum_stream_")
    for kid, _ in stream.REPLACES[variant]:
        launched[prefix + kid] = n
    hold_smoke(label, 384, g.base, sm, worst)
    with tables_env(tables):
        imported.store("5gnr", "bg1_z384", 384, g.base,
                       meta={"source": "nr_bg.full_graph(1, 384)",
                             "validation": {"smoke": sm}})
    nr_cfg = port.PRESETS["nr-bg1-layered"]
    check_registry_sweep(
        "NR BG1 Z=384", ["--preset", "nr-bg1-layered", "--ebn0", "1.5",
                               "--max-frames", str(2 * nr_cfg.run.batch),
                               "--target-errors", "100000000"],
        env, "nr_bg1_z384_r12_std")
    rm, _ = finish(start(cli_cmd("import-standard", "--family", "5gnr",
                                 "--base-graph", "1", "--z", "384",
                                 "--remove", "--tables-dir", tables)),
                   "8d --remove NR")
    if not json.loads(rm)["removed"]:
        raise AssertionError("8d: --remove NR")
    secs["8d NR"] = time.perf_counter() - t0

    # a table with a 4-cycle (tests/test_import_standard.py:55)
    t0 = time.perf_counter()
    c = ieee80211n.make_code(648, "3/4")
    b = c.base.copy()
    rs = np.argwhere(b >= 0)
    r1, j1, r2, j2 = next(
        (r1, j1, r2, j2) for (r1, j1) in rs for (r2, j2) in rs
        if r2 > r1 and j2 != j1 and b[r1, j2] >= 0 and b[r2, j1] >= 0
        and b[r2, j2] >= 0)
    b[r2, j2] = (b[r1, j2] - b[r1, j1] + b[r2, j1]) % c.Z
    cyc_file = os.path.join(tmp, "cycle.json")
    with open(cyc_file, "w") as f:
        json.dump({"Z": c.Z, "base": b.tolist()}, f)
    proc = start(cli_cmd("import-standard", "--family", "ieee80211n", "--n",
                         "648", "--rate", "3/4", "--file", cyc_file,
                         "--tables-dir", tables))
    _, err = finish(proc, "8d 4-cycle", ok_codes=(1,))
    said = err.strip().splitlines()[-1]
    print(f"8d a table with a 4-cycle: exit {proc.returncode}, {said!r}",
          flush=True)
    if "REJECTED" not in said or "girth 4" not in said or os.listdir(
            tables):
        raise AssertionError("8d: the 4-cycle table was not rejected")
    secs["8d 4-cycle"] = time.perf_counter() - t0
    return launched


def check_microbench(micro, dev):
    """The microbenchmark library (S1-S6) == its plain versions on the card,
    tolerance 0; returns the worst error by kernel name."""
    rng = np.random.default_rng(66)
    worst = dict.fromkeys(micro.REPLACES, 0.0)
    g = micro.wifi648()

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        err = max_abs_err((got,), (want,))
        same = torch.equal(got, want)
        print(f"{name} {label}: max_abs_err {err:g} equal {same}", flush=True)
        if not same:
            raise AssertionError(f"microbench {name} != plain on {label}")
        worst[name] = max(worst[name], err)

    for c2v_bytes, what in ((0, "sweep"), (2, "minsum16"), (4, "minsum")):
        lanes, smem, blocks, resident, regs = micro.library_config(
            g, c2v_bytes)
        print(f"{what} (message bytes {c2v_bytes}): {lanes} lanes a block "
              f"({lanes // micro.LANES_PER_THREAD} x {g.Z} threads, "
              f"{micro.LANES_PER_THREAD} lanes a thread), {smem} B of shared "
              f"memory, {blocks} blocks an SM by the rule, {resident} by the "
              f"occupancy API, {regs} registers", flush=True)
        if (lanes, smem, blocks) != micro.block_shape(g, c2v_bytes):
            raise AssertionError("the library's block is not the wrapper's")
        if resident != blocks:
            raise AssertionError(f"{what}: {resident} resident blocks an SM, "
                                 f"the rule counts {blocks}")
    for B in (512, 1024, 1001, BATCH):
        chan_np = rng.integers(-100, 100, size=(g.nb, g.Z, B)).astype(np.int8)
        chan = torch.as_tensor(chan_np).to(dev)
        for use_rot in (True, False):
            hold("sweep", f"{'rot' if use_rot else 'base'} B={B} 44 sweeps "
                 f"(the totals wrap int32)", micro.sweep(chan, 44, use_rot),
                 micro.sweep_plain(chan, 44, use_rot))
            # 6 sweeps: past 2^16, within 2^31, so the kernel's 16-bit
            # totals wrap where the plain version's int32 ones do not
            top = exact_sweep_max(g, chan_np[:, :, :8], 6, use_rot)
            if not 2 ** 16 < top < 2 ** 31:
                raise AssertionError(f"6 sweeps reach {top}: not the 16-bit "
                                     f"wrap case")
            hold("sweep", f"{'rot' if use_rot else 'base'} B={B} 6 sweeps "
                 f"(|total| up to {top}: the 16-bit totals wrap, int32 "
                 f"not)", micro.sweep(chan, 6, use_rot),
                 micro.sweep_plain(chan, 6, use_rot))
        for dt in (torch.int32, torch.int16):
            hold("minsum", f"{dt} messages B={B} 20 sweeps",
                 micro.minsum(chan, 20, dt), micro.minsum_plain(chan, 20, dt))
    a, b = (rng.integers(-120, 120, size=(64, 256)).astype(np.int16)
            for _ in range(2))
    for label, iters in (("the script's inputs", 1), ("the int16 extremes", 1),
                         ("fed back 3 times", 3)):
        if "extremes" in label:
            a, b = (rng.integers(-32768, 32768, size=(64, 256)).astype(
                np.int16) for _ in range(2))
            a[0, :4] = [-32768, -32767, 32767, 0]
            b[0, :4] = [5, -32768, -32768, -32768]
        ta, tb = torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
        got = micro.int16(ta, tb, iters)
        hold("int16", label, got, micro.int16_plain(ta, tb, iters))
        if iters == 1:
            ref = np.minimum(np.where(a < b, np.maximum(a, b), np.abs(a)),
                             np.maximum(a, np.int16(3)))
            if not np.array_equal(got.cpu().numpy(), ref):
                raise AssertionError(f"int16 != numpy on {label}")
    for rows, n_ops in ((micro.Z, 64), (2 * micro.Z, 32), (4 * micro.Z, 16)):
        x = torch.as_tensor(rng.integers(
            -128, 128, size=(rows, micro.TILE_W)).astype(np.int8)).to(dev)
        hold("opchain", f"({rows}, {micro.TILE_W}) n_ops {n_ops} 50 "
             f"iterations, {micro.opchain_ilp(x)} a thread",
             micro.opchain(x, n_ops, 50), micro.opchain_plain(x, n_ops, 50))
    x = torch.as_tensor(rng.integers(
        -128, 128, (micro.Z, micro.N_TILES * micro.TILE_W)).astype(
            np.int8)).to(dev)
    g32, g1 = micro.grid32(x), micro.grid1(x)
    want = micro.gridstep_plain(x)
    hold("grid32", f"{tuple(x.shape)}, {micro.INNER} steps", g32, want)
    hold("grid1", f"{tuple(x.shape)}, {micro.INNER} steps", g1, want)
    if not torch.equal(g32, g1):
        raise AssertionError("grid32 != grid1")
    # grid1's ragged shapes: tiles 1, 3 = 2 + 1, 33 = 2 x 16 + 1 and 31 =
    # 16 + 8 + 4 + 2 + 1 (groups of 16, the rest in groups of 8, 4, 2, 1),
    # one row, a last block of part of a warp (tile_w 100, 13), and the
    # runtime instance (inner != 400)
    for rows, n_tiles, tile_w, inner in GRID1_SHAPES:
        x = torch.as_tensor(rng.integers(
            -128, 128, (rows, n_tiles * tile_w)).astype(np.int8)).to(dev)
        label = f"({rows}, {n_tiles} x {tile_w}), {inner} steps"
        g1, g32 = micro.grid1(x, inner, tile_w), micro.grid32(x, inner, tile_w)
        hold("grid1", label, g1, micro.gridstep_plain(x, inner))
        if not torch.equal(g32, g1):
            raise AssertionError(f"grid32 != grid1 on {label}")
    return worst


# S4-S6's functions in the library's SASS (mangled-name substrings): the
# instances the timed calls launch
SASS_REGISTER = {"opchain": "opchain_kernelILi1E", "grid32": "grid32_kernel",
                 "grid1": "grid1_kernelILi400E"}


def register_floors(micro, gpu, sms, clock_mhz):
    """The chain probe's cycles a link (`microbench.chain_probe`) and the
    loops of S4-S6 in the library's SASS: prints them and returns
    ({kernel: the dependent-issue latency in cycles of an instruction on its
    chain}, {kernel: (ALU, FMA) instructions a link of its chain}). The
    latency is measured on one thread's chain of S4 pairs (5 dependent
    instructions a pair) or S5/S6 steps (3 a step); S3's is the steps'."""
    funcs = sass_functions(micro.load_library().path)

    def fn(key):
        names = [n for n in funcs if key in n]
        if len(names) != 1:
            raise AssertionError(f"{key}: {names} in the library's SASS")
        return funcs[names[0]]

    cycles = micro.chain_probe()
    step = cycles["grid_step"] / micro.GRIDSTEP_CHAIN
    pair = cycles["opchain_pair"] / micro.OPCHAIN_CHAIN
    latency = {"int16": step, "grid32": step, "grid1": step, "opchain": pair}
    print(f"[{gpu}] dependent-issue latency (clock64 around one thread's "
          f"chain of dependent links): {cycles['grid_step']:.3f} cycles an "
          f"S5/S6 step, {step:.3f} an instruction of its "
          f"{micro.GRIDSTEP_CHAIN}; {cycles['opchain_pair']:.3f} an S4 pair, "
          f"{pair:.3f} an instruction of its {micro.OPCHAIN_CHAIN}; {sms} "
          f"SMs, clocks.max.sm {clock_mhz:g} MHz", flush=True)
    pipes = {}
    for name, key in SASS_REGISTER.items():
        ins = fn(key)
        per_link = 2 if name == "opchain" else 1
        loops = [[op for addr, op, _ in ins if lo <= addr <= hi]
                 for lo, hi in innermost_loops(ins)]
        loop = max(loops, key=lambda ops: sum(o in micro.MINMAX_OPS
                                              for o in ops), default=[])
        pipes[name] = micro.link_pipes(loop, per_link)
        mix = {op: loop.count(op) for op in sorted(set(loop))}
        print(f"  sass {name} ({key}): its main loop {len(loop)} "
              f"instructions {json.dumps(mix)}; a link of the chain: "
              f"{pipes[name][0]:.3f} ALU-pipe, {pipes[name][1]:.3f} FMA-pipe",
              flush=True)
    return latency, pipes


def register_row(micro, name, t, dev_t, cost, shape, latency, pipes, sms,
                 clock_mhz, gpu):
    """Prints and returns S3-S6's floors and bound beside the kernel's
    device-only time dev_t (ms) and its event time t[0]. shape: (the
    launch's threads' work n, tiles, the lane operations of the issue floor
    where no loop is read (S3), the dependent instructions on one element's
    chain, the links of the whole call: S4's pairs, S5/S6's steps)."""
    from ldpc_tpu_torch.utils.profiling import bound
    n, tiles, counted, chain_deps, call_links = shape
    clock = clock_mhz * 1e6
    grid, threads = micro.launch_grid(name, n, tiles)
    launch = micro.launch_floor_ms(grid, threads)
    if name in pipes:
        alu, fma = pipes[name]
        issue = micro.issue_floor_ms(alu * call_links, sms, clock,
                                     fma * call_links)
    else:
        issue = micro.issue_floor_ms(counted, sms, clock)
    chain = micro.chain_floor_ms(chain_deps, latency[name], clock)
    b_ms, b_by = bound(*cost)
    floors = {"bound": b_ms, "launch": launch, "issue": issue,
              "chain": chain}
    by = max(floors, key=floors.get)
    warps = grid[0] * grid[1] * -(-threads // 32)
    print(f"[{gpu}] {name}: device-only {dev_t:.4f} ms (events around the "
          f"call, the dispatch inside: {t[0]:.4f} ms); floors: launch "
          f"{launch:.5f} ms (an empty kernel of grid {grid}, {threads} "
          f"threads), issue {issue:.5f} ms (at {warps} warps on "
          f"{4 * sms} schedulers: "
          f"{issue * 4 * sms / min(warps, 4 * sms):.5f}), chain "
          f"{chain:.5f} ms ({chain_deps:g} dependent instructions x "
          f"{latency[name]:.3f} cycles); "
          f"the old bound {b_ms:.6f} ms by {b_by}; bound {floors[by]:.5f} ms "
          f"({by}), {100 * floors[by] / dev_t:.1f}% of the device-only "
          f"time", flush=True)
    return {"event_ms": t[0], "launch_floor_ms": launch,
            "issue_floor_ms": issue, "chain_floor_ms": chain,
            "floor_ms": floors[by], "floor_by": by}


def exact_sweep_max(g, chan, iters, use_rot):
    """The largest |total| of S1's exact (int64) sweeps of chan (nb, Z, b)."""
    c = chan.astype(np.int64)
    a, top = c, int(np.abs(c).max())
    for _ in range(2 * (iters // 2)):
        dst = c.copy()
        for row in g.entries:
            for j, s, _ in row:
                dst[j] += np.roll(a[j], -(s if use_rot else 0), axis=0)
        a = dst
        top = max(top, int(np.abs(a).max()))
    return top


def drive_microbench(micro):
    """The entry point in process, every variant at the reference's
    iteration counts; its counters are set to 0 just before and read just
    after. Returns (records by (variant, batch), launches by kernel)."""
    runs = [[v, "--batch", str(B)] for v in ("rot", "base", "minsum",
                                             "minsum16")
            for B in MICRO_BATCHES]
    runs += [["int16"], ["opshape"], ["gridstep"]]
    micro.reset_counters()
    records = {}
    t0 = time.perf_counter()
    for argv in runs:
        for rec in micro.main(argv):
            records[rec["variant"], rec.get("batch_tile")] = rec
    torch.cuda.synchronize()
    launches = dict(micro.kernel_launches)
    plain = sum(micro.plain_calls.values())
    print(f"microbench entry point: {len(runs)} runs in "
          f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}, "
          f"plain_calls {plain}", flush=True)
    if plain or not all(launches.values()):
        raise AssertionError("the entry point did not run every kernel, or "
                             "ran a plain version")
    if records["int16", None] != {"variant": "int16", "pass": True}:
        raise AssertionError("int16: FAIL")
    for B in MICRO_BATCHES:
        rot, base = records["rot", B], records["base", B]
        print(f"  B={B}: rot {rot['us_per_sweep']} us a sweep beside base "
              f"{base['us_per_sweep']} (the shift costs "
              f"{rot['us_per_sweep'] - base['us_per_sweep']:.3f} us, "
              f"{100 * (rot['us_per_sweep'] / base['us_per_sweep'] - 1):.1f}"
              f"%); minsum {records['minsum', B]['us_per_sweep']}, minsum16 "
              f"{records['minsum16', B]['us_per_sweep']}", flush=True)
    return records, launches


def check_hard(port, minsum, stream, dev):
    """Slice 6, the hard-decision path: HARD["frames"] frames at each p of
    the BSC through Gallager-B, bit-flipping and the soft min-sum decoder
    (K1 behind the batch-first transposes, 0 plain calls) on 802.11n n=648,
    and through both hard decoders on the (3,6)-regular array code, every
    curve held to results/bsc_hard_wifi648.json."""
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.codes.toy import array_qc
    from ldpc_tpu_torch.ops import channel as ch
    from ldpc_tpu_torch.ops import make_hard_decoder
    from ldpc_tpu_torch.ops.encode import make_encoder
    from ldpc_tpu_torch.ops.quantize import quantize
    from ldpc_tpu_torch.sim.pipeline import select_decoder
    from ldpc_tpu_torch.sim.stats import (mean_compatible, rates_compatible,
                                          wilson_interval)
    h = HARD
    cfg = port.PRESETS[h["preset"]]
    ct = from_reference(build_code(cfg), dev)
    reg = array_qc()
    B, n_batches = h["batch"], h["frames"] // h["batch"]
    soft, label = select_decoder(ct, cfg, batch=B, batch_first=True)
    if label != "cuda-minsum-bf":
        raise AssertionError(f"slice 6: the soft decoder is {label}")
    enc = make_encoder(ct)
    algs = ("gallager-b", "bit-flip")
    wifi_decs = {a: make_hard_decoder(ct.code, max_iter=h["max_iter"],
                                      algorithm=a) for a in algs}
    reg_decs = {a: make_hard_decoder(reg, max_iter=h["max_iter"],
                                     algorithm=a) for a in algs}
    gen = torch.Generator(device=dev)
    gen.manual_seed(h["seed"])

    def received(p):
        info = torch.randint(0, 2, (B, ct.k), generator=gen, device=dev,
                             dtype=torch.uint8)
        rx = ch.bsc(gen, enc(info), p)
        return info, rx, quantize(ch.bsc_llr(rx, p), cfg.quant)

    # the soft decoder on these LLRs (two magnitudes only) == its plain
    # version, before the counted run
    _, _, q = received(0.04)
    out_k, out_p = soft.kernel(q), soft.plain(q)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    print(f"K1 behind its transposes on BSC LLRs at p=0.04, B={B}: == plain "
          f"{same} (converged {int(out_k[2].sum())}/{B})", flush=True)
    if not same:
        raise AssertionError("slice 6: K1 != plain on BSC LLRs")

    with open(os.path.join(HERE, "results", h["ref"])) as f:
        ref = {r["p"]: r for r in json.load(f)["results"]}
    minsum.reset_counters()
    stream.reset_counters()
    t0 = time.perf_counter()
    per_frame = {}      # (p, curve) -> per-frame bit errors, all batches
    for p in h["ps"]:
        p32 = np.float32(p)
        for _ in range(n_batches):
            info, rx, q = received(p32)
            outs = {"min-sum-8bit": soft(q)[0], "uncoded": rx}
            outs.update({a: d(rx)[0] for a, d in wifi_decs.items()})
            for name, hard in outs.items():
                errs = (hard[:, ct.info_positions] != info).sum(dim=1)
                per_frame.setdefault((p, name), []).append(errs)
            y = ch.bsc(gen, torch.zeros((B, reg.n), dtype=torch.uint8,
                                        device=dev), p32)
            for a, d in reg_decs.items():
                per_frame.setdefault((p, "regular/" + a), []).append(
                    d(y)[0].sum(dim=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = minsum.library_launches["minsum_flood"]
    plain = minsum.plain_calls + stream.plain_calls
    print(f"slice 6: {len(h['ps'])} points of {h['frames']} frames in "
          f"{wall:.2f} s; backend {label}; kernel launches "
          f"{dict(minsum.library_launches)}, plain_calls {plain}", flush=True)
    if (launches != len(h["ps"]) * n_batches or plain
            or minsum.kernel_launches != launches or stream.kernel_launches):
        raise AssertionError("slice 6 did not run through K1 only")
    # 36 BER rows are held at once: each at 1% / 36 (two-sided), so that
    # the family of them fails a right port 1 time in 100, as one row would
    z_ber = family_z(len(per_frame))
    for (p, name), chunks in per_frame.items():
        errs = torch.cat(chunks).double()
        frames = errs.numel()
        bits = reg.n if name.startswith("regular/") else ct.k
        r, rf = ref[p][name], ref[p]["frames"]
        bit_errs, frame_errs = int(errs.sum()), int((errs > 0).sum())
        ref_fe = round(r["fer"] * rf)
        ok_f = rates_compatible(frame_errs, frames, ref_fe, rf)
        # The per-frame variance: this run's, or, where this run saw fewer
        # failed frames than it takes to estimate one, the least the file's
        # row allows (its bit errors spread evenly over its failed frames:
        # mu^2 / FER - mu^2).
        mu = r["ber"] * bits
        var = max(float(errs.var()),
                  mu * mu / r["fer"] - mu * mu if r["fer"] > 0 else 0.0)
        ok_b = mean_compatible(bit_errs, frames, mu * rf, rf, var, z=z_ber)
        lo, hi = wilson_interval(frame_errs, frames)
        rlo, rhi = wilson_interval(ref_fe, rf)
        print(f"  p {p} {name}: frames {frames} FER {frame_errs / frames:.4e}"
              f" [{lo:.4e}, {hi:.4e}] ref {r['fer']:.4e} [{rlo:.4e}, "
              f"{rhi:.4e}] compatible {ok_f}; BER "
              f"{bit_errs / (frames * bits):.4e} ref {r['ber']:.4e} "
              f"compatible {ok_b} (per-frame z-test at z = {z_ber:.3f}, sd "
              f"{var ** 0.5:.2f} bits/frame)", flush=True)
        if not (ok_f and ok_b and frames == h["frames"]):
            raise AssertionError(f"slice 6: {name} disagrees with "
                                 f"{h['ref']} at p = {p}")


# Slice 9, the process mesh (`parallel/mesh.py`): each run's rows and the
# same run without a mesh. MESH_RUNS: name -> (rng, Eb/N0 points, fused);
# two batches of B = 16,384 a run (a point of a fused run: 8,192 lanes a
# batch), no stop on errors
MESH_RUNS = {"host": ("host", (2.0,), False),
             "device": ("device", (2.0,), False),
             "fused": ("device", (1.5, 2.5), True)}
MESH_QAM = dict(preset="multihost-qam-chain", mesh="2x4", ranks=8,
                ebn0="5.5", frames=3 * 4096)
MESH_FLOOR = ["floor", "--algorithm", "normalized-min-sum", "--beta-lsb",
              "0", "--schedule", "layered", "--harvest-frames", "16384",
              "--batch", "8192", "--frames", "16384", "--ebn0", "3.0",
              "--delta", "1.2,1.6,2.0,2.4", "--stratified"]
RANK_LINE = re.compile(
    r"# rank (\d+) of (\d+) \((\w+), mesh \(([\d, ]+)\)\): lanes \[(\d+), "
    r"(\d+)\), decoder (\S+), kernel launches (\d+) \(packed (\d+), MC "
    r"(\d+)\), streaming launches (\d+), plain calls (\d+)")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stop_all(procs):
    """Kills every process of `procs` still running: a rank that failed
    leaves its peers waiting in a collective."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def mesh_sweep(port, name, mesh=None):
    """MESH_RUNS[name] on `wifi-648-r12-minsum` at B = 16,384 over `mesh`
    (None: one process): (rows, the sweep)."""
    from ldpc_tpu_torch.sim import Sweep
    rng, points, fused = MESH_RUNS[name]
    cfg = slice_config(port, "wifi-648-r12-minsum", rng)
    sw = Sweep(cfg, device="cuda", batch=BATCH, mesh=mesh)
    run = sw.run_fused if fused else sw.run
    frames = BATCH if fused else 2 * BATCH
    res = run(list(points), target_frame_errors=10 ** 9, max_frames=frames)
    return [[p.ebn0_db, p.frames, p.bit_errs, p.frame_errs, p.iter_sum,
             p.converged, p.batches] for p in res.points], sw


def draw_seconds(ct, B, reps=10):
    """Host-clock seconds (synced) of the host chain's draws of a batch of
    B codewords on the card: info bits (k, B), then BPSK noise (n, B)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    out = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.randint(0, 2, (ct.k, B), generator=g, device="cuda",
                      dtype=torch.uint8)
        torch.randn((ct.n, B), generator=g, device="cuda")
        torch.cuda.synchronize()
        if i >= 3:
            out.append(time.perf_counter() - t0)
    return out


def mesh_rank_main(argv):
    """One rank of slice 9b (`chip_smoke.py --mesh-rank R WORLD
    COORDINATOR`): MESH_RUNS over a flat mesh of WORLD ranks on the card,
    each run's rows, label, first lane and launch counters (reset before
    it), then the rank's step and the global draw's times; one JSON line."""
    import torch.distributed as dist
    rank, world, coordinator = int(argv[0]), int(argv[1]), argv[2]
    port = import_port()
    from ldpc_tpu_torch.kernels import minsum
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(coordinator, world, rank, device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        out = {}
        for name in MESH_RUNS:
            minsum.reset_counters()
            rows, sw = mesh_sweep(port, name, mesh)
            torch.cuda.synchronize()
            out[name] = {"rows": rows, "label": sw.backend,
                         "lane0": sw.run_batch.lane0,
                         "local": sw.run_batch.local_batch,
                         "launches": minsum.kernel_launches,
                         "mc": sum(minsum.mc_launches.values()),
                         "plain": minsum.plain_calls}
            if name == "host":
                s20 = np.float32(sigma_for(2.0, sw.code.rate, "bpsk"))
                out["step_s"] = step_seconds(sw.run_batch,
                                             sw.generator(0, 0), s20)
                out["draw_s"] = draw_seconds(sw.ct, BATCH)
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def check_mesh(port, minsum, gpu):
    """Slice 9, the process mesh (`parallel/mesh.py`, the mesh plumbing of
    `sim/` and the CLI). 9a: a world of one rank over NCCL on the card (a
    TCP coordinator on localhost): `Sweep` on `wifi-648-r12-minsum` at
    B = 16,384, host RNG, 2.0 dB, two batches, == the same sweep with no
    process group, through K1-IO only. 9b: a world of two processes on the
    card over gloo, 8,192 lanes a rank: the host-RNG sweep (K1-IO), the
    device-RNG sweep (K1-MC; rank 1 counts Philox from lane 8,192) and the
    two-point fused device-RNG sweep, each == this process's run, each
    rank's launches its kernel's, nothing plain. 9c: `sweep --preset
    multihost-qam-chain --mesh 2x4` over eight processes on the card
    (gloo), the preset's batch of 4,096 (512 lanes a rank, K3's packed
    instance on each), three batches at 5.5 dB, rank 0's JSON == the same
    command's one-process run without --mesh, each rank's launches (its
    stderr line) K3 only. 9d: `floor --mesh 2` on wifi-648-nms-floor's
    configuration (two processes from torchrun's environment, one card),
    two stratified IS batches at 3.0 dB: raw hits and frames ==, FER,
    rel_std and BER within rtol 1e-6 of the one-process run. 9e: the step
    of 9a with and without the process group, in turns, and the global
    draw's share of a rank's step at W = 1 and 2 (host clock, median of
    10, synced). 9f: `python -m ldpc_tpu_torch.parallel.dryrun --world 2
    --device cuda`, beside 9c and 9d. Returns the times."""
    import torch.distributed as dist

    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.parallel import init_distributed, make_mesh
    t_all = time.perf_counter()
    times = {}
    # 9a: a world of one over NCCL, against no process group
    one = {}
    for name in MESH_RUNS:
        one[name], sw1 = mesh_sweep(port, name)
        if name == "host":
            base = sw1
    backend = init_distributed(f"localhost:{free_port()}", 1, 0,
                               device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        minsum.reset_counters()
        rows, swm = mesh_sweep(port, "host", mesh)
        torch.cuda.synchronize()
        launched = (minsum.kernel_launches, minsum.plain_calls)
        ok = (rows == one["host"] and backend == "nccl"
              and launched == (2, 0))
        print(f"9a world of one ({backend}, mesh {tuple(mesh.mesh.shape)}) "
              f"{swm.backend}: {rows} == no process group {one['host']}: "
              f"{rows == one['host']}; launches {launched[0]}, plain calls "
              f"{launched[1]}", flush=True)
        if not ok:
            raise AssertionError("slice 9a: world of one != no process group")
        # 9e at W = 1: the step with and without the process group, in turns
        s20 = np.float32(sigma_for(2.0, base.code.rate, "bpsk"))
        for turn in ("none", "nccl", "nccl", "none"):
            sw = base if turn == "none" else swm
            st = step_seconds(sw.run_batch, sw.generator(0, 0), s20)
            times.setdefault(turn, []).append(statistics.median(st))
            print(f"[{gpu}] 9e step ({sw.backend}) of {BATCH} codewords, "
                  f"process group {turn}: {statistics.median(st) * 1e3:.4f} "
                  f"ms median of {len(st)} (min {min(st) * 1e3:.4f}, max "
                  f"{max(st) * 1e3:.4f})", flush=True)
    finally:
        dist.destroy_process_group()
    draw = statistics.median(draw_seconds(base.ct, BATCH))
    step1 = min(times["none"])
    times["draw W=1"] = draw
    print(f"[{gpu}] 9e the global draw of {BATCH} codewords (info bits, "
          f"BPSK noise): {draw * 1e3:.4f} ms median of 10, "
          f"{100 * draw / step1:.1f}% of the step at W = 1 "
          f"({step1 * 1e3:.4f} ms)", flush=True)

    # 9b: two processes on the card over gloo
    t0 = time.perf_counter()
    coordinator = f"localhost:{free_port()}"
    procs = [start([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                    "--mesh-rank", str(r), "2", coordinator])
             for r in range(2)]
    try:
        ranks = [json.loads(finish(p, f"slice 9b rank {r}", timeout=600
                                   )[0].strip().splitlines()[-1])
                 for r, p in enumerate(procs)]
    finally:
        stop_all(procs)
    for name in MESH_RUNS:
        got = [rk[name] for rk in ranks]
        kernel = "mc" if MESH_RUNS[name][0] == "device" else "launches"
        ok = (all(g["rows"] == one[name] for g in got)
              and [g["lane0"] for g in got] == [0, BATCH // 2]
              and all(g[kernel] == g["launches"] == 2 and g["plain"] == 0
                      for g in got))
        print(f"9b {name} over two ranks ({got[0]['label']}, lanes "
              f"{[(g['lane0'], g['local']) for g in got]}): {got[0]['rows']} "
              f"== one process {one[name]}: {ok}; launches a rank "
              f"{[g['launches'] for g in got]} (MC {[g['mc'] for g in got]}),"
              f" plain {[g['plain'] for g in got]}", flush=True)
        if not ok:
            raise AssertionError(f"slice 9b {name}: {got} != {one[name]}")
    step2 = statistics.median(ranks[0]["step_s"])
    draw2 = statistics.median(ranks[0]["draw_s"])
    times.update({"step W=2": step2, "draw W=2": draw2})
    print(f"[{gpu}] 9e rank 0 of two (gloo, one card): step of its "
          f"{BATCH // 2} lanes {step2 * 1e3:.4f} ms median of 10, the "
          f"global draw {draw2 * 1e3:.4f} ms ({100 * draw2 / step2:.1f}% of "
          f"the step); {time.perf_counter() - t0:.1f} s", flush=True)

    # 9c and 9d at once: the CLI over eight ranks and floor --mesh 2, each
    # beside its one-process run
    t0 = time.perf_counter()
    q = MESH_QAM
    with tempfile.TemporaryDirectory() as tmp:
        common = ["sweep", "--preset", q["preset"], "--ebn0", q["ebn0"],
                  "--max-frames", str(q["frames"]), "--target-errors",
                  "1000000000", "--no-checkpoint"]
        coordinator = f"localhost:{free_port()}"
        started = []
        try:
            qam = [start(cli_cmd(*common, "--mesh", q["mesh"],
                                 "--num-processes", str(q["ranks"]),
                                 "--coordinator", coordinator,
                                 "--process-id", str(r), "--out",
                                 os.path.join(tmp, f"qam{r}")))
                   for r in range(q["ranks"])]
            started += qam
            qam_one = start(cli_cmd(*common, "--out",
                                    os.path.join(tmp, "qam")))
            started.append(qam_one)
            env = {"WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                   "MASTER_PORT": str(free_port())}
            floor = [start(cli_cmd(*MESH_FLOOR, "--mesh", "2", "--out",
                                   os.path.join(tmp, f"floor{r}.json")),
                           env={**env, "RANK": str(r)}) for r in range(2)]
            started += floor
            floor_one = start(cli_cmd(*MESH_FLOOR, "--out",
                                      os.path.join(tmp, "floor.json")))
            started.append(floor_one)
            dryrun = start([sys.executable, "-m",
                            "ldpc_tpu_torch.parallel.dryrun", "--world", "2",
                            "--device", "cuda", "--timeout", "300"])
            started.append(dryrun)
            qam_err = [finish(p, f"slice 9c rank {r}")[1]
                       for r, p in enumerate(qam)]
            finish(qam_one, "slice 9c, one process")
            floor_err = [finish(p, f"slice 9d rank {r}")[1]
                         for r, p in enumerate(floor)]
            finish(floor_one, "slice 9d, one process")
            dry = finish(dryrun, "slice 9f, the dry run", timeout=400)[0]
        finally:
            stop_all(started)
        res = {}
        for name in ("qam0", "qam", "floor0.json", "floor.json"):
            path = os.path.join(tmp, name + ("" if "." in name else ".json"))
            with open(path) as fh:
                res[name] = json.load(fh)
        if any(os.path.exists(os.path.join(tmp, f"qam{r}.json"))
               for r in range(1, q["ranks"])):
            raise AssertionError("slice 9c: a rank other than 0 wrote")
    skip = ("wall_s", "info_bps")

    def counters(d):
        return [{k: v for k, v in r.items() if k not in skip}
                for r in d["results"]]

    lines = [RANK_LINE.search(e) for e in qam_err]
    if not all(lines):
        raise AssertionError("slice 9c: a rank printed no launch line:\n"
                             + "\n".join(e[-1500:] for e in qam_err))
    batches = q["frames"] // 4096
    for m in lines:
        print(f"9c {m.group(0)[2:]}", flush=True)
    ok = (counters(res["qam0"]) == counters(res["qam"])
          and res["qam0"]["config"]["run"]["mesh_shape"] == [2, 4]
          and [int(m.group(1)) for m in lines] == list(range(q["ranks"]))
          and all(m.group(3) == "gloo" and m.group(7) == "cuda-minsum-layered"
                  and int(m.group(8)) == int(m.group(9)) == batches
                  and int(m.group(12)) == 0 and int(m.group(6)) -
                  int(m.group(5)) == 512 for m in lines))
    print(f"9c sweep --preset {q['preset']} --mesh {q['mesh']} over "
          f"{q['ranks']} processes ({res['qam0']['decoder_backend']}): "
          f"{counters(res['qam0'])} == one process without --mesh "
          f"{counters(res['qam'])}: {ok}", flush=True)
    if not ok:
        raise AssertionError("slice 9c: the mesh run differs")
    a, b = res["floor0.json"]["points"], res["floor.json"]["points"]
    exact = [[p[k] for k in ("ebn0_db", "frames", "raw_hits")] for p in a]
    close = np.asarray([[p[k] for k in ("fer", "rel_std", "ber")] for p in a])
    want = np.asarray([[p[k] for k in ("fer", "rel_std", "ber")] for p in b])
    lines = [RANK_LINE.search(e) for e in floor_err]
    ok = (exact == [[p[k] for k in ("ebn0_db", "frames", "raw_hits")]
                    for p in b]
          and np.allclose(close, want, rtol=1e-6, atol=0)
          and res["floor0.json"]["proposal"] == res["floor.json"]["proposal"]
          and all(lines) and all(int(m.group(12)) == 0 for m in lines)
          # rank 0 also harvested; rank 1 launched the two IS batches
          and int(lines[1].group(8)) == 2 <= int(lines[0].group(8)))
    for m in lines:
        if m:
            print(f"9d {m.group(0)[2:]}", flush=True)
    print(f"9d floor --mesh 2 ({res['floor0.json']['proposal']['n_sets']} "
          f"sets): frames, raw hits {exact} ==, FER/rel_std/BER {close.tolist()}"
          f" against one process {want.tolist()} (rtol 1e-6): {ok}; 9c and "
          f"9d {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        raise AssertionError("slice 9d: floor --mesh 2 differs")
    lines = dry.strip().splitlines()
    ranks = [json.loads(x) for x in lines[:-1]]
    ok = (lines[-1] == "dryrun_multichip(2) ok" and len(ranks) == 2
          and ranks[0]["labels"][0] == "cuda-minsum"
          and ranks[0]["labels"][1].startswith("cuda-stream"))
    print(f"9f python -m ldpc_tpu_torch.parallel.dryrun --world 2 --device "
          f"cuda: {lines[-1]}; rank 0 {ranks[0] if ranks else None}: {ok}",
          flush=True)
    if not ok:
        raise AssertionError("slice 9f: the dry run")
    print(f"slice 9: {time.perf_counter() - t_all:.1f} s", flush=True)
    return times


def main():
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check "
                           "runs on a CUDA device only")
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(gpu, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device_count {torch.cuda.device_count()}", flush=True)
    port = import_port()
    from ldpc_tpu_torch.codes import build_code, from_reference
    from ldpc_tpu_torch.kernels import microbench as micro
    from ldpc_tpu_torch.kernels import minsum
    from ldpc_tpu_torch.kernels import minsum_stream as stream, probe_stream
    from ldpc_tpu_torch.ops.channel import sigma_for
    from ldpc_tpu_torch.sim import make_run_batch
    from ldpc_tpu_torch.sim.sweep import batch_seed
    from ldpc_tpu_torch.utils.profiling import bound, device_ms, event_ms
    dev = torch.device("cuda")

    phase("build (the four libraries at once)")
    libs = build_libraries(minsum, stream, micro)
    from ldpc_tpu_torch.kernels import build as kbuild
    print(subprocess.run([kbuild.find_nvcc(), "--version"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1])
    print_sass(minsum, stream, micro)
    phase("kernel vs plain (tolerance 0)")
    cfg648 = port.PRESETS["wifi-648-r12-minsum"]
    oms_cfg = port.PRESETS["wifi-full-oms"]
    rng = np.random.default_rng(2024)
    base_dec, base_q = cfg648.decoder, cfg648.quant
    oms = (dataclasses.replace(base_dec, algorithm="offset-min-sum"),
           dataclasses.replace(base_q, beta_lsb=2))
    nms = (dataclasses.replace(base_dec, algorithm="normalized-min-sum"),
           dataclasses.replace(base_q, alpha_num=3, alpha_shift=2))
    et = dict(early_term=True)

    def dec_cfg(d, **kw):
        return dataclasses.replace(d, **kw)

    def code(n, rate):
        return from_reference(build_code(dataclasses.replace(
            cfg648, code=dataclasses.replace(cfg648.code, n=n,
                                             rate=rate))), dev)

    wifi, n1944, r56 = code(648, "1/2"), code(1944, "3/4"), code(1944, "5/6")

    def long_code(preset, n=None, **code_kw):
        c = port.PRESETS[preset]
        if n:
            code_kw["n"] = n
        c = dataclasses.replace(c, code=dataclasses.replace(c.code,
                                                            **code_kw))
        return from_reference(build_code(c), dev)
    lay = oms_cfg.decoder                     # layered OMS, ET, 20 iterations
    lay_q = oms_cfg.quant
    sig = {(ct, db): float(sigma_for(db, ct.code.rate, "bpsk"))
           for ct, db in ((r56, 3.0), (r56, 3.5), (wifi, 2.0))}
    qam = slice_config(port, "multihost-qam-chain", "host")
    oms_et = slice_config(port, OMS_ET, "host")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    # (label, code, decoder cfg, quant cfg, B, fused, sigma of BPSK LLRs or
    # (configuration, Eb/N0) of the host chain that makes them)
    cases = [
        ("K1 n648 min-sum hard B=16384", wifi, base_dec, base_q, BATCH,
         False, None),
        ("K1-IO n648 min-sum fused-IO B=16384", wifi, base_dec, base_q,
         BATCH, True, 0.8),
        ("K1 n648 offset beta=2 hard B=2000", wifi, *oms, 2000, False, None),
        ("K1-IO n648 normalized alpha=3/4 fused-IO B=1000", wifi, *nms, 1000,
         True, 0.8),
        ("K1 n1944 r3/4 min-sum hard B=4096", n1944, base_dec, base_q, 4096,
         False, None),
        ("K1-IO n1944 r3/4 min-sum fused-IO B=4099", n1944, base_dec, base_q,
         4099, True, 0.8),
        ("K3 n1944 r5/6 OMS ET fused-IO 3.0 dB B=16384", r56, lay, lay_q,
         BATCH, True, sig[r56, 3.0]),
        ("K3 n1944 r5/6 OMS fixed-20 hard B=4099", r56,
         dec_cfg(lay, early_term=False), lay_q, 4099, False, None),
        ("K3 n648 normalized alpha=3/4 ET max_iter 7 hard B=2000", wifi,
         dec_cfg(nms[0], schedule="layered", max_iter=7, **et), nms[1], 2000,
         False, None),
        ("K3 n1944 r3/4 OMS ET fused-IO 16-QAM 5.5 dB B=16384", n1944,
         qam.decoder, qam.quant, BATCH, True, (qam, 5.5)),
        ("K2 n648 min-sum ET fused-IO 2.0 dB B=16384", wifi,
         dec_cfg(base_dec, **et), base_q, BATCH, True, sig[wifi, 2.0]),
        ("K2 n648 offset beta=2 ET max_iter 1 hard B=3000", wifi,
         dec_cfg(oms[0], max_iter=1, **et), oms[1], 3000, False, None),
        # K2's main path: wifi-648-oms-flood-et's decoder at its batch
        ("K2 n648 OMS beta=2 ET fused-IO 2.0 dB B=16384", wifi,
         oms_et.decoder, oms_et.quant, BATCH, True, sig[wifi, 2.0]),
    ]
    # K5: min* in every form; thresholds (8, 3, 0) at scale 4, () at scale
    # 0.5 (int8 input, so the scale only picks the thresholds), 6 bits
    star_lay = dec_cfg(base_dec, algorithm="min-star", schedule="layered")
    star_fl = dec_cfg(base_dec, algorithm="min-star")
    q6 = dataclasses.replace(base_q, bits=6)
    q_none = dataclasses.replace(base_q, scale=0.5)
    if (port.minstar_thresholds(base_q), port.minstar_thresholds(q_none)) != (
            (8, 3, 0), ()):
        raise AssertionError("min* thresholds are not (8, 3, 0) and ()")
    cases += [
        ("K5 n648 min* layered ET fused-IO 2.0 dB B=16384", wifi,
         dec_cfg(star_lay, **et), base_q, BATCH, True, sig[wifi, 2.0]),
        ("K5 n648 min* layered fixed-20 hard B=4099", wifi, star_lay, base_q,
         4099, False, None),
        ("K5 n648 min* flooding fixed-20 fused-IO B=16384", wifi, star_fl,
         base_q, BATCH, True, sig[wifi, 2.0]),
        ("K5 n648 min* flooding ET fused-IO 2.0 dB B=16384", wifi,
         dec_cfg(star_fl, **et), base_q, BATCH, True, sig[wifi, 2.0]),
        ("K5 n648 min* flooding ET hard B=2000", wifi, dec_cfg(star_fl, **et),
         base_q, 2000, False, None),
        ("K5 n1944 r5/6 min* layered ET fused-IO 3.0 dB B=4096", r56,
         dec_cfg(star_lay, **et), base_q, 4096, True, sig[r56, 3.0]),
        ("K5 n1944 r5/6 min* flooding fixed-5 hard B=2000", r56,
         dec_cfg(star_fl, max_iter=5), base_q, 2000, False, None),
        ("K5 n648 min* T=() layered ET hard B=2000", wifi,
         dec_cfg(star_lay, **et), q_none, 2000, False, None),
        ("K5 n1944 r5/6 min* T=() flooding ET max_iter 6 hard B=1000", r56,
         dec_cfg(star_fl, max_iter=6, **et), q_none, 1000, False, None),
        ("K5 n648 min* 6-bit layered ET fused-IO 2.0 dB B=4096", wifi,
         dec_cfg(star_lay, **et), q6, 4096, True, sig[wifi, 2.0]),
        ("K5 n1944 r5/6 min* 6-bit flooding fixed-5 hard B=1000", r56,
         dec_cfg(star_fl, max_iter=5), q6, 1000, False, None),
        ("K5 n648 min* 6-bit flooding fixed-20 hard B=3000", wifi, star_fl,
         q6, 3000, False, None),
    ]
    # the packed flooding instance (K1, K1-IO) at ragged and tiny batches,
    # 6 bits, the row read twice (the (3,30) array code: row degree 30,
    # above the largest register row) and slice 6's (3,6)-regular array code
    from ldpc_tpu_torch.codes.toy import array_qc
    q6_k1 = dataclasses.replace(base_q, bits=6)
    for B in RAGGED:
        cases += [
            (f"K1 n648 min-sum hard B={B}", wifi, base_dec, base_q, B, False,
             None),
            (f"K1-IO n648 min-sum fused-IO B={B}", wifi, base_dec, base_q, B,
             True, 0.8)]
    cases += [
        ("K1 n648 6-bit hard B=4099", wifi, base_dec, q6_k1, 4099, False,
         None),
        ("K1-IO n648 offset beta=2 6-bit fused-IO B=5", wifi, oms[0],
         dataclasses.replace(oms[1], bits=6), 5, True, 0.8),
        ("K1 n1944 r5/6 normalized alpha=3/4 hard B=4099", r56, *nms, 4099,
         False, None),
        ("K1-IO n1944 r5/6 offset beta=2 fused-IO B=16385", r56, *oms,
         16385, True, 0.8),
        ("K1 n1944 r3/4 6-bit hard B=3", n1944, base_dec, q6_k1, 3, False,
         None),
        ("K1 array 3x30 z31 (row degree 30, read twice) hard B=4099",
         bare_tensors(array_qc(3, 30, 31), dev), base_dec, base_q, 4099,
         False, None),
        ("K1 array 3x6 z17 (n=102) hard B=4099",
         bare_tensors(array_qc(), dev), base_dec, base_q, 4099, False, None),
        # codes with no block of four lanes, which take the two-lane
        # instance
        ("K1 DVB-S2 n=16,200 (two lanes a thread) hard B=5",
         long_code("dvbs2-64800-r12", 16200), base_dec, base_q, 5, False,
         None),
        ("K1 NR BG1 Z=384 (two lanes a thread) hard B=3",
         long_code("nr-bg1-layered"), base_dec, base_q, 3, False, None),
    ]
    # the packed flooding instance's early-terminating and min* forms (K2,
    # K5 flooding) at ragged and tiny batches; on n=1944 rate 3/4 (the
    # 16-entry register row) and 5/6 (rows of 19-20 in the 24-entry row);
    # 6 bits, NMS, max_iter 1; the (3,30) array code (min-sum ET reads its
    # rows twice; min* on rows of 30 keeps the one-lane template); and the
    # codes with no block of four lanes, on the two-lane instance
    star_fl_et = dec_cfg(star_fl, **et)
    for B in RAGGED:
        cases += [
            (f"K2 n648 OMS beta=2 ET fused-IO 2.0 dB B={B}", wifi,
             oms_et.decoder, oms_et.quant, B, True, sig[wifi, 2.0]),
            (f"K5 n648 min* flooding ET fused-IO 2.0 dB B={B}", wifi,
             star_fl_et, base_q, B, True, sig[wifi, 2.0]),
            (f"K5 n648 min* flooding fixed-20 hard B={B}", wifi, star_fl,
             base_q, B, False, None)]
    cases += [
        ("K2 n1944 r3/4 OMS ET fused-IO sigma 0.65 B=4099", n1944,
         dec_cfg(oms[0], **et), oms[1], 4099, True, 0.65),
        ("K2 n1944 r5/6 min-sum ET hard B=4099", r56,
         dec_cfg(base_dec, **et), base_q, 4099, False, None),
        ("K5 n1944 r3/4 min* flooding ET hard B=3000", n1944, star_fl_et,
         base_q, 3000, False, None),
        ("K5 n1944 r5/6 min* flooding ET fused-IO 3.0 dB B=4099", r56,
         star_fl_et, base_q, 4099, True, sig[r56, 3.0]),
        ("K2 n648 OMS beta=2 6-bit ET hard B=2000", wifi, oms_et.decoder,
         dataclasses.replace(oms_et.quant, bits=6), 2000, False, None),
        ("K2 n648 normalized alpha=3/4 ET fused-IO B=4099", wifi,
         dec_cfg(nms[0], **et), nms[1], 4099, True, 0.8),
        ("K5 n648 min* flooding ET max_iter 1 hard B=999", wifi,
         dec_cfg(star_fl_et, max_iter=1), base_q, 999, False, None),
        ("K5 n648 min* T=() flooding fixed-20 hard B=999", wifi, star_fl,
         q_none, 999, False, None),
        ("K2 array 3x30 z31 flooding ET (row degree 30, read twice) hard "
         "B=4099", bare_tensors(array_qc(3, 30, 31), dev),
         dec_cfg(base_dec, **et), base_q, 4099, False, None),
        ("K5 array 3x30 z31 min* flooding ET (one-lane template) hard B=999",
         bare_tensors(array_qc(3, 30, 31), dev), star_fl_et, base_q, 999,
         False, None),
        ("K2 NR BG1 Z=384 (two lanes a thread) ET hard B=3",
         long_code("nr-bg1-layered"), dec_cfg(base_dec, **et), base_q, 3,
         False, None),
        ("K5 DVB-S2 n=16,200 min* flooding (two lanes a thread) hard B=5",
         long_code("dvbs2-64800-r12", 16200), dec_cfg(star_fl, max_iter=5),
         base_q, 5, False, None),
    ]
    # the packed layered instance (K3, K5 layered) at ragged and tiny
    # batches; its fixed forms (fused IO at the main paths' batch, the
    # 16-entry row, the 8-entry row in hard-output form); the row read
    # twice (the (3,30) array code, rows of 30); and min* on rows of 30,
    # which keeps the one-lane template
    star_et = dec_cfg(star_lay, **et)
    for B in RAGGED:
        cases += [
            (f"K3 n1944 r5/6 OMS ET fused-IO 3.0 dB B={B}", r56, lay, lay_q,
             B, True, sig[r56, 3.0]),
            (f"K5 n648 min* layered ET fused-IO 2.0 dB B={B}", wifi, star_et,
             base_q, B, True, sig[wifi, 2.0])]
    cases += [
        ("K3 n1944 r5/6 OMS fixed-20 fused-IO 3.0 dB B=16384", r56,
         dec_cfg(lay, early_term=False), lay_q, BATCH, True, sig[r56, 3.0]),
        ("K3 n1944 r3/4 OMS fixed-20 hard B=4099", n1944,
         dec_cfg(qam.decoder, early_term=False), qam.quant, 4099, False,
         None),
        ("K3 n648 min-sum layered fixed-20 hard B=16384", wifi,
         dec_cfg(base_dec, schedule="layered"), base_q, BATCH, False, None),
        ("K5 n648 min* layered fixed-20 fused-IO B=16384", wifi, star_lay,
         base_q, BATCH, True, sig[wifi, 2.0]),
        ("K3 array 3x30 z31 layered ET (row degree 30, read twice) hard "
         "B=4099", bare_tensors(array_qc(3, 30, 31), dev),
         dec_cfg(base_dec, schedule="layered", **et), base_q, 4099, False,
         None),
        ("K5 array 3x30 z31 min* layered ET (one-lane template) hard B=999",
         bare_tensors(array_qc(3, 30, 31), dev), star_et, base_q, 999, False,
         None),
    ]
    # the one-lane template's min-sum family where no block of two lanes
    # fits (NR BG1 Z=384 rate 1/3: about 170 KB a lane), both schedules,
    # fixed and with early termination, at ragged tiny batches: no packed
    # launch
    nr13 = long_code("nr-bg1-layered", rate="1/3")
    for B in (3, 5):
        cases += [
            (f"K1 NR BG1 Z=384 r1/3 min-sum (one-lane template) hard B={B}",
             nr13, base_dec, base_q, B, False, None),
            (f"K2 NR BG1 Z=384 r1/3 min-sum ET (one-lane template) hard "
             f"B={B}", nr13, dec_cfg(base_dec, **et), base_q, B, False,
             None),
            (f"K3 NR BG1 Z=384 r1/3 OMS fixed-20 (one-lane template) hard "
             f"B={B}", nr13, dec_cfg(lay, early_term=False), lay_q, B, False,
             None),
            (f"K3 NR BG1 Z=384 r1/3 OMS ET (one-lane template) hard B={B}",
             nr13, lay, lay_q, B, False, None)]
    worst = dict.fromkeys(libs + ["minsum_flood_et"], 0.0)
    star_worst = dict.fromkeys(libs, 0.0)
    held = {}   # label -> the decoder held to its plain version at B=BATCH
    for label, ct, dc, qc, B, fused, sigma in cases:
        if fused:
            d = minsum.make_decoder(ct, dc, qc, input_scale=qc.scale,
                                    count_info_cols=ct.kb)
            if isinstance(sigma, tuple):
                args = chain_args(ct, *sigma, B=B, gen=gen)
            else:
                llr, info = channel_llrs(rng, ct, B, qc.scale, sigma)
                args = (torch.as_tensor(llr).reshape(ct.nb, ct.Z, B).to(dev),
                        torch.as_tensor(info).reshape(ct.kb, ct.Z, B).to(dev))
        else:
            d = minsum.make_decoder(ct, dc, qc)
            args = (torch.as_tensor(mixed_llrs(rng, ct.n, B, qc.qmax)
                                    ).reshape(ct.nb, ct.Z, B).to(dev),)
        if "(one-lane template)" in label and d.packed:
            raise AssertionError(f"{label}: a packed instance")
        packed0 = minsum.packed_launches[d.library]
        out_k = d.kernel(*args)
        torch.cuda.synchronize()
        if minsum.packed_launches[d.library] - packed0 != int(d.packed):
            raise AssertionError(f"{label}: packed launches")
        out_p = d.plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out_k, out_p)
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
        conv = int(out_k[-1].sum())
        iters = out_k[-2].double()
        print(f"{label}: max_abs_err {err:g} equal {same} (converged "
              f"{conv}/{B}, mean iters {float(iters.mean()):.3f}, "
              f"{d.library} {shape_text(d)})", flush=True)
        if not same:
            raise AssertionError(f"kernel != plain on {label}")
        if (d.minstar is not None) != label.startswith("K5"):
            raise AssertionError(f"{label}: thresholds {d.minstar}")
        tally = star_worst if d.minstar is not None else worst
        key = tally_key(d)
        tally[key] = max(tally.get(key, 0.0), err)
        if B == BATCH:
            held[label] = d
    for ct, dc in ((wifi, dec_cfg(base_dec, **et)), (r56, lay),
                   (wifi, dec_cfg(star_fl, **et)),
                   (r56, dec_cfg(star_lay, **et))):
        B = 1000
        d = minsum.make_decoder(
            ct, dc, base_q if dc.algorithm == "min-star" else lay_q,
            input_scale=4.0, count_info_cols=ct.kb)
        zero = (torch.full((ct.nb, ct.Z, B), 2.0, device=dev),
                torch.zeros((ct.kb, ct.Z, B), dtype=torch.uint8, device=dev))
        bits, frame, iters, conv = d.kernel(*zero)
        torch.cuda.synchronize()
        ok = (int(iters.abs().sum()) == 0 and bool(conv.all())
              and int(bits.sum()) == 0 and int(frame.sum()) == 0)
        print(f"all-zero noiseless {d.library} ({dc.algorithm}) n={ct.n} "
              f"B={B}: iters 0 and converged on every lane {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{d.library} all-zero batch: iters "
                                 f"{iters.unique().tolist()}")

    phase("K1-MC kernel vs plain (tolerance 0)")
    mc_worst, mc_timed, star_mc_worst = check_mc_kernels(port, minsum, dev)
    phase("slice 12: the two-lane packed instances vs plain (tolerance 0)")
    two_worst = check_two_lane(port, minsum, dev)

    phase("streaming library K6b-K6f vs plain (tolerance 0), and K3 behind "
          "its transposes")
    stream_held = check_stream_kernels(port, minsum, stream, dev, worst)
    phase("slices 10 and 11b-11d's decoders vs plain (tolerance 0): K2 at "
          "3-6 bits, K6e on 8PSK and 16APSK rate 2/3, K3 on NR BG2 Z=128, "
          "the 802.11n set, the check-node variants, the punctured ladders "
          "and the QC-PEG codes")
    recorded_held = check_recorded_kernels(port, dev)
    phase("the demap of every modulation on the card against the CPU")
    check_demap(dev)

    phase("microbench library S1-S6 vs plain (tolerance 0)")
    micro_worst = check_microbench(micro, dev)
    phase("microbench entry point, every variant (python -m "
          "ldpc_tpu_torch.kernels.microbench <variant> [--batch N])")
    micro_records, micro_launches = drive_microbench(micro)

    phase("slices 1, 2, 4, 5 and 10: sweeps against recorded waterfalls "
          "(wifi-648-r12-minsum; wifi-full-oms, also with rng=device; "
          "wifi-648-minstar (K5) and qam16-1944-chain (16-QAM chain + K3); "
          "the other min* instances on their steps; the long-codeword "
          "cells on the batch-first step: dvbs2-64800-r12 fixed and with "
          "early termination (the streaming library), dvbs2-16200 and NR "
          "BG1 route against route, NR BG1 Z=128 rate 1/3; the recorded "
          "configurations of slice 10: the bit-width study, 8PSK, 16APSK, "
          "NR BG2, n=1296 and n=1944 OMS, the float decoders; slice 11b-11d: "
          "the 802.11n set, the check-node variants, the rate-compatible "
          "ladders and the designed codes)")
    sweeps, launches, rows = {}, {}, {}
    for sl in SLICES:
        sweeps[sl.label], launches[sl.label], rows[sl.label] = run_slice(
            port, minsum, stream, sl)
    for sl in SLICES:
        ref = rows[sl.ref] if sl.ref in rows else read_ref(sl.ref)
        hold_slice(sl.label, sweeps[sl.label], rows[sl.label], ref, sl.ref,
                   rows[sl.equal_to] if sl.equal_to else None, sl.z,
                   sl.least_row)
    # every decoder a sweep launched was held to its plain version above,
    # as that instance and at that batch
    for label, checked in (
            ("wifi-648-r12-minsum",
             held["K1-IO n648 min-sum fused-IO B=16384"]),
            ("wifi-full-oms",
             held["K3 n1944 r5/6 OMS ET fused-IO 3.0 dB B=16384"]),
            ("wifi-full-oms, MC", mc_timed["layered"][0]),
            ("4a wifi-648-minstar",
             held["K5 n648 min* layered ET fused-IO 2.0 dB B=16384"]),
            ("4b qam16-1944-chain",
             held["K3 n1944 r3/4 OMS ET fused-IO 16-QAM 5.5 dB B=16384"]),
            ("4a wifi-648-minstar, MC", mc_timed["star layered"][0]),
            ("min* flooding",
             held["K5 n648 min* flooding ET fused-IO 2.0 dB B=16384"]),
            ("min* flooding, MC", mc_timed["star flood"][0]),
            (OMS_ET, held["K2 n648 OMS beta=2 ET fused-IO 2.0 dB B=16384"]),
            (OMS_ET + ", MC", mc_timed["oms flood et"][0]),
            *((label, d) for label, (d, _) in stream_held.items()),
            *((label, d) for label, (d, _, _) in recorded_held.items())):
        same_instance(sweeps[label].run_batch.decoder, checked, label)

    phase("slice 3: fused device-RNG sweep (run_fused)")
    fused_res, fused_launches, fused_dec = check_fused(
        port, minsum, stream, mc_timed["flood lanes"][0])
    phase("slice 10g: the deep tail (run_fused under its file's stop rule)")
    t0 = time.perf_counter()
    deep_launches = check_deep_tail(port, minsum, stream,
                                    mc_timed["flood lanes"][0])[1]
    print(f"slice 10g: {time.perf_counter() - t0:.2f} s", flush=True)

    phase("slice 6: the hard-decision path over the BSC (Gallager-B, "
          "bit-flipping, soft min-sum on K1; the regular array code)")
    check_hard(port, minsum, stream, dev)
    phase("slice 11d: the soft decoder over the BSC "
          "(results/bsc_wifi648.json)")
    # record name -> the runs of one kernel instance: (what launched it,
    # decoder, the batch it was held to plain on, launches, worst error)
    floor_runs = {"bsc_wifi648": [("11d " + BSC["ref"],
                                   *check_bsc_soft(port, minsum, stream,
                                                   dev))]}

    phase("CLI: sweep --rng device --fused")
    check_cli(fused_res)
    phase("CLI: sweep --preset dvbs2-64800-r12, sweep --puncture-frac 0.25")
    torch.cuda.empty_cache()
    check_cli_long()
    phase("slice 12: the two-lane instances' main paths through the CLI "
          "(flooding OMS ET on NR BG1 Z=384, layered min* on DVB-S2 "
          "n=16,200; rng host and device against --decoder-backend qc)")
    two_cli = check_two_lane_cli(port, minsum, stream)
    phase("slice 7: error floor (importance sampling on K3: the datapath, "
          "results/error_floor_wifi648.json at full size, NR BG1 Z=128 "
          "rate matching, the CLI's floor)")
    check_floor(port, minsum, stream, gpu)
    phase("slice 8: the design funnel and the table registry (DE, PEXIT, "
          "the census, import-standard with its smoke decode on the card)")
    smoke_launches = check_design(port, minsum, stream, gpu, worst)
    phase("slice 9: the process mesh (a world of one over NCCL; two, "
          "eight and two processes on the one card over gloo: the sweeps, "
          "multihost-qam-chain --mesh 2x4 through the CLI, floor --mesh 2)")
    check_mesh(port, minsum, gpu)
    for key, by, what, hold in (
            ("wifi_floor_sym", "11a.1 wifi_floor_sym.json", "the symmetric "
             "estimator on the census's orbit cover, K3 behind its "
             "transposes", hold_wifi_floor_sym),
            ("nr_floor_sym", "11a.2 nr_floor_sym.json", "the MC anchors on "
             "K3 behind its transposes, floor --symmetric",
             hold_nr_floor_sym),
            ("dvb_floor", "11a.3 dvb_floor_summary.json", "1.2 dB, plain "
             "MC on the streaming ET kernel", hold_dvb_floor_mc),
            ("dvb_floor", "11a.4 dvb_floor_r5.json", "its proposal through "
             "the symmetric estimator on the streaming ET kernel",
             hold_dvb_floor_sym)):
        phase(f"slice {by} ({what})")
        floor_runs.setdefault(key, []).append(
            (by, *hold(port, minsum, stream)))
        torch.cuda.empty_cache()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    if loaded:
        raise AssertionError(f"jax modules loaded: {loaded[:5]}")

    phase("two-phase == single-phase on the card (wifi-full-oms, 3.5 dB)")
    oms_sweep = sweeps["wifi-full-oms"]
    s35 = np.float32(sigma_for(3.5, r56.code.rate, "bpsk"))
    p1, frac = oms_sweep.auto_choice.get(1, (None, None))
    cfg2 = dataclasses.replace(oms_cfg, decoder=dataclasses.replace(
        oms_cfg.decoder, phase1_iters=p1 or 4, phase2_frac=frac or 0.25))
    rb2 = make_run_batch(oms_sweep.ct, cfg2, batch=BATCH)
    rb1 = oms_sweep.run_batch
    for b in range(2):
        c1 = rb1(oms_sweep.generator(1, b), s35).tolist()
        c2 = rb2(oms_sweep.generator(1, b), s35).tolist()
        print(f"batch {b}: single-phase {c1} two-phase ({rb2.backend_label}, "
              f"p1 {cfg2.decoder.phase1_iters}, capacity "
              f"{rb2.decoder.capacity}) {c2} equal {c1 == c2}", flush=True)
        if c1 != c2 or not rb2.backend_label.endswith("-2phase"):
            raise AssertionError("two-phase counters differ on the card")

    phase("times (CUDA events for kernels, host clock + sync for steps)")
    timing = {}   # name -> (kernel ms, plain ms, bound ms, bound by)

    def timed_call(d, args, what, kw={}, plain_reps=3):
        t = kernel_vs_plain_ms(d, args, kw, gpu, what, plain_reps=plain_reps)
        bound, by = bound_of(d, args, kw)
        print(f"  bound {bound:.4f} ms by {by} ({100 * bound / t[0]:.1f}% "
              f"of the kernel's time)", flush=True)
        return t + (bound, by)

    def timed_mc(key, d, what, plain_reps=3):
        """Times megakernel `d`, the decoder a main path launched, on the
        arguments of check_mc_kernels' case `key` (the same instance)."""
        checked, args, kw = mc_timed[key]
        same_instance(d, checked, what)
        return timed_call(d, args, what, kw, plain_reps)

    def bpsk_args(ct, db):
        return chain_args(ct, cfg648, db, BATCH, gen)

    # Each time is of the decoder object its main path launched. K1: the
    # canonical decode (the work does not depend on the data).
    s648 = sweeps["wifi-648-r12-minsum"]
    a20 = bpsk_args(wifi, 2.0)
    timing["K1"] = timed_call(
        s648.run_batch.decoder, a20,
        f"K1-IO decode of {BATCH} codewords (n648, fused-IO, 20 iterations)")
    timing["K1-MC flood"] = timed_call(
        *mc_timed["flood"][:2], f"K1-MC step of {BATCH} codewords (n648 "
        f"flooding, 20 iterations, Philox, 2.0 dB)")
    timing["K1-MC flood lanes"] = timed_mc(
        "flood lanes", fused_dec, f"K1-MC step of {FUSED['batch']} codewords "
        f"(n648 flooding, 20 iterations, Philox, per-lane sigma of "
        f"{len(FUSED['points'])} points: run_fused's launch)")
    # K1 in its other form, int8 in and hard bits out (slice 6's), on the
    # same channel quantized
    from ldpc_tpu_torch.ops.quantize import quantize
    k1_hard = minsum.make_decoder(wifi, base_dec, base_q)
    kernel_vs_plain_ms(
        k1_hard, (quantize(a20[0], base_q),), {}, gpu,
        f"K1 decode of {BATCH} codewords (n648, int8 in, hard bits out, 20 "
        f"iterations)")
    k2 = minsum.make_decoder(wifi, dec_cfg(base_dec, **et), base_q,
                             input_scale=4.0, count_info_cols=wifi.kb)
    timing["K2"] = timed_call(
        k2, a20, f"K2 decode of {BATCH} codewords (n648 min-sum, ET, "
        f"fused-IO, 2.0 dB)")
    timing["K2 OMS"] = timed_call(
        sweeps[OMS_ET].run_batch.decoder, a20,
        f"K2 decode of {BATCH} codewords (n648 OMS beta=2, ET, fused-IO, "
        f"2.0 dB: {OMS_ET}'s launch)")
    timing["K2 MC"] = timed_mc(
        "oms flood et", sweeps[OMS_ET + ", MC"].run_batch.decoder,
        f"K1-MC step of {BATCH} codewords (n648 flooding OMS beta=2, ET, "
        f"Philox, 2.0 dB: {OMS_ET}, MC's launch)")
    k3 = oms_sweep.run_batch.decoder
    for db in (3.0, 3.5):
        timing[f"K3 {db}"] = timed_call(
            k3, bpsk_args(r56, db),
            f"K3 decode of {BATCH} codewords (n1944 r5/6 OMS, ET, fused-IO, "
            f"{db} dB)")
    timing["K1-MC layered"] = timed_mc(
        "layered", sweeps["wifi-full-oms, MC"].run_batch.decoder,
        f"K1-MC step of {BATCH} codewords (n1944 r5/6 layered OMS, ET, "
        f"Philox, 3.5 dB)")
    k3f = minsum.make_decoder(r56, dec_cfg(lay, early_term=False), lay_q,
                              input_scale=4.0, count_info_cols=r56.kb)
    timing["K3 fixed"] = timed_call(
        k3f, bpsk_args(r56, 3.0),
        f"K3 decode of {BATCH} codewords (n1944 r5/6 OMS, 20 fixed "
        f"iterations, fused-IO, 3.0 dB)")
    s4a, s4b = sweeps["4a wifi-648-minstar"], sweeps["4b qam16-1944-chain"]
    timing["K3 qam16"] = timed_call(
        s4b.run_batch.decoder, chain_args(n1944, s4b.cfg, 6.0, BATCH, gen),
        f"K3 decode of {BATCH} codewords (n1944 r3/4 OMS, ET, fused-IO, "
        f"16-QAM LLRs at 6.0 dB: qam16-1944-chain's launch)")

    # K5 beside the min-sum instance of the same library on the same
    # inputs, in turns: the decoders slice 4 launched, then the fixed forms
    # (the plain min* versions take seconds: one run a turn)
    pairs = {   # what -> (the sweep's min* decoder or None, min-sum config)
        "layered ET 2.0 dB": (s4a.run_batch.decoder,
                              dec_cfg(star_lay, algorithm="min-sum", **et)),
        "flooding ET 2.0 dB": (sweeps["min* flooding"].run_batch.decoder,
                               dec_cfg(star_fl, algorithm="min-sum", **et)),
        "layered fixed-20": (None, dec_cfg(star_lay, algorithm="min-sum")),
        "flooding fixed-20": (None, dec_cfg(star_fl, algorithm="min-sum")),
    }
    for what, (d_star, ms_cfg) in pairs.items():
        if d_star is None:
            d_star = minsum.make_decoder(
                wifi, dec_cfg(ms_cfg, algorithm="min-star"), base_q,
                input_scale=4.0, count_info_cols=wifi.kb)
        d_ms = minsum.make_decoder(wifi, ms_cfg, base_q, input_scale=4.0,
                                   count_info_cols=wifi.kb)
        timing[f"pair {what}"] = kernels_in_turns_ms(
            {"min-sum": d_ms, "min*": d_star}, a20, gpu,
            f"n648 {what}, {BATCH} codewords, fused-IO")
        timing[f"K5 {what}"] = timed_call(
            d_star, a20, f"K5 decode of {BATCH} codewords (n648 min* {what}, "
            f"fused-IO)", plain_reps=1)
    for key, label in (("star layered", "4a wifi-648-minstar, MC"),
                       ("star flood", "min* flooding, MC")):
        d = sweeps[label].run_batch.decoder
        timing[f"K5 MC {d.dec.schedule}"] = timed_mc(
            key, d, f"K1-MC min* step of {BATCH} codewords (n648 "
            f"{d.dec.schedule}, ET, Philox, 2.0 dB)", plain_reps=1)

    # Slice 5. The streaming library's kernels in turns on the same inputs,
    # B = 1,024, at n=64,800, n=16,200 (K3 behind its transposes beside
    # them) and NR BG1 Z=384: the pipelined kernel against the template's
    # two placements, what `minsum_stream.instance_auto` rests on; then
    # each instance as its main path launched it (the decoder object held
    # above, on that input).
    l5a, l5b = "5a " + S64800, "5b " + S64800 + "-et"
    l5c, l5d = "5c " + S16200, "5d " + NR384
    l5f, l5fe = "5f " + S89, "5f " + S89 + "-et"
    l5g, l5ge = "5g " + S1689, "5g " + S1689 + "-et"
    d5a, q5a = stream_held[l5a]
    d5b = stream_held[l5b][0]
    d5cs, q5c = stream_held[l5c]
    d5c = stream_held[l5c + ", K3"][0]
    d5ds, q5d = stream_held[l5d]
    d5f, q5f = stream_held[l5f]
    d5fe, q5fe = stream_held[l5fe]
    d5g = stream_held[l5g][0]
    d5ge = stream_held[l5ge][0]
    if (d5a.variant, d5b.variant, d5cs.variant, d5ds.variant, d5f.variant,
            d5fe.variant, d5g.variant, d5ge.variant) != (
            "stream-pipelined", "stream-pipelined-et", "stream-resident-et",
            "stream-resident", "stream-pipelined", "stream-pipelined-et",
            "stream-pipelined", "stream-pipelined-et"):
        raise AssertionError("slice 5's sweeps did not cover the instances")
    if {d.kernel_name(256) for d in (d5f, d5fe, d5g, d5ge)} != {
            "stream_pipelined_kernel<28, false>",
            "stream_pipelined_kernel<28, true>"}:
        raise AssertionError("slices 5f and 5g did not launch the 28-entry "
                             "row")
    # the template's streamed instances, which slice 5f launched before the
    # pipelined kernel's 28-entry row took its code: a forced call
    # (`resident=False`) on 5f's input, its launches counted from 0, its
    # outputs those of 5f's decoder
    d5t = {et: stream.make_decoder(d.ct, sweeps[l].cfg.decoder,
                                   sweeps[l].cfg.quant, resident=False)
           for et, d, l in ((False, d5f, l5f), (True, d5fe, l5fe))}
    forced_launches = {}
    for et, q in ((False, q5f), (True, q5fe)):
        d = d5t[et]
        stream.reset_counters()
        out = d.kernel(q)
        torch.cuda.synchronize()
        forced_launches[d.variant] = stream.instance_launches[d.variant]
        only = stream.kernel_launches == forced_launches[d.variant] == 1
        want = (d5fe if et else d5f).kernel(q)
        ok = only and all(torch.equal(a, b) for a, b in zip(out, want))
        print(f"forced {d.variant} ({d.kernel_name(q.shape[0])}) on "
              f"{l5fe if et else l5f}'s input, B={q.shape[0]}: launches "
              f"{forced_launches[d.variant]}, == the pipelined kernel {ok}",
              flush=True)
        if not ok:
            raise AssertionError(f"forced {d.variant} on slice 5f")
    q5b = bf_chain(d5b.ct, sweeps[l5b].cfg, 1.25, STREAM_BATCH, gen)

    def in_turns(d, early_term, q, what, extra=None):
        """Every instance of the library that takes d's code on q, in
        turns: old, new, old, old, new, old."""
        decs = probe_stream.decoders(d.ct, d.max_iter, d.beta, d.qmax,
                                     d.alpha, early_term)
        return probe_stream.in_turns(decs, q, what, gpu, reps=5, extra=extra)

    def k3_of(ct, cfg, early_term):
        """K3 (the two-lane instance on these codes) behind its transposes,
        for the configuration `cfg` of code ct: the route `pallas`
        forces."""
        return BatchFirstDecoder(minsum.make_decoder(
            ct, dataclasses.replace(cfg.decoder, early_term=early_term),
            cfg.quant))

    def message_bound(d, q):
        """ms to move the int8 messages once each way for the iterations
        this call's lanes ran (E Z bytes a codeword and iteration), at
        3.35 TB/s: the bound if no message stays in the L2."""
        out = d.kernel(q)
        torch.cuda.synchronize()
        its = int(out[1].to(torch.int64).sum())
        return 2 * its * d.ct.n_entries * d.ct.Z / 3.35e9

    timing["turns 64800 fixed"] = in_turns(
        d5a, False, q5a, f"n=64,800 OMS fixed-20 at 1.0 dB, {STREAM_BATCH} "
        f"codewords")
    timing["turns 64800 ET"] = in_turns(
        d5b, True, q5b, f"n=64,800 OMS ET at 1.25 dB, {STREAM_BATCH} "
        f"codewords")
    from ldpc_tpu_torch.sim.pipeline import BatchFirstDecoder
    k3_16200_fixed = BatchFirstDecoder(minsum.make_decoder(
        d5c.inner.ct, dataclasses.replace(d5c.inner.dec, early_term=False),
        d5c.inner.quant))
    timing["turns 16200 fixed"] = in_turns(
        d5cs, False, q5c, f"n=16,200 OMS fixed-20 at 1.4 dB, {STREAM_BATCH} "
        f"codewords", extra={"K3 behind its transposes": k3_16200_fixed})
    timing["turns 16200 ET"] = in_turns(
        d5cs, True, q5c, f"n=16,200 OMS ET at 1.4 dB, {STREAM_BATCH} "
        f"codewords", extra={"K3 behind its transposes": d5c})
    # NR BG1 Z=384 and n=16,200 rate 8/9, B = 1,024 and 256: the packed
    # resident kernel (K6d, K6e) beside the template it replaces, the other
    # instances and K3 behind its transposes (the two-lane instance, what
    # `pipeline.stream_first` weighs); each call's bounds: operations, and
    # the message traffic if none stays in the L2
    for code_label, d_main, cfg_main, points in (
            ("NR BG1 Z=384", d5ds, sweeps[l5d].cfg, (1.0, 1.25)),
            ("n=16,200 rate 8/9", d5g, sweeps[l5g].cfg, (3.5, 3.75))):
        for B in (STREAM_BATCH, 256):
            for et, db in zip((False, True), points):
                q_t = bf_chain(d_main.ct, cfg_main, db, B, gen)
                key = (f"turns {code_label} {'ET' if et else 'fixed'} "
                       f"B={B}")
                timing[key] = in_turns(
                    d_main, et, q_t,
                    f"{code_label} OMS {'ET' if et else 'fixed-20'} at {db} "
                    f"dB, {B} codewords",
                    extra={"K3 behind its transposes": k3_of(
                        d_main.ct, cfg_main, et)})
                variant = "stream-resident-et" if et else "stream-resident"
                d_res = probe_stream.decoders(
                    d_main.ct, d_main.max_iter, d_main.beta, d_main.qmax,
                    d_main.alpha, et)[variant]
                b_ms, b_by = bound_of(d_res, (q_t,), {})
                print(f"  bound of {variant} ({d_res.kernel_name(B)}) on "
                      f"this call: {b_ms:.4f} ms by {b_by}; message traffic "
                      f"{message_bound(d_res, q_t):.4f} ms", flush=True)
    # n=64,800 rate 8/9 (rows of 27-28), B = 256 (slice 5f's input) and
    # 1,024, fixed-20 and with early termination at 3.0 dB: the pipelined
    # kernel's 28-entry row beside the template's `stream`, `stream-et`
    # (the parent's route) and its resident instance; each call's bounds
    for B in (256, STREAM_BATCH):
        for et in (False, True):
            d = d5fe if et else d5f
            q_t = ((q5fe if et else q5f) if B == 256 else
                   bf_chain(d.ct, sweeps[l5f].cfg, 3.0, B, gen))
            timing[f"turns 64800 r89 {'ET' if et else 'fixed'} B={B}"] = \
                in_turns(d, et, q_t, f"n=64,800 rate 8/9 OMS "
                         f"{'ET' if et else 'fixed-20'} at 3.0 dB, {B} "
                         f"codewords")
            b_ms, b_by = bound_of(d, (q_t,), {})
            exact = message_bound(d, q_t)
            w = stream.row_bytes(d.ct)
            print(f"  bound of {d.variant} ({d.kernel_name(B)}) on this "
                  f"call: {b_ms:.4f} ms by {b_by}; message traffic "
                  f"{exact:.4f} ms exact, "
                  f"{exact * w * d.ct.mb / d.ct.n_entries:.4f} ms as stored "
                  f"({w}-byte rows)", flush=True)
    # rows of 22-23 (rate 5/6): the pipelined kernel's 24-entry register row
    cfg56 = slice_config(port, S64800, "host")
    cfg56 = dataclasses.replace(cfg56, code=dataclasses.replace(
        cfg56.code, rate="5/6"))
    ct56 = from_reference(build_code(cfg56), dev)
    timing["turns 64800 r56 fixed"] = in_turns(
        stream.make_decoder(ct56, cfg56.decoder, cfg56.quant), False,
        bf_chain(ct56, cfg56, 3.0, STREAM_BATCH, gen),
        f"n=64,800 rate 5/6 (rows of 22-23) OMS fixed-20 at 3.0 dB, "
        f"{STREAM_BATCH} codewords")
    ct5 = d5a.ct
    per_cw = {"int8 messages": ct5.n_entries * ct5.Z,
              "int8 rows as stored": ct5.mb * ct5.Z * stream.row_bytes(ct5)}
    print(f"  message traffic at n=64,800, {STREAM_BATCH} codewords and 20 "
          f"iterations (read and written once an iteration), at 3.35 TB/s: "
          + ", ".join(f"{k} {2 * v * 20 * STREAM_BATCH / 1e9:.2f} GB, "
                      f"{2 * v * 20 * STREAM_BATCH / 3.35e9:.4f} ms"
                      for k, v in per_cw.items()), flush=True)
    timing["K6 stream-pipelined"] = timed_call(
        d5a, (q5a,), f"K6b/K6c stream-pipelined decode of {STREAM_BATCH} "
        f"codewords (n=64,800 OMS, 20 fixed iterations, 1.0 dB: {l5a}'s "
        f"launch)", plain_reps=1)
    timing["K6 stream-pipelined-et"] = timed_call(
        d5b, (q5b,), f"K6f stream-pipelined-et decode of {STREAM_BATCH} "
        f"codewords (n=64,800 OMS, ET, 1.25 dB: {l5b}'s launch)",
        plain_reps=1)
    timing["K6 stream-pipelined r89"] = timed_call(
        d5f, (q5f,), f"K6b/K6c stream-pipelined "
        f"({d5f.kernel_name(q5f.shape[0])}) decode of {q5f.shape[0]} "
        f"codewords (n=64,800 rate 8/9 OMS, 20 fixed iterations, 3.0 dB: "
        f"{l5f}'s launch)", plain_reps=1)
    timing["K6 stream-pipelined-et r89"] = timed_call(
        d5fe, (q5fe,), f"K6f stream-pipelined-et "
        f"({d5fe.kernel_name(q5fe.shape[0])}) decode of {q5fe.shape[0]} "
        f"codewords (n=64,800 rate 8/9 OMS, ET, 3.0 dB: {l5fe}'s launch)",
        plain_reps=1)
    timing["K6 stream"] = timed_call(
        d5t[False], (q5f,), f"K6b/K6c stream decode of {q5f.shape[0]} "
        f"codewords (n=64,800 rate 8/9 OMS, 20 fixed iterations, 3.0 dB: "
        f"the forced call on {l5f}'s input)", plain_reps=1)
    timing["K6 stream-et"] = timed_call(
        d5t[True], (q5fe,), f"K6f stream-et decode of {q5fe.shape[0]} "
        f"codewords (n=64,800 rate 8/9 OMS, ET, 3.0 dB: the forced call on "
        f"{l5fe}'s input)", plain_reps=1)
    timing["K6 nr384"] = timed_call(
        d5ds, (q5d,), f"K6d stream-resident ({d5ds.kernel_name(256)}) "
        f"decode of {q5d.shape[0]} codewords (NR BG1 Z=384 OMS, 20 fixed "
        f"iterations, 1.0 dB: {l5d}'s launch, `auto`)", plain_reps=1)
    timing["K3 nr384"] = timed_call(
        stream_held[l5d + ", K3"][0], (q5d,), f"K3 behind its transposes, "
        f"decode of {q5d.shape[0]} codewords (NR BG1 Z=384 OMS, 20 fixed "
        f"iterations, 1.0 dB: {l5d}, K3's launch)", plain_reps=1)
    timing["K6 16200 stream"] = timed_call(
        d5cs, (q5c,), f"K6e {d5cs.variant} ({d5cs.kernel_name(STREAM_BATCH)}) "
        f"decode of {STREAM_BATCH} codewords (n=16,200 OMS, ET, 1.4 dB: "
        f"{l5c}'s launch)",
        plain_reps=1)
    timing["K3 16200"] = timed_call(
        d5c, (q5c,), f"K3 behind its transposes, decode of {STREAM_BATCH} "
        f"codewords (n=16,200 OMS, ET, 1.4 dB: {l5c}, K3's launch)")
    # slice 12: the two-lane instances in every form, their route cells,
    # and the decoders of their main paths against plain
    two_timing, two_decs = time_two_lane(port, minsum, gpu, dev)
    timing.update(two_timing)
    # slices 10 and 11b-11d's instances, each the decoder its sweep
    # launched, on the input it was held to plain with: one time for each
    # (instance, batch) that check_recorded_kernels held, on its first
    # sweep's decoder and input
    slice_of = {sl.label: sl for sl in SLICES}
    first_of = {}       # held entry -> the first sweep that launched it
    for label, entry in recorded_held.items():
        first = first_of.setdefault(id(entry), label)
        if first != label:
            continue
        sl = slice_of[label]
        timing[label] = timed_call(
            entry[0], entry[1], f"{label}: {sweeps[label].backend} decode "
            f"of {sl.batch} codewords at {sl.points[0]} dB", plain_reps=1)
    # the deep floors' and the soft BSC's decoders, each instance on the
    # batch its first run held to plain
    for key, ((by, d, q, _, _), *_) in floor_runs.items():
        timing[key] = timed_call(d, (q,), f"slice {by}: "
                                 f"{type(d).__name__} decode of "
                                 f"{q.shape[0]} codewords", plain_reps=1)

    def report_step(name, rb, draw, sigma, k, batch=BATCH):
        st = step_seconds(rb, draw, sigma)
        med = statistics.median(st)
        print(f"[{gpu}] {name} step ({rb.backend_label}) of {batch} "
              f"codewords: {med * 1e3:.4f} ms median of {len(st)} (min "
              f"{min(st) * 1e3:.4f}, max {max(st) * 1e3:.4f}) -> "
              f"{batch * k / med:.6e} decoded info bits/s", flush=True)
        return med * 1e3

    dev648 = make_run_batch(s648.ct, slice_config(
        port, "wifi-648-r12-minsum", "device"), batch=BATCH)
    for turn in ("host", "device", "device", "host"):
        report_step(f"wifi-648-r12-minsum 2.0 dB rng={turn}",
                    s648.run_batch if turn == "host" else dev648,
                    s648.generator(0, 0) if turn == "host" else batch_seed(
                        s648.cfg.run.seed, 0, 0),
                    np.float32(sig[wifi, 2.0]), wifi.k)
    oms_dev = sweeps["wifi-full-oms, MC"]
    for turn in ("host", "device", "device", "host"):
        sw = oms_sweep if turn == "host" else oms_dev
        report_step(f"wifi-full-oms 3.5 dB rng={turn} single-phase",
                    sw.run_batch, sw.draw(1, 0), s35, r56.k)
    auto_rb = oms_sweep.tuned_run_batch(1, s35)
    for turn in ("single", "auto", "auto", "single"):
        report_step(f"wifi-full-oms 3.5 dB rng=host {turn}-phase",
                    rb1 if turn == "single" else auto_rb,
                    oms_sweep.generator(1, 0), s35, r56.k)
    for label, sw, db, key in (
            ("wifi-648-minstar 2.0 dB", s4a, 2.0, "K5 layered ET 2.0 dB"),
            ("qam16-1944-chain 6.0 dB", s4b, 6.0, "K3 qam16")):
        ms = [report_step(f"{label} rng=host", sw.run_batch,
                          sw.generator(1, 0), sw._sigma(db), sw.code.k_eff)
              for _ in range(2)]
        print(f"  its decode kernel alone: {timing[key][0]:.4f} ms, "
              f"{100 * timing[key][0] / min(ms):.1f}% of the faster step",
              flush=True)

    for label, si, db, key in ((l5a, 0, 1.0, "K6 stream-pipelined"),
                               (l5b, 1, 1.25, "K6 stream-pipelined-et"),
                               (l5c + ", K3", 0, 1.4, "K3 16200"),
                               (l5c, 0, 1.4,
                                "K6 16200 stream"),
                               (l5d, 0, 1.0, "K6 nr384"),
                               (l5d + ", K3", 0, 1.0, "K3 nr384"),
                               (l5f, 0, 3.0, "K6 stream-pipelined r89")):
        sw = sweeps[label]
        ms = [report_step(f"{label} {db} dB rng=host", sw.run_batch,
                          sw.generator(si, 0), sw._sigma(db), sw.code.k_eff,
                          sw.batch) for _ in range(2)]
        chain_ms = statistics.median(event_ms(
            lambda: sw.run_batch.chain(sw.generator(si, 0), sw._sigma(db)),
            5))
        print(f"  its decode kernel alone: {timing[key][0]:.4f} ms, "
              f"{100 * timing[key][0] / min(ms):.1f}% of the faster step; "
              f"its chain before the decoder (draws, encode, rate matching, "
              f"channel, quantize; CUDA events): {chain_ms:.4f} ms",
              flush=True)

    # The microbenchmark kernels beside their plain versions, in turns, at
    # the shapes the entry point gives them: the sweeps at K1's batch and the
    # entry point's smaller iteration count; the chain at 2,000 iterations
    # (its plain version is 80 launches an iteration).
    mrng = np.random.default_rng(0)
    mg = micro.wifi648()
    mchan = torch.as_tensor(mrng.integers(
        -100, 100, size=(mg.nb, mg.Z, BATCH)).astype(np.int8)).to(dev)
    ma, mb_ = (torch.as_tensor(mrng.integers(-120, 120, size=(64, 256)).astype(
        np.int16)).to(dev) for _ in range(2))
    mx = torch.as_tensor(mrng.integers(
        -100, 100, size=(micro.Z, micro.TILE_W)).astype(np.int8)).to(dev)
    mgrid = torch.as_tensor(mrng.integers(
        -100, 100, (micro.Z, micro.N_TILES * micro.TILE_W)).astype(
            np.int8)).to(dev)
    n_sweeps = micro.DEFAULT_ITERS["minsum"][0]
    micro_cases = {     # kernel -> (kernel, plain, arguments, cost, what)
        "sweep": (micro.sweep, micro.sweep_plain, (mchan, n_sweeps),
                  micro.sweep_cost(BATCH, n_sweeps),
                  f"S1 sweep, {n_sweeps} sweeps of {BATCH} codewords"),
        "minsum": (micro.minsum, micro.minsum_plain, (mchan, n_sweeps),
                   micro.sweep_cost(BATCH, n_sweeps, mg,
                                    micro.MINSUM_OPS_PER_EDGE),
                   f"S2 minsum, {n_sweeps} sweeps of {BATCH} codewords"),
        "int16": (micro.int16, micro.int16_plain, (ma, mb_),
                  micro.int16_cost(ma.numel()), "S3 int16, (64, 256)"),
        "opchain": (micro.opchain, micro.opchain_plain, (mx, 64, 2000),
                    micro.opchain_cost(mx.numel(), 64, 2000),
                    f"S4 opchain, ({micro.Z}, {micro.TILE_W}), 64 ops x "
                    f"2,000 iterations"),
        "grid32": (micro.grid32, micro.gridstep_plain, (mgrid,),
                   micro.gridstep_cost(mgrid.numel()),
                   f"S5 grid32, {tuple(mgrid.shape)}"),
        "grid1": (micro.grid1, micro.gridstep_plain, (mgrid,),
                  micro.gridstep_cost(mgrid.numel()),
                  f"S6 grid1, {tuple(mgrid.shape)}"),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[torch.cuda.current_device()])
    # S3-S6: (the launch's threads' work, tiles, counted lane operations,
    # one element's dependent instructions, the call's links) for
    # `register_row`
    n_pairs = 64 // 4
    register_shapes = {
        "int16": (ma.numel() // 2, 1, micro.INT16_OPS * ma.numel() // 2,
                  micro.INT16_CHAIN, 0),
        "opchain": (mx.numel(), 1, 0, micro.OPCHAIN_CHAIN * n_pairs * 2000,
                    mx.numel() * n_pairs * 2000),
        **{name: (micro.Z * micro.TILE_W, micro.N_TILES, 0,
                  micro.GRIDSTEP_CHAIN * micro.INNER,
                  mgrid.numel() * micro.INNER)
           for name in ("grid32", "grid1")}}
    latency, pipes = register_floors(micro, gpu, sms, clock_mhz)
    micro_floors = {}
    for name, (kernel, plain, args, cost, what) in micro_cases.items():
        t = kernel_vs_plain_ms(types.SimpleNamespace(kernel=kernel,
                                                     plain=plain),
                               args, {}, gpu, what, plain_reps=1)
        b_ms, b_by = bound(*cost)
        if name in register_shapes:
            # the device alone: S3-S6 last tens of microseconds, where the
            # host's dispatch inside the events weighs
            t_dev = statistics.median(device_ms(lambda: kernel(*args), 50))
            micro_floors[name] = register_row(
                micro, name, t, t_dev, cost, register_shapes[name], latency,
                pipes, sms, clock_mhz, gpu)
            t = (t_dev,) + t[1:]
        else:
            print(f"  bound {b_ms:.6f} ms by {b_by} ({100 * b_ms / t[0]:.1f}% "
                  f"of the kernel's time)", flush=True)
        timing["micro " + name] = t + (b_ms, b_by)
    for name, nbytes in (("sweep", 0), ("minsum", 4), ("minsum16", 2)):
        floor_ms = micro.smem_floor_ms(mg, nbytes, BATCH, n_sweeps, sms,
                                       clock_mhz * 1e6)
        print(f"[{gpu}] {name}: shared-memory floor {floor_ms:.4f} ms "
              f"({micro.smem_bytes_per_sweep(mg, nbytes)} B a codeword and "
              f"sweep, {n_sweeps} sweeps of {BATCH} codewords, "
              f"{micro.SMEM_BYTES_PER_CLOCK} B a clock on each of {sms} SMs "
              f"at {clock_mhz:g} MHz)", flush=True)
    s2 = micro_records["minsum", BATCH]
    print(f"[{gpu}] S2 minsum at B={BATCH}: {s2['us_per_sweep']} us a sweep "
          f"(minsum16 {micro_records['minsum16', BATCH]['us_per_sweep']}) "
          f"beside K1's {timing['K1'][0] * 1e3 / base_dec.max_iter:.3f} us an "
          f"iteration ({timing['K1'][0]:.4f} ms / {base_dec.max_iter}, the "
          f"same {BATCH} codewords with IO, int16 totals and int8 messages)",
          flush=True)

    def record(name, lib, launched, err, t, d):
        star = "_star" in name
        return {"name": name, "instance": instance_name(d), "route": "cuda",
                "source": minsum.STAR_SOURCE if star else minsum.SOURCES[lib],
                "replaces": (minsum.STAR_REPLACES if star
                             else minsum.MC_REPLACES if name.endswith("_mc")
                             else minsum.REPLACES[lib]),
                "launches": launched, "max_abs_err": err, "ms": t[0],
                "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                "library_ms": None}

    # the main path of each instance: the sweep that launched it (for the
    # template's `stream`, `stream-et`: the forced call on 5f's input, under
    # the records' names of before), its decoder and input; the pipelined
    # kernel's 28-entry row is a record of its own, named by its register row
    stream_runs = {     # record name prefix -> (variant, decoder, input,
        # launches, timing key, what launched it)
        "minsum_stream_pipelined_": (
            ("stream-pipelined", d5a, q5a, launches[l5a],
             "K6 stream-pipelined", l5a),
            ("stream-pipelined-et", d5b, q5b, launches[l5b],
             "K6 stream-pipelined-et", l5b)),
        "minsum_stream_pipelined28_": (
            ("stream-pipelined", d5f, q5f, launches[l5f],
             "K6 stream-pipelined r89", l5f),
            ("stream-pipelined-et", d5fe, q5fe, launches[l5fe],
             "K6 stream-pipelined-et r89", l5fe)),
        "minsum_stream_": (
            ("stream", d5t[False], q5f, forced_launches["stream"],
             "K6 stream", f"resident=False forced on {l5f}'s input"),
            ("stream-et", d5t[True], q5fe, forced_launches["stream-et"],
             "K6 stream-et", f"resident=False forced on {l5fe}'s input"),
            ("stream-resident", d5ds, q5d, launches[l5d], "K6 nr384",
             l5d),
            ("stream-resident-et", d5cs, q5c, launches[l5c],
             "K6 16200 stream", l5c)),
    }
    stream_records = [
        {"name": prefix + kid, "instance": d.kernel_name(q.shape[0]),
         "launched_by": by, "route": "cuda", "source": stream.SOURCE,
         "replaces": site, "launches": launched,
         "max_abs_err": worst[variant], "ms": t[0], "plain_ms": t[1],
         "bound_ms": t[2], "bound_by": t[3], "library_ms": None}
        for prefix, runs in stream_runs.items()
        for variant, d, q, launched, key, by in runs
        for kid, site in stream.REPLACES[variant]
        for t in (timing[key],)]
    def kernel_records(tag, d, args, launched, err, t, by):
        """The kernels line's records of decoder d, launched `launched`
        times by `by` and timed on `args` (t: ms, plain ms, bound ms, bound
        by): a streaming instance's, one a TPU kernel it replaces; an
        on-chip decoder's, named by its library (K2: minsum_flood_et)."""
        if hasattr(d, "variant"):
            return [{"name": f"minsum_stream_{kid}_{tag}",
                     "instance": d.kernel_name(args[0].shape[0]),
                     "launched_by": by, "route": "cuda",
                     "source": stream.SOURCE, "replaces": site,
                     "launches": launched, "max_abs_err": err, "ms": t[0],
                     "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                     "library_ms": None}
                    for kid, site in stream.REPLACES[d.variant]]
        inner = getattr(d, "inner", d)
        lib = inner.library
        et = lib == "minsum_flood" and inner.dec.early_term
        return [dict(record(("minsum_flood_et_" if et else lib + "_") + tag,
                            lib, launched, err, t, d), launched_by=by)]

    # slice 10's instances, named by the kernel and the slice's file, and
    # the deep tail's launches of slice 3's K1-MC instance; slice 11's, one
    # for each (instance, batch) held, named by the first file that launched
    # it (its sweeps' launches summed), and the decoders of the deep floors
    # and the soft BSC
    recorded_records = [dict(record(
        "minsum_flood_deep_tail_mc", "minsum_flood", deep_launches,
        mc_worst["minsum_flood"], timing["K1-MC flood lanes"], fused_dec),
        launched_by="10g " + DEEP_TAIL)]
    groups = {}
    for label, entry in recorded_held.items():
        if label.startswith("10"):
            recorded_records += kernel_records(
                label.split(" ", 1)[1].replace(" ", ""), *entry[:2],
                launches[label], entry[2], timing[first_of[id(entry)]],
                label)
        else:
            groups.setdefault(id(entry), []).append(label)
    for key, labels in groups.items():
        d, args, err = recorded_held[labels[0]]
        recorded_records += kernel_records(
            labels[0].split(" ", 1)[1], d, args,
            sum(launches[label] for label in labels), err,
            timing[first_of[key]], labels if len(labels) > 1 else labels[0])
    for key, runs in floor_runs.items():
        _, d, q, _, _ = runs[0]
        for by, other, _, _, _ in runs[1:]:
            same_instance(other, d, by)
        recorded_records += kernel_records(
            key, d, (q,), sum(r[3] for r in runs), max(r[4] for r in runs),
            timing[key], [r[0] for r in runs] if len(runs) > 1 else runs[0][0])

    # launches: of the main path named; ms, plain_ms, bound_ms: of the
    # decoder object that path launched, at its batch; the kernels slice
    # 8d's smoke decodes launched also carry those launches
    records = [
        record("minsum_flood", "minsum_flood",
               launches["wifi-648-r12-minsum"], worst["minsum_flood"],
               timing["K1"], s648.run_batch.decoder),
        record("minsum_layered", "minsum_layered",
               launches["wifi-full-oms"], worst["minsum_layered"],
               timing["K3 3.0"], k3),
        # the two-lane instances where no block of four lanes fits: K3
        # behind the batch-first transposes on DVB-S2 n=16,200 (forced
        # "pallas"), and the CLI's main paths (slice 12): K2 on NR BG1
        # Z=384 with host and device RNG, layered min* on DVB-S2 n=16,200
        record("minsum_layered_two_lane", "minsum_layered",
               launches[l5c + ", K3"],
               max(worst["minsum_layered"], two_worst[instance_name(d5c)]),
               timing["K3 16200"], d5c),
        dict(record("minsum_flood_et_two_lane", "minsum_flood",
                    two_cli["NR BG1 Z=384 flooding OMS ET"],
                    two_worst[instance_name(two_decs["K2 two-lane"])],
                    timing["K2 two-lane"], two_decs["K2 two-lane"]),
             launched_by="12 CLI NR BG1 Z=384 flooding OMS ET"),
        dict(record("minsum_layered_star_two_lane", "minsum_layered",
                    two_cli["DVB-S2 n=16,200 r1/2 layered min*"],
                    two_worst[instance_name(two_decs["K5 layered two-lane"])],
                    timing["K5 layered two-lane"],
                    two_decs["K5 layered two-lane"]),
             launched_by="12 CLI DVB-S2 n=16,200 r1/2 layered min*"),
        # K2: its main path since the packed kernel took it
        record("minsum_flood_et", "minsum_flood", launches[OMS_ET],
               worst["minsum_flood_et"], timing["K2 OMS"],
               sweeps[OMS_ET].run_batch.decoder),
        record("minsum_flood_et_mc", "minsum_flood", launches[OMS_ET + ", MC"],
               mc_worst["minsum_flood_et"], timing["K2 MC"],
               sweeps[OMS_ET + ", MC"].run_batch.decoder),
        record("minsum_flood_mc", "minsum_flood", fused_launches,
               mc_worst["minsum_flood"], timing["K1-MC flood lanes"],
               fused_dec),
        record("minsum_layered_mc", "minsum_layered",
               launches["wifi-full-oms, MC"],
               mc_worst["minsum_layered"], timing["K1-MC layered"],
               sweeps["wifi-full-oms, MC"].run_batch.decoder),
        record("minsum_layered_star", "minsum_layered",
               launches["4a wifi-648-minstar"], star_worst["minsum_layered"],
               timing["K5 layered ET 2.0 dB"], s4a.run_batch.decoder),
        record("minsum_flood_star", "minsum_flood",
               launches["min* flooding"], star_worst["minsum_flood"],
               timing["K5 flooding ET 2.0 dB"],
               sweeps["min* flooding"].run_batch.decoder),
        record("minsum_layered_star_mc", "minsum_layered",
               launches["4a wifi-648-minstar, MC"],
               star_mc_worst["minsum_layered"], timing["K5 MC layered"],
               sweeps["4a wifi-648-minstar, MC"].run_batch.decoder),
        record("minsum_flood_star_mc", "minsum_flood",
               launches["min* flooding, MC"],
               star_mc_worst["minsum_flood"], timing["K5 MC flooding"],
               sweeps["min* flooding, MC"].run_batch.decoder),
        *stream_records,
        *recorded_records,
        *({"name": f"microbench_{name}", "route": "cuda",
           "source": micro.SOURCE, "replaces": micro.REPLACES[name],
           "launches": micro_launches[name],
           "max_abs_err": micro_worst[name], "ms": t[0], "plain_ms": t[1],
           "bound_ms": t[2], "bound_by": t[3], "library_ms": None,
           **micro_floors.get(name, {})}
          for name in micro.REPLACES
          for t in (timing["micro " + name],))]
    for rec in records:
        if rec["name"] in smoke_launches:
            rec["smoke_decode_launches"] = smoke_launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # both join a world (9a's world of one here, a 9b rank), so both leave
    # as every rank does
    rc = (mesh_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--mesh-rank"]
          else main())
    from ldpc_tpu_torch.parallel import exit_process
    exit_process(rc or 0)
