#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nabu_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # build + one check of each kernel
    python3 chip_smoke.py --sweep    # build + the f32 GEMM's K splits timed

Phases, each printing JSON lines:

1. build    — nvcc builds every kernel source from the checkout, one
              process per source, all started together;
2. device   — the card's name and power limit (nvidia-smi);
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card at the full shapes of the serving and training paths:
              max error against the stated tolerance, and a planted
              fault's error, which the tolerance must reject; kernel /
              plain / library times (CUDA events) and the bound (least
              time for the same work);
4. serve    — a full-width dblstm_ctc_wsj artifact (4x320 BLSTM, bf16,
              seeded random weights saved as a best checkpoint, written
              by ``serving.export_model`` as the serve phases' artifacts
              all are) serves 64 synthesized utterances of
              1-15 s through ``serving.serve`` at batch 32; launch counts
              are zeroed just before and read just after, and every
              serving kernel must have run. One batch is then checked:
              kernel path against the same path through the plain
              versions (features and logits, each with a planted fault)
              and the beam search on the card against the same search on
              the CPU;
5. serve_rnnt — a full-width rnnt_char_wsj artifact (Listener of 320
              units, time / 4, prediction LSTM, 320-wide joint, bf16,
              seeded random weights) serves 64 utterances with the
              recipe's transducer_beam (width 8); the serving kernels must
              run and no loss kernel; one batch's n-best on the card must
              equal the same search on the CPU over the same encoder
              output (both in float64; the bf16 agreement is reported);
6. train    — a synthesized character corpus (256 utterances of 2-10 s,
              the recipe's 28 symbols at ~12 a second) goes through
              ``cli data`` and ``cli train`` with the dblstm_ctc_wsj
              recipe, unchanged but for its datafiles and 40 steps: the
              loss at each step, the step time split into forward, loss,
              backward and optimizer, audio seconds trained per second
              of the wall time of steps 2-40 end to end (loader, copy
              to the device and logging included) and of the phases
              alone, peak device memory; launch counts must equal steps x the
              per-step launches; ``latest/`` must reload into the same
              outputs; then one full-width batch's loss and every
              parameter gradient, dropout off, through the kernels
              against the plain versions (with a planted fault);
7. pipeline — the rest of the main path on that trained expdir, each
              stage through ``cli`` and timed, its launch counts zeroed
              just before and read just after: ``test`` (the recipe's
              ctc_beam 16 over the test split, which is the dev split)
              and ``decode`` (``nbest.txt`` must cover every test
              utterance) launch the v2 inference kernels and no other;
              ``export`` must copy best/'s params.npz bit for bit;
              ``serve`` over the exported artifact must answer each of 8
              dev wavs, launching the frontend kernel too, and
              ``recognize`` of the same wavs must give serve's texts;
              ``align`` (CTC forced alignment) writes a CTM covering every
              dev utterance whose segments read as its targets, with the
              v2 inference kernels only; on one batch its Viterbi on the
              card against the CPU (frame labels identical, scores within
              1e-5), each path score at most ``ctc_alpha``'s
              log-likelihood, and a planted skip into a repeated label
              caught;
8. train_rnnt — the same corpus through ``cli data`` and ``cli train``
              with the rnnt_char_wsj recipe (40 steps, the same checks;
              the step split shows the prediction net's share of the
              forward, which runs through the LSTM kernels);
9. serve_stream — a full-width rnnt_streaming_wsj artifact (4x320
              forward-only LSTM encoder, the 1x320 transducer head, bf16,
              seeded random weights) serves 32 utterances through
              ``serving.serve`` with the recipe's transducer_streaming
              recognizer at batch 32 (chunks of 32 frames): only the
              frontend and LSTM forward kernels may run; the same batches
              through transducer_greedy must give identical ids (scores
              within 1e-4); per-chunk ``feed`` latency at batch 1;
              ``serve(streaming=True)`` PARTIAL / FINAL lines, the FINAL
              texts against the batch-32 offline texts (bf16 reported, f32
              required);
10. train_rnnt_stream — ``cli train`` of the rnnt_streaming_wsj recipe
              on the same corpus (40 steps, the same checks; 5 LSTM walks,
              chains and dwh a step, and the dwh launches' share of the
              backward, from CUDA events around them). Its database.conf
              has train_rnnt's sections, so it takes a copy of the data
              train_rnnt's ``cli data`` prepared (checked section by
              section);
11. train_las — ``cli data`` (with the recipe's 3-way speed perturbation,
              from part of the corpus: 96 utterances, 288 after
              perturbation) and 40 steps of ``cli train`` of las_large_wsj
              (5 BLSTM layers of 512 units through the v1 kernels, the
              location-attention Speller, label-smoothed cross-entropy,
              SpecAugment, bf16, B = 64), the same checks (loss and token
              accuracy a step, the forward's Listener and Speller shares;
              5 v1 walks, gates recomputes, chains and dwh a step, no v2
              walk or chain; the gradient check's fault: dwh paired with h
              one step late), then the recipe's attention_greedy validation
              decode of the trained checkpoint over the dev set at B = 64
              (the path of the v1 inference walk): its RTF and launches,
              and the card's ids against the CPU's in f32 on one batch;
12. bench_ctc — the port's bench line (``python -m nabu_tpu_torch.bench``,
              run in process): the 4x320 DBLSTM-CTC step at B = 32, T =
              1000, bf16, warmup 2, 3 repeats of 8 steps, its audio
              seconds a second, median step and its split (CUDA events);
              its launches must be the train phase's per-step launches
              x the steps run;
13. bench_rnnt — the same line for the transducer (``--model rnnt``: a
              2 x 320 Listener, the 1 x 320 prediction net, a 320-wide
              joint, V = 32; T' = 250, U + 1 = 101); its launches must be
              train_rnnt's per-step launches x the steps run;
14. serve_las — (run after serve_stream) a full-width las_large_wsj
              artifact (5 BLSTM layers of 512 units, time / 16, the 2 x 512
              location-attention Speller, bf16, seeded random weights)
              serves 32 utterances of 1-15 s with the recipe's
              attention_beam (beam 16, nbest 8) at batch 32: only the
              frontend and the v2 inference kernels may launch; RTF and
              peak memory; the longest batch's search alone (decode steps,
              ms a step over 512 hypotheses, the host sync a step's cost:
              the same steps without it); then the 4 shortest
              utterances' (ATT_CHECK_UTTS; 8 before train_dp took its
              time) n-best on the card against the CPU over the same
              encoder output, in float64 (identical, scores within 1e-6;
              bf16 reported);
15. serve_joint — the same for a full-width joint_ctc_att_multihost
              artifact (4 BLSTM layers of 512 units, time / 8, the 2 x 512
              bahdanau Speller and the CTC head) with the recipe's
              joint_ctc_att_beam (ctc_weight 0.3), the CTC prefix scan's
              share of the search, and one batch of attention_rescoring;
16. train_joint — (run after train_las) 20 steps of ``cli train
              --distributed`` (one rank of an NCCL group of one, this
              process) of joint_ctc_att_multihost on a copy of train_las's
              prepared data (the recipes' database.conf are the same), B =
              64: the group checked, the gradients' all-reduce timed; the
              same checks (4 v1 walks, recomputes, chains and dwh a step,
              the CTC loss kernels once), the gradient check with the
              Speller's tolerance on the attention head, then ``cli test``
              (attention_beam on head att, beam 16) over the dev split: its
              error and wall time, the v2 inference kernels only;
17. bench_las — the bench's las line (``--model las``: a 4 x 512 Listener,
              the 2 x 512 Speller and the CTC head at B = 32, T = 1000; its
              launches 5 v2 layers and the CTC loss a step), then its
              ``att`` and ``joint`` decode lines at beam 8;
18. serve_conformer_aed — (run after serve_joint) a full-width
              conformer_aed_wsj artifact (8 conformer blocks of 256 units,
              time / 4, the 4 x 256 transformer decoder and the CTC head,
              bf16, seeded random weights) serves 32 utterances with the
              recipe's joint_ctc_att_beam (beam 16, ctc_weight 0.3): only
              the frontend kernel may launch; serve_joint's readings, and
              the decoder's: one step at B x W = 512, the KV caches' beam
              gather a step, and the cached step chain against the
              parallel apply (bf16 and f32) with a planted fault, each
              step's K / V written one slot late;
19. train_conformer_rnnt — (run after train_joint) 20 steps of ``cli
              train`` of conformer_rnnt_wsj (8 conformer blocks of 256
              units, the 1 x 320 prediction LSTM, the 320-wide joint, B =
              32) on a copy of the train phase's prepared data, the same
              checks (the launches the prediction net's LSTM walk, chain
              and dwh and each RNN-T kernel once a step; the loss of one
              fixed batch before and after; the gradient check's fault:
              each lane's last frame out of dpred), then ``cli test``
              (transducer_greedy) over the dev split;
22. train_dp — (run after train_conformer_rnnt, before the bench lines)
              data-parallel training of joint_ctc_att_multihost at its full
              width: two ranks (processes of this script, ``--dp_rank``, a
              gloo group over CUDA tensors on the one card: NCCL refuses
              two ranks on one device) train 64 lanes each of every global
              batch of 128 (DP_T = 800 padded frames, seeded; rank 0 holds
              an example CTC cannot align, rank 1 a fill lane), against one
              process training the 128 lanes at once. In f32, without
              noise, after the first update: the applied gradient's and
              the parameters' worst ||dp - one|| / ||one|| within
              TOL["dp_step"], and the naive recipe's gradient (each rank's
              mean, the ranks' means averaged) beyond it; the ranks'
              parameters equal bit for bit after 3 steps. Then the bf16
              recipe's step, its gradients' all-reduce (bytes and GB/s)
              and the peak memory, at world size 1 (one process, 64 lanes)
              and 2 (each rank), and the losses;
23. train_mwer — (run after train_joint) MWER sequence training of
              joint_ctc_att_multihost at its full width (B = 64): 10 steps
              of ``cli train`` from train_joint's trained checkpoint
              (``pretrained_dir``) on a copy of train_las's prepared data,
              with ``mwer = true`` (beam 4, CE weight 0.01), ``ema_decay =
              0.999`` and a profiler window over steps 3-4: each step's
              MWER loss, expected and oracle errors, the share of
              utterances whose N-best holds more than one error count, its
              time split (search, encoder passes, re-scoring, loss,
              backward) and launches (the search pass's inference walks,
              the gradient pass's training kernels and the CTC kernels);
              the first batch's MWER loss and gradients at train_joint's
              weights through the kernels against the plain versions fed
              the same N-best, in f32 at train_joint's tolerances (bf16
              reported; a planted fault, each hypothesis scored against
              another utterance's reference; the eos term left out of each
              score reported), ``best/`` holding the average and the
              last step's raw weights, the profiler's Chrome trace naming
              the training kernels, then ``cli test``;
20. bench_conformer_rnnt, 21. bench_moe_conformer — the bench's
              ``conformer_rnnt`` and ``moe_conformer`` lines (B = 32, T =
              1000, L = 100), their launches checked, and each encoder's
              forward FLOPs and a training step's bound (3 x, at the bf16
              tensor-core rate).

Each of serve, serve_rnnt, serve_las and serve_joint ends with an
LM-fused pass (``lm_fused_pass``): a 3-gram trained with the port's
``NgramLM.train`` on the phase's seeded text (sentences of the recipe's
alphabet) fused at lm_weight 0.3 into the phase's beam (ctc_beam,
transducer_beam, attention_beam, joint_ctc_att_beam; nbest 8): the
phase's first batch served unfused and fused (the RTF of each; the same
kernel launches), the fused search's 8-best over the ATT_CHECK_UTTS (4)
shortest utterances on the card against the CPU in float64 (identical, scores
within 1e-6), and the planted stale LM context (``DenseLM.step``
returning the parent context), which that check must reject. Then the
same with an RNN LM: ``RnnLM.train`` on the card at the JAX defaults (1 x
256 LSTM, embed 64, batch 64, 500 Adam steps) on the same text, its
training launches read, one batch's gradients through the kernels held
to the plain versions' (worst parameter 1e-4 relative, with the planted
``lstm_dwh_h_late``), the float64 check with the LM moved to float64
and the planted stale state (``DenseRnnLM.step`` returning the parent
state). The unfused and fused batches are served in turns (unfused,
fused, fused, unfused). serve also serves its first batch through a copy
of the artifact with ``frontend_dft_dtype = bf16`` (the RTF beside the
f32 batch's in turns, the texts that differ, the ``stft_mel_bf16``
launch). The pipeline phase adds ``cli lm``, ``cli decode`` with the LM,
``cli rescore``, an export carrying the LM and ``cli serve`` over it,
whose lines must be the fused decode's best; then ``cli lm --type rnn``
(on the card), ``cli rescore`` with it over the decode's n-best twice
(more lines than one walk group; each line's score equal to its score
alone, bit for bit), ``cli decode`` with it, an export carrying it and
``cli serve`` over that export.

The kernels phase also holds the four RNN-T kernels (joint forward,
alpha, beta, joint backward) to their plain versions at B = 32, T' = 250,
U = 120, J = 320, V = 29, checks that the loss's forward plus backward
adds under 100 MB of device memory there and under 400 MB at the
streaming recipe's T' = 1000 (no subsampling), and holds the LSTM
kernels (projection, walk with a carry, training walk, chain, dwh) to
their plain versions at the encoder's T = 1024 and the prediction net's
T = 121, B = 32, H = 320, and the v1 BLSTM kernels (inference walk,
training walk, gates recompute, chain, dwh) at las_large's bottom layer
(T = 1024, D = 80) and pyramid_0 (T = 512, D = 2048), B = 64, H = 512.
Each bf16 GEMM row (blstm_proj, dx, dwx + db, dwh, the v1 gates recompute
and dwh, lstm_proj) also reports the kernel its shape took (``wgmma``:
TMA + wgmma, or the earlier ``wmma``), its K slices, its TFLOP/s and the
earlier WMMA kernel's time on the same inputs; the weight gradients (split
K) launch twice and must repeat bit for bit. Each f32 GEMM row (the same
wrappers in f32, ``lstm_bwd_dwh``) reports its K slices (``split_k_f32``)
and TFLOP/s, its kind-2 rows (held to the float64 product) repeating their
bits likewise; further f32
rows (blstm_proj, dx, dwx + db, dwh) run at the layers of the two f32
recipes, ctc_blstm_timit (H = 128, D = 40 and 256) and las_timit's
Listener (H = 256, D = 40 and 1024), B = 32. Every serving and training
phase prints its GEMM launches by kernel, and the WMMA kernel must not
launch in any of them. The stft_mel row reports its GFLOP/s and its
share of the bound beside the rfft path's time, and how far it and the
plain version land from the float64 spectrum; the stft_mel_bf16 row (the
bf16 mode on the same frames) its TFLOP/s and share of the bound, the
f32 kernel's time, how far it and its plain version land from the
float64 product of the same bf16 operands, and how far the mode's
features lie from the f32 mode's. The LSTM kernels are held again at the
RNN LM's shapes (f32, H = 256, B = 64 sentences of the LM text, T their
packed width), each with its planted fault; each v1 chain row
its µs a step, its split (``chain_plan``) and whether a second launch
repeats its bits (a row whose bits differ fails the run), the bf16 rows
also the µs a step at twice the rows a block; the v2 chain's rows
likewise (``ops.blstm.chain_plan``), the bf16 row the µs a step of every
form of its plan's work a block (``us_per_step_by_split``) and whether
their bits equal the plan's. The v2 walk's rows (``blstm_recur``,
``blstm_recur_train``, both types) print the same for ``ops.blstm.walk_plan``
and a second planted fault, one whole unit group of the plan reading h one
step late; the training rows also their step probe (``step_probe``: a
step's cycles split into waiting at the counter, pulling h, the product
and the cell, from a build of the walk that only the probe launches). The
LSTM walk's rows (``lstm_fwd``, ``lstm_fwd_train``, both types, T = 1024
and 121) print the same for ``ops.lstm.walk_plan`` and its step probe
(``ops.lstm.lstm_fwd_train_probe``), its planted group fault a whole unit
group of the plan past the first 8 units; the stream's own shape, a
32-frame chunk with a carry at B = 32 and B = 1, gets a row of its own.
The v1 walk's rows (``blstm_v1_recur``, ``blstm_v1_recur_train``, both
types, T = 1024 and 512) print the same for ``ops.blstm_v1.walk_plan``
(one plan an element type) and its step probe
(``ops.blstm_v1.blstm_v1_recur_train_probe``), its planted group fault
the plan's second unit group. The CTC rows (``ctc_alpha``, ``ctc_beta``)
print their plan (``ops.ctc_batched.ctc_plan``), µs a step, a second
timed run, whether a second launch and every form of the plan give the
same bits (``us_per_step_by_form``), the step probe
(``ops.ctc_batched.ctc_alpha_probe`` / ``ctc_beta_probe``), how many
floats of [1, 4) the kernels' logarithm maps to other bits than
``logf`` (``log_mismatches``, which must be 0), and a second planted
fault, the emission at each chunk's first frame taken from the frame
walked before it (``chunk_fault_max_abs_err``). The ``rnnt_joint_fwd``
row prints whether a second launch repeats its bits, how many of the
65536 bf16 inputs its table tanh maps to other bits than bf16(tanhf)
(``tanh_mismatches``, which must be 0) and its probe (a frame's cycles
split into forming h, the product, the log-softmax and the stores, from
``ops.transducer_fused.rnnt_joint_fwd_probe``); the ``rnnt_beta`` row its
plan (``ops.transducer_fused.beta_plan``), µs a frame, a second timed
run, whether a second launch and every form give the same bits
(``us_per_frame_by_form``), its step probe (``rnnt_beta_probe``) and how
many floats of [0, 1] its log1p maps to other bits than ``log1pf``
(``log1p_mismatches``, which must be 0); the ``rnnt_alpha`` row its plan
(``ops.transducer_fused.alpha_plan``), µs a diagonal step, a second timed
run, whether a second launch and every form give the same bits
(``us_per_step_by_form``), whether the frozen rows and the lanes past
U_b hold row T_b - 1 and NEG exactly (``layout_exact``), its step probe
(``rnnt_alpha_probe``), the kernel's and the plain version's ll against
the plain version in float64 (``ll_vs_float64``, a reading), and a
second planted fault, the anti-diagonal walk with the lane below read
one diagonal late (``fault_neighbour_late_max_abs_err``). The
``rnnt_widths`` line holds all three again at the bench line's V = 32
(no padded vocabulary column), at U + 1 = 101, 31 and 61: the joint
forward, alpha and beta's plan within their tolerances, every alpha form
against the plan's bits and every beta form bit for bit against the
plain version, each form's µs a step (alpha) or a frame (beta).

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. A failed tolerance check is
reported by its phase, which finishes its readings; the run then fails
at the end. Any other failed check fails the run at once. Either way it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RECIPE = os.path.join(REPO, "config", "recipes", "dblstm_ctc_wsj")
RNNT_RECIPE = os.path.join(REPO, "config", "recipes", "rnnt_char_wsj")
STREAM_RECIPE = os.path.join(REPO, "config", "recipes", "rnnt_streaming_wsj")
LAS_RECIPE = os.path.join(REPO, "config", "recipes", "las_large_wsj")
JOINT_RECIPE = os.path.join(REPO, "config", "recipes", "joint_ctc_att_multihost")
CONFORMER_RNNT_RECIPE = os.path.join(REPO, "config", "recipes", "conformer_rnnt_wsj")
CONFORMER_AED_RECIPE = os.path.join(REPO, "config", "recipes", "conformer_aed_wsj")

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# special-function units (tanh, exp, log): 16 results a clock per SM
# (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost clock
PEAK_SFU = 16 * 132 * 1.98e9
# shared-memory reads: one 32-lane request a clock per SM (128 bytes a
# clock), x 132 SMs x 1.98 GHz; the joint forward's tanh is one such read
# a node and joint unit
PEAK_SMEM_READS = 32 * 132 * 1.98e9

# serving shapes of the 4x320 recipe at batch 32
B, T, H, NFILT = 32, 1024, 320, 40
W, K = 400, 256

# tolerances (max |kernel - plain| <= atol + rtol * |plain|). Each lies
# between the sound reading and the reading of a planted fault, both
# printed by every run (PERF.md records them):
# - stft_mel, log-mel f32: both sides f32, summation orders differ over
#   W = 400 products (sound: about one f32 step of the log); fault: the
#   last tap of W dropped
# - stft_mel_bf16: the same exact bf16 products summed in f32 on both
#   sides, the tensor cores' order against cuBLAS's (the f32 mode's 1e-4
#   holds only for the same order); in near-silent bands the log amplifies
#   the f32 rounding of a sum that cancels to ~1e-5 of its terms: each side
#   lands up to ~8e-5 from the float64 product of the same bf16 operands
#   (both distances printed), so the two may lie up to their sum apart
#   (sound 1.2e-4 at the serving shape, H100); fault: the last tap dropped
#   (10.9)
# - blstm_proj, blstm_bwd_dx: bf16 outputs may land one bf16 rounding
#   step apart when the f32 sums differ in their last bits (and the bias
#   add after the cast keeps that step where the sum is smaller); fault:
#   the last product of the reduction dropped
# - blstm_bwd_dwx / db / dwh: f32 sums over T x B = 32768 tokens in
#   another order (the bf16 products' sums reach ~100, where f32 keeps
#   ~1e-5 of them); in f32 the kernel is held to the float64 product,
#   since the plain version, one f32 sum over such a K in cuBLAS's order,
#   lands up to ~3e-3 from it, and the kernel's split sums in another
#   order (each row also prints that f32 product's distance from float64);
#   fault: the last token's term dropped, the plain version's
# - blstm_recur, blstm_recur_train: over 1024 dependent steps such
#   one-step differences in the bf16 carry propagate; f32 stays tight;
#   fault: 8 hidden units read h one step late (a missed barrier or
#   fence)
# - blstm_recur_train's f32 stores of c and the pre-activation gates,
#   computed from the carried h (sound: f32 sums over h that may differ
#   by such a step); faults: c stored one step late, gates stored with the
#   forget bias folded in
# - blstm_bwd_recur: the same propagation through the bf16 dgates
#   (relative to the largest dgate); fault: the dgates of 8 units read one
#   step stale
# - ctc_alpha (log-likelihood, f32 over T = 1000 steps) and ctc_beta
#   (posteriors in [0, 1]); faults: the skip transition dropped, and the
#   emission at each chunk's first frame the one of the frame walked just
#   before (a stale buffer at the chunk hand-off)
# - features, logits: the serving path with the kernels against the same
#   path through the plain versions; features fault as above, logits
#   fault the carry not held past a length
# - train_grads (||kernel - plain|| / ||plain|| per parameter, the
#   largest over parameters, one full-width bf16 batch): bf16 rounding of
#   h and dgates differs between the two paths; fault: the bw direction's
#   dx left out of the sum over directions. The chain's stale exchange is
#   read too but not required to fail here: its trace in the gradients is
#   below the bf16 noise (PERF.md); the chain check above is its guard
# - lstm_proj: as blstm_proj
# - lstm_fwd, lstm_fwd_train: the walk is f32 on both sides (the same
#   bf16 or f32 inputs), so only the f32 sums' order differs; the masked
#   h is written in the input type, where such a difference may move a
#   bf16 output by one rounding step (0.0039 at |h| < 1); the final carry
#   and the f32 stores (gates, c, h) stay tight; faults: 8 units read h
#   one step late, the second unit group of the walk's plan read h one
#   step late, the carry not held past a length (final carry)
# - lstm_bwd_recur: f32 dgates from the same residuals (sums in another
#   order); fault: the dgates of 8 units read one step stale
# - lstm_bwd_dwh: f32 sums over T x B tokens, held to the float64 product
#   as above; fault: the last token's term dropped
# - stream_scores: streamed and offline greedy scores, the same bits
#   expected (identical arithmetic per frame)
# - blstm_v1_recur(_train): as blstm_recur (the same cell; over 1024
#   dependent steps one-step bf16 differences of the carry propagate);
#   its stores: h as the output, c as blstm_recur_train's c; faults: 8
#   units read h one step late, c and h stored one step late
# - blstm_v1_bwd_gates: f32 sums of the same bf16 (or f32) products over
#   K = 512 in another order; fault: the last of the H products dropped
# - blstm_v1_bwd_recur: as blstm_bwd_recur; fault: the dgates of 8 units
#   one step stale
# - blstm_v1_bwd_dwh: as blstm_bwd_dwh; fault: the last token's term
#   dropped
# - train_las gradients: the Listener's parameters as train_grads; the
#   Speller's (bf16, no kernel) at train_grads_speller: its attention
#   biases' gradients are sums of many cancelling bf16 terms, which one
#   bf16 step in the Listener's output moves by up to ~4% (0.038 seen at B
#   = 64, T = 1072); fault: the v1 layers' dwh with the two directions'
#   carries swapped (the GEMM's operand pairs exchanged); reported, not
#   required: dwh paired with h one step late (adjacent carries are close,
#   so its trace is ~2%)
TOL = {
    "stft_mel": (1e-4, 0.0),
    "stft_mel_bf16": (2.5e-4, 0.0),
    "rnn_lm_grads": 1e-4,
    ("blstm_proj", "bf16"): (1e-2, 1e-2),
    ("blstm_proj", "f32"): (1e-4, 1e-5),
    ("blstm_recur", "bf16"): (4e-2, 0.0),
    ("blstm_recur", "f32"): (1e-4, 0.0),
    ("blstm_recur_train", "bf16"): (4e-2, 0.0),
    ("blstm_recur_train", "f32"): (1e-4, 0.0),
    ("blstm_recur_train_stores", "bf16"): (1e-2, 0.0),
    ("blstm_recur_train_stores", "f32"): (1e-4, 0.0),
    ("blstm_bwd_recur", "bf16"): (2e-2, 0.0),
    ("blstm_bwd_recur", "f32"): (1e-4, 0.0),
    ("blstm_bwd_dx", "bf16"): (1e-2, 1e-2),
    ("blstm_bwd_dx", "f32"): (1e-4, 1e-5),
    ("blstm_bwd_dw", "bf16"): (1e-2, 1e-3),
    ("blstm_bwd_dw", "f32"): (1e-3, 1e-4),
    "ctc_ll": (1e-3, 1e-5),
    "ctc_posts": (1e-4, 0.0),
    "rnnt_lp": (1e-4, 1e-5),
    "rnnt_ll": (1e-3, 1e-5),
    "rnnt_occ": (1e-4, 0.0),
    "rnnt_grad": (1e-3, 1e-3),
    "rnnt_scores": 1e-6,
    "features": (1e-4, 0.0),
    "logits_bf16": (0.03, 0.0),
    "train_loss": (1e-2, 1e-3),
    "train_grads": 0.02,
    "train_grads_speller": 0.1,
    # cli align's Viterbi on the card against the CPU over the same f32
    # log-probs: the same additions in the same order (frame labels
    # identical), path scores within this; each path score at most the
    # CTC log-likelihood of ctc_alpha on the same log-probs, within this
    # relative slack (f32 sums over ~1000 frames)
    "align_scores": 1e-5,
    "align_ll_rel": 1e-5,
    # the transformer decoder's cached step chain against its parallel
    # apply: max |step - apply| over max |apply|, bf16 (the served dtype)
    # and f32
    "aed_cache_bf16": 5e-2,
    "aed_cache_f32": 1e-4,
    # train_dp, f32: the two ranks' first update against one process on
    # their batches concatenated, worst parameter ||dp - one|| / ||one||
    # of the applied gradient and of the parameters after it
    "dp_step": 1e-4,
    ("lstm_proj", "bf16"): (1e-2, 1e-2),
    ("lstm_proj", "f32"): (1e-4, 1e-5),
    ("lstm_fwd", "bf16"): (1e-2, 0.0),
    ("lstm_fwd", "f32"): (1e-4, 0.0),
    "lstm_carry": (1e-4, 0.0),
    "lstm_stores": (1e-4, 1e-5),
    "lstm_bwd_recur": (1e-4, 1e-4),
    "lstm_bwd_dwh": (1e-3, 1e-4),
    "stream_scores": 1e-4,
    ("blstm_v1_recur", "bf16"): (4e-2, 0.0),
    ("blstm_v1_recur", "f32"): (1e-4, 0.0),
    ("blstm_v1_stores", "bf16"): (1e-2, 0.0),
    ("blstm_v1_stores", "f32"): (1e-4, 0.0),
    ("blstm_v1_bwd_gates", "bf16"): (1e-4, 1e-4),
    ("blstm_v1_bwd_gates", "f32"): (1e-4, 1e-4),
    ("blstm_v1_bwd_recur", "bf16"): (2e-2, 0.0),
    ("blstm_v1_bwd_recur", "f32"): (1e-4, 0.0),
    ("blstm_v1_bwd_dwh", "bf16"): (1e-2, 1e-3),
    ("blstm_v1_bwd_dwh", "f32"): (1e-3, 1e-4),
}
# the RNN-T loss's extra peak device memory: 100 MB at T' = 250 (the
# Listener's time / 4); every buffer of the loss is per frame, so the limit
# scales with T': 400 MB at the streaming recipe's T' = 1000 (a
# materialized joint's h alone would be 2.5 GB there)
RNNT_LOSS_LIMIT = {250: 100e6, 1000: 400e6}

_BLSTM_FWD = "nabu_tpu/ops/pallas/blstm.py:867"
_BLSTM_BWD = "nabu_tpu/ops/pallas/blstm.py:952"
TPU_KERNELS = {
    "stft_mel": "nabu_tpu/ops/pallas/stft_mel.py:78",
    # the kernel's dft_dtype = bf16 mode (its default)
    "stft_mel_bf16": "nabu_tpu/ops/pallas/stft_mel.py:78",
    "blstm_proj": _BLSTM_FWD,
    "blstm_recur": _BLSTM_FWD,
    "blstm_recur_train": _BLSTM_FWD,
    "blstm_bwd_recur": _BLSTM_BWD,
    "blstm_bwd_dx": _BLSTM_BWD,
    "blstm_bwd_dwx": _BLSTM_BWD,
    "blstm_bwd_dwh": _BLSTM_BWD,
    "ctc_alpha": "nabu_tpu/ops/pallas/ctc_batched.py:67",
    "ctc_beta": "nabu_tpu/ops/pallas/ctc_batched.py:115",
    "rnnt_joint_fwd": "nabu_tpu/ops/pallas/transducer.py:124",
    "rnnt_alpha": "nabu_tpu/ops/pallas/transducer.py:124",
    "rnnt_beta": "nabu_tpu/ops/pallas/transducer.py:193",
    "rnnt_joint_bwd": "nabu_tpu/ops/pallas/transducer.py:193",
    # lstm_scan_pallas's x @ wx + b, outside the Pallas kernel (XLA)
    "lstm_proj": "nabu_tpu/ops/pallas/lstm.py:292",
    "lstm_fwd": "nabu_tpu/ops/pallas/lstm.py:173",
    "lstm_fwd_train": "nabu_tpu/ops/pallas/lstm.py:173",
    "lstm_bwd_recur": "nabu_tpu/ops/pallas/lstm.py:213",
    "lstm_bwd_dwh": "nabu_tpu/ops/pallas/lstm.py:213",
    # rows 4-6, the v1 family
    "blstm_v1_recur": "nabu_tpu/ops/pallas/blstm.py:123",
    "blstm_v1_recur_train": "nabu_tpu/ops/pallas/blstm.py:388",
    "blstm_v1_bwd_gates": "nabu_tpu/ops/pallas/blstm.py:463",
    "blstm_v1_bwd_recur": "nabu_tpu/ops/pallas/blstm.py:463",
    "blstm_v1_bwd_dwh": "nabu_tpu/ops/pallas/blstm.py:463",
}
SOURCES = {name: "nabu_tpu_torch/ops/kernels/csrc/blstm.cu" for name in TPU_KERNELS}
SOURCES["stft_mel"] = SOURCES["stft_mel_bf16"] = "nabu_tpu_torch/ops/kernels/csrc/stft_mel.cu"
SOURCES["ctc_alpha"] = SOURCES["ctc_beta"] = "nabu_tpu_torch/ops/kernels/csrc/ctc.cu"
for _name in ("rnnt_joint_fwd", "rnnt_alpha", "rnnt_beta", "rnnt_joint_bwd"):
    SOURCES[_name] = "nabu_tpu_torch/ops/kernels/csrc/transducer.cu"
for _name in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd_recur"):
    SOURCES[_name] = "nabu_tpu_torch/ops/kernels/csrc/lstm.cu"
for _name in ("blstm_v1_recur", "blstm_v1_recur_train", "blstm_v1_bwd_recur"):
    SOURCES[_name] = "nabu_tpu_torch/ops/kernels/csrc/blstm_v1.cu"

# the kernels each path launches, and per training step of each training
# phase: the 4-layer DBLSTM-CTC recipe (layer 0's input, the features,
# needs no gradient: no dx there), the RNN-T recipe's Listener of 3 BLSTM
# layers plus the prediction net's LSTM walk, chain and dwh and one of each
# RNN-T kernel, and the streaming recipe's 4 forward-only layers plus the
# prediction net (5 walks, chains and dwh; the training projections are
# autograd matmuls, as XLA's in JAX)
SERVE_KERNELS = ("stft_mel", "blstm_proj", "blstm_recur")
STREAM_SERVE_KERNELS = ("stft_mel", "lstm_proj", "lstm_fwd")
_RNNT_STEP = {"rnnt_joint_fwd": 1, "rnnt_alpha": 1, "rnnt_beta": 1, "rnnt_joint_bwd": 1}
STEP_LAUNCHES = {
    "train": {"blstm_proj": 4, "blstm_recur_train": 4, "blstm_bwd_recur": 4,
              "blstm_bwd_dx": 3, "blstm_bwd_dwx": 4, "blstm_bwd_dwh": 4, "ctc_alpha": 1,
              "ctc_beta": 1},
    "train_rnnt": {"blstm_proj": 3, "blstm_recur_train": 3, "blstm_bwd_recur": 3,
                   "blstm_bwd_dx": 2, "blstm_bwd_dwx": 3, "blstm_bwd_dwh": 3,
                   "lstm_fwd_train": 1, "lstm_bwd_recur": 1, "lstm_bwd_dwh": 1, **_RNNT_STEP},
    "train_rnnt_stream": {"lstm_fwd_train": 5, "lstm_bwd_recur": 5, "lstm_bwd_dwh": 5,
                          **_RNNT_STEP},
    # las_large's 5 Listener layers on the v1 family (the bottom layer's
    # input, the features, needs no dx)
    "train_las": {"blstm_proj": 5, "blstm_v1_recur_train": 5, "blstm_v1_bwd_gates": 5,
                  "blstm_v1_bwd_recur": 5, "blstm_v1_bwd_dwh": 5, "blstm_bwd_dx": 4,
                  "blstm_bwd_dwx": 5},
    # joint_ctc_att_multihost's 4 Listener layers (bottom + 3 pyramid) at B =
    # 64 on v1, and the CTC head's loss
    "train_joint": {"blstm_proj": 4, "blstm_v1_recur_train": 4, "blstm_v1_bwd_gates": 4,
                    "blstm_v1_bwd_recur": 4, "blstm_v1_bwd_dwh": 4, "blstm_bwd_dx": 3,
                    "blstm_bwd_dwx": 4, "ctc_alpha": 1, "ctc_beta": 1},
    # conformer_rnnt_wsj: the attention encoder launches nothing; the
    # prediction net's LSTM walk, chain and dwh and one of each RNN-T kernel
    "train_conformer_rnnt": {"lstm_fwd_train": 1, "lstm_bwd_recur": 1, "lstm_bwd_dwh": 1,
                             **_RNNT_STEP},
    "bench_conformer_rnnt": {"lstm_fwd_train": 1, "lstm_bwd_recur": 1, "lstm_bwd_dwh": 1,
                             **_RNNT_STEP},
    # the bench's moe_conformer line: the CTC loss only
    "bench_moe_conformer": {"ctc_alpha": 1, "ctc_beta": 1},
    # the bench's las line: 5 Listener layers (bottom + 4 pyramid) of 512
    # units at B = 32 on v2, and the CTC head's loss
    "bench_las": {"blstm_proj": 5, "blstm_recur_train": 5, "blstm_bwd_recur": 5,
                  "blstm_bwd_dx": 4, "blstm_bwd_dwx": 5, "blstm_bwd_dwh": 5, "ctc_alpha": 1,
                  "ctc_beta": 1},
}
# the v1 inference walk's decode: the projection and the walk of each layer
LAS_DECODE_KERNELS = ("blstm_proj", "blstm_v1_recur")
# the pipeline phase: cli test / decode / recognize run the v2 inference
# path (recognize also the device frontend), serve the frontend too
DECODE_KERNELS = ("blstm_proj", "blstm_recur")
PIPELINE_KERNELS = {"test": DECODE_KERNELS, "decode": DECODE_KERNELS,
                    "serve": SERVE_KERNELS, "recognize": SERVE_KERNELS,
                    "decode_lm": DECODE_KERNELS, "serve_lm": SERVE_KERNELS,
                    # forced alignment: the CTC head's log-probs, no loss kernel
                    "align": DECODE_KERNELS,
                    # the neural LM: trained on the card (the three training
                    # kernels), its perplexity and rescoring scored by the
                    # projection and the walk; fused, a plain cell a step
                    "lm_rnn": ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh",
                               "lstm_proj", "lstm_fwd"),
                    "rescore_rnn": ("lstm_proj", "lstm_fwd"),
                    "decode_rnn": DECODE_KERNELS, "serve_rnn": SERVE_KERNELS}
# utterances of the dev split that cli serve and cli recognize decode
PIPELINE_UTTS = 8
TRAIN_RECIPES = {"train": RECIPE, "train_rnnt": RNNT_RECIPE, "train_rnnt_stream": STREAM_RECIPE,
                 "train_las": LAS_RECIPE, "train_joint": JOINT_RECIPE,
                 "train_conformer_rnnt": CONFORMER_RNNT_RECIPE}
# the attention serve phases: (recipe, seed, recognizer, the kernels'
# launches a served batch, utterances); each recipe's recognizer.cfg has
# beam 16, nbest 8; the conformer's serving launches only the frontend
_V2 = {"stft_mel": 1, "blstm_proj": 1, "blstm_recur": 1}
ATT_SERVE = {
    "serve_las": (LAS_RECIPE, 11, "AttentionBeamRecognizer", {**_V2, "blstm_proj": 5,
                                                              "blstm_recur": 5}, 32),
    "serve_joint": (JOINT_RECIPE, 13, "JointCTCAttBeamRecognizer", {**_V2, "blstm_proj": 4,
                                                                    "blstm_recur": 4}, 32),
    "serve_conformer_aed": (CONFORMER_AED_RECIPE, 17, "JointCTCAttBeamRecognizer",
                            {"stft_mel": 1}, 32),
}
# the shortest served utterances whose search runs on the card and the CPU
# (8 before train_dp took its time)
ATT_CHECK_UTTS = 4
# the serve phases' LM-fused passes: a 3-gram at this weight, trained on
# this many seeded sentences of the recipe's alphabet
LM_WEIGHT = 0.3
LM_SENTENCES = 400
LM_ATT_PHASES = ("serve_las", "serve_joint")
TRAIN_STEPS = 40
# phases of another length: train_joint's and train_conformer_rnnt's 20
# steps (at 10 the latter's planted dwh fault read 0.014, under its 0.02)
PHASE_STEPS = {"train_joint": 20, "train_conformer_rnnt": 20}
TRAIN_UTTS = 256
# the utterances serve_stream serves
STREAM_UTTS = 32
# las_large: the first 96 utterances of the corpus, x3 after its speed
# perturbation
LAS_TRAIN_UTTS = 96
# the v1 kernel rows: las_large's Listener at B = 64, H = 512, bottom layer
# and pyramid_0 (T, D)
V1_B, V1_H = 64, 512
V1_SHAPES = (("bottom", 1024, 2 * 40), ("pyramid_0", 512, 4 * 512))
# the f32 GEMM rows of the two f32 recipes' BLSTM layers, B = 32, (recipe,
# T, H, D): ctc_blstm_timit (BASELINE config 1: 2 x 128 on fbank 40
# without deltas, then 2H) and las_timit's Listener (3 x 256: the bottom
# layer on fbank 40, pyramid_0 on stacked pairs, 4H, at half the frames)
F32_RECIPE_SHAPES = (("ctc_blstm_timit", 1024, 128, 40), ("ctc_blstm_timit", 1024, 128, 256),
                     ("las_timit", 1024, 256, 40), ("las_timit", 512, 256, 1024))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# tolerance checks of the current phase that failed: the phase prints all
# its readings first, then fails
FAILURES: list = []


def raise_failures() -> None:
    if FAILURES:
        raise CheckFailed("; ".join(FAILURES))


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def excess(got, ref, tol):
    """-> (max |got - ref|, max of |got - ref| - (atol + rtol |ref|))."""
    atol, rtol = tol
    got = got.float()
    ref = ref.float()
    err = (got - ref).abs()
    return float(err.max()), float((err - (atol + rtol * ref.abs())).max())


def compare(torch, got, ref, tol, what: str) -> float:
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    max_err, over = excess(got, ref, tol)
    if over > 0.0:
        FAILURES.append(f"{what}: max |err| {max_err} beyond tolerance {tol}")
    return max_err


def fault_reading(faulty, ref, tol, what: str) -> float:
    """The reading of a planted fault, which the tolerance must reject."""
    max_err, over = excess(faulty, ref, tol)
    if not over > 0.0:
        FAILURES.append(
            f"{what}: a planted fault (max |err| {max_err}) passes tolerance {tol}")
    return max_err


def bound(bytes_, ops, peak_ops, *more):
    """-> (least ms, what sets it): the bytes over the memory rate against
    each (operations, peak rate) pair, the units running side by side."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = max(o / p for o, p in ((ops, peak_ops), *more)) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def gemm_fields(torch, timed, reps, fn, kind, M, N, K, ops, ms, repeat=False) -> dict:
    """The bf16 GEMM row's extra readings: the kernel its launch took
    (``gemm_variant``), its K slices (``split_k``), its TFLOP/s, the time
    of the earlier WMMA kernel on the same inputs, and for kind 2 (split
    K) whether a second launch gives the first one's bits."""
    from nabu_tpu_torch.ops import blstm as bo
    from nabu_tpu_torch.ops import kernels

    before = kernels.variant_counts()
    first = fn()
    ran = [v for v, n in kernels.variant_counts().items() if n > before[v]]
    check(len(ran) == 1, f"a bf16 GEMM row launched {ran}")
    variant = ran[0].rsplit("_", 1)[1]
    fields = {"variant": variant,
              "splits": bo.split_k(kind, M, N, K, 2) if variant == "wgmma" else 1,
              "tflops": None if ms is None else ops / ms / 1e9}
    with swapped(bo, "gemm_variant", lambda lda, ldb, ptrs: "wmma"):
        fields["wmma_ms"] = timed(fn, reps)
    if repeat:
        second = fn()
        pairs = zip(first, second) if isinstance(first, tuple) else ((first, second),)
        same = all(torch.equal(x, y) for x, y in pairs)
        fields["repeat_bits_equal"] = same
        if not same:
            FAILURES.append(f"kind {kind} GEMM M={M} N={N} K={K}: a second launch's bits differ")
    return fields


def f32_gemm_fields(torch, fn, kind, M, N, K, dirs, ops, ms, exact=None, library=None) -> dict:
    """The f32 GEMM row's extra readings: its K slices (``split_k_f32``),
    its TFLOP/s, and for kind 2 (split K) whether a second launch gives
    the first one's bits (a row whose bits differ fails the run) and, with
    ``exact`` (the product in float64, the row's reference), how far one
    f32 library call (a sum over K in its own order) lands from it."""
    from nabu_tpu_torch.ops import blstm as bo

    fields = {"splits": bo.split_k_f32(kind, M, N, K, dirs),
              "tflops": None if ms is None else ops / ms / 1e9}
    if kind == 2:
        first, second = fn(), fn()
        pairs = zip(first, second) if isinstance(first, tuple) else ((first, second),)
        same = all(torch.equal(x, y) for x, y in pairs)
        fields["repeat_bits_equal"] = same
        if not same:
            FAILURES.append(f"f32 kind 2 GEMM M={M} N={N} K={K}: a second launch's bits differ")
        if exact is not None:
            fields["library_f64_max_abs_err"] = float((library().double() - exact).abs().max())
    return fields


def gemm_variants(phase: str) -> dict:
    """The bf16 GEMM launches of the run just read, by kernel, as a line;
    the earlier WMMA kernel must not run on a recipe's path."""
    from nabu_tpu_torch.ops import kernels

    counts = kernels.variant_counts()
    emit({"phase": phase, "gemm_variants": counts})
    check(counts["gemm_bf16_wmma"] == 0,
          f"{phase}: {counts['gemm_bf16_wmma']} launches of the WMMA GEMM")
    return counts


def walk_fields(torch, timed, reps, fn, first, ms, ops, Tq=T, Bq=B, Hq=H, tag=None) -> dict:
    """A walk row's extra readings (Tq steps, Bq rows, Hq units) for the
    v2 walk (``ops`` = ``ops.blstm``), the v1 walk (``ops.blstm_v1``,
    whose plan also takes the element type ``tag``) or the LSTM walk
    (``ops.lstm``): the
    split it ran (``ops.walk_plan``), whether a second launch gives the
    first one's bits, its µs a step and, timed, the µs a step of every
    form of the walk whose blocks fit the card (``ops.walk_plan`` of that
    form alone; ``us_per_step_by_split``), the same launch each, with
    whether their bits equal the plan's (a differing second launch or form
    fails the run)."""
    def flat(out):
        out = out if isinstance(out, tuple) else (out,)
        return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))

    repeat = same(first, fn())
    if not repeat:
        FAILURES.append(f"{fn.__name__} T={Tq} B={Bq}: a second launch's bits differ")
    shape = (Bq, Hq) if tag is None else (Bq, Hq, tag)
    fields = {"plan": ops.walk_plan(*shape), "repeat_bits_equal": repeat,
              "us_per_step": None if ms is None else 1e3 * ms / Tq}
    if reps:
        by_split, bits = {}, True
        for units, mt in ops.WALK_FORMS:
            plan = ops.walk_plan(*shape, ((units, mt),))
            if plan is None:
                continue
            with swapped(ops, "walk_plan", lambda *_, f=plan: f):
                by_split[f"{16 * mt}x{units}"] = 1e3 * timed(fn, reps) / Tq
                bits &= same(first, fn())
        fields["us_per_step_by_split"] = by_split
        fields["bits_equal_across_splits"] = bits
        if not bits:
            FAILURES.append(f"{fn.__name__} T={Tq} B={Bq}: the forms' bits differ")
    return fields


def walk_probe(torch, timed, reps, probe, Tq, counted) -> dict:
    """The step probe of a training walk: ``probe()`` launches its build
    that sums each block's clock64 cycles of the ``counted`` steps by part
    (``ops.blstm.PROBE_PARTS``: waiting at the group's counter, pulling
    h_{t-1}, the product to its gates' sums, the cell with its stores).
    -> the mean over blocks a step, each part's share, the probe's own µs
    a step over its Tq steps (CUDA events; it adds two block barriers a
    step) and its parts in µs by those shares."""
    from nabu_tpu_torch.ops.blstm import PROBE_PARTS

    *_, cycles = probe()
    per = (cycles.double().mean(dim=0) / max(counted, 1)).tolist()
    ms = timed(probe, reps)
    us = None if ms is None else 1e3 * ms / Tq
    shares = [c / sum(per) for c in per]
    wait = cycles[:, 0].double() / max(counted, 1)
    return {"cycles_per_step": dict(zip(PROBE_PARTS, per)),
            "share": dict(zip(PROBE_PARTS, shares)),
            "wait_cycles_min_max": [float(wait.min()), float(wait.max())],
            "probe_us_per_step": us,
            "us": None if us is None else {p: f * us for p, f in zip(PROBE_PARTS, shares)}}


def step_probe(torch, timed, reps, probe, parts, steps=None) -> dict:
    """The step probe of a CTC or RNN-T kernel: ``probe()`` launches its
    build that sums one thread's clock64 cycles by part (``parts``: the
    kernel's ``PROBE_PARTS``) and counts that thread's steps (the last
    column: the walks' frames, the joint forward's frames of warp 0). ->
    the mean over the blocks that took a step of the cycles a step, each
    part's share and the probe's own ms a launch (CUDA events); for a
    walk over ``steps`` serial frames, also its µs a frame and its parts
    in µs by those shares (the joint forward has no serial step)."""
    *_, cycles = probe()
    counted = cycles[:, -1].double()
    walked = counted > 0
    per = (cycles[walked, :-1].double() / counted[walked, None]).mean(dim=0).tolist()
    ms = timed(probe, reps)
    shares = [c / sum(per) for c in per]
    out = {"cycles_per_step": dict(zip(parts, per)), "share": dict(zip(parts, shares)),
           "probe_ms": ms}
    if steps:
        us = None if ms is None else 1e3 * ms / steps
        out["probe_us_per_step"] = us
        out["us"] = None if us is None else {p: f * us for p, f in zip(parts, shares)}
    return out


def alpha_forms(torch, timed, reps, tf, args, want, steps) -> tuple:
    """Every form of ``alpha_plan`` that holds the lattice's U + 1 lanes,
    swapped in for the plan, on ``args`` (``rnnt_alpha``'s): -> ({form: µs
    a diagonal step over ``steps``}, whether every form gave ``want``'s
    bits)."""
    U1 = args[0].shape[2]
    by_form, bits = {}, True
    for form in tf.ALPHA_FORMS:
        try:
            plan = tf.alpha_plan(U1, (form,))
        except ValueError:
            continue
        with swapped(tf, "alpha_plan", lambda U1_, forms=None, p=plan: p):
            got = tf.rnnt_alpha(*args)
            bits &= all(torch.equal(x, y) for x, y in zip(got, want))
            # (three times the reps: a form's launch is tens of µs)
            by_form[f"{form[0]}x{form[1]}"] = (
                None if not reps else 1e3 * timed(lambda: tf.rnnt_alpha(*args), 3 * reps) / steps)
    return by_form, bits


def alpha_layout_ok(torch, tf, alphas, logit_lengths, target_lengths) -> bool:
    """The alphas' rows t >= T_b equal row T_b - 1 bit for bit (NEG where
    T_b = 0), and every lane past U_b holds NEG."""
    T, B, U1 = alphas.shape
    dev = alphas.device
    Tb = logit_lengths.long().clamp(0, T)
    past = torch.arange(U1, device=dev)[None, :] > target_lengths.long()[:, None]
    if not bool((alphas[:, past] == tf.NEG).all()):
        return False
    last = alphas[(Tb - 1).clamp(min=0), torch.arange(B, device=dev)]
    last = torch.where((Tb > 0)[:, None], last, tf.NEG)
    frozen = torch.arange(T, device=dev)[:, None] >= Tb[None, :]
    return bool(((alphas == last[None]) | ~frozen[..., None]).all())


# ---------------------------------------------------------------------------
# plain references and planted faults
# ---------------------------------------------------------------------------

# every kernel wrapper the paths call, by module, with its plain version
_WRAPPERS = {
    "stft_mel": ("stft_mel", "stft_mel"),
    "blstm_proj": ("blstm", "blstm_proj"),
    "blstm_recur": ("blstm", "blstm_recur"),
    "blstm_recur_train": ("blstm", "blstm_recur_train"),
    "blstm_bwd_recur": ("blstm", "blstm_bwd_recur"),
    "blstm_bwd_dx": ("blstm", "blstm_bwd_dx"),
    "blstm_bwd_dwx": ("blstm", "blstm_bwd_dwx"),
    "blstm_bwd_dwh": ("blstm", "blstm_bwd_dwh"),
    "ctc_alpha": ("ctc_batched", "ctc_alpha"),
    "ctc_beta": ("ctc_batched", "ctc_beta"),
    "rnnt_joint_fwd": ("transducer_fused", "rnnt_joint_fwd"),
    "rnnt_alpha": ("transducer_fused", "rnnt_alpha"),
    "rnnt_beta": ("transducer_fused", "rnnt_beta"),
    "rnnt_joint_bwd": ("transducer_fused", "rnnt_joint_bwd"),
    "lstm_proj": ("lstm", "lstm_proj"),
    "lstm_fwd": ("lstm", "lstm_fwd"),
    "lstm_fwd_train": ("lstm", "lstm_fwd_train"),
    "lstm_bwd_recur": ("lstm", "lstm_bwd_recur"),
    "lstm_bwd_dwh": ("lstm", "lstm_bwd_dwh"),
    "blstm_v1_recur": ("blstm_v1", "blstm_v1_recur"),
    "blstm_v1_recur_train": ("blstm_v1", "blstm_v1_recur_train"),
    "blstm_v1_bwd_gates": ("blstm_v1", "blstm_v1_bwd_gates"),
    "blstm_v1_bwd_recur": ("blstm_v1", "blstm_v1_bwd_recur"),
    "blstm_v1_bwd_dwh": ("blstm_v1", "blstm_v1_bwd_dwh"),
}


@contextlib.contextmanager
def swapped(mod, name, fn):
    """Temporarily replace a module attribute (a planted fault)."""
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _plain_of(mod, attr):
    """A wrapper's plain version, called as the paths call the wrapper
    (``stft_mel`` also takes the kernel's Mel ranges, which its plain
    version does not read)."""
    plain = getattr(mod, f"{attr}_plain")
    if attr == "stft_mel":
        return lambda frames, cossin, mel, mr: plain(frames, cossin, mel)
    return plain


@contextlib.contextmanager
def plain_versions(**faults):
    """Run the paths through the kernels' plain versions (the reference
    the kernel path is held to), or through a planted fault in place of
    one of them (``faults``: wrapper name -> function), by swapping the
    module attributes the paths call. No kernel may launch meanwhile."""
    import importlib

    from nabu_tpu_torch.ops import kernels

    with contextlib.ExitStack() as stack:
        for name, (modname, attr) in _WRAPPERS.items():
            mod = importlib.import_module(f"nabu_tpu_torch.ops.{modname}")
            fn = faults.get(name) or _plain_of(mod, attr)
            stack.enter_context(swapped(mod, attr, fn))
        before = kernels.launch_counts()
        yield
        check(kernels.launch_counts() == before, "a plain run launched a kernel")


def drop_last_tap(stft_plain):
    """Planted STFT+Mel fault: the last of the W taps is skipped (an
    off-by-one in the loop over the window)."""
    def faulty(frames, cossin, mel, mr):
        cut = cossin.clone()
        cut[-1] = 0.0
        return stft_plain(frames, cut, mel)
    return faulty


def stale_recur(torch, units: int = 8, first: int = 0):
    """Planted recurrence fault: the gates of the ``units`` hidden units
    from ``first`` on read h one step late (h_{t-2}), as the block owning
    them would after passing the step barrier before the others' h was
    visible. Otherwise the plain masked cell."""
    def recur(xw, lengths, wh, forget_bias: float = 1.0):
        _, T, B, H4 = xw.shape
        H = H4 // 4
        dt = xw.dtype
        cols = _unit_cols(torch, H, units, xw.device, first)
        mask = (torch.arange(T, device=xw.device)[:, None]
                < lengths.to(xw.device)[None, :])[..., None]
        y = torch.zeros((T, B, 2 * H), dtype=dt, device=xw.device)
        for d in range(2):
            whf = wh[d].float()
            h = torch.zeros((B, H), dtype=dt, device=xw.device)
            h_late = h
            c = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
            for t in range(T) if d == 0 else range(T - 1, -1, -1):
                gates = xw[d, t].float() + h.float() @ whf
                gates[:, cols] = xw[d, t, :, cols].float() + h_late.float() @ whf[:, cols]
                gi = torch.sigmoid(gates[:, :H])
                gf = torch.sigmoid(gates[:, H: 2 * H] + forget_bias)
                gg = torch.tanh(gates[:, 2 * H: 3 * H])
                go = torch.sigmoid(gates[:, 3 * H:])
                c_new = gf * c + gi * gg
                h_new = (go * torch.tanh(c_new)).to(dt)
                m = mask[t]
                h_late = h
                h = torch.where(m, h_new, h)
                c = torch.where(m, c_new, c)
                y[t, :, d * H: (d + 1) * H] = h * m.to(dt)
        return y
    return recur


def carry_not_held(torch):
    """Planted recurrence fault: the carry is not held past each
    utterance's length, only the output is masked, so the backward walk
    enters every shorter utterance with the padding's state."""
    from nabu_tpu_torch.ops.blstm import blstm_recur_plain

    def recur(xw, lengths, wh, forget_bias: float = 1.0):
        T = xw.shape[1]
        y = blstm_recur_plain(xw, torch.full_like(lengths, T), wh, forget_bias)
        keep = torch.arange(T, device=xw.device)[:, None] < lengths[None, :]
        return y * keep[..., None].to(y.dtype)
    return recur


def faulty_chain(torch, stale_units: int):
    """Planted backward-chain fault (otherwise ``blstm_bwd_recur_plain``'s
    arithmetic): dh_prev reads the dgates of the first ``stale_units``
    hidden units (their 4 gate columns) one step stale, as a block would
    after passing the step barrier before the block owning them had
    published (all units: a barrier that does not wait at all)."""

    def chain(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
        _, T, B, H4 = gates.shape
        H = H4 // 4
        cdt = gy.dtype
        dev = gates.device
        cols = torch.cat([torch.arange(g * H, g * H + stale_units) for g in range(4)])
        wh_now = wh.float().clone()
        wh_now[:, :, cols] = 0
        wh_late = torch.zeros_like(wh_now)
        wh_late[:, :, cols] = wh[:, :, cols].float()
        mask = (torch.arange(T, device=dev)[:, None]
                < lengths.to(dev)[None, :]).to(torch.float32)[..., None]
        dg = torch.zeros((2, T, B, H4), dtype=cdt, device=dev)
        zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
        for d in range(2):
            dh, dc = zeros, zeros
            prev = torch.zeros((B, H4), dtype=torch.float32, device=dev)
            for t in (range(T - 1, -1, -1) if d == 0 else range(T)):
                t_prev = t - 1 if d == 0 else t + 1
                c_prev = c[d, t_prev] if 0 <= t_prev < T else zeros
                m = mask[t]
                keep = m > 0.5
                z = gates[d, t]
                gi = torch.sigmoid(z[:, :H])
                gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
                gg = torch.tanh(z[:, 2 * H: 3 * H])
                go = torch.sigmoid(z[:, 3 * H:])
                tanh_c = torch.tanh(c[d, t])
                dh_total = gy[t, :, d * H: (d + 1) * H].float() * m + dh
                dh_new = torch.where(keep, dh_total, 0.0)
                dc_new = torch.where(keep, dc, 0.0) + dh_new * go * (1.0 - tanh_c * tanh_c)
                dgates = torch.cat([dc_new * gg * gi * (1.0 - gi),
                                    dc_new * c_prev * gf * (1.0 - gf),
                                    dc_new * gi * (1.0 - gg * gg),
                                    dh_new * tanh_c * go * (1.0 - go)], dim=-1).to(cdt)
                dg[d, t] = dgates
                dh_prev = dgates.float() @ wh_now[d].t() + prev @ wh_late[d].t()
                prev = dgates.float()
                dh = dh_prev + torch.where(keep, 0.0, dh_total)
                dc = dc_new * gf + torch.where(keep, 0.0, dc)
        return dg
    return chain


def c_one_step_late(torch, c):
    """Planted store fault: each step's f32 c written in the next step's
    row (the walk's order: t + 1 forward, t - 1 backward), zeros where
    nothing was written."""
    late = torch.zeros_like(c)
    late[0, 1:], late[1, :-1] = c[0, :-1], c[1, 1:]
    return late


def forget_bias_folded(gates, forget_bias: float = 1.0):
    """Planted store fault: the pre-activation gates stored after the
    forget bias was added to the forget gate's columns."""
    H = gates.shape[-1] // 4
    out = gates.clone()
    out[..., H: 2 * H] += forget_bias
    return out


def chunk_boundary_late(cb, logit_lengths, tc: int, reverse: bool):
    """Planted CTC fault: the emission at the first frame of each chunk
    after the first (the kernels' chunks of ``tc`` frames, forward from
    frame 0, in reverse from frame tlen - 1) is the one of the frame
    walked just before it, t - 1 forward and t + 1 in reverse: a chain
    that read the other buffer at the hand-off (the plain versions'
    emissions so altered)."""
    emissions = cb._emissions

    def late(logprobs, ext):
        lp = emissions(logprobs, ext).clone()
        for b, n in enumerate(logit_lengths):
            n = min(max(int(n), 0), lp.shape[0])
            if reverse:
                for f in range(max(n - 1, 0) - tc, 0, -tc):
                    lp[f, b] = lp[f + 1, b]
            else:
                for f in range(tc, n, tc):
                    lp[f, b] = lp[f - 1, b]
        return lp
    return late


def skip_dropped(cb):
    """Planted CTC fault: the skip transition between distinct labels is
    never taken (the plain versions' lanes with every skip flag off)."""
    lanes = cb._lanes

    def no_skip(labels, blank_id):
        ext, skip = lanes(labels, blank_id)
        return ext, skip & False
    return no_skip


def rnnt_emit_dropped(tf):
    """Planted alpha fault: the emit term left out of the prefix (the plain
    walk with every emit log-prob 0)."""
    def alpha(lp_blank, lp_emit, logit_lengths, target_lengths):
        return tf.rnnt_alpha_plain(lp_blank, lp_emit * 0.0, logit_lengths, target_lengths)
    return alpha


def rnnt_alpha_diagonal_walk(torch, tf, lag: int = 1):
    """The alpha recursion walked along the anti-diagonals d = t + u, as
    ``rnnt_alpha``'s kernel walks it (csrc/transducer.cu (b)), vectorised
    over the lattices and lanes: each node max(logaddexp(alpha[t - 1, u] +
    lp_blank[t - 1, u], alpha[t, u - 1] + lp_emit[t, u - 1]), NEG) from
    diagonal d - 1, the terms a node lacks and those past its lattice
    masked as the kernel masks them (blank 0, emit NEG), rows t >= T_b
    frozen at row T_b - 1, lanes past U_b NEG. With ``lag = 2`` the lane
    below is taken from diagonal d - 2 (``rnnt_alpha_neighbour_late``)."""
    NEG = tf.NEG

    def alpha(lp_blank, lp_emit, logit_lengths, target_lengths):
        T, B, U1 = lp_blank.shape
        dev = lp_blank.device
        Tb = logit_lengths.long().clamp(0, T)[:, None]
        Ub = target_lengths.long().clamp(0, U1 - 1)[:, None]
        u = torch.arange(U1, device=dev)[None, :]
        bi = torch.arange(B, device=dev)[:, None].expand(B, U1)
        live = u <= Ub
        a = torch.where((u == 0) & (Tb > 0), 0.0, NEG).to(torch.float32)
        seen = [a] * lag  # diagonals d - lag .. d - 1
        alphas = torch.full((T, B, U1), NEG, dtype=torch.float32, device=dev)
        steps = int(torch.where(Tb > 0, Tb + Ub, 0).max()) if B else 0
        for d in range(steps):
            t = (d - u).expand(B, U1)
            inside = live & (t >= 0) & (t < Tb)
            vb = torch.where(inside & (t >= 1), lp_blank[(t - 1).clamp(0, T - 1), bi, u], 0.0)
            ve = torch.where(inside & (u >= 1),
                             lp_emit[t.clamp(0, T - 1), bi, (u - 1).clamp(min=0)], NEG)
            below = torch.nn.functional.pad(seen[0][:, :-1], (1, 0), value=NEG)
            a = torch.clamp(torch.logaddexp(a + vb, below + ve), min=NEG)
            seen = seen[1:] + [a]
            ti = t.clamp(0, T - 1)
            alphas[ti, bi, u] = torch.where(inside, a, alphas[ti, bi, u])
        last = torch.where(live, a, NEG)
        frozen = torch.arange(T, device=dev)[:, None, None] >= Tb[None]
        alphas = torch.where(frozen, last[None], alphas)
        lpb = torch.where(Tb > 0, lp_blank[(Tb - 1).clamp(min=0), bi[:, :1], Ub], 0.0)
        return alphas, (torch.gather(a, 1, Ub) + lpb)[:, 0]
    return alpha


def rnnt_alpha_neighbour_late(torch, tf):
    """Planted alpha fault for the anti-diagonal walk: the lane below is
    read from diagonal d - 2 (a hand-off one step stale), so the emit term
    joins alpha[t - 1, u - 1] in place of alpha[t, u - 1]."""
    return rnnt_alpha_diagonal_walk(torch, tf, lag=2)


def rnnt_beta_read_early(torch, tf):
    """Planted beta fault (otherwise ``rnnt_beta_plain``'s arithmetic): the
    blank occupancy reads beta[t] instead of beta[t+1], as a walk that
    published the new row before its readers took the old one."""
    NEG = tf.NEG

    def beta_fn(lp_blank, lp_emit, alphas, ll, g, logit_lengths, target_lengths):
        T, B, U1 = lp_blank.shape
        dev = lp_blank.device
        tlen = logit_lengths[:, None]
        ulen = target_lengths.long()[:, None]
        lanes = torch.arange(U1, device=dev)[None, :]
        init = torch.where(lanes == ulen, 0.0, NEG)
        g = torch.where(ll > NEG / 2, g, 0.0)[:, None]
        beta = torch.full((B, U1), NEG, device=dev)
        gb, ge = torch.zeros_like(lp_blank), torch.zeros_like(lp_blank)
        for t in range(T - 1, -1, -1):
            nxt = torch.where(tlen - 1 <= t, init, beta)
            S = tf._prefix_sum(tf._shift_right(
                torch.where(lanes < ulen, lp_emit[t], 0.0), 1, 0.0))
            new = torch.clamp(-S + tf._suffix_lse(lp_blank[t] + nxt + S), min=NEG)
            ok = tlen > t
            a = alphas[t] - ll[:, None]
            gb[t] = torch.where(ok, torch.exp(torch.clamp(a + lp_blank[t] + new, max=0.0)),
                                0.0) * g
            ge[t] = torch.where(ok, torch.exp(torch.clamp(
                a + lp_emit[t] + tf._shift_left(new, 1, NEG), max=0.0)), 0.0) * g
            beta = torch.where(ok, new, beta)
        return gb, ge
    return beta_fn


def rnnt_last_frame_out_of_dpred(torch, tf):
    """Planted joint-backward fault: each lane's last frame left out of the
    prediction projection's gradient (the sum over t stopping one frame
    short); the other gradients as the plain version's."""
    def bwd(enc, pred, w, b, targets, target_lengths, logit_lengths, gb, ge, blank_id):
        out = tf.rnnt_joint_bwd_plain(enc, pred, w, b, targets, target_lengths,
                                      logit_lengths, gb, ge, blank_id)
        last = (torch.arange(gb.shape[0], device=gb.device)[:, None]
                == (logit_lengths - 1)[None, :])[..., None]
        cut = tf.rnnt_joint_bwd_plain(enc, pred, w, b, targets, target_lengths,
                                      logit_lengths, gb * ~last, ge * ~last, blank_id)
        return out[0], cut[1], out[2], out[3]
    return bwd


def _unit_cols(torch, H, units, device, first: int = 0):
    """The 4 gate columns of the hidden units [first, first + units)."""
    return torch.cat([torch.arange(g * H + first, g * H + first + units)
                      for g in range(4)]).to(device)


def lstm_stale_walk(torch, units: int = 8, first: int = 0):
    """Planted walk fault: the gates of the ``units`` hidden units from
    ``first`` on read h one step late (h_{t-2}), as the block owning them
    would after passing its row group's barrier before the others' h was
    visible. Otherwise ``lstm_fwd_plain``'s arithmetic and signature."""
    def walk(xw, lengths, wh, h0=None, c0=None, forget_bias: float = 1.0):
        T, B, H4 = xw.shape
        H = H4 // 4
        f32 = torch.float32
        dev = xw.device
        cols = _unit_cols(torch, H, units, dev, first)
        whf = wh.to(f32)
        h = torch.zeros((B, H), dtype=f32, device=dev) if h0 is None else h0.to(f32)
        c = torch.zeros((B, H), dtype=f32, device=dev) if c0 is None else c0.to(f32)
        h_late = h
        mask = (torch.arange(T, device=dev)[:, None] < lengths.to(dev)[None, :])[..., None]
        y = torch.zeros((T, B, H), dtype=xw.dtype, device=dev)
        for t in range(T):
            z = xw[t].to(f32) + h @ whf
            z[:, cols] = xw[t][:, cols].to(f32) + h_late @ whf[:, cols]
            gi = torch.sigmoid(z[:, :H])
            gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
            gg = torch.tanh(z[:, 2 * H: 3 * H])
            go = torch.sigmoid(z[:, 3 * H:])
            c_new = gf * c + gi * gg
            h_new = go * torch.tanh(c_new)
            m = mask[t]
            h_late = h
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            y[t] = torch.where(m, h_new, 0.0).to(xw.dtype)
        return y, (h, c)
    return walk


def lstm_carry_not_held(torch):
    """Planted walk fault: the carry is not held past each lane's length,
    only the output is masked, so the final carry a stream hands to its
    next chunk is the padding's."""
    from nabu_tpu_torch.ops.lstm import lstm_fwd_plain

    def walk(xw, lengths, wh, h0=None, c0=None, forget_bias: float = 1.0):
        T = xw.shape[0]
        y, carry = lstm_fwd_plain(xw, torch.full_like(lengths, T), wh, h0, c0, forget_bias)
        keep = torch.arange(T, device=xw.device)[:, None] < lengths.to(xw.device)[None, :]
        return y * keep[..., None].to(y.dtype), carry
    return walk


def lstm_faulty_chain(torch, stale_units: int = 8):
    """Planted chain fault (otherwise ``lstm_bwd_recur_plain``'s
    arithmetic): dh_prev reads the dgates of the first ``stale_units``
    hidden units one step stale, as a block would after passing the step
    barrier before the block owning them had published."""
    def chain(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
        T, B, H4 = gates.shape
        H = H4 // 4
        f32 = torch.float32
        dev = gates.device
        cols = _unit_cols(torch, H, stale_units, dev)
        wh_now = wh.to(f32).clone()
        wh_now[:, cols] = 0
        wh_late = torch.zeros_like(wh_now)
        wh_late[:, cols] = wh[:, cols].to(f32)
        mask = (torch.arange(T, device=dev)[:, None]
                < lengths.to(dev)[None, :]).to(f32)[..., None]
        dxw = torch.zeros((T, B, H4), dtype=f32, device=dev)
        zeros = torch.zeros((B, H), dtype=f32, device=dev)
        dh, dc = zeros, zeros
        prev = torch.zeros((B, H4), dtype=f32, device=dev)
        for t in range(T - 1, -1, -1):
            c_prev = c[t - 1] if t > 0 else zeros
            m = mask[t]
            keep = m > 0.5
            z = gates[t]
            gi = torch.sigmoid(z[:, :H])
            gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
            gg = torch.tanh(z[:, 2 * H: 3 * H])
            go = torch.sigmoid(z[:, 3 * H:])
            tanh_c = torch.tanh(c[t])
            dh_total = gy[t].to(f32) * m + dh
            dh_new = torch.where(keep, dh_total, 0.0)
            dc_new = torch.where(keep, dc, 0.0) + dh_new * go * (1.0 - tanh_c * tanh_c)
            dgates = torch.cat([dc_new * gg * gi * (1.0 - gi),
                                dc_new * c_prev * gf * (1.0 - gf),
                                dc_new * gi * (1.0 - gg * gg),
                                dh_new * tanh_c * go * (1.0 - go)], dim=-1)
            dxw[t] = dgates
            dh = dgates @ wh_now.t() + prev @ wh_late.t() + torch.where(keep, 0.0, dh_total)
            prev = dgates
            dc = dc_new * gf + torch.where(keep, 0.0, dc)
        return dxw
    return chain


def hs_one_step_late(torch, hs):
    """Planted store fault: the v1 walk's stored h carries [2, T + 1, B,
    H] written one slot further along each direction's walk (zeros where
    nothing was written)."""
    late = torch.zeros_like(hs)
    late[0, 2:], late[1, :-2] = hs[0, 1:-1], hs[1, 1:-1]
    return late


def v1_dwh_directions_swapped(torch):
    """Planted v1 dwh fault: each direction's dgates paired with the other
    direction's carries (the GEMM's two operand pairs exchanged)."""
    from nabu_tpu_torch.ops.blstm_v1 import blstm_v1_bwd_dwh_plain

    def dwh(hs, dg):
        return blstm_v1_bwd_dwh_plain(hs.flip(0), dg)
    return dwh


def v1_dwh_h_late(torch):
    """Planted v1 dwh fault: each step's dgates paired with the carry one
    step further back than the step read (an off-by-one in the row offset
    of hprev)."""
    from nabu_tpu_torch.ops.blstm_v1 import blstm_v1_bwd_dwh_plain

    def dwh(hs, dg):
        late = torch.zeros_like(hs)
        late[0, 1:], late[1, :-1] = hs[0, :-1], hs[1, 1:]
        return blstm_v1_bwd_dwh_plain(late, dg)
    return dwh


def lstm_dwh_h_late(torch):
    """Planted dwh fault: each step's dgates paired with h two steps back
    instead of one (an off-by-one in the row offset of h_prev)."""
    from nabu_tpu_torch.ops.lstm import lstm_bwd_dwh_plain

    def dwh(hs, dxw):
        late = torch.zeros_like(hs)
        late[1:] = hs[:-1]
        return lstm_bwd_dwh_plain(late, dxw)
    return dwh


# ---------------------------------------------------------------------------
# synthesized audio and weights (numpy, seeded)
# ---------------------------------------------------------------------------

def align_repeat_skip():
    """Planted forced-alignment fault: the skip s - 2 -> s allowed into
    every label state, a repeated label too, so that a path may go from a
    label straight into its repeat and the two merge into one segment."""
    from nabu_tpu_torch.decoding import align

    right = align.transitions

    def transitions(z, s_len):
        _, in_seq = right(z, s_len)
        states = z.new_tensor(range(z.shape[1]))[None, :]
        return (states % 2 == 1).expand_as(z), in_seq

    return swapped(align, "transitions", transitions)


def label_emissions(targets, target_lengths, lengths, T: int, V: int) -> np.ndarray:
    """f32 log-probs [B, T, V] (blank V - 1) under which each sequence's
    labels, in order, each hold an equal share of its frames with
    probability 0.9 and blank is unlikely: a Viterbi path pays for the
    blank frame it must place between two equal labels, which a skip into
    the repeat (``align_repeat_skip``) would save, so that fault shows
    wherever a sequence repeats a label."""
    B = len(targets)
    lp = np.full((B, T, V), np.log(0.1 / (V - 1)), np.float32)
    for b in range(B):
        n, U = int(lengths[b]), int(target_lengths[b])
        if U == 0:
            continue
        u = np.minimum(np.arange(n) * U // max(n, 1), U - 1)
        lp[b, np.arange(n), np.asarray(targets[b])[u]] = np.log(0.9)
    return lp


def collapses_to(frames, length: int, labels, blank: int) -> bool:
    """A frame-label row's segments (``decoding.align.segments_from_frames``)
    read as the label sequence ``labels``."""
    from nabu_tpu_torch.decoding.align import segments_from_frames

    row = frames.cpu().tolist() if hasattr(frames, "cpu") else list(frames)
    return [lab for lab, _, _ in segments_from_frames(row, int(length), blank)] == [
        int(x) for x in labels]


def mwer_eos_dropped(rows: int):
    """Planted MWER fault: the eos term left out of each hypothesis's
    score. The re-scoring ``Speller.apply`` over ``rows`` (B x N)
    sequences returns constant logits at each sequence's eos position, so
    that term is the same for every hypothesis and cancels in p̂."""
    import torch

    from nabu_tpu_torch.models.decoders import Speller

    right = Speller.apply

    def apply(self, params, encoded, enc_lengths, targets=None, target_lengths=None, **kw):
        logits, lengths = right(self, params, encoded, enc_lengths, targets=targets,
                                target_lengths=target_lengths, **kw)
        if encoded.shape[0] != rows:
            return logits, lengths
        pos = torch.arange(logits.shape[1], device=logits.device)[None, :, None]
        at_eos = pos == target_lengths.to(logits.device).long()[:, None, None]
        return torch.where(at_eos, torch.zeros((), dtype=logits.dtype, device=logits.device),
                           logits), lengths

    return swapped(Speller, "apply", apply)


def mwer_refs_tiled(n: int):
    """Planted MWER fault: each hypothesis scored against another
    utterance's reference, the references tiled over the B x n rows
    (``torch.repeat``) where each should repeat n times in place
    (``repeat_interleave``, JAX's ``jnp.repeat``): the error counts, and
    so the gradient, change."""
    from nabu_tpu_torch.ops import mwer

    right = mwer.token_edit_distance

    def token_edit_distance(hyps, hyp_lengths, refs, ref_lengths):
        return right(hyps, hyp_lengths, refs[::n].repeat(n, 1), ref_lengths[::n].repeat(n))

    return swapped(mwer, "token_edit_distance", token_edit_distance)


def synth_utterance(rng, seconds: float, rate: int = 16000) -> np.ndarray:
    """Tone sequence with envelopes plus a noise floor (no silent bins)."""
    n = int(seconds * rate)
    sig = np.zeros(n, np.float64)
    pos = 0
    while pos < n:
        dur = int(rng.uniform(0.06, 0.2) * rate)
        t = np.arange(min(dur, n - pos)) / rate
        f0 = rng.uniform(100.0, 3500.0)
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
        sig[pos: pos + len(t)] = np.sin(2 * np.pi * f0 * t) * env
        pos += len(t)
    return (6000.0 * sig + 40.0 * rng.standard_normal(n)).astype(np.float32)


def glorot(rng, shape):
    limit = np.sqrt(6.0 / (shape[-2] + shape[-1]))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def recipe_params(rng, input_dim: int, num_layers: int, units: int, num_labels: int):
    """Seeded weights in the JAX package's flattened tree layout."""
    flat = {}
    d = input_dim
    for i in range(num_layers):
        for direction in ("fw", "bw"):
            key = f"encoder/layer_{i}/{direction}"
            flat[f"{key}/wx"] = glorot(rng, (d, 4 * units))
            flat[f"{key}/wh"] = glorot(rng, (units, 4 * units))
            flat[f"{key}/b"] = rng.uniform(-0.1, 0.1, (4 * units,)).astype(np.float32)
        d = 2 * units
    flat["decoders/decoder/out/w"] = glorot(rng, (d, num_labels + 1))
    flat["decoders/decoder/out/b"] = rng.uniform(
        -0.1, 0.1, (num_labels + 1,)).astype(np.float32)
    return flat


def model_params(model_cfg, input_dim: int, num_labels: int, seed: int) -> dict:
    """Seeded weights of any model the port builds, in the flattened tree
    layout: the port's init (glorot, embeddings N(0, 0.02)) from a
    torch.Generator, with nonzero biases drawn by numpy."""
    import torch

    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.params import to_flat_numpy

    model = build_model(model_cfg, input_dim, num_labels)
    flat = to_flat_numpy(model.init(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-0.1, 0.1, v.shape).astype(np.float32) if k.endswith("/b") else v
            for k, v in flat.items()}


def write_artifact(out_dir: str, seed: int, recipe: str = RECIPE) -> dict:
    """A full-width export artifact of a recipe, written by the port's
    ``export`` (``serving.export_model``) from seeded weights saved as the
    best checkpoint of an experiment directory beside ``out_dir``."""
    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.data.processors import TextProcessor
    from nabu_tpu_torch.features.computers import make_feature_computer
    from nabu_tpu_torch.serving import export_model

    r = Recipe(recipe)
    rconf = r.recognizer.section("recognizer")
    input_dim = make_feature_computer(
        r.database.section(rconf.get("features", "testfeatures"))).dim
    num_labels = TextProcessor(r.database.section(rconf.get("targets", "testtargets"))).num_labels
    enc = r.model.section("encoder")
    if enc.get("encoder") == "dblstm" and enc.getbool("bidirectional", True):
        flat = recipe_params(np.random.default_rng(seed), input_dim, enc.getint("num_layers"),
                             enc.getint("num_units"), num_labels)
    else:
        flat = model_params(r.model, input_dim, num_labels, seed)
    expdir = out_dir + "_exp"
    best = os.path.join(expdir, "checkpoints", "best")
    os.makedirs(best)
    np.savez(os.path.join(best, "params.npz"), **flat)
    export_model(recipe, expdir, out_dir)
    with open(os.path.join(out_dir, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(verbose: bool) -> None:
    from nabu_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    info = build.build_all(verbose=verbose)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: v["seconds"] for k, v in info.items()}})
    if verbose:
        for name, v in info.items():
            print(f"--- nvcc {name}.cu\n{v['log']}", flush=True)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_kernels(torch, quick: bool) -> dict:
    from nabu_tpu_torch.features import torch_frontend as tf
    from nabu_tpu_torch.ops import blstm as blstm_ops
    from nabu_tpu_torch.ops import stft_mel as stft_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    reps = 0 if quick else 20
    rows = {}

    def timed(fn, n):
        return time_ms(torch, fn, n) if n else None

    # --- STFT + Mel at N = 32 x 1024 frames ------------------------------
    fp = tf.make_frontend_params(16000.0, nfilt=NFILT, device=dev)
    cossin, mel, mr = fp.folded()
    sig = torch.as_tensor(
        np.stack([synth_utterance(rng, 10.3) for _ in range(B)]), device=dev)
    frames = tf.frame_signal(sig, fp.frame_len, fp.frame_step, T)
    frames = frames.reshape(B * T, fp.frame_len).contiguous()
    N = frames.shape[0]
    check(tuple(cossin.shape) == (W, 2 * K), f"stft_mel: cossin {tuple(cossin.shape)}")
    got = stft_ops.stft_mel(frames, cossin, mel, mr)
    ref = stft_ops.stft_mel_plain(frames, cossin, mel)
    got_f32 = got
    err = compare(torch, got, ref, TOL["stft_mel"], "stft_mel")
    fault = fault_reading(drop_last_tap(stft_ops.stft_mel_plain)(frames, cossin, mel, mr),
                          ref, TOL["stft_mel"], "stft_mel")

    def fft_log_mel():
        # the same function through a real FFT of nfft points
        spec = torch.fft.rfft(frames * fp.window, n=fp.nfft)[:, :K]
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.log(torch.clamp(power @ mel, min=1e-30))

    spec = torch.fft.rfft(frames.double() * fp.window.double(), n=fp.nfft)[:, :K]
    exact = torch.log(torch.clamp((spec.abs() ** 2) @ mel.double(), min=1e-30))
    del spec

    # least work: the window, a real FFT (~2.5 nfft log2 nfft operations a
    # frame), the power, the mel product over its nonzeros, the log
    nnz = int((mel != 0).sum())
    ops = N * (W + 2.5 * fp.nfft * math.log2(fp.nfft) + 3 * K + NFILT) + 2 * N * nnz
    bytes_ = 4 * (N * W + W * 2 * K + K * NFILT + N * NFILT)
    b_ms, b_by = bound(bytes_, ops, PEAK_F32)
    ms = timed(lambda: stft_ops.stft_mel(frames, cossin, mel, mr), reps)
    rows["stft_mel"] = {
        "shape": [N, W, K, NFILT], "dtype": "f32", "max_abs_err": err,
        "tol": TOL["stft_mel"], "fault_max_abs_err": fault, "ms": ms,
        # the kernel's own rate: the DFT product it computes (2 N W 2K)
        "gflops": None if ms is None else 4 * N * W * K / ms / 1e6,
        "bound_share": None if ms is None else b_ms / ms,
        "plain_ms": timed(lambda: stft_ops.stft_mel_plain(frames, cossin, mel), reps),
        "library_ms": timed(lambda: torch.matmul(frames, cossin), reps),
        "library": "torch.matmul frames @ cossin (the DFT product only)",
        "fft_ms": timed(fft_log_mel, reps),
        "fft_max_abs_err": float((fft_log_mel() - ref).abs().max()),
        "fft": "torch.fft.rfft, power, mel product, log",
        # how far the plain version and the kernel land from the float64
        # spectrum (the f32 table and sum order set the near-silent bands)
        "plain_f64_max_abs_err": float((ref.double() - exact).abs().max()),
        "kernel_f64_max_abs_err": float((got.double() - exact).abs().max()),
        "bound_ms": b_ms, "bound_by": b_by, "mel_nonzeros": nnz,
    }
    emit({"phase": "kernels", "kernel": "stft_mel", **rows["stft_mel"]})

    # --- the bf16 mode on the same frames: bf16 frames and table, the
    # product on the tensor cores ------------------------------------------
    cs16, _, _ = fp.folded("bf16")
    fr16 = frames.to(torch.bfloat16)
    got = stft_ops.stft_mel(fr16, cs16, mel, mr)
    ref = stft_ops.stft_mel_plain(fr16, cs16, mel)
    tol = TOL["stft_mel_bf16"]
    err = compare(torch, got, ref, tol, "stft_mel_bf16")
    fault = fault_reading(drop_last_tap(stft_ops.stft_mel_plain)(fr16, cs16, mel, mr), ref, tol,
                          "stft_mel_bf16")
    exact = fr16.double() @ cs16.double()
    exact = torch.log(torch.clamp((exact[:, :K] ** 2 + exact[:, K:] ** 2) @ mel.double(),
                                  min=1e-30))

    def library_bf16():
        # the yardstick: the bf16 product (bf16 out), power, mel, log
        cs = (fr16 @ cs16).float()
        return torch.log(torch.clamp((cs[:, :K] ** 2 + cs[:, K:] ** 2) @ mel, min=1e-30))

    # the DFT product on the tensor cores (2 N W 2K at the bf16 rate) beside
    # the power, the mel product over its nonzeros and the log at the f32
    # rate; each bf16 input read once, the f32 output written once
    b_ms, b_by = bound(2 * (N * W + W * 2 * K) + 4 * (2 * nnz + NFILT * 3 + N * NFILT),
                       4 * N * W * K, PEAK_BF16, (N * (3 * K + NFILT) + 2 * N * nnz, PEAK_F32))
    ms = timed(lambda: stft_ops.stft_mel(fr16, cs16, mel, mr), reps)
    rows["stft_mel_bf16"] = {
        "shape": [N, W, K, NFILT], "dtype": "bf16", "max_abs_err": err, "tol": tol,
        "fault_max_abs_err": fault, "ms": ms,
        "tflops": None if ms is None else 4 * N * W * K / ms / 1e9,
        "bound_share": None if ms is None else b_ms / ms,
        "f32_kernel_ms": rows["stft_mel"]["ms"],
        "plain_ms": timed(lambda: stft_ops.stft_mel_plain(fr16, cs16, mel), reps),
        "library_ms": timed(library_bf16, reps),
        "library": "bf16 frames @ cossin (bf16 out), power, mel product, log",
        # both sides' distance from the float64 product of the same bf16
        # operands, and the mode's distance from the f32 mode's features
        "plain_f64_max_abs_err": float((ref.double() - exact).abs().max()),
        "kernel_f64_max_abs_err": float((got.double() - exact).abs().max()),
        "f32_mode_max_abs_diff": float((got - got_f32).abs().max()),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit({"phase": "kernels", "kernel": "stft_mel_bf16", **rows["stft_mel_bf16"]})
    del exact, fr16

    # --- BLSTM projection and recurrence ----------------------------------
    lengths = np.full((B,), T, np.int32)
    lengths[1:] = rng.integers(T // 8, T + 1, B - 1)
    lens_t = torch.as_tensor(lengths, device=dev)
    valid = int(lengths.sum())
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        es = 2 if tag == "bf16" else 4
        peak = PEAK_BF16 if tag == "bf16" else PEAK_F32
        # D = 2 NFILT: the first layer; 4H: a Listener's pyramid layers
        # (stacked frame pairs); 2H last, the layer the walks below take
        for D in (2 * NFILT, 4 * H, 2 * H):
            x = torch.as_tensor(
                rng.standard_normal((T * B, D)).astype(np.float32), device=dev).to(dtype)
            wx = torch.as_tensor(glorot(rng, (2, D, 4 * H)), device=dev).to(dtype)
            bias = torch.as_tensor(
                rng.uniform(-0.1, 0.1, (2, 4 * H)).astype(np.float32), device=dev).to(dtype)
            got = blstm_ops.blstm_proj(x, wx, bias)
            ref = blstm_ops.blstm_proj_plain(x, wx, bias)
            tol = TOL[("blstm_proj", tag)]
            err = compare(torch, got, ref, tol, f"blstm_proj {tag} D={D}")
            x_cut = x.clone()
            x_cut[:, -1] = 0
            fault = fault_reading(blstm_ops.blstm_proj_plain(x_cut, wx, bias), ref, tol,
                                  f"blstm_proj {tag} D={D}")
            M = T * B
            b_ms, b_by = bound(es * (M * D + 2 * D * 4 * H + 2 * 4 * H + 2 * M * 4 * H),
                               2 * 2 * M * D * 4 * H, peak)
            row = {
                "shape": [M, D, 4 * H], "dtype": tag, "max_abs_err": err, "tol": tol,
                "fault_max_abs_err": fault,
                "ms": timed(lambda: blstm_ops.blstm_proj(x, wx, bias), reps),
                "plain_ms": timed(lambda: blstm_ops.blstm_proj_plain(x, wx, bias), reps),
                "library_ms": timed(lambda: torch.matmul(x, wx), reps),
                "library": "torch.matmul x @ wx (both directions)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if tag == "bf16":
                row.update(gemm_fields(torch, timed, reps,
                                       lambda: blstm_ops.blstm_proj(x, wx, bias), 0, M, 4 * H,
                                       D, 2 * 2 * M * D * 4 * H, row["ms"]))
            else:
                row.update(f32_gemm_fields(torch, lambda: blstm_ops.blstm_proj(x, wx, bias), 0,
                                           M, 4 * H, D, 2, 2 * 2 * M * D * 4 * H, row["ms"]))
            emit({"phase": "kernels", "kernel": "blstm_proj", **row})
            rows[("blstm_proj", tag, D)] = row
        # recurrence on the projection of the widest layer's input
        xw = got.view(2, T, B, 4 * H).contiguous()
        wh = torch.as_tensor(glorot(rng, (2, H, 4 * H)), device=dev).to(dtype)
        got_r = blstm_ops.blstm_recur(xw, lens_t, wh)
        ref_r = blstm_ops.blstm_recur_plain(xw, lens_t, wh)
        tol = TOL[("blstm_recur", tag)]
        err = compare(torch, got_r, ref_r, tol, f"blstm_recur {tag}")
        fault = fault_reading(stale_recur(torch)(xw, lens_t, wh), ref_r, tol,
                              f"blstm_recur {tag}")
        # one whole unit group of the walk's plan reads h one step late
        group = blstm_ops.walk_plan(B, H)[0]
        group_fault = fault_reading(stale_recur(torch, units=group)(xw, lens_t, wh), ref_r, tol,
                                    f"blstm_recur {tag} ({group} units)")
        b_ms, b_by = bound(
            es * (2 * valid * 4 * H + 2 * H * 4 * H + T * B * 2 * H) + 4 * B,
            2 * valid * (2 * H * 4 * H + 12 * H), peak)
        # library yardstick: cuDNN bidirectional LSTM (projection included)
        # on a packed sequence, forget_bias folded into bias_ih
        lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev, dtype)
        with torch.no_grad():
            for d, sfx in enumerate(("", "_reverse")):
                getattr(lstm, f"weight_ih_l0{sfx}").copy_(wx[d].t())
                getattr(lstm, f"weight_hh_l0{sfx}").copy_(wh[d].t())
                b_ih = bias[d].float().clone()
                b_ih[H: 2 * H] += 1.0
                getattr(lstm, f"bias_ih_l0{sfx}").copy_(b_ih.to(dtype))
                getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        lstm.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x.view(T, B, D), torch.as_tensor(lengths), enforce_sorted=False)

        def run_cudnn():
            with torch.no_grad():
                return lstm(packed)[0]

        cudnn_out, _ = torch.nn.utils.rnn.pad_packed_sequence(run_cudnn(), total_length=T)
        ours = blstm_ops.blstm_tm_apply(
            {"fw": {"wx": wx[0], "wh": wh[0], "b": bias[0]},
             "bw": {"wx": wx[1], "wh": wh[1], "b": bias[1]}},
            x.view(T, B, D), lens_t)
        cudnn_err = float((cudnn_out.float() - ours.float()).abs().max())

        def blstm_recur():
            return blstm_ops.blstm_recur(xw, lens_t, wh)

        row = {
            "shape": [T, B, H], "dtype": tag, "max_abs_err": err, "tol": tol,
            "fault_max_abs_err": fault, "group_fault_max_abs_err": group_fault,
            "ms": timed(blstm_recur, reps),
            "plain_ms": timed(lambda: blstm_ops.blstm_recur_plain(xw, lens_t, wh),
                              min(reps, 2)),
            "library_ms": timed(run_cudnn, reps),
            "library": "cuDNN nn.LSTM bidirectional, packed (projection included)",
            "cudnn_layer_max_abs_err": cudnn_err,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        row.update(walk_fields(torch, timed, reps, blstm_recur, got_r, row["ms"], blstm_ops))
        emit({"phase": "kernels", "kernel": "blstm_recur", **row})
        rows[("blstm_recur", tag)] = row
        rows.update(training_kernel_rows(torch, rng, tag, dtype, xw, lengths, wh, lstm,
                                         packed, timed, reps))
    rows.update(ctc_rows(torch, timed, reps))
    rows.update(rnnt_rows(torch, timed, reps))
    rows.update(lstm_rows(torch, timed, reps))
    rows.update(lm_lstm_rows(torch, timed, reps))
    rows.update(v1_rows(torch, timed, reps // 4))
    rows.update(f32_recipe_rows(torch, timed, reps))
    torch.cuda.synchronize()
    return rows


def v1_rows(torch, timed, reps) -> dict:
    """The v1 BLSTM kernels (rows 4-6) at las_large's Listener widths, B =
    64, H = 512, bottom layer (T = 1024, D = 80) and pyramid_0 (T = 512, D =
    2048), bf16 and f32, ragged lengths: the inference walk, the training
    walk (output and stores), the gates recompute and the chain on the
    plain walk's carries, dwh; each against its plain version with a
    planted fault; kernel / plain / library times and the bound. The
    library yardstick is a bidirectional cuDNN ``nn.LSTM`` of width 512 on
    the padded [T, B, D] input, timed only (no forget bias, no masking,
    projection included)."""
    from nabu_tpu_torch.ops import blstm as bo
    from nabu_tpu_torch.ops import blstm_v1 as v1

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    Bv, Hv = V1_B, V1_H
    H4 = 4 * Hv
    rows = {}

    def u(shape, dtype, scale=1.0):
        return torch.as_tensor(rng.uniform(-scale, scale, shape).astype(np.float32),
                               device=dev).to(dtype)

    for case, Tv, D in V1_SHAPES:
        lengths = rng.integers(Tv // 8, Tv + 1, Bv).astype(np.int32)
        lengths[0] = Tv
        lens = torch.as_tensor(lengths, device=dev)
        valid = int(lengths.sum())
        M = Tv * Bv
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            es = 2 if tag == "bf16" else 4
            peak = PEAK_BF16 if tag == "bf16" else PEAK_F32
            key = f"{tag} {case}"
            x = torch.as_tensor(rng.standard_normal((Tv, Bv, D)).astype(np.float32),
                                device=dev).to(dtype)
            wx = torch.as_tensor(glorot(rng, (2, D, H4)), device=dev).to(dtype)
            wh = torch.as_tensor(glorot(rng, (2, Hv, H4)), device=dev).to(dtype)
            xw = bo.blstm_proj(x.view(M, D), wx, u((2, H4), dtype, 0.1)).view(2, Tv, Bv, H4)

            lstm = torch.nn.LSTM(D, Hv, bidirectional=True).to(dev, dtype)
            x_lib = x.detach().clone().requires_grad_(True)
            g_lib = torch.ones((Tv, Bv, 2 * Hv), device=dev, dtype=dtype)

            def lib_infer():
                with torch.no_grad():
                    return lstm(x)[0]

            def lib_fwd():
                return lstm(x_lib)[0]

            def lib_fwd_bwd():
                lib_fwd().backward(g_lib)

            lib_i, lib_f, lib_fb = (timed(f, reps) for f in (lib_infer, lib_fwd, lib_fwd_bwd))
            library = f"cuDNN nn.LSTM bidirectional H = {Hv}, padded, "

            # --- row 4: the inference walk ------------------------------------
            tol = TOL[("blstm_v1_recur", tag)]
            got = v1.blstm_v1_recur(xw, lens, wh)
            ref = v1.blstm_v1_recur_plain(xw, lens, wh)
            err = compare(torch, got, ref, tol, f"blstm_v1_recur {key}")
            fault = fault_reading(stale_recur(torch)(xw, lens, wh), ref, tol,
                                  f"blstm_v1_recur {key}")
            # the plan's second unit group reads h one step late
            group = v1.walk_plan(Bv, Hv, tag)[0]
            stale_group = stale_recur(torch, units=group, first=group)(xw, lens, wh)
            group_fault = fault_reading(stale_group, ref, tol,
                                        f"blstm_v1_recur {key} (unit group {group}.."
                                        f"{2 * group - 1})")
            walk_ops = 2 * valid * (2 * Hv * H4 + 12 * Hv)
            walk_bytes = es * (2 * valid * H4 + 2 * Hv * H4 + M * 2 * Hv) + 4 * Bv
            b_ms, b_by = bound(walk_bytes, walk_ops, peak)
            row = {
                "shape": [Tv, Bv, Hv], "D": D, "dtype": tag, "valid_tokens": valid,
                "max_abs_err": err, "tol": tol, "fault_max_abs_err": fault,
                "group_fault_max_abs_err": group_fault,
                "ms": timed(lambda: v1.blstm_v1_recur(xw, lens, wh), reps),
                "plain_ms": timed(lambda: v1.blstm_v1_recur_plain(xw, lens, wh), min(reps, 1)),
                "library_ms": lib_i, "library": library + "inference (timed only)",
                "bound_ms": b_ms, "bound_by": b_by,
            }

            def blstm_v1_recur():
                return v1.blstm_v1_recur(xw, lens, wh)

            row.update(walk_fields(torch, timed, reps, blstm_v1_recur, got, row["ms"], v1,
                                   Tv, Bv, Hv, tag))
            emit({"phase": "kernels", "kernel": "blstm_v1_recur", "case": case, **row})
            rows[("blstm_v1_recur", tag, case)] = row
            del got, ref

            # --- row 5: the training walk -------------------------------------
            s_tol = TOL[("blstm_v1_stores", tag)]
            got = v1.blstm_v1_recur_train(xw, lens, wh)
            ref = v1.blstm_v1_recur_train_plain(xw, lens, wh)
            err = compare(torch, got[0], ref[0], tol, f"blstm_v1_recur_train {key} y")
            h_err = compare(torch, got[1], ref[1], tol, f"blstm_v1_recur_train {key} h")
            c_err = compare(torch, got[2], ref[2], s_tol, f"blstm_v1_recur_train {key} c")
            fault = fault_reading(stale_recur(torch)(xw, lens, wh), ref[0], tol,
                                  f"blstm_v1_recur_train {key}")
            group_fault = fault_reading(stale_group, ref[0], tol,
                                        f"blstm_v1_recur_train {key} (unit group {group}.."
                                        f"{2 * group - 1})")
            h_fault = fault_reading(hs_one_step_late(torch, ref[1]), ref[1], tol,
                                    f"blstm_v1_recur_train {key} h")
            c_fault = fault_reading(c_one_step_late(torch, ref[2]), ref[2], s_tol,
                                    f"blstm_v1_recur_train {key} c")
            b_ms, b_by = bound(walk_bytes + es * 2 * (Tv + 1) * Bv * Hv + 4 * 2 * M * Hv,
                               walk_ops, peak)
            row = {
                "shape": [Tv, Bv, Hv], "D": D, "dtype": tag, "max_abs_err": err, "tol": tol,
                "h_max_abs_err": h_err, "c_max_abs_err": c_err, "stores_tol": s_tol,
                "fault_max_abs_err": fault, "group_fault_max_abs_err": group_fault,
                "h_fault_max_abs_err": h_fault, "c_fault_max_abs_err": c_fault,
                "ms": timed(lambda: v1.blstm_v1_recur_train(xw, lens, wh), reps),
                "plain_ms": timed(lambda: v1.blstm_v1_recur_train_plain(xw, lens, wh),
                                  min(reps, 1)),
                "library_ms": lib_f, "library": library + "training forward (timed only)",
                "bound_ms": b_ms, "bound_by": b_by,
            }

            def blstm_v1_recur_train():
                return v1.blstm_v1_recur_train(xw, lens, wh)

            row.update(walk_fields(torch, timed, reps, blstm_v1_recur_train, got, row["ms"], v1,
                                   Tv, Bv, Hv, tag))
            # its first step waits for nothing and is not counted
            row["step_probe"] = walk_probe(
                torch, timed, reps, lambda: v1.blstm_v1_recur_train_probe(xw, lens, wh), Tv,
                Tv - 1)
            emit({"phase": "kernels", "kernel": "blstm_v1_recur_train", "case": case, **row})
            rows[("blstm_v1_recur_train", tag, case)] = row
            _, hs, cs = ref
            del got, ref, stale_group

            # --- row 6: gates recompute ---------------------------------------
            tol = TOL[("blstm_v1_bwd_gates", tag)]
            gates = v1.blstm_v1_bwd_gates(xw, hs, wh)
            ref_g = v1.blstm_v1_bwd_gates_plain(xw, hs, wh)
            err = compare(torch, gates, ref_g, tol, f"blstm_v1_bwd_gates {key}")
            hs_cut = hs.clone()
            hs_cut[..., -1] = 0
            fault = fault_reading(v1.blstm_v1_bwd_gates_plain(xw, hs_cut, wh), ref_g, tol,
                                  f"blstm_v1_bwd_gates {key}")
            del gates, hs_cut
            hprev = torch.stack([hs[0, :-1], hs[1, 1:]]).reshape(2, M, Hv)
            b_ms, b_by = bound(es * (2 * M * H4 + 2 * (Tv + 1) * Bv * Hv + 2 * Hv * H4)
                               + 4 * 2 * M * H4, 2 * 2 * valid * Hv * H4, peak)
            row = {
                "shape": [M, Hv, H4], "D": D, "dtype": tag, "max_abs_err": err, "tol": tol,
                "fault_max_abs_err": fault,
                "ms": timed(lambda: v1.blstm_v1_bwd_gates(xw, hs, wh), reps),
                "plain_ms": timed(lambda: v1.blstm_v1_bwd_gates_plain(xw, hs, wh), reps),
                "library_ms": timed(lambda: torch.baddbmm(xw.view(2, M, H4), hprev, wh), reps),
                "library": "torch.baddbmm xw + hprev @ wh (both directions, in the element "
                           "type)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if tag == "bf16":
                row.update(gemm_fields(torch, timed, reps,
                                       lambda: v1.blstm_v1_bwd_gates(xw, hs, wh), 3, M, H4, Hv,
                                       2 * 2 * valid * Hv * H4, row["ms"]))
            else:
                row.update(f32_gemm_fields(torch, lambda: v1.blstm_v1_bwd_gates(xw, hs, wh), 3,
                                           M, H4, Hv, 2, 2 * 2 * M * Hv * H4, row["ms"]))
            emit({"phase": "kernels", "kernel": "blstm_v1_bwd_gates", "case": case, **row})
            rows[("blstm_v1_bwd_gates", tag, case)] = row

            # --- row 6: the chain, on the plain walk's carries ----------------
            gy = u((Tv, Bv, 2 * Hv), dtype)
            tol = TOL[("blstm_v1_bwd_recur", tag)]
            dg = v1.blstm_v1_bwd_recur(ref_g, cs, gy, lens, wh)
            ref_dg = v1.blstm_v1_bwd_recur_plain(ref_g, cs, gy, lens, wh)
            err = compare(torch, dg, ref_dg, tol, f"blstm_v1_bwd_recur {key}")
            fault = fault_reading(faulty_chain(torch, stale_units=8)(ref_g, cs, gy, lens, wh),
                                  ref_dg, tol, f"blstm_v1_bwd_recur {key}")
            b_ms, b_by = bound(
                4 * 2 * M * (H4 + Hv) + es * (M * 2 * Hv + 2 * Hv * H4 + 2 * M * H4) + 4 * Bv,
                2 * valid * (2 * H4 * Hv + 30 * Hv), peak)
            same = torch.equal(dg, v1.blstm_v1_bwd_recur(ref_g, cs, gy, lens, wh))
            if not same:
                FAILURES.append(f"blstm_v1_bwd_recur {key}: a second launch's bits differ")
            ms = timed(lambda: v1.blstm_v1_bwd_recur(ref_g, cs, gy, lens, wh), reps)
            row = {
                "shape": [Tv, Bv, Hv], "D": D, "dtype": tag, "max_abs_err": err, "tol": tol,
                "ref_max_abs": float(ref_dg.float().abs().max()), "fault_max_abs_err": fault,
                "ms": ms, "us_per_step": None if ms is None else 1e3 * ms / Tv,
                "repeat_bits_equal": same, "plan": v1.chain_plan(Bv, Hv, tag),
                "plain_ms": timed(lambda: v1.blstm_v1_bwd_recur_plain(ref_g, cs, gy, lens, wh),
                                  min(reps, 1)),
                "library_ms": None if lib_f is None else lib_fb - lib_f,
                "library": library + "backward (fwd + bwd minus fwd, timed only)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if tag == "bf16" and reps:
                # the split's measurement: the same launch at 32 rows x 32 units
                # a block (half the blocks, twice the rows each block pulls)
                mt, blocks, need = row["plan"]
                with swapped(v1, "chain_plan", lambda *_: (2 * mt, blocks // 2, need)):
                    wide = timed(lambda: v1.blstm_v1_bwd_recur(ref_g, cs, gy, lens, wh), reps)
                row["us_per_step_by_split"] = {f"{16 * mt}x32": row["us_per_step"],
                                               f"{32 * mt}x32": 1e3 * wide / Tv}
            emit({"phase": "kernels", "kernel": "blstm_v1_bwd_recur", "case": case, **row})
            rows[("blstm_v1_bwd_recur", tag, case)] = row
            del dg, ref_dg, ref_g, cs, gy

            # --- row 6: dwh on uniform dgates ---------------------------------
            tol = TOL[("blstm_v1_bwd_dwh", tag)]
            dgr = u((2, Tv, Bv, H4), dtype)
            dwh = v1.blstm_v1_bwd_dwh(hs, dgr)
            hpt, d2 = hprev.transpose(1, 2), dgr.view(2, M, H4)
            # f32 is held to the float64 product (TOL), bf16 to the plain version
            ref_w = (torch.matmul(hpt.double(), d2.double()) if tag == "f32"
                     else v1.blstm_v1_bwd_dwh_plain(hs, dgr))
            err = compare(torch, dwh, ref_w, tol, f"blstm_v1_bwd_dwh {key}")
            cut = dgr.clone()
            cut[0, Tv - 1, 0] = 0  # the full-length lane's last fw token
            fault = fault_reading(v1.blstm_v1_bwd_dwh_plain(hs, cut), ref_w, tol,
                                  f"blstm_v1_bwd_dwh {key}")
            b_ms, b_by = bound(es * (2 * (Tv + 1) * Bv * Hv + 2 * M * H4) + 4 * 2 * Hv * H4,
                               2 * 2 * valid * Hv * H4, peak)
            row = {
                "shape": [Hv, M, H4], "D": D, "dtype": tag, "max_abs_err": err, "tol": tol,
                "fault_max_abs_err": fault,
                "ms": timed(lambda: v1.blstm_v1_bwd_dwh(hs, dgr), reps),
                "plain_ms": timed(lambda: v1.blstm_v1_bwd_dwh_plain(hs, dgr), reps),
                "library_ms": timed(lambda: torch.matmul(hpt, d2), reps),
                "library": "torch.matmul hprev^T @ dg (both directions)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if tag == "bf16":
                row.update(gemm_fields(torch, timed, reps, lambda: v1.blstm_v1_bwd_dwh(hs, dgr),
                                       2, Hv, H4, M, 2 * 2 * valid * Hv * H4, row["ms"],
                                       repeat=True))
            else:
                row.update(f32_gemm_fields(
                    torch, lambda: v1.blstm_v1_bwd_dwh(hs, dgr), 2, Hv, H4, M, 2,
                    2 * 2 * M * Hv * H4, row["ms"], exact=ref_w,
                    library=lambda: torch.matmul(hpt, d2)))
            emit({"phase": "kernels", "kernel": "blstm_v1_bwd_dwh", "case": case, **row})
            rows[("blstm_v1_bwd_dwh", tag, case)] = row
            del dwh, ref_w, cut, dgr, hprev, hpt, d2, hs, xw, x, x_lib, lstm
    return rows


def lstm_rows(torch, timed, reps) -> dict:
    """The unidirectional LSTM kernels at B = 32, H = 320 and the
    streaming encoder's T = 1024 (lstm_proj at D = 320, the layers past
    the first) and the prediction net's T = U + 1 = 121, bf16 and f32,
    ragged lengths: the walk with an initial carry (output and final
    carry), the training walk (output and f32 stores), the chain on the
    plain walk's residuals, dwh; each against its plain version with a
    planted fault; kernel / plain / library times and the bound. Then the
    walk with a carry at the stream's chunk of 32 frames, B = 32 and 1."""
    from nabu_tpu_torch.ops import lstm as lo

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    H4 = 4 * H
    rows = {}

    def u(shape, dtype, scale=1.0):
        return torch.as_tensor(rng.uniform(-scale, scale, shape).astype(np.float32),
                               device=dev).to(dtype)

    def walk_bound(bytes_, valid, tag):
        # the step product on the pipe the walk runs it on: f32 FFMA, or in
        # bf16 three mma.sync passes over the exact split of h beside the
        # f32 cell
        prod, cell = 2 * valid * H * H4, 12 * valid * H
        if tag == "bf16":
            return bound(bytes_, 3 * prod, PEAK_BF16, (cell, PEAK_F32))
        return bound(bytes_, prod + cell, PEAK_F32)

    for case, Tq in (("encoder", T), ("pred", 121)):
        lengths = rng.integers(max(2, Tq // 8), Tq + 1, B).astype(np.int32)
        lengths[0] = Tq
        lens = torch.as_tensor(lengths, device=dev)
        valid = int(lengths.sum())
        M = Tq * B
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            es = 2 if tag == "bf16" else 4
            key = f"{tag} {case}"
            xw = u((Tq, B, H4), dtype)
            wh = torch.as_tensor(glorot(rng, (H, H4)), device=dev).to(dtype)
            h0 = u((B, H), torch.float32, 0.5)
            c0 = u((B, H), torch.float32, 0.5)
            # library yardstick: a unidirectional cuDNN nn.LSTM layer of
            # width H on the packed [T, B, H] input, timed only (no forget
            # bias, no masking beyond the packing, projection included)
            lstm = torch.nn.LSTM(H, H).to(dev, dtype)
            x_lib = u((Tq, B, H), dtype)
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x_lib, torch.as_tensor(lengths), enforce_sorted=False)
            data_g = packed.data.detach().requires_grad_(True)
            packed_g = torch.nn.utils.rnn.PackedSequence(
                data_g, packed.batch_sizes, packed.sorted_indices, packed.unsorted_indices)
            g_lib = torch.ones((data_g.shape[0], H), device=dev, dtype=dtype)

            def lib_infer():
                with torch.no_grad():
                    return lstm(packed)[0].data

            def lib_fwd():
                return lstm(packed_g)[0].data

            def lib_fwd_bwd():
                lib_fwd().backward(g_lib)

            lib_i = timed(lib_infer, reps)
            lib_f = timed(lib_fwd, reps)
            lib_fb = timed(lib_fwd_bwd, reps)
            del data_g

            # --- the walk with an initial carry -----------------------------
            tol = TOL[("lstm_fwd", tag)]
            y, (hT, cT) = lo.lstm_fwd(xw, lens, wh, h0, c0)
            ry, (rh, rc) = lo.lstm_fwd_plain(xw, lens, wh, h0, c0)
            err = compare(torch, y, ry, tol, f"lstm_fwd {key}")
            carry_err = max(compare(torch, hT, rh, TOL["lstm_carry"], f"lstm_fwd {key} h"),
                            compare(torch, cT, rc, TOL["lstm_carry"], f"lstm_fwd {key} c"))
            fault = fault_reading(lstm_stale_walk(torch)(xw, lens, wh, h0, c0)[0], ry, tol,
                                  f"lstm_fwd {key}")
            group = lo.walk_plan(B, H)[0]
            group_fault = fault_reading(
                lstm_stale_walk(torch, group, first=group)(xw, lens, wh, h0, c0)[0], ry, tol,
                f"lstm_fwd {key} (unit group {group}..{2 * group - 1})")
            carry_fault = fault_reading(lstm_carry_not_held(torch)(xw, lens, wh, h0, c0)[1][1],
                                        rc, TOL["lstm_carry"], f"lstm_fwd {key} final c")
            b_ms, b_by = walk_bound(es * (valid * H4 + H * H4 + M * H) + 4 * (B + 4 * B * H),
                                    valid, tag)
            row = {
                "shape": [Tq, B, H], "dtype": tag, "valid_tokens": valid, "max_abs_err": err,
                "tol": tol, "carry_max_abs_err": carry_err, "carry_tol": TOL["lstm_carry"],
                "fault_max_abs_err": fault, "group_fault_max_abs_err": group_fault,
                "carry_fault_max_abs_err": carry_fault,
                "ms": timed(lambda: lo.lstm_fwd(xw, lens, wh, h0, c0), reps),
                "plain_ms": timed(lambda: lo.lstm_fwd_plain(xw, lens, wh, h0, c0),
                                  min(reps, 1)),
                "library_ms": lib_i,
                "library": "cuDNN nn.LSTM unidirectional inference, packed (projection "
                           "included; no forget bias)",
                "bound_ms": b_ms, "bound_by": b_by,
            }

            def lstm_fwd():
                return lo.lstm_fwd(xw, lens, wh, h0, c0)

            row.update(walk_fields(torch, timed, reps, lstm_fwd, (y, (hT, cT)), row["ms"], lo,
                                   Tq))
            emit({"phase": "kernels", "kernel": "lstm_fwd", "case": case, **row})
            rows[("lstm_fwd", tag, case)] = row
            del y, ry

            # --- the training walk ------------------------------------------
            got = lo.lstm_fwd_train(xw, lens, wh)
            ref = lo.lstm_fwd_train_plain(xw, lens, wh)
            err = compare(torch, got[0], ref[0], tol, f"lstm_fwd_train {key}")
            s_err = max(compare(torch, a, r, TOL["lstm_stores"], f"lstm_fwd_train {key} {n}")
                        for n, a, r in zip(("gates", "c", "h"), got[1:], ref[1:]))
            fault = fault_reading(lstm_stale_walk(torch)(xw, lens, wh)[0], ref[0], tol,
                                  f"lstm_fwd_train {key}")
            group_fault = fault_reading(
                lstm_stale_walk(torch, group, first=group)(xw, lens, wh)[0], ref[0], tol,
                f"lstm_fwd_train {key} (unit group {group}..{2 * group - 1})")
            b_ms, b_by = walk_bound(
                es * (valid * H4 + H * H4 + M * H) + 4 * B + 4 * M * (H4 + 2 * H), valid, tag)
            row = {
                "shape": [Tq, B, H], "dtype": tag, "max_abs_err": err, "tol": tol,
                "stores_max_abs_err": s_err, "stores_tol": TOL["lstm_stores"],
                "fault_max_abs_err": fault, "group_fault_max_abs_err": group_fault,
                "ms": timed(lambda: lo.lstm_fwd_train(xw, lens, wh), reps),
                "plain_ms": timed(lambda: lo.lstm_fwd_train_plain(xw, lens, wh), min(reps, 1)),
                "library_ms": lib_f,
                "library": "cuDNN nn.LSTM unidirectional training forward, packed "
                           "(projection included; no forget bias)",
                "bound_ms": b_ms, "bound_by": b_by,
            }

            def lstm_fwd_train():
                return lo.lstm_fwd_train(xw, lens, wh)

            row.update(walk_fields(torch, timed, reps, lstm_fwd_train, got, row["ms"], lo, Tq))
            row["step_probe"] = walk_probe(torch, timed, reps,
                                           lambda: lo.lstm_fwd_train_probe(xw, lens, wh), Tq, Tq)
            emit({"phase": "kernels", "kernel": "lstm_fwd_train", "case": case, **row})
            rows[("lstm_fwd_train", tag, case)] = row
            del got

            # --- the chain, on the plain walk's residuals ----------------------
            _, gates, cs, hs = ref
            gy = u((Tq, B, H), dtype)
            tol = TOL["lstm_bwd_recur"]
            dxw = lo.lstm_bwd_recur(gates, cs, gy, lens, wh)
            ref_dxw = lo.lstm_bwd_recur_plain(gates, cs, gy, lens, wh)
            err = compare(torch, dxw, ref_dxw, tol, f"lstm_bwd_recur {key}")
            fault = fault_reading(lstm_faulty_chain(torch)(gates, cs, gy, lens, wh), ref_dxw,
                                  tol, f"lstm_bwd_recur {key}")
            b_ms, b_by = bound(4 * M * (H4 + H) + es * (M * H + H * H4) + 4 * B + 4 * M * H4,
                               2 * valid * H4 * H + 30 * valid * H, PEAK_F32)
            same = torch.equal(dxw, lo.lstm_bwd_recur(gates, cs, gy, lens, wh))
            if not same:
                FAILURES.append(f"lstm_bwd_recur {key}: a second launch's bits differ")
            ms = timed(lambda: lo.lstm_bwd_recur(gates, cs, gy, lens, wh), reps)
            row = {
                "shape": [Tq, B, H], "dtype": tag, "max_abs_err": err, "tol": tol,
                "ref_max_abs": float(ref_dxw.abs().max()), "fault_max_abs_err": fault,
                "ms": ms, "us_per_step": None if ms is None else 1e3 * ms / Tq,
                "repeat_bits_equal": same, "plan": lo.chain_plan(B, H),
                "plain_ms": timed(lambda: lo.lstm_bwd_recur_plain(gates, cs, gy, lens, wh),
                                  min(reps, 1)),
                "library_ms": None if lib_f is None else lib_fb - lib_f,
                "library": "cuDNN nn.LSTM unidirectional backward, packed (fwd+bwd minus "
                           "fwd; input projection included)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit({"phase": "kernels", "kernel": "lstm_bwd_recur", "case": case, **row})
            rows[("lstm_bwd_recur", tag, case)] = row
            del dxw, gates, cs

            # --- dwh ---------------------------------------------------------
            tol = TOL["lstm_bwd_dwh"]
            dwh = lo.lstm_bwd_dwh(hs, ref_dxw)
            hprev = torch.zeros_like(hs)
            hprev[1:] = hs[:-1]
            hpt, d2 = hprev.view(M, H).t(), ref_dxw.view(M, H4)
            ref_w = torch.matmul(hpt.double(), d2.double())  # f32: float64 (TOL)
            err = compare(torch, dwh, ref_w, tol, f"lstm_bwd_dwh {key}")
            cut = ref_dxw.clone()
            cut[Tq - 1, 0] = 0  # the last token of the full-length lane
            fault = fault_reading(lo.lstm_bwd_dwh_plain(hs, cut), ref_w, tol,
                                  f"lstm_bwd_dwh {key}")
            b_ms, b_by = bound(4 * (M * H + M * H4 + H * H4), 2 * valid * H * H4, PEAK_F32)
            row = {
                "shape": [H, M - B, H4], "dtype": "f32", "max_abs_err": err, "tol": tol,
                "fault_max_abs_err": fault,
                "ms": timed(lambda: lo.lstm_bwd_dwh(hs, ref_dxw), reps),
                "plain_ms": timed(lambda: lo.lstm_bwd_dwh_plain(hs, ref_dxw), reps),
                "library_ms": timed(lambda: torch.matmul(hpt, d2), reps),
                "library": "torch.matmul h_prev^T @ dxw (f32)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            row.update(f32_gemm_fields(
                torch, lambda: lo.lstm_bwd_dwh(hs, ref_dxw), 2, H, H4, M - B, 1,
                2 * (M - B) * H * H4, row["ms"], exact=ref_w,
                library=lambda: torch.matmul(hpt, d2)))
            emit({"phase": "kernels", "kernel": "lstm_bwd_dwh", "case": case, "inputs": tag,
                  **row})
            rows[("lstm_bwd_dwh", tag, case)] = row
            del ref, hs, ref_dxw, cut, hprev, hpt, d2

            # --- the projection (the encoder's layers past the first) ----------
            if case == "encoder":
                tol = TOL[("lstm_proj", tag)]
                x = u((M, H), dtype)
                wx = torch.as_tensor(glorot(rng, (H, H4)), device=dev).to(dtype)
                bias = u((H4,), dtype, 0.1)
                got_p = lo.lstm_proj(x, wx, bias)
                ref_p = lo.lstm_proj_plain(x, wx, bias)
                err = compare(torch, got_p, ref_p, tol, f"lstm_proj {tag}")
                x_cut = x.clone()
                x_cut[:, -1] = 0
                fault = fault_reading(lo.lstm_proj_plain(x_cut, wx, bias), ref_p, tol,
                                      f"lstm_proj {tag}")
                # rows keep their bits whatever the number of rows (a chunk
                # of 32 frames against the whole sequence)
                chunk = lo.lstm_proj(x[: 32 * B].contiguous(), wx, bias)
                check(torch.equal(chunk, got_p[: 32 * B]),
                      f"lstm_proj {tag}: a chunk's rows differ from the same rows of the "
                      "whole projection")
                b_ms, b_by = bound(es * (M * H + H * H4 + H4 + M * H4), 2 * M * H * H4,
                                   PEAK_BF16 if tag == "bf16" else PEAK_F32)
                row = {
                    "shape": [M, H, H4], "dtype": tag, "max_abs_err": err, "tol": tol,
                    "fault_max_abs_err": fault, "chunk_rows_identical": True,
                    "ms": timed(lambda: lo.lstm_proj(x, wx, bias), reps),
                    "plain_ms": timed(lambda: lo.lstm_proj_plain(x, wx, bias), reps),
                    "library_ms": timed(lambda: torch.addmm(bias, x, wx), reps),
                    "library": "torch.addmm b + x @ wx",
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                if tag == "bf16":
                    row.update(gemm_fields(torch, timed, reps, lambda: lo.lstm_proj(x, wx, bias),
                                           0, M, H4, H, 2 * M * H * H4, row["ms"]))
                else:
                    row.update(f32_gemm_fields(torch, lambda: lo.lstm_proj(x, wx, bias), 0, M,
                                               H4, H, 1, 2 * M * H * H4, row["ms"]))
                emit({"phase": "kernels", "kernel": "lstm_proj", **row})
                rows[("lstm_proj", tag)] = row
                del x, got_p, ref_p, x_cut, chunk
            del lstm, xw

    # --- the stream's own shape: a 32-frame chunk with a carry, at batch
    # 32 and 1 (serve_stream's two feeds), where the launch's set-up
    # (staging wh) weighs most; each with the walk's planted faults --------
    Tc = 32
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        es = 2 if tag == "bf16" else 4
        tol = TOL[("lstm_fwd", tag)]
        wh = torch.as_tensor(glorot(rng, (H, H4)), device=dev).to(dtype)
        lstm = torch.nn.LSTM(H, H).to(dev, dtype)
        for Bc in (B, 1):
            xw = u((Tc, Bc, H4), dtype)
            h0 = u((Bc, H), torch.float32, 0.5)
            c0 = u((Bc, H), torch.float32, 0.5)
            x_lib = u((Tc, Bc, H), dtype)
            # streamed lanes at batch 32: one ends inside the chunk, one
            # ended before it (its length clamped to 0, its carry held)
            lengths = np.full((Bc,), Tc, np.int32)
            if Bc > 1:
                lengths[1], lengths[2] = rng.integers(1, Tc), 0
            lens = torch.as_tensor(lengths, device=dev)
            valid = int(lengths.sum())
            key = f"{tag} chunk B={Bc}"
            y, (hT, cT) = lo.lstm_fwd(xw, lens, wh, h0, c0)
            ry, (rh, rc) = lo.lstm_fwd_plain(xw, lens, wh, h0, c0)
            err = compare(torch, y, ry, tol, f"lstm_fwd {key}")
            carry_err = max(compare(torch, hT, rh, TOL["lstm_carry"], f"lstm_fwd {key} h"),
                            compare(torch, cT, rc, TOL["lstm_carry"], f"lstm_fwd {key} c"))
            fault = fault_reading(lstm_stale_walk(torch)(xw, lens, wh, h0, c0)[0], ry, tol,
                                  f"lstm_fwd {key}")
            group = lo.walk_plan(Bc, H)[0]
            group_fault = fault_reading(
                lstm_stale_walk(torch, group, first=group)(xw, lens, wh, h0, c0)[0], ry, tol,
                f"lstm_fwd {key} (unit group {group}..{2 * group - 1})")
            # the lone lane of batch 1 runs the whole chunk, and again as a
            # stream's last chunk, which ends inside it
            short = lens
            if Bc == 1:
                short = torch.full((1,), int(rng.integers(1, Tc)), dtype=torch.int32, device=dev)
                sy, (sh, sc) = lo.lstm_fwd(xw, short, wh, h0, c0)
                rsy, (rsh, rc) = lo.lstm_fwd_plain(xw, short, wh, h0, c0)
                err = max(err, compare(torch, sy, rsy, tol, f"lstm_fwd {key} last"))
                carry_err = max(
                    carry_err,
                    compare(torch, sh, rsh, TOL["lstm_carry"], f"lstm_fwd {key} last h"),
                    compare(torch, sc, rc, TOL["lstm_carry"], f"lstm_fwd {key} last c"))
            carry_fault = fault_reading(lstm_carry_not_held(torch)(xw, short, wh, h0, c0)[1][1],
                                        rc, TOL["lstm_carry"], f"lstm_fwd {key} final c")

            def lstm_fwd():
                return lo.lstm_fwd(xw, lens, wh, h0, c0)

            def lib_chunk():
                with torch.no_grad():
                    return lstm(x_lib)[0]

            M = Tc * Bc
            b_ms, b_by = walk_bound(es * (valid * H4 + H * H4 + M * H) + 4 * (Bc + 4 * Bc * H),
                                    valid, tag)
            row = {
                "shape": [Tc, Bc, H], "dtype": tag, "lengths": lengths.tolist(),
                "short_length": int(short[-1] if Bc == 1 else lengths[1]), "max_abs_err": err, "tol": tol,
                "carry_max_abs_err": carry_err, "carry_tol": TOL["lstm_carry"],
                "fault_max_abs_err": fault, "group_fault_max_abs_err": group_fault,
                "carry_fault_max_abs_err": carry_fault,
                "ms": timed(lstm_fwd, reps),
                "plain_ms": timed(lambda: lo.lstm_fwd_plain(xw, lens, wh, h0, c0),
                                  min(reps, 1)),
                "library_ms": timed(lib_chunk, reps),
                "library": "cuDNN nn.LSTM unidirectional inference, T = 32 (projection "
                           "included; no forget bias)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            row.update(walk_fields(torch, timed, reps, lstm_fwd, (y, (hT, cT)), row["ms"], lo,
                                   Tc, Bc))
            emit({"phase": "kernels", "kernel": "lstm_fwd", "case": f"chunk B={Bc}", **row})
            rows[("lstm_fwd", tag, f"chunk B={Bc}")] = row
            del xw, y, ry
        del lstm
    return rows


def lm_lstm_rows(torch, timed, reps) -> dict:
    """The unidirectional LSTM kernels at the RNN LM's shapes: f32, H =
    256, B = 64 sentences of ``phase_text`` (their lengths + 1, T their
    packed width): the walk with a carry, the training walk (output and
    stores), the chain on the plain walk's residuals and dwh, each against
    its plain version with its planted fault (as ``lstm_rows``), timed
    beside its plain version and its bound."""
    from nabu_tpu_torch.decoding.neural_lm import _pack
    from nabu_tpu_torch.ops import lstm as lo

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    Hq, Bq = 256, 64
    H4 = 4 * Hq
    inp, _, lengths = _pack(phase_text(29, 3)[:Bq], 30)
    Tq = inp.shape[1]
    lens = torch.as_tensor(lengths, device=dev)
    valid, M = int(lengths.sum()), Tq * Bq
    f32 = torch.float32

    def u(shape, scale=1.0):
        return torch.as_tensor(rng.uniform(-scale, scale, shape).astype(np.float32), device=dev)

    xw, wh = u((Tq, Bq, H4)), torch.as_tensor(glorot(rng, (Hq, H4)), device=dev)
    h0, c0 = u((Bq, Hq), 0.5), u((Bq, Hq), 0.5)
    walk_ops = 2 * valid * Hq * H4 + 12 * valid * Hq
    rows = {}

    def row(name, got, ref, tol, fault, bytes_, ops, fn, plain, **more):
        err = max(compare(torch, g, r, tol, f"{name} lm") for g, r in zip(got, ref))
        b_ms, b_by = bound(bytes_, ops, PEAK_F32)
        rows[(name, "f32", "lm")] = r = {
            "shape": [Tq, Bq, Hq], "dtype": "f32", "valid_tokens": valid, "max_abs_err": err,
            "tol": tol, "fault_max_abs_err": fault_reading(fault, ref[0], tol, f"{name} lm"),
            "ms": timed(fn, reps), "plain_ms": timed(plain, min(reps, 1)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **more}
        emit({"phase": "kernels", "kernel": name, "case": "lm", **r})

    tol = TOL[("lstm_fwd", "f32")]
    y, (hT, cT) = lo.lstm_fwd(xw, lens, wh, h0, c0)
    ry, (rh, rc) = lo.lstm_fwd_plain(xw, lens, wh, h0, c0)
    row("lstm_fwd", (y, hT, cT), (ry, rh, rc), tol,
        lstm_stale_walk(torch)(xw, lens, wh, h0, c0)[0],
        4 * (valid * H4 + Hq * H4 + M * Hq + 4 * Bq * Hq) + 4 * Bq, walk_ops,
        lambda: lo.lstm_fwd(xw, lens, wh, h0, c0),
        lambda: lo.lstm_fwd_plain(xw, lens, wh, h0, c0), plan=lo.walk_plan(Bq, Hq))
    got = lo.lstm_fwd_train(xw, lens, wh)
    ref = lo.lstm_fwd_train_plain(xw, lens, wh)
    row("lstm_fwd_train", got, ref, tol, lstm_stale_walk(torch)(xw, lens, wh)[0],
        4 * (valid * H4 + Hq * H4 + M * Hq + M * (H4 + 2 * Hq)) + 4 * Bq, walk_ops,
        lambda: lo.lstm_fwd_train(xw, lens, wh), lambda: lo.lstm_fwd_train_plain(xw, lens, wh))
    _, gates, cs, hs = ref
    gy = u((Tq, Bq, Hq))
    dxw = lo.lstm_bwd_recur(gates, cs, gy, lens, wh)
    ref_dxw = lo.lstm_bwd_recur_plain(gates, cs, gy, lens, wh)
    row("lstm_bwd_recur", (dxw,), (ref_dxw,), TOL["lstm_bwd_recur"],
        lstm_faulty_chain(torch)(gates, cs, gy, lens, wh),
        4 * (M * (H4 + Hq) + M * Hq + Hq * H4 + M * H4) + 4 * Bq,
        2 * valid * H4 * Hq + 30 * valid * Hq,
        lambda: lo.lstm_bwd_recur(gates, cs, gy, lens, wh),
        lambda: lo.lstm_bwd_recur_plain(gates, cs, gy, lens, wh), plan=lo.chain_plan(Bq, Hq))
    hprev = torch.zeros_like(hs)
    hprev[1:] = hs[:-1]
    exact = torch.matmul(hprev.view(M, Hq).t().double(), ref_dxw.view(M, H4).double())
    cut = ref_dxw.clone()
    cut[int(lengths.max()) - 1, int(lengths.argmax())] = 0  # the longest lane's last token
    row("lstm_bwd_dwh", (lo.lstm_bwd_dwh(hs, ref_dxw),), (exact.to(f32),), TOL["lstm_bwd_dwh"],
        lo.lstm_bwd_dwh_plain(hs, cut), 4 * (M * Hq + M * H4 + Hq * H4),
        2 * valid * Hq * H4, lambda: lo.lstm_bwd_dwh(hs, ref_dxw),
        lambda: lo.lstm_bwd_dwh_plain(hs, ref_dxw))
    return rows


def training_kernel_rows(torch, rng, tag, dtype, xw, lengths, wh, lstm, packed, timed,
                         reps) -> dict:
    """The training path's BLSTM kernels at T = 1024, B = 32, H = 320: the
    residual-writing forward, the backward chain, and the products at
    D = 80, 1280 (a Listener's pyramid layers) and 640, each against its
    plain version with a planted fault."""
    from nabu_tpu_torch.ops import blstm as bo

    dev = xw.device
    es = 2 if tag == "bf16" else 4
    peak = PEAK_BF16 if tag == "bf16" else PEAK_F32
    lens_t = torch.as_tensor(lengths, device=dev)
    valid = int(lengths.sum())
    M, H4 = T * B, 4 * H
    rows = {}

    def u(*shape):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, shape).astype(np.float32),
                               device=dev).to(dtype)

    # library yardsticks: cuDNN's bidirectional LSTM, training forward and
    # its backward (fwd + bwd minus fwd), projection included
    x_lib = packed.data.detach().requires_grad_(True)
    packed_g = torch.nn.utils.rnn.PackedSequence(
        x_lib, packed.batch_sizes, packed.sorted_indices, packed.unsorted_indices)
    g_lib = torch.ones((x_lib.shape[0], 2 * H), device=dev, dtype=dtype)

    def lib_fwd():
        return lstm(packed_g)[0].data

    def lib_fwd_bwd():
        lib_fwd().backward(g_lib)

    lib_f = timed(lib_fwd, reps)
    lib_fb = timed(lib_fwd_bwd, reps)

    # --- residual-writing forward ------------------------------------------
    got = bo.blstm_recur_train(xw, lens_t, wh)
    ref = bo.blstm_recur_train_plain(xw, lens_t, wh)
    tol = TOL[("blstm_recur_train", tag)]
    s_tol = TOL[("blstm_recur_train_stores", tag)]
    err = compare(torch, got[0], ref[0], tol, f"blstm_recur_train {tag} h")
    c_err = compare(torch, got[1], ref[1], s_tol, f"blstm_recur_train {tag} c")
    g_err = compare(torch, got[2], ref[2], s_tol, f"blstm_recur_train {tag} gates")
    fault = fault_reading(stale_recur(torch)(xw, lens_t, wh), ref[0], tol,
                          f"blstm_recur_train {tag}")
    group = bo.walk_plan(B, H)[0]
    group_fault = fault_reading(stale_recur(torch, units=group)(xw, lens_t, wh), ref[0], tol,
                                f"blstm_recur_train {tag} ({group} units)")
    c_fault = fault_reading(c_one_step_late(torch, ref[1]), ref[1], s_tol,
                            f"blstm_recur_train {tag} c")
    g_fault = fault_reading(forget_bias_folded(ref[2]), ref[2], s_tol,
                            f"blstm_recur_train {tag} gates")
    b_ms, b_by = bound(
        es * (2 * valid * H4 + 2 * H * H4 + M * 2 * H) + 4 * B + 4 * 2 * M * (H + H4),
        2 * valid * (2 * H * H4 + 12 * H), peak)

    def blstm_recur_train():
        return bo.blstm_recur_train(xw, lens_t, wh)

    row = {
        "shape": [T, B, H], "dtype": tag, "max_abs_err": err, "c_max_abs_err": c_err,
        "gates_max_abs_err": g_err, "tol": tol, "fault_max_abs_err": fault,
        "group_fault_max_abs_err": group_fault,
        "stores_tol": s_tol, "c_fault_max_abs_err": c_fault,
        "gates_fault_max_abs_err": g_fault,
        "ms": timed(blstm_recur_train, reps),
        "plain_ms": timed(lambda: bo.blstm_recur_train_plain(xw, lens_t, wh), min(reps, 1)),
        "library_ms": lib_f,
        "library": "cuDNN nn.LSTM bidirectional training forward, packed (projection "
                   "included)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row.update(walk_fields(torch, timed, reps, blstm_recur_train, got, row["ms"], bo))
    # its first step waits for nothing and is not counted
    row["step_probe"] = walk_probe(torch, timed, reps,
                                   lambda: bo.blstm_recur_train_probe(xw, lens_t, wh), T, T - 1)
    emit({"phase": "kernels", "kernel": "blstm_recur_train", **row})
    rows[("blstm_recur_train", tag)] = row

    # --- backward chain, on the plain forward's residuals -------------------
    _, c, gates = ref
    del got, ref
    gy = u(T, B, 2 * H)
    dg = bo.blstm_bwd_recur(gates, c, gy, lens_t, wh)
    ref_dg = bo.blstm_bwd_recur_plain(gates, c, gy, lens_t, wh)
    tol = TOL[("blstm_bwd_recur", tag)]
    err = compare(torch, dg, ref_dg, tol, f"blstm_bwd_recur {tag}")
    fault = fault_reading(faulty_chain(torch, stale_units=8)(gates, c, gy, lens_t, wh),
                          ref_dg, tol, f"blstm_bwd_recur {tag}")
    b_ms, b_by = bound(
        4 * 2 * M * (H4 + H) + es * (M * 2 * H + 2 * H * H4 + 2 * M * H4) + 4 * B,
        2 * valid * (2 * H4 * H + 30 * H), peak)
    same = torch.equal(dg, bo.blstm_bwd_recur(gates, c, gy, lens_t, wh))
    if not same:
        FAILURES.append(f"blstm_bwd_recur {tag}: a second launch's bits differ")
    ms = timed(lambda: bo.blstm_bwd_recur(gates, c, gy, lens_t, wh), reps)
    plan = bo.chain_plan(B, H)
    row = {
        "shape": [T, B, H], "dtype": tag, "max_abs_err": err, "tol": tol,
        "ref_max_abs": float(ref_dg.float().abs().max()), "fault_max_abs_err": fault,
        "ms": ms, "us_per_step": None if ms is None else 1e3 * ms / T,
        "repeat_bits_equal": same, "plan": plan,
        "plain_ms": timed(lambda: bo.blstm_bwd_recur_plain(gates, c, gy, lens_t, wh),
                          min(reps, 1)),
        "library_ms": None if lib_f is None else lib_fb - lib_f,
        "library": "cuDNN nn.LSTM bidirectional backward, packed (fwd+bwd minus fwd; "
                   "input projection included)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if tag == "bf16" and reps:
        # the split's measurement: every form of the plan's work a block
        # (16 mt rows x units) that fits the card, the same launch each;
        # the rows' sums do not depend on the form, so neither do the bits
        by_split, bits = {}, True
        for units, mt in bo.CHAIN_FORMS:
            form = bo.chain_plan(B, H, ((units, mt),))
            if mt * units != plan[0] * plan[1] or form is None:
                continue
            with swapped(bo, "chain_plan", lambda *_, f=form: f):
                by_split[f"{16 * mt}x{units}"] = 1e3 * timed(
                    lambda: bo.blstm_bwd_recur(gates, c, gy, lens_t, wh), reps) / T
                bits &= torch.equal(dg, bo.blstm_bwd_recur(gates, c, gy, lens_t, wh))
        row["us_per_step_by_split"] = by_split
        row["bits_equal_across_splits"] = bits
    emit({"phase": "kernels", "kernel": "blstm_bwd_recur", **row})
    rows[("blstm_bwd_recur", tag)] = row
    del gates, c, dg, ref_dg

    # --- products: dx, dwx + db, dwh ---------------------------------------
    dgr = u(2, T, B, H4)
    y = u(T, B, 2 * H)
    hprev = torch.zeros((2, T, B, H), device=dev, dtype=dtype)
    hprev[0, 1:] = y[:-1, :, :H]
    hprev[1, :-1] = y[1:, :, H:]
    dg2 = dgr.view(2, M, H4)
    tol_dw = TOL[("blstm_bwd_dw", tag)]
    for D in (2 * NFILT, 4 * H, 2 * H):
        x = u(T, B, D)
        wx = torch.as_tensor(glorot(rng, (2, D, H4)), device=dev).to(dtype)
        # dx: the last product of the reduction over 4H dropped
        tol = TOL[("blstm_bwd_dx", tag)]
        ref = bo.blstm_bwd_dx_plain(dgr, wx)
        err = compare(torch, bo.blstm_bwd_dx(dgr, wx), ref, tol, f"blstm_bwd_dx {tag} D={D}")
        cut = dgr.clone()
        cut[..., -1] = 0
        fault = fault_reading(bo.blstm_bwd_dx_plain(cut, wx), ref, tol,
                              f"blstm_bwd_dx {tag} D={D}")
        b_ms, b_by = bound(es * (2 * M * H4 + 2 * D * H4 + 2 * M * D),
                           2 * 2 * M * H4 * D, peak)
        wxt = wx.transpose(1, 2)
        row = {
            "shape": [M, H4, D], "dtype": tag, "max_abs_err": err, "tol": tol,
            "fault_max_abs_err": fault,
            "ms": timed(lambda: bo.blstm_bwd_dx(dgr, wx), reps),
            "plain_ms": timed(lambda: bo.blstm_bwd_dx_plain(dgr, wx), reps),
            "library_ms": timed(lambda: torch.matmul(dg2, wxt), reps),
            "library": "torch.matmul dg @ wx^T (both directions)",
            "bound_ms": b_ms, "bound_by": b_by,
        }
        if tag == "bf16":
            row.update(gemm_fields(torch, timed, reps, lambda: bo.blstm_bwd_dx(dgr, wx), 1, M,
                                   D, H4, 2 * 2 * M * H4 * D, row["ms"]))
        else:
            row.update(f32_gemm_fields(torch, lambda: bo.blstm_bwd_dx(dgr, wx), 1, M, D, H4, 2,
                                       2 * 2 * M * H4 * D, row["ms"]))
        emit({"phase": "kernels", "kernel": "blstm_bwd_dx", **row})
        rows[("blstm_bwd_dx", tag, D)] = row

        # dwx and db: the last token's term dropped
        dwx, db = bo.blstm_bwd_dwx(x, dgr)
        xt = x.view(M, D).t()
        # f32 is held to the float64 product (TOL), bf16 to the plain version
        if tag == "f32":
            ref_w, ref_b = torch.matmul(xt.double(), dg2.double()), dg2.double().sum(dim=1)
        else:
            ref_w, ref_b = bo.blstm_bwd_dwx_plain(x, dgr)
        err = compare(torch, dwx, ref_w, tol_dw, f"blstm_bwd_dwx {tag} D={D}")
        db_err = compare(torch, db, ref_b, tol_dw, f"blstm_bwd_dwx {tag} D={D} db")
        x_cut = x.clone()
        x_cut[-1, -1] = 0
        fault = fault_reading(bo.blstm_bwd_dwx_plain(x_cut, dgr)[0], ref_w, tol_dw,
                              f"blstm_bwd_dwx {tag} D={D}")
        cut = dgr.clone()
        cut[:, -1, -1] = 0
        db_fault = fault_reading(bo.blstm_bwd_dwx_plain(x, cut)[1], ref_b, tol_dw,
                                 f"blstm_bwd_dwx {tag} D={D} db")
        b_ms, b_by = bound(es * (M * D + 2 * M * H4) + 4 * (2 * D * H4 + 2 * H4),
                           2 * (2 * M * D * H4 + M * H4), peak)
        row = {
            "shape": [D, M, H4], "dtype": tag, "max_abs_err": err, "db_max_abs_err": db_err,
            "tol": tol_dw, "fault_max_abs_err": fault, "db_fault_max_abs_err": db_fault,
            "ms": timed(lambda: bo.blstm_bwd_dwx(x, dgr), reps),
            "plain_ms": timed(lambda: bo.blstm_bwd_dwx_plain(x, dgr), reps),
            "library_ms": timed(lambda: torch.matmul(xt, dg2), reps),
            "library": "torch.matmul x^T @ dg (both directions; db not included)",
            "bound_ms": b_ms, "bound_by": b_by,
        }
        if tag == "bf16":
            row.update(gemm_fields(torch, timed, reps, lambda: bo.blstm_bwd_dwx(x, dgr), 2, D,
                                   H4, M, 2 * (2 * M * D * H4 + M * H4), row["ms"], repeat=True))
        else:
            row.update(f32_gemm_fields(
                torch, lambda: bo.blstm_bwd_dwx(x, dgr), 2, D, H4, M, 2,
                2 * (2 * M * D * H4 + M * H4), row["ms"], exact=ref_w,
                library=lambda: torch.matmul(xt, dg2)))
        emit({"phase": "kernels", "kernel": "blstm_bwd_dwx", **row})
        rows[("blstm_bwd_dwx", tag, D)] = row

    # dwh: the last token's term dropped
    dwh = bo.blstm_bwd_dwh(y, dgr)
    hpt = hprev.view(2, M, H).transpose(1, 2)
    ref = (torch.matmul(hpt.double(), dg2.double()) if tag == "f32"
           else bo.blstm_bwd_dwh_plain(y, dgr))
    err = compare(torch, dwh, ref, tol_dw, f"blstm_bwd_dwh {tag}")
    cut = dgr.clone()
    cut[0, -1, -1] = 0
    fault = fault_reading(bo.blstm_bwd_dwh_plain(y, cut), ref, tol_dw, f"blstm_bwd_dwh {tag}")
    b_ms, b_by = bound(es * (M * 2 * H + 2 * M * H4) + 4 * 2 * H * H4,
                       2 * 2 * (M - B) * H * H4, peak)
    row = {
        "shape": [H, M - B, H4], "dtype": tag, "max_abs_err": err, "tol": tol_dw,
        "fault_max_abs_err": fault,
        "ms": timed(lambda: bo.blstm_bwd_dwh(y, dgr), reps),
        "plain_ms": timed(lambda: bo.blstm_bwd_dwh_plain(y, dgr), reps),
        "library_ms": timed(lambda: torch.matmul(hpt, dg2), reps),
        "library": "torch.matmul hprev^T @ dg (both directions)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if tag == "bf16":
        row.update(gemm_fields(torch, timed, reps, lambda: bo.blstm_bwd_dwh(y, dgr), 2, H, H4,
                               M - B, 2 * 2 * (M - B) * H * H4, row["ms"], repeat=True))
    else:
        row.update(f32_gemm_fields(
            torch, lambda: bo.blstm_bwd_dwh(y, dgr), 2, H, H4, M - B, 2,
            2 * 2 * (M - B) * H * H4, row["ms"], exact=ref,
            library=lambda: torch.matmul(hpt, dg2)))
    emit({"phase": "kernels", "kernel": "blstm_bwd_dwh", **row})
    rows[("blstm_bwd_dwh", tag)] = row
    return rows


def f32_recipe_rows(torch, timed, reps) -> dict:
    """The f32 GEMM at the BLSTM layers of the two f32 recipes, B = 32
    (``F32_RECIPE_SHAPES``): blstm_proj, dx, dwx + db and dwh, each against
    its plain version (kind 2: the product in float64, see TOL) with the
    training rows' planted fault, one PyTorch call as the yardstick (TF32
    off), the bound, its K slices and TFLOP/s; the kind-2 rows launch twice
    and must repeat their bits."""
    from nabu_tpu_torch.ops import blstm as bo

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    rows = {}

    def u(*shape, scale=1.0):
        return torch.as_tensor(rng.uniform(-scale, scale, shape).astype(np.float32), device=dev)

    for recipe, Tr, Hr, D in F32_RECIPE_SHAPES:
        M, H4 = Tr * B, 4 * Hr
        case = f"{recipe} T={Tr} H={Hr} D={D}"
        x, bias = u(Tr, B, D), u(2, H4, scale=0.1)
        wx = torch.as_tensor(glorot(rng, (2, D, H4)), device=dev)
        dg, y = u(2, Tr, B, H4), u(Tr, B, 2 * Hr)
        x2, dg2 = x.view(M, D), dg.view(2, M, H4)
        xe = x2.expand(2, M, D)
        hprev = torch.zeros((2, Tr, B, Hr), device=dev)
        hprev[0, 1:], hprev[1, :-1] = y[:-1, :, :Hr], y[1:, :, Hr:]
        hpt = hprev.view(2, M, Hr).transpose(1, 2)
        x_cut, dg_col, dg_tok = x2.clone(), dg.clone(), dg.clone()
        x_cut[:, -1] = 0  # the last reduction product of the projection
        dg_col[..., -1] = 0  # the last of dx's 4H products
        dg_tok[:, -1, -1] = 0  # the last token's term of db and dwh
        x_tok = x.clone()
        x_tok[-1, -1] = 0  # the last token's term of dwx
        tol_dw = TOL[("blstm_bwd_dw", "f32")]
        products = (
            # name, kind, (M, N, K), kernel, plain, fault, library, bytes, tol,
            # and for kind 2 the reference: the product in float64
            ("blstm_proj", 0, (M, H4, D), lambda: bo.blstm_proj(x2, wx, bias),
             lambda: bo.blstm_proj_plain(x2, wx, bias),
             lambda: bo.blstm_proj_plain(x_cut, wx, bias),
             ("torch.baddbmm b + x @ wx (both directions)",
              lambda: torch.baddbmm(bias[:, None, :], xe, wx)),
             M * D + 2 * D * H4 + 2 * H4 + 2 * M * H4, TOL[("blstm_proj", "f32")], None),
            ("blstm_bwd_dx", 1, (M, D, H4), lambda: bo.blstm_bwd_dx(dg, wx),
             lambda: bo.blstm_bwd_dx_plain(dg, wx), lambda: bo.blstm_bwd_dx_plain(dg_col, wx),
             ("torch.matmul dg @ wx^T (both directions)",
              lambda: torch.matmul(dg2, wx.transpose(1, 2))),
             2 * M * H4 + 2 * D * H4 + 2 * M * D, TOL[("blstm_bwd_dx", "f32")], None),
            ("blstm_bwd_dwx", 2, (D, H4, M), lambda: bo.blstm_bwd_dwx(x, dg),
             lambda: bo.blstm_bwd_dwx_plain(x, dg),
             lambda: (bo.blstm_bwd_dwx_plain(x_tok, dg)[0], bo.blstm_bwd_dwx_plain(x, dg_tok)[1]),
             ("torch.matmul x^T @ dg (both directions; db not included)",
              lambda: torch.matmul(x2.t(), dg2)),
             M * D + 2 * M * H4 + 2 * D * H4 + 2 * H4, tol_dw,
             lambda: (torch.matmul(x2.t().double(), dg2.double()), dg2.double().sum(dim=1))),
            ("blstm_bwd_dwh", 2, (Hr, H4, M - B), lambda: bo.blstm_bwd_dwh(y, dg),
             lambda: bo.blstm_bwd_dwh_plain(y, dg), lambda: bo.blstm_bwd_dwh_plain(y, dg_tok),
             ("torch.matmul hprev^T @ dg (both directions)", lambda: torch.matmul(hpt, dg2)),
             M * 2 * Hr + 2 * M * H4 + 2 * Hr * H4, tol_dw,
             lambda: torch.matmul(hpt.double(), dg2.double())),
        )
        for name, kind, (Mk, Nk, Kk), fn, plain, faulty, (library, lib), nbytes, tol, exact \
                in products:
            got, bad = fn(), faulty()
            ref = plain() if exact is None else exact()
            pairs = zip(got, ref, bad) if isinstance(got, tuple) else ((got, ref, bad),)
            errs, faults = [], []
            for part, (g, r, f) in zip(("", " db"), pairs):
                errs.append(compare(torch, g, r, tol, f"{name} f32 {case}{part}"))
                faults.append(fault_reading(f, r, tol, f"{name} f32 {case}{part}"))
            ops = 2 * 2 * Mk * Nk * Kk
            b_ms, b_by = bound(4 * nbytes, ops, PEAK_F32)
            row = {
                "case": case, "shape": [Mk, Nk, Kk], "dtype": "f32", "max_abs_err": errs[0],
                "tol": tol, "fault_max_abs_err": faults[0],
                "ms": timed(fn, reps), "plain_ms": timed(plain, reps),
                "library_ms": timed(lib, reps), "library": library,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if len(errs) > 1:
                row.update({"db_max_abs_err": errs[1], "db_fault_max_abs_err": faults[1]})
            row.update(f32_gemm_fields(torch, fn, kind, Mk, Nk, Kk, 2, ops, row["ms"],
                                       exact=ref[0] if isinstance(ref, tuple) else ref,
                                       library=lib))
            emit({"phase": "kernels", "kernel": name, **row})
            rows[(name, "f32", recipe, Tr, D)] = row
            del got, ref, bad
        del x, dg, y, hprev, x_cut, dg_col, dg_tok, x_tok
    return rows


# the f32 GEMM's kind-2 launches of the recipes, B = 32 (v1: 64), for
# --sweep: (launch, T, H, D); D is dwx's input width, None for dwh
F32_SWEEP = (("lstm_bwd_dwh", 1024, 320, None), ("lstm_bwd_dwh", 121, 320, None),
             ("blstm_bwd_dwh", 1024, 320, None), ("blstm_bwd_dwx", 1024, 320, 80),
             ("blstm_bwd_dwx", 1024, 320, 640), ("blstm_bwd_dwx", 1024, 320, 1280),
             ("blstm_bwd_dwx", 1024, 128, 40), ("blstm_bwd_dwx", 1024, 128, 256),
             ("blstm_bwd_dwh", 1024, 128, None), ("blstm_bwd_dwx", 1024, 256, 40),
             ("blstm_bwd_dwx", 512, 256, 1024), ("blstm_bwd_dwh", 1024, 256, None),
             ("blstm_bwd_dwh", 512, 256, None), ("blstm_v1_bwd_dwh", 1024, 512, None),
             ("blstm_v1_bwd_dwh", 512, 512, None))


def phase_sweep(torch, reps: int = 20) -> None:
    """Time each kind-2 f32 launch of ``F32_SWEEP`` at every K split S
    (1 .. MAX_SPLITS, at least one K tile a slice), ``split_k_f32`` set to
    S: one line a launch and S with the time (CUDA events, mean of
    ``reps``) and ``split_k_f32``'s cost model, then one a launch with the
    plan's S, the fastest S, and the time a K tile of one block that the
    plan's reading implies (the model's constant, ``_F32_TILE_STEP_MS``)."""
    from nabu_tpu_torch.ops import blstm as bo
    from nabu_tpu_torch.ops import blstm_v1 as v1
    from nabu_tpu_torch.ops import lstm as lo

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)

    def u(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32), device=dev)

    for launch, Tq, Hq, D in F32_SWEEP:
        Bq, H4 = (64 if launch == "blstm_v1_bwd_dwh" else B), 4 * Hq
        if launch == "lstm_bwd_dwh":
            hs, dxw = u(Tq, Bq, Hq), u(Tq, Bq, H4)
            fn, (M, K, dirs) = (lambda: lo.lstm_bwd_dwh(hs, dxw)), (Hq, (Tq - 1) * Bq, 1)
        elif launch == "blstm_bwd_dwx":
            x, dg = u(Tq, Bq, D), u(2, Tq, Bq, H4)
            fn, (M, K, dirs) = (lambda: bo.blstm_bwd_dwx(x, dg)), (D, Tq * Bq, 2)
        elif launch == "blstm_bwd_dwh":
            y, dg = u(Tq, Bq, 2 * Hq), u(2, Tq, Bq, H4)
            fn, (M, K, dirs) = (lambda: bo.blstm_bwd_dwh(y, dg)), (Hq, (Tq - 1) * Bq, 2)
        else:
            hs, dg = u(2, Tq + 1, Bq, Hq), u(2, Tq, Bq, H4)
            fn, (M, K, dirs) = (lambda: v1.blstm_v1_bwd_dwh(hs, dg)), (Hq, Tq * Bq, 2)
        N, ktiles = H4, -(-K // bo.F32_TILE_K)
        plan = bo.split_k_f32(2, M, N, K, dirs)
        case = {"launch": launch, "T": Tq, "H": Hq, "D": D, "shape": [M, N, K], "dirs": dirs}
        times = {}
        for S in range(1, min(bo.MAX_SPLITS, ktiles) + 1):
            with swapped(bo, "split_k_f32", lambda *a, S=S: S):
                times[S] = time_ms(torch, fn, reps)
            emit({"phase": "sweep", **case, "S": S, "ms": times[S],
                  "model_ms": bo._split_cost(M, N, K, dirs, S, bo._F32_MODEL)})
        tm, tn, tk, resident, _ = bo._F32_MODEL
        waves = -(-(-(-M // tm) * -(-N // tn) * dirs * plan) // resident)
        sums_ms = (2 * plan + 1) * dirs * M * N * 4 / bo._SUM_BYTES_PER_MS if plan > 1 else 0.0
        best = min(times, key=times.get)
        emit({"phase": "sweep_best", **case, "plan_S": plan, "plan_ms": times[plan],
              "best_S": best, "best_ms": times[best],
              "step_ms": (times[plan] - sums_ms) / (waves * -(-ktiles // plan)),
              "model_step_ms": bo._F32_TILE_STEP_MS})
        torch.cuda.empty_cache()


def ctc_rows(torch, timed, reps) -> dict:
    """The CTC kernels at B = 32, T = 1000, V = 29, L = 120 (S = 241):
    ragged logit lengths, one label of length 0, one infeasible example.
    Each row also prints its plan (``ctc_plan``), µs a step (the longest
    utterance walks T steps), a second timed run, whether a second launch
    repeats its bits, every form's µs a step with whether its bits equal
    the plan's (a differing launch or form fails the run), its step probe
    and the reading of a planted chunk-boundary fault."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    Bc, Tc, V, L = 32, 1000, 29, 120
    S = 2 * L + 1
    tl = rng.integers(Tc // 4, Tc + 1, Bc)
    tl[0] = Tc
    ll = np.minimum(rng.integers(L // 4, L + 1, Bc), tl // 3)
    ll[0] = L
    ll[1] = 0
    tl[2], ll[2] = 50, L  # infeasible
    labels = torch.as_tensor(rng.integers(0, V - 1, (Bc, L)), dtype=torch.int32, device=dev)
    tl_t = torch.as_tensor(tl, dtype=torch.int32, device=dev)
    ll_t = torch.as_tensor(ll, dtype=torch.int32, device=dev)
    logits = torch.as_tensor(3.0 * rng.standard_normal((Bc, Tc, V)).astype(np.float32),
                             device=dev)
    lp = torch.log_softmax(logits, -1).contiguous()
    args = (lp, tl_t, labels, ll_t)
    plan = cb.ctc_plan(S)
    alphas, lik = cb.ctc_alpha(*args, V - 1)
    posts = cb.ctc_beta(*args, alphas, lik, V - 1)
    ref_a, ref_l = cb.ctc_alpha_plain(*args, V - 1)
    ref_p = cb.ctc_beta_plain(*args, ref_a, ref_l, V - 1)
    check(float(lik[2]) == -1e4, f"ctc_alpha: infeasible ll {float(lik[2])}")
    err = compare(torch, lik, ref_l, TOL["ctc_ll"], "ctc_alpha ll")
    finite = ref_a > -1e29
    a_err = compare(torch, alphas[finite], ref_a[finite], TOL["ctc_ll"], "ctc_alpha alphas")
    p_err = compare(torch, posts, ref_p, TOL["ctc_posts"], "ctc_beta")
    with swapped(cb, "_lanes", skip_dropped(cb)):
        fault_a, fault_l = cb.ctc_alpha_plain(*args, V - 1)
        fault_p = cb.ctc_beta_plain(*args, ref_a, ref_l, V - 1)
    fault = fault_reading(fault_l, ref_l, TOL["ctc_ll"], "ctc_alpha ll")
    p_fault = fault_reading(fault_p, ref_p, TOL["ctc_posts"], "ctc_beta")
    with swapped(cb, "_emissions", chunk_boundary_late(cb, tl, plan[3], reverse=False)):
        _, chunk_l = cb.ctc_alpha_plain(*args, V - 1)
    with swapped(cb, "_emissions", chunk_boundary_late(cb, tl, plan[3], reverse=True)):
        chunk_p = cb.ctc_beta_plain(*args, ref_a, ref_l, V - 1)
    chunk_fault = fault_reading(chunk_l, ref_l, TOL["ctc_ll"], "ctc_alpha ll, chunk boundary")
    chunk_p_fault = fault_reading(chunk_p, ref_p, TOL["ctc_posts"], "ctc_beta, chunk boundary")
    del fault_a

    def alpha():
        return cb.ctc_alpha(*args, V - 1)

    def beta():
        return cb.ctc_beta(*args, alphas, lik, V - 1)

    def same(a, b):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def extra(fn, first, probe):
        """The row's plan, bits of a second launch, of the probe's build
        and of every form, every form's µs a step, the step probe."""
        repeat = same(first, fn())
        if not repeat:
            FAILURES.append(f"{fn.__name__}: a second launch's bits differ")
        probed = probe()
        check(same(first, probed[:-1] if len(probed) > 2 else probed[0]),
              f"{fn.__name__}: the probe's build changed the bits")
        fields = {"plan": plan, "repeat_bits_equal": repeat,
                  "step_probe": step_probe(torch, timed, reps, probe, cb.PROBE_PARTS, Tc)}
        if reps:
            by_form, bits = {}, True
            for k in cb.CTC_FORMS:
                try:
                    form = cb.ctc_plan(S, (k,))
                except ValueError:
                    continue
                with swapped(cb, "ctc_plan", lambda S_, forms=None, f=form: f):
                    by_form[f"{form[0]}x{form[1]}"] = 1e3 * timed(fn, reps) / Tc
                    bits &= same(first, fn())
            fields["us_per_step_by_form"] = by_form
            fields["bits_equal_across_forms"] = bits
            if not bits:
                FAILURES.append(f"{fn.__name__}: the forms' bits differ")
        return fields

    # library yardstick: F.ctc_loss (time-major log-probs), forward and
    # forward + backward
    lp_lib = lp.transpose(0, 1).detach().requires_grad_(True)
    tl_lib, ll_lib = torch.as_tensor(tl, device=dev), torch.as_tensor(ll, device=dev)

    def lib_fwd():
        return torch.nn.functional.ctc_loss(
            lp_lib, labels, tl_lib, ll_lib, blank=V - 1, reduction="sum", zero_infinity=True)

    def lib_fwd_bwd():
        lib_fwd().backward()

    lib_f = timed(lib_fwd, reps)
    lib_fb = timed(lib_fwd_bwd, reps)
    valid = int(tl.sum())
    rows = {}
    b_ms, b_by = bound(4 * (Bc * Tc * V + Bc * L + 3 * Bc + Tc * Bc * S), valid * S * 10,
                       PEAK_F32)
    ms = timed(alpha, reps)
    log_mismatches = cb.ctc_log_mismatches(dev)
    check(log_mismatches == 0, f"ctc: the kernels' log differs from logf on {log_mismatches} floats")
    rows["ctc_alpha"] = {
        "shape": [Bc, Tc, V, S], "dtype": "f32", "max_abs_err": err,
        "log_mismatches": log_mismatches,
        "alphas_max_abs_err": a_err, "tol": TOL["ctc_ll"], "fault_max_abs_err": fault,
        "chunk_fault_max_abs_err": chunk_fault,
        "ms": ms, "ms_second_run": timed(alpha, reps),
        "us_per_step": None if ms is None else 1e3 * ms / Tc,
        "plain_ms": timed(lambda: cb.ctc_alpha_plain(*args, V - 1), min(reps, 2)),
        "library_ms": lib_f, "library": "F.ctc_loss forward",
        "bound_ms": b_ms, "bound_by": b_by,
        **extra(alpha, (alphas, lik), lambda: cb.ctc_alpha_probe(*args, V - 1)),
    }
    emit({"phase": "kernels", "kernel": "ctc_alpha", **rows["ctc_alpha"]})
    b_ms, b_by = bound(4 * (Bc * Tc * V + Bc * L + 3 * Bc + 2 * Tc * Bc * S), valid * S * 14,
                       PEAK_F32)
    ms = timed(beta, reps)
    rows["ctc_beta"] = {
        "shape": [Bc, Tc, V, S], "dtype": "f32", "max_abs_err": p_err,
        "tol": TOL["ctc_posts"], "fault_max_abs_err": p_fault,
        "chunk_fault_max_abs_err": chunk_p_fault,
        "ms": ms, "ms_second_run": timed(beta, reps),
        "us_per_step": None if ms is None else 1e3 * ms / Tc,
        "plain_ms": timed(lambda: cb.ctc_beta_plain(*args, alphas, lik, V - 1),
                          min(reps, 2)),
        "library_ms": None if lib_f is None else lib_fb - lib_f,
        "library": "F.ctc_loss backward (forward + backward minus forward)",
        "bound_ms": b_ms, "bound_by": b_by,
        **extra(beta, posts, lambda: cb.ctc_beta_probe(*args, alphas, lik, V - 1)),
    }
    emit({"phase": "kernels", "kernel": "ctc_beta", **rows["ctc_beta"]})
    return rows


def rnnt_case(torch, rng, B_, T_, U_, J_, V_):
    """Full-width RNN-T loss inputs on the card: bf16 projections, ragged
    logit and target lengths (one lane of each at the full length, lanes
    with U_b = 0, a lane with logit length 0), glorot output weights."""
    dev = torch.device("cuda")
    tl = rng.integers(T_ // 4, T_ + 1, B_)
    ul = rng.integers(U_ // 4, U_ + 1, B_)
    tl[0], ul[0] = T_, U_
    ul[1] = ul[5] = 0
    tl[3] = 0
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    return dict(
        enc=f(0.5 * rng.standard_normal((B_, T_, J_))).to(torch.bfloat16),
        pred=f(0.5 * rng.standard_normal((B_, U_ + 1, J_))).to(torch.bfloat16),
        w=f(glorot(rng, (J_, V_))).to(torch.bfloat16),
        b=f(rng.uniform(-0.1, 0.1, V_)),
        targets=torch.as_tensor(rng.integers(0, V_ - 1, (B_, U_)), dtype=torch.int32,
                                device=dev),
        tlen=torch.as_tensor(ul, dtype=torch.int32, device=dev),
        llen=torch.as_tensor(tl, dtype=torch.int32, device=dev),
    )


def rnnt_widths(torch, timed, reps, tf) -> dict:
    """The joint forward, alpha and beta at the RNN-T bench line's
    vocabulary (V = 32 with the blank last: no padded column), B = 32, T'
    = 250, J = 320, at its lattice width U + 1 = 101 and at 31 and 61 (one
    and four chain warps in ``beta_plan``): the joint forward and alpha
    against their plain versions (alpha's frozen rows and lanes past U_b
    exactly), every alpha form against the plan's bits, beta's plan
    against its plain version and every form that holds U + 1 bit for
    bit; each alpha form's µs a diagonal step, each beta form's µs a
    frame. -> the readings by U + 1."""
    Bq, Tq, Jq, Vq = 32, 250, 320, 32
    blank = Vq - 1
    rng = np.random.default_rng(16)
    out = {}
    for U1 in (101, 31, 61):
        c = rnnt_case(torch, rng, Bq, Tq, U1 - 1, Jq, Vq)
        joint = (c["enc"], c["pred"], c["w"], c["b"], c["targets"], c["tlen"], c["llen"])
        lens = (c["llen"], c["tlen"])
        lpb, lpe = tf.rnnt_joint_fwd(*joint, blank)
        ref_b, ref_e = tf.rnnt_joint_fwd_plain(*joint, blank)
        what = f"U + 1 = {U1}, V = {Vq}"
        lp_err = max(compare(torch, lpb, ref_b, TOL["rnnt_lp"], f"rnnt_joint_fwd {what} lp_blank"),
                     compare(torch, lpe, ref_e, TOL["rnnt_lp"], f"rnnt_joint_fwd {what} lp_emit"))
        ref_a, ref_ll = tf.rnnt_alpha_plain(ref_b, ref_e, *lens)
        alphas, ll = tf.rnnt_alpha(ref_b, ref_e, *lens)
        lanes_ok = (torch.arange(U1, device="cuda")[None, None, :]
                    <= c["tlen"][None, :, None]).expand(Tq, Bq, U1)
        ll_err = max(compare(torch, ll, ref_ll, TOL["rnnt_ll"], f"rnnt_alpha {what} ll"),
                     compare(torch, alphas[lanes_ok], ref_a[lanes_ok], TOL["rnnt_ll"],
                             f"rnnt_alpha {what} alphas"))
        check(alpha_layout_ok(torch, tf, alphas, *lens),
              f"rnnt_alpha {what}: a frozen row or a lane past U_b differs")
        a_by_form, a_bits = alpha_forms(torch, timed, reps, tf, (ref_b, ref_e, *lens),
                                        (alphas, ll), Tq + U1 - 1)
        if not a_bits:
            FAILURES.append(f"rnnt_alpha {what}: a form's bits differ from the plan's")
        del alphas, ll
        beta_args = (ref_b, ref_e, ref_a, ref_ll, torch.ones(Bq, device="cuda"), *lens)
        want = tf.rnnt_beta_plain(*beta_args)
        gb, ge = tf.rnnt_beta(*beta_args)
        occ_err = max(compare(torch, gb, want[0], TOL["rnnt_occ"], f"rnnt_beta {what} gb"),
                      compare(torch, ge, want[1], TOL["rnnt_occ"], f"rnnt_beta {what} ge"))
        by_form, bits = {}, True
        for form in tf.BETA_FORMS:
            try:
                plan = tf.beta_plan(U1, (form,))
            except ValueError:
                continue
            with swapped(tf, "beta_plan", lambda U1_, forms=None, p=plan: p):
                got = tf.rnnt_beta(*beta_args)
                bits &= torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                by_form[f"{form[0]}x{form[1]}"] = (
                    None if not reps else 1e3 * timed(lambda: tf.rnnt_beta(*beta_args), reps) / Tq)
        if not bits:
            FAILURES.append(f"rnnt_beta {what}: a form's bits differ from the plain version's")
        out[U1] = {"joint_fwd_max_abs_err": lp_err, "beta_max_abs_err": occ_err,
                   "plan": tf.beta_plan(U1), "bits_equal_plain_every_form": bits,
                   "us_per_frame_by_form": by_form, "alpha_max_abs_err": ll_err,
                   "alpha_plan": tf.alpha_plan(U1), "alpha_bits_equal_across_forms": a_bits,
                   "alpha_us_per_step_by_form": a_by_form}
        del c, joint, lpb, lpe, ref_b, ref_e, ref_a, beta_args, want, gb, ge
    emit({"phase": "kernels", "kernel": "rnnt_widths", "shape": [Bq, Tq, None, Jq, Vq],
          "tol": {"rnnt_lp": TOL["rnnt_lp"], "rnnt_occ": TOL["rnnt_occ"],
                  "rnnt_ll": TOL["rnnt_ll"]}, "by_lanes": out})
    return out


def rnnt_rows(torch, timed, reps) -> dict:
    """The RNN-T kernels at B = 32, T' = 250, U = 120, J = 320, V = 29
    (the rnnt_char_wsj recipe's widths and its longest batches), each
    against its plain version with a planted fault; times against the
    bound and the library yardsticks; the extra peak memory of the loss's
    forward plus backward."""
    from nabu_tpu_torch.ops import transducer_fused as tf

    Bq, Tq, Uq, Jq, Vq = 32, 250, 120, 320, 29
    rng = np.random.default_rng(6)
    c = rnnt_case(torch, rng, Bq, Tq, Uq, Jq, Vq)
    blank = Vq - 1
    joint = (c["enc"], c["pred"], c["w"], c["b"], c["targets"], c["tlen"], c["llen"])
    lens = (c["llen"], c["tlen"])
    tl, ul = c["llen"].long().cpu(), c["tlen"].long().cpu()
    nodes = int((tl * (ul + 1)).sum())  # lattice nodes the data needs
    U1 = Uq + 1
    inside = ((torch.arange(Tq)[:, None, None] < tl[None, :, None])
              & (torch.arange(U1)[None, None, :] <= ul[None, :, None])).cuda()
    rows = {}

    # --- joint forward ----------------------------------------------------
    lpb, lpe = tf.rnnt_joint_fwd(*joint, blank)
    ref_b, ref_e = tf.rnnt_joint_fwd_plain(*joint, blank)
    err = max(compare(torch, lpb, ref_b, TOL["rnnt_lp"], "rnnt_joint_fwd lp_blank"),
              compare(torch, lpe, ref_e, TOL["rnnt_lp"], "rnnt_joint_fwd lp_emit"))
    w_cut = c["w"].clone()
    w_cut[-1] = 0
    fault_b, _ = tf.rnnt_joint_fwd_plain(c["enc"], c["pred"], w_cut, *joint[3:], blank)
    fault = fault_reading(fault_b, ref_b, TOL["rnnt_lp"], "rnnt_joint_fwd lp_blank")
    del fault_b, lpb, lpe
    tensor_ops = 2 * nodes * Jq * Vq
    sfu = nodes * (Jq + Vq + 1)  # tanh, exp, log (the backward)
    in_bytes = 2 * (Bq * Tq * Jq + Bq * U1 * Jq + Jq * Vq) + 4 * (Vq + Bq * Uq + 2 * Bq)
    lp_bytes = 4 * Tq * Bq * U1
    # the forward's tanh is a table read a node and joint unit (shared
    # memory), its exp and log the special function units' (V + 1 a node)
    b_ms, by = bound(in_bytes + 2 * lp_bytes, tensor_ops, PEAK_BF16,
                     (nodes * (Vq + 1), PEAK_SFU), (nodes * Jq, PEAK_SMEM_READS))
    first = tf.rnnt_joint_fwd(*joint, blank)
    repeat = all(torch.equal(x, y) for x, y in zip(first, tf.rnnt_joint_fwd(*joint, blank)))
    if not repeat:
        FAILURES.append("rnnt_joint_fwd: a second launch's bits differ")
    probed = tf.rnnt_joint_fwd_probe(*joint, blank)
    check(all(torch.equal(x, y) for x, y in zip(first, probed[:2])),
          "rnnt_joint_fwd: the probe's build changed the bits")
    tanh_mismatches = tf.rnnt_tanh_mismatches(torch.device("cuda"))
    check(tanh_mismatches == 0,
          f"rnnt_joint_fwd: the table tanh differs from bf16(tanhf) on {tanh_mismatches} inputs")
    del first, probed

    # library yardstick (partial): the materialized joint, tanh + matmul +
    # log-softmax over every node of [B, T', U+1]
    encf, predf, wf, bf_ = c["enc"], c["pred"], c["w"], c["b"]

    def lib_joint():
        h = torch.tanh(encf[:, :, None, :] + predf[:, None, :, :])
        return torch.log_softmax(torch.matmul(h, wf).float() + bf_, dim=-1)

    def joint_fwd():
        return tf.rnnt_joint_fwd(*joint, blank)

    rows["rnnt_joint_fwd"] = {
        "shape": [Bq, Tq, U1, Jq, Vq], "dtype": "bf16", "nodes": nodes, "max_abs_err": err,
        "tol": TOL["rnnt_lp"], "fault_max_abs_err": fault,
        "repeat_bits_equal": repeat, "tanh_mismatches": tanh_mismatches,
        "ms": timed(joint_fwd, reps), "ms_second_run": timed(joint_fwd, reps),
        "plain_ms": timed(lambda: tf.rnnt_joint_fwd_plain(*joint, blank), min(reps, 2)),
        "library_ms": timed(lib_joint, min(reps, 5)),
        "step_probe": step_probe(torch, timed, reps, lambda: tf.rnnt_joint_fwd_probe(
            *joint, blank), tf.JOINT_PROBE_PARTS),
        "library": "partial: the materialized joint, torch.tanh + torch.matmul + "
                   "log_softmax over [B, T', U+1, V]",
        "bound_ms": b_ms, "bound_by": by,
        "bound_counts": "bytes; 2 J V FLOP a node (bf16 tensor cores); V + 1 exp and log a "
                        "node (special function units); J tanh table reads a node "
                        "(shared memory, 32 a clock an SM)",
    }
    emit({"phase": "kernels", "kernel": "rnnt_joint_fwd", **rows["rnnt_joint_fwd"]})

    # --- alpha --------------------------------------------------------------
    alphas, ll = tf.rnnt_alpha(ref_b, ref_e, *lens)
    ref_a, ref_ll = tf.rnnt_alpha_plain(ref_b, ref_e, *lens)
    check(float(ll[3]) == tf.NEG, f"rnnt_alpha: empty lane ll {float(ll[3])}")
    lanes_ok = (torch.arange(U1, device="cuda")[None, None, :]
                <= c["tlen"][None, :, None]).expand(Tq, Bq, U1)
    err = compare(torch, ll, ref_ll, TOL["rnnt_ll"], "rnnt_alpha ll")
    a_err = compare(torch, alphas[lanes_ok], ref_a[lanes_ok], TOL["rnnt_ll"],
                    "rnnt_alpha alphas")
    _, fault_ll = rnnt_emit_dropped(tf)(ref_b, ref_e, *lens)
    fault = fault_reading(fault_ll, ref_ll, TOL["rnnt_ll"], "rnnt_alpha ll")
    _, late_ll = rnnt_alpha_neighbour_late(torch, tf)(ref_b, ref_e, *lens)
    late_fault = fault_reading(late_ll, ref_ll, TOL["rnnt_ll"],
                               "rnnt_alpha ll, the lane below one diagonal late")
    layout_ok = alpha_layout_ok(torch, tf, alphas, *lens)
    check(layout_ok, "rnnt_alpha: a frozen row differs from row T_b - 1 or a lane past U_b "
                     "is not NEG")
    # a reading, not a gate: each ll against the plain closed form in
    # float64 on the same rows (feasible lattices)
    _, ll64 = tf.rnnt_alpha_plain(ref_b.double(), ref_e.double(), *lens)
    feasible = c["llen"] > 0
    ll_vs_f64 = {"kernel": float((ll.double() - ll64)[feasible].abs().max()),
                 "plain": float((ref_ll.double() - ll64)[feasible].abs().max())}
    del fault_ll, late_ll, ll64

    def alpha():
        return tf.rnnt_alpha(ref_b, ref_e, *lens)

    alpha_repeat = all(torch.equal(x, y) for x, y in zip((alphas, ll), alpha()))
    if not alpha_repeat:
        FAILURES.append("rnnt_alpha: a second launch's bits differ")
    check(all(torch.equal(x, y) for x, y in zip((alphas, ll), tf.rnnt_alpha_probe(
        ref_b, ref_e, *lens)[:2])), "rnnt_alpha: the probe's build changed the bits")
    steps = Tq + Uq  # the longest lattice's diagonals
    a_by_form, a_form_bits = alpha_forms(torch, timed, reps, tf, (ref_b, ref_e, *lens),
                                         (alphas, ll), steps)
    if not a_form_bits:
        FAILURES.append("rnnt_alpha: the forms' bits differ")
    alpha_ms = timed(alpha, reps)
    rows_bytes = 4 * Tq * Bq * U1
    # per node: a sum, a logaddexp (exp + log1p) and a few f32 operations
    b_ms, by = bound(3 * rows_bytes + 4 * 3 * Bq, nodes * 8, PEAK_F32, (nodes * 2, PEAK_SFU))

    # --- beta -------------------------------------------------------------------
    g = torch.ones(Bq, device="cuda")
    gb, ge = tf.rnnt_beta(ref_b, ref_e, ref_a, ref_ll, g, *lens)
    ref_gb, ref_ge = tf.rnnt_beta_plain(ref_b, ref_e, ref_a, ref_ll, g, *lens)
    b_err = max(compare(torch, gb, ref_gb, TOL["rnnt_occ"], "rnnt_beta gb"),
                compare(torch, ge, ref_ge, TOL["rnnt_occ"], "rnnt_beta ge"))
    fault_gb, _ = rnnt_beta_read_early(torch, tf)(ref_b, ref_e, ref_a, ref_ll, g, *lens)
    b_fault = fault_reading(fault_gb, ref_gb, TOL["rnnt_occ"], "rnnt_beta gb")
    del fault_gb, gb, ge
    # per node: the alpha walk's work plus two occupancies (an exp each)
    bb_ms, bb_by = bound(5 * rows_bytes + 4 * 4 * Bq, nodes * 14, PEAK_F32,
                         (nodes * 4, PEAK_SFU))

    # library yardstick: torchaudio's RNN-T loss on the materialized f32
    # lattice (forward, and forward + backward minus forward), where it
    # imports; logit lengths of 0 raised to 1 for it
    lib_a = lib_b = None
    library = "torchaudio not importable on this machine"
    try:
        from torchaudio.functional import rnnt_loss
    except Exception as e:  # noqa: BLE001 (a yardstick only: any import failure)
        library = f"torchaudio.functional.rnnt_loss not importable ({type(e).__name__})"
    else:
        with torch.no_grad():
            lat = (torch.matmul(torch.tanh(encf[:, :, None, :] + predf[:, None, :, :]), wf)
                   .float() + bf_)
        lat_g = lat.detach().requires_grad_(True)
        ta_args = (c["targets"], torch.clamp(c["llen"], min=1), c["tlen"])

        def ta_fwd():
            with torch.no_grad():
                return rnnt_loss(lat, *ta_args, blank=blank, reduction="sum")

        def ta_fwd_bwd():
            rnnt_loss(lat_g, *ta_args, blank=blank, reduction="sum").backward()

        lib_a = timed(ta_fwd, reps)
        lib_fb = timed(ta_fwd_bwd, reps)
        lib_b = None if lib_a is None else lib_fb - lib_a
        library = "torchaudio.functional.rnnt_loss on the materialized f32 lattice"
        del lat, lat_g
    rows["rnnt_alpha"] = {
        "shape": [Tq, Bq, U1], "dtype": "f32", "max_abs_err": err, "alphas_max_abs_err": a_err,
        "tol": TOL["rnnt_ll"], "fault_max_abs_err": fault,
        "fault_neighbour_late_max_abs_err": late_fault, "layout_exact": layout_ok,
        "ll_vs_float64": ll_vs_f64, "plan": tf.alpha_plan(U1),
        "repeat_bits_equal": alpha_repeat, "ms": alpha_ms, "ms_second_run": timed(alpha, reps),
        "us_per_step": None if alpha_ms is None else 1e3 * alpha_ms / steps,
        "us_per_step_by_form": a_by_form, "bits_equal_across_forms": a_form_bits,
        "step_probe": step_probe(torch, timed, reps, lambda: tf.rnnt_alpha_probe(
            ref_b, ref_e, *lens), tf.ALPHA_PROBE_PARTS, steps),
        "plain_ms": timed(lambda: tf.rnnt_alpha_plain(ref_b, ref_e, *lens), min(reps, 2)),
        "library_ms": lib_a, "library": library + " (forward)",
        "bound_ms": b_ms, "bound_by": by,
    }
    emit({"phase": "kernels", "kernel": "rnnt_alpha", **rows["rnnt_alpha"]})
    beta_args = (ref_b, ref_e, ref_a, ref_ll, g, *lens)

    def beta():
        return tf.rnnt_beta(*beta_args)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    first = beta()
    beta_repeat = same(first, beta())
    if not beta_repeat:
        FAILURES.append("rnnt_beta: a second launch's bits differ")
    check(same(first, tf.rnnt_beta_probe(*beta_args)[:2]),
          "rnnt_beta: the probe's build changed the bits")
    log1p_mismatches = tf.rnnt_log1p_mismatches(torch.device("cuda"))
    check(log1p_mismatches == 0,
          f"rnnt_beta: the kernel's log1p differs from log1pf on {log1p_mismatches} floats")
    by_form, form_bits = {}, True
    for form in tf.BETA_FORMS:
        try:
            plan = tf.beta_plan(U1, (form,))
        except ValueError:
            continue
        with swapped(tf, "beta_plan", lambda U1_, forms=None, p=plan: p):
            by_form[f"{form[0]}x{form[1]}"] = (None if not reps else
                                               1e3 * timed(beta, reps) / Tq)
            form_bits &= same(first, beta())
    if not form_bits:
        FAILURES.append("rnnt_beta: the forms' bits differ")
    del first
    beta_ms = timed(beta, reps)
    rows["rnnt_beta"] = {
        "shape": [Tq, Bq, U1], "dtype": "f32", "max_abs_err": b_err, "tol": TOL["rnnt_occ"],
        "fault_max_abs_err": b_fault, "plan": tf.beta_plan(U1),
        "repeat_bits_equal": beta_repeat, "log1p_mismatches": log1p_mismatches,
        "ms": beta_ms, "ms_second_run": timed(beta, reps),
        "us_per_frame": None if beta_ms is None else 1e3 * beta_ms / Tq,
        "us_per_frame_by_form": by_form, "bits_equal_across_forms": form_bits,
        "step_probe": step_probe(torch, timed, reps, lambda: tf.rnnt_beta_probe(*beta_args),
                                 tf.BETA_PROBE_PARTS, Tq),
        "plain_ms": timed(lambda: tf.rnnt_beta_plain(*beta_args), min(reps, 2)),
        "library_ms": lib_b, "library": library + " (backward: forward + backward minus "
                                                  "forward)",
        "bound_ms": bb_ms, "bound_by": bb_by,
    }
    emit({"phase": "kernels", "kernel": "rnnt_beta", **rows["rnnt_beta"]})

    # --- joint backward -------------------------------------------------------
    bwd_args = (*joint, ref_gb, ref_ge, blank)
    got = tf.rnnt_joint_bwd(*bwd_args)
    ref = tf.rnnt_joint_bwd_plain(*bwd_args)
    errs = {n: compare(torch, a, r, TOL["rnnt_grad"], f"rnnt_joint_bwd {n}")
            for n, a, r in zip(("denc", "dpred", "dw", "db"), got, ref)}
    again = tf.rnnt_joint_bwd(*bwd_args)
    check(all(torch.equal(a, r) for a, r in zip(got, again)),
          "rnnt_joint_bwd: two runs differ (the reduction order must be fixed)")
    fault = fault_reading(rnnt_last_frame_out_of_dpred(torch, tf)(*bwd_args)[1], ref[1],
                          TOL["rnnt_grad"], "rnnt_joint_bwd dpred")
    del got, again
    grad_bytes = 4 * (Bq * Tq * Jq + Bq * U1 * Jq + Jq * Vq + Vq)
    # three products of the joint's size, its tanh and softmax again, and
    # per node and joint unit the derivative, dx and its two sums
    jb_ms, jb_by = bound(in_bytes + 2 * lp_bytes + grad_bytes, 3 * tensor_ops, PEAK_BF16,
                         (sfu, PEAK_SFU), (nodes * Jq * 4, PEAK_F32))
    # library yardstick (partial): the materialized joint's backward
    # through autograd, for a given dlogits (forward + backward minus
    # forward)
    e_g = encf.detach().requires_grad_(True)
    p_g = predf.detach().requires_grad_(True)
    w_g = wf.detach().requires_grad_(True)
    dl = torch.randn((Bq, Tq, U1, Vq), device="cuda", dtype=torch.bfloat16)

    def lib_bwd():
        h = torch.tanh(e_g[:, :, None, :] + p_g[:, None, :, :])
        torch.matmul(h, w_g).backward(dl)

    def lib_fwd():
        with torch.no_grad():
            return torch.matmul(torch.tanh(e_g[:, :, None, :] + p_g[:, None, :, :]), w_g)

    lib_fb = timed(lib_bwd, min(reps, 5))
    lib_f = timed(lib_fwd, min(reps, 5))
    rows["rnnt_joint_bwd"] = {
        "shape": [Bq, Tq, U1, Jq, Vq], "dtype": "bf16", "nodes": nodes,
        "max_abs_err": max(errs.values()), "errs": errs, "tol": TOL["rnnt_grad"],
        "ref_max_abs": {n: float(r.abs().max()) for n, r in zip(("denc", "dpred", "dw", "db"),
                                                                   ref)},
        "fault_max_abs_err": fault,
        "plan": dict(zip(("F", "C", "partial_bytes"), tf.joint_bwd_plan(Bq, Tq, U1, Jq))),
        "ms": timed(lambda: tf.rnnt_joint_bwd(*bwd_args), reps),
        "plain_ms": timed(lambda: tf.rnnt_joint_bwd_plain(*bwd_args), min(reps, 2)),
        "library_ms": None if lib_f is None else lib_fb - lib_f,
        "library": "partial: the materialized joint's backward through autograd "
                   "(tanh + matmul, forward + backward minus forward)",
        "bound_ms": jb_ms, "bound_by": jb_by,
    }
    emit({"phase": "kernels", "kernel": "rnnt_joint_bwd", **rows["rnnt_joint_bwd"]})
    del ref, e_g, p_g, w_g, dl
    rnnt_widths(torch, timed, reps, tf)

    # --- the loss's forward + backward: its extra peak device memory --------
    leaves = [t.detach().requires_grad_(True) for t in (c["enc"], c["pred"], c["w"], c["b"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nll = tf.transducer_loss_fused(*leaves, c["llen"], c["targets"], c["tlen"])
    nll.sum().backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(extra < RNNT_LOSS_LIMIT[Tq],
          f"rnnt loss: {extra} bytes of extra peak memory (limit {RNNT_LOSS_LIMIT[Tq]})")
    check(bool(torch.isfinite(nll).all()), "rnnt loss: non-finite nll")
    emit({"phase": "kernels", "kernel": "rnnt_loss", "T": Tq, "extra_peak_bytes": extra,
          "limit_bytes": RNNT_LOSS_LIMIT[Tq], "materialized_h_bytes": 2 * Bq * Tq * U1 * Jq,
          "joint_bwd_plan": dict(zip(("F", "C", "partial_bytes"),
                                     tf.joint_bwd_plan(Bq, Tq, U1, Jq))),
          "fwd_bwd_ms": timed(lambda: tf.transducer_loss_fused(
              *leaves, c["llen"], c["targets"], c["tlen"]).sum().backward(), reps)})
    del leaves, nll, c

    # the streaming recipe's lattice: no subsampling, T' up to 1000
    Ts = 1000
    c = rnnt_case(torch, np.random.default_rng(16), Bq, Ts, Uq, Jq, Vq)
    leaves = [t.detach().requires_grad_(True) for t in (c["enc"], c["pred"], c["w"], c["b"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nll = tf.transducer_loss_fused(*leaves, c["llen"], c["targets"], c["tlen"])
    nll.sum().backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(nll).all()), "rnnt loss (T' = 1000): non-finite nll")
    check(extra < RNNT_LOSS_LIMIT[Ts],
          f"rnnt loss (T' = 1000): {extra} bytes of extra peak memory "
          f"(limit {RNNT_LOSS_LIMIT[Ts]})")
    emit({"phase": "kernels", "kernel": "rnnt_loss", "T": Ts, "extra_peak_bytes": extra,
          "limit_bytes": RNNT_LOSS_LIMIT[Ts], "materialized_h_bytes": 2 * Bq * Ts * U1 * Jq,
          "joint_bwd_plan": dict(zip(("F", "C", "partial_bytes"),
                                     tf.joint_bwd_plan(Bq, Ts, U1, Jq))),
          "fwd_bwd_ms": timed(lambda: tf.transducer_loss_fused(
              *leaves, c["llen"], c["targets"], c["tlen"]).sum().backward(), reps)})
    return rows


def phase_serve(torch, smi: str) -> dict:
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.ops import stft_mel as stft_ops
    from nabu_tpu_torch.serving import load_exported, serve

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        art = os.path.join(tmp, "export")
        manifest = write_artifact(art, seed=2)
        # the backlog sorted by duration, as a batch scorer sorts it: the
        # short half and the long half land in two T buckets
        lines, audio_seconds = synth_requests(tmp, rng)

        t0 = time.perf_counter()
        model = load_exported(art, batch_size=B)
        load_s = time.perf_counter() - t0
        check(model.device.type == "cuda", "serve: model not on the card")
        check(model.device_fe is not None, "serve: no device frontend")

        # per-stage wall time: wrap the three stages with synchronizing timers
        stage = {"frontend": 0.0, "encoder": 0.0, "decode": 0.0}

        def timer(name, fn):
            def wrapped(*a, **kw):
                torch.cuda.synchronize()
                s = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                stage[name] += time.perf_counter() - s
                return out
            return wrapped

        fe, mdl, rec = model.device_fe, model.model, model.recognizer
        fe.batch_features = timer("frontend", fe.batch_features)
        frames_seen = set()
        apply = mdl.apply

        def apply_seen(params, feats, *a, **kw):
            frames_seen.add(int(feats.shape[1]))
            return apply(params, feats, *a, **kw)

        mdl.apply = timer("encoder", apply_seen)
        rec.decode_logprobs = timer("decode", rec.decode_logprobs)

        # requests arrive as a file: select() reports it readable, so
        # serve() micro-batches them up to batch_size, as it would a pipe
        # holding a queue's backlog
        requests = os.path.join(tmp, "requests.scp")
        with open(requests, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(requests) as in_stream:
            served = serve(art, in_stream=in_stream, out_stream=out,
                           batch_size=B, model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        gemm_variants("serve")

        texts = out.getvalue().splitlines()
        check(served == 64 and len(texts) == 64, f"serve: {served} served, {len(texts)} lines")
        alphabet = set(model.text_proc.alphabet) | {" "}
        for line, want in zip(texts, lines):
            utt = want.split()[0]
            check(line.split(" ", 1)[0] == utt, f"serve: line {line!r} is not for {utt}")
            check(set(line[len(utt):].replace("<space>", " ")) <= alphabet,
                  f"serve: unexpected symbols in {line!r}")
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"serve: kernel {name} never launched")
        batches = (64 + B - 1) // B
        check(len(frames_seen) == 2, f"serve: T buckets {sorted(frames_seen)}, want 2")
        check(launches["stft_mel"] == batches,
              f"serve: {launches['stft_mel']} frontend launches for {batches} batches")
        emit({
            "phase": "serve", "utterances": served, "audio_seconds": audio_seconds,
            "wall_seconds": wall, "load_seconds": load_s,
            "rtf": wall / audio_seconds, "utterances_per_second": served / wall,
            "stage_seconds": stage, "launches": launches, "batches": batches,
            "frames_per_batch": sorted(frames_seen),
            "batch_size": B, "card": smi, "manifest": manifest,
        })

        # one batch: kernel path against plain path, card decode against CPU
        from nabu_tpu_torch.data.audio_io import load_audio

        sigs = [load_audio(line.split()[1])[0] for line in lines[:B]]
        del rec.decode_logprobs, mdl.apply, fe.batch_features  # drop the timers
        fe = model.device_fe

        def features():
            return fe.batch_features(sigs, 16000.0, B, model.T_BUCKET)

        feats_k, flens = features()
        with plain_versions():
            feats_p, _ = features()
        with plain_versions(stft_mel=drop_last_tap(stft_ops.stft_mel_plain)):
            feats_f, _ = features()
        feat_err = compare(torch, feats_k, feats_p, TOL["features"], "serve features")
        feat_fault = fault_reading(feats_f, feats_p, TOL["features"], "serve features")
        lens = torch.as_tensor(flens, device=dev)
        mask = (torch.arange(feats_k.shape[1], device=dev)[None, :] < lens[:, None])[..., None]

        def logits(feats):
            return mdl.apply(model.params, feats, lens)["decoder"]

        # encoder + head, kernel path against plain path. The planted fault
        # it must reject is the carry not held past a length; an h read one
        # step late is read too but not required to fail here: through
        # these weights its trace in the logits is about one bf16 step
        # (PERF.md), and the recurrence check above is its guard
        def logits():
            return mdl.apply(model.params, feats_k, lens)["decoder"]

        logits_k, llen = logits()
        with plain_versions():
            logits_p, _ = logits()
        with plain_versions(blstm_recur=carry_not_held(torch)):
            logits_f, _ = logits()
        with plain_versions(blstm_recur=stale_recur(torch)):
            logits_s, _ = logits()
        mask = (torch.arange(logits_k.shape[1], device=dev)[None, :] < lens[:, None])[..., None]
        logit_err = compare(torch, logits_k * mask, logits_p * mask,
                            TOL["logits_bf16"], "serve logits (bf16)")
        logit_fault = fault_reading(logits_f * mask, logits_p * mask,
                                    TOL["logits_bf16"], "serve logits (bf16)")
        logit_stale = excess(logits_s * mask, logits_p * mask, TOL["logits_bf16"])[0]
        logprobs = torch.log_softmax(logits_k, -1)
        seq_g, len_g, sc_g = rec.decode_logprobs(logprobs, llen)
        seq_c, len_c, sc_c = rec.decode_logprobs(logprobs.cpu(), llen.cpu())
        same = sum(
            int(torch.equal(len_g[b, 0].cpu(), len_c[b, 0])
                and torch.equal(seq_g[b, 0, : int(len_c[b, 0])].cpu(),
                                seq_c[b, 0, : int(len_c[b, 0])]))
            for b in range(B)
        )
        score_err = float((sc_g[:, 0].cpu() - sc_c[:, 0]).abs().max())
        check(same == B, f"serve: card and CPU beam search differ on {B - same}/{B}")
        check(score_err <= 1e-3, f"serve: beam scores differ by {score_err}")
        emit({"phase": "serve_check", "feature_max_abs_err": feat_err,
              "feature_fault_max_abs_err": feat_fault, "features_tol": TOL["features"],
              "logit_max_abs_err": logit_err, "logit_fault_max_abs_err": logit_fault,
              "logit_stale_h_max_abs_err": logit_stale,
              "logits_tol": TOL["logits_bf16"],
              "beam_best_identical": same, "beam_score_max_abs_err": score_err,
              "frames": int(feats_k.shape[1])})

        # the LM-fused pass: ctc_beam over the float64 log-probs of the card's
        # logits for the shortest utterances
        from nabu_tpu_torch.decoding.recognizers import Nbest

        n = ATT_CHECK_UTTS
        f_n, l_n = fe.batch_features(sigs[:n], 16000.0, n, model.T_BUCKET)
        logits_n, llen_n = mdl.apply(model.params, f_n, torch.as_tensor(l_n, device=dev))[
            "decoder"]
        lp_n = torch.log_softmax(logits_n.double(), -1)

        def ctc_search(r, device):
            seqs, lengths, scores = r.decode_logprobs(lp_n.to(device), llen_n.to(device))
            k = r.nbest
            return Nbest(ids=seqs[:, :k].cpu().numpy(), lengths=lengths[:, :k].cpu().numpy(),
                         scores=scores[:, :k].cpu().numpy())

        lm_run = lm_fused_pass(torch, smi, "serve", model, lines, tmp, 3, ctc_search)
        rnn_run = lm_fused_pass(torch, smi, "serve", model, lines, tmp, 3, ctc_search,
                                kind="rnn")
        bf16_run = bf16_frontend_batch(torch, smi, art, model, lines, tmp)
    return {"launches": launches, "batches": batches, "lm": lm_run, "rnn_lm": rnn_run,
            "bf16_frontend": bf16_run}


def bf16_frontend_batch(torch, smi: str, art: str, model, lines, tmp: str) -> dict:
    """The serve phase's first batch through the artifact as it is (f32
    DFT operands) and through a copy whose features section sets
    ``frontend_dft_dtype = bf16``: the RTF of each (launch counts zeroed
    just before and read just after; the bf16 batch must launch
    ``stft_mel_bf16`` and not the f32 kernel), and the number of texts that
    differ (a reading, not a gate)."""
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.data import audio_io
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.serving import load_exported

    art16 = os.path.join(tmp, "export_bf16")
    shutil.copytree(art, art16)
    cfg = ConfigFile.read(os.path.join(art16, "frontend.cfg"))
    cfg.section("features").set("frontend_dft_dtype", "bf16")
    cfg.write(os.path.join(art16, "frontend.cfg"))
    model16 = load_exported(art16, batch_size=B)
    check(model16.device_fe.dft_dtype == "bf16", "serve bf16: the frontend is not bf16")
    paths = [line.split()[1] for line in lines[:B]]
    audio_seconds = sum(len(audio_io.load_audio(p)[0]) / 16000.0 for p in paths)

    def served(m):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        texts = m.recognize_files(paths)
        torch.cuda.synchronize()
        return texts, time.perf_counter() - t, {
            k: v for k, v in kernels.launch_counts().items() if v}

    served(model16)  # the new model's first batch (its set-up) untimed
    # f32, bf16, bf16, f32: each mode's RTF is the mean of its two
    runs = [served(m) for m in (model, model16, model16, model)]
    (texts, _, launches_f32), (texts16, _, launches) = runs[:2]
    walls = [run[1] for run in runs]
    wall, wall16 = (walls[0] + walls[3]) / 2, (walls[1] + walls[2]) / 2
    for (_, _, got), want in zip(runs, (launches_f32, launches, launches, launches_f32)):
        check(got == want, f"serve bf16: launches {got}, want {want}")
    check(launches.get("stft_mel_bf16") == 1 and "stft_mel" not in launches,
          f"serve bf16: launches {launches}")
    check(launches_f32.get("stft_mel") == 1 and "stft_mel_bf16" not in launches_f32,
          f"serve f32: launches {launches_f32}")
    out = {"phase": "serve_bf16_frontend", "batch": len(paths), "audio_seconds": audio_seconds,
           "rtf": wall16 / audio_seconds, "f32_rtf": wall / audio_seconds,
           "wall_seconds": wall16, "f32_wall_seconds": wall,
           "walls_f32_bf16_bf16_f32": walls,
           "texts_differ": sum(int(a != b) for a, b in zip(texts, texts16)),
           "launches": launches, "f32_launches": launches_f32, "card": smi}
    emit(out)
    return {"launches": launches}


def phase_serve_rnnt(torch, smi: str) -> dict:
    """A full-width rnnt_char_wsj artifact (seeded random weights) serves
    64 synthesized utterances of 1-15 s through ``serving.serve`` at batch
    32 with the recipe's transducer_beam recognizer (width 8). The serving
    kernels must run and no loss kernel; one batch's n-best on the card
    must equal the same search on the CPU over the same encoder output,
    both in float64."""
    from nabu_tpu_torch.data import audio_io
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.serving import load_exported, serve

    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rnnt_") as tmp:
        art = os.path.join(tmp, "export")
        manifest = write_artifact(art, seed=8, recipe=RNNT_RECIPE)
        lines, audio_seconds = synth_requests(tmp, rng)
        model = load_exported(art, batch_size=B)
        rec = model.recognizer
        check(model.device.type == "cuda", "serve_rnnt: model not on the card")
        check(type(rec).__name__ == "TransducerBeamRecognizer" and rec.beam_width == 8,
              f"serve_rnnt: recognizer {type(rec).__name__}")
        requests = os.path.join(tmp, "requests.scp")
        with open(requests, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(requests) as in_stream:
            served = serve(art, in_stream=in_stream, out_stream=out, batch_size=B, model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        gemm_variants("serve_rnnt")
        texts = out.getvalue().splitlines()
        check(served == 64 and len(texts) == 64,
              f"serve_rnnt: {served} served, {len(texts)} lines")
        alphabet = set(model.text_proc.alphabet) | {" "}
        for line, want in zip(texts, lines):
            utt = want.split()[0]
            check(line.split(" ", 1)[0] == utt, f"serve_rnnt: line {line!r} is not for {utt}")
            check(set(line[len(utt):].replace("<space>", " ")) <= alphabet,
                  f"serve_rnnt: unexpected symbols in {line!r}")
        # the head's precompute is the fixed-order projection (lstm_proj)
        rnnt_kernels = SERVE_KERNELS + ("lstm_proj",)
        for name in rnnt_kernels:
            check(launches[name] > 0, f"serve_rnnt: kernel {name} never launched")
        for name in kernels.KERNELS:
            if name not in rnnt_kernels:
                check(launches[name] == 0,
                      f"serve_rnnt: {launches[name]} launches of {name} while serving")
        nonempty = sum(1 for t in texts if t.split(" ", 1)[1:] and t.split(" ", 1)[1].strip())
        emit({"phase": "serve_rnnt", "utterances": served, "audio_seconds": audio_seconds,
              "wall_seconds": wall, "rtf": wall / audio_seconds,
              "utterances_per_second": served / wall, "launches": launches,
              "nonempty_hypotheses": nonempty, "batch_size": B, "beam_width": rec.beam_width,
              "card": smi, "manifest": manifest})

        # one batch (the 32 shortest): the search on the card against the
        # same search on the CPU over the same encoder output, in float64
        # (weights and encoder output upcast): in bf16 or f32 each device
        # rounds its matmuls and sums in its own order, and the beam's
        # top-8 cut over 240 candidates then reorders near-tied
        # hypotheses (the bf16 agreement is read and reported too)
        sigs = [audio_io.load_audio(line.split()[1])[0] for line in lines[:B]]
        feats, flens = model.device_fe.batch_features(sigs, 16000.0, B, model.T_BUCKET)
        encoded, enc_lengths, head = rec._encode(model.params, feats, flens)
        bf16 = nbest_agreement(rec.nbest_of(*rec.search(head, encoded, enc_lengths)),
                               rec.nbest_of(*rec.search(tree_to(head, "cpu", torch.bfloat16),
                                                        encoded.cpu(), enc_lengths.cpu())))
        dt = torch.float64
        t0 = time.perf_counter()
        card = rec.nbest_of(*rec.search(tree_to(head, encoded.device, dt), encoded.to(dt),
                                        enc_lengths))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = rec.nbest_of(*rec.search(tree_to(head, "cpu", dt), encoded.to("cpu", dt),
                                        enc_lengths.cpu()))
        t2 = time.perf_counter()
        same, score_err = nbest_agreement(card, host)
        emit({"phase": "serve_rnnt_check", "nbest_identical": same, "batch": B,
              "nbest": int(host.ids.shape[1]), "score_max_abs_err": score_err,
              "score_tol": TOL["rnnt_scores"], "dtype": "float64",
              "bf16_nbest_identical": bf16[0], "bf16_score_max_abs_err": bf16[1],
              "frames": int(encoded.shape[1]), "card_search_s": t1 - t0,
              "cpu_search_s": t2 - t1})
        check(same == B, f"serve_rnnt: card and CPU n-best differ on {B - same}/{B}")
        check(score_err <= TOL["rnnt_scores"],
              f"serve_rnnt: n-best scores differ by {score_err}")
        n = ATT_CHECK_UTTS
        search = float64_search(torch, *rec._encode(model.params, *model.device_fe.batch_features(
            sigs[:n], 16000.0, n, model.T_BUCKET)))
        lm_run = lm_fused_pass(torch, smi, "serve_rnnt", model, lines, tmp, 9, search)
        rnn_run = lm_fused_pass(torch, smi, "serve_rnnt", model, lines, tmp, 9, search,
                                kind="rnn")
    return {"launches": launches, "lm": lm_run, "rnn_lm": rnn_run}


def synth_requests(tmp: str, rng, n: int = 64) -> tuple:
    """``n`` synthesized utterances of 1-15 s, sorted by duration, written
    as wavs: -> (``utt path`` request lines, audio seconds)."""
    from nabu_tpu_torch.data import audio_io

    lines, audio_seconds = [], 0.0
    for i, seconds in enumerate(np.sort(rng.uniform(1.0, 15.0, n))):
        sig = synth_utterance(rng, float(seconds))
        path = os.path.join(tmp, f"utt{i:03d}.wav")
        audio_io.write_wav(path, sig, 16000)
        audio_seconds += len(sig) / 16000.0
        lines.append(f"utt{i:03d} {path}")
    return lines, audio_seconds


def tree_to(tree, device, dtype):
    """A parameter tree (nested dicts of tensors) on ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype)


def nbest_agreement(a, c) -> tuple:
    """-> (utterances whose whole n-best lists agree, max |score diff|)."""
    same = sum(
        int(np.array_equal(a.lengths[b], c.lengths[b]) and all(
            np.array_equal(a.ids[b, n, : c.lengths[b, n]], c.ids[b, n, : c.lengths[b, n]])
            for n in range(c.ids.shape[1])))
        for b in range(c.ids.shape[0]))
    return same, float(np.abs(a.scores - c.scores).max())


@contextlib.contextmanager
def search_steps(no_sync: bool = False):
    """Records the answers of the attention searches' exit test (asked
    before each step, and once more where every beam has finished) in the
    yielded list: its False answers count the steps. With ``no_sync`` the
    test answers False without reading the device, so a search runs to its
    max_steps without a host sync a step."""
    from nabu_tpu_torch.decoding import beam, joint

    asked = []
    saved = beam._all_finished

    def counted(finished):
        asked.append(False if no_sync else saved(finished))
        return asked[-1]

    beam._all_finished = joint._all_finished = counted
    try:
        yield asked
    finally:
        beam._all_finished = joint._all_finished = saved


def phase_text(num_labels: int, seed: int) -> list:
    """A serve phase's LM text: LM_SENTENCES seeded sentences of 5-40
    labels of the recipe's alphabet drawn from a random bigram chain (so
    that an LM prefers some continuations)."""
    rng = np.random.default_rng(seed)
    chain = rng.dirichlet(np.full(num_labels, 0.3), num_labels)
    text = []
    for _ in range(LM_SENTENCES):
        seq = [int(rng.integers(num_labels))]
        for _ in range(int(rng.integers(5, 41)) - 1):
            seq.append(int(rng.choice(num_labels, p=chain[seq[-1]])))
        text.append(seq)
    return text


def phase_text_lm(path: str, num_labels: int, seed: int):
    """The n-gram LM of a serve phase's LM-fused pass: a 3-gram trained
    with the port's ``NgramLM.train`` on ``phase_text``, saved to
    ``path``."""
    from nabu_tpu_torch.decoding.lm import NgramLM

    lm = NgramLM.train(phase_text(num_labels, seed), num_labels + 1, 3)
    lm.save(path)
    return lm


def phase_rnn_lm(path: str, num_labels: int, seed: int, device="cuda", num_units: int = 256,
                 num_steps: int = 500):
    """The RNN LM of a serve phase's neural-LM pass: the port's
    ``RnnLM.train`` at the JAX package's defaults (1 x 256 LSTM, embed
    64, batch 64, 500 Adam steps at 1e-3) on ``phase_text``, on
    ``device``, saved to ``path``."""
    from nabu_tpu_torch.decoding.neural_lm import RnnLM

    lm = RnnLM.train(phase_text(num_labels, seed), num_labels + 1, num_units=num_units,
                     num_steps=num_steps, device=device)
    lm.save(path)
    return lm


@contextlib.contextmanager
def lm_stale_context():
    """Planted fault of LM fusion: ``DenseLM.step`` returns the parent
    context, so no hypothesis's LM history advances past the sentence
    start."""
    from nabu_tpu_torch.decoding.lm import DenseLM

    saved = DenseLM.step
    DenseLM.step = lambda self, state, token: state
    try:
        yield
    finally:
        DenseLM.step = saved


def rnn_lm_gradients(torch, lm, text, batch: int = 64) -> dict:
    """One batch's gradients of the RNN LM's loss (the first ``batch``
    sentences of ``text``) through the training kernels, through their
    plain versions and through the plain versions with the planted
    ``lstm_dwh_h_late``: -> the worst parameter's ||kernel - plain|| /
    ||plain|| and the fault's, and the kernels' launches."""
    from nabu_tpu_torch.decoding.neural_lm import _pack
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.params import flatten, unflatten

    dev = lm.device
    inp, tgt, lengths = _pack(text[:batch], lm.vocab)
    args = (torch.as_tensor(inp.T.copy(), device=dev), torch.as_tensor(tgt.T.copy(), device=dev),
            torch.as_tensor(lengths, device=dev))

    def grads():
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in flatten(lm.params).items()}
        loss = lm._loss(unflatten(leaves), *args)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def worst(g, ref):
        return max(float((g[k] - ref[k]).norm() / ref[k].norm()) for k in ref)

    kernels.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    with plain_versions():
        ref = grads()
    with plain_versions(lstm_bwd_dwh=lstm_dwh_h_late(torch)):
        bad = grads()
    return {"rel_err": worst(got, ref), "fault_rel_err": worst(bad, ref), "launches": launches,
            "shape": [int(inp.shape[1]), int(inp.shape[0]), lm.num_units]}


@contextlib.contextmanager
def rnn_lm_stale_state():
    """Planted fault of neural-LM fusion: ``DenseRnnLM.step`` returns the
    parent state, so no hypothesis's LM history advances past <s>."""
    from nabu_tpu_torch.decoding.neural_lm import DenseRnnLM

    saved = DenseRnnLM.step
    DenseRnnLM.step = lambda self, state, token: state
    try:
        yield
    finally:
        DenseRnnLM.step = saved


def lm_fused_pass(torch, smi: str, phase: str, model, lines, tmp: str, seed: int,
                  search, kind: str = "ngram") -> dict:
    """The phase's recognizer again with an LM fused at LM_WEIGHT (nbest
    8): a 3-gram (``phase_text_lm``) or, with ``kind`` "rnn", the RNN LM
    trained on the card at full width (``phase_rnn_lm``; its launches
    zeroed just before and read just after, its gradients on one batch
    held to the plain versions' with a planted fault,
    ``rnn_lm_gradients``). The phase's first batch served unfused and
    fused (RTF side by side; the launch counts of each zeroed just before
    and read just after must agree: a fused step is plain PyTorch), then
    ``search(rec, device)``, the fused search over the ATT_CHECK_UTTS
    shortest utterances in float64 (the RNN LM moved to float64 too) on
    the card and on the CPU (n-best identical, scores within
    TOL["rnnt_scores"]), and once more on the card with the planted stale
    LM state (``lm_stale_context``, ``rnn_lm_stale_state``), which the
    check must reject."""
    from nabu_tpu_torch.data import audio_io
    from nabu_tpu_torch.decoding.recognizers import build_recognizer
    from nabu_tpu_torch.ops import kernels

    t_pass = time.perf_counter()
    rec = model.recognizer
    num_labels = model.text_proc.num_labels
    trained = {}
    if kind == "rnn":
        lm_path = os.path.join(tmp, "lm_rnn.npz")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm = phase_rnn_lm(lm_path, num_labels, seed)
        torch.cuda.synchronize()
        trained = {"train_s": time.perf_counter() - t0,
                   "train_launches": {k: v for k, v in kernels.launch_counts().items() if v}}
        for name in ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh"):
            check(trained["train_launches"].get(name) == 500,
                  f"{phase} rnn lm: {trained['train_launches']} in 500 training steps")
        text = phase_text(num_labels, seed)
        trained["train_ppl"] = lm.perplexity(text)
        grads = rnn_lm_gradients(torch, lm, text)
        trained.update({f"grads_{k}": v for k, v in grads.items()})
        check(grads["rel_err"] <= TOL["rnn_lm_grads"],
              f"{phase} rnn lm: gradients {grads['rel_err']} from the plain versions'")
        check(grads["fault_rel_err"] > TOL["rnn_lm_grads"],
              f"{phase} rnn lm: the dwh fault ({grads['fault_rel_err']}) was not rejected")
        stale_state = rnn_lm_stale_state
    else:
        lm_path = os.path.join(tmp, "lm_3gram.npz")
        lm = phase_text_lm(lm_path, num_labels, seed)
        stale_state = lm_stale_context
    conf = rec.conf.copy()
    for key, value in (("lm_path", lm_path), ("lm_weight", str(LM_WEIGHT)), ("nbest", "8")):
        conf.set(key, value)
    fused = build_recognizer(conf, model.model)
    check(fused.lm is not None and fused.lm_weight == LM_WEIGHT,
          f"{phase} lm: the recognizer fuses no LM")

    paths = [line.split()[1] for line in lines[:B]]
    audio_seconds = sum(len(audio_io.load_audio(p)[0]) / 16000.0 for p in paths)

    def served(r):
        model.recognizer = r
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        texts = model.recognize_files(paths)
        torch.cuda.synchronize()
        return texts, time.perf_counter() - t, {
            k: v for k, v in kernels.launch_counts().items() if v}

    # unfused, fused, fused, unfused: each side's RTF is the mean of its two
    try:
        runs = [served(r) for r in (rec, fused, fused, rec)]
    finally:
        model.recognizer = rec
    (plain_texts, _, plain_launches), (fused_texts, _, launches) = runs[:2]
    walls = [run[1] for run in runs]
    t_plain, t_fused = (walls[0] + walls[3]) / 2, (walls[1] + walls[2]) / 2
    check(all(run[2] == plain_launches for run in runs),
          f"{phase} lm: fused launches {launches}, unfused {plain_launches}")

    card = torch.device("cuda")
    if kind == "rnn":
        fused.lm = fused.lm.to("cpu", torch.float64)
    t0 = time.perf_counter()
    got = search(fused, card)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    want = search(fused, torch.device("cpu"))
    same, score_err = nbest_agreement(got, want)
    with stale_state():
        stale = search(fused, card)
    stale_same, stale_err = nbest_agreement(stale, want)
    n = ATT_CHECK_UTTS
    tol = TOL["rnnt_scores"]
    desc = ({"lm_units": lm.num_units, "lm_layers": lm.num_layers, "lm_embed": lm.embed_dim,
             **trained} if kind == "rnn" else {"lm_order": lm.order})
    emit({"phase": f"{phase}_{'rnn_' if kind == 'rnn' else ''}lm", **desc, "lm_vocab": lm.vocab,
          "lm_weight": LM_WEIGHT, "lm_sentences": LM_SENTENCES, "batch": len(paths),
          "audio_seconds": audio_seconds, "rtf": t_fused / audio_seconds,
          "unfused_rtf": t_plain / audio_seconds, "wall_seconds": t_fused,
          "unfused_wall_seconds": t_plain, "walls_unfused_fused_fused_unfused": walls,
          "hypotheses_changed": sum(int(a != b) for a, b in zip(fused_texts, plain_texts)),
          "launches": launches, "check_utterances": n, "nbest": int(want.ids.shape[1]),
          "dtype": "float64", "nbest_identical": same, "score_max_abs_err": score_err,
          "score_tol": tol, "stale_context_nbest_identical": stale_same,
          "stale_context_score_max_abs_err": stale_err, "card_search_s": t_card,
          "pass_seconds": time.perf_counter() - t_pass, "card": smi})
    check(same == n, f"{phase} {kind} lm: card and CPU n-best differ on {n - same}/{n}")
    check(score_err <= tol, f"{phase} {kind} lm: n-best scores differ by {score_err}")
    check(stale_same < n or stale_err > tol,
          f"{phase} {kind} lm: the stale LM state was not rejected ({stale_err})")
    out = {"launches": launches}
    if kind == "rnn":
        out["train"] = {"launches": trained["train_launches"]}
    return out


def float64_search(torch, encoded, enc_lengths, head):
    """``search(rec, device)`` of ``lm_fused_pass`` for a recognizer with a
    ``search`` over an encoder output: its n-best in float64 on device."""
    def search(rec, device):
        return rec.nbest_of(*rec.search(tree_to(head, device, torch.float64),
                                        encoded.to(device, torch.float64),
                                        enc_lengths.to(device)))
    return search


def kv_one_slot_late(decoder):
    """Planted KV-cache fault of the transformer decoder: each step writes
    its K / V one slot late (slot pos + 1, the last slot past the cap),
    where its own query cannot see them, and reads a zero slot 0 instead.
    A context manager over the decoder instance's ``cache_slot``."""
    import torch

    @contextlib.contextmanager
    def planted():
        decoder.cache_slot = lambda pos, cap: torch.clamp(pos + 1, max=cap - 1).to(torch.int64)
        try:
            yield
        finally:
            del decoder.cache_slot

    return planted()


def cache_check(torch, dec, head, encoded, enc_lengths, targets) -> float:
    """The decoder's cached ``step`` chain, teacher-forced over [<sos>;
    targets], against one parallel ``apply`` on the same inputs: max |step
    - apply| over max |apply| of the logits."""
    B, L = targets.shape
    lengths = torch.full((B,), L, dtype=torch.int32, device=encoded.device)
    with torch.no_grad():
        par, _ = dec.apply(head, encoded, enc_lengths, targets, lengths)
        state = dec.init_state(B, encoded.dtype, enc_frames=encoded.shape[1],
                               device=encoded.device)
        mask = enc_lengths[:, None] > torch.arange(encoded.shape[1], device=encoded.device)
        keys = dec.precompute(head, encoded)
        inputs = torch.cat([torch.full((B, 1), dec.sos_id, device=encoded.device,
                                       dtype=torch.int64), targets.long()], dim=1)
        steps = []
        for t in range(L + 1):
            logits, state = dec.step(head, inputs[:, t], state, encoded, mask, keys=keys)
            steps.append(logits)
    par = par.float()
    return float((torch.stack(steps, 1).float() - par).abs().max() / par.abs().max())


def phase_serve_att(torch, smi: str, phase: str) -> dict:
    """A full-width las_large_wsj (``serve_las``), joint_ctc_att_multihost
    (``serve_joint``) or conformer_aed_wsj (``serve_conformer_aed``)
    artifact, seeded random weights, serves synthesized utterances of 1-15
    s (ATT_SERVE: 32 each) through ``serving.serve`` at batch 32 with the
    recipe's recognizer (attention_beam, or joint_ctc_att_beam with
    ctc_weight 0.3; beam 16, nbest 8): the kernels of ATT_SERVE must launch
    so many times a batch and no other. Then the longest batch's search
    alone: its steps, ms a step, the cost of the host sync a step (the same
    steps without it) and (joint) the CTC prefix scan's share; then the
    ATT_CHECK_UTTS shortest utterances' search on the card's encoder output
    on the card and on the CPU, in float64 (n-best identical, scores within
    TOL["rnnt_scores"]; the bf16 agreement is reported), (joint) one batch
    of attention_rescoring, and (conformer_aed) the transformer decoder's
    readings: one decoder step at B x W = 512 hypotheses, the KV caches'
    beam gather a step, and the cache check (``cache_check`` over 101
    teacher-forced steps of the longest utterances, bf16 and f32, and the
    planted ``kv_one_slot_late``, which the tolerance must reject)."""
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.data import audio_io
    from nabu_tpu_torch.decoding import joint
    from nabu_tpu_torch.decoding.recognizers import AttentionRescoringRecognizer
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.serving import load_exported, serve

    recipe, seed, rec_name, per_batch, utts = ATT_SERVE[phase]
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase}_") as tmp:
        art = os.path.join(tmp, "export")
        manifest = write_artifact(art, seed=seed + 1, recipe=recipe)
        lines, audio_seconds = synth_requests(tmp, rng, utts)
        model = load_exported(art, batch_size=B)
        rec = model.recognizer
        check(model.device.type == "cuda", f"{phase}: model not on the card")
        check(type(rec).__name__ == rec_name and rec.beam_width == 16 and rec.nbest == 8,
              f"{phase}: recognizer {type(rec).__name__}")
        requests = os.path.join(tmp, "requests.scp")
        with open(requests, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with open(requests) as in_stream, search_steps() as steps:
            served = serve(art, in_stream=in_stream, out_stream=out, batch_size=B, model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = kernels.launch_counts()
        gemm_variants(phase)
        texts = out.getvalue().splitlines()
        check(served == utts and len(texts) == utts,
              f"{phase}: {served} served, {len(texts)} lines")
        alphabet = set(model.text_proc.alphabet) | {" "}
        for line, want in zip(texts, lines):
            utt = want.split()[0]
            check(line.split(" ", 1)[0] == utt, f"{phase}: line {line!r} is not for {utt}")
            check(set(line[len(utt):].replace("<space>", " ")) <= alphabet,
                  f"{phase}: unexpected symbols in {line!r}")
        batches = (utts + B - 1) // B
        ran = {k: v for k, v in launches.items() if v}
        want_launches = {k: n * batches for k, n in per_batch.items()}
        check(ran == want_launches,
              f"{phase}: launched {ran}, want {want_launches} for {batches} batches")
        nonempty = sum(1 for t in texts if t.split(" ", 1)[1:] and t.split(" ", 1)[1].strip())
        emit({"phase": phase, "recipe": os.path.relpath(recipe, REPO),
              "recognizer": rec_name, "utterances": served, "audio_seconds": audio_seconds,
              "wall_seconds": wall, "rtf": wall / audio_seconds,
              "utterances_per_second": served / wall, "decode_steps": steps.count(False),
              "peak_device_memory_bytes": peak, "launches": launches,
              "nonempty_hypotheses": nonempty, "batch_size": B, "beam_width": rec.beam_width,
              "card": smi, "manifest": manifest})

        def encode(utts):
            sigs = [audio_io.load_audio(line.split()[1])[0] for line in utts]
            feats, flens = model.device_fe.batch_features(sigs, 16000.0, len(sigs),
                                                          model.T_BUCKET)
            return rec._encode(model.params, feats, flens)

        def timed_search(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = rec.search(*args)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

        # the longest batch's search: its steps and ms a step, with the host
        # sync a step (the loop's exit test) and without it over the same
        # steps, and (joint) the prefix scan's synchronized share
        encoded, enc_lengths, head = encode(lines[-B:])
        with search_steps() as asked:
            synced, t_sync = timed_search(head, encoded, enc_lengths)
        n = asked.count(False)
        saved_max, rec.max_steps = rec.max_steps, n
        with search_steps(no_sync=True):
            unsynced, t_free = timed_search(head, encoded, enc_lengths)
        rec.max_steps = saved_max
        search = {"steps": n, "max_steps": rec.steps(encoded), "frames": int(encoded.shape[1]),
                  "hypotheses": int(encoded.shape[0]) * rec.beam_width,
                  "search_s": t_sync, "ms_per_step": 1e3 * t_sync / n,
                  "no_sync_search_s": t_free, "sync_ms_per_step": 1e3 * (t_sync - t_free) / n,
                  # the same steps give the same beams (seqs cut to the steps run)
                  "no_sync_identical": all(torch.equal(a[..., :n] if a.dim() == 3 else a, c)
                                           for a, c in zip(synced, unsynced))}
        if rec_name == "JointCTCAttBeamRecognizer":
            scan = []
            extend = joint._ctc_extend

            def timed_extend(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = extend(*a)
                torch.cuda.synchronize()
                scan.append(time.perf_counter() - t)
                return res

            joint._ctc_extend = timed_extend
            try:
                _, t_all = timed_search(head, encoded, enc_lengths)
            finally:
                joint._ctc_extend = extend
            search.update(scan_s=sum(scan), scan_share=sum(scan) / t_all,
                          scan_ms_per_step=1e3 * sum(scan) / len(scan),
                          scan_us_per_frame=1e6 * sum(scan) / len(scan) / encoded.shape[1])
        result = {"launches": launches}
        if phase == "serve_conformer_aed":
            result["decoder"] = aed_decoder_readings(torch, rec, head, encoded, enc_lengths, n,
                                                     rng)
            search.update(result["decoder"])
        emit({"phase": f"{phase}_search", **search, "card": smi})

        # the shortest utterances: the search on the card against the same
        # search on the CPU over the same encoder output, in float64 (in
        # bf16 each device rounds its sums in its own order and the top-16
        # cut reorders near-tied hypotheses; reported)
        encoded, enc_lengths, head = encode(lines[:ATT_CHECK_UTTS])
        cpu = torch.device("cpu")
        bf16 = nbest_agreement(
            rec.nbest_of(*rec.search(head, encoded, enc_lengths)),
            rec.nbest_of(*rec.search(tree_to(head, cpu, torch.bfloat16), encoded.cpu(),
                                     enc_lengths.cpu())))
        dt = torch.float64
        card, t_card = timed_search(tree_to(head, encoded.device, dt), encoded.to(dt),
                                    enc_lengths)
        t0 = time.perf_counter()
        host = rec.search(tree_to(head, cpu, dt), encoded.to(cpu, dt), enc_lengths.cpu())
        t_cpu = time.perf_counter() - t0
        same, score_err = nbest_agreement(rec.nbest_of(*card), rec.nbest_of(*host))
        emit({"phase": f"{phase}_check", "nbest_identical": same, "batch": ATT_CHECK_UTTS,
              "nbest": rec.nbest, "score_max_abs_err": score_err,
              "score_tol": TOL["rnnt_scores"], "dtype": "float64",
              "bf16_nbest_identical": bf16[0], "bf16_score_max_abs_err": bf16[1],
              "frames": int(encoded.shape[1]), "card_search_s": t_card, "cpu_search_s": t_cpu})
        check(same == ATT_CHECK_UTTS,
              f"{phase}: card and CPU n-best differ on {ATT_CHECK_UTTS - same}/{ATT_CHECK_UTTS}")
        check(score_err <= TOL["rnnt_scores"], f"{phase}: n-best scores differ by {score_err}")
        if phase in LM_ATT_PHASES:
            search = float64_search(torch, encoded, enc_lengths, head)
            result["lm"] = lm_fused_pass(torch, smi, phase, model, lines, tmp, seed + 2, search)
            result["rnn_lm"] = lm_fused_pass(torch, smi, phase, model, lines, tmp, seed + 2,
                                             search, kind="rnn")

        if phase == "serve_joint":
            # one batch (the 32 shortest) of the two-pass recognizer
            resc = AttentionRescoringRecognizer(Conf(
                {"recognizer": "attention_rescoring", "beam_width": "16", "nbest": "8"},
                "recognizer"), model.model)
            sigs = [audio_io.load_audio(line.split()[1])[0] for line in lines[:B]]
            feats, flens = model.device_fe.batch_features(sigs, 16000.0, B, model.T_BUCKET)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nb = resc(model.params, feats, flens)
            t_resc = time.perf_counter() - t0
            resc_launches = {k: v for k, v in kernels.launch_counts().items() if v}
            layers = per_batch["blstm_recur"]
            check(resc_launches == {"blstm_proj": layers, "blstm_recur": layers},
                  f"{phase} rescoring: launched {resc_launches}")
            check(nb.ids.shape[:2] == (B, 8) and bool(np.isfinite(nb.scores[:, 0]).all()),
                  f"{phase} rescoring: n-best {nb.ids.shape}, scores {nb.scores[:, 0]}")
            emit({"phase": f"{phase}_rescoring", "batch": B, "beam_width": resc.beam_width,
                  "nbest": resc.nbest, "ctc_weight": resc.ctc_weight, "wall_seconds": t_resc,
                  "audio_seconds": sum(len(x) for x in sigs) / 16000.0,
                  "best_lengths": nb.lengths[:, 0].tolist(), "launches": resc_launches,
                  "card": smi})
            result["rescoring_launches"] = resc_launches
    return result


def aed_decoder_readings(torch, rec, head, encoded, enc_lengths, steps: int, rng) -> dict:
    """The transformer decoder's readings on the longest batch's encoder
    output (B x W = 512 hypotheses): one ``decoder_step`` (the beam's
    decoder call, the cache writes included), the KV caches' beam gather a
    step (``gather_beams`` over every state leaf, as the searches do),
    and the cache check in bf16 and f32 with its planted fault (the
    8 longest utterances, 100 random labels, cap T_enc)."""
    from nabu_tpu_torch.decoding import beam
    from nabu_tpu_torch.ops.masking import sequence_mask

    dec = rec.decoder
    att = head[rec.head]
    W = rec.beam_width
    Be, T, _ = encoded.shape
    s = beam.initial_beam(dec, encoded, W, steps, torch.float32)
    mask = sequence_mask(enc_lengths, T)
    keys = dec.precompute(att, encoded)
    step_ms = time_ms(torch, lambda: beam.decoder_step(dec, att, s, encoded, mask, keys), 10)
    parent = torch.as_tensor(rng.integers(0, W, (Be, W)), device=encoded.device)
    gather_ms = time_ms(torch, lambda: beam.tree_map(lambda x: beam.gather_beams(x, parent),
                                                     s["state"]), 10)
    cache_bytes = sum(x.numel() * x.element_size() for x in s["state"].values())

    order = torch.argsort(enc_lengths, descending=True)[:ATT_CHECK_UTTS]
    enc8, len8 = encoded[order], enc_lengths[order]
    L = min(100, int(len8.min()) - 1)
    targets = torch.as_tensor(rng.integers(0, dec.num_labels, (ATT_CHECK_UTTS, L)),
                              device=encoded.device)
    bf16 = cache_check(torch, dec, att, enc8, len8, targets)
    f32 = cache_check(torch, dec, tree_to(att, encoded.device, torch.float32),
                      enc8.float(), len8, targets)
    with kv_one_slot_late(dec):
        fault = cache_check(torch, dec, att, enc8, len8, targets)
    if bf16 > TOL["aed_cache_bf16"] or f32 > TOL["aed_cache_f32"]:
        FAILURES.append(f"serve_conformer_aed: cached step vs apply {bf16} (bf16), {f32} (f32) "
                        f"beyond {TOL['aed_cache_bf16']}, {TOL['aed_cache_f32']}")
    if not fault > TOL["aed_cache_bf16"]:
        FAILURES.append(f"serve_conformer_aed: the planted KV fault ({fault}) passes the "
                        "tolerance")
    return {"decoder_step_ms": step_ms, "kv_gather_ms_per_step": gather_ms,
            "kv_state_bytes": cache_bytes, "cache_check_steps": L + 1,
            "cache_step_vs_apply_bf16": bf16, "cache_step_vs_apply_f32": f32,
            "cache_tol_bf16": TOL["aed_cache_bf16"], "cache_tol_f32": TOL["aed_cache_f32"],
            "fault_kv_one_slot_late": fault}


def phase_serve_stream(torch, smi: str) -> dict:
    """A full-width rnnt_streaming_wsj artifact (seeded random weights)
    serves STREAM_UTTS (32) synthesized utterances of 1-15 s through ``serving.serve`` at
    batch 32 with the recipe's transducer_streaming recognizer (chunks of
    32 frames, 4 symbols a frame): only the frontend and the LSTM forward
    kernels may run. The same batches through transducer_greedy must give
    identical ids on every utterance (scores within 1e-4). Then the
    per-chunk ``feed`` latency at batch 1, and ``serve(streaming=True)`` on
    a few utterances: PARTIAL / FINAL lines, the FINAL texts against the
    batch-32 offline greedy texts of the same host features (bf16
    reported; in f32 compute all must agree)."""
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.data import audio_io
    from nabu_tpu_torch.decoding.recognizers import TransducerGreedyRecognizer
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.serving import load_exported, serve

    def only_stream_kernels(launches, what, need=STREAM_SERVE_KERNELS):
        for name in need:
            check(launches[name] > 0, f"{what}: kernel {name} never launched")
        for name in kernels.KERNELS:
            if name not in STREAM_SERVE_KERNELS:
                check(launches[name] == 0, f"{what}: {launches[name]} launches of {name}")

    rng = np.random.default_rng(11)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        art = os.path.join(tmp, "export")
        manifest = write_artifact(art, seed=12, recipe=STREAM_RECIPE)
        lines, seconds = [], []
        for i, sec in enumerate(np.sort(rng.uniform(1.0, 15.0, STREAM_UTTS))):
            sig = synth_utterance(rng, float(sec))
            path = os.path.join(tmp, f"utt{i:03d}.wav")
            audio_io.write_wav(path, sig, 16000)
            seconds.append(len(sig) / 16000.0)
            lines.append(f"utt{i:03d} {path}")
        audio_seconds = sum(seconds)
        model = load_exported(art, batch_size=B)
        rec = model.recognizer
        check(model.device.type == "cuda", "serve_stream: model not on the card")
        check(type(rec).__name__ == "TransducerStreamingRecognizer"
              and rec.streamer.chunk_frames == 32 and rec.streamer.max_symbols == 4,
              f"serve_stream: recognizer {type(rec).__name__}")
        requests = os.path.join(tmp, "requests.scp")
        with open(requests, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(requests) as in_stream:
            served = serve(art, in_stream=in_stream, out_stream=out, batch_size=B, model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        gemm_variants("serve_stream")
        texts = out.getvalue().splitlines()
        check(served == STREAM_UTTS and len(texts) == STREAM_UTTS,
              f"serve_stream: {served} served, {len(texts)} lines")
        alphabet = set(model.text_proc.alphabet) | {" "}
        for line, want in zip(texts, lines):
            utt = want.split()[0]
            check(line.split(" ", 1)[0] == utt, f"serve_stream: line {line!r} is not for {utt}")
            check(set(line[len(utt):].replace("<space>", " ")) <= alphabet,
                  f"serve_stream: unexpected symbols in {line!r}")
        only_stream_kernels(launches, "serve_stream")

        # the same batches through both recognizers: identical ids
        greedy = TransducerGreedyRecognizer(
            Conf({"recognizer": "transducer_greedy", "max_symbols": "4"}, "recognizer"),
            model.model)
        same, score_err, t_stream, t_greedy, frames = 0, 0.0, 0.0, 0.0, []
        for start in range(0, STREAM_UTTS, B):
            sigs = [audio_io.load_audio(line.split()[1])[0] for line in lines[start:start + B]]
            feats, flens = model.device_fe.batch_features(sigs, 16000.0, B, model.T_BUCKET)
            frames.append(int(feats.shape[1]))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = rec(model.params, feats, flens)
            t2 = time.perf_counter()
            want = greedy(model.params, feats, flens)
            t3 = time.perf_counter()
            t_stream += t2 - t1
            t_greedy += t3 - t2
            for b in range(len(sigs)):
                same += int(got.best(b) == want.best(b))
            score_err = max(score_err, float(np.abs(got.scores[:, 0] - want.scores[:, 0]).max()))
        nonempty = sum(1 for t in texts if t.split(" ", 1)[1:] and t.split(" ", 1)[1].strip())

        # batch 1: the latency of each chunk's feed (32 frames = 320 ms of
        # audio) over the longest utterance, host features as serving
        # streams them
        streamer = model.streamer
        feats1 = model.audio_proc.process(lines[-1].split()[1])
        C = streamer.chunk_frames
        T1 = feats1.shape[0]
        padded = np.zeros((1, -(-T1 // C) * C, feats1.shape[1]), np.float32)
        padded[0, :T1] = feats1
        state = streamer.start(model.params, batch=1)
        feed_ms = []
        for c0 in range(0, padded.shape[1], C):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, state = streamer.feed(model.params, state, padded[:, c0:c0 + C],
                                     np.asarray([min(C, T1 - c0)], np.int32))
            torch.cuda.synchronize()
            feed_ms.append(1e3 * (time.perf_counter() - t1))

        # serve(streaming=True) on a few utterances; FINAL against the
        # batch-32 offline greedy text of the same host features
        picks = lines[::STREAM_UTTS // 4]
        kernels.reset_launch_counts()
        sout = io.StringIO()
        n = serve(art, in_stream=io.StringIO("\n".join(picks) + "\n"), out_stream=sout,
                  streaming=True, model=model)
        stream_launches = kernels.launch_counts()
        gemm_variants("serve_stream (streaming=True)")
        check(n == len(picks), f"serve_stream: streaming served {n} of {len(picks)}")
        # host features: no frontend kernel
        only_stream_kernels(stream_launches, "serve_stream (streaming=True)",
                            need=STREAM_SERVE_KERNELS[1:])
        slines = sout.getvalue().splitlines()
        finals, partials = {}, {}
        for line in slines:
            utt, kind, *rest = line.split(" ", 2)
            check(kind in ("PARTIAL", "FINAL"), f"serve_stream: line {line!r}")
            check(utt not in finals, f"serve_stream: a line for {utt} after its FINAL")
            if kind == "FINAL":
                finals[utt] = rest[0] if rest else ""
            else:
                partials[utt] = partials.get(utt, 0) + 1
        check(sorted(finals) == sorted(p.split()[0] for p in picks),
              f"serve_stream: FINAL lines for {sorted(finals)}")
        host = [model.audio_proc.process(p.split()[1]) for p in picks]

        def offline_texts():
            saved = model.recognizer
            model.recognizer = greedy
            try:
                return model.recognize_features(host)
            finally:
                model.recognizer = saved

        offline = offline_texts()
        agree = sum(int(finals[p.split()[0]] == o) for p, o in zip(picks, offline))
        # the same comparison in f32 compute: a bf16 tie between batch 1
        # and batch 32 (cuBLAS rounds the head's per-step products of other
        # shapes its own way) may flip a symbol there
        model.model.compute_dtype = torch.float32
        try:
            finals32 = [model.stream_file(p.split()[1]) for p in picks]
            offline32 = offline_texts()
        finally:
            model.model.compute_dtype = torch.bfloat16
        agree32 = sum(int(a == o) for a, o in zip(finals32, offline32))
        result = {
            "phase": "serve_stream", "utterances": served, "audio_seconds": audio_seconds,
            "serve_wall_seconds": wall, "rtf": wall / audio_seconds,
            "utterances_per_second": served / wall,
            "streaming_recognizer_seconds": t_stream, "rtf_streaming": t_stream / audio_seconds,
            "greedy_recognizer_seconds": t_greedy, "rtf_greedy": t_greedy / audio_seconds,
            "ids_identical": same, "score_max_abs_err": score_err,
            "score_tol": TOL["stream_scores"], "frames_per_batch": frames,
            "nonempty_hypotheses": nonempty, "launches": launches,
            "feed_chunks": len(feed_ms), "feed_first_ms": feed_ms[0],
            "feed_median_ms": float(np.median(feed_ms[1:])),
            "feed_p90_ms": float(np.percentile(feed_ms[1:], 90)),
            "feed_utterance_seconds": seconds[-1],
            "streaming_serve_utterances": len(picks),
            "partial_lines": sum(partials.values()),
            "final_vs_offline_bf16": agree, "final_vs_offline_f32": agree32,
            "streaming_serve_launches": stream_launches,
            "batch_size": B, "card": smi, "manifest": manifest,
        }
        emit(result)
        check(same == STREAM_UTTS,
              f"serve_stream: streamed ids differ from greedy on {STREAM_UTTS - same}/{STREAM_UTTS}")
        check(score_err <= TOL["stream_scores"],
              f"serve_stream: streamed and greedy scores differ by {score_err}")
        check(agree32 == len(picks),
              f"serve_stream: f32 FINAL texts differ from offline on {len(picks) - agree32}")
    total = {k: launches[k] + stream_launches[k] for k in launches}
    return {"launches": total}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def synth_corpus(root: str, rng, num_utts: int, alphabet, rate: int = 16000):
    """Character utterances of 2-10 s at ~12 symbols a second, each symbol
    a tone of its own frequency (with a noise floor), written as wavs
    with Kaldi-style wav.scp and text. Returns (scp, text, audio s)."""
    from nabu_tpu_torch.data import audio_io

    os.makedirs(root, exist_ok=True)
    freqs = np.geomspace(150.0, 4000.0, len(alphabet))
    chars = [" " if a == "<space>" else a for a in alphabet]
    scp, text, total = [], [], 0.0
    for i in range(num_utts):
        seconds = rng.uniform(2.0, 10.0)
        syms = rng.integers(0, len(alphabet), max(1, int(round(12.0 * seconds))))
        seg = int(seconds * rate) // len(syms)
        t = np.arange(seg) / rate
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
        sig = np.concatenate([np.sin(2 * np.pi * freqs[k] * t) * env for k in syms])
        sig = 6000.0 * sig + 40.0 * rng.standard_normal(len(sig))
        path = os.path.join(root, f"utt{i:04d}.wav")
        audio_io.write_wav(path, sig.astype(np.float32), rate)
        total += len(sig) / rate
        scp.append(f"utt{i:04d} {path}")
        text.append(f"utt{i:04d} {''.join(chars[k] for k in syms)}")
    scp_path, text_path = os.path.join(root, "wav.scp"), os.path.join(root, "text")
    with open(scp_path, "w") as f:
        f.write("\n".join(scp) + "\n")
    with open(text_path, "w") as f:
        f.write("\n".join(text) + "\n")
    return scp_path, text_path, total


def write_train_recipe(recipe: str, out_dir: str, train, dev, steps: int = TRAIN_STEPS) -> str:
    """A recipe with its datafiles pointed at the synthesized corpus and
    ``steps`` steps; nothing else changed."""
    from nabu_tpu_torch.config import ConfigFile

    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(recipe):
        with open(os.path.join(recipe, fname)) as f:
            text = f.read()
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(text)
    db = ConfigFile.read(os.path.join(out_dir, "database.conf"))
    for split, (scp, txt) in (("train", train), ("dev", dev), ("test", dev)):
        db.section(f"{split}features").set("datafile", scp)
        db.section(f"{split}targets").set("datafile", txt)
    db.write(os.path.join(out_dir, "database.conf"))
    tc = ConfigFile.read(os.path.join(out_dir, "trainer.cfg"))
    tc.section("trainer").set("num_steps", steps)
    tc.write(os.path.join(out_dir, "trainer.cfg"))
    return out_dir


@contextlib.contextmanager
def step_timers(torch, record: dict):
    """Synchronized host timers around the trainer's step phases:
    forward (Model.apply_train; inside it a transducer head's prediction
    net, TransducerDecoder._pred_sequence), forward + loss (Trainer._loss), backward
    (Trainer._backward), the gradients' all-reduce (Trainer._reduce_grads,
    with the group's backend and size and the buffer's bytes) and
    optimizer (Trainer._apply_grads), inside the
    forward a Listener's, a Speller's and an attention encoder's shares
    (their ``apply``), and the
    synchronized clock at each step's end (``step_end``: the window
    between two such readings holds everything the loop does, loader,
    copy to the device and logging included). Also keeps each step's loss
    and audio frames, the trainer, the model, the live parameters, a copy
    of them before the first update and the longest batch, and CUDA events around each ``lstm_bwd_dwh`` launch
    (inside the backward; no synchronization) with its step."""
    from nabu_tpu_torch.models.decoders import Speller
    from nabu_tpu_torch.models.encoders import Listener, TransformerEncoder
    from nabu_tpu_torch.models.model import Model
    from nabu_tpu_torch.models.transducer import TransducerDecoder
    from nabu_tpu_torch.ops import lstm as lstm_ops
    from nabu_tpu_torch.params import flatten
    from nabu_tpu_torch.training.trainer import Trainer

    def timed(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapped

    saved = {(Model, "apply_train"): Model.apply_train, (Trainer, "_loss"): Trainer._loss,
             (Trainer, "_backward"): Trainer._backward,
             (Trainer, "_reduce_grads"): Trainer._reduce_grads,
             (Trainer, "_apply_grads"): Trainer._apply_grads,
             (TransducerDecoder, "_pred_sequence"): TransducerDecoder._pred_sequence,
             (Listener, "apply"): Listener.apply, (Speller, "apply"): Speller.apply,
             (TransformerEncoder, "apply"): TransformerEncoder.apply,
             (lstm_ops, "lstm_bwd_dwh"): lstm_ops.lstm_bwd_dwh}
    fwd = timed("forward", saved[(Model, "apply_train")])
    loss = timed("forward_loss", saved[(Trainer, "_loss")])

    def apply_train(self, *a, **kw):
        record["model"] = self
        return fwd(self, *a, **kw)

    def _loss(self, params, batch, generator):
        record["trainer"] = self
        out = loss(self, params, batch, generator)
        record.setdefault("loss", []).append(float(out[0].detach()))
        for k, v in out[1].items():
            if k.endswith("/token_accuracy"):
                record.setdefault("token_accuracy", []).append(float(v))
        mask = batch["example_mask"]
        record.setdefault("frames", []).append(
            float((batch["feature_lengths"].float() * mask).sum()))
        if batch["features"].shape[1] >= record.get("batch_T", 0):
            record["batch_T"] = int(batch["features"].shape[1])
            record["batch"] = batch
        return out

    apply_grads = timed("optimizer", saved[(Trainer, "_apply_grads")])
    reduce_grads = timed("all_reduce", saved[(Trainer, "_reduce_grads")])

    def _reduce_grads(self, grads):
        import torch.distributed as dist

        record["group"] = ((dist.get_backend(), dist.get_world_size())
                           if dist.is_initialized() else None)
        record["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads.values())
        return reduce_grads(self, grads)

    def _apply_grads(self, params, *a, **kw):
        record["params"] = params
        if "initial" not in record:  # the parameters before the first update
            record["initial"] = {k: v.detach().clone() for k, v in flatten(params).items()}
        out = apply_grads(self, params, *a, **kw)
        record.setdefault("step_end", []).append(time.perf_counter())
        return out

    def lstm_bwd_dwh(hs, dxw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = saved[(lstm_ops, "lstm_bwd_dwh")](hs, dxw)
        end.record()
        record.setdefault("dwh_events", []).append((len(record.get("loss", ())) - 1, start, end))
        return out

    Model.apply_train = apply_train
    lstm_ops.lstm_bwd_dwh = lstm_bwd_dwh
    TransducerDecoder._pred_sequence = timed("pred_net", saved[(TransducerDecoder,
                                                               "_pred_sequence")])
    Listener.apply = timed("listener", saved[(Listener, "apply")])
    Speller.apply = timed("speller", saved[(Speller, "apply")])
    TransformerEncoder.apply = timed("attention_encoder", saved[(TransformerEncoder, "apply")])
    Trainer._loss = _loss
    Trainer._backward = timed("backward", saved[(Trainer, "_backward")])
    Trainer._reduce_grads = _reduce_grads
    Trainer._apply_grads = _apply_grads
    try:
        yield
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def gradient_check(torch, trainer, params, batch, phase: str):
    """One full-width batch, dropout off: loss and every parameter
    gradient through the kernels against the same step through the plain
    versions, and through planted faults, of which the tolerance must
    reject the phase's own: for the CTC recipe the bw direction's dx left
    out of the sum over directions (and, reported, the backward chain's
    barrier not waiting: every dgates exchange one step stale); for the
    RNN-T recipe each lane's last frame left out of the prediction
    projection's gradient; for the streaming recipe and the
    conformer-transducer the LSTM layers' dwh paired with h one step late
    (the conformer-transducer's reported reading: the last frame out of
    the prediction projection's gradient); for the LAS recipe the v1 layers' dwh
    with the directions' carries swapped (and, reported, paired with h one
    step late). The LAS recipe's Speller parameters have a tolerance of
    their own (TOL). Per parameter the reading is
    ||kernel - plain|| / ||plain||."""
    from nabu_tpu_torch.ops import blstm as bo
    from nabu_tpu_torch.ops import transducer_fused as tf
    from nabu_tpu_torch.params import flatten, unflatten

    flat = {k: v.detach() for k, v in flatten(params).items()}

    def loss_and_grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        loss, _ = trainer.loss_fn(unflatten(leaves), batch, None, False)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    t0 = time.perf_counter()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with plain_versions():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def rel(grads):
        return {k: float(torch.linalg.vector_norm((grads[k] - grads_p[k]).float())
                         / torch.linalg.vector_norm(grads_p[k].float()).clamp(min=1e-30))
                for k in grads_p}

    readings = {}
    if phase == "train":
        def fw_dx_only(dg, wx):
            dx = bo.blstm_bwd_dx_plain(dg, wx)
            dx[1] = 0
            return dx

        with plain_versions(blstm_bwd_dx=fw_dx_only):
            _, grads_f = loss_and_grads()
        hidden = flat["encoder/layer_0/fw/wh"].shape[0]
        with plain_versions(blstm_bwd_recur=faulty_chain(torch, stale_units=hidden)):
            _, grads_s = loss_and_grads()
        readings["stale_exchange_grads_max_rel_err"] = max(rel(grads_s).values())
    elif phase == "train_rnnt":
        with plain_versions(rnnt_joint_bwd=rnnt_last_frame_out_of_dpred(torch, tf)):
            _, grads_f = loss_and_grads()
    elif phase == "train_conformer_rnnt":
        # behind the conformer's ~250 frames a lane, the last frame's share
        # of dpred is too small for the tolerance to see (0.018 < 0.02):
        # reported; the prediction net's dwh with h one step late decides
        with plain_versions(lstm_bwd_dwh=lstm_dwh_h_late(torch)):
            _, grads_f = loss_and_grads()
        with plain_versions(rnnt_joint_bwd=rnnt_last_frame_out_of_dpred(torch, tf)):
            _, grads_s = loss_and_grads()
        readings["last_frame_out_of_dpred_grads_max_rel_err"] = max(rel(grads_s).values())
    elif phase in THIRD:
        with plain_versions(blstm_v1_bwd_dwh=v1_dwh_directions_swapped(torch)):
            _, grads_f = loss_and_grads()
        with plain_versions(blstm_v1_bwd_dwh=v1_dwh_h_late(torch)):
            _, grads_s = loss_and_grads()
        readings["h_late_dwh_grads_max_rel_err"] = max(rel(grads_s).values())
    else:
        with plain_versions(lstm_bwd_dwh=lstm_dwh_h_late(torch)):
            _, grads_f = loss_and_grads()

    def speller(k):
        return (phase == "train_las" and k.startswith("decoders/")) or (
            phase == "train_joint" and k.startswith("decoders/att/"))

    def tol(k):
        return TOL["train_grads_speller" if speller(k) else "train_grads"]

    rel_k, rel_f = rel(grads_k), rel(grads_f)
    for k, g in grads_k.items():
        check(bool(torch.isfinite(g).all()), f"{phase} gradient {k}: non-finite")
    loss_err = compare(torch, loss_k, loss_p, TOL["train_loss"], f"{phase} batch loss")
    worst = max(rel_k.values())
    fault = max(rel_f.values())
    over = {k: v for k, v in rel_k.items() if v > tol(k)}
    if over:
        FAILURES.append(f"{phase} gradients: relative errors beyond tolerance: {over}")
    if not any(v > tol(k) for k, v in rel_f.items()):
        FAILURES.append(f"{phase} gradients: a planted fault ({fault}) passes the tolerance")
    if phase in THIRD:
        readings["grads_tol_speller"] = TOL["train_grads_speller"]
        readings["speller_grads_max_rel_err"] = max(v for k, v in rel_k.items() if speller(k))
        readings["listener_grads_max_rel_err"] = max(
            v for k, v in rel_k.items() if k.startswith("encoder/"))
    if phase == "train_joint":
        readings["ctc_head_grads_max_rel_err"] = max(
            v for k, v in rel_k.items() if k.startswith("decoders/ctc/"))
    return {
        "batch_shape": list(batch["features"].shape), "loss_kernels": float(loss_k),
        "loss_plain": float(loss_p), "loss_max_abs_err": loss_err,
        "loss_tol": TOL["train_loss"], "grads_max_rel_err": worst,
        "grads_rel_err": rel_k, "grads_tol": TOL["train_grads"],
        "fault_grads_max_rel_err": fault, **readings,
        "kernel_step_s": t1 - t0, "plain_step_s": t2 - t1,
    }


def synth_training_corpus(root: str) -> dict:
    """The training phases' corpus: TRAIN_UTTS utterances to train on, 32
    for dev and test, in the recipes' alphabet."""
    from nabu_tpu_torch.config import ConfigFile

    rng = np.random.default_rng(5)
    alphabet = ConfigFile.read(os.path.join(RECIPE, "database.conf")).section(
        "traintargets").getlist("alphabet")
    t0 = time.perf_counter()
    train = synth_corpus(os.path.join(root, "train"), rng, TRAIN_UTTS, alphabet)
    dev = synth_corpus(os.path.join(root, "dev"), rng, 32, alphabet)
    # train_las: the first LAS_TRAIN_UTTS utterances (its recipe perturbs
    # each at 0.9, 1.0 and 1.1 speed)
    third = []
    for src, name in ((train[0], "wav_third.scp"), (train[1], "text_third")):
        with open(src) as f:
            lines = f.read().splitlines()[:LAS_TRAIN_UTTS]
        third.append(os.path.join(root, "train", name))
        with open(third[-1], "w") as f:
            f.write("\n".join(lines) + "\n")
    from nabu_tpu_torch.data.audio_io import load_audio

    with open(third[0]) as f:
        third_s = sum(len(load_audio(line.split()[1])[0]) / 16000.0 for line in f)
    return {"train": train, "dev": dev, "train_las": (*third, third_s),
            "seconds": time.perf_counter() - t0, "root": root}


def head_outputs(torch, model, params, batch):
    """Every head's outputs on a batch, dropout off, as a flat list."""
    with torch.no_grad():
        out = model.apply_train(params, batch["features"], batch["feature_lengths"],
                                batch["targets"], batch["target_lengths"], train=False)
    flat = []
    for logits, lengths in out.values():
        flat += list(logits.values()) if isinstance(logits, dict) else [logits]
        flat.append(lengths)
    return flat


def _data_sections(recipe: str) -> dict:
    from nabu_tpu_torch.config import ConfigFile

    db = ConfigFile.read(os.path.join(recipe, "database.conf"))
    return {name: dict(db.section(name).items()) for name in db.sections()}


# a training phase that trains on a copy of another phase's prepared data
# (their database.conf sections are checked to be the same)
DATA_FROM = {"train_rnnt_stream": "train_rnnt", "train_joint": "train_las",
             "train_conformer_rnnt": "train"}
# the phases that train on the first LAS_TRAIN_UTTS utterances of the corpus
THIRD = ("train_las", "train_joint")
# the phases whose cli train is one rank of a data-parallel group
DISTRIBUTED = ("train_joint",)
# the phases whose falling-loss check is one fixed batch's loss (the
# longest, dropout off) before and after training: a per-example CTC or
# RNN-T NLL grows with the batch's frames, so the losses of batches of
# other buckets are not comparable over 20 steps
FIXED_BATCH_LOSS = ("train_joint", "train_conformer_rnnt")


def phase_train(torch, smi: str, phase: str, corpus: dict) -> dict:
    """``cli data`` (or, for a phase of DATA_FROM, a copy of its donor's
    prepared data) + ``cli train`` of a recipe (TRAIN_RECIPES[phase]) on
    the synthesized corpus, then its checks."""
    import shutil

    from nabu_tpu_torch import cli
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.params import load_npz, unflatten

    train, dev = corpus["train"], corpus["dev"]
    per_step = STEP_LAUNCHES[phase]
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase}_") as tmp:
        if phase in THIRD:
            train = corpus["train_las"]
        want_steps = PHASE_STEPS.get(phase, TRAIN_STEPS)
        recipe = write_train_recipe(TRAIN_RECIPES[phase], os.path.join(tmp, "recipe"),
                                    train[:2], dev[:2], want_steps)
        expdir = os.path.join(tmp, "exp")
        donor = DATA_FROM.get(phase)
        t1 = time.perf_counter()
        if donor is None:
            with contextlib.redirect_stdout(sys.stderr):
                cli.main(["data", "--recipe", recipe, "--expdir", expdir,
                          "--num_workers", str(min(8, os.cpu_count() or 1))])
            if phase in DATA_FROM.values():
                keep = os.path.join(corpus["root"], f"prepared_{phase}")
                shutil.copytree(os.path.join(expdir, "data"), keep)
                corpus[f"prepared_{phase}"] = (_data_sections(recipe), keep)
        else:
            sections, keep = corpus[f"prepared_{donor}"]
            check(_data_sections(recipe) == sections,
                  f"{phase}: database.conf differs from {donor}'s; its data cannot be reused")
            shutil.copytree(keep, os.path.join(expdir, "data"))
        t2 = time.perf_counter()

        record: dict = {}
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        argv = ["train", "--recipe", recipe, "--expdir", expdir]
        if phase in DISTRIBUTED:
            # one rank of a data-parallel group: NCCL at world size 1
            argv += ["--distributed", "--coordinator", f"127.0.0.1:{_free_port()}",
                     "--num_processes", "1", "--process_id", "0"]
        with step_timers(torch, record), contextlib.redirect_stdout(sys.stderr):
            cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t3
        launches = kernels.launch_counts()
        gemm_variants(phase)
        peak = torch.cuda.max_memory_allocated()

        losses = record["loss"]
        steps = len(losses)
        phases = {
            "forward": record["forward"],
            "loss": [a - b for a, b in zip(record["forward_loss"], record["forward"])],
            "backward": record["backward"], "all_reduce": record["all_reduce"],
            "optimizer": record["optimizer"],
        }
        want_group = ("nccl", 1) if phase in DISTRIBUTED else None
        check(record["group"] == want_group,
              f"{phase}: trained in group {record['group']}, want {want_group}")
        step_s = [sum(v[i] for v in phases.values()) for i in range(steps)]
        pred_net = record.get("pred_net", [0.0] * steps)
        shares = {k: record[k] for k in ("listener", "speller", "attention_encoder")
                  if k in record}
        for i in range(steps):
            emit({"phase": f"{phase}_step", "step": i + 1, "loss": losses[i],
                  "ms": {k: 1e3 * v[i] for k, v in phases.items()},
                  "pred_net_ms": 1e3 * pred_net[i],
                  **{f"{k}_ms": 1e3 * v[i] for k, v in shares.items()},
                  **{k: record[k][i] for k in ("token_accuracy",) if k in record}})
        median_ms = {k: 1e3 * float(np.median(v[1:])) for k, v in phases.items()}
        # the LSTM dwh launches' device time a step, against the backward's
        dwh_ms = [0.0] * steps
        for i, start, end in record.get("dwh_events", []):
            dwh_ms[i] += start.elapsed_time(end)
        audio_s = sum(record["frames"][1:]) * 0.01
        # steps 2..N end to end: from step 1's synchronized end to step N's
        ends = record["step_end"]
        window = ends[-1] - ends[0]
        check(steps == want_steps, f"{phase}: {steps} steps, want {want_steps}")
        check(all(math.isfinite(v) for v in losses), f"{phase}: a non-finite loss")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        model, params, batch = record["model"], record["params"], record["batch"]
        fixed = None
        if phase in FIXED_BATCH_LOSS:
            # the loss of one fixed batch (the longest, dropout off) must
            # fall from the initial parameters to the trained ones
            with torch.no_grad():
                fixed = [float(record["trainer"].loss_fn(p, batch, None, False)[0])
                         for p in (unflatten(record["initial"]), params)]
            check(fixed[1] < fixed[0], f"{phase}: fixed-batch loss not falling {fixed}")
        else:
            check(last < first, f"{phase}: loss not falling ({first} -> {last})")
        for name in kernels.KERNELS:
            want = steps * per_step.get(name, 0)
            check(launches[name] == want,
                  f"{phase}: {launches[name]} launches of {name}, want {want}")
        check(os.path.exists(os.path.join(expdir, "logs", "train_complete.json")),
              f"{phase}: no train_complete.json")

        # latest/ reloads into parameters that give the same outputs
        loaded = load_npz(os.path.join(expdir, "checkpoints", "latest", "params.npz"),
                          device=batch["features"].device)
        live = head_outputs(torch, model, params, batch)
        again = head_outputs(torch, model, loaded, batch)
        check(all(torch.equal(a, c) for a, c in zip(live, again)),
              f"{phase}: latest/ gives other outputs")

        grad = gradient_check(torch, record["trainer"], params, batch, phase)
        result = {
            "phase": phase, "recipe": os.path.relpath(TRAIN_RECIPES[phase], REPO),
            "steps": steps, "utterances": LAS_TRAIN_UTTS if phase in THIRD else TRAIN_UTTS,
            "speed_perturbation": 3 if phase in THIRD else 1,
            "corpus_audio_seconds": train[2], "synth_seconds": corpus["seconds"],
            "data_seconds": t2 - t1, "data_prepared_by": donor or phase,
            "train_wall_seconds": wall,
            "loss_first5_mean": first, "loss_last5_mean": last,
            "fixed_batch_loss_initial_trained": fixed,
            "median_step_ms": median_ms,
            "median_pred_net_ms": 1e3 * float(np.median(pred_net[1:])),
            "median_lstm_bwd_dwh_ms": float(np.median(dwh_ms[1:])),
            "lstm_bwd_dwh_share_of_backward": float(np.median(dwh_ms[1:])) / median_ms["backward"],
            **{f"median_{k}_ms": 1e3 * float(np.median(v[1:])) for k, v in shares.items()},
            "median_step_total_ms": 1e3 * float(np.median(step_s[1:])),
            "first_step_ms": 1e3 * step_s[0],
            "median_step_wall_ms": 1e3 * float(np.median(np.diff(ends))),
            "window_seconds": window, "window_phases_seconds": sum(step_s[1:]),
            "train_audio_seconds_per_second": audio_s / window,
            "phases_audio_seconds_per_second": audio_s / sum(step_s[1:]),
            "peak_device_memory_bytes": peak, "launches": launches,
            "per_step_launches": per_step, "group": record["group"],
            "grad_buffer_bytes": record["grad_bytes"],
            "all_reduce_gb_per_s": record["grad_bytes"] / (median_ms["all_reduce"] * 1e6),
            "card": smi,
        }
        emit(result)
        emit({"phase": f"{phase}_check", **grad})
        if phase == "train_las":
            result["decode"] = las_decode(torch, smi, recipe, expdir, model, corpus["dev"][2])
        elif phase == "train_joint":
            result["test"] = joint_test(torch, smi, recipe, expdir, corpus["dev"][2])
            # train_mwer fine-tunes these weights (warm start from best/)
            keep = os.path.join(corpus["root"], "joint_checkpoint", "best")
            os.makedirs(keep)
            for fname in ("params.npz", "scalars.json"):
                shutil.copy(os.path.join(expdir, "checkpoints", "best", fname), keep)
            corpus["joint_checkpoint"] = os.path.dirname(keep)
        elif phase == "train_conformer_rnnt":
            result["test"] = transducer_test(torch, smi, recipe, expdir, corpus["dev"][2])
        elif phase == "train":
            result["pipeline"] = phase_pipeline(torch, smi, recipe, expdir, corpus["dev"])
    return result


def phase_pipeline(torch, smi: str, recipe: str, expdir: str, dev) -> dict:
    """The rest of the main path on the train phase's trained expdir
    (full-width dblstm_ctc_wsj, 40 steps; its test split is the dev
    split): ``cli test``, ``cli decode``, ``cli export``, then ``cli
    serve`` over the exported artifact and ``cli recognize`` on the first
    PIPELINE_UTTS dev wavs. Each stage is timed, its launch counts zeroed
    just before and read just after: test, decode and recognize run the
    v2 inference kernels (recognize and serve the frontend's too) and no
    other kernel. The exported params.npz must equal best/params.npz bit
    for bit, nbest.txt must hold every test utterance, serve must answer
    every request, and recognize must give serve's hypotheses. Then the
    n-gram LM: ``cli lm``, ``cli decode`` with it (LM_WEIGHT), ``cli
    rescore`` (every line, ranked within each utterance), ``cli export``
    (the artifact carries ``lm.npz``) and ``cli serve`` over that
    export, whose lines must be the fused decode's best hypotheses."""
    from nabu_tpu_torch import cli
    from nabu_tpu_torch.data.processors import read_datafile
    from nabu_tpu_torch.ops import kernels

    def stage(name, argv, stdin=None) -> tuple:
        out = io.StringIO()
        saved = sys.stdin
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if stdin is not None:
                sys.stdin = stdin
            with contextlib.redirect_stdout(out):
                cli.main(argv)
        finally:
            sys.stdin = saved
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        print(out.getvalue(), file=sys.stderr, flush=True)
        want = PIPELINE_KERNELS.get(name, ())
        check(set(launches) == set(want),
              f"pipeline {name}: launched {launches}, want each of {want} and no other")
        return out.getvalue(), seconds, launches

    args = ["--recipe", recipe, "--expdir", expdir]
    seconds, launches = {}, {}
    text, seconds["test"], launches["test"] = stage("test", ["test", *args])
    with open(os.path.join(expdir, "test_result.json")) as f:
        result = json.load(f)
    check(math.isfinite(result["metric"]), f"pipeline test: metric {result['metric']}")

    text, seconds["decode"], launches["decode"] = stage("decode", ["decode", *args])
    utts = [u for u, _ in read_datafile(dev[0])]
    with open(os.path.join(expdir, "decoded", "nbest.txt")) as f:
        nbest = [line.split(" ", 2) for line in f.read().splitlines()]
    check({line[0] for line in nbest} == set(utts),
          f"pipeline decode: nbest.txt holds {len({line[0] for line in nbest})} of "
          f"{len(utts)} test utterances")
    check(all(math.isfinite(float(line[1])) for line in nbest),
          "pipeline decode: a non-finite score")
    rtf = re.search(r"steady-state RTF ([0-9.eE+-]+)", text)

    art = os.path.join(expdir, "export_pipeline")
    _, seconds["export"], launches["export"] = stage(
        "export", ["export", *args, "--output", art])
    with np.load(os.path.join(expdir, "checkpoints", "best", "params.npz")) as a, \
            np.load(os.path.join(art, "params.npz")) as b:
        same = (sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a.files))
    check(same, "pipeline export: params.npz differs from best/params.npz")
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    check(sorted(os.listdir(art)) == ["frontend.cfg", "manifest.json", "model.cfg",
                                      "params.npz", "recognizer.cfg"],
          f"pipeline export: artifact holds {sorted(os.listdir(art))}")

    wavs = read_datafile(dev[0])[:PIPELINE_UTTS]
    # the requests as a file on stdin: select() reports it readable, so
    # serve batches them as recognize does (one batch of PIPELINE_UTTS)
    requests = os.path.join(expdir, "requests.scp")
    with open(requests, "w") as f:
        f.write("".join(f"{u} {p}\n" for u, p in wavs))
    with open(requests) as stdin:
        text, seconds["serve"], launches["serve"] = stage(
            "serve", ["serve", "--export_dir", art, "--batch_size", str(PIPELINE_UTTS)],
            stdin=stdin)
    served = [line.split(" ", 1) for line in text.splitlines()]
    check([line[0] for line in served] == [u for u, _ in wavs],
          f"pipeline serve: answered {len(served)} of {len(wavs)} requests")
    text, seconds["recognize"], launches["recognize"] = stage(
        "recognize", ["recognize", *args, "--batch_size", str(PIPELINE_UTTS),
                      *[p for _, p in wavs]])
    recognized = [line.split(" ", 1) for line in text.splitlines()]
    check([line[0] for line in recognized] == [os.path.splitext(os.path.basename(p))[0]
                                               for _, p in wavs],
          f"pipeline recognize: {len(recognized)} lines for {len(wavs)} files")
    same_text = sum(int(a[1:] == b[1:]) for a, b in zip(served, recognized))
    check(same_text == len(wavs),
          f"pipeline recognize: {len(wavs) - same_text} hypotheses differ from serve's")
    aligned = pipeline_align(torch, stage, recipe, expdir, seconds, launches)

    # the n-gram LM end to end: cli lm on the training transcriptions, cli
    # decode with it (a copy of the recipe whose recognizer.cfg names it at
    # LM_WEIGHT), cli rescore of that n-best, and an export carrying it,
    # whose served lines must be the fused decode's best hypotheses
    from nabu_tpu_torch.config import ConfigFile

    text, seconds["lm"], launches["lm"] = stage("lm", ["lm", *args])
    lm_path = os.path.join(expdir, "lm", "lm_3gram.npz")
    check(os.path.exists(lm_path) and "train ppl" in text, f"pipeline lm: {text!r}")
    recipe_lm = os.path.join(expdir, "recipe_lm")
    shutil.copytree(recipe, recipe_lm)
    rcfg = ConfigFile.read(os.path.join(recipe_lm, "recognizer.cfg"))
    rcfg.section("recognizer").set("lm_path", lm_path)
    rcfg.section("recognizer").set("lm_weight", str(LM_WEIGHT))
    rcfg.write(os.path.join(recipe_lm, "recognizer.cfg"))
    args_lm = ["--recipe", recipe_lm, "--expdir", expdir]
    text, seconds["decode_lm"], launches["decode_lm"] = stage("decode_lm", ["decode", *args_lm])
    rtf_lm = re.search(r"steady-state RTF ([0-9.eE+-]+)", text)
    with open(os.path.join(expdir, "decoded", "nbest.txt")) as f:
        nbest_lm = [(line.split(" ", 2) + [""])[:3] for line in f.read().splitlines()]
    check({u for u, _, _ in nbest_lm} == set(utts) and all(
        math.isfinite(float(sc)) for _, sc, _ in nbest_lm),
        f"pipeline decode_lm: nbest.txt holds {len({u for u, _, _ in nbest_lm})} of "
        f"{len(utts)} test utterances, or a non-finite score")
    best_lm = {}
    for u, _, hyp in nbest_lm:
        best_lm.setdefault(u, hyp.strip())
    _, seconds["rescore"], launches["rescore"] = stage("rescore", ["rescore", *args_lm])
    with open(os.path.join(expdir, "decoded", "rescored.txt")) as f:
        rescored = [(line.split(" ", 2) + [""])[:3] for line in f.read().splitlines()]
    ranked = all(float(a[1]) >= float(b[1]) for a, b in zip(rescored, rescored[1:])
                 if a[0] == b[0])
    check(len(rescored) == len(nbest_lm) and ranked,
          f"pipeline rescore: {len(rescored)} lines for {len(nbest_lm)}, ranked {ranked}")
    art_lm = os.path.join(expdir, "export_lm")
    _, seconds["export_lm"], launches["export_lm"] = stage(
        "export_lm", ["export", *args_lm, "--output", art_lm])
    check("lm.npz" in os.listdir(art_lm), f"pipeline export_lm: {sorted(os.listdir(art_lm))}")
    with open(requests) as stdin:
        text, seconds["serve_lm"], launches["serve_lm"] = stage(
            "serve_lm", ["serve", "--export_dir", art_lm, "--batch_size", str(PIPELINE_UTTS)],
            stdin=stdin)
    served_lm = [(line.split(" ", 1) + [""])[:2] for line in text.splitlines()]
    same_lm = sum(int(u == w and hyp.strip() == best_lm.get(u)) for (u, hyp), (w, _) in
                  zip(served_lm, wavs))
    check(len(served_lm) == len(wavs) and same_lm == len(wavs),
          f"pipeline serve_lm: {len(wavs) - same_lm} of {len(wavs)} lines differ from the "
          "fused decode's best")
    rnn = pipeline_rnn_lm(torch, stage, recipe, expdir, requests, wavs, utts, seconds,
                          launches)
    out = {
        "phase": "pipeline", "recipe": os.path.relpath(RECIPE, REPO),
        "seconds": seconds, "launches": launches, "test_metric": result["metric"],
        "test_evaluator": result["evaluator"], "test_utterances": len(utts),
        "nbest_lines": len(nbest), "decode_steady_rtf": float(rtf.group(1)) if rtf else None,
        "export_params_bit_identical": same, "manifest": manifest,
        "served": len(served), "recognize_equals_serve": same_text,
        "decode_lm_steady_rtf": float(rtf_lm.group(1)) if rtf_lm else None,
        "rescored_lines": len(rescored), "serve_lm_equals_decode_lm": same_lm,
        "lm_hypotheses_changed": sum(int(a[1:] != b[1:]) for a, b in zip(served, served_lm)),
        **rnn, **aligned, "card": smi,
    }
    emit(out)
    return out


def pipeline_align(torch, stage, recipe: str, expdir: str, seconds: dict,
                   launches: dict) -> dict:
    """``cli align`` on the pipeline's expdir over the recognizer's split
    (the dev split): the v2 inference kernels launch and no loss kernel;
    ``align.ctm`` covers every utterance, each one's tokens its targets in
    order. On the first batch: the Viterbi on the card against the CPU
    over the same f32 log-probs (frame labels identical, path scores
    within TOL["align_scores"]); each feasible path score at most the CTC
    log-likelihood ``ctc_alpha`` gives for those log-probs; and the
    planted skip into a repeated label (``align_repeat_skip``), which must
    break a segment list on the batch's label emissions
    (``label_emissions``; its reading on the real log-probs is reported)."""
    from nabu_tpu_torch.config import Conf, Recipe
    from nabu_tpu_torch.data.pipeline import batch_to_arrays, batch_to_device
    from nabu_tpu_torch.decoding.align import ctc_forced_align
    from nabu_tpu_torch.ops import ctc_batched
    from nabu_tpu_torch.ops.ctc import ctc_feasible
    from nabu_tpu_torch.scripts.align import ctc_head, head_logprobs
    from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe
    from nabu_tpu_torch.scripts.test import load_best_params

    _, seconds["align"], launches["align"] = stage(
        "align", ["align", "--recipe", recipe, "--expdir", expdir])
    r = Recipe(recipe)
    rconf = r.recognizer.section("recognizer")
    sections = Conf({"features": rconf["features"], "targets": rconf["targets"]})
    model, meta = model_from_recipe(r, expdir, sections["features"], sections["targets"])
    loader, _, _ = make_loader(r, expdir, sections, batch_size=rconf.getint("batch_size", 16),
                               num_buckets=rconf.getint("num_buckets", 1))
    alphabet = meta["alphabet"]
    want, first = {}, None
    for batch in loader.epoch(0, shuffle=False):
        first = batch if first is None else first
        for b, utt in enumerate(batch.utt_ids):
            if batch.example_mask[b]:
                want[utt] = [alphabet[i] for i in batch.targets[b, :batch.target_lengths[b]]]
    got = {}
    with open(os.path.join(expdir, "aligned", "align.ctm")) as f:
        for line in f:
            utt, _, start, dur, tok = line.split()
            check(float(start) >= 0.0 and float(dur) > 0.0, f"pipeline align: line {line!r}")
            got.setdefault(utt, []).append(tok)
    check(set(got) == set(want),
          f"pipeline align: align.ctm covers {len(got)} of {len(want)} utterances")
    collapsed = sum(int(got[u] == want[u]) for u in want)
    check(collapsed == len(want),
          f"pipeline align: {len(want) - collapsed} utterances' segments are not their targets")

    dev = torch.device("cuda")
    head = ctc_head(model)
    blank = model.decoders[head].blank_id
    arrays = batch_to_device(batch_to_arrays(first), dev, model.compute_dtype)
    logprobs, lengths = head_logprobs(model, load_best_params(expdir, dev), head, arrays)
    logprobs = logprobs.contiguous()
    tg, tl = arrays["targets"], arrays["target_lengths"]
    check(blank == logprobs.shape[2] - 1, f"pipeline align: blank {blank} is not the last id")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = ctc_forced_align(logprobs, lengths, tg, tl, blank)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = ctc_forced_align(logprobs.cpu(), lengths.cpu(), tg.cpu(), tl.cpu(), blank)
    t2 = time.perf_counter()
    same = torch.equal(card[0].cpu(), cpu[0])
    score_err = float((card[1].cpu() - cpu[1]).abs().max())
    check(same, "pipeline align: the card's frame labels differ from the CPU's")
    check(score_err <= TOL["align_scores"],
          f"pipeline align: path scores card vs CPU {score_err} > {TOL['align_scores']}")
    i32 = [x.to(torch.int32).contiguous() for x in (lengths, tg, tl)]
    _, ll = ctc_batched.ctc_alpha(logprobs, *i32, blank)
    real = (arrays["example_mask"] > 0) & ctc_feasible(lengths, tg, tl).bool()
    slack = (card[1] - ll - TOL["align_ll_rel"] * ll.abs())[real]
    check(bool((slack <= 0).all()),
          f"pipeline align: a path score above its CTC log-likelihood ({float(slack.max())})")

    rows = [b for b in range(len(first.utt_ids)) if bool(real[b])]

    def broken(frames):
        return sum(not collapses_to(frames[b], lengths[b], tg[b, :tl[b]], blank) for b in rows)

    sharp = torch.as_tensor(label_emissions(tg.cpu().numpy(), tl.cpu().numpy(),
                                            lengths.cpu().numpy(), logprobs.shape[1],
                                            logprobs.shape[2]), device=dev)
    right = ctc_forced_align(sharp, lengths, tg, tl, blank)[0]
    with align_repeat_skip():
        faulty = ctc_forced_align(sharp, lengths, tg, tl, blank)[0]
        faulty_real = ctc_forced_align(logprobs, lengths, tg, tl, blank)[0]
    check(broken(right) == 0, "pipeline align: the label emissions' alignment breaks")
    if broken(faulty) == 0:
        FAILURES.append("pipeline align: the planted skip into a repeated label passes")
    repeats = sum(int(bool((tg[b, 1:tl[b]] == tg[b, :tl[b] - 1]).any())) for b in rows)
    return {"align_utterances": len(got), "align_collapsed": collapsed,
            "align_batch_shape": list(logprobs.shape),
            "align_card_equals_cpu": same, "align_score_max_abs_err": score_err,
            "align_score_tol": TOL["align_scores"],
            "align_ll_slack_max": float((card[1] - ll)[real].max()),
            "align_viterbi_card_s": t1 - t0, "align_viterbi_cpu_s": t2 - t1,
            "align_rows_with_repeats": repeats,
            "align_fault_broken": broken(faulty), "align_fault_rows": len(rows),
            "align_fault_real_broken": broken(faulty_real),
            "align_fault_real_frames_differ": sum(
                int(not torch.equal(faulty_real[b], card[0][b])) for b in rows)}


def pipeline_rnn_lm(torch, stage, recipe: str, expdir: str, requests: str, wavs, utts,
                    seconds: dict, launches: dict) -> dict:
    """The neural LM end to end on the pipeline's expdir: ``cli lm --type
    rnn`` (the JAX defaults, on the card), ``cli rescore`` with it over the
    decode_lm n-best twice over (more lines than one walk group: each
    line's score must equal its score alone, bit for bit), ``cli decode``
    with it (a copy of the recipe naming it at LM_WEIGHT), ``cli export``
    (the artifact carries it as ``lm.npz``) and ``cli serve`` over that
    export, whose lines must be the fused decode's best hypotheses."""
    from nabu_tpu_torch.config import ConfigFile, Recipe
    from nabu_tpu_torch.data.processors import TextProcessor
    from nabu_tpu_torch.decoding.neural_lm import RnnLM, walk_rows
    from nabu_tpu_torch.scripts.rescore import _text_to_ids

    args = ["--recipe", recipe, "--expdir", expdir]
    text, seconds["lm_rnn"], launches["lm_rnn"] = stage("lm_rnn", ["lm", *args, "--type", "rnn"])
    lm_path = os.path.join(expdir, "lm", "lm_rnn.npz")
    check(os.path.exists(lm_path) and "train ppl" in text, f"pipeline lm_rnn: {text!r}")
    for name in ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh"):
        check(launches["lm_rnn"][name] == 500,
              f"pipeline lm_rnn: {launches['lm_rnn']} in 500 training steps")

    # rescoring: the decode_lm n-best and a second copy under other ids
    resc = os.path.join(expdir, "rescore_rnn")
    os.makedirs(os.path.join(resc, "decoded"))
    with open(os.path.join(expdir, "decoded", "nbest.txt")) as f:
        lines = f.read().splitlines()
    lines += [f"{line.split(' ', 1)[0]}_b {line.split(' ', 1)[1]}" for line in lines]
    with open(os.path.join(resc, "decoded", "nbest.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    lm = RnnLM.load(lm_path, "cuda")
    check(len(lines) > walk_rows(lm.num_units),
          f"pipeline rescore_rnn: {len(lines)} lines fit one group")
    _, seconds["rescore_rnn"], launches["rescore_rnn"] = stage(
        "rescore_rnn", ["rescore", "--recipe", recipe, "--expdir", resc, "--lm", lm_path])
    with open(os.path.join(resc, "decoded", "rescored.txt")) as f:
        rescored = [(line.split(" ", 2) + [""])[:3] for line in f.read().splitlines()]
    ranked = all(float(a[1]) >= float(b[1]) for a, b in zip(rescored, rescored[1:])
                 if a[0] == b[0])
    check(len(rescored) == len(lines) and ranked,
          f"pipeline rescore_rnn: {len(rescored)} lines for {len(lines)}, ranked {ranked}")
    tconf = Recipe(recipe).database.section(
        Recipe(recipe).recognizer.section("recognizer")["targets"])
    proc = TextProcessor(tconf)
    ids = [_text_to_ids(proc, tconf.get("tokenizer", "word"), (line.split(" ", 2) + [""])[2])
           for line in lines]
    grouped = lm.seq_logprobs(ids)
    alone = np.concatenate([lm.seq_logprobs([x]) for x in ids])
    same_bits = int((grouped == alone).sum())
    check(same_bits == len(ids),
          f"pipeline rescore_rnn: {len(ids) - same_bits} grouped scores differ from alone")

    # fused decode, an export carrying the LM, serve over it
    recipe_rnn = os.path.join(expdir, "recipe_rnn")
    shutil.copytree(recipe, recipe_rnn)
    rcfg = ConfigFile.read(os.path.join(recipe_rnn, "recognizer.cfg"))
    rcfg.section("recognizer").set("lm_path", lm_path)
    rcfg.section("recognizer").set("lm_weight", str(LM_WEIGHT))
    rcfg.write(os.path.join(recipe_rnn, "recognizer.cfg"))
    args_rnn = ["--recipe", recipe_rnn, "--expdir", expdir]
    text, seconds["decode_rnn"], launches["decode_rnn"] = stage("decode_rnn",
                                                                ["decode", *args_rnn])
    rtf = re.search(r"steady-state RTF ([0-9.eE+-]+)", text)
    best = {}
    with open(os.path.join(expdir, "decoded", "nbest.txt")) as f:
        for u, sc, hyp in ((line.split(" ", 2) + [""])[:3] for line in f.read().splitlines()):
            check(math.isfinite(float(sc)), f"pipeline decode_rnn: score {sc}")
            best.setdefault(u, hyp.strip())
    check(set(best) == set(utts), f"pipeline decode_rnn: {len(best)} of {len(utts)} utterances")
    art = os.path.join(expdir, "export_rnn")
    _, seconds["export_rnn"], launches["export_rnn"] = stage(
        "export_rnn", ["export", *args_rnn, "--output", art])
    with np.load(os.path.join(art, "lm.npz")) as z:
        check(str(z["kind"]) == "rnn", "pipeline export_rnn: the artifact's LM is not the RNN LM")
    with open(requests) as stdin:
        text, seconds["serve_rnn"], launches["serve_rnn"] = stage(
            "serve_rnn", ["serve", "--export_dir", art, "--batch_size", str(PIPELINE_UTTS)],
            stdin=stdin)
    served = [(line.split(" ", 1) + [""])[:2] for line in text.splitlines()]
    same = sum(int(u == w and hyp.strip() == best.get(u)) for (u, hyp), (w, _) in
               zip(served, wavs))
    check(len(served) == len(wavs) and same == len(wavs),
          f"pipeline serve_rnn: {len(wavs) - same} of {len(wavs)} lines differ from the fused "
          "decode's best")
    return {"rnn_rescored_lines": len(rescored), "rnn_grouped_bits_equal": same_bits,
            "decode_rnn_steady_rtf": float(rtf.group(1)) if rtf else None,
            "serve_rnn_equals_decode_rnn": same}


def encoder_flops(model: str, B: int, T: int, F: int = 80) -> float:
    """Multiply-adds x 2 of the bench line's attention encoder forward
    (``bench.build_model_and_loss``'s config) over B utterances of T frames
    (T / 4 after the pyramid stack, every frame valid): in_proj, each
    block's products (QKV, the scores and the weighted sum over all T / 4
    keys, the output projection, the FFNs, and a conformer's pointwise
    and depthwise convolutions; an MoE FFN's router and its 2 x tokens
    expert slots at capacity 2), layer norms and softmax left out."""
    from nabu_tpu_torch import bench

    layers, d = bench.MODELS[model]
    f = 4 * d
    Tq = -(-T // 4)
    N = B * Tq
    mhsa = 2 * N * d * 3 * d + 2 * 2 * B * Tq * Tq * d + 2 * N * d * d
    ffn = 2 * 2 * N * d * f
    if model == "transformer":
        block = mhsa + ffn
    else:
        block = mhsa + 2 * ffn + 2 * N * d * 2 * d + 2 * N * d * 15 + 2 * N * d * d
        if model == "moe_conformer":
            # the router, and the experts' 2N token slots: one FFN's work more
            block += 2 * N * d * 8 + ffn
    return 2 * N * 4 * F * d + layers * block


def phase_bench(model: str, phase: str, recipe_phase: str) -> dict:
    """A bench line of the port (``nabu_tpu_torch.bench.train_line``, as
    ``python -m nabu_tpu_torch.bench --model <model>`` prints it) in
    process: the 4x320 DBLSTM-CTC step (``dblstm``), the transducer step
    (``rnnt``) or an attention encoder's (``conformer_rnnt``,
    ``moe_conformer``) at B = 32, T = 1000, bf16, through the kernels; its
    launches must be ``recipe_phase``'s per-step launches x the steps run
    (the same layers), and its losses finite. An attention line also
    prints its encoder's forward FLOPs (``encoder_flops``) and the bound of
    a training step, 3 x those at the bf16 tensor-core rate."""
    from nabu_tpu_torch import bench

    line = bench.train_line(model_name=model)
    extra = {}
    if model in bench.ATTENTION_HEADS:
        flops = encoder_flops(model, line["batch"], line["frames"])
        extra = {"encoder_forward_tflop": flops / 1e12,
                 "encoder_step_bound_ms": 3 * flops / PEAK_BF16 * 1e3}
    print(json.dumps({"phase": phase, **line, **extra}), flush=True)
    runs = line["warmup"] + line["steps"] * line["repeats"]
    want = {k: n * runs for k, n in STEP_LAUNCHES[recipe_phase].items()}
    check(line["launches"] == want, f"{phase}: launches {line['launches']}, want {want}")
    check(math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"]),
          f"{phase}: a loss is not finite")
    return {"launches": line["launches"]}


def las_decode(torch, smi: str, recipe: str, expdir: str, model, dev_audio_s: float) -> dict:
    """The recipe's validation evaluator (attention_greedy over the dev
    set at its B = 64) on the trained checkpoint (``best/``, which the
    trainer writes at its end when validation never ran): launch counts
    zeroed just before and read just after (the v1 inference walk must
    run, no training kernel), RTF over the dev audio; then one dev batch
    in f32 on the card against the same search on the CPU (ids identical
    required in f32, not in bf16, where near-ties may flip)."""
    from nabu_tpu_torch.config import ConfigFile, Recipe
    from nabu_tpu_torch.evaluators import build_evaluator
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.params import load_npz
    from nabu_tpu_torch.scripts.common import make_loader

    dev = torch.device("cuda")
    rec = Recipe(recipe)
    vconf = rec.validation_evaluator.section("evaluator")
    vloader, _, _ = make_loader(rec, expdir, vconf, batch_size=vconf.getint("batch_size"),
                                num_buckets=vconf.getint("num_buckets", 2))
    params = load_npz(os.path.join(expdir, "checkpoints", "best", "params.npz"), device=dev)
    evaluator = build_evaluator(vconf, model, vloader)
    check(type(evaluator.recognizer).__name__ == "AttentionGreedyRecognizer",
          "train_las: the validation recognizer is not attention_greedy")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cer = evaluator(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    gemm_variants("train_las decode")
    batches = vloader.num_batches()
    for name in kernels.KERNELS:
        want_some = name in LAS_DECODE_KERNELS
        check((launches[name] > 0) == want_some,
              f"las decode: {launches[name]} launches of {name}")
    check(launches["blstm_v1_recur"] == 5 * batches,
          f"las decode: {launches['blstm_v1_recur']} v1 walks for {batches} batches")

    # one dev batch in f32: the card's ids against the CPU's
    with open(os.path.join(recipe, "model.cfg")) as f:
        cfg = f.read().replace("compute_dtype = bfloat16", "compute_dtype = float32")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "model.cfg"), "w") as f:
            f.write(cfg)
        m32 = build_model(ConfigFile.read(os.path.join(tmp, "model.cfg")),
                          model.encoder.input_dim, model.decoders["decoder"].num_labels)
    rec32 = type(evaluator.recognizer)(vconf, m32)
    batch = next(iter(vloader.epoch(0, shuffle=False)))
    real = int(batch.example_mask.sum())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launch_counts()
    ids_g, len_g, sc_g = rec32.search(params, batch.features, batch.feature_lengths)
    f32_walks = kernels.launch_counts()["blstm_v1_recur"]
    params_cpu = load_npz(os.path.join(expdir, "checkpoints", "best", "params.npz"))
    ids_c, len_c, sc_c = rec32.search(params_cpu, batch.features, batch.feature_lengths)
    same = sum(int(torch.equal(len_g[b].cpu(), len_c[b])
                   and torch.equal(ids_g[b, : int(len_c[b])].cpu(), ids_c[b, : int(len_c[b])]))
               for b in range(real))
    score_err = float((sc_g[:real].cpu() - sc_c[:real]).abs().max())
    check(f32_walks == 5, f"las decode f32: {f32_walks} v1 walks on the card, want 5")
    check(same == real, f"las decode f32: card and CPU ids differ on {real - same}/{real}")
    out = {
        "phase": "train_las_decode", "recognizer": "attention_greedy",
        "batch_size": int(batch.features.shape[0]), "batches": batches,
        "dev_audio_seconds": dev_audio_s, "wall_seconds": wall, "rtf": wall / dev_audio_s,
        "cer": cer, "launches": launches, "f32_ids_identical": same, "f32_utterances": real,
        "f32_score_max_abs_err": score_err, "card": smi,
    }
    emit(out)
    return out


def joint_test(torch, smi: str, recipe: str, expdir: str, dev_audio_s: float,
               phase: str = "train_joint") -> dict:
    """``cli test`` on train_joint's (or train_mwer's) expdir: the recipe's
    test evaluator, attention_beam on ``head = att`` (beam 16) over the dev
    split at batch 32 (the v2 inference kernels, and no other), its error
    and wall time."""
    from nabu_tpu_torch import cli
    from nabu_tpu_torch.ops import kernels

    out = io.StringIO()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["test", "--recipe", recipe, "--expdir", expdir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(out.getvalue(), file=sys.stderr, flush=True)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    gemm_variants(f"{phase} test")
    with open(os.path.join(expdir, "test_result.json")) as f:
        result = json.load(f)
    check(math.isfinite(result["metric"]), f"{phase} test: error {result['metric']}")
    check(set(launches) == set(DECODE_KERNELS),
          f"{phase} test: launched {launches}, want each of {DECODE_KERNELS} and no other")
    line = {"phase": f"{phase}_test", "recognizer": "attention_beam", "head": "att",
            "beam_width": 16, "error": result["metric"], "wall_seconds": wall,
            "dev_audio_seconds": dev_audio_s, "rtf": wall / dev_audio_s, "launches": launches,
            "card": smi}
    emit(line)
    return line


def transducer_test(torch, smi: str, recipe: str, expdir: str, dev_audio_s: float) -> dict:
    """``cli test`` on train_conformer_rnnt's expdir: the recipe's test
    evaluator, transducer_greedy (4 symbols a frame) over the dev split at
    batch 32: its error and wall time; the joint's encoder projection
    (``lstm_proj``) once a batch, and no other kernel."""
    from nabu_tpu_torch import cli
    from nabu_tpu_torch.ops import kernels

    out = io.StringIO()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["test", "--recipe", recipe, "--expdir", expdir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(out.getvalue(), file=sys.stderr, flush=True)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    gemm_variants("train_conformer_rnnt test")
    with open(os.path.join(expdir, "test_result.json")) as f:
        result = json.load(f)
    check(math.isfinite(result["metric"]), f"train_conformer_rnnt test: {result['metric']}")
    check(set(launches) == {"lstm_proj"},
          f"train_conformer_rnnt test: launched {launches}, want lstm_proj and no other")
    line = {"phase": "train_conformer_rnnt_test", "recognizer": "transducer_greedy",
            "error": result["metric"], "wall_seconds": wall, "dev_audio_seconds": dev_audio_s,
            "rtf": wall / dev_audio_s, "launches": launches, "card": smi}
    emit(line)
    return line


# train_mwer: MWER sequence training from train_joint's trained weights
MWER_STEPS = 10
MWER_N = 4
# the trainer.cfg keys patched in (JAX's defaults for beam and CE weight)
MWER_TRAINER = {"mwer": "true", "mwer_beam": str(MWER_N), "mwer_ce_weight": "0.01",
                "ema_decay": "0.999", "profile_start": "3", "profile_stop": "5",
                "log_frequency": "1"}
# kernels the profiler window's trace must name (device events)
MWER_TRACE_KERNELS = ("v1_walk_kernel", "v1_chain_kernel", "ctc_alpha_kernel",
                      "ctc_beta_kernel")


@contextlib.contextmanager
def mwer_timers(torch, record: dict):
    """Synchronized host timers of an MWER step's parts, summed a step:
    the N-best search (``ops.mwer.attention_beam_search``), the encoder
    passes (``Model.encode`` without gradients, the search's, and with
    them), the teacher-forced re-scoring (``Speller.apply`` over B x N
    rows; its other calls are the CE term's) and the edit distance. Also
    each step's error counts [B, N] of the utterances with a reference,
    the launch counts after each optimizer step and the first batch.
    Inside ``step_timers``, whose forward + loss, backward and optimizer it
    splits."""
    from nabu_tpu_torch.models.decoders import Speller
    from nabu_tpu_torch.models.model import Model
    from nabu_tpu_torch.ops import kernels, mwer
    from nabu_tpu_torch.training.trainer import Trainer

    record["_step"] = 0

    def clocked(key_of, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            per = record.setdefault(key_of(*a, **kw), {})
            per[record["_step"]] = per.get(record["_step"], 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    saved = {(mwer, "attention_beam_search"): mwer.attention_beam_search,
             (mwer, "token_edit_distance"): mwer.token_edit_distance,
             (Model, "encode"): Model.encode, (Speller, "apply"): Speller.apply,
             (Trainer, "_loss"): Trainer._loss, (Trainer, "_apply_grads"): Trainer._apply_grads}

    def loss(self, params, batch, generator):
        record.setdefault("first_batch", batch)
        return saved[(Trainer, "_loss")](self, params, batch, generator)

    def encode(self, params, features, *a, **kw):
        record["model"], record["B"] = self, int(features.shape[0])
        return saved[(Model, "encode")](self, params, features, *a, **kw)

    def edit_distance(hyps, hyp_lengths, refs, ref_lengths):
        errs = saved[(mwer, "token_edit_distance")](hyps, hyp_lengths, refs, ref_lengths)
        real = (ref_lengths > 0).reshape(-1, MWER_N)[:, 0]
        record.setdefault("errs", []).append(errs.reshape(-1, MWER_N)[real].cpu())
        return errs

    def apply_grads(self, *a, **kw):
        out = saved[(Trainer, "_apply_grads")](self, *a, **kw)
        record.setdefault("launch_snaps", []).append(dict(kernels.launch_counts()))
        record["_step"] += 1
        return out

    mwer.attention_beam_search = clocked(lambda *a, **kw: "search",
                                         saved[(mwer, "attention_beam_search")])
    mwer.token_edit_distance = clocked(lambda *a, **kw: "edit_distance", edit_distance)
    Model.encode = clocked(
        lambda *a, **kw: "encoder_grad" if torch.is_grad_enabled() else "encoder_search", encode)
    Speller.apply = clocked(
        lambda self, params, encoded, *a, **kw:
        "rescoring" if encoded.shape[0] == record["B"] * MWER_N else "speller_ce",
        saved[(Speller, "apply")])
    Trainer._loss = loss
    Trainer._apply_grads = apply_grads
    try:
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)


def mwer_gradient_check(torch, model, params, batch) -> dict:
    """One batch, dropout off, ``mwer_ce_weight = 0``: the MWER loss and
    every parameter gradient through the kernels against the plain
    versions, both fed the same N-best (searched once, through the
    kernels: the beams may rank near-ties otherwise on the two paths), in
    f32 at train_joint's tolerances (Listener and CTC head train_grads,
    Speller train_grads_speller); the gradient must not be 0 (it is 0 for
    an utterance whose N-best holds one error count), and the kernel path
    with the planted fault (``mwer_refs_tiled``: each hypothesis scored
    against another utterance's reference) must exceed them; the eos term
    left out of each score (``mwer_eos_dropped``) is reported, one term of
    ~100 in a long hypothesis. The same in bf16 is reported: the MWER
    gradient is a difference of hypotheses' log-prob gradients that share
    most of their terms, which amplifies bf16 rounding (0.11-1.6 in PR 24
    call 3, against train_joint's 0.0024-0.022 for its CE + CTC loss)."""
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.ops.mwer import make_mwer_loss_computer, token_edit_distance
    from nabu_tpu_torch.params import flatten, unflatten

    loss_fn = make_mwer_loss_computer(
        model, Conf({"mwer_beam": str(MWER_N), "mwer_ce_weight": "0"}))
    flat = {k: v.detach() for k, v in flatten(params).items()}

    def rel(grads, ref):
        return {k: float(torch.linalg.vector_norm((grads[k] - ref[k]).float())
                         / torch.linalg.vector_norm(ref[k].float()).clamp(min=1e-30))
                for k in ref}

    def worst(prefix, table):
        return max(v for k, v in table.items() if k.startswith(prefix))

    def tol(k):
        return TOL["train_grads_speller" if k.startswith("decoders/att/") else "train_grads"]

    runs = {}
    compute_dtype = model.compute_dtype
    try:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model.compute_dtype = dtype
            b = dict(batch, features=batch["features"].to(dtype))
            nbest = loss_fn.search(unflatten(flat), b)

            def loss_and_grads():
                leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
                loss, metrics = loss_fn(unflatten(leaves), b, None, False, nbest=nbest)
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
                return loss.detach(), metrics, {k: torch.zeros_like(v) if g is None else g
                                                for (k, v), g in zip(leaves.items(), grads)}

            t0 = time.perf_counter()
            kernel = loss_and_grads()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with plain_versions():
                plain = loss_and_grads()
            torch.cuda.synchronize()
            runs[tag] = {"nbest": nbest, "kernel": kernel, "plain": plain,
                         "kernel_step_s": t1 - t0, "plain_step_s": time.perf_counter() - t1}
            if tag == "f32":
                with mwer_refs_tiled(MWER_N):
                    runs[tag]["fault"] = loss_and_grads()
                with mwer_eos_dropped(nbest[0].shape[0] * MWER_N):
                    runs[tag]["eos_fault"] = loss_and_grads()
    finally:
        model.compute_dtype = compute_dtype

    f32 = runs["f32"]
    loss_k, metrics, grads_k = f32["kernel"]
    loss_p, _, grads_p = f32["plain"]
    rel_k, rel_f = rel(grads_k, grads_p), rel(f32["fault"][2], grads_p)
    rel_e = rel(f32["eos_fault"][2], grads_p)
    rel_b = rel(runs["bf16"]["kernel"][2], runs["bf16"]["plain"][2])
    # the utterances whose N-best holds more than one error count
    seqs, lens = f32["nbest"]
    B = seqs.shape[0]
    errs = token_edit_distance(
        seqs.reshape(B * MWER_N, -1), lens.reshape(-1),
        torch.repeat_interleave(batch["targets"], MWER_N, dim=0),
        torch.repeat_interleave(batch["target_lengths"], MWER_N, dim=0)).reshape(B, MWER_N)
    real = batch["target_lengths"] > 0
    spread = float((errs.max(1).values > errs.min(1).values)[real].float().mean())
    for k, g in grads_k.items():
        check(bool(torch.isfinite(g).all()), f"train_mwer gradient {k}: non-finite")
    norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_k.values())))
    check(norm > 0.0, "train_mwer: the MWER gradient is 0 (every N-best one error count?)")
    loss_err = compare(torch, loss_k, loss_p, TOL["train_loss"], "train_mwer batch loss")
    over = {k: v for k, v in rel_k.items() if v > tol(k)}
    if over:
        FAILURES.append(f"train_mwer gradients: relative errors beyond tolerance: {over}")
    if not any(v > tol(k) for k, v in rel_f.items()):
        FAILURES.append(f"train_mwer gradients: the planted fault ({max(rel_f.values())}) "
                        "passes the tolerance")
    return {"dtype": "f32", "batch_shape": list(batch["features"].shape),
            "nbest_shape": list(seqs.shape), "loss_kernels": float(loss_k),
            "loss_plain": float(loss_p), "loss_max_abs_err": loss_err,
            "loss_tol": TOL["train_loss"],
            "expected_errors": float(metrics["mwer/expected_errors"]),
            "oracle_errors": float(metrics["mwer/oracle_errors"]), "grad_norm": norm,
            "nbest_spread_share": spread,
            "listener_grads_max_rel_err": worst("encoder/", rel_k),
            "speller_grads_max_rel_err": worst("decoders/att/", rel_k),
            "ctc_head_grads_max_rel_err": worst("decoders/ctc/", rel_k),
            "grads_tol": TOL["train_grads"], "grads_tol_speller": TOL["train_grads_speller"],
            "fault": "each hypothesis scored against another utterance's reference",
            "fault_listener_grads_max_rel_err": worst("encoder/", rel_f),
            "fault_speller_grads_max_rel_err": worst("decoders/att/", rel_f),
            "eos_fault_listener_grads_max_rel_err": worst("encoder/", rel_e),
            "eos_fault_speller_grads_max_rel_err": worst("decoders/att/", rel_e),
            "bf16_listener_grads_max_rel_err": worst("encoder/", rel_b),
            "bf16_speller_grads_max_rel_err": worst("decoders/att/", rel_b),
            "bf16_loss_kernels_plain": [float(runs["bf16"][k][0]) for k in ("kernel", "plain")],
            **{f"{tag}_{k}": runs[tag][k] for tag in runs
               for k in ("kernel_step_s", "plain_step_s")}}


def phase_train_mwer(torch, smi: str, corpus: dict) -> dict:
    """MWER fine-tuning of joint_ctc_att_multihost at its full width: ``cli
    train`` (MWER_STEPS steps, B = 64) from train_joint's trained
    checkpoint (``pretrained_dir``) on a copy of train_las's prepared data,
    with trainer.cfg's MWER_TRAINER keys (mwer, beam 4, CE weight 0.01,
    ema_decay 0.999, a profiler window of two steps). Each step's
    ``loss/mwer``, expected and oracle errors, the share of utterances
    whose N-best holds more than one error count (only those carry an
    MWER gradient), its time split (search, encoder passes, re-scoring,
    loss, backward, optimizer) and launches: the search pass's inference
    walks and the gradient pass's training kernels and the CTC kernels,
    every step. Then the gradient check (``mwer_gradient_check``),
    ``best/`` (the average as params, the raw weights beside it, the last
    step's), the profiler's trace and ``cli test``."""
    from nabu_tpu_torch import cli
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.ops import blstm as blstm_ops
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.params import flatten, load_npz, unflatten

    phase, donor = "train_mwer", "train_las"
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase}_") as tmp:
        recipe = write_train_recipe(JOINT_RECIPE, os.path.join(tmp, "recipe"),
                                    corpus["train_las"][:2], corpus["dev"][:2], MWER_STEPS)
        tc = ConfigFile.read(os.path.join(recipe, "trainer.cfg"))
        for key, value in {**MWER_TRAINER,
                           "pretrained_dir": corpus["joint_checkpoint"]}.items():
            tc.section("trainer").set(key, value)
        tc.write(os.path.join(recipe, "trainer.cfg"))
        expdir = os.path.join(tmp, "exp")
        sections, keep = corpus[f"prepared_{donor}"]
        check(_data_sections(recipe) == sections,
              f"{phase}: database.conf differs from {donor}'s; its data cannot be reused")
        shutil.copytree(keep, os.path.join(expdir, "data"))

        record: dict = {}
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with step_timers(torch, record), mwer_timers(torch, record), \
                contextlib.redirect_stdout(sys.stderr):
            cli.main(["train", "--recipe", recipe, "--expdir", expdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = kernels.launch_counts()
        gemm_variants(phase)
        steps = len(record["loss"])
        check(steps == MWER_STEPS, f"{phase}: {steps} steps, want {MWER_STEPS}")

        # each step's launches: the search pass's projections and inference
        # walks (the family kernel_family picks at B = 64, H = 512), and the
        # gradient pass's as train_joint's step
        B = record["B"]
        units = record["model"].encoder.num_units
        walk = {"v1": "blstm_v1_recur", "v2": "blstm_recur"}[blstm_ops.kernel_family(B, units)]
        layers = STEP_LAUNCHES["train_joint"]["blstm_proj"]
        per_step = {**STEP_LAUNCHES["train_joint"], "blstm_proj": 2 * layers, walk: layers}
        snaps = [dict.fromkeys(kernels.KERNELS, 0)] + record["launch_snaps"]
        step_launches = [{k: b[k] - a.get(k, 0) for k in b if b[k] - a.get(k, 0)}
                         for a, b in zip(snaps, snaps[1:])]
        for i, got in enumerate(step_launches):
            check(got == per_step, f"{phase} step {i + 1}: launched {got}, want {per_step}")

        with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
            logged = {r["step"]: r for r in map(json.loads, f) if "train/loss" in r}
        parts = ("search", "encoder_search", "encoder_grad", "rescoring", "speller_ce",
                 "edit_distance")
        split = []
        for i in range(steps):
            ms = {k: 1e3 * record.get(k, {}).get(i, 0.0) for k in parts}
            fwd = 1e3 * record["forward_loss"][i]
            ms["loss"] = fwd - sum(ms[k] for k in ("search", "encoder_search", "encoder_grad",
                                                   "rescoring"))
            ms.update(backward=1e3 * record["backward"][i],
                      optimizer=1e3 * record["optimizer"][i], forward_loss=fwd)
            split.append(ms)
            errs = record["errs"][i]
            row = logged[i + 1]
            check(all(math.isfinite(row[k]) for k in ("train/loss", "train/loss/mwer")),
                  f"{phase} step {i + 1}: a non-finite loss")
            emit({"phase": f"{phase}_step", "step": i + 1, "loss": row["train/loss"],
                  "loss_mwer": row["train/loss/mwer"],
                  "expected_errors": row["train/mwer/expected_errors"],
                  "oracle_errors": row["train/mwer/oracle_errors"],
                  "nbest_spread_share": float((errs.max(1).values > errs.min(1).values)
                                              .float().mean()),
                  "utterances": int(errs.shape[0]), "ms": ms,
                  "launches": step_launches[i]})
        median = {k: float(np.median([m[k] for m in split[1:]])) for k in split[0]}

        # best/: the average as params, the raw weights beside them (the
        # last step's), and latest/ carrying the same average
        ckpt = os.path.join(expdir, "checkpoints")
        best_avg = load_npz(os.path.join(ckpt, "best", "params.npz"))
        best_raw = load_npz(os.path.join(ckpt, "best", "raw_params.npz"))
        latest_avg = load_npz(os.path.join(ckpt, "latest", "ema_params.npz"))
        live = {k: v.detach().cpu() for k, v in flatten(record["params"]).items()}
        avg, raw, lat = flatten(best_avg), flatten(best_raw), flatten(latest_avg)
        check(avg.keys() == raw.keys() == lat.keys() == live.keys(),
              f"{phase}: best/ and latest/ hold other parameter names")
        check(all(torch.equal(raw[k], live[k]) for k in live),
              f"{phase}: best/raw_params is not what the last step trained")
        check(all(torch.equal(avg[k], lat[k]) for k in avg),
              f"{phase}: best/params is not latest/'s ema_params")
        avg_vs_raw = max(float((avg[k] - raw[k]).abs().max()) for k in avg)
        check(avg_vs_raw > 0.0, f"{phase}: best/params equals the raw weights")

        # the profiler window: a Chrome trace naming the training kernels
        # (read as text: two MWER steps' events run to ~10^5)
        trace = os.path.join(expdir, "profile", "rank0.pt.trace.json")
        check(os.path.exists(trace), f"{phase}: no profiler trace at {trace}")
        with open(trace) as f:
            text = f.read()
        device = len(re.findall(r'"cat":\s*"kernel"', text))
        named = {k: text.count(k) for k in MWER_TRACE_KERNELS}
        check(device > 0 and all(named.values()),
              f"{phase}: the profiler trace names {named} ({device} device kernels)")

        # the check's weights are train_joint's (before the first update),
        # its batch the first step's: the later steps' N-best lists carry
        # fewer utterances of more than one error count (PR 24 call 1)
        grad = mwer_gradient_check(torch, record["model"], unflatten(record["initial"]),
                                   record["first_batch"])
        result = {
            "phase": phase, "recipe": os.path.relpath(JOINT_RECIPE, REPO), "steps": steps,
            "trainer": MWER_TRAINER, "pretrained_from": "train_joint", "batch": B,
            "train_wall_seconds": wall, "median_step_ms": median,
            "first_step_ms": split[0], "peak_device_memory_bytes": peak,
            "per_step_launches": per_step, "launches": launches,
            "ema_vs_raw_max_abs": avg_vs_raw, "trace_bytes": os.path.getsize(trace),
            "trace_device_kernels": device, "trace_named": named, "card": smi,
        }
        emit(result)
        emit({"phase": f"{phase}_check", **grad})
        result["test"] = joint_test(torch, smi, recipe, expdir, corpus["dev"][2], phase=phase)
    return result


def phase_bench_las() -> dict:
    """The bench's las line in process (``bench.train_line(model_name="las")``:
    a 4 x 512 Listener, the 2 x 512 Speller and the CTC head, B = 32, T =
    1000, bf16; launches the per-step launches of STEP_LAUNCHES["bench_las"]
    x the steps run), then its ``att`` and ``joint`` decode lines at beam 8
    (the realized width 8, the v2 inference kernels once a layer a decode)."""
    from nabu_tpu_torch import bench

    phase_bench("las", "bench_las", "bench_las")
    launches = {}
    for head in ("att", "joint"):
        line = bench.decode_line(model_name="las", head=head, beam_width=8)
        print(json.dumps({"phase": f"bench_las_{head}", **line}), flush=True)
        decodes = line["repeats"] * line["decodes_per_repeat"]
        check(line["beam_width_realized"] == 8,
              f"bench_las {head}: realized width {line['beam_width_realized']}")
        check(line["launches"] == {"blstm_proj": 5 * decodes, "blstm_recur": 5 * decodes},
              f"bench_las {head}: launches {line['launches']} for {decodes} decodes")
        launches[head] = line["launches"]
    return {"launches": {k: sum(v.get(k, 0) for v in launches.values())
                         for k in ("blstm_proj", "blstm_recur")}}


# ---------------------------------------------------------------------------
# train_dp: data-parallel training, two ranks on the one card
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_RANK_BATCH = 64  # joint_ctc_att_multihost's batch_size: a rank's share
DP_T = 800  # padded frames of every batch (8 s, WSJ's scale)
DP_STEPS = 3  # f32 steps of the equivalence
DP_BF16_STEPS = (2, 4)  # bf16 steps a run: warm-up, timed (6 before train_mwer)
DP_TIMEOUT = 900
DP_DEVICE = "cuda"  # the one-process runs' device (the ranks take their group's)


def dp_recipe_parts():
    """-> (input dim, labels) of the joint recipe's training data."""
    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.data.processors import TextProcessor
    from nabu_tpu_torch.features.computers import make_feature_computer

    r = Recipe(JOINT_RECIPE)
    return (make_feature_computer(r.database.section("trainfeatures")).dim,
            TextProcessor(r.database.section("traintargets")).num_labels)


def dp_batches(seed: int, n: int, lanes: slice, feat_dim: int, num_labels: int) -> list:
    """``n`` global batches of DP_WORLD x DP_RANK_BATCH lanes at DP_T
    frames (seeded), each cut to ``lanes`` as a loader's Batch: ragged
    lengths of DP_T / 3 to DP_T frames, targets of a twelfth of the frames
    (the corpus's ~12 characters a second), lane 5 (rank 0) an example
    CTC cannot align (30 labels in 80 frames, 10 encoder frames) and the
    last lane (the last rank's) a loader's fill lane (length 0, masked)."""
    from nabu_tpu_torch.data.pipeline import Batch

    B = DP_WORLD * DP_RANK_BATCH
    L = -(-(DP_T // 12) // 8) * 8
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(DP_T // 3, DP_T + 1, B).astype(np.int32)
        lengths[0] = DP_T
        tl = np.minimum(lengths // 12, L).astype(np.int32)
        lengths[5], tl[5] = DP_T // 10, min(30, L)
        lengths[-1], tl[-1] = 0, 0
        feats = rng.standard_normal((B, DP_T, feat_dim)).astype(np.float32)
        feats[np.arange(DP_T)[None, :] >= lengths[:, None]] = 0.0
        targets = rng.integers(0, num_labels, (B, L)).astype(np.int32)
        targets[np.arange(L)[None, :] >= tl[:, None]] = 0
        mask = np.ones(B, bool)
        mask[-1] = False
        utts = [f"dp{i}" if mask[i] else "<fill>" for i in range(B)]
        out.append(Batch(feats[lanes], lengths[lanes], targets[lanes], tl[lanes], mask[lanes],
                         utts[lanes]))
    return out


class DPLoader:
    """A loader over fixed batches (the Trainer's interface of
    BucketedLoader): one epoch is the list, in order."""

    def __init__(self, batches):
        self.batches = batches

    def num_batches(self) -> int:
        return len(self.batches)

    def epoch(self, epoch: int, shuffle: bool = True, skip: int = 0):
        yield from self.batches[skip:]


def dp_train(torch, tag: str, steps: int, lanes: slice, expdir: str, keep: bool,
             device) -> dict:
    """The joint recipe's model and trainer (through ``Trainer.train``,
    in this process's group if it has one) for ``steps`` steps on
    ``dp_batches``' lanes ``lanes``. ``tag`` f32: the equivalence's run,
    f32 compute, dropout, SpecAugment and scheduled sampling off, so that
    it draws no noise; bf16: the recipe's model as it is. -> each step's
    loss share and synchronized end, each all-reduce's seconds (the
    gradients' sum over the ranks, synchronized before and after), the
    peak memory, and with ``keep`` the first update's gradients and the
    parameters after it and at the end (on the host)."""
    from nabu_tpu_torch.config import ConfigFile, Recipe
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.parallel import mesh
    from nabu_tpu_torch.params import flatten
    from nabu_tpu_torch.training.trainer import Trainer

    feat_dim, num_labels = dp_recipe_parts()
    cfg = ConfigFile.read(os.path.join(JOINT_RECIPE, "model.cfg"))
    if tag == "f32":
        cfg.section("model").set("compute_dtype", "float32")
        cfg.section("model").set("spec_augment", "false")
        cfg.section("encoder").set("dropout", "0.0")
        cfg.section("att").set("sample_prob", "0.0")
    model = build_model(cfg, feat_dim, num_labels)
    conf = Recipe(JOINT_RECIPE).trainer.section("trainer").copy()
    for key, value in (("num_steps", steps), ("log_frequency", 1), ("valid_frequency", 0),
                       ("ckpt_frequency", 0), ("async_checkpoint", "false")):
        conf.set(key, value)
    record: dict = {"loss": [], "step_end": [], "all_reduce_s": [],
                    "group": mesh.world_size() if mesh.in_group() else None}

    def host(tree):
        return {k: v.detach().cpu().clone() for k, v in flatten(tree).items()}

    class Recorded(Trainer):
        def _loss(self, params, batch, generator):
            out = super()._loss(params, batch, generator)
            record["loss"].append(float(out[0].detach()))
            return out

        def _reduce_grads(self, grads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._reduce_grads(grads)
            torch.cuda.synchronize()
            record["all_reduce_s"].append(time.perf_counter() - t0)
            record["grad_bytes"] = sum(g.numel() * g.element_size() for g in out.values())
            if keep and "grads" not in record:
                record["grads"] = {k: g.detach().cpu().clone() for k, g in out.items()}
            return out

        def _apply_grads(self, params, grads, opt_state, lr_scale):
            out = super()._apply_grads(params, grads, opt_state, lr_scale)
            torch.cuda.synchronize()
            record["step_end"].append(time.perf_counter())
            if keep and "params_1" not in record:
                record["params_1"] = host(params)
            return out

    batches = dp_batches({"f32": 11, "bf16": 12}[tag], steps, lanes, feat_dim, num_labels)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Recorded(conf, model, DPLoader(batches), expdir, device=device)
    with contextlib.redirect_stdout(sys.stderr):
        result = trainer.train(0)
    record["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    record["num_params"] = sum(int(v.numel()) for v in flatten(result["params"]).values())
    if keep:
        record["params_end"] = host(result["params"])
        record["trainer"], record["batch_0"] = trainer, batches[0]
    return record


def dp_naive_grads(torch, trainer, batch) -> dict:
    """The planted fault: the naive recipe's gradient of the first step,
    each rank's loss divided by its own batch's counts, the ranks'
    gradients averaged."""
    from nabu_tpu_torch.data.pipeline import batch_to_arrays, batch_to_device
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.parallel import mesh
    from nabu_tpu_torch.params import flatten, unflatten

    leaves = {k: v.to(trainer.device).requires_grad_(True)
              for k, v in flatten(trainer.init_state(0)["params"]).items()}
    arrays = batch_to_device(batch_to_arrays(batch), trainer.device, trainer.feature_dtype)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    loss, _ = make_loss_computer(trainer.model)(unflatten(leaves), arrays, gen, True)
    grads = list(torch.autograd.grad(loss, list(leaves.values())))
    mesh.all_reduce_sum_(grads)
    return {k: (g / mesh.world_size()).cpu() for k, g in zip(leaves, grads)}


def dp_timing(record: dict) -> dict:
    """The timed steps' median (from one step's synchronized end to the
    next's) and, in a group, the gradients' all-reduce (none runs
    without one)."""
    warm = DP_BF16_STEPS[0]
    ar_s = float(np.median(record["all_reduce_s"][warm:]))
    grouped = record["group"] is not None
    return {"world": record["group"] or 1,
            "median_step_ms": 1e3 * float(np.median(np.diff(record["step_end"][warm - 1:]))),
            "median_all_reduce_ms": 1e3 * ar_s if grouped else None,
            "grad_buffer_bytes": record["grad_bytes"],
            "all_reduce_gb_per_s": record["grad_bytes"] / ar_s / 1e9 if grouped else None,
            "loss_shares": record["loss"],
            "peak_device_memory_bytes": record["peak_device_memory_bytes"]}


def dp_rank_main(rank: int, coordinator: str, out_dir: str) -> int:
    """One rank of train_dp (a process of its own): joins a gloo group of
    DP_WORLD ranks over CUDA tensors on the one card (NCCL refuses two
    ranks on one device), runs the f32 equivalence (saving what the
    parent compares) and the bf16 timing, prints its readings."""
    import torch
    import torch.distributed as dist

    from nabu_tpu_torch.ops.kernels import build
    from nabu_tpu_torch.parallel import mesh

    # the parent built every kernel: a rank loads them, never builds
    missing = [n for n in build.SOURCES if not build.library_path(n).exists()]
    check(not missing, f"train_dp rank {rank}: kernels not built: {missing}")
    device = mesh.init_distributed(coordinator, DP_WORLD, rank, backend="gloo")
    try:
        check(dist.get_backend() == "gloo" and device.type == torch.device(DP_DEVICE).type,
              f"train_dp rank {rank}: group {dist.get_backend()} on {device}")
        lanes = slice(rank * DP_RANK_BATCH, (rank + 1) * DP_RANK_BATCH)
        rec = dp_train(torch, "f32", DP_STEPS, lanes, os.path.join(out_dir, "exp_f32"), True,
                       device)
        naive = dp_naive_grads(torch, rec["trainer"], rec["batch_0"])
        keep = {"params_1": rec["params_1"], "params_end": rec["params_end"]}
        if rank == 0:
            keep.update(grads=rec["grads"], naive=naive)
        torch.save(keep, os.path.join(out_dir, f"rank{rank}.pt"))
        bf16 = dp_train(torch, "bf16", sum(DP_BF16_STEPS), lanes,
                        os.path.join(out_dir, "exp_bf16"), False, device)
        print("DP_RESULT " + json.dumps({
            "rank": rank, "backend": dist.get_backend(), "device": str(device),
            "f32_loss_shares": rec["loss"],
            "f32_peak_device_memory_bytes": rec["peak_device_memory_bytes"],
            "bf16": dp_timing(bf16)}), flush=True)
    finally:
        mesh.destroy()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rel(torch, got: dict, ref: dict) -> dict:
    """Per parameter ||got - ref|| / ||ref||."""
    return {k: float(torch.linalg.vector_norm(got[k].double() - ref[k].double())
                     / torch.linalg.vector_norm(ref[k].double()).clamp(min=1e-30))
            for k in ref}


def phase_train_dp(torch, smi: str) -> dict:
    """Data-parallel training of joint_ctc_att_multihost (BASELINE config
    5) at its full width: two ranks (processes of this script, gloo over
    CUDA tensors) each train their 64 lanes of every global batch of 128,
    against one process (no group) training the 128 lanes at once. f32,
    no noise: after the first update the worst parameter's ||dp - one|| /
    ||one|| of the applied gradient and of the parameters within
    TOL["dp_step"], the naive recipe's gradient beyond it, the ranks'
    parameters bit for bit equal after DP_STEPS steps; then the bf16
    recipe's step and all-reduce times at world size 1 (one process, 64
    lanes) and 2."""
    from nabu_tpu_torch.parallel import mesh

    check(not mesh.in_group(), "train_dp: this process is in a group already")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        ref = dp_train(torch, "f32", DP_STEPS, slice(None), os.path.join(tmp, "ref_f32"), True,
                       DP_DEVICE)
        one = dp_train(torch, "bf16", sum(DP_BF16_STEPS), slice(0, DP_RANK_BATCH),
                       os.path.join(tmp, "ref_bf16"), False, DP_DEVICE)
        del ref["trainer"]
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        coordinator = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ, OMP_NUM_THREADS="4")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp_rank", str(r),
             "--dp_coordinator", coordinator, "--dp_out", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(DP_WORLD)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DP_TIMEOUT))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"train_dp rank {r} exited {p.returncode}: {err[-3000:]}")
        ranks = [json.loads(line.split(" ", 1)[1]) for out, _ in outs
                 for line in out.splitlines() if line.startswith("DP_RESULT ")]
        check(len(ranks) == DP_WORLD, f"train_dp: {len(ranks)} rank results")
        t2 = time.perf_counter()
        saved = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(DP_WORLD)]

    grads_rel = dp_rel(torch, saved[0]["grads"], ref["grads"])
    naive_rel = dp_rel(torch, saved[0]["naive"], ref["grads"])
    params_rel = dp_rel(torch, saved[0]["params_1"], ref["params_1"])
    bitwise = all(torch.equal(saved[0]["params_end"][k], saved[1]["params_end"][k])
                  for k in saved[0]["params_end"])
    tol = TOL["dp_step"]
    worst = {"grads": max(grads_rel.values()), "params": max(params_rel.values())}
    for what, value in worst.items():
        if not value <= tol:
            FAILURES.append(f"train_dp: first update's {what}, worst parameter {value} "
                            f"beyond {tol}")
    fault = max(naive_rel.values())
    if not fault > tol:
        FAILURES.append(f"train_dp: the naive mean of the ranks' means ({fault}) passes {tol}")
    if not bitwise:
        FAILURES.append(f"train_dp: the ranks' parameters differ after {DP_STEPS} steps")
    for k, g in saved[0]["grads"].items():
        check(bool(torch.isfinite(g).all()), f"train_dp gradient {k}: non-finite")
    dp_loss = [sum(r["f32_loss_shares"][i] for r in ranks) for i in range(DP_STEPS)]
    check(all(math.isfinite(v) for v in dp_loss + ref["loss"]), "train_dp: a non-finite loss")
    result = {
        "phase": "train_dp", "recipe": os.path.relpath(JOINT_RECIPE, REPO),
        "world": DP_WORLD, "backend": sorted({r["backend"] for r in ranks}),
        "rank_devices": [r["device"] for r in ranks],
        "rank_batch": DP_RANK_BATCH, "frames": DP_T, "num_params": ref["num_params"],
        "f32_steps": DP_STEPS, "tol": tol,
        "first_update_grads_max_rel_err": worst["grads"],
        "first_update_params_max_rel_err": worst["params"],
        "naive_mean_of_means_grads_max_rel_err": fault,
        "grads_rel_err_top": dict(sorted(grads_rel.items(), key=lambda kv: -kv[1])[:5]),
        "ranks_bitwise_equal_after_steps": bitwise,
        "f32_loss_dp": dp_loss, "f32_loss_one_process": ref["loss"],
        "f32_peak_device_memory_bytes": {"one_process_128": ref["peak_device_memory_bytes"],
                                         **{f"rank{r['rank']}": r["f32_peak_device_memory_bytes"]
                                            for r in ranks}},
        "bf16_world_1": dp_timing(one),
        "bf16_world_2": {f"rank{r['rank']}": r["bf16"] for r in ranks},
        "seconds": {"one_process": t1 - t0, "ranks": t2 - t1},
        "card": smi,
    }
    emit(result)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build (with the compiler's resource report) and check "
                         "each kernel once at full shape; no timing, no serve")
    ap.add_argument("--sweep", action="store_true",
                    help="build, then time the f32 GEMM's kind-2 launches of the "
                         "recipes at every K split; no checks, no result")
    # train_dp's rank processes (the script starts them itself)
    ap.add_argument("--dp_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import nabu_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.dp_coordinator, args.dp_out)
    t0 = time.perf_counter()
    phase_build(verbose=args.quick)
    smi = phase_device(torch)
    if args.sweep:
        phase_sweep(torch)
        print("chip_smoke: sweep done (no result)", file=sys.stderr)
        return 0
    t1 = time.perf_counter()
    rows = phase_kernels(torch, args.quick)
    t2 = time.perf_counter()
    if args.quick:
        raise_failures()
        print("chip_smoke: quick check done (no result)", file=sys.stderr)
        return 0
    served = phase_serve(torch, smi)
    t3 = time.perf_counter()
    served_rnnt = phase_serve_rnnt(torch, smi)
    t4 = time.perf_counter()
    served_stream = phase_serve_stream(torch, smi)
    t5 = time.perf_counter()
    served_las = phase_serve_att(torch, smi, "serve_las")
    t5a = time.perf_counter()
    served_joint = phase_serve_att(torch, smi, "serve_joint")
    t5b = time.perf_counter()
    served_aed = phase_serve_att(torch, smi, "serve_conformer_aed")
    t5c = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as corpus_dir:
        corpus = synth_training_corpus(corpus_dir)
        trained = phase_train(torch, smi, "train", corpus)
        t6 = time.perf_counter()
        trained_rnnt = phase_train(torch, smi, "train_rnnt", corpus)
        t7 = time.perf_counter()
        trained_stream = phase_train(torch, smi, "train_rnnt_stream", corpus)
        t8 = time.perf_counter()
        trained_las = phase_train(torch, smi, "train_las", corpus)
        t9 = time.perf_counter()
        trained_joint = phase_train(torch, smi, "train_joint", corpus)
        t9d = time.perf_counter()
        trained_mwer = phase_train_mwer(torch, smi, corpus)
        t9b = time.perf_counter()
        trained_crnnt = phase_train(torch, smi, "train_conformer_rnnt", corpus)
    t9a = time.perf_counter()
    phase_train_dp(torch, smi)
    t9c = time.perf_counter()
    phase_bench("dblstm", "bench_ctc", "train")
    t10 = time.perf_counter()
    phase_bench("rnnt", "bench_rnnt", "train_rnnt")
    t11 = time.perf_counter()
    bench_las = phase_bench_las()
    t12 = time.perf_counter()
    bench_crnnt = phase_bench("conformer_rnnt", "bench_conformer_rnnt", "bench_conformer_rnnt")
    t13 = time.perf_counter()
    bench_moe = phase_bench("moe_conformer", "bench_moe_conformer", "bench_moe_conformer")
    pipeline_s = sum(trained["pipeline"]["seconds"].values())
    emit({"phase": "seconds", "build_device": t1 - t0, "kernels": t2 - t1,
          "serve": t3 - t2, "serve_rnnt": t4 - t3, "serve_stream": t5 - t4,
          "serve_las": t5a - t5, "serve_joint": t5b - t5a, "serve_conformer_aed": t5c - t5b,
          # the train phase runs the pipeline phase: each is counted once
          "train": t6 - t5c - pipeline_s, "pipeline": pipeline_s,
          "train_rnnt": t7 - t6, "train_rnnt_stream": t8 - t7,
          "train_las": t9 - t8, "train_joint": t9d - t9, "train_mwer": t9b - t9d,
          "train_conformer_rnnt": t9a - t9b,
          "train_dp": t9c - t9a, "bench_ctc": t10 - t9c, "bench_rnnt": t11 - t10, "bench_las": t12 - t11,
          "bench_conformer_rnnt": t13 - t12, "bench_moe_conformer": time.perf_counter() - t13,
          "total": time.perf_counter() - t0})
    raise_failures()
    pipeline = [{"launches": v} for v in trained["pipeline"]["launches"].values()]
    # the LM-fused passes of the four beams, n-gram and neural (the RNN
    # LM's training on the card with each), and the bf16 frontend's batch
    lm_runs = tuple(run for s in (served, served_rnnt, served_las, served_joint)
                    for run in (s["lm"], s["rnn_lm"], s["rnn_lm"]["train"]))
    runs = (*lm_runs, served["bf16_frontend"], served, served_rnnt, served_stream, served_las, served_joint, served_aed,
            trained, trained_rnnt, trained_stream, trained_las, trained_las["decode"],
            trained_joint, trained_joint["test"], trained_mwer, trained_mwer["test"],
            trained_crnnt, trained_crnnt["test"],
            bench_las, bench_crnnt, bench_moe, *pipeline)

    kernels_line = []
    for name, key in (("stft_mel", "stft_mel"),
                      ("stft_mel_bf16", "stft_mel_bf16"),
                      ("blstm_proj", ("blstm_proj", "bf16", 2 * H)),
                      ("blstm_recur", ("blstm_recur", "bf16")),
                      ("blstm_recur_train", ("blstm_recur_train", "bf16")),
                      ("blstm_bwd_recur", ("blstm_bwd_recur", "bf16")),
                      ("blstm_bwd_dx", ("blstm_bwd_dx", "bf16", 2 * H)),
                      ("blstm_bwd_dwx", ("blstm_bwd_dwx", "bf16", 2 * H)),
                      ("blstm_bwd_dwh", ("blstm_bwd_dwh", "bf16")),
                      ("ctc_alpha", "ctc_alpha"),
                      ("ctc_beta", "ctc_beta"),
                      ("rnnt_joint_fwd", "rnnt_joint_fwd"),
                      ("rnnt_alpha", "rnnt_alpha"),
                      ("rnnt_beta", "rnnt_beta"),
                      ("rnnt_joint_bwd", "rnnt_joint_bwd"),
                      ("lstm_proj", ("lstm_proj", "bf16")),
                      ("lstm_fwd", ("lstm_fwd", "bf16", "encoder")),
                      ("lstm_fwd_train", ("lstm_fwd_train", "bf16", "encoder")),
                      ("lstm_bwd_recur", ("lstm_bwd_recur", "bf16", "encoder")),
                      ("lstm_bwd_dwh", ("lstm_bwd_dwh", "bf16", "encoder")),
                      ("blstm_v1_recur", ("blstm_v1_recur", "bf16", "bottom")),
                      ("blstm_v1_recur_train", ("blstm_v1_recur_train", "bf16", "bottom")),
                      ("blstm_v1_bwd_gates", ("blstm_v1_bwd_gates", "bf16", "bottom")),
                      ("blstm_v1_bwd_recur", ("blstm_v1_bwd_recur", "bf16", "bottom")),
                      ("blstm_v1_bwd_dwh", ("blstm_v1_bwd_dwh", "bf16", "bottom"))):
        r = rows[key]
        launched = sum(run["launches"].get(name, 0) for run in runs)
        check(launched > 0, f"kernel {name} never launched on a main path")
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": launched,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    emit({"kernels": kernels_line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
