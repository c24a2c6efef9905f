#!/usr/bin/env python3
"""Smoke run of ark_bulletproofs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. build: the card's name, power limit and maximum SM clock, then nvcc
     builds the kernels (csrc/*.cu, one process per source, in parallel)
     for sm_90a into ark_bulletproofs_tpu_torch/_build/ and prints
     ptxas's registers, stack frame and spills per kernel, and g++ the
     native host library (csrc/host/), which must load;
  2. kernels: each kernel against its plain PyTorch version on the card,
     bit-equal limbs: the MSM kernels on secq256k1 and zorro (RCB) and on
     curve25519 (twisted-Edwards: the TE instantiations of the three
     scans, te_double_k_add and te_double) with identity, doubling and
     P + (-P) lanes, suffix_madd_scan also at the n = 2^20 plan's shape
     (256 rows x 90,112 lanes) and at the 2048-column plan's (512 x
     45,056), timed at both and at the JAX plan's (1024 x 22,528: timed
     only; the JAX plan's 22,528 lanes are held at 64 rows); the
     Jacobian jac_double_k_add (k = 0, 1, 4) on secq256k1 and zorro with
     doubling, P + (-P), O + P and P + O lanes at every lane count the
     paths send (DKA_HELD: 1 to 2^20 lanes, and both sides of the lane
     counts from which it runs a group of 4 threads a lane instead of 8,
     and one thread a lane), each timed at k = 0 and 1 on secq256k1 (in
     microseconds, beside the bound and the critical path); jac_double's
     chain (secq256k1, zorro) at steps 1, 2 and 255 of 1, 2, 3 and 65,536
     lanes, timed at the Q table's 255 steps of one lane beside the bound
     and the critical path;
     rcb_double_k_add (secq256k1, zorro) and te_double_k_add (curve25519)
     at k = 0, 1 and 4 at every lane count the paths send (RT_LANES: 1 to
     2^24 lanes, compared by slices of 2^20) and both sides of each
     model's band edges, timed at k = 0 (TE also 1) on secq256k1 and
     curve25519 in microseconds beside the bound and the critical path;
     fs_round at P = 1, 2, 33 and 128 transcripts on the three curves,
     with L = O, R = O and both on secq256k1 and zorro; the v1
     Pippenger's row scan, jac_madd over 1 to 32 rows (secq256k1, zorro)
     and te_madd (curve25519), at every (rows, lanes) a path sends
     (SCAN_ROWS x SCAN_LANES: up to 32 x 131,072) and both sides of each
     band edge, one launch a shape, with doubling, cancelling, P = O and
     q_inf lanes (on curve25519 also (0, 1) rows), its one-row form,
     timed at 32 x 32,768 and 32 x 512 beside the bound and the critical
     path; the field kernels on the
     fr and fq of the three curves at FIELD_LANES (1 to 65,536), with 0,
     1, p - 1 and p - 2 lanes: mont_mul with a (16, 1) operand on either
     side and per row, and with a third operand added or subtracted (c
     full, (16, 1), per row), and at the prover's (6, 4, 9) x 16 x 2048
     row shapes, timed at 6 x 2048 lanes and at one; add, sub and neg
     (the add_sub kernel) with carry and borrow lanes; sum_mod (the torch
     column sum and the tail kernel) at every row count a path sends
     (SUM_ROWS: 1 to 512, over 1 to 65,536 lanes) with an all-(p - 1)
     row, its tail timed at the vector phase's 9 rows;
     mont_inv_batch on fq at INV_LANES (the table shrinks' lane counts)
     with zero lanes, alone and with two rows multiplied in, timed at
     1,024 lanes (n = 2^16's shrink); te_double's chain (curve25519) at
     steps 1, 2 and 255 of 1, 2 and 3 lanes, timed at the Q table's 255
     x 1 and the commit table's 255 x 2; the window Horner, horner_windows
     (RCB on secq256k1 and zorro, extended on curve25519) and
     jac_horner_windows (secq256k1, zorro), at v2's stage-G shape (one
     set, W = 22, c = 12) and the create_batch v1 shape (256 sets,
     W = 64, c = 4) with identity parts, from the identity and from the
     top window, also equal to the W-step double-k-add loop on the card;
     rcb_double on secq256k1 and zorro at 1, 2, 3, 65,536 and 2^20 lanes
     and its band edge and the lane on each side, with identity lanes,
     each timed beside the bound and the critical path; row_gather
     against index_select at the DMA probe's shape (2^22 rows of a
     2^20-row table) and stage B's row count (22 x 2^20 rows); the v2
     MSM's stage-B gather, stage_gather, and its table, stage_table,
     against their plain versions at every (n, B, mapped) a path sends
     (GATHER_SHAPES: n = 2^20 from a real sort, R = 1, B = 2, base maps
     over tables wider than n), timed at n = 2^20 beside the bound, the
     plain version and (the gather) index_select of the 128-byte rows;
     stages D and F's suffix_jac_scan and rowsum on the
     three curves at every (rows, lanes) the paths launch them at
     (CHAIN_SHAPES: 64 x 1,408 and 64 x 22 at n = 2^20; 16 x 1,024,
     16 x 64 and 1 x 64 at n = 256; 16 x 1,048,576, the most lanes a
     path sends), with doubling, P + (-P) and identity lanes, each timed there
     (also in microseconds a complete add, beside the bound and the
     chain's product levels; the table keeps 64 x 1,408); then each
     timed at its main-path shape (n = 2^20
     MSM on secq256k1 and on curve25519; mont_mul and add_sub at the
     k = 1024 fold's 6 x 2048 lanes; sum_mod's tail at 9 rows;
     mont_inv_batch at 1,024 lanes; te_double's chain at 255 x 1;
     jac_double_k_add at the P = 128 batch tree's first 32,768 lanes,
     jac_double's chain at 255 steps of one lane, fs_round at P = 1 and
     128, jac_madd's and te_madd's scans at create_batch's 32 rows of
     32,768 lanes, horner_windows
     at the stage-G shape and against its loop (also in microseconds a
     group operation of the chain), jac_horner_windows at the v1 shape,
     rcb_double at 65,536 lanes, row_gather at both shapes beside
     index_select, stage_table and stage_gather at n = 2^20), the kernel
     alone by replaying a CUDA graph of its launches (stage_gather with
     its table launch, by CUDA events around its calls), beside its plain
     version and its bound;
  gens: the generator farm: gen_candidates against its plain version
     (x, y, ok bit-equal) at 1 to 2^21 attempts on secq256k1 and zorro,
     timed at 2^21 beside the bound; GeneratorsChain fast_forward(4096)
     then take(4096) through the farm on secq256k1 and take(4096) on
     zorro (its first chunk holds an x >= p: replayed on the host), each
     equal to the host chain; the farm (gate lowered) against the host
     chain at 256 to 1,024 generators; take(2^20), timed with its split
     (ChaCha, framing and the >= p test, host to device, kernel, device
     to host, ints), whose points are phase 3's bases;
  3. msm: n = 2^20 secq256k1 through the port's `msm` on the farm's 2^20
     distinct points, equal to the native host Pippenger over them, then
     timed (median of 5) with its peak memory, and
     its stage split (sort, gather: one stage_gather call, its table
     included, C, D, E, F,
     G) by CUDA events, the median of 3 staged calls, whose sum equals
     the host Pippenger too;
  4. shuffle: a k = 1024 secq256k1 shuffle proved on the card through the
     device branches (tabled phase MSMs, vector phase, the IPA on the
     on-device Fiat-Shamir route), with its protocol phases on the host
     clock, proved again with the IPA on the per-round card route and on
     the port's host route, the three proofs byte-equal (the per-round
     route's last rounds run on the v1 Pippenger); the card's proof
     verified on the card with its g/h scalars made on the card, three
     times (first, then twice after a gc.collect()), with the full garbage
     collections inside each run and the device-to-host syncs of one more,
     then with the g/h scalars assembled on the host; a flipped byte and
     swapped commitments rejected;
  5. batch_verify: the 1024 cached k = 8 proofs accepted, a batch with one
     tampered proof rejected;
  6. msm curve25519: as phase 3 on 2^13 chain points tiled 128 times
     (twisted-Edwards: the farm does not sample it), the oracle the
     pure-Python host Pippenger over the 2^13 points (the native library
     has no twisted-Edwards branch);
  7. shuffle curve25519: as phase 4 (the witness commitments through the
     device Pedersen batch on the card; on the host route through the
     host's double-and-add);
  8. ipa n=2^16 secq256k1: G and H from BulletproofGens(secq256k1,
     2^16) (the farm); one IPA on the on-device Fiat-Shamir route
     and on the per-round route, byte-equal, each run twice, with the
     device-to-host syncs of one run of each; then verified with its g/h
     scalars and their MSM on the card (`ipa_gh_msm`) and with the host
     assembly, a changed proof rejected, and the host time of the
     content-keyed cache hits of one such verify;
  9. ipa zorro n=1024: the same on zorro (a != 0 in jac_double), without
     the verify; and a zorro n = 64 IPA on the per-round route, every
     round on the v1 Pippenger, byte-equal to the host route;
 10. create_batch n=64 P=128 secq256k1: the lockstep batch IPA on the FS
     route (ipa_prove_fs_batch) and on the per-round route
     (IpaBatchProver), each proof byte-equal to a serial host `create`,
     each route run twice, proofs/s;
 11. prove_batch P=128 k=32 shuffles secq256k1: byte-equal to a serial
     host-route prove on a sample of 16, all accepted by batch_verify, a
     tampered one rejected, proofs/s;
 12. v1 MSMs: n = 512 secq256k1 through `msm` (one scalar set: the v1
     Pippenger) equal to the native host Pippenger; then v1 against v2 at
     the shapes the router gives v1 (one set n = 256 and 512; base_map
     B = 2 at n = 16, 32, 64; B = 256 at n = 64), equal sums, both timed,
     with the kernel launches of one call of each (and of v1's, its
     jac_madd launches: one row scan a window pass);
 13. batch_verify 64 x k=128: 64 shuffles proved with prove_batch, the
     batch verified with the g/h scalars made and summed on the card
     (padded_n = 256) and with the host assembly, a tampered proof
     rejected;
 16. mesh (run before 14, which checks its paths): under
     engine.set_mesh(make_mesh(devices=["cuda:0"] * 4)), four shards on
     the one card, on the inputs of phases 3, 4, 5 and 8: the sharded
     n = 2^20 MSM equal to phase 3's host reference, timed by CUDA events
     beside the same MSM without the mesh, with the device-to-host syncs
     of one call of each (the sharded one may not sync more); the k = 1024
     prove byte-equal to phase 4's proof, verify accepting it and
     rejecting a flipped t_x and swapped commitments, batch_verify of
     phase 5's 1024 proofs accepting them and rejecting one tampered; the
     n = 2^16 IPA byte-equal to phase 8's (the same transcript end) and
     verified; the sharded g/h scalars at padded_n = 4096 equal to the
     unsharded ones; then two gloo ranks (python -m
     ark_bulletproofs_tpu_torch.parallel.dryrun) on cuda:0 summing 2^16
     generators, each drawing its own half, each equal to the host
     Pippenger and to each other. No figure of it is a multi-card one;
 14. launches: each path of the gens phase and phases 3-13 and 16 runs with
     every launch count set to 0 just before it and read just after
     (gen_candidates on the farm's paths); each of its kernels
     launched (the window Horner, stage_table and stage_gather on every
     v2 MSM path),
     and the v1 paths' double-k-add kernel at k > 0; and the most lanes
     suffix_jac_scan, rowsum and the three double-k-add kernels were
     launched at over
     those paths, no more than phase 2 held them at, with every lane
     count sent; and every (rows, lanes) of jac_madd, te_madd and
     mont_inv_batch, (steps, lanes) of jac_double and te_double, rows
     of sum_mod and (n, B, mapped) of stage_gather a path sent, each
     among the shapes phase 2 held; then
     te_madd's scan timed at the largest (rows, lanes) a path sent it,
     beside the bound and the critical path;
 15. traces: the card prove (secq256k1 and curve25519) and the verify
     once more each under torch.profiler, which splits card time from
     host time and names the largest kernels (last, so that no timing
     above runs after a profiler session).

It imports only the port, never jax or the JAX package. Any failure exits
nonzero. The last three lines are the kernels JSON, the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": ...}. Needs
one card; exits 1 at once without one or without the port beside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import pickle
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MSM = 1 << 20
N_DISTINCT = 1 << 13
SHUFFLE_K = 1024
BATCH_CACHE = os.path.join(ROOT, "benches",
                           ".cache_batch_secq256k1_k8_n1024.pkl")
L_MAIN = 22 * 1024  # scan lanes at n = 2^20 under the JAX plan (C = 1024)
# The JAX plan's scan rows at n = 2^20: no path sends 1024 x L_MAIN, so
# the scan is only timed there (holding it and the kernels after it took
# about 140 s of the smoke's time limit); L_MAIN is held at R_HELD rows.
R_JAX, R_HELD = 1024, 64
# The n = 2^20 MSM's scan under the port's plan (ops/msm2.py::plan_columns:
# C = 4096): 256 rows of W * C = 22 * 4096 lanes; and under the 2048-column
# plan it was measured against (512 x 22 * 2048).
R_PLAN, L_PLAN = 256, 22 * 4096
R_MID, L_MID = 512, 22 * 2048
MM_LANES = 6 * 2048  # the k = 1024 IPA fold's product launch
# Stages D and F's (rows, lanes) on the paths: the n = 2^20 MSM's (c2 = 64
# rows of 22 c1 lanes, then c1 = 64 rows of 22; K1 = 64 rows of 22 M1,
# then M1 = 64 rows of 22), the n = 256 MSM's (16 x 1,024, 16 x 64;
# 16 x 64, 1 x 64), and the most lanes a path sends: the on-device
# Fiat-Shamir IPA's table shrink at n = 2^16 is an MSM of 1024 sets of 128
# terms padded to 256, whose stage D level A is 16 rows of 1024 x 64 x 16
# lanes (phase 14 checks that no path sends more).
CHAIN_SHAPES = [(64, 22 * 64, "n = 2^20: stage D level A, stage F pass 1"),
                (64, 22, "n = 2^20: level B, pass 2"),
                (16, 1024, "n = 256: level A"),
                (16, 64, "n = 256: level B, pass 1"),
                (1, 64, "n = 256: pass 2"),
                (16, 1024 * 64 * 16, "the most lanes a path sends")]
MSM_CU = "ark_bulletproofs_tpu_torch/csrc/msm_kernels.cu"
FIELD_CU = "ark_bulletproofs_tpu_torch/csrc/field_kernels.cu"
JAC_CU = "ark_bulletproofs_tpu_torch/csrc/jac_kernels.cu"
FS_CU = "ark_bulletproofs_tpu_torch/csrc/fs_kernels.cu"
GATHER_CU = "ark_bulletproofs_tpu_torch/csrc/gather_kernels.cu"
GENS_CU = "ark_bulletproofs_tpu_torch/csrc/gens_kernels.cu"
# gen_candidates's attempt counts held against its plain version: 1 to a
# 256-attempt chunk, 65,536 (about a 2^15 request) and 2^21 (a 2^20
# request's chunk is 2,108,992 attempts: timed there at 2^21). The farm's
# requests of 256 to 4,096 generators are timed against the host chain.
GEN_ATTEMPTS = (1, 33, 256, 1 << 16, 1 << 21)
GEN_RATE_SIZES = (256, 512, 1024)
TREE_LANES = 128 * 256  # the first step of the P = 128 batch's c * Q tree
# jac_double_k_add's lane counts on the paths: the on-device Fiat-Shamir
# IPA's c * Q tree (2 P h lanes, h = n / 2 ... 1: 256 ... 2 for one proof
# at n = 256, 32,768 ... 256 for P = 128) and its S = MSM + c * Q (2 P),
# and the v1 Pippenger's adds and bit-Horner steps (k = 1) on G windows
# of its sets: G C, G S and G c S / 2^j lanes, powers of two, and 3 x
# 2^13 to 3 x 2^18 for prove_batch's 384 sets (3 phase MSMs of 128
# proofs; 786,432 lanes at its bit tree's first level). Each held and
# timed at k = 0 and 1; 1 and 2^20 lanes are held too. Phase 14 checks
# that no path sends more, and names any lane count a path sent that
# phase 2 did not time.
DKA_LANES = sorted([1 << i for i in range(1, 20)]
                   + [3 << i for i in range(13, 19)])
DKA_HELD = [1, *DKA_LANES, 1 << 20]
# rcb_double_k_add's and te_double_k_add's lane counts (k = 0 on every
# path but the TE v1 Pippenger's bit Horner, k = 1 at 128 lanes): the
# ragged MSM's chunk sum (B lanes, 1 for one set), the TE commit and
# c * Q trees (2 to 256 lanes a proof, up to 524,288 for a k = 1024
# shuffle's commitments), the v2 MSM's stage D and E adds (BW C and BW S
# lanes: 90,112 at n = 2^20, 26,624 at n = 2^16, 1,024 to 32,768 at
# n = 256 to 4096 for one set, 131,072 and 2,097,152 at n = 256 for 128
# sets, 4,194,304 in prove_batch, 16,777,216 for the on-device
# Fiat-Shamir IPA's 1024-set table shrink; 1,664, 3,328, 24,576, 53,248
# and 98,304 for other plans), and powers of two up to 2^22. Each held at
# k = 0, 1 and 4 and timed at k = 0 (TE also at k = 1); the models' band
# edges and their neighbours are held too. Phase 14 checks that no path
# sends more, and names any lane count a path sent that phase 2 did not
# time.
RT_LANES = sorted({1 << i for i in range(23)} | {1 << 24}
                  | {1664, 3328, 24_576, 26_624, 53_248, 90_112, 98_304})
# Lanes a comparison with the plain version takes at once (its int64
# temporaries at 16,777,216 lanes would not fit on the card).
HOLD_SLICE = 1 << 20
# jac_madd's (rows, lanes) on the paths: the v1 Pippenger's row scan is R
# = min(n, 32) rows of G C lanes (G windows of a pass, C = n / R columns):
# 32 x 512 and 32 x 1,024 for one set at n = 256 and 512, n rows of 128
# for base_map B = 2 at n = 16 and 32 (32 x 256 at 64), 32 x 32,768 for
# create_batch P = 128 and base_map B = 256, R rows of 8,192 for its
# per-round route's small rounds, 24,576 (n = 1) to 98,304 (n = 128) for
# prove_batch's 384 sets, and up to 131,072 at V1_MAX_WINDOW_TERMS
# (2^22 / 32). Held on every row count a power of two up to 32 at these
# lane counts (rows below 32 up to 32,768 lanes) and at the band edges
# (kk.MADD_BANDS) and the lanes below them, in one launch a shape against
# one plain scan a row count over the widest lanes (lanes are
# independent); phase 14 checks that every (rows, lanes) a path sent was
# held here.
SCAN_LANES = sorted({1 << i for i in range(18)} | {3 << i for i in
                                                   range(13, 16)})
SCAN_ROWS = (1, 2, 4, 8, 16, 32)
# jac_double's chain: 255 steps of one lane (the on-device Fiat-Shamir
# IPA's Q table), held at steps 1, 2 and 255 of these lane counts.
CHAIN_STEPS = (1, 2, 255)
CHAIN_LANES = (1, 2, 3, 1 << 16)
# te_double's chain: 255 steps of one lane (the TE Q table) and of two
# (the commit table's 2^i B and 2^i B_blinding), held at steps 1, 2 and
# 255 of these lane counts.
TE_CHAIN_LANES = (1, 2, 3)
# The field kernels' lane counts: one lane (the challenges' products),
# the k = 1024 prover's 2,048-lane vectors and their (6, 9) x 2,048 row
# stacks, 18,432 (9 x 2,048) and the n = 2^16 IPA's 65,536.
FIELD_LANES = (1, 2, 33, 2048, MM_LANES, 9 * 2048, 1 << 16)
# mont_inv_batch's lanes: the table shrink inverts 2 cur lanes (cur the
# width it shrinks to: 512 at n = 2^16, so 1,024; the JAX package's plan
# of 2^4, which phase 8 runs too, 4,096 and then 256: 8,192 and 512),
# with its two rows (X, Y) multiplied in; held with and without rows.
INV_LANES = (1, 2, 33, 512, 1024, 8192)
INV_TIMED = 1024
# rcb_double's lane counts (no path sends it): 1 to 3, 65,536 (the
# table's) and 2^20, and its band edge (kk.DBL_BANDS) with the lane on
# each side.
RCB_DBL_LANES = (1, 2, 3, 1 << 16, 1 << 20)
# sum_mod's rows (one thread a row, 128 a block): a single proof's dot
# (1), an IPA round's c_L, c_R (2), the vector phase's nine dots (9), a
# batch IPA's 2P at P = 128 (create_batch, prove_batch: 256) and the
# batch verify's 2n g/h sums at k = 128 (n = 256: 512), with the block
# edges 128 and 129; each held over SUM_LANES (to 65,536 up to 9 rows).
SUM_ROWS = (1, 2, 9, 128, 129, 256, 512)
SUM_LANES = (1, 2, 64, 2048, 1 << 16)
# stage_gather's (n, B, mapped) on the paths (as phase 14 records them):
# the v2 MSM's scalar count n, its sets B and whether a base map selects
# the bases, each under msm2's plan (one (R, C, W) each). One
# set: the n = 2^20 MSM of phases 3 and 6 (held with the order of a real
# _stage_sort, and timed), the ragged chunks and padded remainders of the
# verifiers' mega-MSMs (256 to 131,072), the IPA's and the prover's phase
# MSMs; base maps: the provers' and the IPA rounds' (B = 2 to 4 at n = 256
# to 65,536), the per-round batch IPA's (32, 128 and 256 sets of 256) and
# the on-device Fiat-Shamir IPA's table shrink (1,024 sets of 256); and
# B = 2 without one; the mesh's shards (phase 16: the MSM's 2^18, the
# prover's 3-set phase MSMs and the IPA rounds' 2-set 2^15). Phase 14
# checks that every (n, B, mapped) a path sent was held here.
GATHER_SHAPES = [(1 << 20, 1, False), (1024, 2, False), (1 << 18, 1, False),
                 (512, 3, False), (256, 3, False), (32768, 2, False)] + [
    (n, 1, False) for n in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                            131072)] + [
    (256, B, True) for B in (2, 32, 128, 256, 1024)] + [
    (512, 2, True), (1024, 2, True), (2048, 2, True), (4096, 2, True),
    (4096, 3, True), (65536, 2, True)]
# Product latencies on a double-k-add lane's critical path, per model:
# one thread runs every product of the add and of a doubling; a group of G
# threads waits on their levels (csrc/rcb.cuh, te.cuh: ceil(N / G) a level
# of N products; a and 3b by double-and-add where small cost no round).
DKA_PATH = {  # model: {"one": (add, double), G: (add, double)}
    "rcb a=0": {"one": (12, 8), 8: (2, 2), 4: (4, 2)},
    "rcb a": {"one": (14, 13), 8: (3, 3), 4: (5, 5)},
    "te": {"one": (11, 11), 8: (3, 3), 4: (4, 4)},
}
# The kernels JSON line, one entry per kernel and point model: (entry
# name, wrapper, model of the paths it counts, source, TPU kernels it
# replaces). "[te]" entries are the twisted-Edwards instantiations of the
# scan and Horner launchers; mont_mul and row_gather count on every path.
ENTRIES = [
    ("suffix_madd_scan", "suffix_madd_scan", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:133"),
    ("suffix_jac_scan", "suffix_jac_scan", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:223"),
    ("rowsum", "rowsum", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:292"),
    ("rcb_double_k_add", "rcb_double_k_add", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:853, "
     "ark_bulletproofs_tpu/ops/kernels.py:704"),
    ("mont_mul", "mont_mul", None, FIELD_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:303"),
    ("suffix_madd_scan[te]", "suffix_madd_scan", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:133, "
     "ark_bulletproofs_tpu/ops/kernels.py:822"),
    ("suffix_jac_scan[te]", "suffix_jac_scan", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:223"),
    ("rowsum[te]", "rowsum", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:292"),
    ("te_double_k_add", "te_double_k_add", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:806, "
     "ark_bulletproofs_tpu/ops/kernels.py:780"),
    ("te_double", "te_double", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:794"),
    ("jac_double_k_add", "jac_double_k_add", "sw", JAC_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:359, "
     "ark_bulletproofs_tpu/ops/kernels.py:385"),
    ("jac_double", "jac_double", "sw", JAC_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:413"),
    ("jac_madd", "jac_madd", "sw", JAC_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:327"),
    ("te_madd", "te_madd", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:822"),
    ("horner_windows", "horner_windows", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:347"),
    ("horner_windows[te]", "horner_windows", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:347"),
    ("jac_horner_windows", "jac_horner_windows", "sw", JAC_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:347"),
    # no path, as in the JAX package (only its proj.double reaches it)
    ("rcb_double", "rcb_double", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:730"),
    # the v2 MSM's stage B, the probe's redesign: its table, then its
    # gather (the gather's times include its table launch)
    ("stage_table", "stage_table", None, GATHER_CU,
     "tools/probe_dma_gather.py:67"),
    ("stage_gather", "stage_gather", None, GATHER_CU,
     "tools/probe_dma_gather.py:67"),
    # the probe's flat form, on no path
    ("row_gather", "row_gather", None, GATHER_CU,
     "tools/probe_dma_gather.py:67"),
    # port-only: the JAX package runs this round body as XLA ops
    ("fs_round", "fs_round", None, FS_CU,
     "ark_bulletproofs_tpu/ops/ipa.py:550"),
    # port-only: the JAX package's field add / sub, sum_mod's tail and
    # batch inverse, XLA ops (and chains of mont_mul_fast) there
    ("add_sub", "add_sub", None, FIELD_CU,
     "ark_bulletproofs_tpu/ops/field.py:196"),
    ("sum_mod", "sum_mod", None, FIELD_CU,
     "ark_bulletproofs_tpu/ops/field.py:319"),
    ("mont_inv_batch", "mont_inv_batch", None, FIELD_CU,
     "ark_bulletproofs_tpu/ops/fs.py:467"),
    # the generator farm: the JAX farm's chain of mont_mul_tiled launches
    # (pow_bits) and the XLA tail around it, one launch a chunk here
    ("gen_candidates", "gen_candidates", None, GENS_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:303 mont_mul_tiled via "
     "ark_bulletproofs_tpu/ops/gens.py:99 pow_bits"),
]
SCANS = ("suffix_madd_scan", "suffix_jac_scan", "rowsum")
PER_MODEL = SCANS + ("horner_windows",)  # entries split by point model
# The bound: the larger of bytes over the card's memory rate and 32-bit
# multiply instructions over 132 SMs x 64 per clock at the maximum SM
# clock. A field product (csrc/field.cuh::fe_mul) is 8 CIOS steps of
# 8 wide products (16 mul.lo/mul.hi), one mul.lo for m and 8 wide
# products for m * p: 264 instructions. On secq256k1 (a = 0, 3b = 21 by
# double-and-add) csrc/rcb.cuh spends 12 products on an add, 11 on a
# mixed add and 8 on a doubling; on curve25519 csrc/te.cuh spends 11 on
# each (a and d as full products). csrc/jac.cuh spends 16 on a Jacobian
# add and 12 on a mixed add, and 8 more (10 for a != 0) on each lane that
# doubles.
HBM_BYTES_PER_S = 3.35e12
MULS_PER_FE_MUL = 264
FE_MULS = {"sw": {"add": 12, "madd": 11, "double": 8},
           "te": {"add": 11, "madd": 11, "double": 11},
           "jac": {"add": 16, "madd": 12, "double": 8, "double_a": 10}}
# v2's kernels; its double-k-add kernel launches at k = 0 only (stages
# D and E), its window Horner is one horner_windows launch, its stage B
# one stage_table and one stage_gather launch
MSM_KERNELS = {"sw": SCANS + ("rcb_double_k_add", "horner_windows",
                              "stage_table", "stage_gather"),
               "te": SCANS + ("te_double_k_add", "horner_windows",
                              "stage_table", "stage_gather")}
# The on-device Fiat-Shamir IPA's kernels beyond the MSM's: the c * Q
# tree and the 2^i Q table, and the round's transcript step.
FS_KERNELS = {"sw": ("mont_mul", "sum_mod", "jac_double_k_add",
                     "jac_double", "fs_round"),
              "te": ("mont_mul", "sum_mod", "te_double", "fs_round")}
# The prover's vector phase beyond its products: the field adds and the
# nine dot products' sums.
VECTOR_KERNELS = ("mont_mul", "add_sub", "sum_mod")
# The v1 Pippenger's kernels: its row scan's mixed add, its adds and bit
# Horner steps (k = 1) on the double-k-add kernel of the model, and its
# window Horner.
V1_KERNELS = {"sw": ("jac_madd", "jac_double_k_add", "jac_horner_windows"),
              "te": ("te_madd", "te_double_k_add", "horner_windows")}
V1_DOUBLING = {"sw": ("jac_double_k_add",), "te": ("te_double_k_add",)}


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def smi_query(fields: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def smi_line() -> str:
    return smi_query("name,power.limit")


class Bound:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the multiply instructions over the multiply rate."""

    def __init__(self, sm_clock_mhz: float):
        self.muls_per_s = 132 * 64 * sm_clock_mhz * 1e6

    def __call__(self, nbytes: int, muls: int) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = muls / self.muls_per_s
        if t_bytes >= t_ops:
            return t_bytes * 1e3, "bytes"
        return t_ops * 1e3, "operations"


class Launches:
    """Launch counts per path: every wrapper's count is set to 0 just
    before the path runs and read just after it."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers
        self.paths = {}
        self.current = None  # the path running now

    def run(self, path: str, fn, kernels, spec, doubling=()):
        """Run path `path` on `spec`'s curve; `kernels` must launch, and
        the double-k-add wrappers in `doubling` must launch with k > 0."""
        for w in self.wrappers.values():
            w.launches = 0
            if hasattr(w, "doubling_launches"):
                w.doubling_launches = 0
        self.current = path
        try:
            out = fn()
        finally:
            self.current = None
        self.paths[path] = (
            {n: w.launches for n, w in self.wrappers.items()}, kernels,
            model(spec),
            {n: self.wrappers[n].doubling_launches for n in doubling})
        return out

    def check(self) -> None:
        for path, (counts, _, _, dbl) in self.paths.items():
            at_k = f"; at k > 0: {dbl}" if dbl else ""
            print(f"   {path}: {counts}{at_k}", flush=True)
        idle = [(path, n) for path, (counts, kernels, _, _) in
                self.paths.items() for n in kernels if counts[n] == 0]
        idle += [(path, f"{n} at k > 0") for path, (_, _, _, dbl) in
                 self.paths.items() for n, c in dbl.items() if c == 0]
        if idle:
            raise AssertionError(f"kernels never launched on their path: "
                                 f"{idle}")

    def total(self, wrapper: str, on_model) -> int:
        """Launches of `wrapper` over the paths of model `on_model` (all
        paths for None)."""
        return sum(counts[wrapper] for counts, _, m, _ in self.paths.values()
                   if on_model in (None, m))


class PathLanes:
    """The most lanes (with the rows or k, and the counted path then, None
    between paths) that stages D and F's kernels and the three
    double-k-add kernels are launched at in the gens phase and phases
    3-13, and every lane count sent (at k > 0 apart); and every (rows,
    lanes) of jac_madd,
    te_madd and mont_inv_batch (rows 0: the inverses alone), (steps,
    lanes) of jac_double and te_double, rows of sum_mod and (n, B,
    mapped) of stage_gather, each with the first path that sent it,
    which must be among the shapes phase 2 held (`held`, KernelCheck's).
    The launch helpers of kernels2, kernels, fs and gather are replaced by
    recorders that read those launchers' arguments and launch as before
    (the wrappers and their counts stay as they are; ops/field.py looks up
    kernels' helper at each call)."""

    # name: (what the shape is, the shape from the arguments)
    SHAPES = {"jac_madd": ("(rows, lanes)", lambda a: (a[5], a[6])),
              "te_madd": ("(rows, lanes)", lambda a: (a[5], a[6])),
              "jac_double": ("(steps, lanes)", lambda a: (a[3], a[2])),
              "te_double": ("(steps, lanes)", lambda a: (a[3], a[2])),
              "mont_inv_batch": ("(rows, lanes)", lambda a: (a[4], a[3])),
              "sum_mod": ("(rows,)", lambda a: (a[2],)),
              "stage_gather": ("(n, B, mapped)",
                               lambda a: (a[5], a[9] // a[8], a[2] != 0))}

    def __init__(self, kk, k2, fsm, gm, launches: Launches, held: dict):
        chain = {L for _, L, _ in CHAIN_SHAPES}
        # name: (module, (lanes, rows or k) from the launch's arguments,
        # what the second number is, the lane counts phase 2 times)
        self.kinds = {
            "suffix_jac_scan": (k2, lambda a: (a[-1], a[-2]), "rows", chain),
            "rowsum": (k2, lambda a: (a[-1], a[-2]), "rows", chain),
            "jac_double_k_add": (kk, lambda a: (a[3], a[4]), "k",
                                 set(DKA_LANES)),
            "rcb_double_k_add": (kk, lambda a: (a[3], a[4]), "k",
                                 set(RT_LANES)),
            "te_double_k_add": (kk, lambda a: (a[3], a[4]), "k",
                                set(RT_LANES)),
        }
        self.held = {"suffix_jac_scan": max(chain), "rowsum": max(chain),
                     "jac_double_k_add": max(DKA_HELD),
                     "rcb_double_k_add": max(RT_LANES),
                     "te_double_k_add": max(RT_LANES)}
        self.shapes_held = held
        self.sent = {name: {} for name in self.SHAPES}  # shape: path
        self.most = {name: (0, 0, None) for name in self.kinds}
        self.seen = {name: set() for name in self.kinds}
        self.seen_k = {name: set() for name in self.kinds}  # at k > 0
        for mod in (k2, kk, fsm, gm):
            self._record(mod, launches, shapes=mod is not k2)

    def _record(self, mod, launches: Launches, shapes: bool) -> None:
        launch = mod.launch
        mine = {n: kind for n, kind in self.kinds.items() if kind[0] is mod}

        def record(name, spec, dev, *args):
            if shapes and name in self.SHAPES:
                shape = self.SHAPES[name][1](args)
                self.sent[name].setdefault(shape, launches.current)
            if name in mine:
                lanes, other = mine[name][1](args)
                self.seen[name].add(lanes)
                if mine[name][2] == "k" and other > 0:
                    self.seen_k[name].add(lanes)
                if (lanes, other) > self.most[name][:2]:
                    self.most[name] = (lanes, other, launches.current)
            return launch(name, spec, dev, *args)

        mod.launch = record

    def check(self) -> None:
        """Print each kernel's most lanes and the lane counts sent that
        phase 2 did not time; raise if phase 2 held it at fewer."""
        over = []
        for name, (L, other, path) in self.most.items():
            _, _, what, timed = self.kinds[name]
            held = self.held[name]
            at_k = (f"; at k > 0: {sorted(self.seen_k[name])}"
                    if what == "k" else "")
            print(f"   {name}: at most {L} lanes ({what} {other}, path "
                  f"{path}); phase 2 holds it at up to {held}; lane counts "
                  f"sent and not timed there: "
                  f"{sorted(self.seen[name] - timed)}; all sent: "
                  f"{sorted(self.seen[name])}{at_k}", flush=True)
            if L > held:
                over.append(name)
        for name, (what, _) in self.SHAPES.items():
            sent = self.sent[name]
            missed = sorted(set(sent) - self.shapes_held[name])
            print(f"   {name}: {what} sent: "
                  f"{ {k: sent[k] for k in sorted(sent)} }; not held in "
                  f"phase 2: {missed}", flush=True)
            if missed:
                over.append(f"{name} at {missed}")
        if over:
            raise AssertionError(f"{over}: a path sent more lanes, or other "
                                 f"shapes, than phase 2 holds them at")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events around `reps` calls,
    after one warm-up: the wrapper's host work included."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per launch of the kernel alone: `reps` calls
    captured in one CUDA graph, replayed once to warm up and once more
    between CUDA events, so no host work lies between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def neg(spec, P):
    """-P for an (NC, ..., 16, L) point or (2, ...) affine tensor: y
    negated on a short-Weierstrass curve, x (and T) on a twisted-Edwards
    one."""
    import torch

    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops.curve import is_te

    out = P.clone()
    for c in ((0, 2) if is_te(spec) else (1,)):
        if c < P.shape[0]:
            out[c] = df.neg(spec.fq, P[c]).to(torch.int32)
    return out


def model(spec) -> str:
    from ark_bulletproofs_tpu_torch.ops.curve import is_te

    return "te" if is_te(spec) else "sw"


def entry(name: str, spec) -> str:
    """The kernels JSON entry of wrapper `name` on `spec`'s model."""
    return f"{name}[te]" if name in PER_MODEL and model(spec) == "te" else name


class KernelCheck:
    """Phase 2: kernels against their plain versions on the card. `times`
    holds (kernel ms, plain ms, bound ms, bound_by) per kernel."""

    def __init__(self, dev, bound: Bound):
        self.dev = dev
        self.bound = bound
        self.err = {e[0]: 0 for e in ENTRIES}
        self.held = {}  # kernel: the shapes held, where a path's must be
        self.times = {}
        self.library_ms = {}
        self.wrapper_ms = None

    def compare(self, name: str, got, want) -> None:
        import torch

        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, want))
        self.err[name] = max(self.err[name], err)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")

    def affine_rows(self, curve, spec, R: int, L: int, seed: int):
        """(2, R, 16, L) affine rows with doubling, P + (-P) and identity
        (y = 0) lanes, and on a twisted-Edwards curve (0, 1) lanes, from a
        pool of 256 chain points and their negatives."""
        import torch

        from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
        from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device

        pts = GeneratorsChain(curve, b"chip_smoke pool").take(256)
        X, Y, _ = affine_to_device(curve, pts, self.dev)
        pool = torch.stack([X, Y])  # (2, 16, 256)
        pool = torch.cat([pool, neg(spec, pool)], dim=2)  # 512 points
        g = torch.Generator(device=self.dev).manual_seed(seed)
        idx = torch.randint(0, 512, (R, L), generator=g, device=self.dev)
        A, B, C = slice(0, L // 8), slice(L // 8, L // 4), slice(L // 4,
                                                                3 * L // 8)
        if R > 1:
            idx[0::2, A] = idx[1::2, A]  # row r = row r + 1: doublings
            idx[0::2, B] = (idx[1::2, B] + 256) % 512  # row r = -(row r+1)
        xy = pool[:, :, idx].permute(0, 2, 1, 3).contiguous()
        ident = torch.rand((R, L), generator=g, device=self.dev) < 0.3
        ident[:, :C.start] = False
        ident[:, C.stop:] = False
        xy[1].masked_fill_(ident.unsqueeze(1), 0)  # y = 0: identity rows
        if model(spec) == "te":  # (0, 1) as an ordinary affine point
            from ark_bulletproofs_tpu_torch.ops import field as df

            D = slice(3 * L // 8, L // 2)
            zy = torch.rand((R, L), generator=g, device=self.dev) < 0.3
            zy[:, :D.start] = False
            zy[:, D.stop:] = False
            zy = zy.unsqueeze(1)
            xy[0].masked_fill_(zy, 0)
            xy[1] = torch.where(zy, df.const(spec.fq.r_limbs, self.dev)
                                .to(torch.int32), xy[1])
        return xy

    @staticmethod
    def special_rows(spec, T):
        """Doubling and P + (-P) lanes in projective rows."""
        L = T.shape[-1]
        if T.shape[1] > 1:
            T[:, 0::2, :, :L // 8] = T[:, 1::2, :, :L // 8]
            T[:, 0::2, :, L // 8:L // 4] = neg(spec, T[:, 1::2, :,
                                                       L // 8:L // 4])
        return T

    def run_curve(self, curve, seed: int, timed: bool) -> None:
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        te = model(spec) == "te"
        nc = 4 if te else 3
        dka = kk.te_double_k_add if te else kk.rcb_double_k_add
        for R, L in ((R_PLAN, L_PLAN), (R_MID, L_MID), (R_HELD, L_MAIN),
                     (R_JAX, L_MAIN)):
            if R == R_JAX and not timed:
                continue
            t0 = time.perf_counter()
            xy = self.affine_rows(curve, spec, R, L, seed + R)
            locs = k2.suffix_madd_scan(spec, xy)
            plain_ms = None
            if R != R_JAX:
                plain_ms = host_ms(lambda: self.compare(
                    entry("suffix_madd_scan", spec), locs,
                    k2.suffix_madd_scan_plain(spec, xy)))
            if timed and R != R_HELD:
                ms = graph_ms(lambda: k2.suffix_madd_scan(spec, xy), 3)
                bound = self.bound((2 + nc) * R * 16 * L * 4,
                                   R * L * FE_MULS[model(spec)]["madd"]
                                   * MULS_PER_FE_MUL)
                plan = {R_PLAN: "the port's", R_MID: "the 2048-column",
                        R_JAX: "the JAX"}[R]
                plain = ("not held" if plain_ms is None
                         else f"plain {plain_ms:.1f} ms")
                print(f"   {curve.name} suffix_madd_scan at {plan} plan "
                      f"({R} rows x {L} lanes): kernel {ms:.4f} ms, {plain}, "
                      f"bound {bound[0]:.5g} ms ({bound[1]})", flush=True)
                if R == R_PLAN:  # the main path's shape
                    self.times[entry("suffix_madd_scan", spec)] = (
                        ms, plain_ms, *bound)
            del xy
            if R != R_HELD:  # the kernels after the scan: at R_HELD rows
                del locs
                torch.cuda.empty_cache()
                print(f"   {curve.name} suffix_madd_scan R={R} L={L}: "
                      f"{'timed' if R == R_JAX else 'bit-equal'} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                continue
            T = self.special_rows(spec, locs)
            self.compare(entry("suffix_jac_scan", spec),
                         k2.suffix_jac_scan(spec, T),
                         k2.suffix_jac_scan_plain(spec, T))
            for K in (16, 64):
                if K <= R:
                    Tk = T[:, :K].contiguous()
                    self.compare(entry("rowsum", spec), k2.rowsum(spec, Tk),
                                 k2.rowsum_plain(spec, Tk))
            P = T[:, 0].contiguous()
            Q = T[:, min(1, R - 1)].contiguous()
            Q[..., :L_MAIN // 8] = P[..., :L_MAIN // 8]  # P + P
            Q[..., L_MAIN // 8:L_MAIN // 4] = neg(
                spec, P[..., L_MAIN // 8:L_MAIN // 4])  # P + (-P)
            for k in (0, 1, 4, 12):
                self.compare(dka.__name__, dka(spec, P, Q, k),
                             kk.double_k_add_plain(spec, P, Q, k))
            if te:
                self.compare("te_double", kk.te_double(spec, Q),
                             kk.te_double_plain(spec, Q))
                self.held.setdefault("te_double", set()).add((1, L_MAIN))
            del T, locs, P, Q
            torch.cuda.empty_cache()
            print(f"   {curve.name} R={R} L={L_MAIN}: all "
                  f"{5 if te else 4} bit-equal "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def run_chains(self, curve, seed: int, timed: bool) -> None:
        """Stages D and F's kernels (suffix_jac_scan, rowsum: a thread
        group a lane's chain of complete adds) bit-equal to their plain
        versions at every (rows, lanes) the paths launch them at
        (CHAIN_SHAPES), on projective rows with doubling, P + (-P) and
        identity lanes; timed there, in ms and in microseconds a complete
        add of the chain, beside the bound and the chain's critical path
        (its adds x product levels an add). The table keeps the n = 2^20
        stage-D shape, 64 x 1,408, as PR 7 measured it."""
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        te = model(spec) == "te"
        nc = 4 if te else 3
        add = FE_MULS[model(spec)]["add"] * MULS_PER_FE_MUL
        levels = 3 if te or not spec.is_a_zero else 2  # at G = 8
        t0 = time.perf_counter()
        for R, L, where in CHAIN_SHAPES:
            T = k2.suffix_madd_scan(spec, self.affine_rows(curve, spec, R, L,
                                                           seed + R + L))
            T = self.special_rows(spec, T).contiguous()
            self.compare(entry("suffix_jac_scan", spec),
                         k2.suffix_jac_scan(spec, T),
                         k2.suffix_jac_scan_plain(spec, T))
            self.compare(entry("rowsum", spec), k2.rowsum(spec, T),
                         k2.rowsum_plain(spec, T))
            if not timed:
                continue
            reps = 20 if L <= 16384 else 5
            runs = {
                "suffix_jac_scan": (
                    lambda: k2.suffix_jac_scan(spec, T),
                    lambda: k2.suffix_jac_scan_plain(spec, T),
                    self.bound((2 * R + 1) * nc * 16 * L * 4, R * L * add)),
                "rowsum": (
                    lambda: k2.rowsum(spec, T),
                    lambda: k2.rowsum_plain(spec, T),
                    self.bound((R + 1) * nc * 16 * L * 4, R * L * add)),
            }
            if L < k2.CHAIN_ONE_THREAD_MIN_LANES:
                path = f"a group of 8 threads a lane: {R} x {levels}"
            else:
                path = (f"one thread a lane: {R} x "
                        f"{FE_MULS[model(spec)]['add']}")
            for name, (kernel, plain, bound) in runs.items():
                ms = graph_ms(kernel, reps)
                print(f"   {curve.name} {name} {R} x {L} ({where}): kernel "
                      f"{ms:.4f} ms, {ms * 1e3 / R:.3f} us a complete add; "
                      f"bound {bound[0]:.5g} ms ({bound[1]}); critical path "
                      f"({path}) product latencies", flush=True)
                if (R, L) == (64, 22 * 64) and curve.name != "zorro":
                    self.times[entry(name, spec)] = (ms, host_ms(plain),
                                                     *bound)
            del T
        print(f"   {curve.name} suffix_jac_scan and rowsum at "
              f"{[(R, L) for R, L, _ in CHAIN_SHAPES]}: bit-equal "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def model_points(self, curve, spec, R: int, L: int, seed: int,
                     rcb: bool = False):
        """(NC, R, 16, L) points in the on-device Fiat-Shamir IPA's model
        coordinates from affine_rows, each with a random Z: Jacobian (x
        Z^2, y Z^3, Z), its identity lanes (y = 0 there) as (0, 0, 0); or
        TE extended (x Z, y Z, x y Z, Z), the y = 0 lanes made (0, 1); or
        with `rcb` on a short-Weierstrass curve RCB projective (x Z, y Z,
        Z), the identity (0, R, 0). Also returns the (R, L) identity
        mask."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops import proj

        fq = spec.fq
        xy = self.affine_rows(curve, spec, R, L, seed)
        ident = df.is_zero(xy[1])  # (R, L)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        z = torch.randint(0, 1 << 16, (R, 16, L), generator=g,
                          device=self.dev, dtype=torch.int32)
        z[:, 15] = 0  # below p
        z[:, 0] |= 1  # not zero
        mm = lambda a, b: df.mont_mul(fq, a, b).to(torch.int32)  # noqa
        if model(spec) == "te":
            one = df.const(fq.r_limbs, self.dev).to(torch.int32)
            x = torch.where(ident.unsqueeze(-2), 0, xy[0])
            y = torch.where(ident.unsqueeze(-2), one, xy[1])
            return torch.stack([mm(x, z), mm(y, z), mm(mm(x, y), z), z]
                               ).contiguous(), ident
        if rcb:
            P = torch.stack([mm(xy[0], z), mm(xy[1], z), z])
            zero = proj.point_zero(spec, L, self.dev).to(torch.int32)
            return torch.where(ident.unsqueeze(-2), zero[:, None],
                               P).contiguous(), ident
        z2 = mm(z, z)
        P = torch.stack([mm(xy[0], z2), mm(xy[1], mm(z2, z)), z])
        return torch.where(ident.unsqueeze(-2), 0, P).contiguous(), ident

    def hold_by_slices(self, name: str, got, plain, *points) -> None:
        """Compare a kernel's output with its plain version over
        HOLD_SLICE lanes at a time (the kernel ran on all lanes at once)."""
        L = got.shape[-1]
        for o in range(0, L, HOLD_SLICE):
            sl = slice(o, min(o + HOLD_SLICE, L))
            self.compare(name, got[..., sl].contiguous(),
                         plain(*(P[..., sl].contiguous() for P in points)))

    def run_rcb_te(self, curve, seed: int, timed: bool) -> None:
        """rcb_double_k_add or te_double_k_add (by the curve's model) at
        k = 0, 1 and 4 bit-equal to double_k_add_plain at every lane count
        of RT_LANES and at the model's band edges and their neighbours
        (kk.DKA_BANDS), by slices of HOLD_SLICE lanes: P = row 0 and Q =
        row 1 of model_points (RCB projective or TE extended, random Z), so
        the lanes hold doublings (one point under two Z), P + (-P), O + Q,
        P + O, O + O and on curve25519 (0, 1). Timed at k = 0 (TE also at
        k = 1, the v1 bit Horner's) at RT_LANES from a CUDA graph, in
        microseconds beside the bound and the critical path; the table
        keeps the n = 2^20 MSM's stage D and E add, 90,112 lanes at
        k = 0."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        te = model(spec) == "te"
        nc = 4 if te else 3
        dka = kk.te_double_k_add if te else kk.rcb_double_k_add
        key = kk.dka_model(spec)
        g4, one = kk.DKA_BANDS[key]
        paths = DKA_PATH[key]
        fe = FE_MULS[model(spec)]
        shapes = sorted({*RT_LANES, g4 - 1, g4, one - 1, one})
        t0 = time.perf_counter()
        for L in shapes:
            T, _ = self.model_points(curve, spec, 2, L, seed + L, rcb=True)
            P, Q = T[:, 0].contiguous(), T[:, 1].contiguous()
            del T
            for k in (0, 1, 4):
                self.hold_by_slices(
                    dka.__name__, dka(spec, P, Q, k),
                    lambda p, q: kk.double_k_add_plain(spec, p, q, k), P, Q)
            if timed and L in RT_LANES:
                reps = 20 if L <= 1 << 20 else 3
                for k in ((0, 1) if te else (0,)):
                    ms = graph_ms(lambda: dka(spec, P, Q, k), reps)
                    bound = self.bound(3 * nc * 16 * L * 4, L * (
                        fe["add"] + k * fe["double"]) * MULS_PER_FE_MUL)
                    if L >= one:
                        add, dbl = paths["one"]
                        path = f"one thread a lane: {k * dbl + add} products"
                    else:
                        G = 8 if L < g4 else 4
                        add, dbl = paths[G]
                        path = (f"a group of {G} threads a lane: "
                                f"{k * dbl + add} product levels")
                    print(f"   {curve.name} {dka.__name__} {L} lanes k = {k}: "
                          f"kernel {ms:.4f} ms ({ms * 1e3:.2f} us); bound "
                          f"{bound[0]:.5g} ms ({bound[1]}); critical path "
                          f"({path})", flush=True)
                    if L == L_PLAN and k == 0:
                        self.times[dka.__name__] = (ms, host_ms(
                            lambda: kk.double_k_add_plain(spec, P, Q, 0)),
                            *bound)
            del P, Q
            torch.cuda.empty_cache()
        print(f"   {curve.name} {dka.__name__} (k = 0, 1, 4) at {shapes} "
              f"lanes: bit-equal ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    def run_jac(self, curve, seed: int, timed: bool) -> None:
        """jac_double_k_add (k = 0, 1, 4) bit-equal to its plain version at
        every lane count the paths send and at the crossover's neighbours
        (DKA_HELD, kk.DKA_BANDS["jac"] and the lane counts just below
        them): P = row 0 and Q = row 1 of model_points, so
        the lanes hold doublings (the same point under two Z), P + (-P),
        O + Q, P + O and O + O. Timed at k = 0 and 1 at DKA_LANES, each
        from a CUDA graph, in microseconds a lane's operation beside the
        bound and the critical path (the group's product levels, or one
        thread's products); the table keeps the P = 128 tree's first
        32,768 lanes at k = 0."""
        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        fe = FE_MULS["jac"]
        dbl = fe["double"] if spec.is_a_zero else fe["double_a"]
        # add levels of 5, 4, 3, 2, 2 products: 5 rounds at G = 8, 6 at
        # G = 4; doubling 4, 3, 1 (and M^2 a round of its own for a != 0)
        dbl_lv = 3 if spec.is_a_zero else 4
        g4, one = kk.DKA_BANDS["jac"]
        shapes = sorted({*DKA_HELD, g4 - 1, g4, one - 1, one})
        t0 = time.perf_counter()
        for L in shapes:
            T, ident = self.model_points(curve, spec, 2, L, seed + L)
            P, Q = T[:, 0].contiguous(), T[:, 1].contiguous()
            for k in (0, 1, 4):
                self.compare("jac_double_k_add",
                             kk.jac_double_k_add(spec, P, Q, k),
                             kk.jac_double_k_add_plain(spec, P, Q, k))
            if not timed or L not in DKA_LANES:
                continue
            xy = self.affine_rows(curve, spec, 2, L, seed + L)
            doubling = int(((xy[:, 0] == xy[:, 1]).all(dim=1).all(dim=0)
                            & ~ident[0] & ~ident[1]).sum())
            for k in (0, 1):
                ms = graph_ms(lambda: kk.jac_double_k_add(spec, P, Q, k), 20)
                muls = L * (fe["add"] + k * dbl) + (doubling * dbl if k == 0
                                                    else 0)
                bound = self.bound(3 * 3 * 16 * L * 4, muls * MULS_PER_FE_MUL)
                if L < one:
                    G, add_lv = (8, 5) if L < g4 else (4, 6)
                    path = (f"a group of {G} threads a lane: "
                            f"{k * dbl_lv + add_lv} product levels, {dbl_lv} "
                            f"more on a doubling lane")
                else:
                    path = (f"one thread a lane: {k * dbl + fe['add']} "
                            f"products, {dbl} more on a doubling lane")
                print(f"   {curve.name} jac_double_k_add {L} lanes k = {k}: "
                      f"kernel {ms:.4f} ms ({ms * 1e3:.2f} us); bound "
                      f"{bound[0]:.5g} ms ({bound[1]}); critical path "
                      f"({path})", flush=True)
                if L == TREE_LANES and k == 0:
                    self.times["jac_double_k_add"] = (
                        ms, host_ms(lambda: kk.jac_double_k_add_plain(
                            spec, P, Q, 0)), *bound)
        print(f"   {curve.name} jac_double_k_add (k = 0, 1, 4) at {shapes} "
              f"lanes: bit-equal ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    def scan_operands(self, curve, spec, R: int, L: int, seed: int):
        """The row scan's operands (jac_madd, or te_madd on a
        twisted-Edwards curve): P (NC, 16, L) Jacobian (x Z^2, y Z^3, Z)
        or extended (x Z, y Z, x y Z, Z) with a random Z, rows qx, qy (R,
        16, L) of affine points from a pool of 256 chain points and their
        negatives, q_inf (R, L); by lane % 6 (so that every prefix of the
        lanes holds each kind): 0 random, on TE every other such lane with
        (0, 1) as an ordinary affine point in row R - 1; 1 P = O and
        Q_{R-2} = Q_{R-1} (a doubling at the second add); 2 P = O and
        Q_{R-2} = -Q_{R-1} (a cancellation, then adds from O); 3 Q_{R-1}
        = P (a doubling at the first add); 4 Q_{R-1} = -P; 5 about 40% of
        the rows the identity (y = 0, q_inf), P = O on every other such
        lane (O + O)."""
        import torch

        from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops import proj
        from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device

        fq = spec.fq
        pts = GeneratorsChain(curve, b"chip_smoke pool").take(256)
        X, Y, _ = affine_to_device(curve, pts, self.dev)
        pool = torch.stack([X, Y])
        pool = torch.cat([pool, neg(spec, pool)], dim=2)  # (2, 16, 512)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        lane = torch.arange(L, device=self.dev)
        kind = lane % 6
        idx = torch.randint(0, 512, (R, L), generator=g, device=self.dev)
        ip = torch.randint(0, 512, (L,), generator=g, device=self.dev)
        if R >= 2:
            idx[R - 2] = torch.where(kind == 1, idx[R - 1], idx[R - 2])
            idx[R - 2] = torch.where(kind == 2, (idx[R - 1] + 256) % 512,
                                     idx[R - 2])
        idx[R - 1] = torch.where(kind == 3, ip, idx[R - 1])
        idx[R - 1] = torch.where(kind == 4, (ip + 256) % 512, idx[R - 1])
        xy = pool[:, :, idx].permute(0, 2, 1, 3).contiguous()
        q_inf = ((kind == 5) & (torch.rand((R, L), generator=g,
                                           device=self.dev) < 0.4))
        xy.masked_fill_(q_inf.unsqueeze(1), 0)
        z = torch.randint(0, 1 << 16, (16, L), generator=g, device=self.dev,
                          dtype=torch.int32)
        z[15] = 0  # below p
        z[0] |= 1  # not zero
        mm = lambda a, b: df.mont_mul(fq, a, b).to(torch.int32)  # noqa
        p_inf = (kind == 1) | (kind == 2) | ((kind == 5) & (lane // 6 % 2
                                                             == 1))
        x, y = pool[0][:, ip], pool[1][:, ip]
        if model(spec) == "te":
            zy = (kind == 0) & (lane // 6 % 2 == 1)  # (0, 1) in row R - 1
            xy[0, R - 1].masked_fill_(zy, 0)
            xy[1, R - 1] = torch.where(zy, df.const(fq.r_limbs, self.dev)
                                       .to(torch.int32), xy[1, R - 1])
            P = torch.stack([mm(x, z), mm(y, z), mm(mm(x, y), z), z])
            zero = proj.point_zero(spec, L, self.dev).to(torch.int32)
            P = torch.where(p_inf, zero, P).contiguous()
        else:
            z2 = mm(z, z)
            P = torch.stack([mm(x, z2), mm(y, mm(z2, z)), z])
            P = torch.where(p_inf, 0, P).contiguous()
        return P, xy[0].contiguous(), xy[1].contiguous(), q_inf.contiguous()

    def run_madd_scan(self, curve, seed: int, timed: bool) -> None:
        """The v1 row scan, one launch a (rows, lanes): jac_madd, or
        te_madd on a twisted-Edwards curve, bit-equal to its plain version
        at every row count of SCAN_ROWS and lane count of SCAN_LANES (up to
        32,768 lanes below 32 rows) and at the model's band edges
        (kk.MADD_BANDS) and the lanes below them, on scan_operands: the
        kernel runs on the first L lanes of one operand set per row count,
        the plain scan once on all of them. Timed at create_batch's
        32 x 32,768 (the table's shape) and one set's 32 x 512 (n = 256),
        beside the bound (a TE mixed add is 11 products on every lane and
        row but the q_inf rows) and the critical path."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        te = model(spec) == "te"
        name = "te_madd" if te else "jac_madd"
        wrapper = kk.te_madd if te else kk.jac_madd
        plain = kk.te_madd_plain if te else kk.jac_madd_plain
        g2, one = kk.MADD_BANDS["te" if te else "jac"]
        t0 = time.perf_counter()
        shapes = []
        for R in SCAN_ROWS:
            top = 1 << 17 if R == 32 else 1 << 15
            lanes = sorted({L for L in SCAN_LANES if L <= top}
                           | {L for L in (g2 - 1, g2, one - 1, one)
                              if L <= top})
            P, qx, qy, qi = self.scan_operands(curve, spec, R, max(lanes),
                                               seed + R)
            want = plain(spec, P, qx, qy, qi)
            for L in lanes:
                ops = [t[..., :L].contiguous() for t in (P, qx, qy, qi)]
                self.compare(name, wrapper(spec, *ops), want[..., :L])
                self.held.setdefault(name, set()).add((R, L))
                if R == 1:  # the one-row form
                    self.compare(name, wrapper(
                        spec, ops[0], *(t[0] for t in ops[1:])),
                        want[:, 0, :, :L])
                if timed and (R, L) in ((32, TREE_LANES), (32, 512)):
                    ms, bound = self.time_madd_scan(spec, ops)
                    if L == TREE_LANES:
                        self.times[name] = (ms, host_ms(
                            lambda: plain(spec, *ops)), *bound)
            shapes += [(R, L) for L in lanes]
            del P, qx, qy, qi, want
            torch.cuda.empty_cache()
        print(f"   {curve.name} {name} row scan at {len(shapes)} (rows, "
              f"lanes) from {shapes[0]} to {shapes[-1]}: bit-equal "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def time_madd_scan(self, spec, ops) -> tuple:
        """The row scan's ms on operands `ops` (P, qx, qy, q_inf) from a
        CUDA graph, printed beside its bound and critical path; returns
        (ms, (bound ms, bound_by))."""
        from ark_bulletproofs_tpu_torch.ops import kernels as kk

        te = model(spec) == "te"
        wrapper = kk.te_madd if te else kk.jac_madd
        R, _, L = ops[1].shape
        ms = graph_ms(lambda: wrapper(spec, *ops), 5)
        g2, one = kk.MADD_BANDS["te" if te else "jac"]
        nc = 4 if te else 3
        nbytes = (nc * 64 + R * (2 * 64 + 1) + nc * R * 64) * L
        if te:  # 11 products an add, the q_inf rows none
            adds = R * L - int(ops[3].sum())
            bound = self.bound(nbytes, adds * FE_MULS["te"]["madd"]
                               * MULS_PER_FE_MUL)
            if L >= one:
                path = f"one thread a lane: {R} x 11 products"
            elif L >= g2:  # levels of 4, 3, 4 products
                path = f"a group of 2 threads a lane: {R} x 6 product rounds"
            else:
                path = (f"a group of 4 threads a lane: {R} x 3 product "
                        f"levels, and the first row's t2")
            extra = ""
        else:
            fe = FE_MULS["jac"]
            dbl = fe["double"] if spec.is_a_zero else fe["double_a"]
            dbl_lv = 3 if spec.is_a_zero else 4
            # the lanes that double (kinds 3, and 1 from two rows)
            doubling = sum(1 for j in range(L)
                           if j % 6 == 3 or (j % 6 == 1 and R > 1))
            bound = self.bound(nbytes, (R * L * fe["madd"] + doubling * dbl)
                               * MULS_PER_FE_MUL)
            if L >= one:
                path = f"one thread a lane: {R} x {fe['madd']} products"
            else:  # levels of 2, 2, 4, 2, 2 products
                G, levels = (4, 5) if L < g2 else (2, 6)
                path = (f"a group of {G} threads a lane: {R} x {levels} "
                        f"product levels")
            extra = (f", {dbl_lv} levels or {dbl} products more on a "
                     f"doubling lane")
        print(f"   {spec.name} {wrapper.__name__} scan {R} x {L}: kernel "
              f"{ms:.4f} ms ({ms * 1e3 / R:.2f} us a row); bound "
              f"{bound[0]:.5g} ms ({bound[1]}); critical path ({path}"
              f"{extra})", flush=True)
        return ms, bound

    def run_double_chain(self, curve, seed: int, timed: bool) -> None:
        """jac_double's chain (a group of 4 threads a lane) bit-equal to
        its plain version at CHAIN_STEPS x CHAIN_LANES, on row 0 of
        model_points with every seventh lane the identity: the kernel on
        the first L lanes, the plain 255-step chain once on all of them
        (steps s: its rows up to s). Timed at the Q table's 255 x 1 beside
        the bound and the critical path."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        fe = FE_MULS["jac"]
        dbl = fe["double"] if spec.is_a_zero else fe["double_a"]
        dbl_lv = 3 if spec.is_a_zero else 4
        t0 = time.perf_counter()
        lanes = CHAIN_LANES
        T, _ = self.model_points(curve, spec, 1, max(lanes), seed)
        P = T[:, 0].contiguous()
        P[..., ::7] = 0
        want = kk.jac_double_plain(spec, P, max(CHAIN_STEPS))
        for L in lanes:
            P1 = P[..., :L].contiguous()
            for steps in CHAIN_STEPS:
                self.compare("jac_double", kk.jac_double(spec, P1, steps),
                             want[:, :, 1, :L] if steps == 1 else
                             want[:, :, :steps + 1, :L])
                self.held.setdefault("jac_double", set()).add((steps, L))
        print(f"   {curve.name} jac_double chain at steps {CHAIN_STEPS} x "
              f"lanes {lanes}: bit-equal ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        del want, T
        if not timed:
            return
        P1 = P[..., 1:2].contiguous()
        steps = max(CHAIN_STEPS)
        ms = graph_ms(lambda: kk.jac_double(spec, P1, steps), 5)
        bound = self.bound((3 + 3 * (steps + 1)) * 64,
                           steps * dbl * MULS_PER_FE_MUL)
        print(f"   {curve.name} jac_double chain {steps} x 1: kernel "
              f"{ms:.4f} ms ({ms * 1e3 / steps:.2f} us a doubling); bound "
              f"{bound[0]:.5g} ms ({bound[1]}); critical path (a group of "
              f"4 threads: {steps} x {dbl_lv} product levels; one thread "
              f"{steps} x {dbl} products)", flush=True)
        if spec.is_a_zero:
            self.times["jac_double"] = (ms, host_ms(
                lambda: kk.jac_double_plain(spec, P1, steps)), *bound)

    @staticmethod
    def fs_round_muls(spec, P: int) -> int:
        """Multiply instructions of one fs_round launch over P transcripts,
        counting its field products: per transcript Z_L Z_R, the two
        products that recover 1 / Z_L and 1 / Z_R, the R^3 product of each
        of the two inversions (fq, fr), and per side the affine and
        out-of-Montgomery products (Jacobian 1 / Z^2, 1 / Z^3, X and Y by
        them, 2 out: 6; TE X / Z, Y / Z, 2 out: 4), 264 instructions each.
        The safegcd inversions' own word products (92 a batch for the
        matrix updates, 11 an inner step; 17-19 batches of about 8 steps)
        depend on the data and are left out, as are Keccak, ChaCha20 and the
        comparisons, which multiply nothing: a lower bound."""
        side = 4 if model(spec) == "te" else 6
        return P * (4 + 2 * side + 1) * MULS_PER_FE_MUL

    def run_fs_round(self, curve, seed: int, timed: bool) -> None:
        """fs_round bit-equal to fs_round_plain (affine L and R, the
        state, u and u^-1, the flags, the positions) for P = 1, 2, 33 and
        128 transcripts at three positions, the last crossing the STROBE
        rate; on a short-Weierstrass curve with L = O (lane 0), R = O
        (lane 3) and both (lanes 4 and 5) where P reaches them; timed at
        P = 1 (a single proof) and 128 (the batch). Transcripts are
        independent, so each P runs the kernel on the first P of 128
        transcripts and is held against the first P of one plain call on
        all 128."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops import fs
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        fr = df.spec_for(curve.fr)
        t0 = time.perf_counter()
        top = 128
        S_all, _ = self.model_points(curve, spec, 1, 2 * top, seed)
        S_all = S_all[:, 0].contiguous()
        if model(spec) != "te":
            S_all[..., [0, 3, 4, 5]] = 0
        g = torch.Generator(device=self.dev).manual_seed(seed)
        st_all = torch.randint(0, 256, (top, 200), generator=g,
                               device=self.dev, dtype=torch.int32)
        for pos, pb in ((3, 1), (90, 85), (160, 150)):
            want = fs.fs_round_plain(spec, fr, S_all, st_all, pos, pb)
            for P in (1, 2, 33, top):
                S = S_all[..., :2 * P].contiguous()
                st = st_all[:P].contiguous()
                got = fs.fs_round(spec, fr, S, st, pos, pb)
                self.compare("fs_round", got[:4], (
                    want[0][..., :2 * P], want[1][..., :P], want[2][:P],
                    want[3][..., :P]))
                if got[4:] != want[4:]:
                    raise AssertionError(f"fs_round positions {got[4:]} != "
                                         f"{want[4:]}")
        for P in ((1, top) if timed else ()):
            S = S_all[..., :2 * P].contiguous()
            st = st_all[:P].contiguous()
            nc = S.shape[0]
            nbytes = (nc * 16 * 2 * P + 2 * 200 * P + 2 * 16 * 2 * P
                      + 2 * 16 * P + 3 * P) * 4
            key = "fs_round" if P == 1 else "fs_round P=128"
            self.times[key] = (
                graph_ms(lambda: fs.fs_round(spec, fr, S, st, 160, 150), 20),
                host_ms(lambda: fs.fs_round_plain(spec, fr, S, st, 160,
                                                  150)),
                *self.bound(nbytes, self.fs_round_muls(spec, P)))
        print(f"   {curve.name} fs_round at P = 1, 2, 33 and 128: bit-equal "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def field_operands(self, fs, rows: int, L: int, seed: int):
        """(rows, 16, L) int32 canonical field elements from a seeded
        generator on the card (the top limb below p's), lanes 0-5 of row 0
        the edges 0, 1, p - 1, p - 2, p - 1, p - 1 (the widest carries and
        borrows)."""
        import torch

        from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs

        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randint(0, 1 << 16, (rows, 16, L), generator=g,
                          device=self.dev, dtype=torch.int32)
        x[:, 15] %= fs.p >> 240
        p = fs.p
        edge = ints_to_limbs([0, 1, p - 1, p - 2, p - 1, p - 1], self.dev)
        k = min(L, 6)
        x[0, :, :k] = edge[:, :k]
        return x

    def run_mont_mul(self, curve, seed: int, timed: bool) -> None:
        """mont_mul bit-equal to its plain version on curve.fr and
        curve.fq at FIELD_LANES: a * b flat, with a (16, 1) operand on
        either side and per row, and a * b + c and a * b - c (the fused
        form: c full, c (16, 1), b (16, 1), per-row b and c), each against
        add_plain / sub_plain of mont_mul_plain; then the prover's row
        shapes. Timed at MM_LANES lanes (the k = 1024 fold) and at one lane
        (a challenge's product), the kernel alone from a CUDA graph beside
        its bound and the wrapper's rate with its host work."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df

        t0 = time.perf_counter()
        for field in (curve.fr, curve.fq):
            fs = df.spec_for(field)
            for L in FIELD_LANES:
                a, b, c = self.field_operands(fs, 3, L, seed + L).unbind(0)
                colb, colc = b[:, L - 1:].contiguous(), c[:, :1].contiguous()
                A2 = torch.stack([a, c])
                B2 = torch.stack([colb, colc])
                for x, y in ((a, b), (a, colb), (colb, a), (A2, B2)):
                    self.compare("mont_mul", df.mont_mul(fs, x, y).long(),
                                 df.mont_mul_plain(fs, x, y))
                for sign, plain in ((1, df.add_plain), (-1, df.sub_plain)):
                    for x, y, z in ((a, b, c), (a, b, colc), (a, colb, c),
                                    (A2, B2, torch.stack([b, colc.expand(
                                        16, L)]))):
                        self.compare("mont_mul",
                                     df.mont_mul(fs, x, y, z, sign).long(),
                                     plain(fs, df.mont_mul_plain(fs, x, y),
                                           z))
        # The prover's launches at k = 1024: the round scalars' (6, 16,
        # 2048) pair, the fold's (4, 16, 2048) against per-row (4, 16, 1)
        # challenges, and the vector phase's (9, 16, 2048) pair.
        fs = df.spec_for(curve.fr)
        for R, Rb, Lb in ((6, 6, 2048), (4, 4, 1), (9, 9, 2048)):
            x = self.field_operands(fs, R, 2048, seed + R)
            y = self.field_operands(fs, Rb, Lb, seed + R + Lb)
            self.compare("mont_mul", df.mont_mul(fs, x, y).long(),
                         df.mont_mul_plain(fs, x, y))
        torch.cuda.synchronize()
        print(f"   mont_mul {curve.name} fr and fq: bit-equal at {FIELD_LANES}"
              f" lanes, with c added and subtracted, and at (6, 4, 9) x 16 x "
              f"2048 ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not timed:
            return
        a, b, c = self.field_operands(fs, 3, MM_LANES, seed).unbind(0)
        self.times["mont_mul"] = (
            graph_ms(lambda: df.mont_mul(fs, a, b), 100),
            host_ms(lambda: df.mont_mul_plain(fs, a, b)),
            *self.bound(3 * 64 * MM_LANES, MM_LANES * MULS_PER_FE_MUL))
        self.wrapper_ms = cuda_ms(lambda: df.mont_mul(fs, a, b), 100)
        fused = graph_ms(lambda: df.mont_mul(fs, a, b, c), 100)
        one = [t[:, :1].contiguous() for t in (a, b)]
        ms1 = graph_ms(lambda: df.mont_mul(fs, *one), 100)
        b1 = self.bound(3 * 64, MULS_PER_FE_MUL)
        print(f"   mont_mul {curve.name} fr at {MM_LANES} lanes: kernel "
              f"{self.times['mont_mul'][0]:.4f} ms, with c added "
              f"{fused:.4f} ms; bound {self.times['mont_mul'][2]:.5g} ms "
              f"({self.times['mont_mul'][3]}); at 1 lane {ms1:.4f} ms, bound "
              f"{b1[0]:.3g} ms ({b1[1]}); critical path one product (about "
              f"1,354 cycles)", flush=True)

    def run_add_sub(self, curve, seed: int, timed: bool) -> None:
        """add, sub and neg on the card (the add_sub kernel) bit-equal to
        add_plain, sub_plain and neg_plain on curve.fr and curve.fq at
        FIELD_LANES, with the edge lanes of field_operands (p - 1 + p - 1:
        past 2^256 where 2p > 2^256; 0 - (p - 1)) and a (16, 1) operand on
        either side; timed at MM_LANES lanes."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df

        t0 = time.perf_counter()
        for field in (curve.fr, curve.fq):
            fs = df.spec_for(field)
            for L in FIELD_LANES:
                a, b = self.field_operands(fs, 2, L, seed + L).unbind(0)
                b = b.flip(-1).contiguous()  # edge lanes meet other lanes
                col = a[:, 2:3].contiguous() if L > 2 else a[:, :1]
                for op, plain, x, y in (
                        (df.add, df.add_plain, a, b),
                        (df.add, df.add_plain, a, a),
                        (df.sub, df.sub_plain, a, b),
                        (df.sub, df.sub_plain, b, a),
                        (df.add, df.add_plain, col, b),
                        (df.sub, df.sub_plain, col, b),
                        (df.sub, df.sub_plain, b, col)):
                    self.compare("add_sub", op(fs, x, y).long(),
                                 plain(fs, x, y))
                self.compare("add_sub", df.neg(fs, a).long(),
                             df.neg_plain(fs, a))
        torch.cuda.synchronize()
        print(f"   add_sub {curve.name} fr and fq: add, sub, neg bit-equal at "
              f"{FIELD_LANES} lanes ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if timed:
            fs = df.spec_for(curve.fr)
            a, b = self.field_operands(fs, 2, MM_LANES, seed).unbind(0)
            self.times["add_sub"] = (
                graph_ms(lambda: df.add(fs, a, b), 100),
                host_ms(lambda: df.add_plain(fs, a, b)),
                *self.bound(3 * 64 * MM_LANES, 0))

    def run_sum_mod(self, curve, seed: int, timed: bool) -> None:
        """sum_mod on the card (a torch column sum, then the sum_mod
        kernel's carries and reduction) bit-equal to sum_mod_plain on
        curve.fr at SUM_ROWS rows over SUM_LANES lanes (up to 2,048 past
        9 rows), row 1 all p - 1; timed, the tail kernel alone, at the
        vector phase's 9 rows of 2,048 lanes beside its bound (the bytes:
        its 3 products a row take less)."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs

        fs = df.spec_for(curve.fr)
        t0 = time.perf_counter()
        for R in SUM_ROWS:
            for L in SUM_LANES:
                if R > 9 and L > 2048:
                    continue
                x = self.field_operands(fs, R, L, seed + R + L)
                if R > 1:
                    x[1] = ints_to_limbs([fs.p - 1], self.dev)  # -> L
                self.compare("sum_mod", df.sum_mod(fs, x).long(),
                             df.sum_mod_plain(fs, x))
            self.held.setdefault("sum_mod", set()).add((R,))
        torch.cuda.synchronize()
        print(f"   sum_mod {curve.name} fr: bit-equal at {SUM_ROWS} rows over "
              f"{SUM_LANES} lanes ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if not timed:
            return
        x = self.field_operands(fs, 9, 2048, seed)
        cols = x.sum(dim=-1, dtype=torch.int64).contiguous()
        out = torch.empty(9, 16, 1, dtype=torch.int32, device=self.dev)
        r2 = df._r2_words(fs).ctypes.data_as(ctypes.c_void_p)

        def tail():
            kk.launch("sum_mod", fs, self.dev, cols.data_ptr(),
                      out.data_ptr(), 9, r2)

        self.times["sum_mod"] = (
            graph_ms(tail, 100), host_ms(lambda: df.sum_mod_plain(fs, x)),
            *self.bound(9 * (16 * 8 + 64), 9 * 3 * MULS_PER_FE_MUL))
        print(f"   sum_mod tail at 9 rows (the 2,048-lane dots' column sums "
              f"in): kernel {self.times['sum_mod'][0]:.4f} ms, with the torch "
              f"column sum {graph_ms(lambda: df.sum_mod(fs, x), 100):.4f} ms;"
              f" critical path 2 dependent products (3 in all, on one thread) "
              f"and an add", flush=True)

    def run_inv_batch(self, curve, seed: int, timed: bool) -> None:
        """mont_inv_batch on the card (one safegcd inverse a lane) bit-equal
        to mont_inv_batch_plain (Montgomery's trick and the Fermat power)
        on curve.fq, the shrink's field, at INV_LANES with every fifth
        lane zero, alone and with the shrink's two rows multiplied in
        (lanes are independent: one plain call at the widest, prefixes
        for the rest); timed at INV_TIMED lanes with two rows beside its
        bound and critical path."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops import fs as dfs

        fq = df.spec_for(curve.fq)
        t0 = time.perf_counter()
        B = max(INV_LANES)
        z, x, y = self.field_operands(fq, 3, B, seed).unbind(0)
        z[:, ::5] = 0
        rows = torch.stack([x, y])
        inv = dfs.mont_inv_batch_plain(fq, z)
        want = df.mont_mul_plain(fq, rows, inv)
        for L in INV_LANES:
            zl, rl = z[:, :L].contiguous(), rows[..., :L].contiguous()
            self.compare("mont_inv_batch", dfs.mont_inv_batch(fq, zl).long(),
                         inv[:, :L])
            self.compare("mont_inv_batch",
                         dfs.mont_inv_batch(fq, zl, rl).long(),
                         want[..., :L])
            self.held.setdefault("mont_inv_batch", set()).update(
                {(0, L), (2, L)})
        torch.cuda.synchronize()
        print(f"   mont_inv_batch {curve.name} fq: bit-equal at {INV_LANES} "
              f"lanes, with and without 2 rows ({time.perf_counter() - t0:.1f}"
              f" s)", flush=True)
        if not timed:
            return
        L = INV_TIMED
        zl, rl = z[:, :L].contiguous(), rows[..., :L].contiguous()
        self.times["mont_inv_batch"] = (
            graph_ms(lambda: dfs.mont_inv_batch(fq, zl, rl), 20),
            host_ms(lambda: dfs.mont_inv_batch_plain(fq, zl, rl)),
            *self.bound(5 * 64 * L, 3 * L * MULS_PER_FE_MUL))
        print(f"   mont_inv_batch {curve.name} fq at {L} lanes, 2 rows: kernel "
              f"{self.times['mont_inv_batch'][0]:.4f} ms, plain "
              f"{self.times['mont_inv_batch'][1]:.1f} ms; bound "
              f"{self.times['mont_inv_batch'][2]:.5g} ms (its 3 field "
              f"products a lane, not the safegcd's word products: a lower "
              f"bound); critical path one safegcd inverse (about 32,000 "
              f"cycles) and 2 products", flush=True)

    def run_te_chain(self, curve, seed: int, timed: bool) -> None:
        """te_double's chain (a group of 8 threads a lane) bit-equal to its
        plain version at CHAIN_STEPS x TE_CHAIN_LANES, on row 0 of
        model_points with lane 1 the identity: the kernel on the first L
        lanes, the plain 255-step chain once on all of them. Timed at the
        Q table's 255 x 1 and the commit table's 255 x 2 beside the bound
        and the critical path."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import proj
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        t0 = time.perf_counter()
        T, _ = self.model_points(curve, spec, 1, 8 * max(TE_CHAIN_LANES),
                                 seed)
        P = T[:, 0, :, 4 * max(TE_CHAIN_LANES):].contiguous()
        P[..., 1] = proj.point_zero(spec, 1, self.dev)[..., 0]
        P = P[..., :max(TE_CHAIN_LANES)].contiguous()
        want = kk.te_double_plain(spec, P, max(CHAIN_STEPS))
        for L in TE_CHAIN_LANES:
            P1 = P[..., :L].contiguous()
            for steps in CHAIN_STEPS:
                self.compare("te_double", kk.te_double(spec, P1, steps),
                             want[:, :, 1, :L] if steps == 1 else
                             want[:, :, :steps + 1, :L])
                self.held.setdefault("te_double", set()).add((steps, L))
        torch.cuda.synchronize()
        print(f"   {curve.name} te_double chain at steps {CHAIN_STEPS} x "
              f"lanes {TE_CHAIN_LANES}: bit-equal "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not timed:
            return
        steps = max(CHAIN_STEPS)
        dbl = FE_MULS["te"]["double"]
        for L in (1, 2):
            P1 = P[..., [0, 2][:L]].contiguous()  # no identity lane
            ms = graph_ms(lambda: kk.te_double(spec, P1, steps), 5)
            bound = self.bound((4 + 4 * (steps + 1)) * 64 * L,
                               L * steps * dbl * MULS_PER_FE_MUL)
            print(f"   {curve.name} te_double chain {steps} x {L}: kernel "
                  f"{ms:.4f} ms ({ms * 1e3 / steps:.2f} us a doubling); bound "
                  f"{bound[0]:.5g} ms ({bound[1]}); critical path (a group of"
                  f" 8 threads: {steps} x 3 product levels; one thread "
                  f"{steps} x {dbl} products)", flush=True)
            if L == 1:
                self.times["te_double"] = (ms, host_ms(
                    lambda: kk.te_double_plain(spec, P1, steps)), *bound)

    def horner_parts(self, curve, spec, jac: bool, B: int, W: int,
                     seed: int):
        """(NC, 16, B, W) window parts, windows innermost as the engines
        hold them: the W rows of a suffix_madd_scan over affine_rows (RCB
        or extended points) or of model_points (Jacobian); windows 1 and
        W / 2 the identity in the first half of the sets (the one set at
        B = 1), the top window in the first quarter."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
        from ark_bulletproofs_tpu_torch.ops import proj
        from ark_bulletproofs_tpu_torch.ops.curve import point_zero

        if jac:
            T, _ = self.model_points(curve, spec, W, B, seed)
            zero = point_zero(spec, B, self.dev)
        else:
            T = k2.suffix_madd_scan(spec, self.affine_rows(curve, spec, W,
                                                           B, seed))
            zero = proj.point_zero(spec, B, self.dev)
        parts = T.permute(0, 2, 3, 1).contiguous()
        zero = zero.to(torch.int32)
        for w, sets in ((1, max(B // 2, 1)), (W // 2, max(B // 2, 1)),
                        (W - 1, B // 4)):
            parts[..., :sets, w] = zero[..., :sets]
        return parts, zero

    def run_horner(self, curve, seed: int, timed: bool) -> None:
        """horner_windows on RCB (or extended) points and
        jac_horner_windows on Jacobian points, at v2's stage-G shape for
        n = 2^20 (one set, W = 22, c = 12) and at the create_batch v1
        shape (256 sets, W = 64, c = 4), from the identity over all W
        windows and from the top window over the other W - 1 (read in
        place): bit-equal to the plain version and to the W-step loop of
        the double-k-add kernel on the card. Timed at both shapes against
        that loop, each from a CUDA graph."""
        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        te = model(spec) == "te"
        t0 = time.perf_counter()
        for jac in ((False,) if te else (False, True)):
            if jac:
                name = "jac_horner_windows"
                horner, dka = k2.jac_horner_windows, kk.jac_double_k_add
                plain = k2.jac_horner_windows_plain
                fe = FE_MULS["jac"]
                dbl = fe["double"] if spec.is_a_zero else fe["double_a"]
            else:
                name = entry("horner_windows", spec)
                horner, dka = k2.horner_windows, kk.double_k_add
                plain = k2.horner_windows_plain
                fe = FE_MULS[model(spec)]
                dbl = fe["double"]
            nc = 3 + te
            for shape, B, W, c in (("stage G", 1, 22, 12),
                                   ("v1", 256, 64, 4)):
                parts, zero = self.horner_parts(curve, spec, jac, B, W,
                                                seed + B)
                top = parts[..., W - 1].contiguous()
                starts = {"identity": (parts, zero),
                          "top window": (parts[..., :W - 1], top)}
                loops = {}
                for start, (pw, acc0) in starts.items():
                    got = horner(spec, pw, c, acc0)
                    self.compare(name, got, plain(spec, pw, c, acc0))

                    def loop(pw=pw, acc0=acc0):
                        acc = acc0
                        for w in range(pw.shape[-1] - 1, -1, -1):
                            acc = dka(spec, acc, pw[..., w].contiguous(), c)
                        return acc

                    self.compare(name, got, loop())
                    loops[start] = loop
                if not timed:
                    continue
                start = "top window" if shape == "stage G" else "identity"
                pw, acc0 = starts[start]
                Wu = pw.shape[-1]
                ms = graph_ms(lambda: horner(spec, pw, c, acc0), 5)
                loop_ms = graph_ms(loops[start], 1)
                bound = self.bound((B * Wu + 2 * B) * nc * 16 * 4,
                                   B * Wu * (c * dbl + fe["add"])
                                   * MULS_PER_FE_MUL)
                print(f"   {curve.name} {name} {shape} (B = {B}, "
                      f"{Wu} windows, c = {c}, from the {start}): kernel "
                      f"{ms:.4f} ms ({ms * 1e3 / (Wu * (c + 1)):.3f} us a "
                      f"group operation of the chain), the {Wu}-launch "
                      f"double-k-add loop {loop_ms:.4f} ms, bound "
                      f"{bound[0]:.5g} ms ({bound[1]})", flush=True)
                if (shape == "stage G") != jac:  # each one's main path
                    self.times[name] = (
                        ms, host_ms(lambda: plain(spec, pw, c, acc0)),
                        *bound)
        print(f"   {curve.name} Horner kernels at (B, W, c) = (1, 22, 12) "
              f"and (256, 64, 4), both starts: bit-equal to the plain "
              f"versions and the double-k-add loops "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def run_rcb_double(self, curve, seed: int, timed: bool) -> None:
        """rcb_double (kernels.double at 65,536 lanes, and the wrapper)
        bit-equal to its plain version at RCB_DBL_LANES and at the model's
        band edge (kk.DBL_BANDS) and the lane on each side: the kernel on
        the first L lanes of row 0 of model_points (RCB projective with a
        random Z, about a third of the lanes the identity), the plain
        version once on all of them. Timed at those lane counts from a
        CUDA graph beside the bound and the critical path; the table keeps
        65,536 lanes. No path calls it, as in the JAX package."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        key = kk.dka_model(spec)
        edge = kk.DBL_BANDS[key]
        G = 4 if spec.is_a_zero else 8
        # product levels of a group, products of one thread (csrc/rcb.cuh;
        # zorro's a by double-and-add)
        levels, products = (2, 8) if spec.is_a_zero else (3, 13)
        lanes = sorted({*RCB_DBL_LANES, edge - 1, edge, edge + 1})
        t0 = time.perf_counter()
        T, _ = self.model_points(curve, spec, 1, max(lanes), seed, rcb=True)
        P = T[:, 0].contiguous()
        del T
        want = kk.rcb_double_plain(spec, P)
        for L in lanes:
            P1 = P[..., :L].contiguous()
            got = kk.double(spec, P1) if L == 1 << 16 else kk.rcb_double(
                spec, P1)
            self.compare("rcb_double", got, want[..., :L])
            if not timed:
                continue
            ms = graph_ms(lambda: kk.rcb_double(spec, P1), 20)
            bound = self.bound(2 * 3 * 16 * L * 4,
                               L * products * MULS_PER_FE_MUL)
            path = (f"one thread a lane: {products} products" if L >= edge
                    else f"a group of {G} threads a lane: {levels} product "
                    f"levels")
            print(f"   {curve.name} rcb_double {L} lanes: kernel {ms:.4f} ms "
                  f"({ms * 1e3:.2f} us); bound {bound[0]:.5g} ms "
                  f"({bound[1]}); critical path ({path})", flush=True)
            if L == 1 << 16 and spec.is_a_zero:
                self.times["rcb_double"] = (ms, host_ms(
                    lambda: kk.rcb_double_plain(spec, P1)), *bound)
        del P, want
        torch.cuda.empty_cache()
        print(f"   {curve.name} rcb_double at {lanes} lanes: bit-equal "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def run_row_gather(self) -> None:
        """row_gather bit-equal to index_select at the DMA probe's shape
        (an n = 2^20-row table of random words, K = 2^22 random int32 rows
        from numpy seed 11, as tools/probe_dma_gather.py draws them) and
        at stage B's row count for n = 2^20 (22 windows, each a random
        permutation of the 2^20 rows, int64: 1.48 GB out); each timed from
        a CUDA graph against index_select, the library call, in ms and ns
        a row. The bound counts the distinct rows read, the indices and
        the rows written."""
        import numpy as np
        import torch

        from ark_bulletproofs_tpu_torch.ops import gather

        n, K = 1 << 20, 1 << 22
        rng = np.random.default_rng(11)
        tbl = torch.from_numpy(rng.integers(0, 2**32, size=(n, 16),
                                            dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(self.dev)
        probe = torch.from_numpy(rng.integers(0, n, size=(K,),
                                              dtype=np.int64)
                                 .astype(np.int32)).to(self.dev)
        g = torch.Generator(device=self.dev).manual_seed(12)
        stage_b = torch.cat([torch.randperm(n, generator=g, device=self.dev)
                             for _ in range(22)])
        for what, idx in (("probe", probe), ("stage B", stage_b)):
            got = gather.row_gather(tbl, idx)
            self.compare("row_gather", got, tbl.index_select(0, idx))
            del got
            rows = idx.shape[0]
            ms = graph_ms(lambda: gather.row_gather(tbl, idx), 3)
            lib = graph_ms(lambda: tbl.index_select(0, idx), 3)
            distinct = int(torch.unique(idx).numel())
            bound = self.bound(distinct * 64 + rows * idx.element_size()
                               + rows * 64, 0)
            print(f"   row_gather {what} ({rows} rows of 64 bytes, "
                  f"{idx.dtype} indices, {distinct} distinct): kernel "
                  f"{ms:.4f} ms ({ms * 1e6 / rows:.3f} ns/row), "
                  f"index_select {lib:.4f} ms ({lib * 1e6 / rows:.3f} "
                  f"ns/row), bound {bound[0]:.5g} ms ({bound[1]}); "
                  f"bit-equal", flush=True)
            if what == "stage B":
                self.times["row_gather"] = (
                    ms, host_ms(lambda: gather.row_gather_plain(tbl, idx)),
                    *bound)
                self.library_ms["row_gather"] = lib
            torch.cuda.empty_cache()

    def run_stage_gather(self) -> None:
        """stage_gather bit-equal to stage_gather_plain, and stage_table
        to stage_table_plain, at every (n, B, mapped) of GATHER_SHAPES,
        under msm2's plan for each: random 16-bit
        limbs with identity rows (about a tenth), the order a random
        permutation a row (at n = 2^20 the order of a real _stage_sort of
        random scalars), with a base map a table of 2 n + 3 rows. Timed at
        stage B's n = 2^20, B = 1: the wrapper (the table kernel and the
        gather kernel, by CUDA events around 5 calls, its host work and the
        allocator's cached blocks as on the path), and from CUDA graphs the
        gather kernel alone, the table kernel alone, and index_select of
        the 128-byte rows at the R L rows (the one PyTorch call that
        gathers them, without the transpose), beside the bound: the
        output, the distinct table rows at 128 bytes a point and the
        order, read and written once; the table kernel beside its plain
        version and its bound (the two planes and the flags read, the
        packed rows written)."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import gather, msm2
        from ark_bulletproofs_tpu_torch.ops.kernels import launch

        gen = torch.Generator(device=self.dev).manual_seed(51)
        held = self.held.setdefault("stage_gather", set())

        def limbs(m):
            return torch.randint(0, 1 << 16, (16, m), generator=gen,
                                 device=self.dev, dtype=torch.int32)

        for n, B, mapped in GATHER_SHAPES:
            t0 = time.perf_counter()
            g = msm2._Cfg(n, msm2.window_bits(n), B, self.dev)
            m = 2 * n + 3 if mapped else n
            X, Y = limbs(m), limbs(m)
            inf = torch.rand(m, generator=gen, device=self.dev) < 0.1
            timed = (n, B, mapped) == (N_MSM, 1, False)
            if timed:
                order, _ = msm2._stage_sort(g, limbs(B * n).reshape(B, 16, n))
            else:
                order = torch.argsort(torch.rand(
                    g.BW, n, generator=gen, device=self.dev), dim=1)
            bm = (torch.randint(0, m, (B, n), generator=gen, device=self.dev)
                  if mapped else None)
            args = (X, Y, inf, order, g.R, g.C, g.W, bm)
            self.compare("stage_table", gather.stage_table(X, Y, inf),
                         gather.stage_table_plain(X, Y, inf))
            got = gather.stage_gather(*args)
            self.compare("stage_gather", got, gather.stage_gather_plain(*args))
            held.add((n, B, mapped))
            print(f"   stage_gather n = {n}, B = {B}"
                  f"{', base map' if mapped else ''} (R = {g.R}, C = {g.C}, "
                  f"W = {g.W}, L = {g.L}): bit-equal "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            del got
            torch.cuda.empty_cache()
            if not timed:
                continue
            out_bytes = 2 * g.R * 16 * g.L * 4
            distinct = int(torch.unique(order).numel())
            bound = self.bound(out_bytes + distinct * 128
                               + order.numel() * order.element_size(), 0)
            ms = cuda_ms(lambda: gather.stage_gather(*args), 5)
            tbl = gather.stage_table_plain(X, Y, inf)
            table_ms = graph_ms(lambda: launch(
                "stage_table", None, self.dev, X.data_ptr(), Y.data_ptr(),
                inf.data_ptr(), m, m, m, tbl.data_ptr()), 3)
            table_plain = host_ms(lambda: gather.stage_table_plain(X, Y,
                                                                   inf))
            # the planes and the identity flags read, the rows written
            table_bound = self.bound(2 * 16 * m * 4 + m + m * 16 * 4, 0)
            out = torch.empty(2, g.R, 16, g.L, dtype=torch.int32,
                              device=self.dev)
            kernel_ms = graph_ms(lambda: launch(
                "stage_gather", None, self.dev, tbl.data_ptr(),
                order.data_ptr(), 0, out.data_ptr(), m, n, g.R, g.C, g.W,
                g.BW, 1), 3)
            del out, tbl
            plain = host_ms(lambda: gather.stage_gather_plain(*args))
            wide = torch.stack([X, torch.where(inf, 0, Y)]).permute(
                2, 0, 1).reshape(m, 32).contiguous()
            rows = order.reshape(g.BW, g.C, g.R).permute(2, 0, 1).reshape(-1)
            lib = graph_ms(lambda: wide.index_select(0, rows), 3)
            del wide, rows
            print(f"   stage_gather n = 2^20, B = 1 ({g.R} x {g.L} points, "
                  f"{out_bytes / 1e9:.3f} GB out, {distinct} distinct rows):"
                  f" wrapper {ms:.4f} ms ({out_bytes / ms / 1e9:.3f} TB/s "
                  f"of output), gather kernel alone {kernel_ms:.4f} ms, "
                  f"table kernel alone {table_ms:.4f} ms (plain "
                  f"{table_plain:.3f} ms, bound {table_bound[0]:.5g} ms); "
                  f"plain {plain:.1f} ms; "
                  f"index_select of the 128-byte rows {lib:.4f} ms; bound "
                  f"{bound[0]:.5g} ms ({bound[1]})", flush=True)
            self.times["stage_table"] = (table_ms, table_plain, *table_bound)
            self.times["stage_gather"] = (ms, plain, *bound)
            self.library_ms["stage_gather"] = lib
            torch.cuda.empty_cache()

    def run_gens(self, curve, timed: bool) -> None:
        """gen_candidates bit-equal (x, y, ok) to its plain version at
        GEN_ATTEMPTS attempts (x = 0, 1, p - 1 and about half non-squares;
        the root picked by the sign word); timed at 2^21 attempts from a
        CUDA graph beside the plain version and the bound (the multiplies
        the function needs, from the exponent and the field:
        ops/gens.py::least_muls; the kernel's own field products, from its
        window schedule, printed beside it)."""
        import numpy as np
        import torch

        from ark_bulletproofs_tpu_torch.ops import gens
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec, sq = spec_for(curve), gens.sqrt_spec_for(curve.fq)
        p = curve.fq.p
        t0 = time.perf_counter()
        for m in GEN_ATTEMPTS:
            w = np.random.default_rng(m).integers(
                0, 1 << 32, size=(m, 9), dtype=np.uint64).astype(np.uint32)
            w[:, 7] %= np.uint32(p >> 224)  # x below p
            for i, x in enumerate([0, 1, p - 1][:m]):
                w[i, :8] = [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
            w = torch.from_numpy(w.view(np.int32)).to(self.dev)
            got = gens.gen_candidates(spec, sq, w)
            t1 = time.perf_counter()
            want = gens.gen_candidates_plain(spec, sq, w)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            self.compare("gen_candidates", got, want)
            if m != GEN_ATTEMPTS[-1] or not timed:
                continue
            products = gens.kernel_products(spec, sq)
            least = gens.least_muls(spec, sq)
            ms = graph_ms(lambda: gens.gen_candidates(spec, sq, w), 3)
            bound = self.bound(m * (36 + 65), m * least)
            print(f"   {curve.name} gen_candidates {m} attempts: kernel "
                  f"{ms:.4f} ms ({ms * 1e6 / m:.2f} ns an attempt; "
                  f"{products} field products, "
                  f"{products * MULS_PER_FE_MUL} multiplies each, against "
                  f"the {least} the function needs), plain {plain_ms:.1f} "
                  f"ms, bound {bound[0]:.5g} ms ({bound[1]}, "
                  f"{ms / bound[0]:.2f} times); "
                  f"{int(got[1].sum())} on the curve", flush=True)
            if curve.name == "secq256k1":
                self.times["gen_candidates"] = (ms, plain_ms, *bound)
        print(f"   {curve.name} gen_candidates at {GEN_ATTEMPTS} attempts: "
              f"bit-equal ({time.perf_counter() - t0:.1f} s)", flush=True)

    def report(self) -> None:
        for name, (ms, pms, bms, by) in self.times.items():
            print(f"   {name}: kernel {ms:.4f} ms, plain {pms:.1f} ms, "
                  f"bound {bms:.5g} ms ({by})", flush=True)
        print(f"   mont_mul wrapper, host work included: {self.wrapper_ms:.4f}"
              f" ms a call (CUDA events around 100 calls)", flush=True)


def path_name(what: str, curve) -> str:
    return what if curve.name == "secq256k1" else f"{what} {curve.name}"


def phase_msm(curve, launches: Launches, pts=None) -> tuple:
    """n = 2^20 MSM through `msm`, equal to the host Pippenger: on `pts`,
    2^20 distinct points (the farm's), against the native host Pippenger
    over them; else on 2^13 chain points tiled 128 times, against the host
    Pippenger (pure Python on curve25519) over the 2^13 points with the
    sums of their scalars. Then the device MSM timed (median of 5) with
    its peak memory, and its stage split by CUDA events (equal to the host
    Pippenger too). Returns the device inputs (X, Y, inf, scal), the host
    reference and the median ms, for phase 16."""
    import numpy as np
    import torch

    import ark_bulletproofs_tpu_torch as port
    from ark_bulletproofs_tpu_torch import engine, native
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                      point_batch_to_host,
                                                      spec_for)
    from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
    from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_ragged

    t0 = time.perf_counter()
    raw = np.random.default_rng(2024).integers(
        0, 1 << 16, size=(N_MSM, 16), dtype=np.uint16).tobytes()
    r = curve.fr.p
    ks = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % r
          for i in range(N_MSM)]
    if pts is None:
        pts = GeneratorsChain(curve, b"chip_smoke msm").take(N_DISTINCT)
        reps = N_MSM // N_DISTINCT
        bases = pts * reps  # base i is pts[i % 2^13]
        ksum = [sum(ks[j::N_DISTINCT]) % r for j in range(N_DISTINCT)]
        want = curve.msm(pts, ksum)  # host Pippenger over 2^13 points
        what = f"{N_DISTINCT} chain points tiled {reps} times"
    else:
        reps, bases = 1, pts
        if not native.set_curve_native(curve):
            raise AssertionError("no native host Pippenger for this curve")
        want = curve.to_affine(native.cpu_pippenger_native(pts, ks,
                                                           curve=curve))
        what = f"{len(pts)} distinct farm points, native host Pippenger"
    print(f"   inputs and host reference ({what}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    spec = spec_for(curve)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = launches.run(path_name("msm", curve),
                       lambda: port.msm(curve, bases, ks),
                       MSM_KERNELS[model(spec)], spec)
    e2e = time.perf_counter() - t0
    if got != want:
        raise AssertionError("n=2^20 MSM differs from the host Pippenger")
    print(f"   port msm == host Pippenger (end to end {e2e:.3f} s)",
          flush=True)
    dev = engine.torch_device()
    X, Y, inf = affine_to_device(curve, pts, dev)
    X, Y, inf = X.repeat(1, reps), Y.repeat(1, reps), inf.repeat(reps)
    scal = scalars_to_device(curve, [ks], dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msm_device_ragged(spec, X, Y, inf, scal)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"   device msm {curve.name}: median {med * 1e3:.1f} ms of "
          f"{[round(t * 1e3, 1) for t in times]} -> {N_MSM / med:.0f} "
          f"points/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    split, out, g = msm_stage_split(spec, X, Y, inf, scal)
    if point_batch_to_host(curve, out)[0] != want:
        raise AssertionError("the staged n=2^20 MSM differs from the host")
    total = sum(split.values())
    print(f"   stage split {curve.name} (CUDA events, median of 3; plan "
          f"C = {g.C}, R = {g.R}, c1 = {g.c1}, c2 = {g.c2}, L = {g.L}): "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in split.items())
          + f"; sum {total:.3f} ms", flush=True)
    return (X, Y, inf, scal), want, med * 1e3


GENS_SPLIT = (("gens:chacha", "ChaCha words"),
              ("gens:frame", "framing and the >= p test"),
              ("gens:h2d", "host to device (and the launch)"),
              ("gens:kernel", "kernel (to its ok flags on the host)"),
              ("gens:d2h", "accepted points to the host"),
              ("gens:ints", "ints and assembly"))


def phase_gens(launches: Launches) -> list:
    """The generator farm: fast_forward(4096) then take(4096) of the G
    chain through the farm on secq256k1 and take(4096) on zorro (which
    replays on the host), each equal to the host chain; the farm against
    the host chain at GEN_RATE_SIZES generators (the gate lowered), the
    host's rate at 512; then take(2^20) on secq256k1, timed with its
    split. Returns the 2^20 points (phase 3's MSM bases)."""
    import torch

    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for
    from ark_bulletproofs_tpu_torch.utils import profiling

    gate = GeneratorsChain._DEVICE_MIN
    label = b"G\0\0\0\0"

    def host(fn):
        """fn() with the farm's gate out of reach: the host chain."""
        GeneratorsChain._DEVICE_MIN = 1 << 62
        try:
            return fn()
        finally:
            GeneratorsChain._DEVICE_MIN = gate

    sec, zor = curves.secq256k1, curves.zorro
    t0 = time.perf_counter()

    def farm():
        chain = GeneratorsChain(sec, label).fast_forward(4096)
        return chain, chain.take(4096)

    chain, got = launches.run("gens secq256k1 fast_forward + take", farm,
                              ("gen_candidates",), spec_for(sec))
    farm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = host(lambda: GeneratorsChain(sec, label).fast_forward(4096))
    want = host(lambda: ref.take(4096))
    host_s = time.perf_counter() - t0
    if got != want or chain.take(3) != ref.take(3):
        raise AssertionError("the farm's secq256k1 chain differs from the "
                             "host chain")
    print(f"   secq256k1 fast_forward(4096) + take(4096): farm {farm_s:.3f} "
          f"s, host chain {host_s:.3f} s, equal (and the next 3)",
          flush=True)
    replays = GeneratorsChain.replays
    t0 = time.perf_counter()
    got = launches.run("gens zorro take",
                       lambda: GeneratorsChain(zor, label).take(4096), (),
                       spec_for(zor))
    farm_s = time.perf_counter() - t0
    if GeneratorsChain.replays != replays + 1:
        raise AssertionError("zorro's farm did not replay on the host")
    if got != host(lambda: GeneratorsChain(zor, label).take(4096)):
        raise AssertionError("the farm's zorro chain differs from the host "
                             "chain")
    print(f"   zorro take(4096): through the farm's gate, an x >= p in its "
          f"first chunk, replayed on the host ({farm_s:.3f} s); equal to "
          f"the host chain", flush=True)
    for n in GEN_RATE_SIZES:
        t0 = time.perf_counter()
        want = host(lambda: GeneratorsChain(sec, b"rate").take(n))
        host_s = time.perf_counter() - t0
        GeneratorsChain._DEVICE_MIN = 1
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = GeneratorsChain(sec, b"rate").take(n)
            farm_s = time.perf_counter() - t0
        finally:
            GeneratorsChain._DEVICE_MIN = gate
        if got != want:
            raise AssertionError(f"the farm differs from the host at {n}")
        print(f"   secq256k1 take({n}): host chain {host_s * 1e3:.1f} ms "
              f"({host_s * 1e3 / n:.3f} ms a point), farm (gate lowered) "
              f"{farm_s * 1e3:.1f} ms; equal", flush=True)
        if n == 512:
            rate = host_s / n
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = launches.run(
        "gens secq256k1 take 2^20",
        lambda: GeneratorsChain(sec, b"chip_smoke msm").take(N_MSM),
        ("gen_candidates",), spec_for(sec))
    total = time.perf_counter() - t0
    split = {what: profiling.total(name) for name, what in GENS_SPLIT}
    profiling.reset()
    if len(pts) != N_MSM or len(set(pts)) != N_MSM:
        raise AssertionError("take(2^20) did not give 2^20 distinct points")
    for P in pts[:: N_MSM // 64]:
        if not sec.is_on_curve(P):
            raise AssertionError("take(2^20) gave a point off the curve")
    print(f"   secq256k1 take(2^20): {total:.3f} s "
          f"({N_MSM / total:.0f} points/s; the host chain's rate at 512, "
          f"{rate * 1e3:.3f} ms a point, would take {rate * N_MSM:.1f} s); "
          f"split: " + ", ".join(f"{what} {t * 1e3:.1f} ms"
                                 for what, t in split.items())
          + f", other {(total - sum(split.values())) * 1e3:.1f} ms; "
          f"distinct, on the curve", flush=True)
    return pts


MSM_STAGES = ("sort", "gather", "C scan", "D carries", "E buckets",
              "F rowsum", "G horner")


def msm_stage_split(spec, X, Y, inf, scal, reps: int = 3):
    """Milliseconds of each stage of one v2 MSM (ops/msm2.py::msm2_impl's
    stages in its order: A and B's digits and sort, the gather, the scan,
    the carries, the bucket terms, the row sums, the window Horner) by CUDA
    events between them, the median of `reps` calls; also the sums of the
    last call (NC, 16, B) and its plan. scal: (B, 16, n) on the card."""
    import torch

    from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
    from ark_bulletproofs_tpu_torch.ops import msm2

    n, B = scal.shape[-1], scal.shape[0]
    g = msm2._Cfg(n, msm2.window_bits(n), B, scal.device)
    runs = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in MSM_STAGES]
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[0].record()
        order, sd = msm2._stage_sort(g, scal)
        ev[1].record()
        xy = msm2._stage_gather(g, X, Y, inf, order)
        ev[2].record()
        del order
        locs = k2.suffix_madd_scan(spec, xy)
        ev[3].record()
        del xy
        excl = msm2._stage_carries(g, spec, locs)
        ev[4].record()
        U = msm2._stage_buckets(g, spec, sd, excl, locs)
        ev[5].record()
        del locs, excl
        wsum = msm2._stage_rowsum(g, spec, U)
        ev[6].record()
        out = msm2._stage_horner(g, spec, wsum)
        ev[7].record()
        torch.cuda.synchronize()
        runs.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    split = {name: statistics.median(r[i] for r in runs)
             for i, name in enumerate(MSM_STAGES)}
    return split, out, g


def tamper_t_x(curve, proof):
    """The proof with one byte of t_x flipped (still a valid scalar)."""
    from ark_bulletproofs_tpu_torch.r1cs import R1CSProof

    blob = bytearray(proof.to_bytes(curve))
    off = 11 * len(curve.serialize_compressed(curve.gen))  # 11 points
    blob[off] ^= 1
    return R1CSProof.from_bytes(curve, bytes(blob))


def must_raise(what: str, fn) -> None:
    from ark_bulletproofs_tpu_torch.errors import (R1CSError,
                                                   VerificationError)

    try:
        fn()
    except (R1CSError, VerificationError):
        print(f"   {what}: rejected", flush=True)
        return
    raise AssertionError(f"{what}: accepted")


def full_collections() -> int:
    """Full (generation 2) garbage collections so far in this process."""
    return gc.get_stats()[2]["collections"]


def print_phases() -> None:
    """The protocol phases timed since the last reset (host clock)."""
    from ark_bulletproofs_tpu_torch.utils import profiling

    print("\n".join(f"     {line}" for line in
                    profiling.report().splitlines()), flush=True)
    profiling.reset()


def traced(what: str, fn) -> None:
    """Run fn once under torch.profiler and print its wall time, the
    card's busy time (the summed durations of its kernels and copies: one
    stream, so they do not overlap; the phases' annotation ranges are not
    card work and are left out) and the card time of the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e6)
    busy = sum(t for _, t in by_name.values())
    print(f"   traced {what}: {wall:.3f} s, card busy {busy:.4f} s, host "
          f"{wall - busy:.3f} s, card idle share {1 - busy / wall:.4f}; card "
          f"time by kernel (count, ms), largest first:", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"     {n:5d} {t * 1e3:9.3f}  {name[:90]}", flush=True)


def phase_shuffle(curve, launches: Launches) -> tuple:
    """k = SHUFFLE_K shuffle: card prove, host-route prove, byte-equal;
    verify on the card; two tamper checks. Returns the card prove and
    the verify as functions, for the traces, and (the card prove, its
    bytes, the proof, commitments, generators, label) for phase 16."""
    import torch

    from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                            ShuffleProof, Transcript,
                                            engine, ipp, seeded_rng)
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for
    from ark_bulletproofs_tpu_torch.r1cs import verifier
    from ark_bulletproofs_tpu_torch.utils import profiling

    spec = spec_for(curve)
    msm_kernels = MSM_KERNELS[model(spec)]
    # the per-round route shrinks the IPA table to 16 columns at cur = 16:
    # its last four rounds' MSMs (2 sets of 16 terms) run on v1
    round_kernels = msm_kernels + VECTOR_KERNELS + V1_KERNELS[model(spec)]
    # the FS route's Q table; on curve25519 also the witness commits' 2^i
    # B table (te_double), built by the first prove and kept after it
    prove_kernels = msm_kernels + FS_KERNELS[model(spec)] + VECTOR_KERNELS
    t0 = time.perf_counter()
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 2 * SHUFFLE_K, 1)
    pyrng = random.Random(1024)
    vals = [pyrng.getrandbits(64) for _ in range(SHUFFLE_K)]
    perm = vals[:]
    pyrng.shuffle(perm)
    label = b"chip_smoke shuffle"
    print(f"   {curve.name} generators: {time.perf_counter() - t0:.1f} s",
          flush=True)

    def prove():
        return ShuffleProof.prove(seeded_rng(1024), pc, bp,
                                  Transcript(label), vals, perm)

    profiling.reset()
    full = full_collections()
    t0 = time.perf_counter()
    sp, ic, oc = launches.run(path_name("prove", curve), prove,
                              prove_kernels, spec)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card = sp.proof.to_bytes(curve)
    card_ipa = profiling.total("prove:ipa")
    print(f"   {curve.name} card prove k={SHUFFLE_K}, IPA on the on-device "
          f"Fiat-Shamir route: {card_s:.3f} s ({len(card)} bytes, "
          f"{full_collections() - full} full collections); its phases:",
          flush=True)
    print_phases()
    saved = ipp.IPA_FS
    ipp.IPA_FS = ()  # the per-round route: host Fiat-Shamir every round
    try:
        t0 = time.perf_counter()
        sp_rounds, _, _ = launches.run(path_name("prove per-round", curve),
                                       prove, round_kernels, spec,
                                       V1_DOUBLING[model(spec)])
        torch.cuda.synchronize()
        rounds_s = time.perf_counter() - t0
    finally:
        ipp.IPA_FS = saved
    if sp_rounds.proof.to_bytes(curve) != card:
        raise AssertionError("the FS-route proof differs from the per-round "
                             "route's")
    ipa_ms = {"fs": [card_ipa * 1e3],
              "per-round": [profiling.total("prove:ipa") * 1e3]}
    print(f"   {curve.name} card prove k={SHUFFLE_K}, IPA on the per-round "
          f"route: {rounds_s:.3f} s, byte-equal", flush=True)
    for route in ("per-round", "fs"):  # once more each, in turn
        ipp.IPA_FS = saved if route == "fs" else ()
        try:
            profiling.reset()
            prove()
            torch.cuda.synchronize()
            ipa_ms[route].append(profiling.total("prove:ipa") * 1e3)
        finally:
            ipp.IPA_FS = saved
    print(f"   {curve.name} k={SHUFFLE_K} prove:ipa, two proves a route in "
          f"the order fs, per-round, per-round, fs: FS route "
          f"{ipa_ms['fs'][0]:.1f} and {ipa_ms['fs'][1]:.1f} ms; per-round "
          f"route {ipa_ms['per-round'][0]:.1f} and "
          f"{ipa_ms['per-round'][1]:.1f} ms", flush=True)
    profiling.reset()
    threshold = engine.config.msm_device_threshold
    engine.config.msm_device_threshold = 1 << 62  # nothing reaches the card
    try:
        t0 = time.perf_counter()
        sp_host, _, _ = prove()
        host_s = time.perf_counter() - t0
    finally:
        engine.config.msm_device_threshold = threshold
    if sp_host.proof.to_bytes(curve) != card:
        raise AssertionError("card proof differs from the host-route proof")
    print(f"   {curve.name} host-route prove k={SHUFFLE_K}: {host_s:.3f} s; "
          f"the three proofs are byte-equal", flush=True)

    def verify():
        ShuffleProof(sp.proof).verify(pc, bp, Transcript(label), ic, oc)

    # The first verify inherits the collector's state from the phases
    # before it, the next two start from a gc.collect(): a full collection
    # that falls inside a run costs it a pass over every live object. The
    # g/h scalars are made on the card (padded_n = 2048 >= the gate).
    for run in ("first", "after gc.collect()", "after gc.collect(), again"):
        if run != "first":
            gc.collect()
        profiling.reset()
        full = full_collections()
        t0 = time.perf_counter()
        launches.run(path_name("verify", curve), verify,
                     msm_kernels + ("mont_mul",), spec)
        torch.cuda.synchronize()
        print(f"   {curve.name} verify k={SHUFFLE_K} on the card, g/h "
              f"scalars on the card, {run}: accepted, "
              f"{time.perf_counter() - t0:.3f} s, "
              f"{full_collections() - full} full collections; its phases:",
              flush=True)
        print_phases()
    _, syncs = count_syncs(verify)
    print_syncs(f"{curve.name} one verify with the g/h scalars on the card",
                syncs)
    gate = verifier.DEVICE_SCALARS_MIN_N
    verifier.DEVICE_SCALARS_MIN_N = 1 << 62  # the host assembles g/h
    try:
        gc.collect()
        profiling.reset()
        t0 = time.perf_counter()
        verify()
        torch.cuda.synchronize()
        print(f"   {curve.name} verify k={SHUFFLE_K} on the card, g/h "
              f"scalars assembled on the host, after gc.collect(): "
              f"accepted, {time.perf_counter() - t0:.3f} s; its phases:",
              flush=True)
        print_phases()
    finally:
        verifier.DEVICE_SCALARS_MIN_N = gate
    must_raise("flipped t_x byte", lambda: ShuffleProof(
        tamper_t_x(curve, sp.proof)).verify(pc, bp, Transcript(label), ic,
                                            oc))
    must_raise("swapped commitments", lambda: ShuffleProof(sp.proof).verify(
        pc, bp, Transcript(label), oc, ic))
    return prove, verify, (prove, card, sp.proof, ic, oc, pc, bp, label)


def phase_batch(curve, launches: Launches) -> tuple:
    """The 1024 cached k = 8 proofs batch-verified on the card, a batch with
    one tampered rejected. Returns (the decoded proofs and commitments,
    pc, bp) for phase 16."""
    from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                            R1CSProof, ShuffleProof,
                                            Transcript, batch_verify,
                                            seeded_rng)
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    with open(BATCH_CACHE, "rb") as fh:
        blobs = pickle.load(fh)  # tracked in the repo: (bytes, [bytes], [bytes])
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 16, 1)
    decoded = [
        (R1CSProof.from_bytes(curve, pb),
         [curve.deserialize_compressed(b) for b in icb],
         [curve.deserialize_compressed(b) for b in ocb])
        for pb, icb, ocb in blobs
    ]

    def instances(items):
        return [
            (ShuffleProof(p).build_verifier(pc, Transcript(b"bench batch"),
                                            ic, oc), p)
            for p, ic, oc in items
        ]

    inst = instances(decoded)
    t0 = time.perf_counter()
    launches.run("batch_verify",
                 lambda: batch_verify(seeded_rng(1000), inst, pc, bp),
                 MSM_KERNELS["sw"], spec_for(curve))
    dt = time.perf_counter() - t0
    print(f"   batch_verify of {len(decoded)} k=8 proofs: accepted, "
          f"{dt:.3f} s, {len(decoded) / dt:.1f} proofs/s", flush=True)
    bad = list(decoded)
    p, ic, oc = bad[517]
    bad[517] = (tamper_t_x(curve, p), ic, oc)
    must_raise("batch with one tampered proof", lambda: batch_verify(
        seeded_rng(1001), instances(bad), pc, bp))
    return decoded, pc, bp


def count_syncs(fn):
    """(fn(), the device-to-host synchronisations that PyTorch reports
    during it: torch.cuda.set_sync_debug_mode warns on each .item(),
    .cpu(), nonzero and blocking copy)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = (f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}")
            sites[where] = sites.get(where, 0) + 1
    return out, sites


def print_syncs(what: str, sites: dict) -> None:
    top = sorted(sites.items(), key=lambda kv: -kv[1])
    print(f"   {what}: {sum(sites.values())} device-to-host syncs; by call "
          f"site: {', '.join(f'{k} x{v}' for k, v in top)}", flush=True)


def random_scalars(curve, count: int, seed: int) -> list[int]:
    import numpy as np

    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(count, 16), dtype=np.uint16).tobytes()
    r = curve.fr.p
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % r
            for i in range(count)]


def phase_ipa_routes(curve, n: int, launches: Launches,
                     verify: bool = False, farm: bool = False) -> tuple:
    """One n-term IPA through `InnerProductProof.create` on the on-device
    Fiat-Shamir route and on the per-round route, each run twice (the
    second counted as the path), byte-equal proofs and transcripts; the
    device-to-host syncs of one more run of each. G and H: with `farm`,
    BulletproofGens(curve, n)'s share 0, made by the generator farm (a
    path of its own); else chain points, 8192 repeated where n is larger
    (any bases serve; the routes must agree). With `verify`,
    the proof is then verified on the device route (`ipa_gh_msm`) and on
    the host-scalar route, and a proof with a changed a is rejected.
    Returns ((proof bytes, transcript end), inputs, P or None)."""
    import torch

    from ark_bulletproofs_tpu_torch import (BulletproofGens,
                                            InnerProductProof, PedersenGens,
                                            Transcript, engine, ipp)
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops import ipa
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    spec = spec_for(curve)
    t0 = time.perf_counter()
    if farm:
        share = launches.run(path_name(f"gens BulletproofGens {n}", curve),
                             lambda: BulletproofGens(curve, n).share(0),
                             ("gen_candidates",), spec)
        G, H = share.G(n), share.H(n)
    else:
        m = min(n, N_DISTINCT)
        G = GeneratorsChain(curve, b"chip_smoke ipa G").take(m) * (n // m)
        H = GeneratorsChain(curve, b"chip_smoke ipa H").take(m) * (n // m)
    gf, hf, a, b = (random_scalars(curve, n, 300 + i) for i in range(4))
    Q = curve.mul(PedersenGens.default(curve).B, 0x5EED)
    print(f"   inputs: {time.perf_counter() - t0:.1f} s", flush=True)
    # past FS_SEG_MIN the FS route shrinks its table on the card, with one
    # batch inverse a shrink
    shrink = ("mont_inv_batch",) if n > ipa.FS_SEG_MIN else ()
    kernels = {"fs": MSM_KERNELS[model(spec)] + FS_KERNELS[model(spec)]
               + shrink,
               "per-round": MSM_KERNELS[model(spec)] + ("mont_mul",
                                                        "sum_mod")}
    saved = ipp.IPA_FS
    out = {}
    try:
        for route in ("fs", "per-round"):
            on_card = (engine.torch_device().type,)
            ipp.IPA_FS = on_card if route == "fs" else ()

            def create():
                t = Transcript(b"chip_smoke ipa")
                proof = InnerProductProof.create(t, curve, Q, gf, hf, G, H,
                                                 a, b)
                torch.cuda.synchronize()
                return proof.to_bytes(curve), t.challenge_bytes(b"end", 32)

            times = []
            for rep in range(2):
                t0 = time.perf_counter()
                out[route] = (create() if rep == 0 else launches.run(
                    path_name(f"ipa n={n} {route}", curve), create,
                    kernels[route], spec))
                times.append(time.perf_counter() - t0)
            _, syncs = count_syncs(create)
            print(f"   {curve.name} ipa n={n} {route} route: "
                  f"{times[0]:.3f} s, then {times[1]:.3f} s", flush=True)
            print_syncs(f"one {route} proof", syncs)
        if n > ipa.FS_SEG_MIN and ipa.FS_SEG != 4:
            # the JAX package's plan: shrink by 2^4, 16-term sets
            seg = ipa.FS_SEG
            ipp.IPA_FS, ipa.FS_SEG = (engine.torch_device().type,), 4
            try:
                t0 = time.perf_counter()
                if create() != out["fs"]:
                    raise AssertionError("FS_SEG = 4 gives other bytes")
                print(f"   {curve.name} ipa n={n} fs route with the JAX "
                      f"package's segment plan (FS_SEG = 4): "
                      f"{time.perf_counter() - t0:.3f} s, byte-equal",
                      flush=True)
            finally:
                ipa.FS_SEG = seg
    finally:
        ipp.IPA_FS = saved
    if out["fs"] != out["per-round"]:
        raise AssertionError(f"{curve.name} n={n}: the FS route's proof or "
                             f"transcript differs from the per-round route's")
    print(f"   {curve.name} ipa n={n}: the two routes' proofs and "
          f"transcripts are byte-equal", flush=True)
    inputs = (gf, hf, a, b, G, H, Q)
    P = verify_ipa(curve, n, launches, out["fs"][0], inputs) if verify \
        else None
    return out["fs"], inputs, P


def verify_ipa(curve, n: int, launches: Launches, blob: bytes, inputs):
    """Verify the IPA proof `blob` against P = <a Gf, G> + <b Hf, H> +
    <a, b> Q (an MSM on the card): the device route (the g/h scalars and
    their 2n-term MSM on the card, `ops/verify.py::ipa_gh_msm`), timed
    twice (the first uploads the table), and the host-scalar route; a
    proof with a changed a rejected. Returns P."""
    import torch

    import ark_bulletproofs_tpu_torch as port
    from ark_bulletproofs_tpu_torch import (InnerProductProof, Transcript,
                                            engine, ipp)
    from ark_bulletproofs_tpu_torch.ops import cache as dcache
    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops import verify as dverify
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    gf, hf, a, b, G, H, Q = inputs
    p = curve.fr.p
    t0 = time.perf_counter()
    P = port.msm(curve, G + H + [Q], [x * f % p for x, f in zip(a, gf)]
                 + [x * f % p for x, f in zip(b, hf)]
                 + [sum(x * y for x, y in zip(a, b)) % p])
    print(f"   P for the verify (a {2 * n + 1}-term MSM on the card with "
          f"its marshal): {time.perf_counter() - t0:.3f} s", flush=True)
    proof = InnerProductProof.from_bytes(curve, blob)[0]
    spec = spec_for(curve)

    def check(pr):
        pr.verify(n, Transcript(b"chip_smoke ipa"), curve, gf, hf, P, Q, G,
                  H)
        torch.cuda.synchronize()

    times = []
    for rep in range(2):
        t0 = time.perf_counter()
        launches.run(path_name(f"ipa n={n} verify", curve),
                     lambda: check(proof),
                     MSM_KERNELS[model(spec)] + ("mont_mul",), spec)
        times.append(time.perf_counter() - t0)
    gate = ipp.VERIFY_DEVICE_MIN_N
    ipp.VERIFY_DEVICE_MIN_N = 1 << 62  # the host assembles every scalar
    try:
        t0 = time.perf_counter()
        check(proof)
        host_s = time.perf_counter() - t0
    finally:
        ipp.VERIFY_DEVICE_MIN_N = gate
    print(f"   {curve.name} ipa n={n} verify: accepted; g/h scalars and "
          f"their MSM on the card {times[0]:.3f} s, then {times[1]:.3f} s; "
          f"host-scalar route {host_s:.3f} s", flush=True)
    fr = df.spec_for(curve.fr)
    dev = engine.torch_device()
    t0 = time.perf_counter()
    dcache.ipa_table(curve, G, H, dev)
    for fv in (gf, hf):
        dverify._cached_mont_vector(fr, fv, p, curve.fr.R, dev)
    print(f"   of which the content-keyed cache hits of one verify (the "
          f"[G | H] table and the two factor vectors, n = {n}): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    bad = InnerProductProof(proof.L_vec, proof.R_vec, (proof.a + 1) % p,
                            proof.b)
    must_raise(f"ipa n={n} proof with a changed a", lambda: check(bad))
    return P


def phase_ipa_v1(curve, n: int, launches: Launches) -> None:
    """An n-term IPA on the per-round card route with every MSM on the
    card (threshold 0): below 128 terms each round's two-set MSM is the v1
    Pippenger's. Byte-equal to the host route's proof."""
    import torch

    from ark_bulletproofs_tpu_torch import (InnerProductProof, PedersenGens,
                                            Transcript, engine, ipp)
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    spec = spec_for(curve)
    G = GeneratorsChain(curve, b"chip_smoke ipa G").take(n)
    H = GeneratorsChain(curve, b"chip_smoke ipa H").take(n)
    gf, hf, a, b = (random_scalars(curve, n, 500 + i) for i in range(4))
    Q = curve.mul(PedersenGens.default(curve).B, 0x5EED)

    def create():
        t = Transcript(b"chip_smoke ipa v1")
        proof = InnerProductProof.create(t, curve, Q, gf, hf, G, H, a, b)
        torch.cuda.synchronize()
        return proof.to_bytes(curve), t.challenge_bytes(b"end", 32)

    saved = (ipp.IPA_FS, engine.config.msm_device_threshold)
    try:
        engine.config.msm_device_threshold = 1 << 62
        want = create()
        ipp.IPA_FS, engine.config.msm_device_threshold = (), 0
        t0 = time.perf_counter()
        got = launches.run(path_name(f"ipa n={n} per-round", curve), create,
                           V1_KERNELS[model(spec)] + ("mont_mul",), spec,
                           V1_DOUBLING[model(spec)])
        dt = time.perf_counter() - t0
    finally:
        ipp.IPA_FS, engine.config.msm_device_threshold = saved
    if got != want:
        raise AssertionError(f"{curve.name} ipa n={n}: the per-round card "
                             f"route differs from the host route")
    print(f"   {curve.name} ipa n={n} per-round route, rounds on v1: "
          f"{dt:.3f} s, byte-equal to the host route", flush=True)


BATCH_P, BATCH_N = 128, 64


def phase_create_batch(curve, launches: Launches) -> None:
    """create_batch of BATCH_P proofs at n = BATCH_N with Q_b = w_b B on
    both routes, each proof byte-equal to a serial `create` on the host
    route; proofs/s of each route's second run. The transcripts' labels
    have one length, so that they stay in lockstep (the FS batch route
    needs one position for all)."""
    import torch

    from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                            PedersenGens, Transcript, engine,
                                            ipp)
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    spec = spec_for(curve)
    P, n = BATCH_P, BATCH_N
    gens = BulletproofGens(curve, n, 1).share(0)
    G, H = gens.G(n), gens.H(n)
    B = PedersenGens.default(curve).B
    ws = random_scalars(curve, P, 400)
    gfs, hfs, As, Bs = ([random_scalars(curve, n, 1000 * i + j)
                         for j in range(P)] for i in range(1, 5))
    threshold = engine.config.msm_device_threshold
    engine.config.msm_device_threshold = 1 << 62  # the serial host oracle
    try:
        t0 = time.perf_counter()
        want = [InnerProductProof.create(
            Transcript(b"chip_smoke batch %03d" % j), curve,
            curve.mul(B, ws[j]), gfs[j], hfs[j], G, H, As[j],
            Bs[j]).to_bytes(curve)
            for j in range(P)]
        print(f"   {P} serial host-route creates: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        engine.config.msm_device_threshold = 64  # the batch on the card
        saved = ipp.IPA_FS
        # per-round: each round is one 2P = 256-set MSM of 64 terms (a
        # base_map batch below 128 terms: the v1 Pippenger); the FS batch
        # route keeps the JAX package's v2 from 16 terms
        kernels = {"fs": MSM_KERNELS["sw"] + ("mont_mul", "jac_double_k_add",
                                              "fs_round"),
                   "per-round": ("mont_mul",) + V1_KERNELS["sw"]}
        doubling = {"fs": (), "per-round": V1_DOUBLING["sw"]}
        for route in ("fs", "per-round"):
            on_card = (engine.torch_device().type,)
            ipp.IPA_FS = on_card if route == "fs" else ()

            def batch():
                ts = [Transcript(b"chip_smoke batch %03d" % j)
                      for j in range(P)]
                proofs = InnerProductProof.create_batch(
                    ts, curve, B, ws, gfs, hfs, G, H, As, Bs)
                torch.cuda.synchronize()
                return [p.to_bytes(curve) for p in proofs]

            times = []
            for rep in range(2):
                t0 = time.perf_counter()
                got = (batch() if rep == 0 else launches.run(
                    f"create_batch {route}", batch, kernels[route], spec,
                    doubling[route]))
                times.append(time.perf_counter() - t0)
                if got != want:
                    bad = [j for j in range(P) if got[j] != want[j]]
                    raise AssertionError(f"create_batch {route}: proofs {bad}"
                                         f" differ from serial create")
            print(f"   create_batch n={n} P={P} {route} route: "
                  f"{times[0]:.3f} s, then {times[1]:.3f} s "
                  f"({P / times[1]:.1f} proofs/s); all {P} equal serial "
                  f"create", flush=True)
    finally:
        engine.config.msm_device_threshold = threshold
        ipp.IPA_FS = saved


PROVE_BATCH_K = 32
PROVE_BATCH_SAMPLE = 16


def phase_prove_batch(curve, launches: Launches) -> None:
    """prove_batch of BATCH_P k = 32 shuffles (2k - 2 = 62 multipliers,
    padded n = 64), every phase MSM on the card (threshold 0, as the JAX
    package's batch bench runs all of them on its device: below the
    threshold the 3P one-base phase-1 MSMs of a shuffle would be host
    scalar multiplications) and the IPA through create_batch's FS route;
    a sample of the proofs byte-equal to ShuffleProof.prove on the host
    route under the same seeded RNG; all accepted by batch_verify; one
    tampered proof rejected."""
    import torch

    from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                            Prover, ShuffleProof, Transcript,
                                            batch_verify, engine, prove_batch,
                                            seeded_rng)
    from ark_bulletproofs_tpu_torch.gadgets import shuffle_gadget
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for
    from ark_bulletproofs_tpu_torch.utils import profiling

    spec = spec_for(curve)
    P, k = BATCH_P, PROVE_BATCH_K
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 2 * k, 1)
    label = b"chip_smoke prove_batch"

    def witness(j: int):
        r = random.Random(5000 + j)
        vals = [r.getrandbits(64) for _ in range(k)]
        perm = vals[:]
        r.shuffle(perm)
        return vals, perm

    def shuffle_prover(j: int):
        """ShuffleProof.prove's steps up to Prover.prove."""
        vals, perm = witness(j)
        prng = seeded_rng(5000 + j)
        t = Transcript(label)
        t.append_message(b"dom-sep", b"ShuffleProof")
        t.append_u64(b"k", k)
        prover = Prover(pc, t)
        ins = prover.commit_many(vals, curve.fr.rand_many(prng, k))
        outs = prover.commit_many(perm, curve.fr.rand_many(prng, k))
        shuffle_gadget(prover, curve, [v for _, v in ins],
                       [v for _, v in outs])
        return prover, prng, [c for c, _ in ins], [c for c, _ in outs]

    threshold = engine.config.msm_device_threshold
    try:
        t0 = time.perf_counter()
        built = [shuffle_prover(j) for j in range(P)]
        print(f"   {P} constraint systems built: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        engine.config.msm_device_threshold = 0
        profiling.reset()
        t0 = time.perf_counter()
        # the phase MSMs (3P sets of 1 and of 125 terms) run on v1
        proofs = launches.run("prove_batch", lambda: prove_batch(
            [b[0] for b in built], [b[1] for b in built], bp),
            MSM_KERNELS["sw"] + ("mont_mul", "jac_double_k_add", "fs_round",
                                 "jac_madd", "jac_horner_windows"), spec,
            V1_DOUBLING["sw"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"   prove_batch P={P} k={k}: {dt:.3f} s, {P / dt:.1f} "
              f"proofs/s; its phases:", flush=True)
        print_phases()
        engine.config.msm_device_threshold = 1 << 62  # the host oracle
        for j in range(0, P, P // PROVE_BATCH_SAMPLE):
            sp, _, _ = ShuffleProof.prove(seeded_rng(5000 + j), pc, bp,
                                          Transcript(label), *witness(j))
            if sp.proof.to_bytes(curve) != proofs[j].to_bytes(curve):
                raise AssertionError(f"prove_batch proof {j} differs from "
                                     f"ShuffleProof.prove")
        print(f"   a sample of {PROVE_BATCH_SAMPLE} (every "
              f"{P // PROVE_BATCH_SAMPLE}th) equals ShuffleProof.prove on "
              f"the host route", flush=True)
        engine.config.msm_device_threshold = threshold

        def instances(items):
            return [(ShuffleProof(p).build_verifier(pc, Transcript(label),
                                                    ic, oc), p)
                    for p, ic, oc in items]

        items = [(p, b[2], b[3]) for p, b in zip(proofs, built)]
        t0 = time.perf_counter()
        batch_verify(seeded_rng(6000), instances(items), pc, bp)
        print(f"   batch_verify of the {P} proofs: accepted, "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        bad = min(5, P - 1)
        items[bad] = (tamper_t_x(curve, items[bad][0]), *items[bad][1:])
        must_raise("prove_batch batch with one tampered proof",
                   lambda: batch_verify(seeded_rng(6001), instances(items),
                                        pc, bp))
    finally:
        engine.config.msm_device_threshold = threshold


V1_SHAPES = [("one set", 1, 256, False), ("one set", 1, 512, False),
             ("base_map", 2, 16, True), ("base_map", 2, 32, True),
             ("base_map", 2, 64, True), ("base_map", 256, 64, True)]


def phase_v1(curve, launches: Launches) -> None:
    """n = 512 through `msm` (one scalar set: the router's v1) equal to the
    native host Pippenger; then the v1 Pippenger against the v2 MSM (padded
    to its 256-term minimum where narrower) at the shapes the router gives
    v1, on random scalars over 2n chain points (base_map rows drawn from
    them): equal sums, each engine's median of 3 timed runs after one
    warm-up (host clock around synchronised runs)."""
    import torch

    import ark_bulletproofs_tpu_torch as port
    from ark_bulletproofs_tpu_torch import engine, native
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops import proj
    from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                      point_batch_to_host,
                                                      spec_for)
    from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
    from ark_bulletproofs_tpu_torch.parallel import msm as pm

    spec = spec_for(curve)
    pts = GeneratorsChain(curve, b"chip_smoke v1").take(1024)
    ks = random_scalars(curve, 512, 700)
    want = curve.to_affine(native.cpu_pippenger_native(pts[:512], ks,
                                                       curve=curve))
    got = launches.run("msm n=512", lambda: port.msm(curve, pts[:512], ks),
                       V1_KERNELS["sw"], spec, V1_DOUBLING["sw"])
    if got != want:
        raise AssertionError("n=512 msm differs from the native Pippenger")
    print("   msm n=512 (v1) == native host Pippenger", flush=True)
    dev = engine.torch_device()
    X, Y, inf = affine_to_device(curve, pts, dev)
    for kind, B, n, mapped in V1_SHAPES:
        scal = scalars_to_device(curve, [random_scalars(curve, n, 710 + b)
                                         for b in range(B)], dev)
        g = torch.Generator(device=dev).manual_seed(n + B)
        bm = (torch.randint(0, 1024, (B, n), generator=g, device=dev)
              if mapped else None)
        Xs, Ys, Is = (X, Y, inf) if mapped else (X[:, :n], Y[:, :n],
                                                 inf[:n])
        runs = {
            "v1": lambda: proj.from_jacobian(
                spec, pm.msm_v1(spec, Xs, Ys, Is, scal, bm)).to(torch.int32),
            "v2": lambda: pm.msm_v2(spec, Xs, Ys, Is, scal, bm),
        }
        out, ms, count = {}, {}, {}
        madd = launches.wrappers["jac_madd"]
        for eng in ("v1", "v2", "v2", "v1"):
            before = sum(w.launches for w in launches.wrappers.values())
            madd0 = madd.launches
            out[eng] = runs[eng]()
            count[eng] = (sum(w.launches for w in launches.wrappers.values())
                          - before)
            if eng == "v1":
                count["scan"] = madd.launches - madd0
            ms.setdefault(eng, []).extend(
                host_ms(runs[eng]) for _ in range(3))
        if (point_batch_to_host(curve, out["v1"])
                != point_batch_to_host(curve, out["v2"])):
            raise AssertionError(f"v1 and v2 differ: {kind} B={B} n={n}")
        print(f"   {kind} B={B} n={n}: v1 {statistics.median(ms['v1']):.3f}"
              f" ms, v2 {statistics.median(ms['v2']):.3f} ms (medians of "
              f"6), equal sums; kernel launches a call: v1 {count['v1']} "
              f"({count['scan']} of them jac_madd: its row scans), v2 "
              f"{count['v2']}; router: "
              f"{'v2' if pm.uses_v2(n, B > 1 or mapped, mapped) else 'v1'}",
              flush=True)


BV_P, BV_K = 64, 128


def phase_batch_verify_dev(curve, launches: Launches) -> None:
    """BV_P k = BV_K shuffles (padded_n = 256) proved with prove_batch on
    the card, then batch_verify with the g/h scalars made, alpha-scaled
    and summed on the card (one batched pass for the size group), timed,
    and with the host assembly; one tampered proof rejected."""
    import torch

    from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                            Prover, ShuffleProof, Transcript,
                                            batch_verify, prove_batch,
                                            seeded_rng)
    from ark_bulletproofs_tpu_torch.gadgets import shuffle_gadget
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for
    from ark_bulletproofs_tpu_torch.r1cs import verifier
    from ark_bulletproofs_tpu_torch.utils import profiling

    spec = spec_for(curve)
    P, k = BV_P, BV_K
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 2 * k, 1)
    label = b"chip_smoke batch_verify"
    t0 = time.perf_counter()
    built = []
    for j in range(P):
        r = random.Random(8000 + j)
        vals = [r.getrandbits(64) for _ in range(k)]
        perm = vals[:]
        r.shuffle(perm)
        prng = seeded_rng(8000 + j)
        t = Transcript(label)
        t.append_message(b"dom-sep", b"ShuffleProof")
        t.append_u64(b"k", k)
        prover = Prover(pc, t)
        ins = prover.commit_many(vals, curve.fr.rand_many(prng, k))
        outs = prover.commit_many(perm, curve.fr.rand_many(prng, k))
        shuffle_gadget(prover, curve, [v for _, v in ins],
                       [v for _, v in outs])
        built.append((prover, prng, [c for c, _ in ins],
                      [c for c, _ in outs]))
    proofs = prove_batch([b[0] for b in built], [b[1] for b in built], bp)
    torch.cuda.synchronize()
    print(f"   {P} k={k} shuffles proved with prove_batch: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def instances(items):
        return [(ShuffleProof(p).build_verifier(pc, Transcript(label), ic,
                                                oc), p)
                for p, ic, oc in items]

    items = [(p, b[2], b[3]) for p, b in zip(proofs, built)]
    times = []
    for rep in range(2):
        inst = instances(items)
        gc.collect()
        profiling.reset()
        t0 = time.perf_counter()
        launches.run(f"batch_verify k={k}", lambda: batch_verify(
            seeded_rng(9000), inst, pc, bp), MSM_KERNELS["sw"] +
            ("mont_mul",), spec)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"   batch_verify of {P} k={k} proofs, g/h scalars on the card: "
          f"accepted, {times[0]:.3f} s, then {times[1]:.3f} s "
          f"({P / times[1]:.1f} proofs/s); its phases:", flush=True)
    print_phases()
    gate = verifier.DEVICE_SCALARS_MIN_N
    verifier.DEVICE_SCALARS_MIN_N = 1 << 62  # the host assembles g/h
    try:
        inst = instances(items)
        gc.collect()
        profiling.reset()
        t0 = time.perf_counter()
        batch_verify(seeded_rng(9000), inst, pc, bp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        verifier.DEVICE_SCALARS_MIN_N = gate
    print(f"   batch_verify of the same {P}, g/h scalars assembled on the "
          f"host: accepted, {dt:.3f} s ({P / dt:.1f} proofs/s); its phases:",
          flush=True)
    print_phases()
    bad = list(items)
    bad[P // 2] = (tamper_t_x(curve, bad[P // 2][0]), *bad[P // 2][1:])
    must_raise(f"batch_verify k={k} with one tampered proof",
               lambda: batch_verify(seeded_rng(9001), instances(bad), pc,
                                    bp))


MESH_D = 4  # phase 16's shards, all on cuda:0
MESH_RANKS_N = 1 << 16  # the two-rank MSM's terms


def event_ms(fn, reps: int = 5) -> list[float]:
    """Milliseconds of `reps` calls of fn, each between two CUDA events
    (after one warm-up call)."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def run_ranks(n: int, world: int = 2) -> list[str]:
    """`world` processes of the port's dry-run worker (parallel/dryrun.py)
    on cuda:0, joined over gloo on localhost: each sums its own block of
    n generators and checks the sum against the host Pippenger. Returns
    each rank's MULTIHOST_OK line; raises if a rank fails. Every process
    is waited for and killed at the end."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ark_bulletproofs_tpu_torch.parallel.dryrun",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--n", str(n), "--device", "cuda", "--timeout", "180"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    lines = []
    try:
        for r, pr in enumerate(procs):
            out, err = pr.communicate(timeout=400)
            ok = [ln for ln in out.splitlines()
                  if ln.startswith(f"MULTIHOST_OK rank={r} world={world}")]
            if pr.returncode != 0 or not ok:
                raise AssertionError(f"rank {r} rc={pr.returncode}\n"
                                     f"{out[-2000:]}\n{err[-3000:]}")
            lines.append(ok[0])
    finally:
        for pr in procs:
            pr.kill()
            pr.wait()
    return lines


def phase_mesh(curve, launches: Launches, msm_in, msm_te_in, shuffle_in,
               batch_in, ipa_in) -> None:
    """Phase 16: the mesh paths under engine.set_mesh(make_mesh(devices=
    ["cuda:0"] * MESH_D)), on the inputs of phases 3, 4, 5, 6 and 8 (not
    drawn again): the sharded n = 2^20 MSM equal to phase 3's host
    reference, timed by CUDA events beside the same MSM without the mesh,
    with the device-to-host syncs of one call of each (the sharded one
    may not sync more); phase 6's curve25519 MSM sharded (v2 shards, as
    on secq256k1), equal to its host reference and timed the same way;
    the k = 1024 prove byte-equal to phase 4's proof,
    verify and batch_verify of phase 5's 1024 proofs accepting, each with
    a tampered input rejected; the n = 2^16 IPA byte-equal to phase 8's
    proof (same transcript end) and verified; the sharded g/h scalars
    equal to the unsharded ones; then two gloo ranks on cuda:0 summing
    MESH_RANKS_N generators, each against the host Pippenger, and equal.
    Shards on one card: no figure here is a multi-card one."""
    import torch

    from ark_bulletproofs_tpu_torch import (InnerProductProof, ShuffleProof,
                                            Transcript, batch_verify,
                                            curves, engine, seeded_rng)
    from ark_bulletproofs_tpu_torch.ops import verify as dverify
    from ark_bulletproofs_tpu_torch.ops.curve import (point_batch_to_host,
                                                      spec_for)
    from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
    from ark_bulletproofs_tpu_torch.parallel.mesh import (Pieces, gather,
                                                          make_mesh)
    from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_ragged

    spec = spec_for(curve)
    (X, Y, inf, scal), want, alone_ms = msm_in
    prove, card, proof, ic, oc, pc, bp, label = shuffle_in
    decoded, bpc, bbp = batch_in
    (ipa_blob, ipa_end), (gf, hf, ipa_a, ipa_b, G, H, Q), P = ipa_in
    mesh = make_mesh(devices=["cuda:0"] * MESH_D)

    def msm():
        return msm_device_ragged(spec, X, Y, inf, scal)

    def sharded_against_one_device(name, fn, host_ms):
        """CUDA-event medians of fn with and without the mesh, in turns."""
        times = {"sharded": [], "one device": []}
        for rep in ("sharded", "one device", "one device", "sharded"):
            engine.set_mesh(mesh if rep == "sharded" else None)
            times[rep] += event_ms(fn, 3)
        engine.set_mesh(mesh)
        med = {k: statistics.median(v) for k, v in times.items()}
        runs = {k: [round(t, 3) for t in v] for k, v in times.items()}
        print(f"   {name} n=2^20 MSM == host Pippenger over {MESH_D} shards "
              f"on one card; CUDA events, median of 6 (two turns of 3, in "
              f"the order sharded, one device, one device, sharded): "
              f"sharded {med['sharded']:.3f} ms {runs['sharded']}, one "
              f"device {med['one device']:.3f} ms {runs['one device']} "
              f"(its phase, host clock: {host_ms:.1f} ms); ratio "
              f"{med['sharded'] / med['one device']:.3f}", flush=True)

    _, syncs_alone = count_syncs(msm)
    engine.set_mesh(mesh)
    try:
        got = launches.run("mesh msm secq256k1", msm, MSM_KERNELS["sw"],
                           spec)
        if point_batch_to_host(curve, got)[0] != want:
            raise AssertionError("the sharded n=2^20 MSM differs from the "
                                 "host Pippenger")
        _, syncs = count_syncs(msm)
        sharded_against_one_device(curve.name, msm, alone_ms)
        te = curves.curve25519
        spec_te = spec_for(te)
        (Xt, Yt, It, St), want_te, te_ms = msm_te_in

        def msm_te():
            return msm_device_ragged(spec_te, Xt, Yt, It, St)

        got = launches.run("mesh msm curve25519", msm_te, MSM_KERNELS["te"],
                           spec_te)
        if point_batch_to_host(te, got)[0] != want_te:
            raise AssertionError("the sharded curve25519 n=2^20 MSM differs "
                                 "from the host Pippenger")
        sharded_against_one_device(te.name, msm_te, te_ms)

        shard = pmesh.width(X) // MESH_D
        split, _, g = msm_stage_split(spec, *(
            pmesh.take(t, X.device, 0, shard) for t in (X, Y, inf, scal)))
        print(f"   stage split of one shard, n = {shard} (CUDA events, median "
              f"of 3; plan C = {g.C}, R = {g.R}, W = {g.W}, L = {g.L} "
              f"lanes): " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in split.items())
              + f"; sum {sum(split.values()):.3f} ms", flush=True)
        print_syncs("one sharded n=2^20 MSM", syncs)
        print_syncs("the same MSM on one device", syncs_alone)
        if sum(syncs.values()) > sum(syncs_alone.values()):
            raise AssertionError("the sharded MSM syncs more than one "
                                 "unsharded MSM")

        t0 = time.perf_counter()
        sp, _, _ = launches.run("mesh prove secq256k1", prove,
                                MSM_KERNELS["sw"] + VECTOR_KERNELS, spec)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        if sp.proof.to_bytes(curve) != card:
            raise AssertionError("the mesh prove differs from phase 4's proof")

        def verify(pr, i, o):
            ShuffleProof(pr).verify(pc, bp, Transcript(label), i, o)
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        launches.run("mesh verify secq256k1", lambda: verify(proof, ic, oc),
                     MSM_KERNELS["sw"] + ("mont_mul",), spec)
        verify_s = time.perf_counter() - t0
        must_raise("mesh verify of a flipped t_x byte",
                   lambda: verify(tamper_t_x(curve, proof), ic, oc))
        must_raise("mesh verify of swapped commitments",
                   lambda: verify(proof, oc, ic))

        def instances(items):
            return [(ShuffleProof(p).build_verifier(
                bpc, Transcript(b"bench batch"), i, o), p)
                for p, i, o in items]

        inst = instances(decoded)
        t0 = time.perf_counter()
        launches.run("mesh batch_verify", lambda: batch_verify(
            seeded_rng(1000), inst, bpc, bbp), MSM_KERNELS["sw"], spec)
        batch_s = time.perf_counter() - t0
        bad = list(decoded)
        p0, i0, o0 = bad[211]
        bad[211] = (tamper_t_x(curve, p0), i0, o0)
        must_raise("mesh batch with one tampered proof", lambda: batch_verify(
            seeded_rng(1001), instances(bad), bpc, bbp))

        def create():
            t = Transcript(b"chip_smoke ipa")
            pr = InnerProductProof.create(t, curve, Q, gf, hf, G, H, ipa_a,
                                          ipa_b)
            torch.cuda.synchronize()
            return pr.to_bytes(curve), t.challenge_bytes(b"end", 32)

        t0 = time.perf_counter()
        ipa = launches.run("mesh ipa n=2^16 secq256k1", create,
                           MSM_KERNELS["sw"] + ("mont_mul", "sum_mod",
                                                "add_sub"), spec)
        ipa_s = time.perf_counter() - t0
        if ipa != (ipa_blob, ipa_end):
            raise AssertionError("the mesh IPA differs from phase 8's proof "
                                 "or transcript")
        n = len(G)
        t0 = time.perf_counter()
        InnerProductProof.from_bytes(curve, ipa_blob)[0].verify(
            n, Transcript(b"chip_smoke ipa"), curve, gf, hf, P, Q, G, H)
        ipa_verify_s = time.perf_counter() - t0

        padded_n = 1 << 12
        p = curve.fr.p
        wv = [(i * 13 + 5) % p for i in range(padded_n)]
        args = (curve, padded_n, wv, wv[::-1], wv, 3, 5, 7, 11, 13,
                [17 + i for i in range(12)], 19, 10)
        g, h, d = dverify.gh_scalars(*args)
        engine.set_mesh(None)
        g0, h0, d0 = dverify.gh_scalars(*args)
        if not (isinstance(g, Pieces) and len(g.parts) == MESH_D
                and torch.equal(gather(g, g0.device), g0)
                and torch.equal(gather(h, h0.device), h0) and d == d0):
            raise AssertionError("the sharded g/h scalars differ")
    finally:
        engine.set_mesh(None)
    mesh_paths = [c for path, (c, _, _, _) in launches.paths.items()
                  if path.startswith("mesh ")]
    print("   launches over the mesh paths: "
          + str({name: sum(c[name] for c in mesh_paths)
                 for name in launches.wrappers}), flush=True)
    print(f"   mesh k={SHUFFLE_K} prove: {prove_s:.3f} s, byte-equal to "
          f"phase 4's proof; verify {verify_s:.3f} s; batch_verify of "
          f"{len(decoded)} k=8 proofs {batch_s:.3f} s "
          f"({len(decoded) / batch_s:.1f} proofs/s); ipa n={n} {ipa_s:.3f} s,"
          f" byte-equal to phase 8's, verify (host scalars) "
          f"{ipa_verify_s:.3f} s; g/h scalars at padded_n = {padded_n} "
          f"sharded equal", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = run_ranks(MESH_RANKS_N)
    points = {ln.split("point=")[1] for ln in lines}
    if len(points) != 1:
        raise AssertionError(f"the ranks disagree: {lines}")
    print(f"   two gloo ranks on cuda:0, n = {MESH_RANKS_N}: each equal to "
          f"the host Pippenger, the same point ({points.pop()[:18]}...); "
          f"{time.perf_counter() - t0:.3f} s with the processes' start",
          flush=True)


def ptxas_report(log: str) -> list[str]:
    """One line per kernel instantiation of nvcc's `-Xptxas -v` report:
    kernel, point model, thread group size G, registers, stack frame,
    spill stores and loads (bytes); and one for each function the kernels
    call (not inlined) with its stack frame and spills."""
    import re

    models = {"TeModel": "te", "RcbModelILb1E": "rcb a=0",
              "RcbModelILb0E": "rcb a", "JacModelILb1E": "jac a=0",
              "JacModelILb0E": "jac a", "kernelIlE": "int64 indices",
              "kernelIiE": "int32 indices"}

    def short(mangled: str) -> str:
        m = re.match(r"_Z(\d+)", mangled)
        if not m:
            return mangled
        return mangled[len(m.group(0)):len(m.group(0)) + int(m.group(1))]

    out, entry, label, props, frame = [], None, None, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, frame = m.group(1), ""
            kind = next((v for k, v in models.items() if k in entry), "")
            grp = re.search(r"Li(n?\d+)EEv", entry)
            if grp and "mont_mul" in entry:  # the template is its OP
                kind += {"0": " a*b", "1": " a*b+c",
                         "n1": " a*b-c"}[grp.group(1)]
            elif grp:
                kind += f" G={grp.group(1)}"
            dbl = re.search(r"Lb([01])EEv", entry)
            if dbl and "wide" in entry:
                kind += " k>0" if dbl.group(1) == "1" else " k=0"
            label = f"{short(entry)} {kind}".strip()
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            text = (f"stack frame {m.group(1)} B, spill stores {m.group(2)} "
                    f"B, loads {m.group(3)} B")
            if props == entry:
                frame = text
            else:
                out.append(f"{short(props or '?')} (called, not inlined): "
                           f"{text}")
        m = re.search(r"Used (\d+) registers", line)
        if m and label:
            out.append(f"{label}: {m.group(1)} registers, {frame}")
            label = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ark_bulletproofs_tpu_torch import curves, engine, native
    from ark_bulletproofs_tpu_torch.ops import _build
    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops import fs, gather, gens
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    engine.config.device = "cuda"
    dev = engine.torch_device()
    wrappers = {
        "suffix_madd_scan": k2.suffix_madd_scan,
        "suffix_jac_scan": k2.suffix_jac_scan,
        "rowsum": k2.rowsum,
        "rcb_double_k_add": kk.rcb_double_k_add,
        "mont_mul": df.mont_mul,
        "add_sub": df.add_sub,
        "sum_mod": df.sum_mod,
        "mont_inv_batch": fs.mont_inv_batch,
        "te_double_k_add": kk.te_double_k_add,
        "te_double": kk.te_double,
        "jac_double_k_add": kk.jac_double_k_add,
        "jac_double": kk.jac_double,
        "jac_madd": kk.jac_madd,
        "te_madd": kk.te_madd,
        "fs_round": fs.fs_round,
        "horner_windows": k2.horner_windows,
        "jac_horner_windows": k2.jac_horner_windows,
        "rcb_double": kk.rcb_double,
        "row_gather": gather.row_gather,
        "stage_table": gather.stage_table,
        "stage_gather": gather.stage_gather,
        "gen_candidates": gens.gen_candidates,
    }

    with phase("1 build"):
        smi = smi_line()
        clock = float(smi_query("clocks.max.sm", units=False))
        print(f"   card: {smi}, max SM clock {clock:.0f} MHz; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        state = ("clocks.sm,clocks.mem,clocks.max.mem,temperature.gpu,"
                 "power.draw")
        print(f"   {state}: {smi_query(state)}", flush=True)
        _build.lib()
        print(f"   nvcc sm_90a build: {_build.build_seconds} s -> "
              f"{os.path.relpath(_build.library_path(), ROOT)}", flush=True)
        for line in ptxas_report(_build.build_log or ""):
            print(f"     {line}", flush=True)
        host = native.lib()
        if host is None:
            raise AssertionError("the native host library did not build "
                                 "or load")
        print(f"   native host library: {os.path.relpath(host._name, ROOT)}",
              flush=True)

    CURVES_ALL = (curves.secq256k1, curves.zorro, curves.curve25519)
    check = KernelCheck(dev, Bound(clock))
    with phase("2 kernels vs plain versions"):
        check.run_curve(curves.secq256k1, seed=1, timed=True)
        check.run_curve(curves.zorro, seed=2, timed=False)
        check.run_curve(curves.curve25519, seed=5, timed=True)
        check.run_chains(curves.secq256k1, seed=19, timed=True)
        check.run_chains(curves.zorro, seed=20, timed=True)
        check.run_chains(curves.curve25519, seed=21, timed=True)
        check.run_mont_mul(curves.secq256k1, seed=3, timed=True)
        check.run_mont_mul(curves.zorro, seed=4, timed=False)
        check.run_mont_mul(curves.curve25519, seed=27, timed=False)
        for seed, curve in enumerate(CURVES_ALL, 28):
            check.run_add_sub(curve, seed, timed=curve is curves.secq256k1)
            check.run_sum_mod(curve, seed, timed=curve is curves.secq256k1)
            check.run_inv_batch(curve, seed,
                                timed=curve is curves.secq256k1)
        check.run_te_chain(curves.curve25519, seed=31, timed=True)
        check.run_rcb_te(curves.secq256k1, seed=22, timed=True)
        check.run_rcb_te(curves.zorro, seed=23, timed=False)
        check.run_rcb_te(curves.curve25519, seed=24, timed=True)
        check.run_jac(curves.secq256k1, seed=6, timed=True)
        check.run_jac(curves.zorro, seed=7, timed=False)
        check.run_madd_scan(curves.secq256k1, seed=11, timed=True)
        check.run_madd_scan(curves.zorro, seed=12, timed=False)
        check.run_double_chain(curves.secq256k1, seed=25, timed=True)
        check.run_double_chain(curves.zorro, seed=26, timed=True)
        check.run_madd_scan(curves.curve25519, seed=13, timed=True)
        check.run_fs_round(curves.secq256k1, seed=8, timed=True)
        check.run_fs_round(curves.zorro, seed=9, timed=False)
        check.run_fs_round(curves.curve25519, seed=10, timed=False)
        check.run_horner(curves.secq256k1, seed=14, timed=True)
        check.run_horner(curves.zorro, seed=15, timed=False)
        check.run_horner(curves.curve25519, seed=16, timed=True)
        check.run_rcb_double(curves.secq256k1, seed=17, timed=True)
        check.run_rcb_double(curves.zorro, seed=18, timed=True)
        check.run_row_gather()
        check.run_stage_gather()
        check.report()
    torch.cuda.empty_cache()

    launches = Launches(wrappers)
    path_lanes = PathLanes(kk, k2, fs, gather, launches, check.held)
    with phase("gens generator farm"):
        check.run_gens(curves.secq256k1, timed=True)
        check.run_gens(curves.zorro, timed=True)
        farm_points = phase_gens(launches)
    with phase("3 msm n=2^20 secq256k1"):
        msm_in = phase_msm(curves.secq256k1, launches, farm_points)
        del farm_points
    with phase(f"4 shuffle k={SHUFFLE_K} secq256k1"):
        prove, verify, shuffle_in = phase_shuffle(curves.secq256k1,
                                                  launches)
    with phase("5 batch_verify 1024 x k=8"):
        batch_in = phase_batch(curves.secq256k1, launches)
    with phase("6 msm n=2^20 curve25519"):
        msm_te_in = phase_msm(curves.curve25519, launches)
    with phase(f"7 shuffle k={SHUFFLE_K} curve25519"):
        prove_te, _, _ = phase_shuffle(curves.curve25519, launches)
    with phase("8 ipa n=2^16 secq256k1"):
        ipa_in = phase_ipa_routes(curves.secq256k1, 1 << 16, launches,
                                  verify=True, farm=True)
    with phase("9 ipa zorro n=1024"):
        phase_ipa_routes(curves.zorro, 1024, launches)
        phase_ipa_v1(curves.zorro, 64, launches)
    with phase(f"10 create_batch n={BATCH_N} P={BATCH_P} secq256k1"):
        phase_create_batch(curves.secq256k1, launches)
    with phase(f"11 prove_batch P={BATCH_P} k={PROVE_BATCH_K} secq256k1"):
        phase_prove_batch(curves.secq256k1, launches)
    with phase("12 v1 MSMs secq256k1"):
        phase_v1(curves.secq256k1, launches)
    with phase(f"13 batch_verify {BV_P} x k={BV_K} secq256k1"):
        phase_batch_verify_dev(curves.secq256k1, launches)
    with phase(f"16 mesh: {MESH_D} shards on one card"):
        phase_mesh(curves.secq256k1, launches, msm_in, msm_te_in, shuffle_in,
                   batch_in, ipa_in)
        del msm_in, msm_te_in
    with phase("14 launches"):
        launches.check()
        path_lanes.check()
        te_sent = path_lanes.sent["te_madd"]
        if not te_sent:
            raise AssertionError("no curve25519 path sent te_madd")
        R, L = max(te_sent, key=lambda s: (s[1] * s[0], s[1]))
        print(f"   te_madd at the largest (rows, lanes) a path sent, "
              f"{(R, L)} ({te_sent[(R, L)]}):", flush=True)
        P, qx, qy, qi = check.scan_operands(
            curves.curve25519, spec_for(curves.curve25519), R, L, seed=41)
        check.time_madd_scan(spec_for(curves.curve25519), (P, qx, qy, qi))
        del P, qx, qy, qi
    with phase("15 traces"):
        traced(f"secq256k1 card prove k={SHUFFLE_K}", prove)
        traced(f"secq256k1 verify k={SHUFFLE_K}", verify)
        traced(f"curve25519 card prove k={SHUFFLE_K}", prove_te)

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.total(wrapper, on_model),
            "max_abs_err": check.err[name],
            "ms": check.times[name][0],
            "plain_ms": check.times[name][1],
            "bound_ms": check.times[name][2],
            "bound_by": check.times[name][3],
            "library_ms": check.library_ms.get(name),
        }
        for name, wrapper, on_model, source, replaces in ENTRIES
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
