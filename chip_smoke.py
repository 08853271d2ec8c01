#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tagan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit; build the CUDA kernels from
   ``tagan_torch/csrc`` (all ``nvcc`` processes at once) and print each
   kernel's registers and spill from ptxas;
2. the forward kernel B1 (the fp32 pair walk) against its plain PyTorch
   version on the card at small shapes: every metric, dead rows and an
   empty query tile, N not a multiple of the tile, D != Dv, per-head
   scales, dropout 0 and 0.1, and the same at the pair walks' sparse
   masks (``tests/test_torch_gpu.py::sparse_mask``, N = 1,000, H = 4) and
   (D, Dv) of (16, 16), (8, 8), (12, 12), (7, 3), (128, 128) there (N =
   1,008, H = 3); (2b) the backward kernels, B2 (the fp32 backward pair
   walk) and B3a + B3b (the two-walk backward: a row pair walk over the
   forward plan, a key pair walk over the transposed plan), against the
   plain backward on the same grid plus learnable scales (dscale), an
   empty key strip, an lse cotangent and (D, Dv) of (7, 3), (40, 72),
   (128, 128), and at 2's sparse masks and head dims; and B3a + B3b at
   ``tests/test_torch_gpu.py::two_walk_mask``'s cases
   (`dense_two_walk_check`: every metric, dropout 0 and 0.1, rows and
   keys past 128 entries, an empty key strip, a live row whose lse is
   LSE_DEAD, a fold of 33 heads, outputs allocated NaN-filled and set
   everywhere, one case 20 times bit for bit);
   (2c) the edge-biased forward kernels B4 (lse1) and B5 (out, lse2),
   the fp32 pair walks, against their plain versions on the same grid
   with a bias that sums duplicate edges, and the three (D, Dv), and at
   2's sparse masks and head dims with a N(0, 1) bias at the mask's
   pairs; (2d) the edge-biased backward's
   fp32 pair walks, the row walk (B6 and B7a: delta1, dB, dq, dscale)
   and the key walk (B7b: dk, dv), against their plain versions on 2c's
   grid and at its sparse masks and head dims, a fold of 40 heads (two
   row walk launches adding into dB), dB at the mask's pairs, and nine
   cases called twice, bit for bit; (2e) the compact-store forward
   kernels of the hybrid backend, B1c, B4c and B5c, against their compact
   plain versions on 2c's grid, with the bit and the int8 store (a row
   tile with jcount = 0 among the dead rows), and the compact forward
   pair walk in its three modes, B5c (`compact_fwd_walk_check`), B1c
   (`compact_out_walk_check`: with dropout, far from the plain version
   at another seed) and B4c (`compact_lse_walk_check`: no dropout, the
   cases' head dims D), at `tests/test_torch_gpu.py::band_mask`'s cases
   over `band_compact`'s walks (every metric, dropouts off and on, both
   stores, (D, Dv) of (16, 16), (8, 8), (12, 12), (7, 3) and (128, 128),
   folds of 1, 4 and 33 heads; its outputs allocated NaN-filled and set
   everywhere, two cases called 20 times bit for bit); (2f) the
   compact-store backward kernels B3a c (dq, dscale; the compact row
   pair walk) and B3b c (dk, dv; the compact key pair walk) against the
   compact plain backward on 2e's grid with an lse cotangent, dead rows
   and an empty key strip (icount = 0) exactly zero, and B3b c at
   `tests/test_torch_gpu.py::band_mask`'s cases over `band_compact`'s
   walks (`compact_bwd_walk_check`: every metric, dropout off and on,
   both stores, (D, Dv) of (16, 16), (8, 8), (12, 12), (7, 3) and (128,
   128), folds of 1, 4 and 12 heads and 12 at head dim 128, a row whose
   lse is LSE_DEAD though the store lists its pairs; its outputs
   allocated NaN-filled and set everywhere, two cases called 20 times
   bit for bit), and B3a c at the same cases (`compact_dq_walk_check`:
   dscale at gaussian and rbf, folds of 1, 4 and 33 heads and 33 at head
   dim 128, rows whose walks list more than 128 pairs); (2g) the
   compact-store biased backward's fp32 pair walks, the row walk (B6c
   and B7a c: delta1, dB at the store's pairs, dq, dscale) and the key
   walk (B7b c: dk, dv), against the compact plain parts on 2e's grid
   with union-like statistics (a residual's delta1 added between the row
   walk's passes, the merge's NEG_INF lse2 on dead rows), both stores,
   and at `tests/test_torch_gpu.py::band_mask`'s cases over
   `band_compact`'s walks (a walked slot with no bit, walk entries past
   the counts, a key tile no row reaches, rows past 128 keys, N = 330),
   folds of 8 and 40 heads, and nine cases called twice, bit for bit;
   (2h) the bf16 forms of B1, B2, B3a
   and B3b (bf16 dot operands, fp32 sums) against the plain bf16
   versions on 2's grid and head dims 8, 12 and 128 (and B3a + B3b bf16
   at 2b's two-walk cases), under three gates
   over the plain version's largest entry: max error <= 2e-3 (bf16-class:
   an fp32 sum in another order may flip a bf16 rounding), mean error <=
   1e-5 (fp32-class), and the mean distance from the fp32 result at
   least 100 times the mean error; (2i) the bf16 forms of B4 and B5 and
   the bf16 biased backward's row walk (B6 and B7a) and key walk (B7b)
   against their plain bf16 versions on 2c/2d's grid, (D, Dv) of (16,
   16), (8, 8), (12, 12), (7, 3) and (128, 128), under the same gates, dB
   at the mask's pairs; (2j) the bf16 forms of B1c, B3a c
   and B3b c against the compact plain bf16 versions on 2f's grid, both
   stores, (D, Dv) of (16, 16), (8, 8), (12, 12), (7, 3) and (128, 128),
   under the same gates (dead rows and the empty key strip exactly 0),
   B3b c bf16's and B3a c bf16's walks at 2f's band cases under the
   bf16 gates, and a jslot past the store raising before any launch;
   (2k) the bf16
   forms of B4c, B5c and the compact biased backward's row walk (B6c
   and B7a c) and key walk (B7b c) against the compact plain bf16
   versions on 2g's grid and union-like statistics with a residual
   delta1 that is not 0, both stores, (D, Dv) of (16, 16), (8, 8), (12,
   12), (7, 3) and (128, 128), and at 2g's band cases, under the same
   gates (dB at the store's pairs, dead rows and the empty key strip
   exactly 0), the backward's outputs allocated NaN-filled (every entry
   set but dB's off the store's pairs, which stay NaN), one band case
   20 times bit for bit; the walks given a zero delta1_rest failing the
   gates (the witness); a jslot past the store raising before any
   launch at the four entries; and the bf16 compact forward walk, B5c
   bf16, B1c bf16 and B4c bf16 (the max and mean gates), at 2e's band
   cases under the bf16 gates;
3. the serving path: ``Predictor`` serving 3 requests of 2 sequences at
   the width ``bench.py`` runs (10,000 nodes, 160,000 random edges per
   snapshot, 8 snapshots, hidden 64, 4 heads, 2 flash layers) with random
   weights from a seed; launch counts set to 0 just before and read just
   after; the forward alone, and one layer's B1 launch over the request's
   folded snapshots, timed; then the first layer's B1 output on one
   snapshot against the plain version at full width;
   (3b) the same with edge features (``bench_tgn.py``'s Fe = 4, N(0, 1)
   features, ``use_edge_features=True``): 3 requests, launch counts set
   to 0 just before and read just after (B4 and B5 once per layer per
   request, B1 never); the forward, one layer's B4 and B5 over the
   folded snapshots (and, for 5b, per snapshot at the euclidean and the
   scaled-dot metric, each of the 16 snapshots held to the plain
   versions), and the first layer's B4 and B5 on one snapshot against
   the plain versions at full width;
   (3c) the hybrid backend at ``bench_partition_stress.py`` part C's
   width (131,072 nodes, 16 edges per node, 95% of them within +-512 of
   their source, 2 snapshots, node features 8, hidden 64, 4 heads, 2
   layers): 3 requests of 2 sequences with the plans pinned over them,
   launch counts set to 0 just before and read just after (B1c once per
   layer per request, nothing else); host packing and planning, the
   forward, the peak memory, one layer's B1c over the folded snapshots,
   and the first layer's B1c on one snapshot against its plain version;
   (3d) the same with 4 N(0, 1) edge features (B4c and B5c once per layer
   per request, B1 and B1c never), one layer's bias store build;
   (3e) phase 3 with ``bf16_matmul=True`` (B1's bf16 form once per layer
   per request, nothing else), the peak memory, the fp32 model's logits
   on the same request and weights beside the bf16 model's, and the
   first layer's B1 bf16 on one snapshot against the plain bf16 version
   under the bf16 gates; (3f) phase 3b with ``bf16_matmul=True`` (the
   bf16 forms of B4 and B5 once per layer per request, nothing else),
   the peak memory, the fp32 edge model's logits beside the bf16
   model's, and the first layer's bf16 B4 and B5 on one snapshot at full
   width against the plain bf16 versions under the bf16 gates; (3g)
   phase 3c with ``bf16_matmul=True`` on 3c's requests (B1c's bf16 form
   once per layer per request, nothing else): host packing and planning,
   the forward, the peak memory, the fp32 hybrid model's logits beside
   the bf16 model's on the same weights and request, and the first
   layer's bf16 B1c on one 131K snapshot against the plain bf16 version
   under the bf16 gates; (3h) phase 3d with ``bf16_matmul=True`` on 3d's
   requests (the bf16 forms of B4c and B5c once per layer per request,
   nothing else): host packing and planning, the forward, the peak
   memory, the fp32 edge-feature hybrid model's logits beside the bf16
   model's, and the first layer's bf16 B4c and B5c on one 131K snapshot
   against the plain bf16 versions under the bf16 gates; (3i) phase 3's
   requests served by ``Predictor(reorder="rcm")`` (B1 once per layer
   per request, nothing else), held to phase 3's probabilities within
   TOL; the host time of ``build_sequence`` on one of its requests with
   and without the reorder and of the RCM order alone, and on one 3c
   request (the median and range of 5 rounds, the order alternating),
   and the flash plan's walked tiles with and without the reorder; (3j) one part C sequence (131,072 nodes, 16 N edges a
   snapshot, 2 snapshots) with its node IDs relabelled by a seeded
   permutation (the same x rows and edges: the same graph), served on
   the hybrid model with ``reorder="rcm"`` (B1c once per layer, nothing
   else) and held within TOL to the sequence with its IDs as they were
   and no reorder; the plan's S, Wj, Er and the band's share of edges
   beside the unrelabelled sequence's, the band the relabelled one would
   get without RCM, and the RCM, packing and planning seconds and the
   forward;
4. end to end at 1,000 nodes: the same Predictor's probabilities on the
   card (kernels) and on the CPU (plain versions), and the per-node
   features after the attention layers (``encode_spatial``); (4b) the
   same for the edge-feature model, and its flash form against its csr
   form on the card (an independent O(E) formula), on distinct edges;
   (4c) the hybrid Predictor at 4,096 nodes, plain and edge-feature
   models, card against CPU; (4d) at 131,072 nodes on distinct non-loop
   edges, the hybrid models against their csr forms on the card; (4e)
   the same graph, the hybrid model's first-step gradients against its
   csr form's on the card (within 1e-3 of each tensor's largest entry);
   (4f) the same for the edge-feature hybrid model (4 N(0, 1) edge
   features; csr's autograd is an independent formula for dB), the edge
   parameters' gradients non-zero; (4g) ``infer_with_attention`` of one
   of phase 4's sequences packed with ``dense_adj=True`` (the dense path
   by JAX's rule: no kernel launched), card against CPU, the weights and
   logits within TOL; packed with ``dense_adj=False`` it raises
   ValueError;
5. times at the main path's shape (one snapshot, 4 heads, 10,000 nodes,
   head dim 16) with CUDA events, in turns: B1, B2 (the fp32 pair walks;
   B2 also at the scaled-dot metric), B3a, B3b and B3a + B3b against the
   plain versions, and ``scaled_dot_product_attention`` on fp32 q, k, v
   (forward; backward = forward+backward - forward) with the boolean mask
   as the library yardstick; each kernel's bound from this run's inputs;
   B1 also over 3's 16 folded snapshots, per snapshot, at the euclidean
   and the scaled-dot metric beside sdpa fp32 over the same fold (timed
   in 3), and B2 over 6's 8 folded snapshots at both metrics beside sdpa
   fp32's backward over that fold (timed in 6);
   (5b) B4 and B5 (the fp32 pair walks) at one snapshot of the
   edge-feature request against their plain versions in turns, held to
   them at the euclidean and the scaled-dot metric, compiled
   ``flex_attention`` at the scaled-dot metric as the library yardstick
   (held against B4 and B5 at that metric), the csr ``edge_attention``
   on the same graph and bias, and their bounds; B4 and B5 also over 3b's
   16 folded snapshots, per snapshot, at both metrics (timed in 3b);
   (5c) the fp32 row walk, the key walk and the two together at the
   same snapshot against the plain biased backward, compiled
   ``flex_attention``'s backward of B4 and B5's function at the
   scaled-dot metric as the library yardstick (its gradients held
   against the walks' there, recorded), and their bounds; the walks
   over 6b's 8 folded snapshots are timed in 6b;
   (5d) B1c, B4c and B5c at one 131K snapshot of 3c/3d against their
   plain versions and bounds (and each one's share of its bound),
   compiled ``flex_attention`` under a block mask built from the compact
   plan (a bit-store mask_mod) at the scaled-dot metric as the library yardstick (held against the kernels
   at that metric; null with the reason if it does not build), and the
   csr ``edge_attention`` over the layer's whole edge set; (5e) B3a c
   (the compact row pair walk), B3b c (the compact key pair walk) and
   the two together at one 131K
   snapshot of 6c against the compact plain backward and their bounds
   (and each one's share of its bound), compiled ``flex_attention``'s
   backward under the compact plan's block mask at the scaled-dot metric
   as the library yardstick (forward+backward minus forward; null with
   the reason if it does not build or differs), and csr
   ``edge_attention``'s autograd backward over the layer's whole edge set;
   (5f) the compact row walk (B6c and B7a c), the key walk (B7b c) and
   the two together at one 131K snapshot of 6d (union statistics)
   against the compact plain parts and their bounds (the bias and dB at
   the valid pairs only), the histogram of valid pairs per walked tile
   on an earlier line, compiled
   ``flex_attention``'s backward of B4c and B5c's function under the
   compact plan's BlockMask at the scaled-dot metric as the library
   yardstick (held against the walks on band statistics; null with the
   reason if it does not build or differs), and csr ``edge_attention``'s
   biased autograd backward over the layer's whole edge set;
   (5g) B1, B2, B3a and B3b in their bf16 forms at one snapshot of 3e's
   request, each beside its fp32 form in turns, the plain bf16 versions,
   ``scaled_dot_product_attention`` on bf16 q, k, v with the boolean mask
   as the library yardstick (held against B1 bf16, the pair walk, at the
   scaled-dot metric within FLEX_BF16_TOL), and their bounds (the fp32
   forms' bytes, operations at the bf16 tensor-core rate); B1 bf16 also
   at the grid its path launches, 3e's 16 folded snapshots, per snapshot,
   at the euclidean and the scaled-dot metric beside sdpa over the same
   fold (timed in 3e, where the fold is); B2 bf16 (the backward pair
   walk) at the scaled-dot metric beside sdpa bf16's gradients (their
   error recorded, not gated: sdpa rounds its output, dS and gradients
   to bf16), and over 6e's 8 folded snapshots at both metrics (timed in
   6e); and a density sweep at N = 10,000 (degree 16, 256 and 2,048): B1
   bf16, B4 bf16 and B2 bf16 held to the plain bf16 versions under the
   bf16 gates, B1, B2, B4 and B5 (the fp32 walks; B5 with a N(0, 1) bias
   at the mask's pairs) to the plain fp32 versions within TOL, beside
   sdpa bf16 and sdpa fp32 (forward, and fp32's backward) on the same
   masks, times recorded, not gated; the sweep also
   holds the bf16 biased backward's two walks to the plain bf16 version
   and the fp32 walks to the plain fp32 version within TOL on each mask;
   (5h) the bf16 forms of B4, B5 (pair walks) and B6, B7a and B7b (the
   row walk, B6 and B7a bf16 in one kernel, and the key walk, B7b bf16)
   at one snapshot of 3f's request, each beside its fp32 form in turns,
   the plain bf16 versions, compiled ``flex_attention`` on bf16 q,
   k, v at the scaled-dot metric as the library yardstick (held against
   the bf16 B4 and B5 at that metric, null with the reason if it does
   not build or differs; its backward forward+backward minus forward,
   its gradients held against the two walks' at that metric, recorded),
   and their bounds; B4 bf16 and B5 bf16 also over 3f's 16 folded
   snapshots, per snapshot, at both metrics (timed in 3f), and the two
   walks over 6f's 8 folded snapshots beside the fp32 walks there
   (timed in 6f); (5i) the bf16 forms
   of B1c, B3a c and B3b c at one 131K snapshot of 6g, each beside its
   fp32 form in turns, the compact plain bf16 versions, compiled
   ``flex_attention`` on bf16 q, k, v under the compact plan's BlockMask
   at the scaled-dot metric as the library yardstick (forward, and
   forward+backward minus forward; held against the bf16 kernels at that
   metric, null with the reason if it does not build or differs), and
   their bounds (the fp32 forms' bytes, operations at the bf16 rate) and
   each one's share of its bound;
   (5j) the bf16 forms of B4c, B5c, the compact row walk (B6c and
   B7a c) and key walk (B7b c) at one 131K snapshot of 6h (union
   statistics), each beside its fp32 form in turns, the compact plain
   bf16 versions, compiled ``flex_attention`` on bf16 q, k, v under the
   compact plan's BlockMask at the scaled-dot metric as the library
   yardstick (B4c's and B5c's functions, held against the bf16 kernels
   at that metric, null with the reason if it does not build or
   differs; and the two calls' forward+backward minus forward, its
   gradients' error against the bf16 walks' recorded, not gated), and
   their bounds (the fp32 forms' bytes, operations at the bf16 rate) and
   each walk's share of its bound;
6. the training path at the same width: ``TAGANTrainer.train`` on one
   sequence per batch, one warm-up step and 3 steps with B3a+B3b, then 3
   with B2 (the picker's default), launch counts set to 0
   just before each and read just after; step times (host clock around a
   synchronising step), the forward / backward / optimizer split (CUDA
   events), one layer's B1 and backward launches over the 8 folded
   snapshots (B2 also at the scaled-dot metric, and sdpa fp32's backward
   over the fold) and their share of the step, finite losses, finite non-zero
   gradients and parameters moved after the warm-up; then one snapshot
   at full width, both backward forms against the plain backward, at the
   seeded weights and at those after the B3a+B3b steps (which sum in a
   fixed order, so the inputs are the same in every run);
   (6b) the same for the edge-feature model (B4, B5 forward; the row
   walk and the key walk backward, each exactly once per layer per step,
   B1-B3 never): step times, split, peak memory, one layer's two walks
   (and each alone, and the bf16 walks on the same fold) over the folded
   snapshots and their share of the step, finite non-zero
   gradients (``edge_embedding`` and each ``edge_bias`` included) and
   every parameter moved; one snapshot at full width against the plain
   backward; (6c) the hybrid model at part C's width over a
   ``plan="hybrid"`` loader: the loader's planning batch apart from its
   cached ones, one warm-up step, then 3 steps (B1c, B3a c and B3b c
   each exactly once per layer per step, nothing else), step times,
   split, peak memory, one layer's B3a c + B3b c (and each alone) over
   the folded snapshots and their share of the step, finite non-zero
   gradients,
   every parameter moved, and one snapshot at full width against the
   compact plain backward; (6d) the same for the edge-feature hybrid
   model (Fe = 4: B4c, B5c, the compact row walk and the compact key
   walk each exactly once per layer per step, nothing else: their bf16
   forms never), one layer's two walks over the folded snapshots
   and their share of the step, the edge
   parameters' gradients non-zero, one snapshot at full width against
   the compact plain parts with the layer's union statistics;
   (6e) phase 6 with ``bf16_matmul=True``, ``bench.py``'s bf16 step
   (:129-151): B1's and B2's bf16 forms (and B3a's and B3b's with the
   other backward) launched exactly as the fp32 forms are in 6, the fp32
   forms never; step times, split, peak memory, one layer's bf16 B1 and
   backward over the folded snapshots and their share of the step; one
   snapshot at full width against the plain bf16 backward, the plain bf16
   backward's own movement under a 1e-7 relative nudge of q and k logged
   beside it; (6f) phase 6b
   with ``bf16_matmul=True``: the bf16 forms of B4 and B5 and the bf16
   backward's row walk and key walk each exactly once per layer per
   step, nothing else; step times, split, peak memory, one layer's bf16
   B4 + B5 (and B4 alone) and the two walks (and each alone, and the fp32
   walks on the same fold) over the folded snapshots and their
   share of the step, finite non-zero gradients (the edge parameters'
   included), one snapshot at full width against the plain bf16 biased
   backward;
   (6g) phase 6c with ``bf16_matmul=True`` over 6c's loaders and planned
   batches: one warm-up step, then 3 steps (the bf16 forms of B1c, B3a c
   and B3b c each exactly once per layer per step, the fp32 forms
   never), step times, split, peak memory, one layer's bf16 B3a c + B3b c
   (and each alone) over the folded snapshots and their share of the
   step, finite non-zero
   gradients, every parameter moved, and one snapshot at full width
   against the compact plain bf16 backward under the bf16 gates, at the
   weights the 3 steps left: the warm-up and the 3 steps run under
   torch's deterministic algorithms, so that their sums run in a fixed
   order, and the sha256 of the weights and of the check's inputs is
   logged (6c logs it too); (6h)
   phase 6d with ``bf16_matmul=True`` over 6d's loaders and planned
   batches (the bf16 forms of B4c, B5c and the compact row and key
   walks each exactly once per layer per step, the fp32 forms never):
   step times, split, peak memory, one layer's two bf16 walks over the
   folded snapshots and their share of the step, the edge parameters'
   gradients non-zero, every parameter moved, and one snapshot at full
   width against the compact plain bf16 parts under the bf16 gates;
   (6i) at 1,000 nodes, one training step of each loss family that
   ``compute_loss`` routes (focal with one output and with three,
   regression, multi_label, sequence, huber and quantile), card against
   CPU on the loss and the gradients within TOL, B1 and B2 once per layer
   on the card; then one step of phase 6's 10K flash trainer over a
   ``reorder="rcm"`` loader, its loss within TOL of the same step over the
   loader without reorder;
7. training at 1,000 nodes on the card and on the CPU from the same
   weights and batches: the first step's gradients and the losses and
   parameters of 3 AdamW steps; (7b) the same for the edge-feature
   model, and its first-step gradients on the card against its csr form
   (csr's autograd, an independent formula for dB) on distinct edges;
   (7c) the hybrid model at 4,096 nodes over a ``plan="hybrid"`` loader,
   card against CPU; (7d) the same for the edge-feature hybrid model;
   (7e) the same with ``bf16_matmul=True``, the card's fp32 model the
   witness, twice: with the kernels alone at bf16 (the plain
   contractions pinned to fp32) under model-level bf16 gates, and as
   the model runs, every contraction at bf16, at bf16-class tolerances;
   (7f) the same for the edge-feature model on 7b's graphs (the bf16 forms
   of B4, B5 and the two walks); (7g) the same for the hybrid model on 7c's
   graphs at 4,096 nodes (the bf16 forms of B1c, B3a c and B3b c), the
   CPU's own flip noise measured beside it; (7h) the same for the
   edge-feature hybrid model on 7d's graphs (the bf16 forms of B4c-B7b c);
8. the graph-sharded ring over g = 2, 4 and 8 virtual ranks of the card
   (``make_mesh(graph=g, devices=["cuda"] * g)``, each rank with a
   compute and a copy stream of its own): the main path is
   ``ring_all_gather_sharded`` over the 10K flash model's layer-0 K as
   [10,000, 64] fp32 and over [131,072, 64] fp32 and bf16 rows, and
   ``ring_flash_attention`` on that layer's q, k, v and snapshot mask,
   fp32 at every g and bf16 at g = 4, launch counts set to 0 just before
   and read just after; (8a) B8, one launch of the ring kernel a ring,
   bit for bit against the rank-order concatenation on every rank and
   identical over 50 rings, its ms beside each rank's ``torch.cat`` of the
   shards and the host's time to issue a ring (in a run of rings and onto
   an idle card); (8b) B9 within 1e-4 of its
   plain version on the card and of B1 on the live rows (its dead rows
   exactly 0), within 2e-4 of the port's collective ring
   (``dist.edge_partition.ring_edge_attention``) on the card, repeated
   rings identical, ms per snapshot beside SDPA with the boolean mask at
   the scaled-dot metric (held to B9 there within 1e-4, else its time is
   null with the reason), the host's time to issue a ring and, at g = 4,
   the ms of one fold launch alone (rank 0's hop 0) and of one
   ``ring_copy`` of a K chunk beside ``Tensor.copy_``; (8c) B9's bf16 form
   at g = 4 under the bf16 gates, the fp32 form's ms in the same run, SDPA
   on bf16 q, k, v as its yardstick (within ``FLEX_BF16_TOL``), its issue
   and fold times likewise; (8d) B9 and its bf16 form at g = 4 on random
   masks of 256 and 2,048 keys a row (each within its gates against the
   plain version) beside SDPA at both precisions: where the pair walk
   meets the tensor cores.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. A copy of the measurements goes to
``chiprun_out/chip_smoke.json``. Exits non-zero without CUDA.
"""

import contextlib
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEV = "cuda"
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
# fp32 kernel vs plain version, sums in another order (and dq by atomics
# under B2): max abs error, taken over the largest entry (at least 1)
# where gradients span many scales
TOL = 1e-4

N_FULL, E_FULL, T_FULL, F_NODE = 10_000, 160_000, 8, 16
F_EDGE = 4                  # bench_tgn.py's edge_feature_dim
# the hybrid model's graphs (bench_partition_stress.py part C, :194-238)
N_HYB, DEG_HYB, T_HYB, F_HYB = 131_072, 16, 2, 8
N_MID_HYB = 4_096
# the flash model against the csr model: the flash path's norm expansion
# of squared distances against csr's subtract-then-square
TOL_CSR = 2e-4
# the hybrid model's first-step gradients against the csr model's at
# 131,072 nodes, over each tensor's largest entry: the same conventions,
# summed over 2.2M edges in other orders
TOL_HYB_CSR_GRAD = 1e-3
REQUESTS, SEQS_PER_REQUEST = 3, 2
N_MID = 1_000
# (D, Dv) of the fp32 pair walks' checks at the sparse masks (2, 2b, 2c)
SPARSE_DIMS = ((16, 16), (8, 8), (12, 12), (7, 3), (128, 128))
TRAIN_STEPS = 3
# gradients that are zero in exact arithmetic (a bias that adds one
# constant to every score of a softmax row): fp32 noise on the card
ZERO_GRAD = ("temporal_attention.k.b",
             "temporal_attention.time_encoding.basis_proj.b",
             "temporal_attention.time_q_proj.b")
FG_SRC = "tagan_tpu/ops/pallas/flash_geometric.py"
HB_SRC = "tagan_tpu/ops/pallas/hybrid_biased.py"
# the bf16 forms against their plain versions (both bf16), three gates
# over the plain version's largest entry: the max error is bf16-class (an
# fp32 sum in another order can put a value on the other side of a bf16
# rounding midpoint, which moves one term by up to 2^-8 of itself), the
# mean error fp32-class (a systematic slip moves every entry), and the
# witness: the mean distance from the fp32 result is at least 100 times
# the mean error, so that the rounding really happens
BF16_MAX_TOL = 2e-3
BF16_MEAN_TOL = 1e-5
BF16_WITNESS = 100
# the bf16 model end to end at 1,000 nodes, card against CPU. With the
# kernels alone at bf16, a flip in one layer's kernel moves the next
# layer's inputs and flips some of its roundings in turn, so the mean gate
# is a model's: each gradient's mean error over its largest entry
# (measured 5.4e-5 at most, max 2.0e-4; a systematic slip such as a
# rounded norm moves every entry by ~2^-9), the witness over the model 10
# times it (measured 2.0e-3), and the parameters after 3 AdamW steps at
# learning rate 1e-3 within half a step (measured 8.1e-5). With every
# contraction at bf16 the roundings flip throughout the model: each
# gradient's max error over its largest entry (measured 2.2e-2; the CPU
# tests hold the model to JAX's at this tolerance), the losses (4.1e-3)
# and the parameters, which a step turned by a flipped small gradient
# moves by up to a few learning rates (5.7e-3)
BF16_MODEL_MEAN_TOL = 1e-4
# the edge-feature model with the kernels alone at bf16 (7f): the edge
# parameters' gradients are sums of dB over every edge, and dB = sum_h dz
# sums to ~0 over each row (a softmax's cotangent), so they are differences
# of nearly equal sums, and every entry of such a tensor carries the same
# sum's flips (edge_embedding.b: each entry that sum times a weight; each
# edge_bias.b: the sum itself, one entry): each gradient's mean error over
# its largest entry (measured 3.2e-4 on edge_embedding.b, 7.9e-4 on the
# one-entry edge_bias.b; the max gate, 7e's, 7.9e-4)
BF16_EDGE_MEAN_TOL = 1e-3
BF16_MODEL_WITNESS = 10
# the hybrid model's witness (7g). Only its band runs at bf16, and its
# gradients stand only ~2.2e-4 (mean over the largest entry) from the
# fp32 model's, while a 1e-7 relative change of the node features moves
# them by ~3.8e-5 on the CPU alone (flipped roundings, which 7g measures
# and logs beside the card's error): any correct card lands ~6x closer
# to the CPU's bf16 gradients than the fp32 model is, a card that
# rounded nothing ~1x. 3x separates the two.
BF16_HYB_WITNESS = 3
BF16_KERNELS_PARAM = 5e-4
BF16_MODEL_GRAD = 1e-1
BF16_MODEL_LOSS = 2e-2
BF16_MODEL_PARAM = 1e-2
PEAK_BF16_FLOPS = 989e12    # H100 SXM, dense bf16 on the tensor cores
# compiled flex_attention on bf16 q, k, v against the bf16 forms of B4 and
# B5 at the scaled-dot metric (5h), max abs error over the largest entry
# (at least 1): flex returns out in bf16 (2^-9 of each entry) and rounds p
# against the running max of its own 128-key tiles, the kernels of their
# 64-key tiles (a flip moves a term by 2^-8)
FLEX_BF16_TOL = 1e-2


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters):
    fn()
    sync()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / iters


def host_ms(fn, iters):
    """ms of the host's clock to issue ``fn`` once, not waiting for the
    card."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    sync()
    return ms


def device_ms(fn, iters):
    """The card's ms of one call of ``fn``: the device time of every
    kernel it launched over ``iters`` calls, by ``torch.profiler``, over
    ``iters`` (unlike `cuda_ms`, no gap in which the card waits for the
    host counts)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    return sum(e.device_time_total for e in prof.key_averages()) \
        / iters / 1e3


def idle_issue_ms(fn, iters):
    """The least ms of the host's clock to issue ``fn`` once onto an idle
    card (synchronised before each issue), over ``iters`` tries: unlike
    `host_ms`, no queue of earlier work can hold the host back."""
    fn()
    best = float("inf")
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    sync()
    return best


def reset_counts(FG):
    for k in FG.KERNELS:
        k.launches = 0


def counts(FG):
    return {k.name: k.launches for k in FG.KERNELS}


def rel_err(got, want):
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def bf16_gates(label, got, want, f32, witness=True, mean=True):
    """The bf16 gates of ``got`` against ``want`` (the fp32 result
    ``f32`` is the witness's); returns (max abs error, max error, mean
    error, witness), the last three over ``want``'s largest entry.
    ``mean=False`` keeps the max gate alone (a reduction of a few
    entries, such as dscale)."""
    m = want.abs().max().clamp(min=1e-30)
    err = (got - want).abs()
    mx, mn = (err.max() / m).item(), (err.mean() / m).item()
    wit = ((f32 - want).abs().mean() / m).item()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: not finite")
    if not mx <= BF16_MAX_TOL or (mean and not mn <= BF16_MEAN_TOL):
        raise AssertionError(f"{label}: max err {mx}, mean err {mn} over "
                             f"the largest entry; tolerances {BF16_MAX_TOL}, "
                             f"{BF16_MEAN_TOL}")
    if witness and not wit >= max(BF16_WITNESS * mn, BF16_MEAN_TOL):
        raise AssertionError(f"{label}: witness {wit} < {BF16_WITNESS} x "
                             f"mean err {mn}")
    return err.max().item(), mx, mn, wit


def biased_kernels(FG, bf16):
    """The wrappers of B4, B5, the backward's row walk (B6 and B7a) and
    its key walk (B7b): the fp32 or the bf16 forms."""
    if bf16:
        return (FG.flash_lse1_bf16_kernel, FG.flash_biased_fwd_bf16_kernel,
                FG.flash_biased_bwd_row_bf16_kernel,
                FG.flash_biased_bwd_key_bf16_kernel)
    return (FG.flash_lse1_kernel, FG.flash_biased_fwd_kernel,
            FG.flash_biased_bwd_row_kernel, FG.flash_biased_bwd_key_kernel)


def flash_kernels(FG, bf16):
    """The wrappers of B1, B2, B3a and B3b: the fp32 or the bf16 forms."""
    if bf16:
        return (FG.flash_geometric_fwd_bf16_kernel,
                FG.flash_geometric_bwd_fused_bf16_kernel,
                FG.flash_geometric_bwd_dq_bf16_kernel,
                FG.flash_geometric_bwd_dkv_bf16_kernel)
    return (FG.flash_geometric_fwd_kernel, FG.flash_geometric_bwd_fused_kernel,
            FG.flash_geometric_bwd_dq_kernel,
            FG.flash_geometric_bwd_dkv_kernel)


def compact_kernels(FG, bf16):
    """The wrappers of B1c, B3a c and B3b c: the fp32 or the bf16 forms."""
    if bf16:
        return (FG.flash_geometric_fwd_compact_bf16_kernel,
                FG.flash_geometric_bwd_dq_compact_bf16_kernel,
                FG.flash_geometric_bwd_dkv_compact_bf16_kernel)
    return (FG.flash_geometric_fwd_compact_kernel,
            FG.flash_geometric_bwd_dq_compact_kernel,
            FG.flash_geometric_bwd_dkv_compact_kernel)


def compact_biased_kernels(FG, bf16):
    """The wrappers of B4c, B5c and the compact biased backward's row walk
    (B6c and B7a c) and key walk (B7b c): the fp32 or the bf16 forms."""
    if bf16:
        return (FG.flash_lse1_compact_bf16_kernel,
                FG.flash_biased_fwd_compact_bf16_kernel,
                FG.flash_biased_bwd_row_compact_bf16_kernel,
                FG.flash_biased_bwd_key_compact_bf16_kernel)
    return (FG.flash_lse1_compact_kernel, FG.flash_biased_fwd_compact_kernel,
            FG.flash_biased_bwd_row_compact_kernel,
            FG.flash_biased_bwd_key_compact_kernel)


# -- phase 1 ------------------------------------------------------------------

# each built source's ptxas lines, "kernel<template args>: report", from
# phase 1 (the kernels line carries the ring's)
PTXAS = {}


def phase_build(build, FG):
    TG, TF = ring_modules()[2:]
    t0 = time.perf_counter()
    build.build([k.source for k in FG.KERNELS + TG.KERNELS + TF.KERNELS])
    log(f"[1] kernels built in {time.perf_counter() - t0:.3f} s, each "
        f"source (its nvcc's time, all started together) "
        f"{ {n: round(t, 3) for n, t in build.build_seconds.items()} }")
    for name, text in build.build_logs.items():
        fn = "?"
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(\w+_kernel)(I(?:L[ib]\d+E)+E)?",
                              m.group(1))
                fn = k.group(1) if k else m.group(1)
                if k and k.group(2):
                    fn += "<" + ",".join(re.findall(r"L[ib](\d+)E",
                                                    k.group(2))) + ">"
            elif "registers" in line or "spill" in line:
                log(f"[1] {name} {fn}: {line.strip()}")
                PTXAS.setdefault(name, []).append(f"{fn}: {line.strip()}")


# -- phase 2 ------------------------------------------------------------------

def small_inputs(FG, G, H, N, D, Dv, metric, seed):
    """Random q, k, v, cotangents do and dlse, and an int8 mask with
    dead rows (one of them the last row), an empty query tile and an
    empty key strip where N and G allow. The cotangents are 0.25 x
    N(0, 1), so that the gradients are of order 1 and an absolute
    error means what it says (with N(0, 1) cotangents the squared
    metrics give gradients near 20, whose fp32 resolution is ~1e-5)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(G, H, N, D, device=DEV, generator=g)
    k = torch.randn(G, H, N, D, device=DEV, generator=g)
    v = torch.randn(G, H, N, Dv, device=DEV, generator=g)
    do = 0.25 * torch.randn(G, H, N, Dv, device=DEV, generator=g)
    dlse = 0.25 * torch.randn(G, H, N, device=DEV, generator=g)
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    mask = (torch.rand(G, N, N, device=DEV, generator=g) < 0.1).to(torch.int8)
    mask[0, 5] = 0
    mask[0, N - 1] = 0
    if N > 2 * FG.BLOCK_M:
        mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0   # a key strip, no queries
        if G > 1:
            mask[1, FG.BLOCK_M:2 * FG.BLOCK_M] = 0  # a query tile, no keys
    scale = torch.linspace(0.7, 2.0, H, device=DEV) \
        if metric in FG.SCALED_METRICS else torch.ones(H, device=DEV)
    seeds = torch.tensor([12345, -7, 2 ** 31 - 1, 0][:G], dtype=torch.int32,
                         device=DEV)
    return q, k, v, do, dlse, mask, scale, seeds


def sparse_cases(G, N, seed):
    """`tests.test_torch_gpu.sparse_mask` on the card: the pair walks'
    own cases (a whole tile, a tile of one pair, an empty tile between
    walked ones, rows whose keys lie in their last walked tile, rows past
    a list's 64 entries, dead rows and a dead query tile)."""
    from tests.test_torch_gpu import sparse_mask
    return torch.from_numpy(sparse_mask(G, N, seed)).to(DEV)


def kernel_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0, sparse=False):
    """B1 against the plain forward (at `sparse_cases` with ``sparse``);
    returns the max abs error of out and lse over live rows after checking
    dead rows exactly."""
    q, k, v, _, _, mask, scale, seeds = small_inputs(FG, G, H, N, D, Dv,
                                                     metric, seed)
    if sparse:
        mask = sparse_cases(G, N, seed)
    jlist, jcount = FG.make_block_plan(mask)
    out, lse = FG.flash_geometric_fwd_kernel(
        q, k, v, mask, jlist, jcount, metric, scale, seeds, rate)
    sync()
    p_out, p_lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seeds)
    sync()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
            and torch.all(p_out[dead] == 0)
            and torch.all(p_lse[dead] == FG.LSE_DEAD)):
        raise AssertionError(f"{metric} rate={rate}: dead rows differ")
    err = max((out - p_out)[~dead].abs().max().item(),
              (lse - p_lse)[~dead].abs().max().item())
    if not err <= TOL:
        raise AssertionError(f"{metric} rate={rate} D={D} Dv={Dv}: "
                             f"max abs err {err} > {TOL}")
    return err


def phase_small(FG):
    errs = []
    for metric in FG.MXU_METRICS:
        for rate in (0.0, 0.1):
            errs.append(kernel_vs_plain(FG, 2, 3, 150, 16, 8, metric, rate))
            errs.append(kernel_vs_plain(FG, 2, 4, 1000, 16, 16, metric, rate,
                                        sparse=True))
    for metric, D, Dv in (("euclidean", 40, 72), ("gaussian_kernel", 128, 128),
                          ("dot_product", 7, 3)):
        errs.append(kernel_vs_plain(FG, 2, 2, 200, D, Dv, metric, 0.1, 1))
    for D, Dv in SPARSE_DIMS:
        errs.append(kernel_vs_plain(FG, 1, 3, 1008, D, Dv, "gaussian_kernel",
                                    0.1, 1, sparse=True))
    log(f"[2] B1 vs plain: {len(errs)} cases ({len(errs) - 19} at the sparse "
        f"masks), max abs err {max(errs):.3e} (tol {TOL})")
    return max(errs)


def check_backward(label, got, want, fused):
    """{output: error} of one backward form against the plain backward:
    the max abs error of dq, dk and dv, and of dscale over its largest
    entry (at least 1); raises where an output's error over its largest
    entry (at least 1) passes TOL."""
    errs, rel = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} fused={fused}: non-finite {name}")
        errs[name], rel[name] = (g - w).abs().max().item(), rel_err(g, w)
    errs["dscale"] = rel["dscale"] = \
        rel_err(got[3], want[3]) if want[3] is not None else 0.0
    if not max(rel.values()) <= TOL:
        raise AssertionError(f"{label} fused={fused}: errors {rel} > {TOL}")
    return errs


def kernel_errors(res):
    """Each kernel's error from its own outputs, given {fused: {output:
    error}}: B2 all of them, B3a dq and dscale, B3b dk and dv."""
    return {"B2": max(res[True].values()),
            "B3a": max(res[False]["dq"], res[False]["dscale"]),
            "B3b": max(res[False]["dk"], res[False]["dv"])}


def backward_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0,
                      sparse=False):
    """B2 and B3a + B3b against the plain backward on one input (at
    `sparse_cases` with ``sparse``); returns {fused: {output: error}}
    (`check_backward`)."""
    q, k, v, do, dlse, mask, scale, seeds = small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    if sparse:
        mask = sparse_cases(G, N, seed)
    need = metric in FG.SCALED_METRICS
    out, lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                                rate, seeds)
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    want = FG.flash_geometric_backward_plain(q, k, v, mask, out, lse, do,
                                             metric, scale, rate, seeds,
                                             need, dlse)
    res = {}
    for fused in (True, False):
        got = FG._backward(q, k, v, mask, out, lse, do, plan, plan_t, metric,
                           scale, rate, seeds, need, fused, dlse)
        sync()
        res[fused] = check_backward(f"{metric} rate={rate} D={D} Dv={Dv}",
                                    got, want, fused)
    return res


def phase_small_bwd(FG):
    errs = []
    for metric in FG.MXU_METRICS:
        for rate in (0.0, 0.1):
            errs.append(backward_vs_plain(FG, 2, 3, 150, 16, 8, metric, rate))
            errs.append(backward_vs_plain(FG, 2, 4, 1000, 16, 16, metric,
                                          rate, sparse=True))
    for D, Dv in ((7, 3), (40, 72), (128, 128)):
        errs.append(backward_vs_plain(FG, 2, 2, 200, D, Dv, "gaussian_kernel",
                                      0.1, 1))
    for D, Dv in SPARSE_DIMS:
        errs.append(backward_vs_plain(FG, 1, 3, 1008, D, Dv,
                                      "gaussian_kernel", 0.1, 1, sparse=True))
    out = {name: max(kernel_errors(e)[name] for e in errs)
           for name in ("B2", "B3a", "B3b")}
    walks = two_walk_cases(FG, False)
    for name, parts in (("B3a", ("dq", "dscale")), ("B3b", ("dk", "dv"))):
        out[name] = max(out[name], max(w.get(n, 0.0) for w in walks
                                       for n in parts))
    log(f"[2b] backward vs plain: {len(errs)} cases ({len(errs) - 19} at the "
        f"sparse masks), and B3a + B3b at the two walks' {len(walks)} cases "
        f"(`two_walk_cases`); max err B2 (dq, dk, dv, dscale) "
        f"{out['B2']:.3e}, B3a (dq, dscale) {out['B3a']:.3e}, B3b (dk, dv) "
        f"{out['B3b']:.3e} (tol {TOL})")
    return out


def two_walk_cases(FG, bf16):
    """[2b], [2h] B3a then B3b (``bf16``: their bf16 forms) at
    `tests.test_torch_gpu.two_walk_mask`'s cases (rows and keys past 2
    CAPR, a whole tile, a tile of one pair, an empty key strip, dead rows,
    a live row whose lse is LSE_DEAD) through `dense_two_walk_check`:
    every metric with dropout off and on at N = 1,000 (byte loads of the
    mask) and H = 4, a fold of 33 heads (two row walk head groups, five
    key walk ones) at N = 1,008, and 20 calls bit for bit; outputs
    allocated NaN-filled, each call launching each walk once. Returns the
    checks' {output: error} (bf16: the max abs error)."""
    from tests.test_torch_gpu import dense_two_walk_check
    res = [dense_two_walk_check(DEV, bf16, 2, 4, 1000, 16, 16, metric, rate)
           for metric in FG.MXU_METRICS for rate in (0.0, 0.1)]
    res.append(dense_two_walk_check(DEV, bf16, 2, 33, 1008, 16, 16,
                                    "gaussian_kernel", 0.1, seed=5))
    res.append(dense_two_walk_check(DEV, bf16, 2, 4, 1008, 16, 16,
                                    "gaussian_kernel", 0.1, seed=4,
                                    repeats=20))
    return [{n: e[0] if bf16 else e for n, e in r.items()} for r in res]


# -- phase 2h -----------------------------------------------------------------

def bf16_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0):
    """B1, B2, B3a and B3b in their bf16 forms against the plain bf16
    versions on one input (the forward walking the same plan), under the
    bf16 gates with the plain fp32 versions as the witness; dead rows
    exactly. Returns {kernel: (max abs error, max error, mean error,
    witness)} of its worst output."""
    q, k, v, do, dlse, mask, scale, seeds = small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    label = f"bf16 {metric} rate={rate} D={D} Dv={Dv}"
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    out, lse = FG.flash_geometric_fwd_bf16_kernel(
        q, k, v, mask, *plan, metric, scale, seeds, rate)
    sync()
    p_out, p_lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seeds, True, plan)
    f_out, f_lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seeds)
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
            and torch.all(p_out[dead] == 0)):
        raise AssertionError(f"{label}: dead rows differ")
    res = {"B1": max(
        bf16_gates(f"{label} out", out[~dead], p_out[~dead], f_out[~dead]),
        bf16_gates(f"{label} lse", lse[~dead], p_lse[~dead], f_lse[~dead],
                   witness=False))}
    need = metric in FG.SCALED_METRICS
    want = FG.flash_geometric_backward_plain(
        q, k, v, mask, p_out, p_lse, do, metric, scale, rate, seeds, need,
        dlse, True)
    f32 = FG.flash_geometric_backward_plain(
        q, k, v, mask, p_out, p_lse, do, metric, scale, rate, seeds, need,
        dlse)
    for fused, parts in ((True, {"B2": (0, 1, 2, 3)}),
                         (False, {"B3a": (0, 3), "B3b": (1, 2)})):
        got = FG._backward(q, k, v, mask, p_out, p_lse, do, plan, plan_t,
                           metric, scale, rate, seeds, need, fused, dlse,
                           True)
        sync()
        for name, idx in parts.items():
            res[name] = max(
                bf16_gates(f"{label} {name} {'dq dk dv dscale'.split()[i]}",
                           got[i], want[i], f32[i], witness=i < 3,
                           mean=i < 3)
                for i in idx if want[i] is not None)
    return res


def phase_small_bf16(FG):
    """[2h] every metric with dropout 0 and 0.1 at head dim 16, head
    dims 8 and 12 (sqrt(d) not a power of two) and 128 (the widest,
    whose q and k tiles the bf16 backward rounds in place: rounded copies
    beside them would pass a block's 227 KB of shared memory), dscale for
    gaussian/rbf, dead rows, an empty query tile and key strip, N not a
    multiple of the tile."""
    cases = [(metric, 16, 8, rate) for metric in FG.MXU_METRICS
             for rate in (0.0, 0.1)]
    cases += [("scaled_dot_product", 8, 8, 0.1), ("gaussian_kernel", 12, 12,
                                                   0.0),
              ("rbf_kernel", 8, 12, 0.1), ("cosine_similarity", 12, 8, 0.0),
              ("euclidean", 128, 128, 0.1)]
    worst = {}
    for metric, D, Dv, rate in cases:
        for name, r in bf16_vs_plain(FG, 2, 3, 150, D, Dv, metric,
                                     rate).items():
            worst[name] = max(worst.get(name, r), r)
    walks = two_walk_cases(FG, True)
    for name, parts in (("B3a", ("dq", "dscale")), ("B3b", ("dk", "dv"))):
        err = max(w.get(n, 0.0) for w in walks for n in parts)
        worst[name] = max(worst[name], (err,) + worst[name][1:])
    log(f"[2h] bf16 forms vs plain bf16: {len(cases)} cases, and B3a + B3b "
        f"bf16 at the two walks' {len(walks)} cases (`two_walk_cases`, "
        f"max abs err folded into theirs); worst (max abs "
        f"err, max err, mean err, witness over the largest entry) "
        + "; ".join(f"{n} {tuple(f'{x:.3e}' for x in r)}"
                    for n, r in worst.items())
        + f" (tol {BF16_MAX_TOL}, {BF16_MEAN_TOL}, witness {BF16_WITNESS}x)")
    return {n: r[0] for n, r in worst.items()}


# -- phase 2c -----------------------------------------------------------------

def biased_small_inputs(FG, G, H, N, D, Dv, metric, seed):
    """`small_inputs` plus a bias on the mask's pairs built as the model
    builds it (per-edge values added at (src, dst), every edge given
    twice, so duplicates add) and two hash seeds per snapshot."""
    q, k, v, _, _, mask, scale, seeds = small_inputs(FG, G, H, N, D, Dv,
                                                     metric, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    pairs = mask.nonzero(as_tuple=True)
    b = torch.randn(pairs[0].shape[0], device=DEV, generator=g)
    bias = torch.zeros(G, N, N, device=DEV)
    bias.index_put_(pairs, b, accumulate=True)
    bias.index_put_(pairs, 0.5 * b, accumulate=True)
    return q, k, v, mask, bias, scale, FG.biased_seeds(seeds, G, DEV)


def biased_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0,
                    sparse=False):
    """B4 against the plain lse1, and B5 against the plain second walk
    on the same lse1 (at `sparse_cases` with a N(0, 1) bias at the mask's
    pairs with ``sparse``); returns the max abs error of out, lse1 and
    lse2 over live rows after checking dead rows exactly."""
    q, k, v, mask, bias, scale, seeds = biased_small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    if sparse:
        mask = sparse_cases(G, N, seed)
        bias = torch.where(mask != 0, torch.randn(
            mask.shape, device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(seed + 2)),
            0.0)
    jlist, jcount = FG.make_block_plan(mask)
    lse1 = FG.flash_lse1_kernel(q, k, mask, jlist, jcount, metric, scale)
    p_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale)
    out, lse2 = FG.flash_biased_fwd_kernel(q, k, v, mask, bias, p_lse1,
                                           jlist, jcount, metric, scale,
                                           seeds, rate)
    p_out, p_lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias,
                                                  p_lse1, metric, scale,
                                                  rate, seeds)
    sync()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not all(torch.all(t[dead] == FG.LSE_DEAD)
               for t in (lse1, p_lse1, lse2, p_lse2)) or \
            not (torch.all(out[dead] == 0) and torch.all(p_out[dead] == 0)):
        raise AssertionError(f"{metric} rate={rate}: dead rows differ")
    err = max((out - p_out)[~dead].abs().max().item(),
              (lse1 - p_lse1)[~dead].abs().max().item(),
              (lse2 - p_lse2)[~dead].abs().max().item())
    if not err <= TOL:
        raise AssertionError(f"biased {metric} rate={rate} D={D} Dv={Dv}: "
                             f"max abs err {err} > {TOL}")
    return err


def phase_small_biased(FG):
    errs = []
    for metric in FG.MXU_METRICS:
        for rate in (0.0, 0.1):
            errs.append(biased_vs_plain(FG, 2, 3, 150, 16, 8, metric, rate))
            errs.append(biased_vs_plain(FG, 2, 4, 1000, 16, 16, metric, rate,
                                        sparse=True))
    for D, Dv in ((7, 3), (40, 72), (128, 128)):
        errs.append(biased_vs_plain(FG, 2, 2, 200, D, Dv, "gaussian_kernel",
                                    0.1, 1))
    for D, Dv in SPARSE_DIMS:
        errs.append(biased_vs_plain(FG, 1, 3, 1008, D, Dv, "gaussian_kernel",
                                    0.1, 1, sparse=True))
    log(f"[2c] B4 and B5 vs plain: {len(errs)} cases ({len(errs) - 19} at "
        f"the sparse masks), max abs err of out, lse1 and lse2 "
        f"{max(errs):.3e} (tol {TOL})")
    return max(errs)


# -- phase 2d -----------------------------------------------------------------

def biased_bwd_kernels(FG, q, k, v, mask, bias, do, lse1, lse2, delta2,
                       plan, plan_t, metric, scale, seeds, rate, need,
                       bf16=False):
    """The row walk, then the key walk on its delta1, in fp32 or with
    ``bf16`` their bf16 forms: (delta1, dB, dq, dscale, dk, dv)."""
    common = (q, k, v, mask, bias, do, lse1, lse2, delta2)
    row, key = biased_kernels(FG, bf16)[2:]
    d1, db, dq, dsc = row(*common, *plan, metric, scale, seeds, rate, need)
    dk, dv = key(*common, d1, *plan_t, metric, scale, seeds, rate)
    return d1, db, dq, dsc, dk, dv


def biased_bwd_plain_parts(FG, common, metric, scale, seeds, rate, need,
                           bf16=False):
    """The plain parts (delta1, dB, dq, dscale, dk, dv) on ``common`` =
    (q, k, v, mask, bias, do, lse1, lse2, delta2)."""
    d1, db = FG.flash_biased_bwd_pre_plain(*common, metric, scale, rate,
                                           seeds, bf16)
    dq, dsc = FG.flash_biased_bwd_dq_plain(*common, d1, metric, scale, rate,
                                           seeds, need, bf16)
    dk, dv = FG.flash_biased_bwd_dkv_plain(*common, d1, metric, scale, rate,
                                           seeds, bf16)
    return d1, db, dq, dsc, dk, dv


def biased_bwd_errors(FG, label, got, q, k, v, mask, bias, do, lse1, lse2,
                      delta2, metric, scale, seeds, rate, need, bf16=False):
    """{"B6+B7a": the row walk's error, "B7b": the key walk's} of the
    walks' outputs ``got`` against the plain parts on the same inputs, dB
    at the mask's pairs (the only ones the row walk writes): each output's
    max abs error over its largest entry (at least 1), raising past TOL or
    on a non-finite output. ``bf16``: the bf16 walks against the plain
    bf16 parts under the bf16 gates (the plain fp32 parts the witness;
    dscale the max gate alone); the errors are then each walk's worst
    (max abs error, max error, mean error, witness)."""
    d1, db, dq, dsc, dk, dv = got
    common = (q, k, v, mask, bias, do, lse1, lse2, delta2)
    plain = biased_bwd_plain_parts(FG, common, metric, scale, seeds, rate,
                                   need, bf16)
    p_d1, p_db, p_dq, p_dsc, p_dk, p_dv = plain
    sync()
    on = mask != 0
    if bf16:
        f32 = biased_bwd_plain_parts(FG, common, metric, scale, seeds, rate,
                                     need)
        g = {n: bf16_gates(f"{label} {n}", a, b, c) for n, a, b, c in (
            ("delta1", d1, p_d1, f32[0]), ("dB", db[on], p_db[on], f32[1][on]),
            ("dq", dq, p_dq, f32[2]), ("dk", dk, p_dk, f32[4]),
            ("dv", dv, p_dv, f32[5]))}
        if need:
            g["dscale"] = bf16_gates(f"{label} dscale", dsc, p_dsc, f32[3],
                                     witness=False, mean=False)
        return {"B6+B7a": max(g["delta1"], g["dB"], g["dq"],
                              g.get("dscale", g["dq"])),
                "B7b": max(g["dk"], g["dv"])}
    for name, t in (("delta1", d1), ("dq", dq), ("dk", dk), ("dv", dv),
                    ("dB", db[on])):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    err = {"B6+B7a": max(rel_err(d1, p_d1), rel_err(db[on], p_db[on]),
                         rel_err(dq, p_dq),
                         rel_err(dsc, p_dsc) if need else 0.0),
           "B7b": max(rel_err(dk, p_dk), rel_err(dv, p_dv))}
    if not max(err.values()) <= TOL:
        raise AssertionError(f"{label}: errors {err} > {TOL}")
    return err


def biased_bwd_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0,
                        sparse=False, repeat=False):
    """The fp32 row and key walks against the plain parts on 2c's inputs
    (at `sparse_cases` with a N(0, 1) bias at the mask's pairs with
    ``sparse``), the plain forward's statistics and the cotangent of
    `small_inputs`; with ``repeat``, a second call must give the same bits
    (dB at the mask's pairs)."""
    q, k, v, mask, bias, scale, seeds = biased_small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    if sparse:
        mask = sparse_cases(G, N, seed)
        bias = torch.where(mask != 0, torch.randn(
            mask.shape, device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(seed + 2)),
            0.0)
    do = small_inputs(FG, G, H, N, D, Dv, metric, seed)[3]
    need = metric in FG.SCALED_METRICS
    lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale)
    out, lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                              metric, scale, rate, seeds)
    delta2 = (do * out).sum(-1)
    args = (q, k, v, mask, bias, do, lse1, lse2, delta2)
    plans = FG.make_block_plans_from_mask(mask)
    got = biased_bwd_kernels(FG, *args, *plans, metric, scale, seeds, rate,
                             need)
    label = (f"biased {metric} rate={rate} G={G} H={H} N={N} D={D} Dv={Dv}"
             + (" sparse" if sparse else ""))
    if repeat:
        on = mask != 0
        again = biased_bwd_kernels(FG, *args, *plans, metric, scale, seeds,
                                   rate, need)
        for i, (a, b) in enumerate(zip(got, again)):
            if a is not None and not torch.equal(
                    a[on] if i == 1 else a, b[on] if i == 1 else b):
                raise AssertionError(f"{label}: output {i} differs between "
                                     f"two calls")
    return biased_bwd_errors(FG, label, got, *args, metric, scale, seeds,
                             rate, need)


def phase_small_biased_bwd(FG):
    """[2d] The fp32 row walk (B6 and B7a) and key walk (B7b): 2c's grid,
    every metric with dropout 0 and 0.1 on the random masks and at the
    sparse masks, head dims up to (128, 128), a fold past 32 heads (two
    row walk launches adding into dB), two calls bit for bit."""
    errs = []
    for metric in FG.MXU_METRICS:
        for rate in (0.0, 0.1):
            errs.append(biased_bwd_vs_plain(FG, 2, 3, 150, 16, 8, metric,
                                            rate))
            errs.append(biased_bwd_vs_plain(FG, 2, 4, 1000, 16, 16, metric,
                                            rate, sparse=True,
                                            repeat=rate > 0))
    for D, Dv in ((7, 3), (40, 72), (128, 128)):
        errs.append(biased_bwd_vs_plain(FG, 2, 2, 200, D, Dv,
                                        "gaussian_kernel", 0.1, 1))
    for D, Dv in SPARSE_DIMS:
        errs.append(biased_bwd_vs_plain(FG, 1, 3, 1008, D, Dv,
                                        "gaussian_kernel", 0.1, 1,
                                        sparse=True))
    errs.append(biased_bwd_vs_plain(FG, 2, 40, 600, 16, 16, "rbf_kernel",
                                    0.1, 2, sparse=True, repeat=True))
    out = {name: max(e[name] for e in errs) for name in ("B6+B7a", "B7b")}
    log(f"[2d] the fp32 row walk (B6 and B7a) and key walk (B7b) vs plain: "
        f"{len(errs)} cases ({len(errs) - 19} at the sparse masks, 9 of "
        f"them called twice bit for bit); max err row walk (delta1, dB at "
        f"the mask's pairs, dq, dscale) {out['B6+B7a']:.3e}, key walk (dk, "
        f"dv) {out['B7b']:.3e} (tol {TOL})")
    return out


# -- phase 2i -----------------------------------------------------------------

def biased_bf16_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0):
    """B4, B5 and the backward's two walks in their bf16 forms against the
    plain bf16 versions on 2c's inputs and 2d's cotangent, under the bf16
    gates (the plain fp32 versions the witness): lse1, then out and lse2
    (B5 on the plain lse1, the plain B5 walking the same plan), then the
    backward parts on the plain bf16 forward's statistics (dB at the
    mask's pairs); dead rows exactly.
    Returns {kernel: (max abs error, max error, mean error, witness)} of
    its worst output."""
    q, k, v, mask, bias, scale, seeds = biased_small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    do = small_inputs(FG, G, H, N, D, Dv, metric, seed)[3]
    label = f"bf16 biased {metric} rate={rate} D={D} Dv={Dv}"
    need = metric in FG.SCALED_METRICS
    b4, b5 = biased_kernels(FG, True)[:2]
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    lse1 = b4(q, k, mask, *plan, metric, scale)
    p_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale, True)
    f_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale)
    fwd = (q, k, v, mask, bias, p_lse1, metric, scale, rate, seeds)
    out, lse2 = b5(q, k, v, mask, bias, p_lse1, *plan, metric, scale, seeds,
                   rate)
    p_out, p_lse2 = FG.flash_biased_forward_plain(*fwd, True, plan)
    f_out, f_lse2 = FG.flash_biased_forward_plain(*fwd)
    sync()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (all(torch.all(t[dead] == FG.LSE_DEAD)
                for t in (lse1, lse2, p_lse2))
            and torch.all(out[dead] == 0) and torch.all(p_out[dead] == 0)):
        raise AssertionError(f"{label}: dead rows differ")
    live = ~dead
    res = {"B4": bf16_gates(f"{label} lse1", lse1[live], p_lse1[live],
                            f_lse1[live], witness=False),
           "B5": max(bf16_gates(f"{label} out", out[live], p_out[live],
                                f_out[live]),
                     bf16_gates(f"{label} lse2", lse2[live], p_lse2[live],
                                f_lse2[live], witness=False))}
    delta2 = (do * p_out).sum(-1)
    args = (q, k, v, mask, bias, do, p_lse1, p_lse2, delta2)
    got = biased_bwd_kernels(FG, *args, plan, plan_t, metric, scale, seeds,
                             rate, need, True)
    res.update(biased_bwd_errors(FG, label, got, *args, metric, scale, seeds,
                                 rate, need, True))
    return res


def phase_small_biased_bf16(FG):
    """[2i] 2c/2d's grid for the bf16 forms of B4-B7b: every metric with
    dropout 0 and 0.1 at (D, Dv) = (16, 8), and (16, 16), (8, 8),
    (12, 12), (7, 3), (128, 128) (sqrt(d) not a power of two, D != Dv,
    the widest, whose tiles are rounded in place), dscale for
    gaussian/rbf, dead rows, an empty query tile and key strip, N not a
    multiple of the tile."""
    cases = [(metric, 16, 8, rate, 2, 3, 150, 0) for metric in FG.MXU_METRICS
             for rate in (0.0, 0.1)]
    cases += [(metric, D, Dv, 0.1, 2, 2, 200, 1) for metric, D, Dv in (
        ("scaled_dot_product", 16, 16), ("gaussian_kernel", 8, 8),
        ("rbf_kernel", 12, 12), ("euclidean", 7, 3),
        ("gaussian_kernel", 128, 128))]
    worst = {}
    for metric, D, Dv, rate, G, H, N, seed in cases:
        for name, r in biased_bf16_vs_plain(FG, G, H, N, D, Dv, metric, rate,
                                            seed).items():
            worst[name] = max(worst.get(name, r), r)
    log(f"[2i] bf16 forms of B4, B5 and the row and key walks (B6+B7a, "
        f"B7b) vs plain bf16: {len(cases)} cases; worst "
        f"(max abs err, max err, mean err, witness over the largest entry) "
        + "; ".join(f"{n} {tuple(f'{x:.3e}' for x in r)}"
                    for n, r in worst.items())
        + f" (tol {BF16_MAX_TOL}, {BF16_MEAN_TOL}, witness {BF16_WITNESS}x)")
    return {n: r[0] for n, r in worst.items()}


# -- phase 3 ------------------------------------------------------------------

def make_sequence(rng, n, e, t_len):
    return [{"x": rng.standard_normal((n, F_NODE)).astype(np.float32),
             "edge_index": np.stack([rng.integers(0, n, e),
                                     rng.integers(0, n, e)]),
             "node_ids": np.arange(n), "timestep": float(t)}
            for t in range(t_len)]


def model_config(tt, bf16=False):
    """bench.py's 10K flash model (:37, :140-151), with ``bf16_matmul``
    as its bf16 step sets it."""
    return tt.TAGANConfig(hidden_dim=64, num_heads=4, num_layers=2,
                          node_feature_dim=F_NODE, output_dim=1,
                          loss_type="bce", dropout=0.0,
                          spatial_backend="flash", bf16_matmul=bf16)


def layer0_inputs(FG, model, batch, n):
    """Layer 0's kernel inputs of a packed batch, its B*T snapshots folded
    as the model folds them: (q, k, v, mask, jlist, jcount, ilist,
    icount)."""
    from tagan_torch.nn.model import flash_structures
    attn = model.geometric_layers["layer_0"].attn
    with torch.no_grad():
        q, k, v = attn._qkv(model.node_embedding(batch.x))   # [B, T, H, N, Dh]
        mask, plan, plan_t = flash_structures(
            batch.edge_src, batch.edge_dst, batch.edge_mask, batch.node_mask,
            n)
    G = q.shape[0] * q.shape[1]
    return tuple(t.reshape(G, *t.shape[2:]).contiguous()
                 for t in (q, k, v, mask, *plan, *plan_t))


def phase_serve(tt, FG, bf16=False):
    """[3], and with ``bf16`` [3e]: the 10K model with bf16_matmul=True,
    B1's bf16 form held to the plain bf16 version under the bf16 gates,
    and the fp32 model's logits on the same request beside it."""
    tag = "3e" if bf16 else "3"
    fwd = flash_kernels(FG, bf16)[0]
    cfg = model_config(tt, bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    dims = (T_FULL, N_FULL, E_FULL, 0)
    pred = tt.Predictor(model, dims=dims, batch_size=SEQS_PER_REQUEST)
    rng = np.random.default_rng(0)
    requests = [[make_sequence(rng, N_FULL, E_FULL, T_FULL)
                 for _ in range(SEQS_PER_REQUEST)] for _ in range(REQUESTS)]
    pred.warmup()
    sync()

    torch.cuda.reset_peak_memory_stats()
    reset_counts(FG)
    lat, probs = [], []
    for req in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_proba(req))   # host copy: synchronises
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = counts(FG)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launched[fwd.name]
    expected = cfg.num_layers * REQUESTS      # one launch per layer per batch
    probs = np.concatenate(probs)
    finite = bool(np.isfinite(probs).all())
    log(f"[{tag}] request latency ms: {[round(x, 3) for x in lat]}; "
        f"sequences/s {REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3):.3f}; "
        f"peak memory {peak_gb:.3f} GB; kernel launches {launched} (expected "
        f"{fwd.name} {expected}, no backward); probabilities finite: "
        f"{finite}, shape {probs.shape}")
    if launches != expected or launches == 0 or \
            sum(launched.values()) != launches:
        raise AssertionError(f"launches {launched}, expected {fwd.name} "
                             f"{expected}")
    if not finite or probs.shape != (REQUESTS * SEQS_PER_REQUEST, 1):
        raise AssertionError("bad probabilities")

    # forward alone on a packed batch (no host packing)
    batch = tt.batch_sequences(pred._pack(requests[0])).to(DEV)
    with torch.inference_mode():
        model(batch)
        sync()
        t0 = time.perf_counter()
        logits = model(batch).logits
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    log(f"[{tag}] forward on a packed request: {fwd_ms:.3f} ms")
    gap = None
    if bf16:
        f32 = tt.TAGAN(model_config(tt), device=DEV,
                       generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            gap = (logits - f32(batch).logits).abs().max().item()
        del f32
        log(f"[{tag}] logits of the fp32 model on the same request and "
            f"weights: max abs gap {gap:.4e} (logits {logits.ravel()})")

    H = cfg.num_heads
    folded = layer0_inputs(FG, model, batch, N_FULL)
    G = folded[0].shape[0]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.inference_mode():
        layer_ms = cuda_ms(lambda: fwd(*folded[:6], "euclidean", ones,
                                       seeds, 0.0), 3)
        # one snapshot at full width against the plain version; copies,
        # so that the folded mask is freed when this phase returns
        args = tuple(t[:1].clone() for t in folded)
        out, lse = fwd(*args[:6], "euclidean", ones, seeds[:1], 0.0)
        p_out, p_lse = FG.flash_geometric_forward_plain(
            *args[:4], "euclidean", ones, 0.0, seeds[:1], bf16, args[4:6])
        sync()
        if bf16:
            f_out, f_lse = FG.flash_geometric_forward_plain(
                *args[:4], "euclidean", ones, 0.0, seeds[:1])
    share = cfg.num_layers * layer_ms / fwd_ms
    log(f"[{tag}] one layer's launch over the {G} folded snapshots: "
        f"{layer_ms:.3f} ms; {cfg.num_layers} layers = {share:.3f} of the "
        f"forward")
    fold = fold_times_b1(fwd, folded, ones, seeds, bf16)
    del folded
    if bf16:
        gates = max(bf16_gates("full-width out", out, p_out, f_out),
                    bf16_gates("full-width lse", lse, p_lse, f_lse,
                               witness=False))
        err = gates[0]
        log(f"[{tag}] layer-0 bf16 kernel vs plain bf16 at N={N_FULL}: "
            f"(max abs err, max err, mean err, witness) "
            f"{tuple(f'{x:.3e}' for x in gates)}")
    else:
        err = max((out - p_out).abs().max().item(),
                  (lse - p_lse).abs().max().item())
        log(f"[{tag}] layer-0 kernel vs plain at N={N_FULL}: max abs err "
            f"{err:.3e}")
        if not err <= TOL:
            raise AssertionError(f"full-width kernel error {err} > {TOL}")
    return dict(latency_ms=lat, launches=launches, expected=expected,
                forward_ms=fwd_ms, layer_launch_ms=layer_ms,
                kernel_share_of_forward=share, full_err=err, args=args,
                probs=probs.ravel().tolist(),
                peak_gb=peak_gb, fp32_logits_gap=gap, fold=fold,
                sequences_per_s=REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3))


def fold_times_b1(fwd, folded, ones, seeds, bf16):
    """[5] and with ``bf16`` [5g]: B1 (its bf16 form with ``bf16``) at the
    grid its path launches, one layer's G folded snapshots of 3's (3e's)
    request, per snapshot: at the model's euclidean metric and at the
    scaled-dot metric, beside ``scaled_dot_product_attention`` with the
    boolean mask over the same fold (the same function there) on fp32 q,
    k, v (bf16 with ``bf16``). The bf16 library call is held to B1 bf16
    within FLEX_BF16_TOL on the rows with a valid key; the fp32 one is
    held to B1 within TOL there, else its time is recorded as null with
    the reason."""
    G = folded[0].shape[0]
    sdp = "scaled_dot_product"
    tag, name = ("5g", "B1 bf16") if bf16 else ("5", "B1")
    lq, lk, lv = (t.bfloat16() if bf16 else t for t in folded[:3])
    bmask = folded[3][:, None] != 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.inference_mode():
        ms = cuda_ms(lambda: fwd(*folded[:6], "euclidean", ones, seeds,
                                 0.0), 10)
        sdp_ms = cuda_ms(lambda: fwd(*folded[:6], sdp, ones, seeds, 0.0), 10)
        lib_ms = cuda_ms(lambda: sdpa(lq, lk, lv, attn_mask=bmask), 10)
        out = fwd(*folded[:6], sdp, ones, seeds, 0.0)[0]
        ref = sdpa(lq, lk, lv, attn_mask=bmask).float()
        live = bmask.any(-1).expand(-1, out.shape[1], -1)
        err = rel_err(out[live], ref[live])
    del lq, lk, lv, bmask, out, ref
    tol = FLEX_BF16_TOL if bf16 else TOL
    if bf16 and not err <= tol:
        raise AssertionError(f"sdpa on bf16 inputs differs from B1 bf16 at "
                             f"the scaled-dot metric: {err} > {tol}")
    error = None if err <= tol else \
        f"sdpa fp32 differs from B1 at the scaled-dot metric: {err} > {tol}"
    res = dict(G=G, ms=ms / G, sdp_ms=sdp_ms / G,
               library_ms=None if error else lib_ms / G, library_err=err,
               library_error=error)
    log(f"[{tag}] {name} over the {G} folded snapshots of the layer, per "
        f"snapshot: euclidean {res['ms']:.5f} ms, scaled-dot "
        f"{res['sdp_ms']:.5f} ms; sdpa {'bf16' if bf16 else 'fp32'} over the "
        f"same fold {lib_ms / G:.5f} ms a snapshot, {err:.3e} from {name} at "
        f"the scaled-dot metric" + (f" ({error})" if error else ""))
    return res


# -- phase 4 ------------------------------------------------------------------

def phase_mid(tt, FG):
    cfg = model_config(tt)
    rng = np.random.default_rng(1)
    req = [make_sequence(rng, N_MID, 16 * N_MID, T_FULL)
           for _ in range(SEQS_PER_REQUEST)]
    dims = (T_FULL, N_MID, 16 * N_MID, 0)
    got, launched, nodes = {}, {}, {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        model = tt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        pred = tt.Predictor(model, dims=dims)
        before = FG.flash_geometric_fwd_kernel.launches
        got[side] = pred.predict_proba(req)
        launched[side] = FG.flash_geometric_fwd_kernel.launches - before
        # the per-node features before pooling, where a fault in one row
        # tile of the kernel is not averaged away
        batch = tt.batch_sequences(pred._pack(req)).to(dev)
        with torch.inference_mode():
            nodes[side] = model.encode_spatial(batch).cpu()
    err = float(np.abs(got["card"] - got["cpu"]).max())
    node_err = (nodes["card"] - nodes["cpu"]).abs().max().item()
    log(f"[4] N={N_MID} probabilities card vs cpu: "
        f"{got['card'].ravel().tolist()} vs {got['cpu'].ravel().tolist()}; "
        f"max abs err {err:.3e}; per-node features after the attention "
        f"layers {tuple(nodes['cpu'].shape)}: max abs err {node_err:.3e}; "
        f"kernel launches card {launched['card']}, cpu {launched['cpu']}")
    if launched != {"card": cfg.num_layers, "cpu": 0}:
        raise AssertionError(f"launches {launched}")
    if not (err <= TOL and node_err <= TOL):
        raise AssertionError(f"end-to-end error {err}, per-node error "
                             f"{node_err} > {TOL}")
    return dict(prob_err=err, node_err=node_err)


# -- phase 3b -----------------------------------------------------------------

def make_edge_sequence(rng, n, e, t_len, unique=False):
    """`make_sequence` with N(0, 1) edge features [e, F_EDGE]; with
    ``unique`` the e edges of a snapshot are distinct and none is a self
    edge (the flash model adds a duplicate's biases into one pair, the
    csr model keeps both copies, so they agree only without them)."""
    seq = []
    for t in range(t_len):
        x = rng.standard_normal((n, F_NODE)).astype(np.float32)
        if unique:
            pick = rng.choice(n * (n - 1), e, replace=False)
            src, dst = pick // (n - 1), pick % (n - 1)
            ei = np.stack([src, dst + (dst >= src)])
        else:
            ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
        seq.append({"x": x, "edge_index": ei, "node_ids": np.arange(n),
                    "edge_attr": rng.standard_normal(
                        (e, F_EDGE)).astype(np.float32),
                    "timestep": float(t)})
    return seq


def edge_model_config(tt, backend="flash", bf16=False):
    """`model_config` with ``bench_tgn.py``'s edge features, and
    ``bf16_matmul`` with ``bf16``."""
    return tt.TAGANConfig(hidden_dim=64, num_heads=4, num_layers=2,
                          node_feature_dim=F_NODE, edge_feature_dim=F_EDGE,
                          use_edge_features=True, output_dim=1,
                          loss_type="bce", dropout=0.0,
                          spatial_backend=backend, bf16_matmul=bf16)


def layer0_biased_inputs(FG, model, batch, n):
    """Layer 0's B4/B5 inputs of a packed batch, its B*T snapshots
    folded: (q, k, v, mask, bias, jlist, jcount), and the csr form of
    its first snapshot: (edge_q, edge_k, edge_mask, edge_bias) with the
    self loops appended."""
    from tagan_torch.nn.model import edge_bias_matrix
    from tagan_torch.ops.sparse import add_self_loops
    q, k, v, mask, jlist, jcount, _, _ = layer0_inputs(FG, model, batch, n)
    G = q.shape[0]
    with torch.no_grad():
        b = model.geometric_layers["layer_0"].edge_bias(
            model.edge_embedding(batch.edge_attr))[..., 0]
        bias = edge_bias_matrix(b, batch.edge_src, batch.edge_dst,
                                batch.edge_mask, n).reshape(G, n, n)
        first = (batch.edge_src[:1, 0], batch.edge_dst[:1, 0],
                 batch.edge_mask[:1, 0])
        eq, ek, em = add_self_loops(*first, batch.node_mask[:1, 0])
        b0 = torch.where(first[2], b[:1, 0], torch.zeros_like(b[:1, 0]))
        eb = torch.cat([b0, b0.new_zeros(1, n)], -1)
    return (q, k, v, mask, bias, jlist, jcount), (eq, ek, em, eb)


def phase_serve_edge(tt, FG, bf16=False):
    """[3b], and with ``bf16`` [3f]: the edge-feature model with
    bf16_matmul=True, the bf16 forms of B4 and B5 held to the plain bf16
    versions under the bf16 gates, and the fp32 model's logits on the
    same request beside it."""
    tag = "3f" if bf16 else "3b"
    b4, b5 = biased_kernels(FG, bf16)[:2]
    cfg = edge_model_config(tt, bf16=bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    pred = tt.Predictor(model, dims=(T_FULL, N_FULL, E_FULL, F_EDGE),
                        batch_size=SEQS_PER_REQUEST)
    rng = np.random.default_rng(4)
    requests = [[make_edge_sequence(rng, N_FULL, E_FULL, T_FULL)
                 for _ in range(SEQS_PER_REQUEST)] for _ in range(REQUESTS)]
    pred.warmup()
    sync()

    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts(FG)
    lat, probs = [], []
    for req in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_proba(req))   # host copy: synchronises
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = counts(FG)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    expected = {k.name: 0 for k in FG.KERNELS}
    for kern in (b4, b5):
        expected[kern.name] = cfg.num_layers * REQUESTS
    probs = np.concatenate(probs)
    finite = bool(np.isfinite(probs).all())
    log(f"[{tag}] edge features (Fe={F_EDGE}"
        f"{', bf16_matmul=True' if bf16 else ''}): request latency ms "
        f"{[round(x, 3) for x in lat]}; sequences/s "
        f"{REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3):.3f}; peak device "
        f"memory of the requests {peak_gb:.3f} GB above the {held_gb:.3f} GB "
        f"held before them; kernel launches {launched} (expected "
        f"{expected}); probabilities finite: {finite}, shape {probs.shape}")
    if launched != expected:
        raise AssertionError(f"launches {launched} != {expected}")
    if not finite or probs.shape != (REQUESTS * SEQS_PER_REQUEST, 1):
        raise AssertionError("bad probabilities")

    batch = tt.batch_sequences(pred._pack(requests[0])).to(DEV)
    with torch.inference_mode():
        model(batch)
        sync()
        t0 = time.perf_counter()
        logits = model(batch).logits
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        # one layer's bias build: the per-edge projection scattered into
        # the folded [G, N, N] f32 matrix
        from tagan_torch.nn.model import edge_bias_matrix
        ea = model.edge_embedding(batch.edge_attr)
        eb = model.geometric_layers["layer_0"].edge_bias
        build_ms = cuda_ms(lambda: edge_bias_matrix(
            eb(ea)[..., 0], batch.edge_src, batch.edge_dst, batch.edge_mask,
            N_FULL), 3)
        del ea
    log(f"[{tag}] forward on a packed request: {fwd_ms:.3f} ms; one layer's "
        f"bias build ({tuple(batch.edge_src.shape[:2])} snapshots of "
        f"[{N_FULL}, {N_FULL}] f32): {build_ms:.3f} ms")
    gap = None
    if bf16:
        f32 = tt.TAGAN(edge_model_config(tt), device=DEV,
                       generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            gap = (logits - f32(batch).logits).abs().max().item()
        del f32
        log(f"[{tag}] logits of the fp32 model on the same request and "
            f"weights: max abs gap {gap:.4e} (logits {logits.ravel()})")

    H = cfg.num_heads
    folded, graph = layer0_biased_inputs(FG, model, batch, N_FULL)
    q, k, v, mask, bias, jlist, jcount = folded
    G = q.shape[0]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    # one snapshot, copied (not a view, so that ``del folded`` frees the
    # rest) outside inference mode: phase 5b hands it to torch.compile
    args = tuple(t[:1].clone() for t in folded)
    q1, k1, v1, m1, bias1, jl1, jc1 = args
    with torch.inference_mode():
        b4_ms = cuda_ms(lambda: b4(q, k, mask, jlist, jcount, "euclidean",
                                   ones), 3)
        lse1 = b4(q, k, mask, jlist, jcount, "euclidean", ones)
        b5_ms = cuda_ms(lambda: b5(q, k, v, mask, bias, lse1, jlist, jcount,
                                   "euclidean", ones, seeds, 0.0), 3)
        # [5b] / [5h] B4 and B5 (their bf16 forms with ``bf16``) at the
        # grid their path launches, per snapshot, at the model's metric
        # and at the scaled-dot one
        sdp = "scaled_dot_product"
        l1_sdp = b4(q, k, mask, jlist, jcount, sdp, ones)
        fold = {"B4": dict(G=G, ms=cuda_ms(lambda: b4(
            q, k, mask, jlist, jcount, "euclidean", ones), 10) / G,
            sdp_ms=cuda_ms(lambda: b4(q, k, mask, jlist, jcount, sdp,
                                      ones), 10) / G),
            "B5": dict(G=G, ms=cuda_ms(lambda: b5(
                q, k, v, mask, bias, lse1, jlist, jcount, "euclidean",
                ones, seeds, 0.0), 10) / G, sdp_ms=cuda_ms(lambda: b5(
                    q, k, v, mask, bias, l1_sdp, jlist, jcount, sdp, ones,
                    seeds, 0.0), 10) / G)}
        del l1_sdp
        fold_err = None
        if not bf16:
            # the fp32 walks over the fold, each snapshot against the
            # plain versions (B5 on the walk's lse1)
            out_f, lse2_f = b5(q, k, v, mask, bias, lse1, jlist, jcount,
                               "euclidean", ones, seeds, 0.0)
            fold_err = 0.0
            for g in range(G):
                one = (q[g:g + 1], k[g:g + 1], v[g:g + 1], mask[g:g + 1])
                p_l1 = FG.flash_lse1_plain(*one[:2], one[3], "euclidean",
                                           ones)
                p_o, p_l2 = FG.flash_biased_forward_plain(
                    *one, bias[g:g + 1], lse1[g:g + 1], "euclidean", ones,
                    0.0, seeds[g:g + 1])
                fold_err = max(fold_err, rel_err(lse1[g:g + 1], p_l1),
                               rel_err(out_f[g:g + 1], p_o),
                               rel_err(lse2_f[g:g + 1], p_l2))
            del out_f, lse2_f, p_l1, p_o, p_l2
            if not fold_err <= TOL:
                raise AssertionError(f"B4/B5 over the fold vs plain: "
                                     f"{fold_err} > {TOL}")
        log(f"[{'5h' if bf16 else '5b'}] over the {G} folded snapshots of "
            f"{tag}'s layer, per snapshot: " + "; ".join(
                f"{n}{' bf16' if bf16 else ''} euclidean {f['ms']:.5f} ms, "
                f"scaled-dot {f['sdp_ms']:.5f} ms" for n, f in fold.items())
            + ("" if bf16 else f"; each snapshot vs plain: max err of lse1, "
               f"out and lse2 {fold_err:.3e} (tol {TOL})"))
        # one snapshot at full width against the plain versions (bf16:
        # the plain B5 walks the same plan)
        lse1_k = b4(q1, k1, m1, jl1, jc1, "euclidean", ones)
        p_lse1 = FG.flash_lse1_plain(q1, k1, m1, "euclidean", ones, bf16)
        out, lse2 = b5(q1, k1, v1, m1, bias1, p_lse1, jl1, jc1, "euclidean",
                       ones, seeds[:1], 0.0)
        fwd = (q1, k1, v1, m1, bias1, p_lse1, "euclidean", ones, 0.0,
               seeds[:1])
        p_out, p_lse2 = FG.flash_biased_forward_plain(*fwd, bf16, (jl1, jc1))
        if bf16:
            f_lse1 = FG.flash_lse1_plain(q1, k1, m1, "euclidean", ones)
            f_out, f_lse2 = FG.flash_biased_forward_plain(*fwd)
        sync()
    del folded, q, k, v, mask, bias, lse1
    share = cfg.num_layers * (b4_ms + b5_ms) / fwd_ms
    log(f"[{tag}] one layer's launches over the {G} folded snapshots: B4 "
        f"{b4_ms:.3f} ms, B5 {b5_ms:.3f} ms; {cfg.num_layers} layers = "
        f"{share:.3f} of the forward")
    if bf16:
        # no row of the full-width snapshot is dead (every node keeps its
        # diagonal)
        gates = max(bf16_gates("full-width lse1", lse1_k, p_lse1, f_lse1,
                               witness=False),
                    bf16_gates("full-width out", out, p_out, f_out),
                    bf16_gates("full-width lse2", lse2, p_lse2, f_lse2,
                               witness=False))
        err = gates[0]
        log(f"[{tag}] layer-0 bf16 B4 and B5 vs plain bf16 at N={N_FULL}: "
            f"worst of lse1, out and lse2 (max abs err, max err, mean err, "
            f"witness) {tuple(f'{x:.3e}' for x in gates)}")
    else:
        err = max((lse1_k - p_lse1).abs().max().item(),
                  (out - p_out).abs().max().item(),
                  (lse2 - p_lse2).abs().max().item())
        log(f"[{tag}] layer-0 B4 and B5 vs plain at N={N_FULL}: max abs err "
            f"of lse1, out and lse2 {err:.3e}")
        if not err <= TOL:
            raise AssertionError(f"full-width biased kernel error {err} > "
                                 f"{TOL}")
    return dict(latency_ms=lat, launches=launched, forward_ms=fwd_ms,
                peak_memory_gb=peak_gb, held_gb=held_gb,
                bias_build_ms=build_ms,
                b4_layer_launch_ms=b4_ms, b5_layer_launch_ms=b5_ms,
                kernel_share_of_forward=share, full_err=err, args=args,
                graph=graph, fp32_logits_gap=gap, fold=fold,
                fold_err=fold_err,
                sequences_per_s=REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3))


# -- phase 4b -----------------------------------------------------------------

def phase_mid_edge(tt, FG):
    """The edge-feature model at 1,000 nodes: the flash model on the card
    (B4, B5) against the CPU (plain versions), and against the csr model
    on the card (an O(E) formula of its own), on distinct non-loop
    edges."""
    rng = np.random.default_rng(5)
    req = [make_edge_sequence(rng, N_MID, 16 * N_MID, T_FULL, unique=True)
           for _ in range(SEQS_PER_REQUEST)]
    dims = (T_FULL, N_MID, 16 * N_MID, F_EDGE)
    got, nodes, launched = {}, {}, {}
    for side, backend, dev in (("card", "flash", DEV), ("cpu", "flash", "cpu"),
                               ("csr", "csr", DEV)):
        model = tt.TAGAN(edge_model_config(tt, backend), device=dev,
                         generator=torch.Generator().manual_seed(0))
        pred = tt.Predictor(model, dims=dims)
        before = counts(FG)
        got[side] = pred.predict_proba(req)
        launched[side] = {n: c - before[n] for n, c in counts(FG).items()
                          if c != before[n]}
        batch = tt.batch_sequences(pred._pack(req)).to(dev)
        with torch.inference_mode():
            nodes[side] = model.encode_spatial(batch).cpu()
    err = float(np.abs(got["card"] - got["cpu"]).max())
    node_err = (nodes["card"] - nodes["cpu"]).abs().max().item()
    csr_err = float(np.abs(got["card"] - got["csr"]).max())
    csr_node_err = (nodes["card"] - nodes["csr"]).abs().max().item()
    log(f"[4b] N={N_MID}, edge features: probabilities card vs cpu max abs "
        f"err {err:.3e}, per-node features {node_err:.3e}; flash vs csr on "
        f"the card: probabilities {csr_err:.3e}, per-node features "
        f"{csr_node_err:.3e}; launches {launched}")
    want = {"card": {FG.flash_lse1_kernel.name: 2,
                     FG.flash_biased_fwd_kernel.name: 2},
            "cpu": {}, "csr": {}}
    if launched != want:
        raise AssertionError(f"launches {launched} != {want}")
    if not (err <= TOL and node_err <= TOL):
        raise AssertionError(f"card vs cpu: {err}, per-node {node_err} > "
                             f"{TOL}")
    if not (csr_err <= TOL_CSR and csr_node_err <= TOL_CSR):
        raise AssertionError(f"flash vs csr: {csr_err}, per-node "
                             f"{csr_node_err} > {TOL_CSR}")
    return dict(prob_err=err, node_err=node_err, csr_prob_err=csr_err,
                csr_node_err=csr_node_err)


# -- phase 5 ------------------------------------------------------------------

def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                bytes=nbytes, flops=flops)


def phase_times(FG, args):
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(G, dtype=torch.int32, device=DEV)
    fwd = FG.flash_geometric_fwd_kernel

    def kernel():
        fwd(q, k, v, mask, jlist, jcount, "euclidean", ones, seed0, 0.0)

    def kernel_sdp():
        fwd(q, k, v, mask, jlist, jcount, "scaled_dot_product", ones, seed0,
            0.0)

    def plain():
        FG.flash_geometric_forward_plain(q, k, v, mask, "euclidean", ones,
                                         0.0, seed0)
    bmask = (mask[:, None] != 0)

    def library():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bmask)

    with torch.inference_mode():
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kernel, 20)
        k2 = cuda_ms(kernel, 20)
        p2 = cuda_ms(plain, 5)
        lib = cuda_ms(library, 20)
        k_sdp = cuda_ms(kernel_sdp, 20)
    with torch.no_grad():
        out, lse = fwd(q, k, v, mask, jlist, jcount, "euclidean", ones,
                       seed0, 0.0)
    pairs = int((mask != 0).sum().item())                 # valid (i, j)
    walk_pairs = int(jcount.sum().item()) * FG.BLOCK_M * FG.BLOCK_N
    qkv = 4 * G * H * N * (2 * D + Dv)
    nbytes = (qkv + mask.numel() + 4 * (jlist.numel() + jcount.numel() + H + G)
              + 4 * G * H * N * (Dv + 1))                   # out, lse
    res = dict(kernel_ms=[k1, k2], plain_ms=[p1, p2], library_ms=lib,
               kernel_sdp_ms=k_sdp, valid_pairs=pairs, walk_pairs=walk_pairs,
               walk_flops_ms=2 * H * walk_pairs * (D + Dv)
               / PEAK_FP32_FLOPS * 1e3,
               **bound(nbytes, 2 * H * pairs * (D + Dv)))   # q.k and p.v
    log(f"[5] H={H} N={N} D={D} Dv={Dv}, one snapshot: B1 ms {k1:.4f} "
        f"{k2:.4f}; plain ms {p1:.4f} {p2:.4f}; sdpa ms {lib:.4f} (B1 at "
        f"the same metric {k_sdp:.4f})")
    log(f"[5] B1 bound {res['bound_ms']:.5f} ms by {res['bound_by']} "
        f"({nbytes} bytes, {res['flops']} flops over {pairs} valid pairs); "
        f"the plan's 64 x 64 tiles hold {walk_pairs} pairs = "
        f"{res['walk_flops_ms']:.5f} ms of fp32 math at peak (a dense tile "
        f"walk's work; the pair walk computes the valid pairs alone)")
    res["bwd"] = backward_times(FG, args, out, lse, pairs)
    return res


def backward_times(FG, args, out, lse, pairs):
    """B2, B3a, B3b and B3a + B3b against the plain backward and the
    backward of ``scaled_dot_product_attention``, with their bounds."""
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(G, dtype=torch.int32, device=DEV)
    do = torch.randn(out.shape, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(5))
    delta = (do * out).sum(-1)
    common = (q, k, v, mask, do, lse, delta)

    def b2():
        FG.flash_geometric_bwd_fused_kernel(*common, jlist, jcount,
                                            "euclidean", ones, seed0, 0.0,
                                            False)

    def b3a():
        FG.flash_geometric_bwd_dq_kernel(*common, jlist, jcount, "euclidean",
                                         ones, seed0, 0.0, False)

    def b3b():
        FG.flash_geometric_bwd_dkv_kernel(*common, ilist, icount,
                                          "euclidean", ones, seed0, 0.0)

    def b3():
        b3a()
        b3b()

    def plain():
        FG.flash_geometric_backward_plain(q, k, v, mask, out, lse, do,
                                          "euclidean", ones, 0.0, seed0)

    bmask = (mask[:, None] != 0)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fb():
        o = sdpa(*leaves, attn_mask=bmask)
        torch.autograd.grad(o, leaves, do)

    def lib_f():
        with torch.no_grad():
            sdpa(*leaves, attn_mask=bmask)

    # B2 at the scaled-dot metric, on B1's out and lse there
    sdp = "scaled_dot_product"
    with torch.no_grad():
        out_s, lse_s = FG.flash_geometric_fwd_kernel(
            q, k, v, mask, jlist, jcount, sdp, ones, seed0, 0.0)
    sdp_args = (q, k, v, mask, do, lse_s, (do * out_s).sum(-1), jlist,
                jcount, sdp, ones, seed0, 0.0, False)

    p1 = cuda_ms(plain, 3)
    f1, s1 = cuda_ms(b2, 10), cuda_ms(b3, 10)
    s2, f2 = cuda_ms(b3, 10), cuda_ms(b2, 10)
    p2 = cuda_ms(plain, 3)
    ta, tb = cuda_ms(b3a, 10), cuda_ms(b3b, 10)
    f_sdp = cuda_ms(lambda: FG.flash_geometric_bwd_fused_kernel(*sdp_args),
                    10)
    del out_s, lse_s, sdp_args
    lib = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
    HN = G * H * N
    reads = (4 * HN * (2 * D + 2 * Dv) + 8 * HN          # q k v do lse delta
             + mask.numel() + 4 * (H + G))
    plan_b = 4 * (jlist.numel() + jcount.numel())
    plan_tb = 4 * (ilist.numel() + icount.numel())
    res = {
        "B2": dict(ms=[f1, f2], sdp_ms=f_sdp, **bound(
            reads + plan_b + 4 * HN * (2 * D + Dv),
            2 * H * pairs * (3 * D + 2 * Dv))),
        "B3a": dict(ms=[ta], **bound(reads + plan_b + 4 * HN * D,
                                     2 * H * pairs * (2 * D + Dv))),
        "B3b": dict(ms=[tb], **bound(reads + plan_tb + 4 * HN * (D + Dv),
                                     2 * H * pairs * (2 * D + 2 * Dv))),
        "B3a+B3b_ms": [s1, s2], "plain_ms": [p1, p2], "library_ms": lib}
    log(f"[5] backward, one snapshot: B2 ms {f1:.4f} {f2:.4f} (at the "
        f"scaled-dot metric {f_sdp:.4f}); B3a+B3b ms {s1:.4f} {s2:.4f} (B3a "
        f"{ta:.4f}, B3b {tb:.4f}); plain ms {p1:.4f} {p2:.4f}; sdpa backward "
        f"ms {lib:.4f}")
    for name in ("B2", "B3a", "B3b"):
        r = res[name]
        log(f"[5] {name} bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['flops']} flops)")
    return res


# -- phase 5g -----------------------------------------------------------------

def phase_times_bf16(FG, args):
    """[5g] B1, B2, B3a and B3b in their bf16 forms at one 10K snapshot of
    the bf16 request (3e), each beside its fp32 form in turns, the plain
    bf16 versions, and ``scaled_dot_product_attention`` on bf16 q, k, v
    with the boolean mask as the library yardstick (backward: forward +
    backward - forward). The bounds: the fp32 forms' bytes (the inputs
    stay fp32: the norms and the euclidean chain read them unrounded)
    and the pairs' operations at the bf16 tensor-core rate."""
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(G, dtype=torch.int32, device=DEV)
    f32k, bf16k = flash_kernels(FG, False), flash_kernels(FG, True)

    def fwd(kern):
        return lambda: kern(q, k, v, mask, jlist, jcount, "euclidean", ones,
                            seed0, 0.0)

    def plain_fwd():
        FG.flash_geometric_forward_plain(q, k, v, mask, "euclidean", ones,
                                         0.0, seed0, True, (jlist, jcount))
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    bmask = mask[:, None] != 0
    sdpa = torch.nn.functional.scaled_dot_product_attention

    sdp = "scaled_dot_product"
    with torch.inference_mode():
        t32a, t16a = cuda_ms(fwd(f32k[0]), 10), cuda_ms(fwd(bf16k[0]), 10)
        t16b, t32b = cuda_ms(fwd(bf16k[0]), 10), cuda_ms(fwd(f32k[0]), 10)
        plain = cuda_ms(plain_fwd, 2)
        lib = cuda_ms(lambda: sdpa(bq, bk, bv, attn_mask=bmask), 10)
        t16_sdp = cuda_ms(lambda: bf16k[0](q, k, v, mask, jlist, jcount, sdp,
                                           ones, seed0, 0.0), 10)
        out, lse = bf16k[0](q, k, v, mask, jlist, jcount, "euclidean", ones,
                            seed0, 0.0)
        # the library's function is B1 bf16's at the scaled-dot metric, on
        # the rows with a valid key
        live = bmask.any(-1).expand(-1, H, -1)
        lib_err = rel_err(
            bf16k[0](q, k, v, mask, jlist, jcount, sdp, ones, seed0,
                     0.0)[0][live],
            sdpa(bq, bk, bv, attn_mask=bmask).float()[live])
    if not lib_err <= FLEX_BF16_TOL:
        raise AssertionError(f"sdpa on bf16 inputs differs from B1 bf16 at "
                             f"the scaled-dot metric: {lib_err} > "
                             f"{FLEX_BF16_TOL}")
    pairs = int((mask != 0).sum().item())
    qkv = 4 * G * H * N * (2 * D + Dv)
    nbytes = (qkv + mask.numel() + 4 * (jlist.numel() + jcount.numel() + H + G)
              + 4 * G * H * N * (Dv + 1))
    res = {"B1": dict(ms=[t16a, t16b], fp32_ms=[t32a, t32b], plain_ms=plain,
                      library_ms=lib, sdp_ms=t16_sdp, library_err=lib_err,
                      **bound16(nbytes, 2 * H * pairs * (D + Dv)))}
    log(f"[5g] bf16, one snapshot: B1 bf16 ms {t16a:.4f} {t16b:.4f} (fp32 "
        f"{t32a:.4f} {t32b:.4f}); plain bf16 ms {plain:.4f}; sdpa bf16 ms "
        f"{lib:.4f} (B1 bf16 at the same metric {t16_sdp:.4f}, "
        f"{lib_err:.3e} from it)")

    do = torch.randn(out.shape, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(5))
    delta = (do * out).sum(-1)
    common = (q, k, v, mask, do, lse, delta)

    def b2(kern):
        # the bf16 form is a pair walk over the forward plan
        walk = (jlist, jcount) if kern is bf16k[1] else (ilist, icount)
        return lambda: kern(*common, *walk, "euclidean", ones, seed0, 0.0,
                            False)

    def b3a(kern):
        return lambda: kern(*common, jlist, jcount, "euclidean", ones, seed0,
                            0.0, False)

    def b3b(kern):
        return lambda: kern(*common, ilist, icount, "euclidean", ones, seed0,
                            0.0)

    def plain_bwd():
        FG.flash_geometric_backward_plain(q, k, v, mask, out, lse, do,
                                          "euclidean", ones, 0.0, seed0,
                                          False, None, True)
    leaves = [t.detach().clone().requires_grad_() for t in (bq, bk, bv)]
    bdo = do.bfloat16()

    def lib_fb():
        o = sdpa(*leaves, attn_mask=bmask)
        torch.autograd.grad(o, leaves, bdo)

    def lib_f():
        with torch.no_grad():
            sdpa(*leaves, attn_mask=bmask)

    times = {}
    for name, make, kern32, kern16 in (("B2", b2, f32k[1], bf16k[1]),
                                       ("B3a", b3a, f32k[2], bf16k[2]),
                                       ("B3b", b3b, f32k[3], bf16k[3])):
        a32, a16 = cuda_ms(make(kern32), 10), cuda_ms(make(kern16), 10)
        b16, b32 = cuda_ms(make(kern16), 10), cuda_ms(make(kern32), 10)
        times[name] = ([a16, b16], [a32, b32])
    plain_b = cuda_ms(plain_bwd, 2)
    lib_b = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
    res["B2_sdp"] = b2_vs_sdpa(FG, bf16k, q, k, v, mask, jlist, jcount, do,
                               leaves, bmask)
    HN = G * H * N
    reads = (4 * HN * (2 * D + 2 * Dv) + 8 * HN + mask.numel() + 4 * (H + G))
    plan_b = 4 * (jlist.numel() + jcount.numel())
    plan_tb = 4 * (ilist.numel() + icount.numel())
    for name, nb, flops in (
            ("B2", reads + plan_b + 4 * HN * (2 * D + Dv),
             2 * H * pairs * (3 * D + 2 * Dv)),
            ("B3a", reads + plan_b + 4 * HN * D, 2 * H * pairs * (2 * D + Dv)),
            ("B3b", reads + plan_tb + 4 * HN * (D + Dv),
             2 * H * pairs * (2 * D + 2 * Dv))):
        res[name] = dict(ms=times[name][0], fp32_ms=times[name][1],
                         plain_ms=plain_b, library_ms=lib_b,
                         **bound16(nb, flops))
    log(f"[5g] bf16 backward, one snapshot: "
        + "; ".join(f"{n} bf16 ms {' '.join(f'{x:.4f}' for x in times[n][0])}"
                    f" (fp32 {' '.join(f'{x:.4f}' for x in times[n][1])})"
                    for n in times)
        + f"; plain bf16 backward ms {plain_b:.4f}; sdpa bf16 backward ms "
        f"{lib_b:.4f}")
    for name in ("B1", "B2", "B3a", "B3b"):
        r = res[name]
        log(f"[5g] {name} bf16 bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bytes']} bytes, {r['flops']} flops at the "
            f"bf16 rate)")
    res["B2"]["sdp_ms"] = res["B2_sdp"]["ms"]
    res["density"] = density_sweep(FG, f32k[0], bf16k[0], H, N, D, Dv)
    return res


def b2_vs_sdpa(FG, bf16k, q, k, v, mask, jlist, jcount, do, leaves, bmask):
    """[5g] B2's bf16 form (the backward pair walk) at the scaled-dot
    metric, on B1 bf16's out and lse there, beside the gradients of
    ``scaled_dot_product_attention`` on bf16 q, k, v with the boolean mask
    (the library yardstick's function): ms, and the max abs error of dq,
    dk and dv over each one's largest entry (dq on rows with a valid key).
    Recorded, not gated: the library rounds its output, dS and gradients
    to bf16, so its delta = rowsum(do out) and gradients differ from the
    kernel's fp32 ones by more than a forward's rounding."""
    G, H, N, _ = q.shape
    sdp = "scaled_dot_product"
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        out, lse = bf16k[0](q, k, v, mask, jlist, jcount, sdp, ones, seed0,
                            0.0)
        delta = (do * out).sum(-1)
        args = (q, k, v, mask, do, lse, delta, jlist, jcount, sdp, ones,
                seed0, 0.0, False)
        ms = cuda_ms(lambda: bf16k[1](*args), 10)
        got = bf16k[1](*args)[:3]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                         attn_mask=bmask)
    want = torch.autograd.grad(o, leaves, do.bfloat16())
    live = bmask.any(-1).expand(-1, H, -1)
    errs = {n: rel_err(g[live] if n == "dq" else g, w.float()[live]
                       if n == "dq" else w.float())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    log(f"[5g] B2 bf16 at the scaled-dot metric, one snapshot: {ms:.4f} ms; "
        f"against sdpa bf16's gradients (max abs err over the largest "
        f"entry, recorded) "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    return dict(ms=ms, library_err=errs)


# the density sweep's degrees at N = 10,000 (5g): the model's graphs
# (bench.py's 16 edges a node), and two denser ones where the pair walk's
# rows hold 4 and 33 pairs a walked tile
DENSITY_DEGREES = (16, 256, 2048)


def density_sweep(FG, f32, bf16, H, N, D, Dv):
    """[5g] B1 bf16 (the pair walk) at one snapshot of N nodes whose rows
    hold `DENSITY_DEGREES` uniform random keys (and their diagonal),
    beside B1 (the fp32 pair walk) and ``scaled_dot_product_attention``
    on bf16 and on fp32 q, k, v with the boolean mask, on the same
    inputs; B1 bf16 held to the plain bf16 version under the bf16 gates,
    B1 to the plain fp32 version within TOL. B4 bf16 and B2 bf16 (the
    other pair walks) on the same inputs, held to their plain bf16
    versions likewise, B2 (fp32) to the plain fp32 backward within TOL
    beside sdpa fp32's backward, B4 and B5 (fp32, B5 with a N(0, 1) bias
    at the mask's pairs) to their plain fp32 versions within TOL, and
    the bf16
    biased backward's row walk and key walk on B4 bf16's lse1 and B5
    bf16's out and lse2 with a N(0, 1) bias at the mask's pairs, held to
    the plain bf16 biased backward, and the fp32 walks on B4's and B5's
    statistics, held to the plain fp32 backward within TOL. Times are
    recorded, not gated."""
    b4 = FG.flash_lse1_bf16_kernel
    b2 = FG.flash_geometric_bwd_fused_bf16_kernel
    b5, row, key = biased_kernels(FG, True)[1:]
    seeds2 = torch.zeros(1, 2, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(13)
    q, k, v = (0.5 * torch.randn(1, H, N, w, device=DEV, generator=gen)
               for w in (D, D, Dv))
    do = torch.randn(1, H, N, Dv, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(14))
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(1, dtype=torch.int32, device=DEV)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for deg in DENSITY_DEGREES:
        mask = torch.zeros(1, N, N, dtype=torch.int8, device=DEV)
        rows = torch.arange(N, device=DEV).repeat_interleave(deg)
        mask[0, rows, torch.randint(0, N, (rows.numel(),), device=DEV,
                                    generator=gen)] = 1
        mask[0].fill_diagonal_(1)
        plan = FG.make_block_plan(mask)
        bmask = mask[:, None] != 0

        def call(kern):
            return lambda: kern(q, k, v, mask, *plan, "euclidean", ones,
                                seed0, 0.0)
        with torch.inference_mode():
            a16, a32 = cuda_ms(call(bf16), 10), cuda_ms(call(f32), 5)
            b32, b16 = cuda_ms(call(f32), 5), cuda_ms(call(bf16), 10)
            lib = cuda_ms(lambda: sdpa(bq, bk, bv, attn_mask=bmask), 10)
            lib32 = cuda_ms(lambda: sdpa(q, k, v, attn_mask=bmask), 10)
            out, lse = call(bf16)()
            out32, lse32 = call(f32)()
            p_out, p_lse = FG.flash_geometric_forward_plain(
                q, k, v, mask, "euclidean", ones, 0.0, seed0, True, plan)
            f_out, f_lse = FG.flash_geometric_forward_plain(
                q, k, v, mask, "euclidean", ones, 0.0, seed0)
            b4_ms = cuda_ms(lambda: b4(q, k, mask, *plan, "euclidean", ones),
                            10)
            lse1 = b4(q, k, mask, *plan, "euclidean", ones)
            p_lse1 = FG.flash_lse1_plain(q, k, mask, "euclidean", ones, True)
            # B2 bf16 on the plain bf16 forward's out and lse
            delta = (do * p_out).sum(-1)
            bwd = (q, k, v, mask, do, p_lse, delta, *plan, "euclidean", ones,
                   seed0, 0.0, False)
            b2_ms = cuda_ms(lambda: b2(*bwd), 10)
            grads = b2(*bwd)[:3]
            b2_32 = FG.flash_geometric_bwd_fused_kernel
            b2_32_ms = cuda_ms(lambda: b2_32(*bwd), 10)
            grads32 = b2_32(*bwd)[:3]
            p_grads = FG.flash_geometric_backward_plain(
                q, k, v, mask, p_out, p_lse, do, "euclidean", ones, 0.0,
                seed0, False, None, True)[:3]
            f_grads = FG.flash_geometric_backward_plain(
                q, k, v, mask, p_out, p_lse, do, "euclidean", ones, 0.0,
                seed0)[:3]
            # the biased backward's walks
            bias = torch.where(mask != 0, torch.randn(
                mask.shape, device=DEV, generator=gen), 0.0)
            # B4 and B5 (the fp32 walks), B5 on the walk's lse1
            b4_32, b5_32 = biased_kernels(FG, False)[:2]
            b4_32_ms = cuda_ms(lambda: b4_32(q, k, mask, *plan, "euclidean",
                                             ones), 10)
            lse1_32 = b4_32(q, k, mask, *plan, "euclidean", ones)
            b5_32_ms = cuda_ms(lambda: b5_32(
                q, k, v, mask, bias, lse1_32, *plan, "euclidean", ones,
                seeds2, 0.0), 10)
            out5_32, lse2_32 = b5_32(q, k, v, mask, bias, lse1_32, *plan,
                                     "euclidean", ones, seeds2, 0.0)
            f_lse1 = FG.flash_lse1_plain(q, k, mask, "euclidean", ones)
            f_out5, f_lse2 = FG.flash_biased_forward_plain(
                q, k, v, mask, bias, lse1_32, "euclidean", ones, 0.0, seeds2)
            live = f_lse1 < FG.LSE_DEAD
            err45_32 = max(rel_err(lse1_32[live], f_lse1[live]),
                           rel_err(out5_32, f_out5),
                           rel_err(lse2_32[live], f_lse2[live]))
            # the fp32 row and key walks on B4 and B5's statistics
            plan_t = FG._transposed_plan(mask)
            row32, key32 = biased_kernels(FG, False)[2:]
            c32 = (q, k, v, mask, bias, do, lse1_32, lse2_32,
                   (do * out5_32).sum(-1))
            row32_ms = cuda_ms(lambda: row32(*c32, *plan, "euclidean", ones,
                                             seeds2, 0.0, False), 10)
            d1_32 = row32(*c32, *plan, "euclidean", ones, seeds2, 0.0,
                          False)[0]
            key32_ms = cuda_ms(lambda: key32(*c32, d1_32, *plan_t,
                                             "euclidean", ones, seeds2, 0.0),
                               10)
            got32 = biased_bwd_kernels(FG, *c32, plan, plan_t, "euclidean",
                                       ones, seeds2, 0.0, False)
            walk32_err = biased_bwd_errors(FG, f"degree {deg} fp32 walks",
                                           got32, *c32, "euclidean", ones,
                                           seeds2, 0.0, False)
            del lse1_32, out5_32, lse2_32, f_lse1, f_out5, f_lse2
            del c32, d1_32, got32
            out5, lse2 = b5(q, k, v, mask, bias, lse1, *plan, "euclidean",
                            ones, seeds2, 0.0)
            bcommon = (q, k, v, mask, bias, do, lse1, lse2,
                       (do * out5).sum(-1))
            row_ms = cuda_ms(lambda: row(*bcommon, *plan, "euclidean", ones,
                                         seeds2, 0.0, False), 10)
            d1 = row(*bcommon, *plan, "euclidean", ones, seeds2, 0.0,
                     False)[0]
            key_ms = cuda_ms(lambda: key(*bcommon, d1, *plan_t, "euclidean",
                                         ones, seeds2, 0.0), 10)
            got = biased_bwd_kernels(FG, *bcommon, plan, plan_t, "euclidean",
                                     ones, seeds2, 0.0, False, True)
            walk_gates = biased_bwd_errors(FG, f"degree {deg} walks", got,
                                           *bcommon, "euclidean", ones,
                                           seeds2, 0.0, False, True)
            del bias, out5, lse2, bcommon, d1, got
        # sdpa fp32's backward (forward+backward - forward)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib32_b = cuda_ms(lambda: torch.autograd.grad(
            sdpa(*leaves, attn_mask=bmask), leaves, do), 5)
        with torch.no_grad():
            lib32_b -= cuda_ms(lambda: sdpa(*leaves, attn_mask=bmask), 5)
        del leaves
        gates = max(bf16_gates(f"degree {deg} out", out, p_out, f_out),
                    bf16_gates(f"degree {deg} lse", lse, p_lse, p_lse,
                               witness=False))
        gates4 = bf16_gates(f"degree {deg} lse1", lse1, p_lse1, p_lse1,
                            witness=False)
        gates2 = max(bf16_gates(f"degree {deg} {n}", g, w, f)
                     for n, g, w, f in zip(("dq", "dk", "dv"), grads,
                                           p_grads, f_grads))
        live = f_lse < FG.LSE_DEAD
        err32 = max(rel_err(out32, f_out), rel_err(lse32[live], f_lse[live]))
        err2_32 = max(rel_err(g, w) for g, w in zip(grads32, f_grads))
        if not (err32 <= TOL and err2_32 <= TOL and err45_32 <= TOL):
            raise AssertionError(f"degree {deg}: fp32 walks vs plain fp32: "
                                 f"B1 {err32}, B2 {err2_32}, B4 and B5 "
                                 f"{err45_32} > {TOL}")
        pairs = int(bmask.sum().item())
        res[deg] = dict(ms=[a16, b16], fp32_ms=[a32, b32], library_ms=lib,
                        fp32_library_ms=lib32, fp32_err=err32,
                        valid_pairs=pairs, gates=gates, b4_ms=b4_ms,
                        b4_gates=gates4, b2_ms=b2_ms, b2_gates=gates2,
                        b2_fp32_ms=b2_32_ms, b2_fp32_err=err2_32,
                        b2_fp32_library_ms=lib32_b,
                        b4_fp32_ms=b4_32_ms, b5_fp32_ms=b5_32_ms,
                        b4_b5_fp32_err=err45_32,
                        row_walk_ms=row_ms, key_walk_ms=key_ms,
                        walk_gates=walk_gates, row_walk_fp32_ms=row32_ms,
                        key_walk_fp32_ms=key32_ms, walk_fp32_err=walk32_err)
        log(f"[5g] density: N={N}, degree {deg} ({pairs} valid pairs, "
            f"{int(plan[1].sum().item())} walked tiles): B1 bf16 ms "
            f"{a16:.4f} {b16:.4f}, B1 (fp32 walk) ms {a32:.4f} {b32:.4f}, "
            f"sdpa bf16 ms {lib:.4f}, sdpa fp32 ms {lib32:.4f}; B4 bf16 ms "
            f"{b4_ms:.4f}, B2 bf16 ms {b2_ms:.4f}, B2 (fp32 walk) ms "
            f"{b2_32_ms:.4f}, sdpa fp32 backward ms {lib32_b:.4f}; B4 (fp32 "
            f"walk) ms {b4_32_ms:.4f}, B5 (fp32 walk) ms {b5_32_ms:.4f}; fp32 "
            f"walks vs plain fp32 B1 {err32:.3e}, B2 {err2_32:.3e}, B4 and B5 "
            f"{err45_32:.3e}, row walk {walk32_err['B6+B7a']:.3e}, key walk "
            f"{walk32_err['B7b']:.3e}; biased backward row walk bf16 ms "
            f"{row_ms:.4f}, key walk bf16 ms {key_ms:.4f}, row walk (fp32) ms "
            f"{row32_ms:.4f}, key walk (fp32) ms {key32_ms:.4f}; vs plain "
            f"bf16 (max abs err, max err, "
            f"mean err, witness) B1 {tuple(f'{x:.3e}' for x in gates)}, B4 "
            f"{tuple(f'{x:.3e}' for x in gates4)}, B2 "
            f"{tuple(f'{x:.3e}' for x in gates2)}, walks "
            + "; ".join(f"{n} {tuple(f'{x:.3e}' for x in r)}"
                        for n, r in walk_gates.items()))
        del mask, bmask, plan, out, p_out, f_out, grads, p_grads, f_grads
        del out32, lse32, grads32, f_lse
    return res


# -- phase 5b -----------------------------------------------------------------

def flex_setup(q, mask):
    """(block mask of the int8 mask, compiled ``flex_attention``): the
    library's form of the masked walk (the port never calls it)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    G, _, N, _ = q.shape
    valid = mask != 0
    block_mask = create_block_mask(lambda b, h, qi, kv: valid[b, qi, kv],
                                   G, None, N, N, device=DEV)
    return block_mask, torch.compile(flex_attention, dynamic=False)


def flex_yardstick(q, k, v, mask, bias):
    """The library's form of B4 and B5 at the scaled-dot metric:
    compiled ``flex_attention`` under a block mask built from the int8
    mask, with return_lse. The identity score_mod gives lse1 (B4);
    score_mod exp(s - lse1) + bias gives B5's out and lse2. Returns
    (call_b4, call_b5, lse1, out, lse2)."""
    block_mask, flex = flex_setup(q, mask)

    def call_b4():
        return flex(q, k, v, block_mask=block_mask, return_lse=True)

    lse1 = call_b4()[1]

    def biased(s, b, h, qi, kv):
        return torch.exp(s - lse1[b, h, qi]) + bias[b, qi, kv]

    def call_b5():
        return flex(q, k, v, score_mod=biased, block_mask=block_mask,
                    return_lse=True)

    out, lse2 = call_b5()
    return call_b4, call_b5, lse1, out, lse2


def phase_times_biased(FG, args, graph):
    """B4 and B5 (the fp32 pair walks) at one snapshot of the
    edge-feature request, against their plain versions in turns and held
    to them within TOL at the euclidean and the scaled-dot metric, with
    their bounds. The library yardstick is
    ``flex_attention`` at the scaled-dot metric (B4 and B5 are timed at
    that metric too, and held against it); the csr ``edge_attention``
    with the same bias on the same graph is the port's own O(E) form."""
    from tagan_torch.ops.sparse import edge_attention
    q, k, v, mask, bias, jlist, jcount = args
    eq, ek, em, eb = graph
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    sdp = "scaled_dot_product"
    with torch.inference_mode():
        lse1 = FG.flash_lse1_kernel(q, k, mask, jlist, jcount, "euclidean",
                                    ones)
        lse1_sdp = FG.flash_lse1_kernel(q, k, mask, jlist, jcount, sdp, ones)

        def b4(metric="euclidean"):
            FG.flash_lse1_kernel(q, k, mask, jlist, jcount, metric, ones)

        def b5(metric="euclidean", l1=lse1):
            FG.flash_biased_fwd_kernel(q, k, v, mask, bias, l1, jlist,
                                       jcount, metric, ones, seeds, 0.0)

        def plain4():
            FG.flash_lse1_plain(q, k, mask, "euclidean", ones)

        def plain5():
            FG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                          "euclidean", ones, 0.0, seeds)

        def csr():
            edge_attention("euclidean", q, k, v, eq, ek, em, N, edge_bias=eb)

        p4a, k4a, k4b, p4b = (cuda_ms(plain4, 5), cuda_ms(b4, 20),
                              cuda_ms(b4, 20), cuda_ms(plain4, 5))
        p5a, k5a, k5b, p5b = (cuda_ms(plain5, 5), cuda_ms(b5, 20),
                              cuda_ms(b5, 20), cuda_ms(plain5, 5))
        csr_ms = [cuda_ms(csr, 20), cuda_ms(csr, 20)]
        k4_sdp = cuda_ms(lambda: b4(sdp), 20)
        k5_sdp = cuda_ms(lambda: b5(sdp, lse1_sdp), 20)
        out_sdp, lse2_sdp = FG.flash_biased_fwd_kernel(
            q, k, v, mask, bias, lse1_sdp, jlist, jcount, sdp, ones, seeds,
            0.0)
        # the walks against the plain versions at both metrics (B5 on the
        # walk's lse1)
        live = (mask != 0).any(-1)[:, None].expand(G, H, N)
        plain_err = {}
        for metric, l1, o, l2 in (
                ("euclidean", lse1, *FG.flash_biased_fwd_kernel(
                    q, k, v, mask, bias, lse1, jlist, jcount, "euclidean",
                    ones, seeds, 0.0)),
                (sdp, lse1_sdp, out_sdp, lse2_sdp)):
            p_l1 = FG.flash_lse1_plain(q, k, mask, metric, ones)
            p_o, p_l2 = FG.flash_biased_forward_plain(
                q, k, v, mask, bias, l1, metric, ones, 0.0, seeds)
            plain_err[metric] = max(rel_err(l1[live], p_l1[live]),
                                    rel_err(o, p_o),
                                    rel_err(l2[live], p_l2[live]))
        del o, l2, p_l1, p_o, p_l2
    if not max(plain_err.values()) <= TOL:
        raise AssertionError(f"B4/B5 vs plain at one snapshot: {plain_err} "
                             f"> {TOL}")
    with torch.no_grad():
        t0 = time.perf_counter()
        lib4, lib5, f_lse1, f_out, f_lse2 = flex_yardstick(q, k, v, mask,
                                                          bias)
        sync()
        flex_setup_s = time.perf_counter() - t0
        lib4_ms, lib5_ms = cuda_ms(lib4, 20), cuda_ms(lib5, 20)
    # the library's function is the kernels' at this metric: rows with no
    # valid key excepted (flex gives lse -inf there, the kernels LSE_DEAD)
    flex_err = max((f_lse1 - lse1_sdp)[live].abs().max().item(),
                   (f_lse2 - lse2_sdp)[live].abs().max().item(),
                   (f_out - out_sdp)[live].abs().max().item())
    pairs = int((mask != 0).sum().item())
    plan_b = 4 * (jlist.numel() + jcount.numel())
    qk = 4 * G * H * N * 2 * D
    rows = 4 * G * H * N                                  # one [G, H, N]
    # B5's result depends on the bias only at the valid pairs: 4 bytes each
    res = {
        "B4": dict(ms=[k4a, k4b], plain_ms=[p4a, p4b], sdp_ms=k4_sdp,
                   library_ms=lib4_ms, **bound(
                       qk + mask.numel() + plan_b + 4 * H + rows,
                       2 * H * pairs * D)),               # q.k
        "B5": dict(ms=[k5a, k5b], plain_ms=[p5a, p5b], sdp_ms=k5_sdp,
                   library_ms=lib5_ms, **bound(
                       qk + 4 * G * H * N * Dv + mask.numel() + 4 * pairs
                       + rows + plan_b + 4 * (H + 2 * G)
                       + 4 * G * H * N * Dv + rows,
                       2 * H * pairs * (D + Dv))),        # q.k and p.v
        "csr_ms": csr_ms, "valid_pairs": pairs,
        "csr_edges": int(em.sum().item()), "flex_err": flex_err,
        "flex_setup_s": flex_setup_s, "plain_err": plain_err}
    log(f"[5b] H={H} N={N} D={D} Dv={Dv}, one snapshot, edge bias: B4 ms "
        f"{k4a:.4f} {k4b:.4f} (plain {p4a:.4f} {p4b:.4f}); B5 ms {k5a:.4f} "
        f"{k5b:.4f} (plain {p5a:.4f} {p5b:.4f}); csr edge_attention with "
        f"the bias on the same graph ({res['csr_edges']} edges) ms "
        f"{csr_ms[0]:.4f} {csr_ms[1]:.4f}; vs plain, max err of lse1, out "
        f"and lse2: " + ", ".join(f"{m} {e:.3e}" for m, e in
                                   plain_err.items()) + f" (tol {TOL})")
    log(f"[5b] library: compiled flex_attention at the scaled-dot metric "
        f"(block mask and compile {flex_setup_s:.3f} s): lse1 {lib4_ms:.4f} "
        f"ms (B4 at the same metric {k4_sdp:.4f}), out and lse2 "
        f"{lib5_ms:.4f} ms (B5 at the same metric {k5_sdp:.4f}); max abs "
        f"err against B4/B5 at that metric {flex_err:.3e}")
    if not flex_err <= TOL:
        raise AssertionError(f"flex_attention yardstick differs from B4/B5: "
                             f"{flex_err} > {TOL}")
    for name in ("B4", "B5"):
        r = res[name]
        log(f"[5b] {name} bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['flops']} flops over {pairs} valid "
            f"pairs)")
    return res


# -- phase 5c -----------------------------------------------------------------

def flex_bwd_yardstick(q, k, v, mask, bias, do, got=None):
    """The library's backward of B4 and B5's function at the scaled-dot
    metric: compiled ``flex_attention``, forward+backward minus forward
    of `flex_yardstick`'s two calls, with lse1 flowing from the first
    call into the second's score_mod and the bias requiring grad (PyTorch
    2.11 differentiates both). Where the installed PyTorch cannot, ms is
    None and ``error`` says why. ``got``, the kernels' (delta1, dB, dq,
    dscale, dk, dv) at that metric: ``grad_err`` holds the max abs error
    of dq (rows with a valid key), dk, dv and dB (the mask's pairs)
    against the library's gradients over each one's largest entry,
    recorded, not gated: the library rounds its outputs and gradients to
    bf16."""
    block_mask, flex = flex_setup(q, mask)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]

    def two_calls(ql, kl, vl, bl):
        l1 = flex(ql, kl, vl, block_mask=block_mask, return_lse=True)[1]

        def biased(s, b, h, qi, kv):
            return torch.exp(s - l1[b, h, qi]) + bl[b, qi, kv]
        return flex(ql, kl, vl, score_mod=biased, block_mask=block_mask)

    def fwd_bwd():
        torch.autograd.grad(two_calls(*leaves), leaves, do)

    def fwd():
        with torch.no_grad():
            two_calls(*leaves)

    try:
        fwd_bwd()
        sync()
    except Exception as e:          # the yardstick only: never the port
        return dict(ms=None, error=f"{type(e).__name__}: {e}"[:300])
    res = dict(ms=cuda_ms(fwd_bwd, 5) - cuda_ms(fwd, 5),
               form="both calls; gradients of q, k, v and the bias, "
                    "lse1 differentiated")
    if got is not None:
        want = [w.float() for w in torch.autograd.grad(two_calls(*leaves),
                                                       leaves, do)]
        live = (mask != 0).any(-1)[:, None].expand(q.shape[:3])
        on = mask != 0
        res["grad_err"] = {
            "dq": rel_err(got[2][live], want[0][live]),
            "dk": rel_err(got[4], want[1]), "dv": rel_err(got[5], want[2]),
            "dB": rel_err(got[1][on], want[3][on])}
    return res


def biased_bwd_bounds(FG, q, v, mask, plan, plan_t):
    """The biased backward walks' least times from these inputs: every
    input read once (q, k, v, do, the row statistics, the int8 mask, the
    bias at the valid pairs only, the plan, scale, seeds) and every output
    written once (dB at the valid pairs), against the products on the
    valid pairs at the fp32 peak: the row walk ("B6+B7a": delta1, dB, dq
    from one read of their inputs), the key walk ("B7b", reading delta1)
    and the two ("both": delta1 between them is internal)."""
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    HN = G * H * N
    pairs = int((mask != 0).sum().item())
    common = (4 * HN * (2 * D + 2 * Dv) + 3 * 4 * HN + mask.numel()
              + 4 * pairs + 4 * (H + 2 * G))
    plan_b = 4 * sum(t.numel() for t in plan)
    plan_tb = 4 * sum(t.numel() for t in plan_t)
    f6, f7a = 2 * H * pairs * (D + Dv), 2 * H * pairs * (2 * D + Dv)
    f7b = 2 * H * pairs * (2 * D + 2 * Dv)
    return pairs, {
        "B6+B7a": bound(common + plan_b + 4 * HN + 4 * pairs + 4 * HN * D,
                        f6 + f7a),
        "B7b": bound(common + 4 * HN + plan_tb + 4 * HN * (D + Dv), f7b),
        "both": bound(common + plan_b + plan_tb + 4 * pairs
                      + 4 * HN * (2 * D + Dv), f6 + f7a + f7b)}


def phase_times_biased_bwd(FG, args):
    """[5c] The fp32 row walk (B6 and B7a), key walk (B7b) and the two
    together at one snapshot of the edge-feature request, against the
    plain backward, the library's (`flex_bwd_yardstick`) and each one's
    bound."""
    q, k, v, mask, bias, jlist, jcount = args
    G, H, N, D = q.shape
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    plan, plan_t = (jlist, jcount), FG._transposed_plan(mask)
    row, key = biased_kernels(FG, False)[2:]
    sdp = "scaled_dot_product"
    stats = {}
    with torch.no_grad():
        for metric in ("euclidean", sdp):
            lse1 = FG.flash_lse1_kernel(q, k, mask, *plan, metric, ones)
            out, lse2 = FG.flash_biased_fwd_kernel(q, k, v, mask, bias, lse1,
                                                   *plan, metric, ones,
                                                   seeds, 0.0)
            stats[metric] = (out, lse1, lse2)
        out, lse1, lse2 = stats["euclidean"]
        do = torch.randn(out.shape, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(7))
        stats = {m: (l1, l2, (do * o).sum(-1))
                 for m, (o, l1, l2) in stats.items()}
        delta2 = stats["euclidean"][2]
        common = (q, k, v, mask, bias, do, lse1, lse2, delta2)
        d1 = row(*common, *plan, "euclidean", ones, seeds, 0.0, False)[0]

        def row_walk():
            row(*common, *plan, "euclidean", ones, seeds, 0.0, False)

        def key_walk():
            key(*common, d1, *plan_t, "euclidean", ones, seeds, 0.0)

        def both(metric="euclidean"):
            biased_bwd_kernels(FG, q, k, v, mask, bias, do, *stats[metric],
                               plan, plan_t, metric, ones, seeds, 0.0, False)

        def plain():
            FG.flash_biased_backward_plain(q, k, v, mask, bias, out, lse1,
                                           lse2, do, "euclidean", ones, 0.0,
                                           seeds)

        p1, a1, a2, p2 = (cuda_ms(plain, 3), cuda_ms(both, 10),
                          cuda_ms(both, 10), cuda_ms(plain, 3))
        tr, tk = cuda_ms(row_walk, 10), cuda_ms(key_walk, 10)
        a_sdp = cuda_ms(lambda: both(sdp), 10)
        got_sdp = biased_bwd_kernels(FG, q, k, v, mask, bias, do,
                                     *stats[sdp], plan, plan_t, sdp, ones,
                                     seeds, 0.0, False)
    t0 = time.perf_counter()
    lib = flex_bwd_yardstick(q, k, v, mask, bias, do, got_sdp)
    lib["setup_and_timing_s"] = time.perf_counter() - t0
    pairs, bounds = biased_bwd_bounds(FG, q, v, mask, plan, plan_t)
    res = {"B6+B7a": dict(ms=[tr], **bounds["B6+B7a"]),
           "B7b": dict(ms=[tk], **bounds["B7b"]),
           "both": dict(ms=[a1, a2], sdp_ms=a_sdp, **bounds["both"]),
           "plain_ms": [p1, p2], "library": lib, "valid_pairs": pairs,
           "walked_tiles": int(jcount.sum().item())}
    log(f"[5c] H={H} N={N} D={D}, one snapshot, fp32 biased backward: row "
        f"walk (B6+B7a) ms {tr:.4f}, key walk (B7b) {tk:.4f}; both ms "
        f"{a1:.4f} {a2:.4f} (scaled-dot metric {a_sdp:.4f}); plain ms "
        f"{p1:.4f} {p2:.4f}")
    log(f"[5c] library: compiled flex_attention backward of B4 and B5's "
        f"function at the scaled-dot metric: {lib}")
    for name in ("B6+B7a", "B7b", "both"):
        r = res[name]
        log(f"[5c] {name} bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['flops']} flops over {pairs} valid "
            f"pairs)")
    return res


# -- phase 5h -----------------------------------------------------------------

def bound16(nbytes, flops):
    """`bound` with the operations at the bf16 tensor-core rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                bytes=nbytes, flops=flops)


def phase_times_biased_bf16(FG, args):
    """[5h] B4 and B5 in their bf16 forms and the bf16 backward's two
    walks (the row walk: B6 and B7a bf16; the key walk: B7b bf16; and the
    two together) at one 10K snapshot of the bf16 edge-feature request
    (3f), each beside its fp32 form in turns, the plain bf16 versions,
    and their bounds: the fp32 forms' bytes (the inputs stay fp32) and
    the valid pairs' operations at the bf16 tensor-core rate. The library
    yardstick is compiled ``flex_attention`` on bf16 q, k, v at the
    scaled-dot metric, as in 5b and 5c: held against the bf16 B4 and B5
    at that metric (null with the reason where it does not build or
    differs); its backward is forward+backward minus forward of B4 and
    B5's function, and its gradients are held against the two walks' at
    that metric (recorded)."""
    q, k, v, mask, bias, jlist, jcount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    plan, plan_t = (jlist, jcount), FG._transposed_plan(mask)
    k32, k16 = biased_kernels(FG, False), biased_kernels(FG, True)
    sdp = "scaled_dot_product"
    with torch.no_grad():
        lse1 = k16[0](q, k, mask, *plan, "euclidean", ones)
        out, lse2 = k16[1](q, k, v, mask, bias, lse1, *plan, "euclidean",
                           ones, seeds, 0.0)
        do = torch.randn(out.shape, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(7))
        delta2 = (do * out).sum(-1)
        common = (q, k, v, mask, bias, do, lse1, lse2, delta2)
        d1 = k16[2](*common, *plan, "euclidean", ones, seeds, 0.0, False)[0]
        d1_32 = k32[2](*common, *plan, "euclidean", ones, seeds, 0.0,
                       False)[0]

        def fwd4(kern):
            return lambda: kern(q, k, mask, *plan, "euclidean", ones)

        def fwd5(kern):
            return lambda: kern(q, k, v, mask, bias, lse1, *plan,
                                "euclidean", ones, seeds, 0.0)

        def both(bf16, metric="euclidean", stats=(lse1, lse2, delta2)):
            return lambda: biased_bwd_kernels(
                FG, q, k, v, mask, bias, do, *stats, plan, plan_t, metric,
                ones, seeds, 0.0, False, bf16)
        calls = {
            "B4": (fwd4(k32[0]), fwd4(k16[0])),
            "B5": (fwd5(k32[1]), fwd5(k16[1])),
            "B6+B7a": (lambda: k32[2](*common, *plan, "euclidean", ones,
                                      seeds, 0.0, False),
                       lambda: k16[2](*common, *plan, "euclidean", ones,
                                      seeds, 0.0, False)),
            "B7b": (lambda: k32[3](*common, d1_32, *plan_t, "euclidean",
                                   ones, seeds, 0.0),
                    lambda: k16[3](*common, d1, *plan_t, "euclidean", ones,
                                   seeds, 0.0)),
            "both": (both(False), both(True))}
        times = {}
        for name, (f32, f16) in calls.items():
            a32, a16 = cuda_ms(f32, 10), cuda_ms(f16, 10)
            b16, b32 = cuda_ms(f16, 10), cuda_ms(f32, 10)
            times[name] = ([a16, b16], [a32, b32])
        plain4 = cuda_ms(lambda: FG.flash_lse1_plain(
            q, k, mask, "euclidean", ones, True), 2)
        plain5 = cuda_ms(lambda: FG.flash_biased_forward_plain(
            q, k, v, mask, bias, lse1, "euclidean", ones, 0.0, seeds, True,
            plan), 2)
        plain_b = cuda_ms(lambda: FG.flash_biased_backward_plain(
            q, k, v, mask, bias, out, lse1, lse2, do, "euclidean", ones, 0.0,
            seeds, False, True), 2)
        l1_sdp = k16[0](q, k, mask, *plan, sdp, ones)
        out_sdp, l2_sdp = k16[1](q, k, v, mask, bias, l1_sdp, *plan, sdp,
                                 ones, seeds, 0.0)
        k4_sdp = cuda_ms(lambda: k16[0](q, k, mask, *plan, sdp, ones), 10)
        k5_sdp = cuda_ms(lambda: k16[1](q, k, v, mask, bias, l1_sdp, *plan,
                                        sdp, ones, seeds, 0.0), 10)
        sdp_stats = (l1_sdp, l2_sdp, (do * out_sdp).sum(-1))
        walks_sdp = cuda_ms(both(True, sdp, sdp_stats), 10)
        got_sdp = both(True, sdp, sdp_stats)()
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    live = (mask != 0).any(-1)[:, None].expand(G, H, N)
    lib = {"B4": None, "B5": None, "error": None}
    # phases 5b and 5c compiled flex_attention under other score functions
    # and dtypes: past dynamo's recompile limit it would run unfused
    torch._dynamo.reset()
    t0 = time.perf_counter()
    try:                            # the yardstick only: never the port
        with torch.no_grad():
            lib4, lib5, f_lse1, f_out, f_lse2 = flex_yardstick(bq, bk, bv,
                                                              mask, bias)
            sync()
            lib["B4"], lib["B5"] = cuda_ms(lib4, 20), cuda_ms(lib5, 20)
        flex_err = max(rel_err(f_lse1.float()[live], l1_sdp[live]),
                       rel_err(f_lse2.float()[live], l2_sdp[live]),
                       rel_err(f_out.float()[live], out_sdp[live]))
        lib["err"] = flex_err
        if not flex_err <= FLEX_BF16_TOL:
            lib.update(B4=None, B5=None, error=(
                f"flex_attention on bf16 inputs differs from the bf16 B4/B5 "
                f"at the scaled-dot metric: {flex_err} > {FLEX_BF16_TOL}"))
    except Exception as e:
        lib["error"] = f"{type(e).__name__}: {e}"[:300]
    lib["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib_bwd = flex_bwd_yardstick(bq, bk, bv, mask, bias, do.bfloat16(),
                                 got_sdp)
    lib_bwd["setup_and_timing_s"] = time.perf_counter() - t0
    pairs, bounds = biased_bwd_bounds(FG, q, v, mask, plan, plan_t)
    plan_b = 4 * (jlist.numel() + jcount.numel())
    qk = 4 * G * H * N * 2 * D
    rows = 4 * G * H * N
    nbytes = {
        "B4": qk + mask.numel() + plan_b + 4 * H + rows,
        "B5": (qk + 4 * G * H * N * Dv + mask.numel() + 4 * pairs + rows
               + plan_b + 4 * (H + 2 * G) + 4 * G * H * N * Dv + rows)}
    nbytes.update({n: b["bytes"] for n, b in bounds.items()})
    flops = {"B4": 2 * H * pairs * D, "B5": 2 * H * pairs * (D + Dv),
             **{n: b["flops"] for n, b in bounds.items()}}
    res = {}
    for name in calls:
        plain, library = ((plain4, lib["B4"]) if name == "B4" else
                          (plain5, lib["B5"]) if name == "B5" else
                          (plain_b, lib_bwd["ms"]))
        res[name] = dict(ms=times[name][0], fp32_ms=times[name][1],
                         plain_ms=plain, library_ms=library,
                         **bound16(nbytes[name], flops[name]))
    res.update(library=lib, library_bwd=lib_bwd, valid_pairs=pairs,
               b4_sdp_ms=k4_sdp, b5_sdp_ms=k5_sdp, walks_sdp_ms=walks_sdp)
    log(f"[5h] bf16 edge bias, one snapshot: "
        + "; ".join(f"{n} bf16 ms {' '.join(f'{x:.4f}' for x in t[0])} (fp32 "
                    f"{' '.join(f'{x:.4f}' for x in t[1])})"
                    for n, t in times.items())
        + f"; plain bf16 ms B4 {plain4:.4f}, B5 {plain5:.4f}, backward "
        f"{plain_b:.4f} (\"B6+B7a\": the row walk; \"B7b\": the key walk; "
        f"\"both\": the two walks; each beside its fp32 form)")
    log(f"[5h] library: compiled flex_attention on bf16 q, k, v at the "
        f"scaled-dot metric: {lib} (bf16 B4 at that metric {k4_sdp:.4f} ms, "
        f"B5 {k5_sdp:.4f}, the two walks {walks_sdp:.4f}); backward of B4 "
        f"and B5's function {lib_bwd}")
    for name in calls:
        r = res[name]
        log(f"[5h] {name} bf16 bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bytes']} bytes, {r['flops']} flops over "
            f"{pairs} valid pairs at the bf16 rate)")
    return res


# -- phase 6 ------------------------------------------------------------------

def step_times(trainer, batches):
    """ms of one synchronised training step per batch, on the host clock."""
    out = []
    for b, y, m in batches:
        sync()
        t0 = time.perf_counter()
        trainer._train_step(b, y, m)
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_split(trainer, b, y, m):
    """[forward, backward, optimizer] ms of two steps, CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    splits = []
    for _ in range(2):
        trainer.optimizer.zero_grad()
        sync()
        ev[0].record()
        loss, _ = trainer._loss(b, y, m, True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        sync()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    return splits


@contextlib.contextmanager
def fixed_order(on=True):
    """With ``on``: torch's deterministic algorithms (index_add_,
    scatter_add_ and the gathers' backward sum in a fixed order; an
    operation with no such form warns), uninitialised memory left
    unfilled so that nothing else changes."""
    if not on:
        yield
        return
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (the first 16 hex digits)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_grads(model):
    """Names of the parameters whose gradient is missing, not finite, or
    zero where it is not zero in exact arithmetic."""
    return [n for n, p in model.named_parameters() if p.grad is None
            or not bool(torch.isfinite(p.grad).all())
            or (n not in ZERO_GRAD and not bool((p.grad != 0).any()))]


def phase_train(tt, FG, bf16=False):
    """[6], and with ``bf16`` [6e]: bench.py's bf16 training step
    (bf16_matmul=True), the bf16 forms' launches counted and held to the
    plain bf16 backward under the bf16 gates."""
    tag = "6e" if bf16 else "6"
    b1, b2, b3a, b3b = flash_kernels(FG, bf16)
    cfg = model_config(tt, bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    exp = tt.ExperimentConfig(model=cfg, batch_size=1, num_epochs=1, seed=0,
                              checkpoint_dir="", shuffle=False)
    rng = np.random.default_rng(2)
    ds = tt.TemporalGraphDataset(
        [make_sequence(rng, N_FULL, E_FULL, T_FULL)
         for _ in range(TRAIN_STEPS + 1)], [1.0, 0.0, 1.0, 0.0])
    kw = dict(batch_size=1, dense_adj=False, max_time=T_FULL,
              max_nodes=N_FULL, max_edges=E_FULL)
    warm = tt.TemporalGraphDataLoader(ds.subset([0]), **kw)
    loader = tt.TemporalGraphDataLoader(
        ds.subset(list(range(1, TRAIN_STEPS + 1))), **kw)
    t0 = time.perf_counter()
    batches = list(loader)                  # packs and caches the sequences
    pack_s = time.perf_counter() - t0
    trainer = tt.TAGANTrainer(model, exp)

    def snapshot():
        return tuple(t[:1].clone() for t in layer0_inputs(
            FG, model, batches[0][0].to(DEV), N_FULL))
    # the full-width check (below) runs on layer 0 of the first batch's
    # first snapshot at two sets of weights: the seeded ones, and the
    # trained ones after the warm-up and the B3a+B3b steps. Every step
    # before that takes B3a+B3b, which sum in a fixed order (B2 sums dq by
    # atomics, in an order that changes from run to run), so both inputs,
    # and which bf16 roundings of the check flip, are the same in every run
    checks = {"seeded": snapshot()}
    default = FG.FUSED_BWD
    FG.FUSED_BWD = False
    trainer.train(warm, verbose=False)
    sync()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for fused in (False, True):
        FG.FUSED_BWD = fused
        reset_counts(FG)
        t0 = time.perf_counter()
        res = trainer.train(loader, verbose=False)
        sync()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        launched = counts(FG)
        if not fused:
            checks["trained"] = snapshot()
        want = {k.name: 0 for k in FG.KERNELS}
        want[b1.name] = 2 * TRAIN_STEPS
        for kern in (b2,) if fused else (b3a, b3b):
            want[kern.name] = cfg.num_layers * TRAIN_STEPS
        losses = res["history"]["train_loss"]
        step_ms = step_times(trainer, batches)
        # the last step's (clipped) gradients: every one finite, and every
        # one non-zero but those that are zero in exact arithmetic
        grads = dict(model.named_parameters())
        no_grad = check_grads(model)
        log(f"[{tag}] {'B2' if fused else 'B3a+B3b'} backward: {TRAIN_STEPS} "
            f"steps of TAGANTrainer.train in {epoch_ms:.3f} ms; mean loss "
            f"{losses}; launches {launched} (expected {want}); step ms "
            f"(host clock, synchronised) {[round(x, 3) for x in step_ms]}; "
            f"{len(grads) - len(no_grad)} of {len(grads)} gradients finite "
            f"and non-zero where not zero in exact arithmetic")
        if launched != want:
            raise AssertionError(f"launches {launched} != {want}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"loss not finite: {losses}")
        if no_grad:
            raise AssertionError(f"no finite non-zero gradient: {no_grad}")
        runs[fused] = dict(epoch_ms=epoch_ms, step_ms=step_ms,
                           launches=launched, loss=losses)
    FG.FUSED_BWD = default
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(int(not torch.equal(p.detach(), before[n]))
                for n, p in model.named_parameters())
    log(f"[{tag}] parameters moved by the measured steps: {moved} of "
        f"{len(before)} tensors; peak memory of the measured steps "
        f"{peak_gb:.3f} GB")
    if moved != len(before):
        raise AssertionError(f"only {moved} of {len(before)} parameters moved")

    # the step split with CUDA events, the picker's default backward
    b, y, m = batches[0]
    splits = step_split(trainer, b, y, m)
    log(f"[{tag}] step split (CUDA events) forward / backward / optimizer "
        f"ms: {[[round(x, 3) for x in s] for s in splits]}")

    # one layer's backward launch over the batch's 8 folded snapshots
    args = layer0_inputs(FG, model, b.to(DEV), N_FULL)
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H = q.shape[:2]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        out, lse = b1(q, k, v, mask, jlist, jcount, "euclidean", ones, seeds,
                      0.0)
        fold_b1 = cuda_ms(lambda: b1(q, k, v, mask, jlist, jcount,
                                     "euclidean", ones, seeds, 0.0), 3)
        do = torch.randn(out.shape, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(6))
        delta = (do * out).sum(-1)
        common = (q, k, v, mask, do, lse, delta)
        # B2 is a pair walk over the forward plan
        fold_b2 = cuda_ms(lambda: b2(*common, jlist, jcount, "euclidean",
                                     ones, seeds, 0.0, False), 3)
        fold_b3 = cuda_ms(lambda: (
            b3a(*common, jlist, jcount, "euclidean", ones, seeds, 0.0, False),
            b3b(*common, ilist, icount, "euclidean", ones, seeds, 0.0)), 3)
        # [5] / [5g] B2 at the scaled-dot metric over the same fold, on
        # B1's out and lse there
        sdp = "scaled_dot_product"
        out_s, lse_s = b1(q, k, v, mask, jlist, jcount, sdp, ones, seeds,
                          0.0)
        sdp_args = (q, k, v, mask, do, lse_s, (do * out_s).sum(-1),
                    jlist, jcount, sdp, ones, seeds, 0.0, False)
        fold_b2_sdp = cuda_ms(lambda: b2(*sdp_args), 10)
        del out_s, lse_s, sdp_args
    fold_lib = None
    if not bf16:
        # [5] sdpa fp32's backward over the same fold (forward+backward -
        # forward), with the boolean mask
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        bmask = mask[:, None] != 0

        def lib_fb():
            torch.autograd.grad(sdpa(*leaves, attn_mask=bmask), leaves, do)

        def lib_f():
            with torch.no_grad():
                sdpa(*leaves, attn_mask=bmask)
        fold_lib = cuda_ms(lib_fb, 3) - cuda_ms(lib_f, 3)
        del leaves, bmask
    fold = {True: fold_b2, False: fold_b3}[default]
    step = min(runs[default]["step_ms"])
    share = cfg.num_layers * (fold_b1 + fold) / step
    log(f"[{tag}] one layer's launches over the {G} folded snapshots: B1 "
        f"{fold_b1:.3f} ms; backward B2 {fold_b2:.3f} ms, B3a+B3b "
        f"{fold_b3:.3f} ms; {cfg.num_layers} layers' B1 and "
        f"{'B2' if default else 'B3a+B3b'} = {share:.3f} of the fastest step "
        f"({step:.3f} ms); B2 at the scaled-dot metric over the fold "
        f"{fold_b2_sdp:.3f} ms" + ("" if bf16 else f", sdpa fp32's backward "
                                   f"over the fold {fold_lib:.3f} ms"))

    # one snapshot at full width, at the seeded and the trained weights:
    # both forms against the plain backward
    del q, k, v, mask, out, lse, do, common, args
    full, sums, noise = {True: {}, False: {}}, {}, {}
    for label, (q1, k1, v1, mask1, jl1, jc1, il1, ic1) in checks.items():
        with torch.no_grad():
            out1, lse1 = b1(q1, k1, v1, mask1, jl1, jc1, "euclidean", ones,
                            seeds[:1], 0.0)
        do1 = torch.randn(out1.shape, device=DEV, generator=torch.Generator(
            device=DEV).manual_seed(6))
        one = (q1, k1, v1, mask1, out1, lse1, do1)
        # the inputs' sums, to compare them between runs
        sums[label] = [t.double().sum().item() for t in (q1, k1, v1)]

        def plain(q_, k_, b16):
            return FG.flash_geometric_backward_plain(
                q_, k_, *one[2:], "euclidean", ones, 0.0, seeds[:1], False,
                None, b16)
        want = plain(q1, k1, bf16)
        if bf16:
            f32 = plain(q1, k1, False)
            # the plain bf16 backward's own movement, over each gradient's
            # largest entry, when q and k change by 1e-7 of themselves (out,
            # lse and do held): how far flipped bf16 roundings move it here
            gen = torch.Generator(device=DEV).manual_seed(7)
            moved_by = plain(*(t * (1 + 1e-7 * torch.randn(
                t.shape, device=DEV, generator=gen)) for t in (q1, k1)), True)
            noise[label] = {n: ((m_ - w).abs().max() / w.abs().max()).item()
                            for n, m_, w in zip(("dq", "dk", "dv"), moved_by,
                                                want)}
            del moved_by
        for fused in (True, False):
            got = FG._backward(*one, (jl1, jc1), (il1, ic1), "euclidean",
                               ones, 0.0, seeds[:1], False, fused, None, bf16)
            sync()
            if bf16:
                gates = {n: bf16_gates(f"N={N_FULL} {label} fused={fused} "
                                       f"{n}", g, w, f)
                         for n, g, w, f in zip(("dq", "dk", "dv"), got, want,
                                               f32)}
                log(f"[{tag}] {'B2' if fused else 'B3a+B3b'} at N={N_FULL}, "
                    f"{label} weights, vs plain bf16: (max abs err, max err, "
                    f"mean err, witness) "
                    + ", ".join(f"{n} {tuple(f'{x:.3e}' for x in t)}"
                                for n, t in gates.items()))
                errs = {n: t[0] for n, t in gates.items()}
                errs["dscale"] = 0.0
            else:
                errs = check_backward(f"N={N_FULL} {label}", got, want, fused)
            for n, e in errs.items():
                full[fused][n] = max(full[fused].get(n, 0.0), e)
        del got, want, one
    full = kernel_errors(full)
    log(f"[{tag}] full-width check's inputs (sums of q, k, v): {sums}"
        + (f"; the plain bf16 backward's movement under a 1e-7 relative "
           f"nudge of q and k, over each largest entry: {noise}"
           if bf16 else ""))
    log(f"[{tag}] backward at N={N_FULL}, one snapshot, seeded and trained "
        f"weights, vs plain{' bf16 (bf16 gates)' if bf16 else ''}: max abs "
        f"err B2 {full['B2']:.3e}, B3a {full['B3a']:.3e}, B3b "
        f"{full['B3b']:.3e}")
    return dict(pack_s=pack_s, runs={str(k): v for k, v in runs.items()},
                default_fused=default, moved=moved, split_ms=splits,
                fold_b1_ms=fold_b1, fold_b2_ms=fold_b2, fold_b3_ms=fold_b3,
                fold_b2=dict(G=G, ms=fold_b2 / G, sdp_ms=fold_b2_sdp / G,
                             library_ms=(None if fold_lib is None
                                         else fold_lib / G)),
                kernel_share_of_step=share, full_err=full, peak_gb=peak_gb,
                check_input_sums=sums, bf16_nudge_noise=noise,
                launches={f: runs[f]["launches"] for f in runs})


# -- phase 6b -----------------------------------------------------------------

def phase_train_edge(tt, FG, bf16=False):
    """[6b] `TAGANTrainer.train` on the 10K-node edge-feature flash model:
    one warm-up step, then 3 steps with launch counts set to 0 just before
    and read just after; step times, split, peak memory, one layer's
    biased backward over the folded snapshots, and one snapshot at full
    width against the plain backward. With ``bf16`` [6f]: the model with
    bf16_matmul=True, the bf16 forms of B4-B7b held to the plain bf16
    parts under the bf16 gates."""
    tag = "6f" if bf16 else "6b"
    kerns = biased_kernels(FG, bf16)
    cfg = edge_model_config(tt, bf16=bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    exp = tt.ExperimentConfig(model=cfg, batch_size=1, num_epochs=1, seed=0,
                              checkpoint_dir="", shuffle=False)
    rng = np.random.default_rng(8)
    ds = tt.TemporalGraphDataset(
        [make_edge_sequence(rng, N_FULL, E_FULL, T_FULL)
         for _ in range(TRAIN_STEPS + 1)], [1.0, 0.0, 1.0, 0.0])
    kw = dict(batch_size=1, dense_adj=False, max_time=T_FULL,
              max_nodes=N_FULL, max_edges=E_FULL)
    warm = tt.TemporalGraphDataLoader(ds.subset([0]), **kw)
    loader = tt.TemporalGraphDataLoader(
        ds.subset(list(range(1, TRAIN_STEPS + 1))), **kw)
    batches = list(loader)                  # packs and caches the sequences
    trainer = tt.TAGANTrainer(model, exp)
    trainer.train(warm, verbose=False)
    sync()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts(FG)
    t0 = time.perf_counter()
    res = trainer.train(loader, verbose=False)
    sync()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    launched = counts(FG)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    want = {k.name: 0 for k in FG.KERNELS}
    for kern in kerns:
        want[kern.name] = cfg.num_layers * TRAIN_STEPS
    losses = res["history"]["train_loss"]
    no_grad = check_grads(model)
    edge_grads = {n: p.grad.abs().max().item()
                  for n, p in model.named_parameters() if "edge" in n}
    moved = sum(int(not torch.equal(p.detach(), before[n]))
                for n, p in model.named_parameters())
    log(f"[{tag}] edge features{', bf16_matmul=True' if bf16 else ''}: "
        f"{TRAIN_STEPS} steps of TAGANTrainer.train in "
        f"{epoch_ms:.3f} ms; mean loss {losses}; peak device memory "
        f"{peak_gb:.3f} GB above the {held_gb:.3f} GB held before; launches "
        f"{launched} (expected {want}); {len(before) - len(no_grad)} of "
        f"{len(before)} gradients finite and non-zero where not zero in exact "
        f"arithmetic; largest |gradient| of the edge parameters {edge_grads}; "
        f"parameters moved {moved} of {len(before)}")
    if launched != want:
        raise AssertionError(f"launches {launched} != {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"loss not finite: {losses}")
    if no_grad:
        raise AssertionError(f"no finite non-zero gradient: {no_grad}")
    if moved != len(before):
        raise AssertionError(f"only {moved} of {len(before)} parameters moved")

    step_ms = step_times(trainer, batches)
    b, y, m = batches[0]
    splits = step_split(trainer, b, y, m)
    log(f"[{tag}] step ms (host clock, synchronised) "
        f"{[round(x, 3) for x in step_ms]}; split (CUDA events) forward / "
        f"backward / optimizer ms {[[round(x, 3) for x in s] for s in splits]}")

    # one layer's kernels over the batch's 8 folded snapshots
    trainer.optimizer.zero_grad()
    folded, _ = layer0_biased_inputs(FG, model, b.to(DEV), N_FULL)
    q, k, v, mask, bias, jlist, jcount = folded
    del folded
    G, H = q.shape[:2]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    plan, plan_t = (jlist, jcount), FG._transposed_plan(mask)
    with torch.no_grad():
        lse1 = kerns[0](q, k, mask, *plan, "euclidean", ones)
        out, lse2 = kerns[1](q, k, v, mask, bias, lse1, *plan, "euclidean",
                             ones, seeds, 0.0)
        do = torch.randn(out.shape, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(9))
        delta2 = (do * out).sum(-1)
        args = (q, k, v, mask, bias, do, lse1, lse2, delta2)
        fold_fwd = cuda_ms(lambda: FG._biased_forward(
            q, k, v, mask, bias, *plan, "euclidean", ones, 0.0, seeds, bf16),
            3)
        fold_b4 = cuda_ms(lambda: kerns[0](q, k, mask, *plan, "euclidean",
                                           ones), 3)
        fold_bwd = cuda_ms(lambda: biased_bwd_kernels(
            FG, *args, plan, plan_t, "euclidean", ones, seeds, 0.0, False,
            bf16), 3)
        walks = fold_walk_times(FG, tag, args, plan, plan_t, ones, seeds,
                                bf16)
    step = min(step_ms)
    share = cfg.num_layers * fold_bwd / step
    log(f"[{tag}] one layer's launches over the {G} folded snapshots: B4+B5 "
        f"{fold_fwd:.3f} ms (B4 {fold_b4:.3f} ms), "
        f"the row and key walks {fold_bwd:.3f} ms; {cfg.num_layers} "
        f"layers' backward kernels = {share:.3f} and with B4+B5 "
        f"{cfg.num_layers * (fold_fwd + fold_bwd) / step:.3f} of the fastest "
        f"step ({step:.3f} ms)")

    # one snapshot at full width against the plain parts
    one = tuple(t[:1].contiguous() for t in args)
    plans = tuple(tuple(t[:1].contiguous() for t in p) for p in (plan, plan_t))
    del args, q, k, v, mask, bias, do, lse1, lse2, delta2, out
    got = biased_bwd_kernels(FG, *one, *plans, "euclidean", ones, seeds[:1],
                             0.0, False, bf16)
    full = biased_bwd_errors(FG, f"N={N_FULL}", got, *one, "euclidean", ones,
                             seeds[:1], 0.0, False, bf16)
    if bf16:
        log(f"[{tag}] bf16 biased backward at N={N_FULL}, one snapshot, vs "
            f"plain bf16 (bf16 gates): worst (max abs err, max err, mean err, "
            f"witness) " + "; ".join(f"{n} {tuple(f'{x:.3e}' for x in r)}"
                                     for n, r in full.items()))
        full = {n: r[0] for n, r in full.items()}
    else:
        log(f"[{tag}] biased backward at N={N_FULL}, one snapshot, vs plain: "
            f"max err row walk {full['B6+B7a']:.3e}, key walk "
            f"{full['B7b']:.3e}")
    return dict(epoch_ms=epoch_ms, step_ms=step_ms, split_ms=splits,
                loss=losses, launches=launched, peak_memory_gb=peak_gb,
                held_gb=held_gb, edge_grad_max=edge_grads, moved=moved,
                fold_b4_b5_ms=fold_fwd, fold_b4_ms=fold_b4,
                fold_b6_b7_ms=fold_bwd, fold_walks=walks,
                b6_b7_share_of_step=share, full_err=full)


def fold_walk_times(FG, tag, args, plan, plan_t, ones, seeds, bf16):
    """The biased backward's walks over 6b's (6f's with ``bf16``) folded
    snapshots, per snapshot: the row walk, the key walk and the two
    together at the euclidean metric, the two at the scaled-dot metric (on
    B4 and B5's statistics there), and the two walks of the other
    precision on the same inputs, in turns."""
    q, k, v, mask, bias, do, lse1, lse2, delta2 = args
    G = q.shape[0]
    kerns = biased_kernels(FG, bf16)
    common = args
    d1 = kerns[2](*common, *plan, "euclidean", ones, seeds, 0.0, False)[0]
    sdp = "scaled_dot_product"
    l1 = kerns[0](q, k, mask, *plan, sdp, ones)
    o, l2 = kerns[1](q, k, v, mask, bias, l1, *plan, sdp, ones, seeds, 0.0)
    sdp_stats = (l1, l2, (do * o).sum(-1))
    del o

    def walks(metric="euclidean", stats=(lse1, lse2, delta2), b16=bf16):
        return lambda: biased_bwd_kernels(
            FG, q, k, v, mask, bias, do, *stats, plan, plan_t, metric, ones,
            seeds, 0.0, False, b16)
    row = cuda_ms(lambda: kerns[2](*common, *plan, "euclidean", ones, seeds,
                                   0.0, False), 5)
    key = cuda_ms(lambda: kerns[3](*common, d1, *plan_t, "euclidean", ones,
                                   seeds, 0.0), 5)
    other = "fp32" if bf16 else "bf16"
    o_a, both_a = cuda_ms(walks(b16=not bf16), 5), cuda_ms(walks(), 5)
    both_b, o_b = cuda_ms(walks(), 5), cuda_ms(walks(b16=not bf16), 5)
    both_sdp = cuda_ms(walks(sdp, sdp_stats), 5)
    res = dict(G=G, row_ms=row / G, key_ms=key / G,
               ms=min(both_a, both_b) / G, sdp_ms=both_sdp / G,
               turns_ms=[both_a / G, both_b / G],
               **{f"{other}_ms": min(o_a, o_b) / G,
                  f"{other}_turns_ms": [o_a / G, o_b / G]})
    log(f"[{tag}] the {'bf16' if bf16 else 'fp32'} biased backward's walks "
        f"over the {G} folded snapshots, per snapshot: row walk "
        f"{res['row_ms']:.5f} ms, key walk {res['key_ms']:.5f} ms, both "
        f"{' '.join(f'{x:.5f}' for x in res['turns_ms'])} ms (scaled-dot "
        f"metric {res['sdp_ms']:.5f}); the {other} walks on the same fold "
        f"{' '.join(f'{x:.5f}' for x in res[f'{other}_turns_ms'])} ms")
    return res


# -- phase 7 ------------------------------------------------------------------

def grad_errors(got, want):
    """(max over tensors of the max abs error over the tensor's largest
    entry, names of the tensors at fp32 noise). A tensor whose largest
    entry is below 1e-6 of the model's largest gradient is zero in exact
    arithmetic (a bias that adds a constant to every score of a softmax
    row comes out as +-1e-9 on either side): there both sides must stay
    below that noise level instead."""
    noise = 1e-6 * max(g.abs().max().item() for g in want.values())
    worst, zero = 0.0, []
    for n, w in want.items():
        m = w.abs().max().item()
        if m < noise:
            zero.append(n)
            if not got[n].abs().max().item() < noise:
                raise AssertionError(f"{n}: gradient {got[n].abs().max()} "
                                     f"where the CPU's is noise ({m})")
        else:
            worst = max(worst, (got[n] - w).abs().max().item() / m)
    return worst, zero


def train_steps(tt, FG, cfg, dev, ds, plan=None, contractions=None):
    """AdamW steps of a fresh model (weights from seed 0) over ``ds``,
    one sequence per batch (the loader's ``plan``): the losses, the first
    step's gradients, the parameters after the last step and the kernels
    launched. ``contractions`` pins the precision of the model's plain
    contractions (`default_matmul_precision`), the kernels' aside."""
    from tagan_torch.core.module import default_matmul_precision
    model = tt.TAGAN(cfg, device=dev,
                     generator=torch.Generator().manual_seed(0))
    if contractions is not None:
        model.precision = lambda: default_matmul_precision(contractions)
    trainer = tt.TAGANTrainer(model, tt.ExperimentConfig(
        model=cfg, batch_size=1, seed=0))
    loader = tt.TemporalGraphDataLoader(ds, batch_size=1, dense_adj=False,
                                        plan=plan)
    losses, grads = [], None
    start = counts(FG)
    for b, y, m in loader:
        trainer.optimizer.zero_grad()
        loss, _ = trainer._loss(b, y, m, True)
        loss.backward()
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
        trainer.optimizer.step()
        losses.append(loss.item())
    launched = {n: c - start[n] for n, c in counts(FG).items()
                if c != start[n]}
    return dict(losses=losses, grads=grads, launched=launched, params={
        n: p.detach().cpu() for n, p in model.named_parameters()})


def card_vs_cpu(label, card, cpu, nodes=N_MID):
    """(gradient, loss, parameter errors, names at noise) of two
    `train_steps` runs; raises past TOL."""
    grad_err, zero = grad_errors(card["grads"], cpu["grads"])
    loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    # parameters only where the first gradient stands above fp32 noise:
    # an exactly-zero gradient comes out as +-1e-9 on either side, and
    # Adam's first step turns its sign into a full +-lr step
    param_err = 0.0
    for n, p in cpu["params"].items():
        g = cpu["grads"][n].abs()
        sel = g > 1e-4 * g.max().clamp(min=1e-30)
        if sel.any():
            param_err = max(param_err,
                            (card["params"][n] - p)[sel].abs().max().item())
    log(f"[{label}] training at N={nodes}, card vs cpu: losses "
        f"{card['losses']} vs {cpu['losses']} (max abs err {loss_err:.3e}); "
        f"first-step gradients max err over each tensor's largest entry "
        f"{grad_err:.3e} ({len(cpu['grads']) - len(zero)} tensors; "
        f"{len(zero)} at fp32 noise, zero in exact arithmetic: {zero}); "
        f"parameters after 3 steps max abs err {param_err:.3e}")
    if not (grad_err <= TOL and loss_err <= TOL and param_err <= TOL):
        raise AssertionError(f"card vs cpu training: grads {grad_err}, "
                             f"losses {loss_err}, params {param_err}")
    return dict(losses={"card": card["losses"], "cpu": cpu["losses"]},
                grad_err=grad_err, noise_tensors=zero, loss_err=loss_err,
                param_err=param_err)


def phase_train_mid(tt, FG):
    cfg = model_config(tt)
    rng = np.random.default_rng(3)
    ds = tt.TemporalGraphDataset(
        [make_sequence(rng, N_MID, 16 * N_MID, T_FULL) for _ in range(3)],
        [1.0, 0.0, 1.0])
    return card_vs_cpu("7", train_steps(tt, FG, cfg, DEV, ds),
                       train_steps(tt, FG, cfg, "cpu", ds))



# -- phase 7e -----------------------------------------------------------------

def phase_train_mid_bf16(tt, FG, edge=False, hybrid=False):
    """[7e] the bf16 model (bf16_matmul=True) at 1,000 nodes: 3 AdamW steps
    on the card (the bf16 kernels) and on the CPU (their plain versions)
    from the same weights and batches: the first step's gradients (but
    those zero in exact arithmetic), the losses, and the parameters where
    the first gradient stands above fp32 noise (as in phase 7), twice.
    (a) The kernels alone at bf16, the plain contractions pinned to fp32
    on both sides: the bf16 gates per gradient, the card's fp32 model the
    witness. (b) The model as it runs, every contraction at bf16: there a
    rounding that an fp32 sum order flips moves its value by 2^-8, and the
    roundings of what it feeds then flip in turn, so the two sides part at
    bf16 class throughout the model; held at bf16-class tolerances.
    With ``edge`` [7f]: the edge-feature model on 7b's graphs, the bf16
    forms of B4-B7b. With ``hybrid`` [7g]: the hybrid model at N_MID_HYB
    nodes on 7c's graphs over ``plan="hybrid"`` loaders, the bf16 forms
    of B1c, B3a c and B3b c. With both [7h]: the edge-feature hybrid
    model on 7d's graphs, the bf16 forms of B4c, B5c, B6c, B7a c and
    B7b c, under 7e's witness and 7f's mean gate (the edge parameters'
    gradients, as in 7f); the CPU's own flip noise is measured and logged
    beside the card's error, as in 7g. Unlike 7g's model, whose band
    alone runs at bf16 and stands close to its fp32 form, the edge bias
    moves this model's bf16 gradients far from the fp32 model's, so 7e's
    10x witness holds."""
    tag = ("7h" if edge else "7g") if hybrid else ("7f" if edge else "7e")
    plan, nodes = ("hybrid", N_MID_HYB) if hybrid else (None, N_MID)
    noise = None
    if hybrid:
        seqs = [hybrid_snaps(N_MID_HYB, DEG_HYB, T_HYB,
                             (80 if edge else 70) + s,
                             edge_dim=F_EDGE if edge else 0)
                for s in range(3)]
        ds = tt.TemporalGraphDataset(seqs, [1.0, 0.0, 1.0])
        cfg16 = hybrid_config(tt, edge, bf16=True)
        f32 = train_steps(tt, FG, hybrid_config(tt, edge), DEV, ds, plan)
        want = {kern.name: 3 * 2 for kern in (
            compact_biased_kernels if edge else compact_kernels)(FG, True)}
        # the model's own sensitivity to flipped roundings: the CPU's
        # kernels-alone gradients on node features changed by 1e-7 of
        # themselves, against the same on the features as they are
        rng = np.random.default_rng(0)
        nudged = tt.TemporalGraphDataset([[dict(s, x=(s["x"] * (
            1 + 1e-7 * rng.standard_normal(s["x"].shape))).astype(
            np.float32)) for s in seq] for seq in seqs], [1.0, 0.0, 1.0])
        base, moved = (train_steps(tt, FG, cfg16, "cpu", d, plan, "highest")
                       for d in (ds, nudged))
        noise = max(((moved["grads"][n] - w).abs().mean()
                     / w.abs().max()).item()
                    for n, w in base["grads"].items() if n not in ZERO_GRAD)
        log(f"[{tag}] the CPU's kernels-alone bf16 gradients moved by a 1e-7 "
            f"relative change of the node features: worst mean {noise:.3e} "
            f"of the largest entry")
    elif edge:
        rng = np.random.default_rng(9)
        ds = tt.TemporalGraphDataset(
            [make_edge_sequence(rng, N_MID, 16 * N_MID, T_FULL, unique=True)
             for _ in range(3)], [1.0, 0.0, 1.0])
        cfg16 = edge_model_config(tt, bf16=True)
        f32 = train_steps(tt, FG, edge_model_config(tt), DEV, ds)
        want = {kern.name: 3 * 2 for kern in biased_kernels(FG, True)}
    else:
        rng = np.random.default_rng(3)
        ds = tt.TemporalGraphDataset(
            [make_sequence(rng, N_MID, 16 * N_MID, T_FULL) for _ in range(3)],
            [1.0, 0.0, 1.0])
        cfg16 = model_config(tt, True)
        f32 = train_steps(tt, FG, model_config(tt), DEV, ds)
        want = {FG.flash_geometric_fwd_bf16_kernel.name: 3 * 2}
        for kern in (flash_kernels(FG, True)[1:2] if FG.FUSED_BWD
                     else flash_kernels(FG, True)[2:]):
            want[kern.name] = 3 * 2
    res = {}
    for part, contractions in (("a", "highest"), ("b", None)):
        card = train_steps(tt, FG, cfg16, DEV, ds, plan, contractions)
        cpu = train_steps(tt, FG, cfg16, "cpu", ds, plan, contractions)
        launched = [r["launched"] for r in (card, cpu)]
        if launched != [want, {}]:
            raise AssertionError(f"launches {launched}, card expected {want}")
        grads = {}
        for n, w in cpu["grads"].items():
            if n in ZERO_GRAD:
                continue
            m = w.abs().max()
            err = (card["grads"][n] - w).abs()
            grads[n] = ((err.max() / m).item(), (err.mean() / m).item(),
                        ((f32["grads"][n] - w).abs().mean() / m).item(),
                        w.numel())
        worst = tuple(max(g[i] for g in grads.values()) for i in range(3))
        top = {i: sorted(grads, key=lambda n: -grads[n][i])[:3]
               for i in (0, 1)}
        log(f"[{tag}{part}] largest max errors "
            f"{[(n, f'{grads[n][0]:.3e}', grads[n][3]) for n in top[0]]}; "
            f"largest mean errors "
            f"{[(n, f'{grads[n][1]:.3e}', grads[n][3]) for n in top[1]]}")
        # the witness over the model: some tensors lie far from the
        # attention layers, where the kernels' rounding barely reaches. With
        # edge features it is held against the mean errors of the tensors
        # of more than one entry: a one-entry tensor's mean error is its
        # max error, which the max gate holds
        mean_tol = BF16_EDGE_MEAN_TOL if edge else BF16_MODEL_MEAN_TOL
        witness = BF16_HYB_WITNESS if hybrid and not edge \
            else BF16_MODEL_WITNESS
        wit_mean = max(g[1] for g in grads.values()
                       if g[3] > 1 or not edge)
        if part == "a" and not (
                worst[0] <= BF16_MAX_TOL and worst[1] <= mean_tol
                and worst[2] >= witness * wit_mean):
            raise AssertionError(f"gradients: max err {worst[0]}, mean err "
                                 f"{worst[1]} ({wit_mean} over tensors of "
                                 f"more than one entry), witness {worst[2]}")
        loss_err = max(abs(a - b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
        param_err = 0.0
        for n, p in cpu["params"].items():
            g = cpu["grads"][n].abs()
            sel = g > 1e-4 * g.max().clamp(min=1e-30)
            if sel.any():
                param_err = max(param_err, (card["params"][n]
                                            - p)[sel].abs().max().item())
        what = "kernels alone" if part == "a" else "every contraction"
        log(f"[{tag}{part}] bf16 training at N={nodes}, card vs cpu, {what} "
            f"at bf16: losses {card['losses']} vs {cpu['losses']} (max abs err "
            f"{loss_err:.3e}); first-step gradients over each tensor's "
            f"largest entry: worst max err, worst mean err, largest mean "
            f"fp32 distance {tuple(f'{x:.3e}' for x in worst)}; parameters "
            f"after "
            f"3 steps max abs err {param_err:.3e}; launches {launched}")
        tols = (TOL, BF16_KERNELS_PARAM) if part == "a" else (
            BF16_MODEL_LOSS, BF16_MODEL_PARAM)
        if part == "b" and not worst[0] <= BF16_MODEL_GRAD:
            raise AssertionError(f"gradients {worst[0]} > {BF16_MODEL_GRAD}")
        if not (loss_err <= tols[0] and param_err <= tols[1]):
            raise AssertionError(f"losses {loss_err}, parameters {param_err}"
                                 f" > {tols}")
        res[part] = dict(losses={"card": card["losses"], "cpu": cpu["losses"]},
                         grad_worst=worst, loss_err=loss_err,
                         param_err=param_err)
    res["cpu_nudge_mean_err"] = noise
    return res


# -- phase 7b -----------------------------------------------------------------

def phase_train_mid_edge(tt, FG):
    """The edge-feature flash model at 1,000 nodes: 3 AdamW steps on the
    card (B4, B5, the row walk and the key walk) and on the CPU (plain
    versions) from the same weights and batches, and its first-step
    gradients against its csr form on the card (csr's autograd, an
    independent formula for dB), on distinct non-loop edges."""
    rng = np.random.default_rng(9)
    ds = tt.TemporalGraphDataset(
        [make_edge_sequence(rng, N_MID, 16 * N_MID, T_FULL, unique=True)
         for _ in range(3)], [1.0, 0.0, 1.0])
    card = train_steps(tt, FG, edge_model_config(tt), DEV, ds)
    cpu = train_steps(tt, FG, edge_model_config(tt), "cpu", ds)
    csr = train_steps(tt, FG, edge_model_config(tt, "csr"), DEV, ds)
    res = card_vs_cpu("7b", card, cpu)
    csr_err, csr_zero = grad_errors(card["grads"], csr["grads"])
    launched = [r["launched"] for r in (card, cpu, csr)]
    want = {k.name: 3 * 2 for k in biased_kernels(FG, False)}
    log(f"[7b] edge features: first-step gradients flash vs csr on the card "
        f"{csr_err:.3e} (tol {TOL_CSR}; at noise {csr_zero}); launches card, "
        f"cpu, csr {launched}")
    if launched != [want, {}, {}]:
        raise AssertionError(f"launches {launched}, card expected {want}")
    if not csr_err <= TOL_CSR:
        raise AssertionError(f"flash vs csr gradients {csr_err} > {TOL_CSR}")
    return dict(res, csr_grad_err=csr_err)


# -- phase 2e -----------------------------------------------------------------

def compact_small_inputs(FG, G, H, N, D, Dv, metric, seed, pack):
    """`biased_small_inputs` moved to the compact store (bits or int8):
    the store, a bias store in its slots and the plan (jlist, jcount,
    jslot); the mask keeps its dead rows and, for G > 1, a row tile with
    jcount = 0."""
    q, k, v, mask, bias, scale, seeds = biased_small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    store, plan = FG.compact_from_mask(mask, pack=pack)
    return (q, k, v, mask, store, FG.compact_values(mask, bias), plan, scale,
            seeds)


def compact_vs_plain(FG, G, H, N, D, Dv, metric, rate, pack, seed=0):
    """B1c, B4c and B5c (on B4c's lse1 merged with a second one, as the
    hybrid band's union lse1 is) against their compact plain versions;
    returns {kernel: max abs error over live rows} after checking dead
    rows exactly."""
    q, k, v, mask, store, bias_store, plan, scale, seeds = \
        compact_small_inputs(FG, G, H, N, D, Dv, metric, seed, pack)
    from tagan_torch.ops.hybrid_biased import lse_union
    out, lse = FG.flash_geometric_fwd_compact_kernel(
        q, k, v, store, *plan, metric, scale, seeds[:, 0].contiguous(), rate)
    lse1 = FG.flash_lse1_compact_kernel(q, k, store, *plan, metric, scale)
    other = torch.randn(lse1.shape, device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    lse1_u = lse_union(lse1, other).contiguous()
    out2, lse2 = FG.flash_biased_fwd_compact_kernel(
        q, k, v, store, bias_store, lse1_u, *plan, metric, scale, seeds, rate)
    p_out, p_lse = FG.flash_geometric_forward_compact_plain(
        q, k, v, store, *plan, metric, scale, rate, seeds[:, 0])
    p_lse1 = FG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale)
    p_out2, p_lse2 = FG.flash_biased_forward_compact_plain(
        q, k, v, store, bias_store, lse1_u, *plan, metric, scale, rate, seeds)
    sync()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (all(torch.all(t[dead] == FG.LSE_DEAD)
                for t in (lse, p_lse, lse1, p_lse1, lse2, p_lse2))
            and all(torch.all(t[dead] == 0)
                    for t in (out, p_out, out2, p_out2))):
        raise AssertionError(f"compact {metric} rate={rate}: dead rows differ")
    live = ~dead
    err = {"B1c": max((out - p_out)[live].abs().max().item(),
                      (lse - p_lse)[live].abs().max().item()),
           "B4c": (lse1 - p_lse1)[live].abs().max().item(),
           "B5c": max((out2 - p_out2)[live].abs().max().item(),
                      (lse2 - p_lse2)[live].abs().max().item())}
    if not max(err.values()) <= TOL:
        raise AssertionError(f"compact {metric} rate={rate} D={D} Dv={Dv} "
                             f"pack={pack}: errors {err} > {TOL}")
    return err


def compact_fwd_walk_runs(FG):
    """The band cases at which 2e and 2k hold the compact forward walk,
    B5c and B1c (the arguments of `tests.test_torch_gpu`'s
    `compact_fwd_walk_check` and `compact_out_walk_check` after the
    precision; B4c's, `compact_lse_walk_check`'s, are these without Dv
    and the dropout rate): every metric with the dropouts off and on,
    both stores;
    (D, Dv) of (16, 16), (8, 8), (12, 12), (7, 3) and (128, 128), both
    stores; folds of 1, 4 and 33 heads; and two cases called 20 times,
    bit for bit."""
    runs = [(2, 4, 330, 16, 16, metric, rate, pack)
            for pack in (True, False) for metric in FG.MXU_METRICS
            for rate in (0.0, 0.1)]
    runs += [(1, 2, 330, D, Dv, "gaussian_kernel", 0.1, pack, 1)
             for pack in (True, False)
             for D, Dv in ((16, 16), (8, 8), (12, 12), (7, 3), (128, 128))]
    runs += [(2, H, 330, 16, 16, "gaussian_kernel", 0.1, True, 5)
             for H in (1, 4, 33)]
    runs += [(2, 4, 1008, 16, 16, "gaussian_kernel", 0.1, pack, 3, 20)
             for pack in (True, False)]
    return runs


def phase_compact_fwd_walk(FG, bf16):
    """The compact forward pair walk (``bf16``: its bf16 form) in its three
    modes, B5c, B1c (with dropout, far from the plain version at another
    seed) and B4c, at `compact_fwd_walk_runs`' band cases, outputs
    allocated NaN-filled and set everywhere, dead rows exactly 0 and
    LSE_DEAD, one launch each, against the compact plain versions: within
    TOL, or under the bf16 gates (B4c: the max and mean gates). Returns
    {kernel: (cases, worst error)}."""
    from tests.test_torch_gpu import (compact_fwd_walk_check,
                                      compact_lse_walk_check,
                                      compact_out_walk_check)
    runs = compact_fwd_walk_runs(FG)
    lse_runs = list(dict.fromkeys(r[:4] + (r[5], r[7]) + r[8:]
                                  for r in runs))
    out = {}
    for name, check, cases in (("B5c", compact_fwd_walk_check, runs),
                               ("B1c", compact_out_walk_check, runs),
                               ("B4c", compact_lse_walk_check, lse_runs)):
        errs = [check(DEV, bf16, *run) for run in cases]
        out[name] = (len(errs), tuple(
            max(e[i] for e in errs) if i < 3 else min(e[i] for e in errs)
            for i in range(4)) if bf16 else max(errs))
    return out


def phase_small_compact(FG):
    errs = []
    for pack in (True, False):
        for metric in FG.MXU_METRICS:
            for rate in (0.0, 0.1):
                errs.append(compact_vs_plain(FG, 2, 3, 150, 16, 8, metric,
                                             rate, pack))
        for D, Dv in ((7, 3), (40, 72), (128, 128)):
            errs.append(compact_vs_plain(FG, 2, 2, 200, D, Dv,
                                         "gaussian_kernel", 0.1, pack, 1))
    out = {name: max(e[name] for e in errs) for name in ("B1c", "B4c", "B5c")}
    walks = phase_compact_fwd_walk(FG, False)
    for name, (_, err) in walks.items():
        out[name] = max(out[name], err)
    log(f"[2e] B1c, B4c and B5c vs their compact plain versions, bit and "
        f"int8 stores: {len(errs)} cases; the compact forward walk at the "
        f"band's cases (every metric, dropouts off and on, head dims, folds "
        f"of 1, 4 and 33 heads, outputs allocated NaN-filled, two cases 20 "
        f"times bit for bit): "
        + ", ".join(f"{n} {c} cases, max abs err {e:.3e}"
                    for n, (c, e) in walks.items())
        + f"; max abs err {out} (tol {TOL})")
    return out


# -- phase 2f -----------------------------------------------------------------

def compact_bwd_inputs(FG, G, H, N, D, Dv, metric, seed, pack):
    """`small_inputs` moved to the compact store (bits or int8): q, k, v,
    do, dlse, the mask (dead rows, a key strip whose transposed walk is
    empty, icount = 0, and for G > 1 a row tile with jcount = 0), the
    store, both walks, scale and seeds."""
    q, k, v, do, dlse, mask, scale, seeds = small_inputs(FG, G, H, N, D, Dv,
                                                         metric, seed)
    store, plan = FG.compact_from_mask(mask, pack=pack)
    return (q, k, v, do, dlse, mask, store, plan,
            FG.compact_transposed_plan(mask), scale, seeds)


def compact_errors(res):
    """Each compact backward kernel's error from its own outputs, given
    `check_backward`'s {output: error}: B3a c dq and dscale, B3b c dk and
    dv."""
    return {"B3a c": max(res["dq"], res["dscale"]),
            "B3b c": max(res["dk"], res["dv"])}


def compact_bwd_vs_plain(FG, G, H, N, D, Dv, metric, rate, pack, seed=0):
    """B3a c then B3b c against the compact plain backward on one input,
    with an lse cotangent and dscale where the metric has a scale;
    dq exactly 0 on dead rows and dk, dv on the empty key strip. Returns
    {kernel: error} (`compact_errors`)."""
    q, k, v, do, dlse, mask, store, plan, plan_t, scale, seeds = \
        compact_bwd_inputs(FG, G, H, N, D, Dv, metric, seed, pack)
    need = metric in FG.SCALED_METRICS
    out, lse = (t.contiguous() for t in
                FG.flash_geometric_forward_compact_plain(
                    q, k, v, store, *plan, metric, scale, rate, seeds))
    want = FG.flash_geometric_backward_compact_plain(
        q, k, v, store, out, lse, do, *plan, metric, scale, rate, seeds, need,
        dlse)
    got = FG._backward_compact(q, k, v, store, out, lse, do, plan, plan_t,
                               metric, scale, rate, seeds, need, dlse)
    sync()
    label = f"compact {metric} rate={rate} D={D} Dv={Dv} pack={pack}"
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    strip = slice(FG.BLOCK_N, 2 * FG.BLOCK_N)
    if not (torch.all(got[0][dead] == 0) and torch.all(want[0][dead] == 0)
            and (N <= 2 * FG.BLOCK_M or (torch.all(got[1][0, :, strip] == 0)
                                         and torch.all(got[2][0, :, strip]
                                                       == 0)))):
        raise AssertionError(f"{label}: dead rows or the empty key strip "
                             f"not exactly 0")
    return compact_errors(check_backward(label, got, want, False))


def compact_walk_runs(FG, folds, seed):
    """The band cases at which 2f and 2j hold a compact backward walk
    (the arguments of `tests.test_torch_gpu`'s `compact_bwd_walk_check`
    and `compact_dq_walk_check` after the precision): every metric with
    dropout off and on, both stores; (D, Dv) of (16, 16), (8, 8), (12,
    12), (7, 3) and (128, 128), both stores; ``folds``' (H, D); and two
    cases called 20 times, bit for bit, at ``seed``."""
    runs = [(2, 4, 330, 16, 16, metric, rate, pack)
            for pack in (True, False) for metric in FG.MXU_METRICS
            for rate in (0.0, 0.1)]
    runs += [(1, 2, 330, D, Dv, "gaussian_kernel", 0.1, pack, 1)
             for pack in (True, False)
             for D, Dv in ((16, 16), (8, 8), (12, 12), (7, 3), (128, 128))]
    runs += [(2, H, 330, D, D, "gaussian_kernel", 0.1, True, 5)
             for H, D in folds]
    runs += [(2, 4, 1008, 16, 16, "gaussian_kernel", 0.1, pack, seed, 20)
             for pack in (True, False)]
    return runs


def phase_compact_walks(FG, bf16):
    """B3b c's compact key pair walk and B3a c's compact row pair walk
    (``bf16``: their bf16 forms) at `compact_walk_runs`' band cases: the
    key walk with folds of 1, 4 and 12 heads (two head groups of its
    block's 8) and 12 at head dim 128, the row walk with 1, 4 and 33 heads
    (two groups of a warp's 32) and 33 at head dim 128, and its 20-call
    cases at seed 4 (`test_compact_dq_walk_deterministic`'s); outputs
    allocated NaN-filled and set everywhere, one launch each, against the
    compact plain backward: within TOL, or under the bf16 gates. Returns
    {kernel: (cases, worst error)}."""
    from tests.test_torch_gpu import (compact_bwd_walk_check,
                                      compact_dq_walk_check)
    out = {}
    for name, check, folds, seed in (
            ("B3b c", compact_bwd_walk_check,
             ((1, 16), (4, 16), (12, 16), (12, 128)), 3),
            ("B3a c", compact_dq_walk_check,
             ((1, 16), (4, 16), (33, 16), (33, 128)), 4)):
        errs = [check(DEV, bf16, *run)
                for run in compact_walk_runs(FG, folds, seed)]
        out[name] = (len(errs), tuple(
            max(e[i] for e in errs) if i < 3 else min(e[i] for e in errs)
            for i in range(4)) if bf16 else max(errs))
    return out


def phase_small_compact_bwd(FG):
    errs = []
    for pack in (True, False):
        for metric in FG.MXU_METRICS:
            for rate in (0.0, 0.1):
                errs.append(compact_bwd_vs_plain(FG, 2, 3, 150, 16, 8, metric,
                                                 rate, pack))
        for D, Dv in ((7, 3), (40, 72), (128, 128)):
            errs.append(compact_bwd_vs_plain(FG, 2, 2, 200, D, Dv,
                                             "gaussian_kernel", 0.1, pack, 1))
    out = {name: max(e[name] for e in errs) for name in ("B3a c", "B3b c")}
    walks = phase_compact_walks(FG, False)
    (n_band, band_err), (n_rows, row_err) = walks["B3b c"], walks["B3a c"]
    out["B3b c"] = max(out["B3b c"], band_err)
    out["B3a c"] = max(out["B3a c"], row_err)
    log(f"[2f] B3a c (dq, dscale) and B3b c (dk, dv) vs the compact plain "
        f"backward, bit and int8 stores, lse cotangent: {len(errs)} cases; "
        f"B3b c's walk at the band's cases (every metric, dropout off and "
        f"on, head dims, folds of 1, 4 and 12 heads, outputs allocated "
        f"NaN-filled, two cases 20 times bit for bit): {n_band} cases, max "
        f"abs err {band_err:.3e}; B3a c's walk at the band's cases (every "
        f"metric, dropout off and on, dscale, head dims, folds of 1, 4 and "
        f"33 heads, outputs allocated NaN-filled, two cases 20 times bit "
        f"for bit): {n_rows} cases, max abs err {row_err:.3e}; max err "
        f"{out} (tol {TOL})")
    return out


# -- phase 2j -----------------------------------------------------------------

def compact_bf16_vs_plain(FG, G, H, N, D, Dv, metric, rate, pack, seed=0):
    """B1c, B3a c and B3b c in their bf16 forms against the compact plain
    bf16 versions on one input of 2f (the backward from the plain bf16
    forward), under the bf16 gates with the compact plain fp32 versions
    as the witness; dead rows, and dk and dv on the empty key strip,
    exactly 0. Returns {kernel: (max abs error, max error, mean error,
    witness)} of its worst output."""
    q, k, v, do, dlse, mask, store, plan, plan_t, scale, seeds = \
        compact_bwd_inputs(FG, G, H, N, D, Dv, metric, seed, pack)
    label = f"compact bf16 {metric} rate={rate} D={D} Dv={Dv} pack={pack}"
    out, lse = FG.flash_geometric_fwd_compact_bf16_kernel(
        q, k, v, store, *plan, metric, scale, seeds, rate)
    sync()
    fwd = (q, k, v, store, *plan, metric, scale, rate, seeds)
    p_out, p_lse = FG.flash_geometric_forward_compact_plain(*fwd, bf16=True)
    f_out, f_lse = FG.flash_geometric_forward_compact_plain(*fwd)
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
            and torch.all(p_out[dead] == 0)):
        raise AssertionError(f"{label}: dead rows differ")
    res = {"B1c": max(
        bf16_gates(f"{label} out", out[~dead], p_out[~dead], f_out[~dead]),
        bf16_gates(f"{label} lse", lse[~dead], p_lse[~dead], f_lse[~dead],
                   witness=False))}
    need = metric in FG.SCALED_METRICS
    args = (q, k, v, store, p_out.contiguous(), p_lse.contiguous(), do)
    rest = (*plan, metric, scale, rate, seeds, need, dlse)
    want = FG.flash_geometric_backward_compact_plain(*args, *rest, bf16=True)
    f32 = FG.flash_geometric_backward_compact_plain(*args, *rest)
    got = FG._backward_compact(*args, plan, plan_t, metric, scale, rate,
                               seeds, need, dlse, True)
    sync()
    strip = slice(FG.BLOCK_N, 2 * FG.BLOCK_N)
    if not (torch.all(got[0][dead] == 0)
            and (N <= 2 * FG.BLOCK_M or (torch.all(got[1][0, :, strip] == 0)
                                         and torch.all(got[2][0, :, strip]
                                                       == 0)))):
        raise AssertionError(f"{label}: dead rows or the empty key strip "
                             f"not exactly 0")
    for name, idx in (("B3a c", (0, 3)), ("B3b c", (1, 2))):
        res[name] = max(
            bf16_gates(f"{label} {name} {'dq dk dv dscale'.split()[i]}",
                       got[i], want[i], f32[i], witness=i < 3, mean=i < 3)
            for i in idx if want[i] is not None)
    return res


def phase_small_compact_bf16(FG):
    """[2j] B1c, B3a c and B3b c's bf16 forms, bit and int8 stores: every
    metric with dropout 0 and 0.1 at (D, Dv) = (16, 8), and (D, Dv) of
    (16, 16), (8, 8), (12, 12), (7, 3) and (128, 128); an lse cotangent,
    dscale for gaussian/rbf, dead rows, a row tile with jcount = 0, an
    empty key strip; B3b c bf16's and B3a c bf16's walks at 2f's band
    cases. Then a jslot past the store raises before any launch, at the
    forward's entry and at B3a c's and B3b c's bf16 wrappers."""
    cases = [(metric, 16, 8, rate) for metric in FG.MXU_METRICS
             for rate in (0.0, 0.1)]
    cases += [("scaled_dot_product", 16, 16, 0.1), ("scaled_dot_product", 8,
                                                    8, 0.1),
              ("gaussian_kernel", 12, 12, 0.0), ("dot_product", 7, 3, 0.1),
              ("euclidean", 128, 128, 0.1)]
    worst = {}
    for pack in (True, False):
        for metric, D, Dv, rate in cases:
            for name, r in compact_bf16_vs_plain(FG, 2, 3, 150, D, Dv, metric,
                                                 rate, pack).items():
                worst[name] = max(worst.get(name, r), r)
    walks = phase_compact_walks(FG, True)
    (n_band, band), (n_rows, rows) = walks["B3b c"], walks["B3a c"]
    worst["B3b c"] = max(worst["B3b c"], band)
    worst["B3a c"] = max(worst["B3a c"], rows)
    q, k, v, do, _, _, store, plan, plan_t, scale, seeds = \
        compact_bwd_inputs(FG, 1, 2, 150, 16, 16, "dot_product", 0, True)
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    js[0, 0, 0] = isl[0, 0, 0] = store.shape[1]
    lse = torch.zeros(1, 2, 150, device=DEV)
    before = counts(FG)
    refused = 0
    for call in (
            lambda: FG.flash_geometric_fwd_compact(
                q, k, v, store, jl, jc, js, metric="dot_product", bf16=True),
            lambda: FG.flash_geometric_bwd_dq_compact_bf16_kernel(
                q, k, v, store, do, lse, lse, jl, jc, js, "dot_product",
                scale, seeds, 0.0, False),
            lambda: FG.flash_geometric_bwd_dkv_compact_bf16_kernel(
                q, k, v, store, do, lse, lse, il, ic, isl, "dot_product",
                scale, seeds, 0.0)):
        try:
            call()
        except ValueError:
            refused += 1
    if refused != 3 or counts(FG) != before:
        raise AssertionError(f"a bad jslot: {refused} of 3 entries refused "
                             f"it; launches {counts(FG)} vs {before}")
    log(f"[2j] bf16 forms of B1c, B3a c and B3b c vs the compact plain bf16 "
        f"versions, bit and int8 stores: {2 * len(cases)} cases; B3b c bf16's "
        f"walk at 2f's band cases: {n_band} cases, worst "
        f"{tuple(f'{x:.3e}' for x in band)}; B3a c bf16's walk there: "
        f"{n_rows} cases, worst {tuple(f'{x:.3e}' for x in rows)}; worst (max "
        f"abs err, max err, mean err, witness over the largest entry) "
        + "; ".join(f"{n} {tuple(f'{x:.3e}' for x in r)}"
                    for n, r in worst.items())
        + f" (tol {BF16_MAX_TOL}, {BF16_MEAN_TOL}, witness {BF16_WITNESS}x);"
        f" a bad jslot raised before launch at all 3 entries")
    return {n: r[0] for n, r in worst.items()}


# -- phases 3c, 3d, 4c, 4d, 5d: the hybrid backend at 131,072 nodes -----------

def hybrid_snaps(n, deg, t_len, seed, locality=0.95, width=None,
                 edge_dim=0, unique=False):
    """``benchmarks/bench_partition_stress.py``'s ``_snaps`` (its part C,
    the hybrid model's graphs): deg * n edges per snapshot, a fraction
    ``locality`` of them within +-width of their source, the rest
    uniform; N(0, 1) edge features from ``default_rng(seed + 1)`` with
    ``edge_dim``. ``unique`` keeps the distinct non-loop edges only."""
    rng = np.random.default_rng(seed)
    rng_b = np.random.default_rng(seed + 1)
    e = n * deg
    w = width or max(n // 256, 8)
    out = []
    for t in range(t_len):
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        sel = rng.random(e) < locality
        near = np.clip(src + rng.integers(-w, w + 1, e), 0, n - 1)
        dst = np.where(sel, near, dst)
        if unique:
            key = np.unique(src * n + dst)
            key = key[key // n != key % n]
            src, dst = key // n, key % n
        s = {"x": rng.standard_normal((n, F_HYB)).astype(np.float32),
             "edge_index": np.stack([src, dst]), "node_ids": np.arange(n),
             "timestep": float(t)}
        if edge_dim:
            s["edge_attr"] = rng_b.standard_normal(
                (len(src), edge_dim)).astype(np.float32)
        out.append(s)
    return out


def hybrid_config(tt, edge=False, backend="hybrid", bf16=False):
    """``bench_partition_stress.py`` part C's model (:226-238): hidden 64,
    4 heads, 2 layers, node features 8, bce, no dropout; with ``edge``
    its edge features (Fe = 4, ``use_edge_features``), with ``bf16``
    ``bf16_matmul``."""
    return tt.TAGANConfig(hidden_dim=64, num_heads=4, num_layers=2,
                          node_feature_dim=F_HYB, output_dim=1,
                          loss_type="bce", dropout=0.0,
                          edge_feature_dim=F_EDGE if edge else 0,
                          use_edge_features=edge, spatial_backend=backend,
                          bf16_matmul=bf16)


def hybrid_layer0(FG, model, batch):
    """Layer 0's compact-kernel inputs of a packed hybrid batch, its B*T
    snapshots folded: (q, k, v, store, plan, residual (eq, ek, em)) and,
    with edge features, (bias store, residual bias)."""
    from tagan_torch.nn.model import hybrid_bias_store, hybrid_residual_bias
    layer = model.geometric_layers["layer_0"]
    with torch.no_grad():
        q, k, v = layer.attn._qkv(model.node_embedding(batch.x))
        G = q.shape[0] * q.shape[1]
        fold = tuple(t.reshape(G, *t.shape[2:]).contiguous()
                     for t in (q, k, v))
        store, plan = FG.fold_compact(batch.hyb_mask_blocks, batch.hyb_plan,
                                      G)
        res = tuple(t.reshape(G, -1) for t in batch.hyb_res)
        extra = None
        if model.edge_bias_on:
            b = layer.edge_bias(model.edge_embedding(batch.edge_attr))[..., 0]
            b = torch.where(batch.edge_mask, b, torch.zeros_like(b))
            bst = hybrid_bias_store(b, batch)
            extra = (bst.reshape(G, *bst.shape[2:]).contiguous(),
                     hybrid_residual_bias(b, batch).reshape(G, -1))
    return fold + (store, plan, res), extra


def hybrid_requests(edge, seed0):
    """REQUESTS requests of SEQS_PER_REQUEST 131K sequences and their
    dims."""
    reqs = [[hybrid_snaps(N_HYB, DEG_HYB, T_HYB, seed0 + 10 * r + s,
                          edge_dim=F_EDGE if edge else 0)
             for s in range(SEQS_PER_REQUEST)] for r in range(REQUESTS)]
    return reqs, (T_HYB, N_HYB, N_HYB * DEG_HYB, F_EDGE if edge else 0)


def phase_serve_hybrid(tt, FG, edge, bf16=False, reqs=None):
    """Serve the 131K hybrid model (``edge``: with edge features) with
    `Predictor` (each request planned at its own sizes): REQUESTS
    requests, launch counts set to 0 just before and read just after;
    forward, one request's host packing and plan build, peak memory, one
    layer's compact launches over the folded snapshots; the first layer's
    kernels on one snapshot against their plain versions at full width.
    With ``bf16`` [3g]: the plain model with bf16_matmul=True on 3c's
    requests ``reqs`` (B1c's bf16 form once per layer per request,
    nothing else), held to the plain bf16 version under the bf16 gates,
    and the fp32 model's logits on the same request and weights beside
    the bf16 model's. With ``edge`` and ``bf16`` [3h]: the edge-feature
    model with bf16_matmul=True on 3d's requests (the bf16 forms of B4c
    and B5c once per layer per request, nothing else), held to their
    plain bf16 versions under the bf16 gates, the fp32 edge model's
    logits beside. The requests are returned under "reqs"."""
    from tagan_torch.core.graph import attach_hybrid_plans
    from tagan_torch.ops.hybrid_biased import lse_union, residual_lse1
    label = ("3h" if bf16 else "3d") if edge else ("3g" if bf16 else "3c")
    cfg = hybrid_config(tt, edge, bf16=bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    if reqs is None:
        reqs, dims = hybrid_requests(edge, 300 if edge else 100)
    else:
        dims = (T_HYB, N_HYB, N_HYB * DEG_HYB, F_EDGE if edge else 0)
    b1c = compact_kernels(FG, bf16)[0]
    b4c, b5c = compact_biased_kernels(FG, bf16)[:2]
    pred = tt.Predictor(model, dims=dims, batch_size=SEQS_PER_REQUEST)
    pred.warmup()
    sync()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts(FG)
    lat, probs = [], []
    for req in reqs:
        t0 = time.perf_counter()
        probs.append(pred.predict_proba(req))   # host copy: synchronises
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = counts(FG)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    expected = {k.name: 0 for k in FG.KERNELS}
    for kern in ((b4c, b5c) if edge else (b1c,)):
        expected[kern.name] = cfg.num_layers * REQUESTS
    probs = np.concatenate(probs)
    finite = bool(np.isfinite(probs).all())
    log(f"[{label}] hybrid N={N_HYB}, E={N_HYB * DEG_HYB}/snapshot, T={T_HYB}"
        f"{', edge features' if edge else ''}"
        f"{', bf16_matmul=True' if bf16 else ''}: request latency ms "
        f"{[round(x, 3) for x in lat]}; sequences/s "
        f"{REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3):.3f}; peak device "
        f"memory {peak_gb:.3f} GB above {held_gb:.3f} GB held; launches "
        f"{launched} (expected {expected}); probabilities finite {finite}, "
        f"shape {probs.shape}")
    if launched != expected:
        raise AssertionError(f"launches {launched} != {expected}")
    if not finite or probs.shape != (REQUESTS * SEQS_PER_REQUEST, 1):
        raise AssertionError("bad probabilities")

    # one request's host side alone: packing and planning, then the
    # planning again on its packed sequences
    t0 = time.perf_counter()
    seqs = pred._pack(reqs[0])
    req_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, pin = attach_hybrid_plans(seqs)
    req_plan_s = time.perf_counter() - t0
    log(f"[{label}] one request's packing and planning {req_pack_s:.3f} s, "
        f"of which planning {req_plan_s:.3f} s; its plan sizes {pin}")
    batch = tt.batch_sequences(seqs).to(DEV)
    with torch.inference_mode():
        model(batch)
        sync()
        t0 = time.perf_counter()
        logits = model(batch).logits
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    gap = None
    if bf16:
        f32 = tt.TAGAN(hybrid_config(tt, edge), device=DEV,
                       generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            logits32 = f32(batch).logits
        gap = (logits - logits32).abs().max().item()
        del f32
        log(f"[{label}] logits of the fp32 model on the same request and "
            f"weights: max abs gap {gap:.4e} (bf16 {logits.ravel()}, fp32 "
            f"{logits32.ravel()})")
    (q, k, v, store, plan, rs), extra = hybrid_layer0(FG, model, batch)
    G, H = q.shape[:2]
    ones = torch.ones(H, device=DEV)
    res = dict(latency_ms=lat, launches=launched, forward_ms=fwd_ms,
               peak_memory_gb=peak_gb, held_gb=held_gb, pin=pin,
               request_pack_plan_s=req_pack_s, request_plan_s=req_plan_s,
               sequences_per_s=REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3),
               fp32_logits_gap=gap)
    with torch.inference_mode():
        if not edge:
            seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
            res["b1c_layer_ms"] = cuda_ms(
                lambda: b1c(q, k, v, store, *plan, "euclidean", ones, seeds,
                            0.0), 3)
            one = (q[:1], k[:1], v[:1], store[:1], tuple(p[:1] for p in plan),
                   tuple(t[:1] for t in rs))
            out, lse = b1c(*one[:4], *one[4], "euclidean", ones, seeds[:1],
                           0.0)
            fwd = (*one[:4], *one[4], "euclidean", ones, 0.0, seeds[:1])
            p_out, p_lse = FG.flash_geometric_forward_compact_plain(
                *fwd, bf16=bf16)
            sync()
            name = "B1c bf16" if bf16 else "B1c"
            if bf16:
                f_out, f_lse = FG.flash_geometric_forward_compact_plain(*fwd)
                live = p_lse < 1e29
                gates = max(bf16_gates("full-width out", out[live],
                                       p_out[live], f_out[live]),
                            bf16_gates("full-width lse", lse[live],
                                       p_lse[live], f_lse[live],
                                       witness=False))
                if not (torch.all(out[~live] == 0)
                        and torch.all(lse[~live] == FG.LSE_DEAD)):
                    raise AssertionError("full-width dead rows differ")
                res["full_err"], res["full_gates"] = gates[0], gates
                err_text = (f"(max abs err, max err, mean err, witness) "
                            f"{tuple(f'{x:.3e}' for x in gates)}")
            else:
                res["full_err"] = max((out - p_out).abs().max().item(),
                                      (lse - p_lse).abs().max().item())
                err_text = f"max abs err {res['full_err']:.3e}"
            share = cfg.num_layers * res["b1c_layer_ms"] / fwd_ms
            log(f"[{label}] forward on a packed request {fwd_ms:.3f} ms; one "
                f"request's packing and planning {req_pack_s:.3f} s; one "
                f"layer's {name} over the {G} folded snapshots "
                f"{res['b1c_layer_ms']:.3f} ms ({cfg.num_layers} layers = "
                f"{share:.3f} of the forward); layer-0 {name} vs plain"
                f"{' bf16' if bf16 else ''} on one snapshot: {err_text}")
            args = one
        else:
            bst, rb = extra
            seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
            from tagan_torch.nn.model import hybrid_bias_store
            emb = model.edge_embedding(batch.edge_attr)
            eb = model.geometric_layers["layer_0"].edge_bias
            res["bias_store_build_ms"] = cuda_ms(lambda: hybrid_bias_store(
                eb(emb)[..., 0], batch), 3)
            del emb
            lse1_b = b4c(q, k, store, *plan, "euclidean", ones)
            lse1_u = lse_union(lse1_b, residual_lse1(
                "euclidean", q, k, *rs, N_HYB, ones)).contiguous()
            res["b4c_layer_ms"] = cuda_ms(
                lambda: b4c(q, k, store, *plan, "euclidean", ones), 3)
            res["b5c_layer_ms"] = cuda_ms(
                lambda: b5c(q, k, v, store, bst, lse1_u, *plan, "euclidean",
                            ones, seeds, 0.0), 3)
            one = (q[:1], k[:1], v[:1], store[:1], tuple(p[:1] for p in plan),
                   tuple(t[:1] for t in rs))
            bst1, l1u = bst[:1].clone(), lse1_u[:1].contiguous()
            del bst, lse1_u
            l1 = b4c(*one[:2], one[3], *one[4], "euclidean", ones)
            out, l2 = b5c(*one[:4], bst1, l1u, *one[4], "euclidean", ones,
                          seeds[:1], 0.0)
            fwd = {}
            for b16 in ((True, False) if bf16 else (False,)):
                fwd[b16] = (FG.flash_lse1_compact_plain(
                    *one[:2], one[3], *one[4], "euclidean", ones, b16),
                    *FG.flash_biased_forward_compact_plain(
                        *one[:4], bst1, l1u, *one[4], "euclidean", ones, 0.0,
                        seeds[:1], b16))
            p_l1, p_out, p_l2 = fwd[bf16]
            sync()
            live = l1 < 1e29
            name = "B4c and B5c bf16" if bf16 else "B4c and B5c"
            if bf16:
                f_l1, f_out, f_l2 = fwd[False]
                if not (torch.all(l1[~live] == FG.LSE_DEAD)
                        and torch.all(out[~live] == 0)):
                    raise AssertionError("full-width dead rows differ")
                gates = max(bf16_gates("full-width lse1", l1[live],
                                       p_l1[live], f_l1[live],
                                       witness=False),
                            bf16_gates("full-width out", out[live],
                                       p_out[live], f_out[live]),
                            bf16_gates("full-width lse2", l2[live],
                                       p_l2[live], f_l2[live],
                                       witness=False))
                res["full_err"], res["full_gates"] = gates[0], gates
                err_text = (f"(max abs err, max err, mean err, witness) "
                            f"{tuple(f'{x:.3e}' for x in gates)}")
            else:
                res["full_err"] = max((l1 - p_l1)[live].abs().max().item(),
                                      (out - p_out).abs().max().item(),
                                      (l2 - p_l2)[live].abs().max().item())
                err_text = f"max abs err {res['full_err']:.3e}"
            share = cfg.num_layers * (res["b4c_layer_ms"]
                                      + res["b5c_layer_ms"]) / fwd_ms
            log(f"[{label}] forward on a packed request {fwd_ms:.3f} ms; one "
                f"request's packing and planning {req_pack_s:.3f} s; one "
                f"layer's bias store build {res['bias_store_build_ms']:.3f} "
                f"ms; one layer over the {G} folded snapshots: B4c "
                f"{res['b4c_layer_ms']:.3f} ms, B5c {res['b5c_layer_ms']:.3f}"
                f" ms ({cfg.num_layers} layers = {share:.3f} of the forward); "
                f"layer-0 {name} vs plain{' bf16' if bf16 else ''} on one "
                f"snapshot: {err_text}")
            args = one + (bst1, l1u, rb[:1])
        res["kernel_share_of_forward"] = share
    if not bf16 and not res["full_err"] <= TOL:
        raise AssertionError(f"full-width compact kernel error "
                             f"{res['full_err']} > {TOL}")
    res["args"], res["reqs"] = args, reqs
    return res


def phase_mid_hybrid(tt, FG):
    """The hybrid Predictor at N_MID_HYB nodes (the same generator), plain
    and edge-feature models: probabilities and per-node features on the
    card (compact kernels) against the CPU (plain versions)."""
    out = {}
    for edge in (False, True):
        req = [hybrid_snaps(N_MID_HYB, DEG_HYB, T_HYB, 40 + s,
                            edge_dim=F_EDGE if edge else 0)
               for s in range(SEQS_PER_REQUEST)]
        dims = (T_HYB, N_MID_HYB, N_MID_HYB * DEG_HYB, F_EDGE if edge else 0)
        got, nodes, launched = {}, {}, {}
        for side, dev in (("card", DEV), ("cpu", "cpu")):
            model = tt.TAGAN(hybrid_config(tt, edge), device=dev,
                             generator=torch.Generator().manual_seed(0))
            pred = tt.Predictor(model, dims=dims)
            before = counts(FG)
            got[side] = pred.predict_proba(req)
            launched[side] = {n: c - before[n] for n, c in counts(FG).items()
                              if c != before[n]}
            batch = tt.batch_sequences(pred._pack(req)).to(dev)
            with torch.inference_mode():
                nodes[side] = model.encode_spatial(batch).cpu()
        err = float(np.abs(got["card"] - got["cpu"]).max())
        node_err = (nodes["card"] - nodes["cpu"]).abs().max().item()
        kern = ((FG.flash_lse1_compact_kernel,
                 FG.flash_biased_fwd_compact_kernel) if edge else
                (FG.flash_geometric_fwd_compact_kernel,))
        want = {"card": {k.name: 2 for k in kern}, "cpu": {}}   # 2 layers
        log(f"[4c] hybrid N={N_MID_HYB}{', edge features' if edge else ''}: "
            f"probabilities card vs cpu max abs err {err:.3e}, per-node "
            f"features {tuple(nodes['cpu'].shape)} {node_err:.3e}; launches "
            f"{launched}")
        if launched != want:
            raise AssertionError(f"launches {launched} != {want}")
        if not (err <= TOL and node_err <= TOL):
            raise AssertionError(f"hybrid card vs cpu: {err}, per-node "
                                 f"{node_err} > {TOL}")
        out["edge" if edge else "plain"] = dict(prob_err=err,
                                                node_err=node_err)
    return out


def phase_hybrid_vs_csr(tt, FG):
    """At full width, one sequence of distinct non-loop edges: the hybrid
    model against the csr model (an O(E) formula of its own) on the card,
    plain and edge-feature models, the same weights."""
    out = {}
    for edge in (False, True):
        seq = hybrid_snaps(N_HYB, DEG_HYB, T_HYB, 50, edge_dim=F_EDGE if edge
                           else 0, unique=True)
        E = max(s["edge_index"].shape[1] for s in seq)
        dims = (T_HYB, N_HYB, E, F_EDGE if edge else 0)
        got, nodes = {}, {}
        for backend in ("hybrid", "csr"):
            model = tt.TAGAN(hybrid_config(tt, edge, backend), device=DEV,
                             generator=torch.Generator().manual_seed(0))
            pred = tt.Predictor(model, dims=dims)
            got[backend] = pred.predict_proba([seq])
            batch = tt.batch_sequences(pred._pack([seq])).to(DEV)
            with torch.inference_mode():
                nodes[backend] = model.encode_spatial(batch).cpu()
            del model, pred, batch
        err = float(np.abs(got["hybrid"] - got["csr"]).max())
        node_err = (nodes["hybrid"] - nodes["csr"]).abs().max().item()
        log(f"[4d] N={N_HYB}, {E} distinct non-loop edges/snapshot"
            f"{', edge features' if edge else ''}: hybrid vs csr on the card: "
            f"probabilities {got['hybrid'].ravel().tolist()} vs "
            f"{got['csr'].ravel().tolist()}, max abs err {err:.3e}; per-node "
            f"features {node_err:.3e} (tol {TOL_CSR})")
        if not (err <= TOL_CSR and node_err <= TOL_CSR):
            raise AssertionError(f"hybrid vs csr: {err}, per-node {node_err}"
                                 f" > {TOL_CSR}")
        out["edge" if edge else "plain"] = dict(prob_err=err,
                                                node_err=node_err, edges=E)
    return out


def flex_compact_setup(FG, q, store, plan):
    """(block mask, compiled ``flex_attention``): the library's form of the
    compact walk. kv_num_blocks / kv_indices are jcount / jlist at block
    size 64, and the mask_mod reads the bit store through a [n_i, n_j]
    slot map (the port never calls it)."""
    from torch.nn.attention.flex_attention import BlockMask, flex_attention
    N = q.shape[2]
    jlist, jcount, jslot = (p[0] for p in plan)
    n_i = jcount.shape[0]
    bm = FG.BLOCK_M
    live = torch.arange(jlist.shape[1], device=DEV) < jcount[:, None]
    kv_idx = torch.zeros(n_i, n_i, dtype=torch.int32, device=DEV)
    kv_idx[:, :jlist.shape[1]] = torch.where(live, jlist, 0)
    slot_map = torch.full((n_i, n_i), -1, dtype=torch.int64, device=DEV)
    rows = torch.arange(n_i, device=DEV)[:, None].expand_as(jlist)
    slot_map[rows[live], jlist[live].long()] = jslot[live].long()
    words = store[0]

    def mask_mod(b, h, qi, kv):
        s = slot_map[qi // bm, kv // bm]
        w = words[s.clamp(min=0), qi % bm]
        return (s >= 0) & (((w >> (kv % bm)) & 1) != 0)

    block_mask = BlockMask.from_kv_blocks(
        jcount[None, None].to(torch.int32), kv_idx[None, None],
        BLOCK_SIZE=bm, mask_mod=mask_mod, seq_lengths=(N, N))
    flex = torch.compile(flex_attention, dynamic=False)

    def call(*a, **kw):
        # the kernel's tiles must divide the block mask's 64
        return flex(*a, kernel_options={"BLOCK_M": bm, "BLOCK_N": bm}, **kw)
    return block_mask, call, slot_map


def band_edges(FG, store, plan):
    """The band's pairs (self loops included) of snapshot 0 of a bit
    store as an edge list: (query, key, (walk step, tile row, tile
    column) of each pair)."""
    words = FG.unpack_bits(store[0])                  # [S, 64, 64]
    jl, jc, js = (p[0] for p in plan)
    live = torch.arange(jl.shape[1], device=DEV) < jc[:, None]
    i = torch.arange(jl.shape[0], device=DEV)[:, None].expand_as(jl)
    t_, r_, c_ = words[js[live].long()].nonzero(as_tuple=True)
    return (i[live][t_] * FG.BLOCK_M + r_,
            jl[live].long()[t_] * FG.BLOCK_N + c_, (t_, r_, c_))


def phase_times_hybrid(FG, plain_args, edge_args):
    """At one 131K snapshot, CUDA events: B1c, B4c and B5c against their
    plain versions, their bounds, compiled ``flex_attention`` over the
    compact plan at the scaled-dot metric (held against B1c and B5c at
    that metric), and the csr form of the whole layer's attention."""
    from tagan_torch.ops.sparse import add_self_loops, edge_attention
    q, k, v, store, plan, (res_eq, res_ek, res_em) = plain_args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(1, dtype=torch.int32, device=DEV)
    seeds = torch.zeros(1, 2, dtype=torch.int32, device=DEV)
    sdp = "scaled_dot_product"
    res = {}
    with torch.inference_mode():
        def b1(metric="euclidean"):
            return FG.flash_geometric_fwd_compact_kernel(
                q, k, v, store, *plan, metric, ones, seed0, 0.0)

        def plain1():
            FG.flash_geometric_forward_compact_plain(
                q, k, v, store, *plan, "euclidean", ones, 0.0, seed0)
        p1, k1, k2, p2 = (cuda_ms(plain1, 3), cuda_ms(b1, 20), cuda_ms(b1, 20),
                          cuda_ms(plain1, 3))
        k_sdp = cuda_ms(lambda: b1(sdp), 20)
        out_sdp, lse_sdp = b1(sdp)
        pairs = int(FG.unpack_bits(store).sum().item())
        walked = int(plan[1].sum().item())
        plan_b = 4 * sum(p.numel() for p in plan)
        qkv = 4 * G * H * N * (2 * D + Dv)
        res["B1c"] = dict(ms=[k1, k2], plain_ms=[p1, p2], sdp_ms=k_sdp,
                          **bound(qkv + store.numel() * 8 + plan_b + 4 * H
                                  + 4 * G + 4 * G * H * N * (Dv + 1),
                                  2 * H * pairs * (D + Dv)))
        # B4c and B5c on the edge-feature model's snapshot
        qe, ke, ve, st_e, plan_e, rs, bst, l1u, rb = edge_args
        pairs_e = int(FG.unpack_bits(st_e).sum().item())

        def b4(metric="euclidean"):
            return FG.flash_lse1_compact_kernel(qe, ke, st_e, *plan_e, metric,
                                                ones)

        def b5(metric="euclidean", l1=l1u):
            return FG.flash_biased_fwd_compact_kernel(
                qe, ke, ve, st_e, bst, l1, *plan_e, metric, ones, seeds, 0.0)

        def plain4():
            FG.flash_lse1_compact_plain(qe, ke, st_e, *plan_e, "euclidean",
                                        ones)

        def plain5():
            FG.flash_biased_forward_compact_plain(
                qe, ke, ve, st_e, bst, l1u, *plan_e, "euclidean", ones, 0.0,
                seeds)
        p4a, k4a, k4b, p4b = (cuda_ms(plain4, 3), cuda_ms(b4, 20),
                              cuda_ms(b4, 20), cuda_ms(plain4, 3))
        p5a, k5a, k5b, p5b = (cuda_ms(plain5, 3), cuda_ms(b5, 20),
                              cuda_ms(b5, 20), cuda_ms(plain5, 3))
        l1_sdp = b4(sdp)
        k4_sdp = cuda_ms(lambda: b4(sdp), 20)
        k5_sdp = cuda_ms(lambda: b5(sdp, l1_sdp), 20)
        out5_sdp, l2_sdp = b5(sdp, l1_sdp)
        bounds = compact_biased_fwd_bounds(qe, ve, st_e, plan_e, pairs_e)
        res["B4c"] = dict(ms=[k4a, k4b], plain_ms=[p4a, p4b], sdp_ms=k4_sdp,
                          **bounds["B4c"])
        res["B5c"] = dict(ms=[k5a, k5b], plain_ms=[p5a, p5b], sdp_ms=k5_sdp,
                          **bounds["B5c"])

        # the csr form of the whole layer's attention on the same graphs:
        # band edges, residual edges and self loops as one edge list
        eq_b, ek_b, _ = band_edges(FG, store, plan)
        eq = torch.cat([eq_b, res_eq[0][res_em[0]].long()])[None]
        ek = torch.cat([ek_b, res_ek[0][res_em[0]].long()])[None]
        em = torch.ones_like(eq, dtype=torch.bool)

        def csr():
            edge_attention("euclidean", q, k, v, eq, ek, em, N)
        csr_ms = [cuda_ms(csr, 10), cuda_ms(csr, 10)]
        eq_e, ek_e, (t_, r_, c_) = band_edges(FG, st_e, plan_e)
        jl, jc, js = (p[0] for p in plan_e)
        live = torch.arange(jl.shape[1], device=DEV) < jc[:, None]
        b_band = bst[0][js[live].long()][t_, r_, c_]
        e_eq, e_ek, e_em = rs
        eqe = torch.cat([eq_e, e_eq[0][e_em[0]].long()])[None]
        eke = torch.cat([ek_e, e_ek[0][e_em[0]].long()])[None]
        ebe = torch.cat([b_band, rb[0][e_em[0]]])[None]
        eme = torch.ones_like(eqe, dtype=torch.bool)

        def csr_b():
            edge_attention("euclidean", qe, ke, ve, eqe, eke, eme, N,
                           edge_bias=ebe)
        csr_b_ms = [cuda_ms(csr_b, 10), cuda_ms(csr_b, 10)]
    res["csr_ms"], res["csr_biased_ms"] = csr_ms, csr_b_ms
    res.update(valid_pairs=pairs, walked_tiles=walked,
               valid_pairs_edge=pairs_e, csr_edges=int(eq.shape[-1]),
               csr_biased_edges=int(eqe.shape[-1]))
    # the library: compiled flex_attention over the compact plan. Phases
    # 5b and 5c compiled it under other score and mask functions: past
    # dynamo's recompile limit it would run unfused, [H, N, N] scores
    torch._dynamo.reset()
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            bmask, flex, _ = flex_compact_setup(FG, q, store, plan)
            f_out, f_lse = flex(q, k, v, block_mask=bmask, return_lse=True)
            lib1 = cuda_ms(lambda: flex(q, k, v, block_mask=bmask,
                                        return_lse=True), 20)
            bmask_e, flex_e, slot_map = flex_compact_setup(FG, qe, st_e,
                                                           plan_e)
            f_l1 = flex_e(qe, ke, ve, block_mask=bmask_e, return_lse=True)[1]
            bs = bst[0]

            def biased(s, b, h, qi, kv):
                bm = FG.BLOCK_M
                sl = slot_map[qi // bm, kv // bm].clamp(min=0)
                return torch.exp(s - f_l1[b, h, qi]) + \
                    bs[sl, qi % bm, kv % bm]

            def call5():
                return flex_e(qe, ke, ve, score_mod=biased,
                              block_mask=bmask_e, return_lse=True)
            f_out5, f_l2 = call5()
            lib4 = cuda_ms(lambda: flex_e(qe, ke, ve, block_mask=bmask_e,
                                          return_lse=True), 20)
            lib5 = cuda_ms(call5, 20)
            sync()
        live = lse_sdp < 1e29
        live_e = l1_sdp < 1e29
        flex_err = max((f_lse - lse_sdp)[live].abs().max().item(),
                       (f_out - out_sdp)[live].abs().max().item(),
                       (f_l1 - l1_sdp)[live_e].abs().max().item(),
                       (f_l2 - l2_sdp)[live_e].abs().max().item(),
                       (f_out5 - out5_sdp)[live_e].abs().max().item())
        lib = dict(B1c=lib1, B4c=lib4, B5c=lib5, err=flex_err, error=None)
    except Exception as e:          # the yardstick only: never the port
        lib = dict(B1c=None, B4c=None, B5c=None, err=None,
                   error=f"{type(e).__name__}: {e}"[:300])
    lib["setup_and_timing_s"] = time.perf_counter() - t0
    res["library"] = lib
    for name in ("B1c", "B4c", "B5c"):
        r = res[name]
        r["library_ms"] = lib[name]
        r["bound_share"] = r["bound_ms"] / min(r["ms"])
        log(f"[5d] {name} one snapshot of N={N}: ms {r['ms'][0]:.4f} "
            f"{r['ms'][1]:.4f} (scaled-dot {r['sdp_ms']:.4f}); plain ms "
            f"{r['plain_ms'][0]:.4f} {r['plain_ms'][1]:.4f}; library "
            f"{r['library_ms']}; bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bytes']} bytes, {r['flops']} flops), "
            f"{r['bound_share']:.4f} of it reached")
    log(f"[5d] {pairs} valid band pairs ({pairs_e} on the edge-feature "
        f"snapshot) on {walked} walked tiles per head; csr edge_attention "
        f"over all {res['csr_edges']} edges ms {csr_ms[0]:.4f} "
        f"{csr_ms[1]:.4f}, with the bias ({res['csr_biased_edges']} edges) "
        f"{csr_b_ms[0]:.4f} {csr_b_ms[1]:.4f}; library: {lib}")
    if lib["err"] is not None and not lib["err"] <= TOL:
        raise AssertionError(f"flex_attention yardstick differs from the "
                             f"compact kernels: {lib['err']} > {TOL}")
    return res


# -- phases 4e, 5e, 6c, 7c: training the hybrid model -------------------------

def phase_hybrid_train_vs_csr(tt, FG):
    """At full width, one sequence of distinct non-loop edges: the hybrid
    model's first-step gradients (B1c forward, B3a c + B3b c backward,
    the residual and the merge under autograd) against the csr model's
    (an O(E) formula of its own under autograd) on the card, the same
    weights."""
    seq = hybrid_snaps(N_HYB, DEG_HYB, T_HYB, 60, unique=True)
    ds = tt.TemporalGraphDataset([seq], [1.0])
    grads, losses = {}, {}
    for backend in ("hybrid", "csr"):
        model = tt.TAGAN(hybrid_config(tt, backend=backend), device=DEV,
                         generator=torch.Generator().manual_seed(0))
        loader = tt.TemporalGraphDataLoader(
            ds, batch_size=1, dense_adj=False,
            plan="hybrid" if backend == "hybrid" else None)
        b, y, _ = next(iter(loader))
        loss = model(b, y).loss
        loss.backward()
        losses[backend] = loss.item()
        grads[backend] = {n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()}
        del model, loader, b, loss
    err, zero = grad_errors(grads["hybrid"], grads["csr"])
    E = seq[0]["edge_index"].shape[1]
    log(f"[4e] N={N_HYB}, {E} distinct non-loop edges in snapshot 0: "
        f"first-step gradients hybrid vs csr on the card: max err over each "
        f"tensor's largest entry {err:.3e} (tol {TOL_HYB_CSR_GRAD}; at fp32 "
        f"noise {zero}); losses {losses}")
    if not err <= TOL_HYB_CSR_GRAD:
        raise AssertionError(f"hybrid vs csr gradients {err} > "
                             f"{TOL_HYB_CSR_GRAD}")
    return dict(grad_err=err, noise_tensors=zero, losses=losses, edges=E)


def hybrid_layer0_bwd(FG, model, batch, bf16=False):
    """`hybrid_layer0`'s inputs with the folded transposed walk, B1c's
    (out, lse) over them (its bf16 form's with ``bf16``), and cotangents
    dO and dlse (N(0, 1), seed 11): the layer's compact backward
    launch."""
    (q, k, v, store, plan, res), _ = hybrid_layer0(FG, model, batch)
    G, H = q.shape[:2]
    plan_t = FG.fold_compact(batch.hyb_mask_blocks, batch.hyb_plan_t, G)[1]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        out, lse = compact_kernels(FG, bf16)[0](
            q, k, v, store, *plan, "euclidean", ones, seeds, 0.0)
    g = torch.Generator(device=DEV).manual_seed(11)
    do = torch.randn(out.shape, device=DEV, generator=g)
    dlse = torch.randn(lse.shape, device=DEV, generator=g)
    return q, k, v, store, plan, plan_t, res, out, lse, do, dlse


def phase_train_hybrid(tt, FG, bf16=False, data=None):
    """`TAGANTrainer.train` on the 131K hybrid model (part C) over a
    ``plan="hybrid"`` loader, one sequence per batch: the loader's
    planning batch apart from the cached ones, one warm-up step, then
    3 steps with launch counts set to 0 just before and read just after;
    step times, split, peak memory, one layer's B3a c + B3b c over the
    folded snapshots and their share of the step, finite losses and
    gradients, every parameter moved; one snapshot at full width against
    the compact plain backward. With ``bf16`` [6g]: the model with
    bf16_matmul=True over 6c's loaders and planned batches ``data`` (B1c,
    B3a c and B3b c's bf16 forms each once per layer per step, the fp32
    forms never), held to the compact plain bf16 backward under the bf16
    gates. The loaders and batches are returned under "data"."""
    tag = "6g" if bf16 else "6c"
    kerns = compact_kernels(FG, bf16)
    cfg = hybrid_config(tt, bf16=bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    exp = tt.ExperimentConfig(model=cfg, batch_size=1, num_epochs=1, seed=0,
                              checkpoint_dir="", shuffle=False)
    if data is None:
        ds = tt.TemporalGraphDataset(
            [hybrid_snaps(N_HYB, DEG_HYB, T_HYB, 600 + s)
             for s in range(TRAIN_STEPS + 1)], [1.0, 0.0, 1.0, 0.0])
        kw = dict(batch_size=1, dense_adj=False, plan="hybrid")
        warm = tt.TemporalGraphDataLoader(ds.subset([0]), **kw)
        loader = tt.TemporalGraphDataLoader(
            ds.subset(list(range(1, TRAIN_STEPS + 1))), **kw)
        # the first batch packs and plans every sequence of the bucket;
        # the later ones, and every later epoch, stack cached sequences
        batch_s, batches = [], []
        it = iter(loader)
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            batches.append(next(it))
            batch_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        list(loader)
        cached_epoch_s = time.perf_counter() - t0
        log(f"[6c] hybrid N={N_HYB}, T={T_HYB}: the loader's batches "
            f"(plan='hybrid') s {[round(x, 3) for x in batch_s]} (the first "
            f"packs and plans all {TRAIN_STEPS} sequences), a cached epoch "
            f"{cached_epoch_s:.3f} s; bucket pin {loader.plan_pins}")
    else:
        warm, loader, batches, batch_s, cached_epoch_s = data
        log(f"[{tag}] hybrid N={N_HYB}, T={T_HYB}, bf16_matmul=True: 6c's "
            f"loaders and their planned batches (bucket pin "
            f"{loader.plan_pins})")
    trainer = tt.TAGANTrainer(model, exp)
    # 6g's check runs at the weights these steps leave, where the plain
    # bf16 backward's roundings flip with any change of its inputs: the
    # residual's segment sums (index_add_) and the gathers' backward then
    # sum in a fixed order, so that its inputs are the same in every run
    with fixed_order(bf16):
        trainer.train(warm, verbose=False)
        sync()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}

        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_counts(FG)
        t0 = time.perf_counter()
        res = trainer.train(loader, verbose=False)
        sync()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        launched = counts(FG)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
        no_grad = check_grads(model)
        # the full-width check's inputs: layer 0 of the first batch at the
        # weights the measured steps left
        b, y, m = batches[0]
        trainer.optimizer.zero_grad()
        q, k, v, store, plan, plan_t, rs, out, lse, do, dlse = \
            hybrid_layer0_bwd(FG, model, b.to(DEV), bf16)
        sync()
    digests = dict(weights=digest(p for _, p in model.named_parameters()),
                   check_inputs=digest((q[:1], k[:1], v[:1], out[:1],
                                        lse[:1], do[:1], dlse[:1])))
    log(f"[{tag}] sha256 of the trained weights and of the full-width "
        f"check's inputs{' (steps in a fixed order)' if bf16 else ''}: "
        f"{digests}")
    want = {k_.name: 0 for k_ in FG.KERNELS}
    for kern in kerns:
        want[kern.name] = cfg.num_layers * TRAIN_STEPS
    losses = res["history"]["train_loss"]
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    moved = len(before) - len(still)
    log(f"[{tag}] {TRAIN_STEPS} steps of TAGANTrainer.train in {epoch_ms:.3f} "
        f"ms; mean loss {losses}; peak device memory {peak_gb:.3f} GB above "
        f"the {held_gb:.3f} GB held before; launches {launched} (expected "
        f"{want}); {len(before) - len(no_grad)} of {len(before)} gradients "
        f"finite and non-zero where not zero in exact arithmetic; "
        f"parameters moved {moved} of {len(before)} (not moved: {still})")
    if launched != want:
        raise AssertionError(f"launches {launched} != {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"loss not finite: {losses}")
    if no_grad:
        raise AssertionError(f"no finite non-zero gradient: {no_grad}")
    # a zero bias whose gradient is zero in exact arithmetic may stay put
    # (weight decay keeps zero at zero); fp32 noise usually moves it
    if set(still) - set(ZERO_GRAD):
        raise AssertionError(f"parameters not moved: {still}")

    step_ms = step_times(trainer, batches)
    splits = step_split(trainer, b, y, m)
    log(f"[{tag}] step ms (host clock, synchronised) "
        f"{[round(x, 3) for x in step_ms]}; split (CUDA events) forward / "
        f"backward / optimizer ms "
        f"{[[round(x, 3) for x in s] for s in splits]}")

    # one layer's compact launches over the batch's folded snapshots
    G, H = q.shape[:2]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        fold_fwd = cuda_ms(lambda: kerns[0](
            q, k, v, store, *plan, "euclidean", ones, seeds, 0.0), 3)
        fold_bwd = cuda_ms(lambda: FG._backward_compact(
            q, k, v, store, out, lse, do, plan, plan_t, "euclidean", ones,
            0.0, seeds, False, dlse, bf16), 3)
        common = (q, k, v, store, do, lse, FG._delta(do, out, dlse)
                  .contiguous())
        fold_b3a = cuda_ms(lambda: kerns[1](
            *common, *plan, "euclidean", ones, seeds, 0.0, False), 3)
        fold_b3b = cuda_ms(lambda: kerns[2](
            *common, *plan_t, "euclidean", ones, seeds, 0.0), 3)
        del common
    step = min(step_ms)
    share = cfg.num_layers * fold_bwd / step
    log(f"[{tag}] one layer's launches over the {G} folded snapshots: B1c "
        f"{fold_fwd:.3f} ms, B3a c+B3b c {fold_bwd:.3f} ms (B3a c alone "
        f"{fold_b3a:.3f}, B3b c alone {fold_b3b:.3f}); {cfg.num_layers} "
        f"layers' B3a c+B3b c = {share:.3f} and with B1c "
        f"{cfg.num_layers * (fold_fwd + fold_bwd) / step:.3f} of the fastest "
        f"step ({step:.3f} ms)")

    # one snapshot at full width against the compact plain backward
    one = tuple(t[:1].contiguous() for t in (q, k, v, store))
    plan1, plan_t1 = (tuple(t[:1].contiguous() for t in p)
                      for p in (plan, plan_t))
    o1, l1, do1, dl1 = (t[:1].contiguous() for t in (out, lse, do, dlse))
    res1 = tuple(t[:1] for t in rs)
    del q, k, v, store, out, lse, do, dlse
    got = FG._backward_compact(*one, o1, l1, do1, plan1, plan_t1,
                               "euclidean", ones, 0.0, seeds[:1], False, dl1,
                               bf16)
    plain = (*one, o1, l1, do1, *plan1, "euclidean", ones, 0.0, seeds[:1],
             False, dl1)
    want_g = FG.flash_geometric_backward_compact_plain(*plain, bf16=bf16)
    sync()
    if bf16:
        f32 = FG.flash_geometric_backward_compact_plain(*plain)
        gates = [bf16_gates(f"N={N_HYB} {n}", g, w, f)
                 for n, g, w, f in zip(("dq", "dk", "dv"), got, want_g, f32)]
        full = {"B3a c": gates[0][0], "B3b c": max(gates[1], gates[2])[0]}
        del f32
        log(f"[{tag}] bf16 compact backward at N={N_HYB}, one snapshot, lse "
            f"cotangent, vs the compact plain bf16 backward (bf16 gates): "
            f"(max abs err, max err, mean err, witness) dq "
            f"{tuple(f'{x:.3e}' for x in gates[0])}, dk "
            f"{tuple(f'{x:.3e}' for x in gates[1])}, dv "
            f"{tuple(f'{x:.3e}' for x in gates[2])}")
    else:
        full = compact_errors(check_backward(f"N={N_HYB}", got, want_g,
                                             False))
        log(f"[6c] compact backward at N={N_HYB}, one snapshot, lse "
            f"cotangent, vs the compact plain backward: max abs err B3a c "
            f"{full['B3a c']:.3e}, B3b c {full['B3b c']:.3e}")
    del got, want_g
    return dict(data=(warm, loader, batches, batch_s, cached_epoch_s),
                batch_s=batch_s, cached_epoch_s=cached_epoch_s,
                pins={str(k): v for k, v in loader.plan_pins.items()},
                epoch_ms=epoch_ms, step_ms=step_ms, split_ms=splits,
                loss=losses, launches=launched, peak_memory_gb=peak_gb,
                held_gb=held_gb, moved=moved, digests=digests,
                fold_b1c_ms=fold_fwd, fold_b3a_c_ms=fold_b3a,
                fold_b3b_c_ms=fold_b3b,
                fold_b3c_ms=fold_bwd, b3c_share_of_step=share, full_err=full,
                args=(*one, plan1, plan_t1, res1, o1, l1, do1, dl1))


def compact_bwd_bounds(FG, q, v, store, plan, plan_t, pairs, rate=None):
    """B3a c's and B3b c's least time from these inputs: q, k, v, dO, lse
    and delta, the store, the walk, scale and seed read once, dq (or dk
    and dv) written once, against the products on the valid pairs at the
    fp32 peak (``rate``: `bound16` for the bf16 rate)."""
    bound_of = rate or bound
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    HN = G * H * N
    reads = (4 * HN * (2 * D + 2 * Dv) + 8 * HN + store.numel()
             * store.element_size() + 4 * (H + G))
    plan_b, plan_tb = (4 * sum(t.numel() for t in p) for p in (plan, plan_t))
    return {"B3a c": bound_of(reads + plan_b + 4 * HN * D,
                              2 * H * pairs * (2 * D + Dv)),
            "B3b c": bound_of(reads + plan_tb + 4 * HN * (D + Dv),
                              2 * H * pairs * (2 * D + 2 * Dv))}


def phase_times_hybrid_bwd(FG, args):
    """At one 131K snapshot of 6c, CUDA events: B3a c, B3b c and the two
    together against the compact plain backward, compiled
    ``flex_attention``'s backward under the BlockMask of the compact plan
    at the scaled-dot metric (forward+backward minus forward; held
    against the kernels at that metric), csr ``edge_attention``'s autograd
    backward over the layer's whole edge set, and the bounds."""
    from tagan_torch.ops.sparse import edge_attention
    q, k, v, store, plan, plan_t, (res_eq, res_ek, res_em), out, lse, do, \
        dlse = args
    G, H, N, D = q.shape
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(1, dtype=torch.int32, device=DEV)
    sdp = "scaled_dot_product"
    with torch.no_grad():
        delta = ((do * out).sum(-1) - dlse).contiguous()
        common = (q, k, v, store, do, lse, delta)

        def b3a(metric="euclidean", c=common):
            FG.flash_geometric_bwd_dq_compact_kernel(
                *c, *plan, metric, ones, seed0, 0.0, False)

        def b3b(metric="euclidean", c=common):
            FG.flash_geometric_bwd_dkv_compact_kernel(
                *c, *plan_t, metric, ones, seed0, 0.0)

        def both(metric="euclidean", c=common):
            b3a(metric, c)
            b3b(metric, c)

        def plain():
            FG.flash_geometric_backward_compact_plain(
                q, k, v, store, out, lse, do, *plan, "euclidean", ones, 0.0,
                seed0, False, dlse)
        p1, a1, a2, p2 = (cuda_ms(plain, 3), cuda_ms(both, 10),
                          cuda_ms(both, 10), cuda_ms(plain, 3))
        ta, tb = cuda_ms(b3a, 10), cuda_ms(b3b, 10)
        out_s, lse_s = FG.flash_geometric_fwd_compact_kernel(
            q, k, v, store, *plan, sdp, ones, seed0, 0.0)
        c_sdp = (q, k, v, store, do, lse_s, (do * out_s).sum(-1).contiguous())
        a_sdp = cuda_ms(lambda: both(sdp, c_sdp), 10)
        g_sdp = FG._backward_compact(q, k, v, store, out_s, lse_s, do, plan,
                                     plan_t, sdp, ones, 0.0, seed0, False,
                                     None)
        pairs = int(FG.unpack_bits(store).sum().item())
        walked = int(plan[1].sum().item())

        # the csr form of the layer's whole edge set: the band's pairs
        # and the residual edges as one edge list
        eq_b, ek_b, _ = band_edges(FG, store, plan)
        eq = torch.cat([eq_b, res_eq[0][res_em[0]].long()])[None]
        ek = torch.cat([ek_b, res_ek[0][res_em[0]].long()])[None]
        em = torch.ones_like(eq, dtype=torch.bool)
        del eq_b, ek_b
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def csr_fb():
        o = edge_attention("euclidean", *leaves, eq, ek, em, N)
        torch.autograd.grad(o, leaves, do)

    def csr_f():
        with torch.no_grad():
            edge_attention("euclidean", *leaves, eq, ek, em, N)
    csr_ms = [cuda_ms(csr_fb, 5) - cuda_ms(csr_f, 5),
              cuda_ms(csr_fb, 5) - cuda_ms(csr_f, 5)]
    # the library: compiled flex_attention's backward over the compact
    # plan; 5b-5d compiled it under other functions (dynamo's recompile
    # limit), so start afresh
    torch._dynamo.reset()
    t0 = time.perf_counter()
    try:
        bmask, flex, _ = flex_compact_setup(FG, q, store, plan)

        def lib_fb():
            o = flex(*leaves, block_mask=bmask)
            return torch.autograd.grad(o, leaves, do)

        def lib_f():
            with torch.no_grad():
                flex(*leaves, block_mask=bmask)
        f_grads = lib_fb()
        sync()
        flex_err = max(rel_err(f, g) for f, g in zip(f_grads, g_sdp[:3]))
        del f_grads
        ms = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
        lib = dict(ms=ms if flex_err <= TOL else None, err=flex_err,
                   error=None if flex_err <= TOL else
                   f"differs from B3a c + B3b c by {flex_err:.3e}")
    except Exception as e:          # the yardstick only: never the port
        lib = dict(ms=None, err=None, error=f"{type(e).__name__}: {e}"[:300])
    lib["setup_and_timing_s"] = time.perf_counter() - t0
    bounds = compact_bwd_bounds(FG, q, v, store, plan, plan_t, pairs)
    res = {"B3a c": dict(ms=[ta], bound_share=bounds["B3a c"]["bound_ms"]
                         / ta, **bounds["B3a c"]),
           "B3b c": dict(ms=[tb], bound_share=bounds["B3b c"]["bound_ms"]
                         / tb, **bounds["B3b c"]),
           "B3a c+B3b c_ms": [a1, a2], "B3a c+B3b c_sdp_ms": a_sdp,
           "plain_ms": [p1, p2], "library": lib, "csr_ms": csr_ms,
           "csr_edges": int(eq.shape[-1]), "valid_pairs": pairs,
           "walked_tiles": walked}
    log(f"[5e] H={H} N={N} D={D}, one snapshot, compact backward: B3a c ms "
        f"{ta:.4f}, B3b c {tb:.4f}; both ms {a1:.4f} {a2:.4f} (scaled-dot "
        f"metric {a_sdp:.4f}); compact plain backward ms {p1:.4f} {p2:.4f}; "
        f"csr edge_attention backward over all {res['csr_edges']} edges ms "
        f"{csr_ms[0]:.4f} {csr_ms[1]:.4f}")
    log(f"[5e] library: compiled flex_attention backward under the compact "
        f"plan's BlockMask at the scaled-dot metric: {lib}")
    for name in ("B3a c", "B3b c"):
        r = res[name]
        log(f"[5e] {name} bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['flops']} flops over {pairs} valid "
            f"pairs on {walked} walked tiles per head), "
            f"{r['bound_share']:.4f} of it reached")
    return res


# -- phase 5i -----------------------------------------------------------------

def phase_times_hybrid_bf16(FG, args):
    """[5i] B1c, B3a c and B3b c in their bf16 forms at one 131K snapshot
    of 6g, CUDA events, each beside its fp32 form in turns; the compact
    plain bf16 versions; compiled ``flex_attention`` on bf16 q, k, v under
    the compact plan's BlockMask at the scaled-dot metric as the library
    yardstick (forward, and forward+backward minus forward), held against
    the bf16 kernels at that metric (null with the reason where it does
    not build or differs); the bounds: the fp32 forms' bytes (the inputs
    stay fp32) and the valid pairs' operations at the bf16 tensor-core
    rate."""
    q, k, v, store, plan, plan_t, _, out, lse, do, dlse = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(1, dtype=torch.int32, device=DEV)
    sdp = "scaled_dot_product"
    k32, k16 = compact_kernels(FG, False), compact_kernels(FG, True)
    with torch.no_grad():
        delta = ((do * out).sum(-1) - dlse).contiguous()
        common = (q, k, v, store, do, lse, delta)
        calls = {
            "B1c": lambda kern: lambda: kern(q, k, v, store, *plan,
                                             "euclidean", ones, seed0, 0.0),
            "B3a c": lambda kern: lambda: kern(*common, *plan, "euclidean",
                                               ones, seed0, 0.0, False),
            "B3b c": lambda kern: lambda: kern(*common, *plan_t, "euclidean",
                                               ones, seed0, 0.0)}
        times = {}
        for i, (name, make) in enumerate(calls.items()):
            a32, a16 = cuda_ms(make(k32[i]), 10), cuda_ms(make(k16[i]), 10)
            b16, b32 = cuda_ms(make(k16[i]), 10), cuda_ms(make(k32[i]), 10)
            times[name] = ([a16, b16], [a32, b32])
        plain_f = cuda_ms(lambda: FG.flash_geometric_forward_compact_plain(
            q, k, v, store, *plan, "euclidean", ones, 0.0, seed0, True), 2)
        plain_b = cuda_ms(lambda: FG.flash_geometric_backward_compact_plain(
            q, k, v, store, out, lse, do, *plan, "euclidean", ones, 0.0,
            seed0, False, dlse, True), 2)
        out_s, lse_s = k16[0](q, k, v, store, *plan, sdp, ones, seed0, 0.0)
        k1_sdp = cuda_ms(lambda: k16[0](q, k, v, store, *plan, sdp, ones,
                                        seed0, 0.0), 10)
        g_sdp = FG._backward_compact(q, k, v, store, out_s, lse_s, do, plan,
                                     plan_t, sdp, ones, 0.0, seed0, False,
                                     None, True)
        pairs = int(FG.unpack_bits(store).sum().item())
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    live = lse_s < 1e29
    lib = {"B1c": None, "bwd": None, "error": None}
    # 5d and 5e compiled flex_attention under other functions and dtypes:
    # past dynamo's recompile limit it would run unfused
    torch._dynamo.reset()
    t0 = time.perf_counter()
    try:                            # the yardstick only: never the port
        bmask, flex, _ = flex_compact_setup(FG, bq, store, plan)
        with torch.no_grad():
            f_out, f_lse = flex(bq, bk, bv, block_mask=bmask,
                                return_lse=True)
            sync()
            lib["B1c"] = cuda_ms(lambda: flex(bq, bk, bv, block_mask=bmask,
                                              return_lse=True), 20)
        leaves = [t.detach().clone().requires_grad_() for t in (bq, bk, bv)]
        bdo = do.bfloat16()

        def lib_fb():
            o = flex(*leaves, block_mask=bmask)
            return torch.autograd.grad(o, leaves, bdo)

        def lib_f():
            with torch.no_grad():
                flex(*leaves, block_mask=bmask)
        f_grads = lib_fb()
        sync()
        lib["bwd"] = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
        flex_err = max([rel_err(f_lse.float()[live], lse_s[live]),
                        rel_err(f_out.float()[live], out_s[live])]
                       + [rel_err(f.float(), g)
                          for f, g in zip(f_grads, g_sdp[:3])])
        lib["err"] = flex_err
        if not flex_err <= FLEX_BF16_TOL:
            lib.update(B1c=None, bwd=None, error=(
                f"flex_attention on bf16 inputs differs from the bf16 B1c / "
                f"B3a c + B3b c at the scaled-dot metric: {flex_err} > "
                f"{FLEX_BF16_TOL}"))
        del f_grads, leaves
    except Exception as e:
        lib["error"] = f"{type(e).__name__}: {e}"[:300]
    lib["setup_and_timing_s"] = time.perf_counter() - t0
    qkv = 4 * G * H * N * (2 * D + Dv)
    plan_b = 4 * sum(p.numel() for p in plan)
    bounds = compact_bwd_bounds(FG, q, v, store, plan, plan_t, pairs,
                                bound16)
    bounds["B1c"] = bound16(qkv + store.numel() * store.element_size()
                            + plan_b + 4 * H + 4 * G + 4 * G * H * N
                            * (Dv + 1), 2 * H * pairs * (D + Dv))
    res = {}
    for name in calls:
        fwd = name == "B1c"
        res[name] = dict(ms=times[name][0], fp32_ms=times[name][1],
                         plain_ms=plain_f if fwd else plain_b,
                         library_ms=lib["B1c"] if fwd else lib["bwd"],
                         bound_share=bounds[name]["bound_ms"]
                         / min(times[name][0]), **bounds[name])
    res.update(library=lib, valid_pairs=pairs, b1c_sdp_ms=k1_sdp)
    log(f"[5i] bf16 compact forms, one snapshot of N={N}: "
        + "; ".join(f"{n} bf16 ms {' '.join(f'{x:.4f}' for x in t[0])} (fp32 "
                    f"{' '.join(f'{x:.4f}' for x in t[1])})"
                    for n, t in times.items())
        + f"; compact plain bf16 ms forward {plain_f:.4f}, backward "
        f"{plain_b:.4f}")
    log(f"[5i] library: compiled flex_attention on bf16 q, k, v under the "
        f"compact plan's BlockMask at the scaled-dot metric (forward, and "
        f"forward+backward - forward): {lib} (bf16 B1c at that metric "
        f"{k1_sdp:.4f} ms)")
    for name in calls:
        r = res[name]
        log(f"[5i] {name} bf16 bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bytes']} bytes, {r['flops']} flops over "
            f"{pairs} valid pairs at the bf16 rate), {r['bound_share']:.4f} "
            f"of it reached")
    return res


def phase_train_mid_hybrid(tt, FG):
    """The hybrid model at N_MID_HYB nodes: 3 AdamW steps over a
    ``plan="hybrid"`` loader on the card (B1c, B3a c, B3b c) and on the
    CPU (plain versions) from the same weights and batches."""
    ds = tt.TemporalGraphDataset(
        [hybrid_snaps(N_MID_HYB, DEG_HYB, T_HYB, 70 + s) for s in range(3)],
        [1.0, 0.0, 1.0])
    card = train_steps(tt, FG, hybrid_config(tt), DEV, ds, "hybrid")
    cpu = train_steps(tt, FG, hybrid_config(tt), "cpu", ds, "hybrid")
    res = card_vs_cpu("7c", card, cpu, N_MID_HYB)
    launched = [card["launched"], cpu["launched"]]
    want = {k.name: 3 * 2 for k in (
        FG.flash_geometric_fwd_compact_kernel,
        FG.flash_geometric_bwd_dq_compact_kernel,
        FG.flash_geometric_bwd_dkv_compact_kernel)}
    log(f"[7c] hybrid launches card, cpu {launched}")
    if launched != [want, {}]:
        raise AssertionError(f"launches {launched}, card expected {want}")
    return res


# -- phase 2g -----------------------------------------------------------------

def compact_biased_bwd_inputs(FG, G, H, N, D, Dv, metric, seed, pack, rate):
    """2d's inputs on the compact store (bits or int8) with a bias store
    in its slots and both walks; in snapshot 1 the keys from 128 cleared,
    so that it has fewer occupied tiles than the store's S (slots no walk
    visits); union-like row statistics, as the hybrid backward passes
    them: the compact plain forward's lse1 and lse2 raised by a constant
    on live rows, lse2 = NEG_INF on dead rows (the merge's mark), delta2 =
    rowsum(dO out), and a residual delta1 (0.25 N(0, 1) on live rows)."""
    q, k, v, mask, bias, scale, seeds = biased_small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    do = small_inputs(FG, G, H, N, D, Dv, metric, seed)[3]
    if G > 1 and N > 2 * FG.BLOCK_N:
        mask[1, :, 2 * FG.BLOCK_N:] = 0
        bias = torch.where(mask != 0, bias, torch.zeros((), device=DEV))
    store, plan = FG.compact_from_mask(mask, pack=pack)
    plan_t = FG.compact_transposed_plan(mask)
    bias_store = FG.compact_values(mask, bias)
    lse1 = FG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale)
    live = lse1 < 1e29
    lse1 = torch.where(live, lse1 + 0.25, lse1).contiguous()
    out, lse2 = FG.flash_biased_forward_compact_plain(
        q, k, v, store, bias_store, lse1, *plan, metric, scale, rate, seeds)
    lse2 = torch.where(live, lse2 + 0.1,
                       torch.full_like(lse2, -1e30)).contiguous()
    g = torch.Generator(device=DEV).manual_seed(seed + 2)
    d1_rest = 0.25 * torch.randn(lse1.shape, device=DEV, generator=g) * live
    return (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do,
            lse1, lse2, (do * out).sum(-1).contiguous(), d1_rest)


def compact_biased_bwd_errors(FG, label, got, q, k, v, store, bias_store,
                              plan, metric, scale, seeds, rate, do, lse1,
                              lse2, delta2, d1_rest):
    """{B6c+B7a c, B7b c: error} of `_biased_backward_compact`'s outputs
    ``got`` (dq, dk, dv, dB, dscale, delta1) against the compact plain
    parts on the same inputs (delta1 = B6c's plus ``d1_rest``): each
    output's max abs error over its largest entry (at least 1), the row
    walk's delta1, dB at the store's pairs (it sets no other entry), dq
    and dscale, the key walk's dk and dv; raises past TOL or on a
    non-finite output."""
    dq, dk, dv, db, dsc, d1 = got
    need = dsc is not None
    common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
    p_d1, p_db = FG.flash_biased_bwd_pre_compact_plain(
        *common, *plan, metric, scale, rate, seeds)
    d1u = p_d1 + d1_rest
    p_dq, p_dsc = FG.flash_biased_bwd_dq_compact_plain(
        *common, d1u, *plan, metric, scale, rate, seeds, need)
    p_dk, p_dv = FG.flash_biased_bwd_dkv_compact_plain(
        *common, d1u, *plan, metric, scale, rate, seeds)
    sync()
    on = FG.store_pairs(store)
    db, p_db = db[on], p_db[on]
    for name, t in (("delta1", d1), ("dB", db), ("dq", dq), ("dk", dk),
                    ("dv", dv)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    err = {"B6c+B7a c": max(rel_err(d1, d1u), rel_err(db, p_db),
                            rel_err(dq, p_dq),
                            rel_err(dsc, p_dsc) if need else 0.0),
           "B7b c": max(rel_err(dk, p_dk), rel_err(dv, p_dv))}
    if not max(err.values()) <= TOL:
        raise AssertionError(f"{label}: errors {err} > {TOL}")
    return err


def compact_biased_bwd_vs_plain(FG, G, H, N, D, Dv, metric, rate, pack,
                                seed=0, band=False, twice=False):
    """The compact row walk (B6c and B7a c, the residual's delta1 added
    between its passes), then the key walk (B7b c) on the union's delta1
    (`_biased_backward_compact`), against the compact plain parts; dq
    exactly 0 on dead rows, dk and dv on the empty key strip (keys 64-127,
    or with ``band`` `tests.test_torch_gpu.band_mask`'s keys 192-255 over
    `band_compact`'s walks); with ``twice``, a second call bit for
    bit."""
    if band:
        from tests.test_torch_gpu import _compact_biased_bwd_inputs
        (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do,
         lse1, lse2, delta2, d1_rest) = (
            t.to(DEV).contiguous() if torch.is_tensor(t)
            else tuple(x.to(DEV).contiguous() for x in t)
            for t in _compact_biased_bwd_inputs(G, H, N, D, Dv, metric, pack,
                                                rate, seed, band=True))
        strip = slice(3 * FG.BLOCK_N, 4 * FG.BLOCK_N)
    else:
        (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do,
         lse1, lse2, delta2, d1_rest) = compact_biased_bwd_inputs(
            FG, G, H, N, D, Dv, metric, seed, pack, rate)
        strip = slice(FG.BLOCK_N, 2 * FG.BLOCK_N)
    need = metric in FG.SCALED_METRICS

    def call():
        return FG._biased_backward_compact(
            q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
            metric, scale, rate, seeds, need, d1_rest)
    got = call()
    label = (f"compact biased {metric} rate={rate} G={G} H={H} N={N} D={D} "
             f"Dv={Dv} pack={pack} band={band}")
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (torch.all(got[0][dead] == 0)
            and (N <= 2 * FG.BLOCK_M or (torch.all(got[1][0, :, strip] == 0)
                                         and torch.all(got[2][0, :, strip]
                                                       == 0)))):
        raise AssertionError(f"{label}: dead rows or the empty key strip "
                             f"not exactly 0")
    if twice:
        on = FG.store_pairs(store)
        again = call()
        same = [torch.equal(a, b) for a, b in zip(got[:3], again[:3])] + [
            torch.equal(got[3][on], again[3][on]), torch.equal(got[5],
                                                               again[5])]
        if need:
            same.append(torch.equal(got[4], again[4]))
        if not all(same):
            raise AssertionError(f"{label}: a second call differs: {same}")
    return compact_biased_bwd_errors(FG, label, got, q, k, v, store,
                                     bias_store, plan, metric, scale, seeds,
                                     rate, do, lse1, lse2, delta2, d1_rest)


def phase_small_compact_biased_bwd(FG):
    errs = []
    for pack in (True, False):
        for metric in FG.MXU_METRICS:
            for rate in (0.0, 0.1):
                errs.append(compact_biased_bwd_vs_plain(
                    FG, 2, 3, 150, 16, 8, metric, rate, pack))
        for D, Dv in ((7, 3), (40, 72), (128, 128)):
            errs.append(compact_biased_bwd_vs_plain(
                FG, 2, 2, 200, D, Dv, "gaussian_kernel", 0.1, pack, 1))
        # the band's cases, each called twice
        for metric, rate in (("euclidean", 0.0), ("gaussian_kernel", 0.1),
                             ("scaled_dot_product", 0.1),
                             ("cosine_distance", 0.0)):
            errs.append(compact_biased_bwd_vs_plain(
                FG, 2, 4, 330, 16, 16, metric, rate, pack, 3, True, True))
    for H in (8, 40):
        errs.append(compact_biased_bwd_vs_plain(
            FG, 2, H, 330, 16, 16, "gaussian_kernel", 0.1, True, 5, True,
            True))
    errs.append(compact_biased_bwd_vs_plain(
        FG, 1, 1, 330, 128, 128, "euclidean", 0.1, False, 4, True))
    out = {name: max(e[name] for e in errs)
           for name in ("B6c+B7a c", "B7b c")}
    log(f"[2g] the compact row walk (B6c + B7a c: delta1, dB at the store's "
        f"pairs, dq, dscale) and key walk (B7b c: dk, dv) vs the compact "
        f"plain parts, bit and int8 stores, union statistics, the band's "
        f"cases (a slot with no bit, walk entries past the counts), folds "
        f"of 8 and 40 heads, nine cases called twice bit for bit: "
        f"{len(errs)} cases; max err {out} (tol {TOL})")
    return out


# -- phase 2k -----------------------------------------------------------------

def compact_biased_bf16_errors(FG, label, got, q, k, v, store, bias_store,
                               plan, metric, scale, seeds, rate, do, lse1,
                               lse2, delta2, d1_rest):
    """{B6c+B7a c, B7b c: (max abs error, max error, mean error,
    witness)} of `_biased_backward_compact`'s bf16 outputs ``got`` (dq,
    dk, dv, dB, dscale, delta1) against the compact plain bf16 parts on
    the same inputs (delta1 = B6c's plus ``d1_rest``) under the bf16
    gates, the compact plain fp32 parts the witness: the row walk's
    delta1, dB at the store's pairs (the walk sets no other entry), dq
    and dscale (the max gate alone), the key walk's dk and dv. Each
    walk's worst output."""
    dq, dk, dv, db, dsc, d1 = got
    need = dsc is not None
    common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
    parts = {}
    for bf16 in (True, False):
        p_d1, p_db = FG.flash_biased_bwd_pre_compact_plain(
            *common, *plan, metric, scale, rate, seeds, bf16)
        d1u = p_d1 + d1_rest
        p_dq, p_dsc = FG.flash_biased_bwd_dq_compact_plain(
            *common, d1u, *plan, metric, scale, rate, seeds, need, bf16)
        p_dk, p_dv = FG.flash_biased_bwd_dkv_compact_plain(
            *common, d1u, *plan, metric, scale, rate, seeds, bf16)
        parts[bf16] = dict(delta1=d1u, dB=p_db, dq=p_dq, dscale=p_dsc,
                           dk=p_dk, dv=p_dv)
    sync()
    want, f32 = parts[True], parts[False]
    on = FG.store_pairs(store)
    g = {n: bf16_gates(f"{label} {n}", x[sel], want[n][sel], f32[n][sel])
         for n, x, sel in (("delta1", d1, ...), ("dB", db, on),
                           ("dq", dq, ...), ("dk", dk, ...),
                           ("dv", dv, ...))}
    if need:
        g["dscale"] = bf16_gates(f"{label} dscale", dsc, want["dscale"],
                                 f32["dscale"], witness=False, mean=False)
    return {"B6c+B7a c": max(g["delta1"], g["dB"], g["dq"],
                             g.get("dscale", g["dq"])),
            "B7b c": max(g["dk"], g["dv"])}


def compact_biased_bf16_inputs(FG, G, H, N, D, Dv, metric, rate, pack, seed,
                               band):
    """2g's inputs (`compact_biased_bwd_inputs`), or with ``band``
    `tests.test_torch_gpu._compact_biased_bwd_inputs`' at `band_mask`'s
    cases over `band_compact`'s walks, q and k at half scale as the card's
    bf16 tests take them (``BF16_QK_SCALE``), on the card."""
    if not band:
        return compact_biased_bwd_inputs(FG, G, H, N, D, Dv, metric, seed,
                                         pack, rate)
    from tests.test_torch_gpu import _compact_biased_bf16_inputs
    return _compact_biased_bf16_inputs(DEV, G, H, N, D, Dv, metric, pack,
                                       rate, seed, band=True)


def compact_biased_bf16_vs_plain(FG, G, H, N, D, Dv, metric, rate, pack,
                                 seed=0, band=False, twice=False):
    """B4c and B5c in their bf16 forms, then the bf16 row walk (B6c and
    B7a c, the residual's delta1 added between its passes) and key walk
    (B7b c) against the compact plain bf16 versions on one input of 2g
    (``band``: at the band's cases), under the bf16 gates with the
    compact plain fp32 versions as the witness: lse1, then out and lse2
    on 2g's union-like lse1 (the plain B5c walking the same plan), then
    the backward (`_biased_backward_compact` with bf16) on 2g's
    statistics (`compact_biased_bf16_errors`), its outputs allocated
    NaN-filled (`tests.test_torch_gpu.nan_empty`): every entry of delta1,
    dq, dk, dv and dscale set, dB NaN exactly off the store's pairs (the
    walk writes and reads nothing else); dead rows, and dk and dv on the
    empty key strip, exactly 0. With ``twice``, 19 more calls of the
    backward bit for bit. Returns {kernel: (max abs error, max error, mean
    error, witness)} of its worst output."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = compact_biased_bf16_inputs(
        FG, G, H, N, D, Dv, metric, rate, pack, seed, band)
    label = (f"compact biased bf16 {metric} rate={rate} G={G} H={H} N={N} "
             f"D={D} Dv={Dv} pack={pack} band={band}")
    need = metric in FG.SCALED_METRICS
    b4c, b5c = compact_biased_kernels(FG, True)[:2]
    l1 = b4c(q, k, store, *plan, metric, scale)
    out, l2 = b5c(q, k, v, store, bias_store, lse1, *plan, metric, scale,
                  seeds, rate)

    from tests.test_torch_gpu import nan_empty

    def call():
        with nan_empty():
            return FG._biased_backward_compact(
                q, k, v, store, bias_store, do, lse1, lse2, delta2, plan,
                plan_t, metric, scale, rate, seeds, need, d1_rest, True)
    got = call()
    sync()
    on = FG.store_pairs(store)
    set_ = [got[0], got[1], got[2], got[5]] + ([got[4]] if need else [])
    if not (all(bool(torch.isfinite(t).all()) for t in set_)
            and bool(torch.isfinite(got[3][on]).all())
            and bool(torch.isnan(got[3][~on]).all())):
        raise AssertionError(f"{label}: an output entry left unset, or dB "
                             f"written off the store's pairs")
    fwd = {}
    for bf16 in (True, False):
        p_l1 = FG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale,
                                           bf16)
        fwd[bf16] = (p_l1, *FG.flash_biased_forward_compact_plain(
            q, k, v, store, bias_store, lse1, *plan, metric, scale, rate,
            seeds, bf16))
    (p_l1, p_out, p_l2), (f_l1, f_out, f_l2) = fwd[True], fwd[False]
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    strip = (slice(3 * FG.BLOCK_N, 4 * FG.BLOCK_N) if band
             else slice(FG.BLOCK_N, 2 * FG.BLOCK_N))
    if not (torch.all(l1[dead] == FG.LSE_DEAD)
            and torch.all(l2[dead] == FG.LSE_DEAD)
            and torch.all(out[dead] == 0) and torch.all(got[0][dead] == 0)
            and (N <= 2 * FG.BLOCK_M or (torch.all(got[1][0, :, strip] == 0)
                                         and torch.all(got[2][0, :, strip]
                                                       == 0)))):
        raise AssertionError(f"{label}: dead rows or the empty key strip "
                             f"not exactly 0")
    if twice:
        first = [t.clone() for t in got[:3]] + [got[3][on], got[5].clone()]
        for _ in range(19):
            again = call()
            same = [torch.equal(a, b) for a, b in zip(
                first, [*again[:3], again[3][on], again[5]])]
            if need:
                same.append(torch.equal(got[4], again[4]))
            if not all(same):
                raise AssertionError(f"{label}: a repeated call differs: "
                                     f"{same}")
    live = ~dead
    res = {"B4c": bf16_gates(f"{label} lse1", l1[live], p_l1[live],
                             f_l1[live], witness=False),
           "B5c": max(bf16_gates(f"{label} out", out[live], p_out[live],
                                 f_out[live]),
                      bf16_gates(f"{label} lse2", l2[live], p_l2[live],
                                 f_l2[live], witness=False))}
    res.update(compact_biased_bf16_errors(
        FG, label, got, q, k, v, store, bias_store, plan, metric, scale,
        seeds, rate, do, lse1, lse2, delta2, d1_rest))
    return res


def zero_rest_witness(FG, pack):
    """The bf16 walks given a zero residual delta1 where the true one is
    not 0, held to the plain bf16 parts on the true one: the gates must
    fail (a walk that dropped ``delta1_rest`` would pass 2k only if they
    could not tell). Returns the failure's message."""
    (q, k, v, _, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = compact_biased_bf16_inputs(
        FG, 2, 4, 330, 16, 16, "euclidean", 0.0, pack, 3, True)
    got = FG._biased_backward_compact(
        q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
        "euclidean", scale, 0.0, seeds, False, torch.zeros_like(d1_rest),
        True)
    try:
        compact_biased_bf16_errors(FG, "zero delta1_rest", got, q, k, v,
                                   store, bias_store, plan, "euclidean",
                                   scale, seeds, 0.0, do, lse1, lse2, delta2,
                                   d1_rest)
    except AssertionError as e:
        return str(e)
    raise AssertionError(f"pack={pack}: the bf16 walks given a zero "
                         f"delta1_rest passed the gates against the true one")


def phase_small_compact_biased_bf16(FG):
    """[2k] the bf16 forms of B4c, B5c and the compact row walk (B6c and
    B7a c) and key walk (B7b c), bit and int8 stores: every metric with
    dropout 0 and 0.1 at (D, Dv) = (16, 8), and (D, Dv) of (16, 16), (8,
    8), (12, 12), (7, 3) and (128, 128); 2g's union-like statistics with
    a residual delta1 that is not 0, dscale for gaussian/rbf, dead rows,
    a row tile with jcount = 0, an empty key strip, unvisited slots; the
    band's cases (`tests.test_torch_gpu.band_mask` over `band_compact`'s
    walks) at four metrics, one of them called 20 times bit for bit;
    every backward output allocated NaN-filled. Then the witness: the
    walks given a zero delta1_rest fail the gates, both stores. Then a
    jslot (islot) past the store raises before any launch at each of the
    four bf16 entries."""
    cases = [(metric, 16, 8, rate) for metric in FG.MXU_METRICS
             for rate in (0.0, 0.1)]
    cases += [("scaled_dot_product", 16, 16, 0.1), ("scaled_dot_product", 8,
                                                    8, 0.1),
              ("gaussian_kernel", 12, 12, 0.0), ("dot_product", 7, 3, 0.1),
              ("euclidean", 128, 128, 0.1)]
    band_cases = [("euclidean", 0.0), ("gaussian_kernel", 0.1),
                  ("scaled_dot_product", 0.1), ("cosine_distance", 0.0)]
    worst = {}
    n = 0
    for pack in (True, False):
        runs = [(2, 3, 150, D, Dv, metric, rate, pack, 0, False, False)
                for metric, D, Dv, rate in cases]
        runs += [(2, 4, 330, 16, 16, metric, rate, pack, 3, True, i == 0)
                 for i, (metric, rate) in enumerate(band_cases)]
        for run in runs:
            for name, r in compact_biased_bf16_vs_plain(FG, *run).items():
                worst[name] = max(worst.get(name, r), r)
            n += 1
    witness = [zero_rest_witness(FG, pack) for pack in (True, False)]
    (q, k, v, _, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, _) = compact_biased_bwd_inputs(
        FG, 1, 2, 150, 16, 16, "dot_product", 0, True, 0.0)
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    js[0, 0, 0] = isl[0, 0, 0] = store.shape[1]
    common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
    _, _, row_k, key_k = compact_biased_kernels(FG, True)
    before = counts(FG)
    refused = 0
    for call in (
            lambda: FG.flash_lse1_compact(q, k, store, jl, jc, js,
                                          metric="dot_product", bf16=True),
            lambda: FG.flash_biased_fwd_compact(
                q, k, v, store, bias_store, lse1, jl, jc, js,
                metric="dot_product", bf16=True),
            lambda: row_k(*common, None, jl, jc, js, "dot_product", scale,
                          seeds, 0.0, False),
            lambda: key_k(*common, lse1, il, ic, isl, "dot_product", scale,
                          seeds, 0.0)):
        try:
            call()
        except ValueError:
            refused += 1
    if refused != 4 or counts(FG) != before:
        raise AssertionError(f"a bad jslot: {refused} of 4 entries refused "
                             f"it; launches {counts(FG)} vs {before}")
    walks = phase_compact_fwd_walk(FG, True)
    worst["B5c"] = max(worst["B5c"], walks["B5c"][1])
    worst["B4c"] = max(worst["B4c"], walks["B4c"][1])
    worst["B1c"] = walks["B1c"][1]
    log(f"[2k] bf16 forms of B4c, B5c, the row walk (B6c + B7a c) and the "
        f"key walk (B7b c) vs the compact plain bf16 versions, bit and int8 "
        f"stores, union statistics with a residual delta1, the band's "
        f"cases, outputs allocated NaN-filled (dB NaN exactly off the "
        f"store's pairs), one band case 20 times bit for bit: {n} cases; "
        f"worst (max abs err, max err, mean err, witness over the largest "
        f"entry) "
        + "; ".join(f"{n_} {tuple(f'{x:.3e}' for x in r)}"
                    for n_, r in worst.items())
        + f" (tol {BF16_MAX_TOL}, {BF16_MEAN_TOL}, witness {BF16_WITNESS}x);"
        f" given a zero delta1_rest the gates fail (bit, int8 store): "
        f"{[w[:160] for w in witness]}; a bad jslot raised before launch "
        f"at all 4 entries; the bf16 compact forward walk at the band's "
        f"cases (every metric, dropouts off and on, head dims, folds of 1, "
        f"4 and 33 heads, outputs allocated NaN-filled, two cases 20 times "
        f"bit for bit): "
        + ", ".join(f"{n_} {c} cases, worst {tuple(f'{x:.3e}' for x in e)}"
                    for n_, (c, e) in walks.items()))
    return {n_: r[0] for n_, r in worst.items()}


# -- phases 4f, 5f, 6d, 7d: training the edge-feature hybrid model ------------

def phase_hybrid_edge_train_vs_csr(tt, FG):
    """At full width, one sequence of distinct non-loop edges with 4 edge
    features: the edge-feature hybrid model's first-step gradients (B4c
    and B5c forward, B6c, B7a c and B7b c backward, the residual's two
    sides, the bias store's gather) against the csr model's (its own
    O(E) formula under autograd, an independent one for dB) on the card,
    the same weights."""
    seq = hybrid_snaps(N_HYB, DEG_HYB, T_HYB, 61, edge_dim=F_EDGE,
                       unique=True)
    ds = tt.TemporalGraphDataset([seq], [1.0])
    grads, losses = {}, {}
    for backend in ("hybrid", "csr"):
        model = tt.TAGAN(hybrid_config(tt, edge=True, backend=backend),
                         device=DEV,
                         generator=torch.Generator().manual_seed(0))
        loader = tt.TemporalGraphDataLoader(
            ds, batch_size=1, dense_adj=False,
            plan="hybrid" if backend == "hybrid" else None)
        b, y, _ = next(iter(loader))
        loss = model(b, y).loss
        loss.backward()
        losses[backend] = loss.item()
        grads[backend] = {n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()}
        del model, loader, b, loss
    err, zero = grad_errors(grads["hybrid"], grads["csr"])
    edge = {n: g.abs().max().item() for n, g in grads["hybrid"].items()
            if "edge" in n}
    E = seq[0]["edge_index"].shape[1]
    log(f"[4f] N={N_HYB}, {E} distinct non-loop edges in snapshot 0, edge "
        f"features: first-step gradients hybrid vs csr on the card: max err "
        f"over each tensor's largest entry {err:.3e} (tol {TOL_HYB_CSR_GRAD}; "
        f"at fp32 noise {zero}); largest |gradient| of the edge parameters "
        f"{edge}; losses {losses}")
    if not err <= TOL_HYB_CSR_GRAD:
        raise AssertionError(f"edge hybrid vs csr gradients {err} > "
                             f"{TOL_HYB_CSR_GRAD}")
    if not all(m > 0 for m in edge.values()):
        raise AssertionError(f"zero edge-parameter gradient: {edge}")
    return dict(grad_err=err, noise_tensors=zero, losses=losses, edges=E,
                edge_grad_max=edge)


def hybrid_edge_layer0_bwd(FG, model, batch, bf16=False):
    """Layer 0's edge-feature hybrid inputs (`hybrid_layer0`) with the
    folded transposed walk, and the union statistics of its backward as
    ``_HybridBiasedAttention`` forms them: lse1 (B4c's and the residual's
    union), out and lse2 (B5c's partial merged with the residual's; their
    bf16 forms' with ``bf16``), a cotangent dO (N(0, 1), seed 13), delta2
    and the residual's delta1."""
    from tagan_torch.ops import hybrid_biased as HB
    from tagan_torch.ops.sparse import merge_attention_partials
    (q, k, v, store, plan, res), (bst, rb) = hybrid_layer0(FG, model, batch)
    G, H, N = q.shape[:3]
    plan_t = FG.fold_compact(batch.hyb_mask_blocks, batch.hyb_plan_t, G)[1]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    m = "euclidean"
    b4c, b5c = compact_biased_kernels(FG, bf16)[:2]
    with torch.no_grad():
        lse1 = HB.lse_union(
            b4c(q, k, store, *plan, m, ones),
            HB.residual_lse1(m, q, k, *res, N, ones)).contiguous()
        band = b5c(q, k, v, store, bst, lse1, *plan, m, ones, seeds, 0.0)
        part = HB.residual_biased_partial(m, q, k, v, *res, N, rb, lse1,
                                          ones)
        out, lse2 = merge_attention_partials([band, part])
        lse2 = lse2.contiguous()
        do = torch.randn(out.shape, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(13))
        delta2 = (do * out).sum(-1).contiguous()
        d1_rest = HB._residual_backward(m, q, k, v, do, *res, N, rb, lse1,
                                        lse2, delta2, ones)[1]
    return (q, k, v, store, bst, plan, plan_t, res, rb, do, lse1, lse2,
            delta2, d1_rest)


def phase_train_hybrid_edge(tt, FG, bf16=False, data=None):
    """`TAGANTrainer.train` on the 131K edge-feature hybrid model (part C,
    Fe = 4) over a ``plan="hybrid"`` loader, one sequence per batch: the
    loader's planning batch apart from the cached ones, one warm-up step,
    then 3 steps with launch counts set to 0 just before and read just
    after (the compact row and key walks each once per layer per step);
    step times, split, peak memory, one layer's two walks over the folded
    snapshots and their share of the step, finite losses and non-zero
    gradients (the edge parameters included), every parameter moved; one
    snapshot at full width against the compact plain parts. With
    ``bf16`` [6h]: the model with bf16_matmul=True over 6d's
    loaders and planned batches ``data`` (the bf16 forms of B4c, B5c,
    B6c, B7a c and B7b c each once per layer per step, the fp32 forms
    never), held to the compact plain bf16 parts under the bf16 gates.
    The loaders and batches are returned under "data"."""
    tag = "6h" if bf16 else "6d"
    kerns = compact_biased_kernels(FG, bf16)
    cfg = hybrid_config(tt, edge=True, bf16=bf16)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    exp = tt.ExperimentConfig(model=cfg, batch_size=1, num_epochs=1, seed=0,
                              checkpoint_dir="", shuffle=False)
    if data is None:
        ds = tt.TemporalGraphDataset(
            [hybrid_snaps(N_HYB, DEG_HYB, T_HYB, 700 + s, edge_dim=F_EDGE)
             for s in range(TRAIN_STEPS + 1)], [1.0, 0.0, 1.0, 0.0])
        kw = dict(batch_size=1, dense_adj=False, plan="hybrid")
        warm = tt.TemporalGraphDataLoader(ds.subset([0]), **kw)
        loader = tt.TemporalGraphDataLoader(
            ds.subset(list(range(1, TRAIN_STEPS + 1))), **kw)
        batch_s, batches = [], []
        it = iter(loader)
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            batches.append(next(it))
            batch_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        list(loader)
        cached_epoch_s = time.perf_counter() - t0
        log(f"[6d] edge-feature hybrid N={N_HYB}, T={T_HYB}, Fe={F_EDGE}: "
            f"the loader's batches (plan='hybrid') s "
            f"{[round(x, 3) for x in batch_s]} (the first packs and plans "
            f"all {TRAIN_STEPS} sequences), a cached epoch "
            f"{cached_epoch_s:.3f} s; bucket pin {loader.plan_pins}")
    else:
        warm, loader, batches, batch_s, cached_epoch_s = data
        log(f"[{tag}] edge-feature hybrid N={N_HYB}, T={T_HYB}, Fe={F_EDGE},"
            f" bf16_matmul=True: 6d's loaders and their planned batches "
            f"(bucket pin {loader.plan_pins})")
    trainer = tt.TAGANTrainer(model, exp)
    trainer.train(warm, verbose=False)
    sync()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts(FG)
    t0 = time.perf_counter()
    res = trainer.train(loader, verbose=False)
    sync()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    launched = counts(FG)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    want = {k.name: 0 for k in FG.KERNELS}
    for kern in kerns:
        want[kern.name] = cfg.num_layers * TRAIN_STEPS
    losses = res["history"]["train_loss"]
    no_grad = check_grads(model)
    edge_grads = {n: p.grad.abs().max().item()
                  for n, p in model.named_parameters() if "edge" in n}
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    moved = len(before) - len(still)
    log(f"[{tag}] {TRAIN_STEPS} steps of TAGANTrainer.train in {epoch_ms:.3f} "
        f"ms; mean loss {losses}; peak device memory {peak_gb:.3f} GB above "
        f"the {held_gb:.3f} GB held before; launches {launched} (expected "
        f"{want}); {len(before) - len(no_grad)} of {len(before)} gradients "
        f"finite and non-zero where not zero in exact arithmetic; largest "
        f"|gradient| of the edge parameters {edge_grads}; parameters moved "
        f"{moved} of {len(before)} (not moved: {still})")
    if launched != want:
        raise AssertionError(f"launches {launched} != {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"loss not finite: {losses}")
    if no_grad:
        raise AssertionError(f"no finite non-zero gradient: {no_grad}")
    if not all(m > 0 for m in edge_grads.values()):
        raise AssertionError(f"zero edge-parameter gradient: {edge_grads}")
    if set(still) - set(ZERO_GRAD):
        raise AssertionError(f"parameters not moved: {still}")

    step_ms = step_times(trainer, batches)
    b, y, m = batches[0]
    splits = step_split(trainer, b, y, m)
    log(f"[{tag}] step ms (host clock, synchronised) "
        f"{[round(x, 3) for x in step_ms]}; split (CUDA events) forward / "
        f"backward / optimizer ms "
        f"{[[round(x, 3) for x in s] for s in splits]}")

    # one layer's backward launches over the batch's folded snapshots
    trainer.optimizer.zero_grad()
    (q, k, v, store, bst, plan, plan_t, rs, rb, do, lse1, lse2, delta2,
     d1_rest) = hybrid_edge_layer0_bwd(FG, model, b.to(DEV), bf16)
    G, H = q.shape[:2]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, 2, dtype=torch.int32, device=DEV)
    rows = (do, lse1, lse2, delta2)
    with torch.no_grad():
        fold_fwd = cuda_ms(lambda: (
            kerns[0](q, k, store, *plan, "euclidean", ones),
            kerns[1](q, k, v, store, bst, lse1, *plan, "euclidean", ones,
                     seeds, 0.0)), 3)
        fold_bwd = cuda_ms(lambda: FG._biased_backward_compact(
            q, k, v, store, bst, *rows, plan, plan_t, "euclidean", ones, 0.0,
            seeds, False, d1_rest, bf16), 3)
    step = min(step_ms)
    share = cfg.num_layers * fold_bwd / step
    bwd_name = "the bf16 row and key walks" if bf16 \
        else "the row and key walks"
    log(f"[{tag}] one layer's launches over the {G} folded snapshots: B4c+B5c "
        f"{fold_fwd:.3f} ms, {bwd_name} {fold_bwd:.3f} ms; "
        f"{cfg.num_layers} layers' {bwd_name} = {share:.3f} and with "
        f"B4c+B5c {cfg.num_layers * (fold_fwd + fold_bwd) / step:.3f} of the "
        f"fastest step ({step:.3f} ms)")

    # one snapshot at full width against the compact plain parts
    one = tuple(t[:1].contiguous() for t in (q, k, v, store, bst))
    plan1, plan_t1 = (tuple(t[:1].contiguous() for t in p)
                      for p in (plan, plan_t))
    rows1 = tuple(t[:1].contiguous() for t in (*rows, d1_rest))
    res1 = (tuple(t[:1] for t in rs), rb[:1])
    del q, k, v, store, bst, rows, do, lse1, lse2, delta2, d1_rest
    got = FG._biased_backward_compact(*one, *rows1[:4], plan1, plan_t1,
                                      "euclidean", ones, 0.0, seeds[:1],
                                      False, rows1[4], bf16)
    if bf16:
        gates = compact_biased_bf16_errors(
            FG, f"N={N_HYB}", got, *one, plan1, "euclidean", ones,
            seeds[:1], 0.0, *rows1)
        full = {n: r[0] for n, r in gates.items()}
        log(f"[{tag}] bf16 compact biased backward at N={N_HYB}, one "
            f"snapshot, union statistics, vs the compact plain bf16 parts "
            f"(bf16 gates): (max abs err, max err, mean err, witness) "
            + "; ".join(f"{n} {tuple(f'{x:.3e}' for x in r)}"
                        for n, r in gates.items()))
    else:
        full = compact_biased_bwd_errors(
            FG, f"N={N_HYB}", got, *one, plan1, "euclidean", ones,
            seeds[:1], 0.0, *rows1)
        log(f"[6d] compact biased backward at N={N_HYB}, one snapshot, "
            f"union statistics, vs the compact plain parts: max err the row "
            f"walk (B6c + B7a c) {full['B6c+B7a c']:.3e}, the key walk "
            f"(B7b c) {full['B7b c']:.3e}")
    del got
    return dict(data=(warm, loader, batches, batch_s, cached_epoch_s),
                batch_s=batch_s, cached_epoch_s=cached_epoch_s,
                pins={str(k): v for k, v in loader.plan_pins.items()},
                epoch_ms=epoch_ms, step_ms=step_ms, split_ms=splits,
                loss=losses, launches=launched, peak_memory_gb=peak_gb,
                held_gb=held_gb, edge_grad_max=edge_grads, moved=moved,
                fold_b4c_b5c_ms=fold_fwd, fold_b6c_b7c_ms=fold_bwd,
                b6c_b7c_share_of_step=share, full_err=full,
                args=(*one, plan1, plan_t1, res1, rows1))


def compact_biased_fwd_bounds(q, v, store, plan, pairs, bound_of=None):
    """B4c's and B5c's least time from these inputs: q and k (and for B5c
    v and lse1), the store, the bias at the valid pairs only, the walk,
    scale and seeds read once, lse1 (B5c: out and lse2) written once,
    against the products on the valid pairs at the fp32 peak
    (``bound_of``: `bound16` for the bf16 rate)."""
    bound_of = bound_of or bound
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    qk = 4 * G * H * N * 2 * D
    rows = 4 * G * H * N
    st = store.numel() * store.element_size()
    plan_b = 4 * sum(p.numel() for p in plan)
    return {"B4c": bound_of(qk + st + plan_b + 4 * H + rows,
                            2 * H * pairs * D),
            "B5c": bound_of(qk + 4 * G * H * N * Dv + st + 4 * pairs + rows
                            + plan_b + 4 * (H + 2 * G) + 4 * G * H * N * Dv
                            + rows, 2 * H * pairs * (D + Dv))}


def compact_walk_bounds(FG, q, v, store, plan, plan_t, pairs,
                        bound_of=None):
    """The compact row walk's (B6c and B7a c), the key walk's (B7b c) and
    the two walks' least time from these inputs: q, k, v, dO, lse1, lse2
    and delta2, the row walk's delta1_rest and the key walk's delta1, the
    store, the bias at the valid pairs only (4 bytes each: the result
    depends on no other entry), the walks, scale and seeds read once; the
    row walk's delta1, dB at the valid pairs and dq, the key walk's dk
    and dv written once; against the products on the valid pairs at the
    fp32 peak (the row walk's two passes: q.k and do.v twice and W k;
    the key walk's q.k, do.v, W q and drop2(w2) do; ``bound_of``:
    `bound16` for the bf16 rate)."""
    bound_of = bound_of or bound
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    HN = G * H * N
    common = (4 * HN * (2 * D + 2 * Dv) + 3 * 4 * HN
              + store.numel() * store.element_size() + 4 * pairs
              + 4 * (H + 2 * G))
    plan_b, plan_tb = (4 * sum(t.numel() for t in p) for p in (plan, plan_t))
    row_b = 4 * HN + plan_b + 4 * HN + 4 * pairs + 4 * HN * D
    key_b = 4 * HN + plan_tb + 4 * HN * (D + Dv)
    row_f = 2 * H * pairs * (3 * D + 2 * Dv)
    key_f = 2 * H * pairs * (2 * D + 2 * Dv)
    return {"B6c+B7a c": bound_of(common + row_b, row_f),
            "B7b c": bound_of(common + key_b, key_f),
            "both": bound_of(common + row_b + plan_tb + 4 * HN * (D + Dv),
                             row_f + key_f)}


def tile_occupancy(FG, store, plan):
    """The valid pairs of each walked 64 x 64 tile of snapshot 0, as a
    histogram over power-of-two bins: {"0": tiles with no pair, "1",
    "2-3", ..., "2048-4095", "4096"}, and the quantiles."""
    jl, jc, js = (t[0] for t in plan)
    live = torch.arange(jl.shape[-1], device=jl.device) < jc[:, None]
    per = FG.store_pairs(store)[0][js[live].long()].sum((-1, -2))
    per = per.cpu()
    hist = {"0": int((per == 0).sum())}
    lo = 1
    while lo < 4096:
        hist[f"{lo}" if lo == 1 else f"{lo}-{2 * lo - 1}"] = int(
            ((per >= lo) & (per < 2 * lo)).sum())
        lo *= 2
    hist["4096"] = int((per == 4096).sum())
    q = torch.quantile(per.double(), torch.tensor(
        [0.1, 0.5, 0.9, 0.99], dtype=torch.float64)).tolist()
    return dict(histogram=hist, tiles=int(per.numel()),
                pairs=int(per.sum()), mean=float(per.double().mean()),
                max=int(per.max()), quantiles_10_50_90_99=q,
                rows_past_64=int((per > 64).sum()))


def phase_times_hybrid_edge_bwd(FG, args):
    """At one 131K snapshot of 6d, CUDA events: the compact row walk (B6c
    and B7a c), the key walk (B7b c) and the two together
    (`_biased_backward_compact`) against the compact plain parts (pre,
    then dq and dk/dv), compiled ``flex_attention``'s backward of B4c and
    B5c's function under the compact plan's BlockMask at the scaled-dot
    metric (forward+backward minus forward; held against the walks at
    that metric on band-only statistics), csr ``edge_attention``'s biased
    autograd backward over the layer's whole edge set, and the bounds;
    first, the histogram of valid pairs per walked tile."""
    from tagan_torch.ops.sparse import edge_attention
    (q, k, v, store, bst, plan, plan_t, ((res_eq, res_ek, res_em), rb),
     (do, lse1, lse2, delta2, d1_rest)) = args
    _, H, N, D = q.shape
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(1, 2, dtype=torch.int32, device=DEV)
    sdp = "scaled_dot_product"
    d1_rest = d1_rest.contiguous()
    occ = tile_occupancy(FG, store, plan)
    log(f"[5f] valid pairs per walked 64x64 tile, one snapshot of N={N}: "
        f"{occ['tiles']} walked tiles, {occ['pairs']} pairs, mean "
        f"{occ['mean']:.2f}, max {occ['max']}, quantiles 10/50/90/99% "
        f"{occ['quantiles_10_50_90_99']}; histogram {occ['histogram']}")
    row_k, key_k = (FG.flash_biased_bwd_row_compact_kernel,
                    FG.flash_biased_bwd_key_compact_kernel)
    with torch.no_grad():
        common = (q, k, v, store, bst, do, lse1, lse2, delta2)
        d1 = row_k(*common, d1_rest, *plan, "euclidean", ones, seeds, 0.0,
                   False)[0]

        def row():
            row_k(*common, d1_rest, *plan, "euclidean", ones, seeds, 0.0,
                  False)

        def key():
            key_k(*common, d1, *plan_t, "euclidean", ones, seeds, 0.0)

        def both(metric="euclidean", c=common, rest=d1_rest):
            return FG._biased_backward_compact(
                *c, plan, plan_t, metric, ones, 0.0, seeds, False, rest)

        def plain():
            p_d1 = FG.flash_biased_bwd_pre_compact_plain(
                *common, *plan, "euclidean", ones, 0.0, seeds)[0]
            FG._biased_bwd_compact_plain(
                *common, *plan, "euclidean", ones, 0.0, seeds,
                p_d1 + d1_rest, False, ("dq", "dkv"))
        p1, a1, a2, p2 = (cuda_ms(plain, 2), cuda_ms(both, 10),
                          cuda_ms(both, 10), cuda_ms(plain, 2))
        t_row = [cuda_ms(row, 10), cuda_ms(row, 10)]
        t_key = [cuda_ms(key, 10), cuda_ms(key, 10)]
        # the band alone at the scaled-dot metric: the function the
        # library computes
        l1_s = FG.flash_lse1_compact_kernel(q, k, store, *plan, sdp, ones)
        out_s, l2_s = FG.flash_biased_fwd_compact_kernel(
            q, k, v, store, bst, l1_s, *plan, sdp, ones, seeds, 0.0)
        c_sdp = (q, k, v, store, bst, do, l1_s, l2_s,
                 (do * out_s).sum(-1).contiguous())
        a_sdp = cuda_ms(lambda: both(sdp, c_sdp, None), 10)
        g_sdp = both(sdp, c_sdp, None)
        pairs = occ["pairs"]
        walked = occ["tiles"]

        # the csr form of the layer's whole edge set: the band's pairs
        # with their store bias and the residual edges with theirs
        eq_b, ek_b, (t_, r_, c_) = band_edges(FG, store, plan)
        jl, jc, js = (p[0] for p in plan)
        live = torch.arange(jl.shape[1], device=DEV) < jc[:, None]
        b_band = bst[0][js[live].long()][t_, r_, c_]
        eq = torch.cat([eq_b, res_eq[0][res_em[0]].long()])[None]
        ek = torch.cat([ek_b, res_ek[0][res_em[0]].long()])[None]
        eb = torch.cat([b_band, rb[0][res_em[0]]])[None]
        em = torch.ones_like(eq, dtype=torch.bool)
        del eq_b, ek_b, b_band, t_, r_, c_
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, eb)]

    def csr_fb():
        o = edge_attention("euclidean", *leaves[:3], eq, ek, em, N,
                           edge_bias=leaves[3])
        torch.autograd.grad(o, leaves, do)

    def csr_f():
        with torch.no_grad():
            edge_attention("euclidean", *leaves[:3], eq, ek, em, N,
                           edge_bias=leaves[3])
    csr_ms = [cuda_ms(csr_fb, 5) - cuda_ms(csr_f, 5),
              cuda_ms(csr_fb, 5) - cuda_ms(csr_f, 5)]
    del leaves
    # the library: compiled flex_attention, B4c's then B5c's function
    # under the compact plan's BlockMask (lse1 flows from the first call
    # into the second's score_mod; the bias store requires grad)
    torch._dynamo.reset()
    t0 = time.perf_counter()
    try:
        bmask, flex, slot_map = flex_compact_setup(FG, q, store, plan)
        fl = [t.detach().clone().requires_grad_() for t in (q, k, v, bst[0])]
        bm = FG.BLOCK_M

        def two_calls(ql, kl, vl, bl):
            l1 = flex(ql, kl, vl, block_mask=bmask, return_lse=True)[1]

            def biased(s, b, h, qi, kv):
                sl = slot_map[qi // bm, kv // bm].clamp(min=0)
                return torch.exp(s - l1[b, h, qi]) + bl[sl, qi % bm, kv % bm]
            return flex(ql, kl, vl, score_mod=biased, block_mask=bmask)

        def lib_fb():
            return torch.autograd.grad(two_calls(*fl), fl, do)

        def lib_f():
            with torch.no_grad():
                two_calls(*fl)
        f_grads = lib_fb()
        sync()
        # the walks set dB at the store's pairs only: compare there
        on = FG.store_pairs(store)[0]
        flex_err = max(rel_err(f_grads[0], g_sdp[0]),
                       rel_err(f_grads[1], g_sdp[1]),
                       rel_err(f_grads[2], g_sdp[2]),
                       rel_err(f_grads[3][on], g_sdp[3][0][on]))
        del f_grads
        ms = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
        lib = dict(ms=ms if flex_err <= TOL else None, err=flex_err,
                   error=None if flex_err <= TOL else
                   f"differs from the compact walks by {flex_err:.3e}")
    except Exception as e:          # the yardstick only: never the port
        lib = dict(ms=None, err=None, error=f"{type(e).__name__}: {e}"[:300])
    lib["setup_and_timing_s"] = time.perf_counter() - t0
    bounds = compact_walk_bounds(FG, q, v, store, plan, plan_t, pairs)
    res = {"B6c+B7a c": dict(ms=t_row, **bounds["B6c+B7a c"]),
           "B7b c": dict(ms=t_key, **bounds["B7b c"]),
           "both": dict(ms=[a1, a2], sdp_ms=a_sdp, **bounds["both"]),
           "plain_ms": [p1, p2], "library": lib, "csr_ms": csr_ms,
           "csr_edges": int(eq.shape[-1]), "valid_pairs": pairs,
           "walked_tiles": walked, "occupancy": occ}
    log(f"[5f] H={H} N={N} D={D}, one snapshot, compact biased backward "
        f"(union statistics): the row walk (B6c + B7a c) ms "
        f"{t_row[0]:.4f} {t_row[1]:.4f}, the key walk (B7b c) "
        f"{t_key[0]:.4f} {t_key[1]:.4f}; the two ms {a1:.4f} {a2:.4f} "
        f"(scaled-dot metric, band statistics {a_sdp:.4f}); compact plain "
        f"parts ms {p1:.4f} {p2:.4f}; csr biased edge_attention backward "
        f"over all {res['csr_edges']} edges ms {csr_ms[0]:.4f} "
        f"{csr_ms[1]:.4f}")
    log(f"[5f] library: compiled flex_attention backward of B4c and B5c's "
        f"function under the compact plan's BlockMask at the scaled-dot "
        f"metric: {lib}")
    for name in ("B6c+B7a c", "B7b c", "both"):
        r = res[name]
        log(f"[5f] {name} bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['flops']} flops over {pairs} valid "
            f"pairs on {walked} walked tiles per head); "
            f"{r['bound_ms'] / min(r['ms']):.4f} of it reached")
    return res


# -- phase 5j -----------------------------------------------------------------

def phase_times_hybrid_edge_bf16(FG, args):
    """[5j] B4c and B5c in their bf16 forms and the bf16 compact row walk
    (B6c and B7a c) and key walk (B7b c) at one 131K snapshot of 6h
    (union statistics, the residual's delta1 added by the row walk), CUDA
    events, each beside its fp32 form in turns; the compact plain bf16
    versions; compiled ``flex_attention`` on bf16 q, k, v under the
    compact plan's BlockMask at the scaled-dot metric as the library
    yardstick: B4c's function (lse only) and B5c's (exp(s - lse1) + the
    bias store, lse1 given), held against the bf16 kernels at that metric
    on band statistics (null with the reason where it does not build or
    differs), and the backward of the two calls (forward+backward minus
    forward), its gradients' error against the bf16 walks' at that metric
    recorded, not gated (flex rounds its outputs and gradients to bf16);
    the bounds: the fp32 forms' bytes (the inputs stay fp32) and the
    valid pairs' operations at the bf16 tensor-core rate, and each walk's
    share of its bound."""
    (q, k, v, store, bst, plan, plan_t, _,
     (do, lse1, lse2, delta2, d1_rest)) = args
    H = q.shape[1]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(1, 2, dtype=torch.int32, device=DEV)
    sdp = "scaled_dot_product"
    d1_rest = d1_rest.contiguous()
    k32, k16 = compact_biased_kernels(FG, False), compact_biased_kernels(
        FG, True)
    with torch.no_grad():
        common = (q, k, v, store, bst, do, lse1, lse2, delta2)

        def row(kern):
            return lambda: kern(*common, d1_rest, *plan, "euclidean", ones,
                                seeds, 0.0, False)
        d1_16, d1_32 = (row(kern[2])()[0] for kern in (k16, k32))

        def key(kern, d1):
            return lambda: kern(*common, d1, *plan_t, "euclidean", ones,
                                seeds, 0.0)
        calls = {
            "B4c": (lambda: k16[0](q, k, store, *plan, "euclidean", ones),
                    lambda: k32[0](q, k, store, *plan, "euclidean", ones)),
            "B5c": (lambda: k16[1](q, k, v, store, bst, lse1, *plan,
                                   "euclidean", ones, seeds, 0.0),
                    lambda: k32[1](q, k, v, store, bst, lse1, *plan,
                                   "euclidean", ones, seeds, 0.0)),
            "B6c+B7a c": (row(k16[2]), row(k32[2])),
            "B7b c": (key(k16[3], d1_16), key(k32[3], d1_32))}
        times = {}
        for name, (f16, f32) in calls.items():
            a32, a16 = cuda_ms(f32, 10), cuda_ms(f16, 10)
            b16, b32 = cuda_ms(f16, 10), cuda_ms(f32, 10)
            times[name] = ([a16, b16], [a32, b32])
        plain4 = cuda_ms(lambda: FG.flash_lse1_compact_plain(
            q, k, store, *plan, "euclidean", ones, True), 2)
        plain5 = cuda_ms(lambda: FG.flash_biased_forward_compact_plain(
            q, k, v, store, bst, lse1, *plan, "euclidean", ones, 0.0, seeds,
            True), 2)

        def plain_bwd():
            p_d1 = FG.flash_biased_bwd_pre_compact_plain(
                *common, *plan, "euclidean", ones, 0.0, seeds, True)[0]
            FG._biased_bwd_compact_plain(
                *common, *plan, "euclidean", ones, 0.0, seeds,
                p_d1 + d1_rest, False, ("dq", "dkv"), True)
        plain_b = cuda_ms(plain_bwd, 2)
        # the band alone at the scaled-dot metric: the function the
        # library computes
        l1_s = k16[0](q, k, store, *plan, sdp, ones)
        out_s, l2_s = k16[1](q, k, v, store, bst, l1_s, *plan, sdp, ones,
                             seeds, 0.0)
        k4_sdp = cuda_ms(lambda: k16[0](q, k, store, *plan, sdp, ones), 10)
        k5_sdp = cuda_ms(lambda: k16[1](q, k, v, store, bst, l1_s, *plan,
                                        sdp, ones, seeds, 0.0), 10)
        c_sdp = (q, k, v, store, bst, do, l1_s, l2_s,
                 (do * out_s).sum(-1).contiguous())
        walks_sdp = cuda_ms(lambda: FG._biased_backward_compact(
            *c_sdp, plan, plan_t, sdp, ones, 0.0, seeds, False, None, True),
            10)
        g_sdp = FG._biased_backward_compact(
            *c_sdp, plan, plan_t, sdp, ones, 0.0, seeds, False, None, True)
        pairs = int(FG.unpack_bits(store).sum().item())
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    live = l1_s < 1e29
    lib = {"B4c": None, "B5c": None, "error": None}
    lib_bwd = {"ms": None, "error": None}
    band = None
    # 5d-5i compiled flex_attention under other functions and dtypes: past
    # dynamo's recompile limit it would run unfused
    torch._dynamo.reset()
    t0 = time.perf_counter()
    try:                            # the yardstick only: never the port
        bmask, flex, slot_map = flex_compact_setup(FG, bq, store, plan)
        bm = FG.BLOCK_M

        def band(ql, kl, vl, bl, l1=None):
            """B4c's function (unless ``l1`` is given), then B5c's."""
            if l1 is None:
                l1 = flex(ql, kl, vl, block_mask=bmask, return_lse=True)[1]

            def biased(s, b, h, qi, kv):
                sl = slot_map[qi // bm, kv // bm].clamp(min=0)
                return torch.exp(s - l1[b, h, qi]) + bl[sl, qi % bm, kv % bm]
            return l1, flex(ql, kl, vl, score_mod=biased, block_mask=bmask,
                            return_lse=True)
        with torch.no_grad():
            f_l1, (f_out, f_l2) = band(bq, bk, bv, bst[0])
            sync()
            lib["B4c"] = cuda_ms(lambda: flex(bq, bk, bv, block_mask=bmask,
                                              return_lse=True), 20)
            lib["B5c"] = cuda_ms(lambda: band(bq, bk, bv, bst[0], f_l1), 20)
        flex_err = max(rel_err(f_l1.float()[live], l1_s[live]),
                       rel_err(f_l2.float()[live], l2_s[live]),
                       rel_err(f_out.float()[live], out_s[live]))
        lib["err"] = flex_err
        if not flex_err <= FLEX_BF16_TOL:
            lib.update(B4c=None, B5c=None, error=(
                f"flex_attention on bf16 inputs differs from the bf16 "
                f"B4c/B5c at the scaled-dot metric: {flex_err} > "
                f"{FLEX_BF16_TOL}"))
    except Exception as e:
        lib["error"] = f"{type(e).__name__}: {e}"[:300]
    lib["setup_and_timing_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:                            # the yardstick only: never the port
        if band is None:
            raise RuntimeError(f"no flex_attention setup: {lib['error']}")
        fl = [t.detach().clone().requires_grad_()
              for t in (bq, bk, bv, bst[0])]
        bdo = do.bfloat16()

        def lib_fb():
            return torch.autograd.grad(band(*fl)[1][0], fl, bdo)

        def lib_f():
            with torch.no_grad():
                band(*fl)
        f_grads = lib_fb()
        sync()
        lib_bwd["ms"] = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
        lib_bwd["form"] = ("both calls; gradients of q, k, v and the bias "
                           "store, lse1 differentiated")
        # the walks set dB at the store's pairs only: compare there
        on = FG.store_pairs(store)[0]
        lib_bwd["grad_err"] = {
            "dq": rel_err(g_sdp[0], f_grads[0].float()),
            "dk": rel_err(g_sdp[1], f_grads[1].float()),
            "dv": rel_err(g_sdp[2], f_grads[2].float()),
            "dB": rel_err(g_sdp[3][0][on], f_grads[3].float()[on])}
        del f_grads, fl
    except Exception as e:
        lib_bwd["error"] = f"{type(e).__name__}: {e}"[:300]
    lib_bwd["setup_and_timing_s"] = time.perf_counter() - t0
    bounds = {**compact_biased_fwd_bounds(q, v, store, plan, pairs, bound16),
              **compact_walk_bounds(FG, q, v, store, plan, plan_t, pairs,
                                    bound16)}
    res = {}
    for name in calls:
        fwd = name in ("B4c", "B5c")
        res[name] = dict(ms=times[name][0], fp32_ms=times[name][1],
                         plain_ms=(plain4 if name == "B4c" else plain5
                                   if name == "B5c" else plain_b),
                         library_ms=lib[name] if fwd else lib_bwd["ms"],
                         **bounds[name])
        res[name]["bound_share"] = res[name]["bound_ms"] / min(
            times[name][0])
    res.update(library=lib, library_bwd=lib_bwd, valid_pairs=pairs,
               b4c_sdp_ms=k4_sdp, b5c_sdp_ms=k5_sdp, walks_sdp_ms=walks_sdp)
    log(f"[5j] bf16 compact biased forms, one snapshot of N={q.shape[2]}, "
        f"union statistics: "
        + "; ".join(f"{n} bf16 ms {' '.join(f'{x:.4f}' for x in t[0])} "
                    f"(fp32 {' '.join(f'{x:.4f}' for x in t[1])})"
                    for n, t in times.items())
        + f"; compact plain bf16 ms B4c {plain4:.4f}, B5c {plain5:.4f}, "
        f"backward {plain_b:.4f} (\"B6c+B7a c\": the row walk, \"B7b c\": "
        f"the key walk)")
    log(f"[5j] library: compiled flex_attention on bf16 q, k, v under the "
        f"compact plan's BlockMask at the scaled-dot metric (B4c's and B5c's "
        f"functions): {lib} (bf16 B4c at that metric {k4_sdp:.4f} ms, B5c "
        f"{k5_sdp:.4f}, the two bf16 walks {walks_sdp:.4f}); forward+"
        f"backward - forward of the two calls {lib_bwd}")
    for name in calls:
        r = res[name]
        log(f"[5j] {name} bf16 bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bytes']} bytes, {r['flops']} flops over "
            f"{pairs} valid pairs at the bf16 rate); {r['bound_share']:.4f} "
            f"of it reached")
    return res


def phase_train_mid_hybrid_edge(tt, FG):
    """The edge-feature hybrid model at N_MID_HYB nodes: 3 AdamW steps
    over a ``plan="hybrid"`` loader on the card (B4c, B5c, B6c, B7a c,
    B7b c) and on the CPU (plain versions) from the same weights and
    batches."""
    ds = tt.TemporalGraphDataset(
        [hybrid_snaps(N_MID_HYB, DEG_HYB, T_HYB, 80 + s, edge_dim=F_EDGE)
         for s in range(3)], [1.0, 0.0, 1.0])
    card = train_steps(tt, FG, hybrid_config(tt, edge=True), DEV, ds,
                       "hybrid")
    cpu = train_steps(tt, FG, hybrid_config(tt, edge=True), "cpu", ds,
                      "hybrid")
    res = card_vs_cpu("7d", card, cpu, N_MID_HYB)
    launched = [card["launched"], cpu["launched"]]
    want = {k.name: 3 * 2 for k in compact_biased_kernels(FG, False)}
    log(f"[7d] edge-feature hybrid launches card, cpu {launched}")
    if launched != [want, {}]:
        raise AssertionError(f"launches {launched}, card expected {want}")
    return res


# -- phases 3i, 3j, 4g, 6i: host packing and the RCM slot order, attention ----
# -- weights, the loss families -----------------------------------------------

def seconds(fn):
    """(host seconds of ``fn()``, its result)."""
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def repeated(fns: dict, reps: int = 5) -> dict:
    """Host seconds of each of ``fns`` over ``reps`` rounds, the order of
    the functions alternating from round to round: {name: {"median",
    "min", "max"}}."""
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(seconds(fns[k])[0])
    return {k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
            for k, v in times.items()}


def spread(t: dict) -> str:
    return f"{t['median']:.4f} s ({t['min']:.4f}-{t['max']:.4f})"


def nonzero(launched: dict) -> dict:
    return {k: v for k, v in launched.items() if v}


def walked_tiles(FG, seq) -> int:
    """The 64 x 64 tiles the flash plan of a packed sequence walks, over
    its snapshots."""
    seq = seq.to(DEV)
    plan, _ = FG.make_block_plans_from_edges(
        seq.edge_src, seq.edge_dst, seq.edge_mask, seq.node_mask,
        seq.max_nodes)
    return int(plan[1].sum())


def phase_serve_rcm(tt, FG, serve):
    """[3i] Phase 3's requests through ``Predictor(reorder="rcm")``, held
    to phase 3's probabilities (``serve["probs"]``); the host times of
    packing one of its requests with and without the reorder and of the
    RCM order alone, and of packing one 3c request; the flash plan's
    walked tiles with and without the reorder."""
    from tagan_torch.core import graph as G
    t_phase = time.perf_counter()
    cfg = model_config(tt)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    requests = [[make_sequence(rng, N_FULL, E_FULL, T_FULL)
                 for _ in range(SEQS_PER_REQUEST)] for _ in range(REQUESTS)]
    pred = tt.Predictor(model, dims=(T_FULL, N_FULL, E_FULL, 0),
                        batch_size=SEQS_PER_REQUEST, reorder="rcm")
    fwd = FG.flash_geometric_fwd_kernel
    reset_counts(FG)
    lat, probs = [], []
    for req in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_proba(req))   # host copy: synchronises
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = counts(FG)
    expected = {k.name: 0 for k in FG.KERNELS}
    expected[fwd.name] = cfg.num_layers * REQUESTS
    probs = np.concatenate(probs)
    err = float(np.abs(probs.ravel() - np.asarray(serve["probs"])).max())

    kw = dict(max_nodes=N_FULL, max_edges=E_FULL, max_time=T_FULL,
              edge_feature_dim=0, dense_adj=False)
    req = requests[0]
    pack = repeated({
        "sorted IDs": lambda: [tt.build_sequence(s, **kw) for s in req],
        "rcm": lambda: [tt.build_sequence(s, reorder="rcm", **kw)
                        for s in req],
        "rcm order alone": lambda: [G.locality_order(
            [G._unpack_snapshot(snap) for snap in s]) for s in req]})
    walked = {"sorted IDs": walked_tiles(FG, tt.build_sequence(req[0], **kw)),
              "rcm": walked_tiles(FG, tt.build_sequence(
                  req[0], reorder="rcm", **kw))}
    hkw = dict(max_nodes=N_HYB, max_edges=N_HYB * DEG_HYB, max_time=T_HYB,
               edge_feature_dim=0, dense_adj=False)
    hreq = hybrid_requests(False, 100)[0][0]      # 3c's first request
    h_pack = repeated({"sorted IDs": lambda: [tt.build_sequence(s, **hkw)
                                              for s in hreq]})
    res = dict(latency_ms=lat, launches=launched, prob_err=err,
               request_pack_s=pack, walked_tiles_per_sequence=walked,
               hybrid_request_pack_s=h_pack,
               seconds=time.perf_counter() - t_phase)
    log(f"[3i] Predictor(reorder='rcm') on phase 3's {REQUESTS} requests: "
        f"latency ms {[round(x, 3) for x in lat]}; launches "
        f"{nonzero(launched)} (expected {nonzero(expected)}, no other); "
        f"probabilities {probs.ravel().tolist()} vs "
        f"phase 3's, max abs err {err:.3e}; one request ({SEQS_PER_REQUEST} "
        f"sequences of {T_FULL} x {N_FULL} nodes, {E_FULL} edges) packed, "
        f"median (range) of 5 alternating rounds: sorted IDs "
        f"{spread(pack['sorted IDs'])}, with RCM {spread(pack['rcm'])}, the "
        f"RCM order alone {spread(pack['rcm order alone'])}; flash tiles "
        f"walked by one sequence's plan: {walked} (uniform random edges "
        f"leave RCM no locality to find); one 3c request ({SEQS_PER_REQUEST} "
        f"sequences of {T_HYB} x {N_HYB} nodes, {N_HYB * DEG_HYB} edges) "
        f"packed in {spread(h_pack['sorted IDs'])}; phase "
        f"{res['seconds']:.1f} s")
    if launched != expected:
        raise AssertionError(f"launches {launched} != {expected}")
    if not (np.isfinite(probs).all() and err <= TOL):
        raise AssertionError(f"reordered serving: err {err} > {TOL}")
    return res


def phase_serve_hybrid_rcm(tt, FG, serve_hyb):
    """[3j] One part C sequence with its node IDs relabelled by a seeded
    permutation (the same x rows and edge_index: the same graph), served
    on the hybrid model with ``reorder="rcm"``, against the sequence with
    its IDs unchanged served without reorder (3c's form); plan sizes and
    band shares of both beside 3c's pin, and the band the relabelled
    sequence would get without RCM."""
    from tagan_torch.core import graph as G
    t_phase = time.perf_counter()
    cfg = hybrid_config(tt)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    seq = hybrid_snaps(N_HYB, DEG_HYB, T_HYB, 100)
    perm = np.random.default_rng(29).permutation(N_HYB)
    relabelled = [dict(s, node_ids=perm) for s in seq]
    dims = (T_HYB, N_HYB, N_HYB * DEG_HYB, 0)
    b1c = compact_kernels(FG, False)[0]
    pred = tt.Predictor(model, dims=dims, batch_size=1, reorder="rcm")
    reset_counts(FG)
    lat_s, probs = seconds(lambda: pred.predict_proba([relabelled]))
    launched = counts(FG)
    expected = {k.name: 0 for k in FG.KERNELS}
    expected[b1c.name] = cfg.num_layers
    base = tt.Predictor(model, dims=dims, batch_size=1).predict_proba([seq])
    err = float(np.abs(probs - base).max())

    hkw = dict(max_nodes=N_HYB, max_edges=N_HYB * DEG_HYB, max_time=T_HYB,
               edge_feature_dim=0, dense_adj=False)
    rcm_s, _ = seconds(lambda: G.locality_order(
        [G._unpack_snapshot(s) for s in relabelled]))
    pack_s, packed = seconds(lambda: tt.build_sequence(
        relabelled, reorder="rcm", **hkw))
    plan_s, (planned, pin) = seconds(lambda: G.attach_hybrid_plans(
        [packed]))
    base_planned, base_pin = G.attach_hybrid_plans(
        [tt.build_sequence(seq, **hkw)])

    def band_share(s):
        return float((s.hyb_band_slot >= 0).sum() / s.edge_mask.sum())
    # the relabelled sequence in sorted-ID slots: its band (the 95%
    # quantile of |src - dst|) and its occupied tiles, counted in numpy
    # (planning it would need a store of most of the 2,048^2 tiles)
    scr = tt.build_sequence(relabelled, **hkw)
    src, dst, em = (t.numpy().astype(np.int64) for t in (
        scr.edge_src, scr.edge_dst, scr.edge_mask))
    em = em.astype(bool)
    gap = np.abs(src - dst)
    width = int(np.quantile(gap[em], 0.95))
    n_t = -(-N_HYB // 64)
    tiles = max(np.unique((src[t] // 64 * n_t + dst[t] // 64)[
        em[t] & (gap[t] <= width)]).size for t in range(T_HYB))
    batch = tt.batch_sequences(planned).to(DEV)
    with torch.inference_mode():
        model(batch)
        sync()
        fwd_ms, _ = seconds(lambda: (model(batch), sync()))
    fwd_ms *= 1e3
    res = dict(latency_s=lat_s, launches=launched, prob_err=err,
               rcm_s=rcm_s, pack_with_rcm_s=pack_s, plan_s=plan_s, pin=pin,
               band_share=band_share(planned[0]), unrelabelled_pin=base_pin,
               unrelabelled_band_share=band_share(base_planned[0]),
               serve_3c_pin=serve_hyb["pin"],
               without_rcm={"band_width": width, "max_band_tiles": tiles,
                            "all_tiles": n_t * n_t},
               forward_ms=fwd_ms, seconds=time.perf_counter() - t_phase)
    log(f"[3j] part C sequence ({T_HYB} x {N_HYB} nodes, {N_HYB * DEG_HYB} "
        f"edges a snapshot) with its IDs permuted, Predictor(reorder='rcm') "
        f"on the hybrid model: {lat_s:.3f} s; launches {nonzero(launched)} "
        f"(expected {nonzero(expected)}, no other); probabilities "
        f"{probs.ravel().tolist()} vs "
        f"{base.ravel().tolist()} with the IDs unchanged and no reorder, max "
        f"abs err {err:.3e}; RCM {rcm_s:.3f} s, packing with RCM "
        f"{pack_s:.3f} s (RCM included), planning {plan_s:.3f} s; plan "
        f"{pin}, band share {res['band_share']:.4f}, beside the unchanged "
        f"IDs' {base_pin}, band share {res['unrelabelled_band_share']:.4f}, "
        f"and 3c's request pin {serve_hyb['pin']}; the permuted IDs without "
        f"RCM: band width {width}, {tiles} band tiles of {n_t * n_t}; "
        f"forward on the packed sequence {fwd_ms:.3f} ms; phase "
        f"{res['seconds']:.1f} s")
    if launched != expected:
        raise AssertionError(f"launches {launched} != {expected}")
    if not (np.isfinite(probs).all() and err <= TOL):
        raise AssertionError(f"reordered hybrid serving: err {err} > {TOL}")
    return res


def phase_mid_attention(tt, FG):
    """[4g] ``infer_with_attention`` on one of phase 4's sequences packed
    with its dense adjacency, card against CPU (the dense path on both:
    no kernel launched); packed without it, ValueError."""
    t_phase = time.perf_counter()
    cfg = model_config(tt)
    seq = make_sequence(np.random.default_rng(1), N_MID, 16 * N_MID, T_FULL)
    kw = dict(max_nodes=N_MID, max_edges=16 * N_MID, max_time=T_FULL)
    packed = tt.build_sequence(seq, **kw)
    sparse = tt.build_sequence(seq, dense_adj=False, **kw)
    got, launched, raised = {}, {}, {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        model = tt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        reset_counts(FG)
        got[side] = {k: v.cpu() for k, v in
                     model.infer_with_attention(packed).items()}
        launched[side] = sum(counts(FG).values())
        try:
            model.infer_with_attention(sparse)
            raised[side] = False
        except ValueError:
            raised[side] = True
    errs = {k: (got["card"][k] - w).abs().max().item()
            for k, w in got["cpu"].items()}
    shapes = {k: tuple(v.shape) for k, v in got["card"].items()}
    res = dict(errs=errs, shapes=shapes, launches=launched, raised=raised,
               seconds=time.perf_counter() - t_phase)
    log(f"[4g] infer_with_attention at N={N_MID} (dense_adj=True, the dense "
        f"path), card vs cpu: max abs err {errs}; shapes {shapes}; kernel "
        f"launches {launched}; dense_adj=False raises ValueError: {raised}; "
        f"phase {res['seconds']:.1f} s")
    if launched != {"card": 0, "cpu": 0} or not all(raised.values()):
        raise AssertionError(f"launches {launched}, raised {raised}")
    if not max(errs.values()) <= TOL:
        raise AssertionError(f"attention weights card vs cpu {errs} > {TOL}")
    return res


# (loss_type, output_dim, label of the one sequence) of each family that
# compute_loss routes, beside bce and ce (phases 6 and 7)
LOSS_FAMILIES = (
    ("focal", 1, 1.0),
    ("focal", 3, np.array([0.0, 1.0, 0.0], np.float32)),
    ("regression", 2, np.array([0.4, -1.3], np.float32)),
    ("multi_label", 3, np.array([1.0, 0.0, 1.0], np.float32)),
    ("sequence", 1, 0.7),
    ("huber", 2, np.array([1.5, -2.0], np.float32)),
    ("quantile", 1, -0.3))


def phase_train_losses(tt, FG):
    """[6i] One training step of each loss family at N_MID, card against
    CPU (loss and first-step gradients within TOL, B1 and B2 once per
    layer on the card); then one step of phase 6's trainer over a
    ``reorder="rcm"`` loader against the loader without reorder."""
    t_phase = time.perf_counter()
    seq = make_sequence(np.random.default_rng(11), N_MID, 16 * N_MID, T_FULL)
    b1, b2 = flash_kernels(FG, False)[:2]
    want = {b1.name: 2, b2.name: 2}
    fam = {}
    for loss_type, od, label in LOSS_FAMILIES:
        cfg = tt.TAGANConfig(hidden_dim=64, num_heads=4, num_layers=2,
                             node_feature_dim=F_NODE, output_dim=od,
                             loss_type=loss_type, dropout=0.0,
                             spatial_backend="flash")
        ds = tt.TemporalGraphDataset([seq], [label])
        card = train_steps(tt, FG, cfg, DEV, ds)
        cpu = train_steps(tt, FG, cfg, "cpu", ds)
        grad_err, zero = grad_errors(card["grads"], cpu["grads"])
        loss_err = abs(card["losses"][0] - cpu["losses"][0])
        fam[f"{loss_type} x{od}"] = dict(
            loss={"card": card["losses"][0], "cpu": cpu["losses"][0]},
            loss_err=loss_err, grad_err=grad_err, noise_tensors=zero,
            launches={"card": card["launched"], "cpu": cpu["launched"]})
        if card["launched"] != want or cpu["launched"] or \
                not (grad_err <= TOL and loss_err <= TOL) or \
                not np.isfinite(card["losses"][0]):
            raise AssertionError(f"[6i] {loss_type} x{od}: "
                                 f"{fam[f'{loss_type} x{od}']}")
    log("[6i] one step at N=" + str(N_MID) + " per loss family, card vs "
        "cpu: " + "; ".join(
            f"{k}: loss {r['loss']['card']:.6f} (err {r['loss_err']:.2e}), "
            f"gradients {r['grad_err']:.2e}, launches {r['launches']['card']}"
            for k, r in fam.items()))

    # phase 6's trainer and first training sequence, with and without the
    # reorder
    cfg = model_config(tt)
    rng = np.random.default_rng(2)
    seq6 = [make_sequence(rng, N_FULL, E_FULL, T_FULL) for _ in range(2)][1]
    ds = tt.TemporalGraphDataset([seq6], [0.0])
    kw = dict(batch_size=1, dense_adj=False, max_time=T_FULL,
              max_nodes=N_FULL, max_edges=E_FULL)
    steps = {}
    for reorder in (None, "rcm"):
        pack_s, (b, y, m) = seconds(lambda: next(iter(
            tt.TemporalGraphDataLoader(ds, reorder=reorder, **kw))))
        model = tt.TAGAN(cfg, device=DEV,
                         generator=torch.Generator().manual_seed(0))
        trainer = tt.TAGANTrainer(model, tt.ExperimentConfig(
            model=cfg, batch_size=1, seed=0))
        start = counts(FG)
        trainer.optimizer.zero_grad()
        loss, _ = trainer._loss(b, y, m, True)
        loss.backward()
        trainer.optimizer.step()
        steps[str(reorder)] = dict(
            loss=loss.item(), pack_s=pack_s, walked_tiles=walked_tiles(FG, b),
            launches={n: c - start[n] for n, c in counts(FG).items()
                      if c != start[n]})
    loss_err = abs(steps["None"]["loss"] - steps["rcm"]["loss"])
    res = dict(families=fam, rcm_step=steps, rcm_loss_err=loss_err,
               seconds=time.perf_counter() - t_phase)
    log(f"[6i] phase 6's step at N={N_FULL} over a reorder='rcm' loader vs "
        f"the loader without: {steps} (loss err {loss_err:.3e}); phase "
        f"{res['seconds']:.1f} s")
    if not loss_err <= TOL or any(r["launches"] != want
                                  for r in steps.values()):
        raise AssertionError(f"[6i] reordered step {steps}")
    return res


# -- phase 8: the graph-sharded ring over virtual ranks (B8, B9) ---------------

RG_SRC = "tagan_tpu/ops/pallas/ring_gather.py"
RF_SRC = "tagan_tpu/ops/pallas/ring_flash.py"
RING_GS = (2, 4, 8)
# the g whose numbers stand in the kernels line (every g is in the json)
RING_G_RECORD = 4
RING_REPEATS = 50
# 8d's random masks, keys a row: where the pair walk meets SDPA
RING_DEGREES = (256, 2048)
# the hybrid model's node count, where a graph-sharded mesh matters
N_RING_WIDE, D_RING = 131_072, 64


def ring_modules():
    from tagan_torch.dist import edge_partition as TE
    from tagan_torch.dist import mesh as TM
    from tagan_torch.ops import ring_flash as TF
    from tagan_torch.ops import ring_gather as TG
    return TM, TE, TG, TF


def phase_ring(FG, args):
    """[8]: the ring over g in RING_GS virtual ranks of the card (8a B8,
    8b B9, 8c B9's bf16 form). ``args`` is phase 3's one snapshot of the
    10K flash model's layer 0 (q, k, v [1, H, N, Dh], its flash mask)."""
    TM, TE, TG, TF = ring_modules()
    kernels = TG.KERNELS + TF.KERNELS
    gather, copy, fold, fold16 = *TG.KERNELS, *TF.KERNELS
    q, k, v = (t[0].contiguous() for t in args[:3])        # [H, N, Dh]
    mask = args[3][0]                                      # int8 [N, N]
    H, N, Dh = q.shape
    meshes = {g: TM.make_mesh(graph=g, devices=[DEV] * g) for g in RING_GS}
    gen = torch.Generator(device=DEV).manual_seed(8)
    wide = torch.randn(N_RING_WIDE, D_RING, device=DEV, generator=gen)
    gathers = {"K [10000, 64] fp32": k.transpose(0, 1).reshape(N, H * Dh)
               .contiguous(),
               "[131072, 64] fp32": wide,
               "[131072, 64] bf16": wide.to(torch.bfloat16)}
    scale = torch.ones(H, device=DEV)

    # the main path: each entry point once per configuration, the counts
    # set to 0 just before and read just after
    for kern in kernels:
        kern.launches = 0
    with torch.inference_mode():
        gathered = {(name, g): TG.ring_all_gather_sharded(meshes[g], x)
                    for name, x in gathers.items() for g in RING_GS}
        flash = {(g, False): TF.ring_flash_attention(
            meshes[g], q, k, v, mask, metric="euclidean") for g in RING_GS}
        flash[RING_G_RECORD, True] = TF.ring_flash_attention(
            meshes[RING_G_RECORD], q, k, v, mask, metric="euclidean",
            bf16=True)
        sync()
    launched = {k.name: k.launches for k in kernels}
    # B8: one launch a ring (every rank on the card); the copies are B9's,
    # k and v a rank and hop but the last
    hops = sum(2 * g * (g - 1) for g in RING_GS)
    want = {gather.name: len(gathers) * len(RING_GS),
            copy.name: hops + 2 * RING_G_RECORD * (RING_G_RECORD - 1),
            fold.name: sum(g * g for g in RING_GS),
            fold16.name: RING_G_RECORD ** 2}
    log(f"[8] main path: ring_all_gather_sharded over "
        f"{list(gathers)} x g {RING_GS}, ring_flash_attention fp32 x g "
        f"{RING_GS} and bf16 at g {RING_G_RECORD}; launches {launched} "
        f"(expected {want})")
    if launched != want or not all(launched.values()):
        raise AssertionError(f"ring launches {launched}, expected {want}")
    res = dict(launches=launched)
    res["gather"], profiled = phase_ring_gather(TM, TG, meshes, gathers,
                                                gathered)
    del gathered
    res["flash"] = phase_ring_flash(FG, TM, TE, TF, meshes, args, flash,
                                    scale)
    res["copy"] = phase_ring_copy(TM, TG, meshes[RING_G_RECORD], k)
    res["density"] = phase_ring_density(TM, TF, meshes[RING_G_RECORD],
                                        *args[:3])
    # the profiler last, so that it cannot touch the host's launches,
    # which set B9's times
    ring_device_ms(res["gather"], profiled)
    return res


def phase_ring_gather(TM, TG, meshes, gathers, gathered):
    """[8a] B8 against the rank-order concatenation, bit for bit on every
    rank, RING_REPEATS rings identical; CUDA-event ms of one ring, and the
    host's ms to issue one (its one launch), in a run of rings and onto an
    idle card; the bound: each rank reads the g - 1 chunks it does not
    own and writes all N rows, at the memory rate; the library: each
    rank's torch.cat of the shards. Returns the results and, for
    `ring_device_ms`, each case's ring and torch.cats."""
    res, profiled = {}, []
    with torch.inference_mode():
        for name, x in gathers.items():
            for g, mesh in meshes.items():
                shards = TM.shard_rows(mesh, x)
                want = TG.ring_all_gather_plain(shards)
                exact = all(torch.equal(o, w) for o, w in
                            zip(gathered[name, g], want))
                stable = True
                for _ in range(RING_REPEATS):
                    outs = TG.ring_all_gather(shards, mesh)
                    stable &= all(torch.equal(o, w)
                                  for o, w in zip(outs, want))
                del outs
                if not (exact and stable):
                    raise AssertionError(f"[8a] {name} g={g}: bit-exact "
                                         f"{exact}, {RING_REPEATS} repeats "
                                         f"identical {stable}")

                # bound to this case: `ring_device_ms` calls them later
                def ring(shards=shards, mesh=mesh):
                    TG.ring_all_gather(shards, mesh)

                def plain():
                    TG.ring_all_gather_plain(shards)

                def library(shards=shards, g=g):
                    for _ in range(g):
                        torch.cat(shards)
                p1 = cuda_ms(plain, 10)
                k1 = cuda_ms(ring, 20)
                k2 = cuda_ms(ring, 20)
                p2 = cuda_ms(plain, 10)
                lib = cuda_ms(library, 20)
                issue = host_ms(ring, 20)
                idle = idle_issue_ms(ring, 20)
                rows, e = x.shape[0], x.element_size() * x.shape[1]
                chunk = rows // g
                b = bound(g * ((g - 1) * chunk + rows) * e, 0)
                res[f"{name} g={g}"] = dict(
                    ms=[k1, k2], plain_ms=[p1, p2], library_ms=lib,
                    host_issue_ms=issue, idle_issue_ms=idle,
                    max_abs_err=0.0,
                    repeats_identical=RING_REPEATS, **b)
                profiled.append((f"{name} g={g}", ring, library))
                log(f"[8a] B8 {name} over {g} virtual ranks: bit-exact, "
                    f"{RING_REPEATS} repeats identical; ring ms {k1:.4f} "
                    f"{k2:.4f} (host clock to issue one {issue:.4f}, onto "
                    f"an idle card {idle:.4f}), plain ms {p1:.4f} "
                    f"{p2:.4f}, each rank's torch.cat {lib:.4f}; bound "
                    f"{b['bound_ms']:.5f} ms by {b['bound_by']} "
                    f"({b['bytes']} bytes)")
                del shards, want
    return res, profiled


def ring_device_ms(res, profiled):
    """[8a] the card's ms of each gather's ring and of its torch.cats by
    the profiler (`device_ms`), after the rest of phase 8."""
    with torch.inference_mode():
        for key, ring, library in profiled:
            r = res[key]
            r["device_ms"] = device_ms(ring, 20)
            r["library_device_ms"] = device_ms(library, 20)
            log(f"[8a] B8 {key}: the card's ms of a ring {r['device_ms']:.4f}"
                f", of the torch.cats {r['library_device_ms']:.4f} (the "
                f"profiler's, after 8b-8d)")


def phase_ring_flash(FG, TM, TE, TF, meshes, args, flash, scale):
    """[8b] B9 on the 10K model's layer-0 q/k/v and snapshot mask: its
    plain version on the card, B1 on the same inputs (live rows; B9's dead
    rows exactly 0) and the port's collective ring on the card; repeated
    rings identical; ms per snapshot beside SDPA at the scaled-dot metric,
    the host's ms to issue one ring (in a run of rings, and onto an idle
    card) and, at g = RING_G_RECORD, the ms of one fold launch alone (rank
    0's hop 0, its own chunk). [8c] the bf16 form at g = RING_G_RECORD
    under the bf16 gates, the fp32 form's ms in the same run."""
    q, k, v, mask = (t[0].contiguous() for t in args[:4])
    H, N, D = q.shape
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(1, dtype=torch.int32, device=DEV)
    with torch.inference_mode():
        b1 = FG.flash_geometric_fwd_kernel(*args[:6], "euclidean", ones,
                                           seed0, 0.0)[0][0]
        src, dst = (t.cpu().numpy().astype(np.int32)
                    for t in torch.nonzero(mask, as_tuple=True))
    dead = (mask == 0).all(-1)
    live = ~dead
    pairs = int(mask.count_nonzero().item())
    # every node of the snapshot is active, so its mask has no dead row:
    # the same rings also run on it with every 97th node inactive (its row
    # and column cleared, as the flash mask has an inactive node)
    off = torch.zeros(N, dtype=torch.bool, device=DEV)
    off[::97] = True
    mask_d = mask.masked_fill(off[:, None] | off[None, :], 0)
    dead_d = (mask_d == 0).all(-1)
    with torch.inference_mode():
        b1_d = FG.flash_geometric_fwd_kernel(
            q[None], k[None], v[None], mask_d[None],
            *FG.make_block_plan(mask_d[None]), "euclidean", ones, seed0,
            0.0)[0][0]
    res = {}
    for (g, bf16), got in flash.items():
        mesh = meshes[g]
        tag = "8c" if bf16 else "8b"
        with torch.inference_mode():
            qs, ks, vs = (TM.shard_rows(mesh, t, dim=1) for t in (q, k, v))
            masks = TM.shard_rows(mesh, mask)
            scales = [ones] * g

            def ring(metric="euclidean", b16=bf16):
                return TF.ring_flash_attention_local(
                    mesh, qs, ks, vs, masks, metric=metric, bf16=b16)

            def plain(b16=bf16):
                return torch.cat([TF.ring_flash_attention_local_plain(
                    qs[r], ks, vs, masks[r], r, "euclidean", scales[r], b16)
                    for r in range(g)], 1)
            want = plain()
            again = [torch.cat(ring(), 1) for _ in range(3)]
            sync()
            stable = all(torch.equal(a, got) for a in again)
            dead_zero = bool((got[:, dead] == 0).all())
            r = dict(stable=stable, dead_rows=int(dead.sum()))
            if bf16:
                f32 = plain(False)
                gates = bf16_gates(f"[8c] g={g}", got, want, f32)
                r.update(max_abs_err=gates[0], bf16_gates=gates[1:])
            else:
                err = (got - want).abs().max().item()
                err_b1 = (got - b1)[:, live].abs().max().item()
                eq, ek, em, _ = TE.partition_edges_by_query_and_key(
                    src, dst, np.ones_like(src, bool), N, g)
                coll = TE.ring_edge_attention(mesh, "euclidean", q, k, v,
                                              eq, ek, em)
                err_coll = (got - coll).abs().max().item()
                del coll
                masks_d = TM.shard_rows(mesh, mask_d)
                got_d = torch.cat(TF.ring_flash_attention_local(
                    mesh, qs, ks, vs, masks_d, metric="euclidean"), 1)
                want_d = torch.cat([TF.ring_flash_attention_local_plain(
                    qs[r_], ks, vs, masks_d[r_], r_, "euclidean", ones)
                    for r_ in range(g)], 1)
                err_d = max((got_d - want_d).abs().max().item(),
                            (got_d - b1_d)[:, ~dead_d].abs().max().item())
                dead_zero &= bool((got_d[:, dead_d] == 0).all())
                del got_d, want_d, masks_d
                r.update(max_abs_err=max(err, err_d), err_vs_b1_live=err_b1,
                         err_vs_collective_ring=err_coll,
                         inactive_mask_err=err_d,
                         inactive_dead_rows=int(dead_d.sum()))
                if not (err <= TOL and err_b1 <= TOL and err_d <= TOL
                        and err_coll <= TOL_CSR):
                    raise AssertionError(
                        f"[8b] g={g}: vs plain {err}, vs B1 {err_b1}, with "
                        f"inactive nodes vs plain and B1 {err_d} (tolerance "
                        f"{TOL}), vs the collective ring {err_coll} "
                        f"(tolerance {TOL_CSR})")
            r["dead_rows_zero"] = dead_zero
            if not (stable and dead_zero):
                raise AssertionError(f"[{tag}] g={g}: repeats identical "
                                     f"{stable}, dead rows 0 {dead_zero}")
            p1 = cuda_ms(plain, 2)
            k1 = cuda_ms(ring, 10)
            k2 = cuda_ms(ring, 10)
            p2 = cuda_ms(plain, 2)
            r["host_issue_ms"] = host_ms(ring, 10)
            r["idle_issue_ms"] = idle_issue_ms(ring, 10)
            if bf16:
                r["fp32_ms"] = [cuda_ms(lambda: ring(b16=False), 10)
                                for _ in range(2)]
            if g == RING_G_RECORD:
                r["fold_ms"] = fold_alone_ms(TF, qs, ks, vs, masks, ones,
                                             bf16)
            # the library: SDPA with the boolean mask on the full q, k, v
            # (bf16 for the bf16 form), B9 at its scaled-dot metric beside
            qf, kf, vf = (t[None].to(torch.bfloat16 if bf16 else t.dtype)
                          for t in (q, k, v))
            bmask = (mask != 0)[None, None]

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qf, kf, vf, attn_mask=bmask)
            lib = cuda_ms(library, 10)
            k_sdp = cuda_ms(lambda: ring("scaled_dot_product"), 10)
            sdpa_err = rel_err(library()[0].float()[:, live],
                               torch.cat(ring("scaled_dot_product"), 1)[
                                   :, live])
            sdpa_tol = FLEX_BF16_TOL if bf16 else TOL
            if not sdpa_err <= sdpa_tol:
                r["library_error"] = (
                    f"SDPA differs from B9 at the scaled-dot metric on live "
                    f"rows: {sdpa_err} > {sdpa_tol}")
                lib = None
            del want
        # q, k, v read once, the mask's N^2 bytes, out written; q.k and p.v
        # over the valid pairs, the pairs the walk computes
        nbytes = 4 * 4 * H * N * D + N * N
        flops = 2 * H * pairs * (D + D)
        b = bound16(nbytes, flops) if bf16 else bound(nbytes, flops)
        r.update(ms=[k1, k2], plain_ms=[p1, p2], library_ms=lib,
                 ring_sdp_ms=k_sdp, sdpa_err_live=sdpa_err,
                 valid_pairs=pairs, **b)
        res[f"g={g}" + (" bf16" if bf16 else "")] = r
        log(f"[{tag}] B9{' bf16' if bf16 else ''} at N={N}, H={H}, D={D} "
            f"over {g} virtual ranks ({N // g} rows each): "
            + (f"bf16 gates (max abs, max, mean, witness) "
               f"{tuple(f'{x:.3e}' for x in gates)}" if bf16 else
               f"vs plain {r['max_abs_err']:.3e}, vs B1 on live rows "
               f"{r['err_vs_b1_live']:.3e}, vs the collective ring "
               f"{r['err_vs_collective_ring']:.3e}; with every 97th node "
               f"inactive vs plain and B1 {r['inactive_mask_err']:.3e}, its "
               f"{r['inactive_dead_rows']} dead rows exactly 0")
            + f"; {int(dead.sum())} dead rows exactly 0, 3 repeats "
            f"identical; ms per snapshot {k1:.4f} {k2:.4f}"
            + (f" (fp32 {' '.join(f'{x:.4f}' for x in r['fp32_ms'])})"
               if bf16 else "")
            + f", plain ms {p1:.4f} {p2:.4f}; host clock to issue one "
            f"{r['host_issue_ms']:.4f} ms (one onto an idle card "
            f"{r['idle_issue_ms']:.4f})"
            + (f"; one fold launch alone (rank 0, hop 0) "
               f"{' '.join(f'{x:.4f}' for x in r['fold_ms'])} ms"
               if "fold_ms" in r else "")
            + f"; SDPA ({'bf16' if bf16 else 'fp32'}"
            f" q, k, v, bool mask) {lib} ms, B9 at the scaled-dot metric "
            f"{k_sdp:.4f} ms, SDPA vs B9 there on live rows {sdpa_err:.3e} "
            f"of the largest entry (tolerance {sdpa_tol}); bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({nbytes} bytes, "
            f"{flops} flops over the {pairs} valid pairs, the pairs the "
            f"walk computes)")
    return res


def phase_ring_copy(TM, TG, mesh, k):
    """[8b] B9's chunk mover alone: one ``ring_copy`` launch of rank 0's K
    chunk ([H, N / g, Dh] of the 10K layer 0) into a slot on the current
    stream, bit for bit, its CUDA-event ms beside ``Tensor.copy_`` (the
    plain version and the library call alike); bound: the chunk read and
    written once."""
    src = TM.shard_rows(mesh, k, dim=1)[0]
    dst = torch.empty_like(src)
    stream = torch.cuda.current_stream()
    with torch.inference_mode():
        def copy():
            TG.ring_copy_kernel(dst, src, stream)

        def plain():
            dst.copy_(src)
        dst.zero_()
        copy()
        sync()
        if not torch.equal(dst, src):
            raise AssertionError("[8b] ring_copy differs from its source")
        p1, k1, k2, p2 = (cuda_ms(f, 50) for f in (plain, copy, copy, plain))
    n = src.numel() * src.element_size()
    b = bound(2 * n, 0)
    log(f"[8b] ring_copy of a {tuple(src.shape)} fp32 K chunk: bit-exact; "
        f"ms {k1:.4f} {k2:.4f}, Tensor.copy_ {p1:.4f} {p2:.4f}; bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({2 * n} bytes)")
    return dict(ms=[k1, k2], plain_ms=[p1, p2], library_ms=min(p1, p2),
                max_abs_err=0.0, shape=list(src.shape), **b)


def fold_alone_ms(TF, qs, ks, vs, masks, scale, bf16):
    """CUDA-event ms of one B9 fold launch alone, twice: rank 0's hop 0
    (its own chunk, column block 0) on the current stream, the state
    written as between hops."""
    fold = TF.ring_flash_fold_bf16_kernel if bf16 else \
        TF.ring_flash_fold_kernel
    q = qs[0]
    H, per, _ = q.shape
    state = (torch.empty(H, per, device=DEV), torch.empty(H, per, device=DEV),
             torch.empty_like(q))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream()

    def one():
        fold(q, ks[0], vs[0], masks[0], scale, state, out, 0, "euclidean",
             True, False, stream)
    return [cuda_ms(one, 20) for _ in range(2)]


def phase_ring_density(TM, TF, mesh, q, k, v):
    """[8d] B9 and its bf16 form over the mesh's ranks on uniform random
    masks of RING_DEGREES keys a row (self loops) on the 10K layer-0 q, k,
    v: each against its plain version (fp32 within TOL, bf16 under the
    bf16 gates), ms beside SDPA with the boolean mask at each precision."""
    q, k, v = (t[0].contiguous() for t in (q, k, v))      # [H, N, D]
    H, N, _ = q.shape
    g = mesh.shape[TM.GRAPH_AXIS]
    ones = torch.ones(H, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(88)
    res = {}
    with torch.inference_mode():
        qs, ks, vs = (TM.shard_rows(mesh, t, dim=1) for t in (q, k, v))
        for deg in RING_DEGREES:
            mask = torch.rand(N, N, device=DEV, generator=gen) < deg / N
            mask.fill_diagonal_(True)
            bmask = mask[None, None]
            mask = mask.to(torch.int8)
            masks = TM.shard_rows(mesh, mask)
            pairs = int(mask.count_nonzero().item())
            for bf16 in (False, True):
                def ring():
                    return TF.ring_flash_attention_local(
                        mesh, qs, ks, vs, masks, metric="euclidean",
                        bf16=bf16)

                def plain(b16):
                    return torch.cat([TF.ring_flash_attention_local_plain(
                        qs[r], ks, vs, masks[r], r, "euclidean", ones, b16)
                        for r in range(g)], 1)
                got, want = torch.cat(ring(), 1), plain(bf16)
                if bf16:
                    # the fp32 distance is recorded, not gated: a sample,
                    # not a gate of B9's model inputs (8c)
                    gates = bf16_gates(f"[8d] degree {deg}", got, want,
                                       plain(False), witness=False)
                    err = gates[0]
                else:
                    err = (got - want).abs().max().item()
                    if not err <= TOL:
                        raise AssertionError(f"[8d] degree {deg}: vs plain "
                                             f"{err} > {TOL}")
                qf, kf, vf = (t[None].to(torch.bfloat16 if bf16 else
                                         t.dtype) for t in (q, k, v))

                def library():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qf, kf, vf, attn_mask=bmask)
                ms = [cuda_ms(ring, 5) for _ in range(2)]
                lib = cuda_ms(library, 5)
                tag = f"degree {deg}" + (" bf16" if bf16 else "")
                res[tag] = dict(valid_pairs=pairs, max_abs_err=err, ms=ms,
                                library_ms=lib)
                if bf16:
                    res[tag]["bf16_gates"] = gates[1:]
                log(f"[8d] B9{' bf16' if bf16 else ''} over {g} virtual "
                    f"ranks, {pairs} valid pairs ({pairs / N:.1f} a row): "
                    f"vs plain {err:.3e}; ring ms "
                    f"{' '.join(f'{x:.4f}' for x in ms)}, SDPA "
                    f"({'bf16' if bf16 else 'fp32'} q, k, v, bool mask) "
                    f"{lib:.4f} ms")
            del mask, bmask, masks
    return res


def kernel_record(FG, kern, source, replaces, launches, err, ms, plain_ms,
                  plain_of, b, library_ms, src=FG_SRC):
    """One kernel's entry of the ``{"kernels": [...]}`` line; ``plain_of``
    says which plain function ``plain_ms`` timed, ``src`` which file
    holds the TPU kernel's call site ``replaces``."""
    return {"name": kern.name, "route": "cuda",
            "source": f"tagan_torch/csrc/{source}",
            "replaces": f"{src}:{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_of": plain_of,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": library_ms}


def pairwalk_fields(one, fold):
    """The pair walks' extra fields: ms a snapshot at the scaled-dot
    metric (one snapshot, and the path's fold), the library call's ms at
    one snapshot over the fold's scaled-dot ms (the like-for-like factor),
    and the share of the bound reached at the fold's model metric."""
    return dict(sdp_ms=one["sdp_ms"], fold_snapshots=fold["G"],
                fold_ms=fold["ms"], fold_sdp_ms=fold["sdp_ms"],
                fold_library_ms=fold.get("library_ms"),
                library_factor=(None if one["library_ms"] is None else
                                one["library_ms"] / fold["sdp_ms"]),
                bound_share=one["bound_ms"] / fold["ms"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tagan_torch as tt
    from tagan_torch.ops import build
    from tagan_torch.ops import flash_geometric as FG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] card: {card}")
    phase_build(build, FG)

    small_err = phase_small(FG)
    small_bwd = phase_small_bwd(FG)
    small_biased = phase_small_biased(FG)
    small_biased_bwd = phase_small_biased_bwd(FG)
    small_compact = phase_small_compact(FG)
    small_compact_bwd = phase_small_compact_bwd(FG)
    small_compact_biased_bwd = phase_small_compact_biased_bwd(FG)
    small_bf16 = phase_small_bf16(FG)
    small_biased_bf16 = phase_small_biased_bf16(FG)
    small_compact_bf16 = phase_small_compact_bf16(FG)
    small_compact_biased_bf16 = phase_small_compact_biased_bf16(FG)
    serve = phase_serve(tt, FG)
    serve_bf16 = phase_serve(tt, FG, bf16=True)
    serve_edge = phase_serve_edge(tt, FG)
    serve_edge_bf16 = phase_serve_edge(tt, FG, bf16=True)
    serve_hyb = phase_serve_hybrid(tt, FG, edge=False)
    serve_hyb_bf16 = phase_serve_hybrid(tt, FG, edge=False, bf16=True,
                                        reqs=serve_hyb.pop("reqs"))
    del serve_hyb_bf16["reqs"], serve_hyb_bf16["args"]
    serve_hyb_edge = phase_serve_hybrid(tt, FG, edge=True)
    serve_hyb_edge_bf16 = phase_serve_hybrid(
        tt, FG, edge=True, bf16=True, reqs=serve_hyb_edge.pop("reqs"))
    del serve_hyb_edge_bf16["reqs"], serve_hyb_edge_bf16["args"]
    mid = phase_mid(tt, FG)
    mid_edge = phase_mid_edge(tt, FG)
    serve_rcm = phase_serve_rcm(tt, FG, serve)
    serve_hyb_rcm = phase_serve_hybrid_rcm(tt, FG, serve_hyb)
    mid_hyb = phase_mid_hybrid(tt, FG)
    hyb_csr = phase_hybrid_vs_csr(tt, FG)
    hyb_train_csr = phase_hybrid_train_vs_csr(tt, FG)
    hyb_edge_train_csr = phase_hybrid_edge_train_vs_csr(tt, FG)
    mid_attention = phase_mid_attention(tt, FG)
    ring_args = serve["args"]
    times = phase_times(FG, serve.pop("args"))
    times_bf16 = phase_times_bf16(FG, serve_bf16.pop("args"))
    edge_args = serve_edge.pop("args")
    times_biased = phase_times_biased(FG, edge_args, serve_edge.pop("graph"))
    times_biased_bwd = phase_times_biased_bwd(FG, edge_args)
    del edge_args
    serve_edge_bf16.pop("graph")
    times_biased_bf16 = phase_times_biased_bf16(FG,
                                                serve_edge_bf16.pop("args"))
    times_hyb = phase_times_hybrid(FG, serve_hyb.pop("args"),
                                   serve_hyb_edge.pop("args"))
    train = phase_train(tt, FG)
    train_bf16 = phase_train(tt, FG, bf16=True)
    train_edge = phase_train_edge(tt, FG)
    train_edge_bf16 = phase_train_edge(tt, FG, bf16=True)
    train_mid = phase_train_mid(tt, FG)
    train_mid_bf16 = phase_train_mid_bf16(tt, FG)
    train_mid_edge = phase_train_mid_edge(tt, FG)
    train_mid_edge_bf16 = phase_train_mid_bf16(tt, FG, edge=True)
    train_hyb = phase_train_hybrid(tt, FG)
    times_hyb_bwd = phase_times_hybrid_bwd(FG, train_hyb.pop("args"))
    train_hyb_bf16 = phase_train_hybrid(tt, FG, bf16=True,
                                        data=train_hyb.pop("data"))
    del train_hyb_bf16["data"]
    times_hyb_bf16 = phase_times_hybrid_bf16(FG, train_hyb_bf16.pop("args"))
    train_mid_hyb = phase_train_mid_hybrid(tt, FG)
    train_mid_hyb_bf16 = phase_train_mid_bf16(tt, FG, hybrid=True)
    train_hyb_edge = phase_train_hybrid_edge(tt, FG)
    times_hyb_edge_bwd = phase_times_hybrid_edge_bwd(
        FG, train_hyb_edge.pop("args"))
    train_hyb_edge_bf16 = phase_train_hybrid_edge(
        tt, FG, bf16=True, data=train_hyb_edge.pop("data"))
    del train_hyb_edge_bf16["data"]
    times_hyb_edge_bf16 = phase_times_hybrid_edge_bf16(
        FG, train_hyb_edge_bf16.pop("args"))
    train_mid_hyb_edge = phase_train_mid_hybrid_edge(tt, FG)
    train_mid_hyb_edge_bf16 = phase_train_mid_bf16(tt, FG, edge=True,
                                                    hybrid=True)
    train_losses = phase_train_losses(tt, FG)
    ring = phase_ring(FG, ring_args)
    del ring_args

    bwd = times["bwd"]
    plain_bwd = min(bwd["plain_ms"])
    launches = {**train["launches"][False], **{
        k: v for k, v in train["launches"][True].items() if v}}
    # the plain backward forms dq, dk and dv in one pass over row chunks:
    # it is the plain version of each backward kernel, and its time is
    # that of the whole backward, not of B3a's or B3b's share
    plain_of = "flash_geometric_backward_plain (dq, dk and dv)"
    # the pair walks B1 and B2: the one-snapshot times of 5 beside sdpa
    # fp32, and the folds of 3 and 6 (timed there); B4 and B5: the
    # one-snapshot times of 5b beside flex fp32, and 3b's fold
    kernels = [
        dict(kernel_record(FG, FG.flash_geometric_fwd_kernel,
                           "flash_pairwalk_fwd.cu", 259, serve["launches"],
                           max(small_err, serve["full_err"]),
                           min(times["kernel_ms"]), min(times["plain_ms"]),
                           "flash_geometric_forward_plain", times,
                           times["library_ms"]),
             library_of="scaled_dot_product_attention on fp32 q, k, v with "
                        "the boolean mask",
             **pairwalk_fields(dict(times, sdp_ms=times["kernel_sdp_ms"]),
                               serve["fold"])),
    ] + [
        dict(kernel_record(FG, kern, source, line, launches[kern.name],
                           max(small_bwd[name], train["full_err"][name]),
                           min(bwd[name]["ms"]), plain_bwd, plain_of,
                           bwd[name], bwd["library_ms"]),
             library_of="scaled_dot_product_attention on fp32 q, k, v with "
                        "the boolean mask, forward+backward - forward",
             **(pairwalk_fields(dict(bwd[name], library_ms=bwd["library_ms"]),
                                train["fold_b2"]) if name == "B2" else {}))
        for name, kern, source, line in (
            ("B2", FG.flash_geometric_bwd_fused_kernel,
             "flash_pairwalk_bwd.cu", 1590),
            ("B3a", FG.flash_geometric_bwd_dq_kernel,
             "flash_pairwalk_two_walk.cu", 1455),
            ("B3b", FG.flash_geometric_bwd_dkv_kernel,
             "flash_pairwalk_two_walk.cu", 1534))] + [
        dict(kernel_record(
            FG, kern, "flash_pairwalk_fwd.cu", line,
            serve_edge["launches"][kern.name],
            max(small_biased, serve_edge["full_err"], serve_edge["fold_err"],
                max(times_biased["plain_err"].values())),
            min(times_biased[name]["ms"]), min(times_biased[name]["plain_ms"]),
            plain_of, times_biased[name], times_biased[name]["library_ms"]),
             csr_ms=min(times_biased["csr_ms"]),
             library_of="compiled flex_attention on fp32 q, k, v, block mask "
                        "from the int8 mask, scaled-dot metric, "
                        + ("lse only" if name == "B4" else
                           "exp(s - lse1) + bias"),
             **pairwalk_fields(times_biased[name], serve_edge["fold"][name]))
        for name, kern, line, plain_of in (
            ("B4", FG.flash_lse1_kernel, 885, "flash_lse1_plain"),
            ("B5", FG.flash_biased_fwd_kernel, 944,
             "flash_biased_forward_plain"))]
    # the fp32 biased backward's row walk (B6 and B7a) and key walk (B7b):
    # launches on the edge-feature training path (6b), times at one 10K
    # snapshot of 3b's request (5c) and over 6b's fold; the plain biased
    # backward, like the plain backward above, forms every output in one
    # pass: its time is the whole backward's
    tb, fw32 = times_biased_bwd, train_edge["fold_walks"]
    kernels += [
        dict(kernel_record(
            FG, kern, "flash_pairwalk_biased_bwd.cu", line,
            train_edge["launches"][kern.name],
            max(small_biased_bwd[name], train_edge["full_err"][name]),
            min(tb[name]["ms"]), min(tb["plain_ms"]),
            "flash_biased_backward_plain (dq, dk, dv and dB)", tb[name],
            tb["library"]["ms"]),
             also_replaces=also, library_of=tb["library"].get("form"),
             library_grad_err=tb["library"].get("grad_err"),
             both_walks_ms=min(tb["both"]["ms"]),
             both_walks_bound_ms=tb["both"]["bound_ms"],
             both_walks_sdp_ms=tb["both"]["sdp_ms"],
             fold_snapshots=fw32["G"], fold_ms=fw32[fold_key],
             fold_both_ms=fw32["ms"], fold_both_sdp_ms=fw32["sdp_ms"],
             fold_bf16_ms=fw32["bf16_ms"],
             library_factor=(None if tb["library"]["ms"] is None
                             else tb["library"]["ms"] / fw32["sdp_ms"]),
             bound_share=tb[name]["bound_ms"] / fw32[fold_key])
        for name, kern, line, also, fold_key in (
            ("B6+B7a", FG.flash_biased_bwd_row_kernel, 1038,
             f"{FG_SRC}:1102", "row_ms"),
            ("B7b", FG.flash_biased_bwd_key_kernel, 1176, None, "key_ms"))]
    # the compact forms: launches on the hybrid serving paths (3c, 3d),
    # times at one 131K snapshot (5d), the library's compact walk or null
    th, lib = times_hyb, times_hyb["library"]
    kernels += [
        dict(kernel_record(
            FG, kern, source, line, serving["launches"][kern.name],
            max(small_compact[name], serving["full_err"]),
            min(th[name]["ms"]), min(th[name]["plain_ms"]), plain_of,
            th[name], th[name]["library_ms"], src),
             csr_ms=min(th["csr_biased_ms" if name != "B1c" else "csr_ms"]),
             bound_share=th[name]["bound_share"],
             library_of=("compiled flex_attention, BlockMask from the compact "
                         "plan, bit-store mask_mod, scaled-dot metric"
                         if lib["error"] is None else lib["error"]))
        for name, kern, source, src, line, serving, plain_of in (
            ("B1c", FG.flash_geometric_fwd_compact_kernel,
             "flash_pairwalk_fwd_compact.cu", FG_SRC, 1369, serve_hyb,
             "flash_geometric_forward_compact_plain"),
            ("B4c", FG.flash_lse1_compact_kernel,
             "flash_pairwalk_fwd_compact.cu", HB_SRC, 197, serve_hyb_edge,
             "flash_lse1_compact_plain"),
            ("B5c", FG.flash_biased_fwd_compact_kernel,
             "flash_pairwalk_fwd_compact.cu", HB_SRC, 236, serve_hyb_edge,
             "flash_biased_forward_compact_plain"))]
    # the compact backward: launches on the hybrid training path (6c),
    # times at one 131K snapshot (5e); the plain version forms dq, dk and
    # dv in one walk, so its time is the whole backward's
    tbh = times_hyb_bwd
    kernels += [
        dict(kernel_record(
            FG, kern, source, line,
            train_hyb["launches"][kern.name],
            max(small_compact_bwd[name], train_hyb["full_err"][name]),
            min(tbh[name]["ms"]), min(tbh["plain_ms"]),
            "flash_geometric_backward_compact_plain (dq, dk and dv)",
            tbh[name], tbh["library"]["ms"]),
             csr_ms=min(tbh["csr_ms"]),
             bound_share=tbh[name]["bound_share"],
             fold_ms=train_hyb[f"fold_{name.lower().replace(' ', '_')}_ms"],
             library_of=("compiled flex_attention fwd+bwd - fwd, BlockMask "
                         "from the compact plan, bit-store mask_mod, "
                         "scaled-dot metric"
                         if tbh["library"]["error"] is None
                         else tbh["library"]["error"]))
        for name, kern, source, line in (
            ("B3a c", FG.flash_geometric_bwd_dq_compact_kernel,
             "flash_pairwalk_bwd_compact.cu", 2009),
            ("B3b c", FG.flash_geometric_bwd_dkv_compact_kernel,
             "flash_pairwalk_bwd_compact.cu", 2074))]
    # the compact biased backward's fp32 walks, the row walk (B6c and B7a
    # c) and the key walk (B7b c): launches on the edge-feature hybrid
    # training path (6d), times at one 131K snapshot (5f) beside the two
    # together; the plain version is the three compact plain parts, so its
    # time is the whole backward's
    tbe = times_hyb_edge_bwd
    kernels += [
        dict(kernel_record(
            FG, kern, "flash_pairwalk_biased_bwd_compact.cu", line,
            train_hyb_edge["launches"][kern.name],
            max(small_compact_biased_bwd[name],
                train_hyb_edge["full_err"][name]),
            min(tbe[name]["ms"]), min(tbe["plain_ms"]),
            "flash_biased_bwd_{pre,dq,dkv}_compact_plain (delta1, dB, dq, "
            "dk and dv)", tbe[name], tbe["library"]["ms"], HB_SRC),
             also_replaces=also, csr_ms=min(tbe["csr_ms"]),
             both_walks_ms=min(tbe["both"]["ms"]),
             both_walks_bound_ms=tbe["both"]["bound_ms"],
             both_walks_sdp_ms=tbe["both"]["sdp_ms"],
             bound_share=tbe[name]["bound_ms"] / min(tbe[name]["ms"]),
             tile_occupancy=tbe["occupancy"]["histogram"],
             library_of=("compiled flex_attention fwd+bwd - fwd of B4c and "
                         "B5c's function, BlockMask from the compact plan, "
                         "scaled-dot metric"
                         if tbe["library"]["error"] is None
                         else tbe["library"]["error"]))
        for name, kern, line, also in (
            ("B6c+B7a c", FG.flash_biased_bwd_row_compact_kernel, 298,
             f"{HB_SRC}:371"),
            ("B7b c", FG.flash_biased_bwd_key_compact_kernel, 405, None))]
    # the bf16 forms: launches on the bf16 serving (3e) and training (6e)
    # paths, times at one 10K snapshot of the bf16 request (5g), each
    # beside its fp32 form's in the same run
    t16 = times_bf16
    launches16 = {**train_bf16["launches"][False], **{
        k: v for k, v in train_bf16["launches"][True].items() if v}}
    kernels += [
        dict(kernel_record(
            FG, kern, source, line,
            serve_bf16["launches"] if name == "B1" else launches16[kern.name],
            max(small_bf16[name], serve_bf16["full_err"] if name == "B1"
                else train_bf16["full_err"][name]),
            min(t16[name]["ms"]), t16[name]["plain_ms"],
            ("flash_geometric_forward_plain" if name == "B1" else
             "flash_geometric_backward_plain (dq, dk and dv)")
            + " with bf16=True", t16[name], t16[name]["library_ms"]),
             fp32_ms=min(t16[name]["fp32_ms"]),
             library_of="scaled_dot_product_attention on bf16 q, k, v with "
                        "the boolean mask" + ("" if name == "B1" else
                                              ", forward+backward - forward"),
             **(pairwalk_fields(t16["B1"], serve_bf16["fold"])
                if name == "B1" else
                dict(pairwalk_fields(t16["B2"], train_bf16["fold_b2"]),
                     library_err=t16["B2_sdp"]["library_err"])
                if name == "B2" else {}))
        for name, kern, source, line in zip(
            ("B1", "B2", "B3a", "B3b"), flash_kernels(FG, True),
            ("flash_pairwalk_fwd.cu", "flash_pairwalk_bwd.cu",
             "flash_pairwalk_two_walk.cu", "flash_pairwalk_two_walk.cu"),
            (259, 1590, 1455, 1534))]
    # the bf16 forms of B4 and B5: launches on the bf16 edge-feature
    # serving path (3f), times at one 10K snapshot of 3f's request (5h),
    # each beside its fp32 form's in the same run
    t16e = times_biased_bf16
    lib16 = t16e["library"]
    kernels += [
        dict(kernel_record(
            FG, kern, "flash_pairwalk_fwd.cu", line,
            serve_edge_bf16["launches"][kern.name],
            max(small_biased_bf16[name], serve_edge_bf16["full_err"]),
            min(t16e[name]["ms"]), t16e[name]["plain_ms"], plain_of,
            t16e[name], t16e[name]["library_ms"]),
             fp32_ms=min(t16e[name]["fp32_ms"]),
             library_of=(
                 "compiled flex_attention on bf16 q, k, v, block mask from "
                 "the int8 mask, scaled-dot metric"
                 if lib16["error"] is None else lib16["error"]),
             **pairwalk_fields(dict(t16e[name], sdp_ms=t16e[
                 f"b{name[1]}_sdp_ms"]), serve_edge_bf16["fold"][name]))
        for name, kern, line, plain_of in zip(
            ("B4", "B5"), biased_kernels(FG, True)[:2], (885, 944),
            ("flash_lse1_plain with bf16=True",
             "flash_biased_forward_plain with bf16=True (walks the plan)"))]
    # the bf16 biased backward's row walk (B6 and B7a bf16) and key walk
    # (B7b bf16): launches on the bf16 edge-feature training path (6f),
    # times at one 10K snapshot of 3f's request (5h) beside the fp32
    # walks in the same run, and over 6f's fold
    fw = train_edge_bf16["fold_walks"]
    lbwd = t16e["library_bwd"]
    kernels += [
        dict(kernel_record(
            FG, kern, "flash_pairwalk_biased_bwd.cu", line,
            train_edge_bf16["launches"][kern.name],
            max(small_biased_bf16[name], train_edge_bf16["full_err"][name]),
            min(t16e[name]["ms"]), t16e[name]["plain_ms"],
            "flash_biased_backward_plain with bf16=True (dq, dk, dv and dB)",
            t16e[name], t16e[name]["library_ms"]),
             also_replaces=also, fp32_ms=min(t16e[name]["fp32_ms"]),
             fp32_of=fp32_of,
             library_of=lbwd.get("form", lbwd.get("error")),
             library_grad_err=lbwd.get("grad_err"),
             both_walks_ms=min(t16e["both"]["ms"]),
             both_walks_fp32_ms=min(t16e["both"]["fp32_ms"]),
             both_walks_bound_ms=t16e["both"]["bound_ms"],
             both_walks_sdp_ms=t16e["walks_sdp_ms"],
             fold_snapshots=fw["G"], fold_ms=fw[fold_key],
             fold_both_ms=fw["ms"], fold_both_sdp_ms=fw["sdp_ms"],
             fold_fp32_ms=fw["fp32_ms"],
             library_factor=(None if lbwd["ms"] is None
                             else lbwd["ms"] / fw["sdp_ms"]),
             bound_share=t16e[name]["bound_ms"] / fw[fold_key])
        for name, kern, line, also, fp32_of, fold_key in (
            ("B6+B7a", FG.flash_biased_bwd_row_bf16_kernel, 1038,
             f"{FG_SRC}:1102", "the fp32 row walk", "row_ms"),
            ("B7b", FG.flash_biased_bwd_key_bf16_kernel, 1176, None,
             "the fp32 key walk", "key_ms"))]
    # the bf16 forms of B1c, B3a c and B3b c: launches on the hybrid bf16
    # serving (3g) and training (6g) paths, times at one 131K snapshot of
    # 6g (5i), each beside its fp32 form's in the same run
    t16h = times_hyb_bf16
    lib16h = t16h["library"]
    kernels += [
        dict(kernel_record(
            FG, kern, source, line,
            (serve_hyb_bf16 if name == "B1c" else
             train_hyb_bf16)["launches"][kern.name],
            max(small_compact_bf16[name], serve_hyb_bf16["full_err"],
                small_compact_biased_bf16["B1c"]) if name == "B1c" else
            max(small_compact_bf16[name], train_hyb_bf16["full_err"][name]),
            min(t16h[name]["ms"]), t16h[name]["plain_ms"], plain_of,
            t16h[name], t16h[name]["library_ms"]),
             fp32_ms=min(t16h[name]["fp32_ms"]),
             bound_share=t16h[name]["bound_share"],
             library_of=(
                 ("compiled flex_attention on bf16 q, k, v, BlockMask from "
                  "the compact plan, bit-store mask_mod, scaled-dot metric"
                  + ("" if name == "B1c" else ", forward+backward - forward"))
                 if lib16h["error"] is None else lib16h["error"]))
        for name, kern, source, line, plain_of in zip(
            ("B1c", "B3a c", "B3b c"), compact_kernels(FG, True),
            ("flash_pairwalk_fwd_compact.cu",)
            + ("flash_pairwalk_bwd_compact.cu",) * 2,
            (1369, 2009, 2074),
            ("flash_geometric_forward_compact_plain with bf16=True (walks "
             "the plan)",) + ("flash_geometric_backward_compact_plain with "
                              "bf16=True (dq, dk and dv)",) * 2)]
    # the bf16 forms of B4c and B5c: launches on the edge-feature hybrid
    # bf16 serving path (3h), times at one 131K snapshot of 6h (5j), each
    # beside its fp32 form's in the same run
    t16he = times_hyb_edge_bf16
    lib16he = t16he["library"]
    kernels += [
        dict(kernel_record(
            FG, kern, source, line,
            serve_hyb_edge_bf16["launches"][kern.name],
            max(small_compact_biased_bf16[name],
                serve_hyb_edge_bf16["full_err"]),
            min(t16he[name]["ms"]), t16he[name]["plain_ms"], plain_of,
            t16he[name], t16he[name]["library_ms"], HB_SRC),
             fp32_ms=min(t16he[name]["fp32_ms"]),
             bound_share=t16he[name]["bound_share"],
             library_of=(
                 "compiled flex_attention on bf16 q, k, v, BlockMask from "
                 "the compact plan, scaled-dot metric, "
                 + ("lse only" if name == "B4c" else
                    "exp(s - lse1) + bias store")
                 if lib16he["error"] is None else lib16he["error"]))
        for name, kern, source, line, plain_of in zip(
            ("B4c", "B5c"), compact_biased_kernels(FG, True)[:2],
            ("flash_pairwalk_fwd_compact.cu",) * 2,
            (197, 236),
            ("flash_lse1_compact_plain with bf16=True",
             "flash_biased_forward_compact_plain with bf16=True (walks the "
             "plan)"))]
    # the bf16 compact row walk (B6c and B7a c bf16) and key walk (B7b c
    # bf16): launches on the edge-feature hybrid bf16 training path (6h),
    # times at one 131K snapshot of 6h (5j) beside the fp32 walks in the
    # same run
    lb16he = t16he["library_bwd"]
    kernels += [
        dict(kernel_record(
            FG, kern, "flash_pairwalk_biased_bwd_compact.cu", line,
            train_hyb_edge_bf16["launches"][kern.name],
            max(small_compact_biased_bf16[name],
                train_hyb_edge_bf16["full_err"][name]),
            min(t16he[name]["ms"]), t16he[name]["plain_ms"],
            "flash_biased_bwd_{pre,dq,dkv}_compact_plain with bf16=True "
            "(delta1, dB, dq, dk and dv)", t16he[name],
            t16he[name]["library_ms"], HB_SRC),
             also_replaces=also, fp32_ms=min(t16he[name]["fp32_ms"]),
             fp32_of=fp32_of, bound_share=t16he[name]["bound_share"],
             both_walks_sdp_ms=t16he["walks_sdp_ms"],
             library_of=("compiled flex_attention on bf16 q, k, v, "
                         "BlockMask from the compact plan, scaled-dot "
                         "metric, fwd+bwd - fwd of B4c and B5c's calls"
                         if lb16he["error"] is None else lb16he["error"]),
             library_grad_err=lb16he.get("grad_err"))
        for name, kern, line, also, fp32_of in (
            ("B6c+B7a c", FG.flash_biased_bwd_row_compact_bf16_kernel, 298,
             f"{HB_SRC}:371", "the fp32 compact row walk"),
            ("B7b c", FG.flash_biased_bwd_key_compact_bf16_kernel, 405, None,
             "the fp32 compact key walk"))]
    # the ring (phase 8): launches over phase 8's main path (B8's count
    # includes the chunk moves of B9's rings), times and bounds at
    # g = RING_G_RECORD virtual ranks (every g in chip_smoke.json), B8 at
    # [131072, 64] fp32, B9 per 10K snapshot
    TG, TF = ring_modules()[2:]
    rgat, rfl = ring["gather"], ring["flash"]
    r8 = rgat[f"[131072, 64] fp32 g={RING_G_RECORD}"]
    r9, r9b = rfl[f"g={RING_G_RECORD}"], rfl[f"g={RING_G_RECORD} bf16"]
    rcopy = ring["copy"]
    kernels += [
        dict(kernel_record(
            FG, TG.ring_gather_kernel, "ring_gather.cu", 92,
            ring["launches"][TG.ring_gather_kernel.name],
            max(r["max_abs_err"] for r in rgat.values()), min(r8["ms"]),
            min(r8["plain_ms"]), "ring_all_gather_plain (each rank's "
            "rank-order concatenation)", r8, r8["library_ms"], RG_SRC),
             library_of="torch.cat of the shards, once per rank",
             host_issue_ms=r8["host_issue_ms"],
             idle_issue_ms=r8["idle_issue_ms"], device_ms=r8["device_ms"],
             library_device_ms=r8["library_device_ms"],
             ptxas=[p for p in PTXAS.get("ring_gather", [])
                    if "ring_gather_kernel" in p],
             shape=f"[131072, 64] fp32 over {RING_G_RECORD} virtual ranks"),
        dict(kernel_record(
            FG, TG.ring_copy_kernel, "ring_gather.cu", 72,
            ring["launches"][TG.ring_copy_kernel.name], rcopy["max_abs_err"],
            min(rcopy["ms"]), min(rcopy["plain_ms"]), "Tensor.copy_", rcopy,
            rcopy["library_ms"], RF_SRC),
             library_of="Tensor.copy_",
             ptxas=[p for p in PTXAS.get("ring_gather", [])
                    if "copy_kernel" in p],
             shape=f"one K chunk {rcopy['shape']} fp32 of B9 at "
                   f"{RING_G_RECORD} virtual ranks"),
        dict(kernel_record(
            FG, TF.ring_flash_fold_kernel, "ring_flash.cu", 177,
            ring["launches"][TF.ring_flash_fold_kernel.name],
            max(r["max_abs_err"] for n, r in rfl.items() if "bf16" not in n),
            min(r9["ms"]), min(r9["plain_ms"]),
            "ring_flash_attention_local_plain, every rank", r9,
            r9["library_ms"], RF_SRC),
             library_of="scaled_dot_product_attention on the full q, k, v "
                        "with the boolean mask, scaled-dot",
             library_error=r9.get("library_error"),
             fold_ms=min(r9["fold_ms"]), host_issue_ms=r9["host_issue_ms"],
             idle_issue_ms=r9["idle_issue_ms"],
             ptxas=PTXAS.get("ring_flash"),
             shape=f"one 10K snapshot over {RING_G_RECORD} virtual ranks"),
        dict(kernel_record(
            FG, TF.ring_flash_fold_bf16_kernel, "ring_flash.cu", 177,
            ring["launches"][TF.ring_flash_fold_bf16_kernel.name],
            r9b["max_abs_err"], min(r9b["ms"]), min(r9b["plain_ms"]),
            "ring_flash_attention_local_plain with bf16=True, every rank",
            r9b, r9b["library_ms"], RF_SRC),
             fp32_ms=min(r9b["fp32_ms"]),
             library_of="scaled_dot_product_attention on the full q, k, v "
                        "cast to bf16 with the boolean mask, scaled-dot",
             library_error=r9b.get("library_error"),
             fold_ms=min(r9b["fold_ms"]), host_issue_ms=r9b["host_issue_ms"],
             idle_issue_ms=r9b["idle_issue_ms"],
             ptxas=PTXAS.get("ring_flash"),
             shape=f"one 10K snapshot over {RING_G_RECORD} virtual ranks")]
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        ring=ring, serve_rcm=serve_rcm, serve_hybrid_rcm=serve_hyb_rcm,
        mid_attention=mid_attention, train_losses=train_losses,
        small_compact_biased_bf16_err=small_compact_biased_bf16,
        serve_hybrid_edge_bf16=serve_hyb_edge_bf16,
        train_hybrid_edge_bf16=train_hyb_edge_bf16,
        times_hybrid_edge_bf16=times_hyb_edge_bf16,
        train_mid_hybrid_edge_bf16=train_mid_hyb_edge_bf16,
        small_compact_bf16_err=small_compact_bf16,
        serve_hybrid_bf16=serve_hyb_bf16, train_hybrid_bf16=train_hyb_bf16,
        times_hybrid_bf16=times_hyb_bf16,
        train_mid_hybrid_bf16=train_mid_hyb_bf16,
        small_biased_bf16_err=small_biased_bf16,
        serve_edge_bf16=serve_edge_bf16, times_biased_bf16=times_biased_bf16,
        train_edge_bf16=train_edge_bf16,
        train_mid_edge_bf16=train_mid_edge_bf16,
        small_bf16_err=small_bf16, serve_bf16=serve_bf16,
        times_bf16=times_bf16, train_bf16=train_bf16,
        train_mid_bf16=train_mid_bf16,
        card=card, small_err=small_err, small_bwd_err=small_bwd,
        small_biased_err=small_biased, small_biased_bwd_err=small_biased_bwd,
        small_compact_err=small_compact,
        small_compact_bwd_err=small_compact_bwd,
        small_compact_biased_bwd_err=small_compact_biased_bwd,
        hybrid_edge_train_vs_csr=hyb_edge_train_csr,
        train_hybrid_edge=train_hyb_edge,
        times_hybrid_edge_bwd=times_hyb_edge_bwd,
        train_mid_hybrid_edge=train_mid_hyb_edge,
        hybrid_train_vs_csr=hyb_train_csr, train_hybrid=train_hyb,
        times_hybrid_bwd=times_hyb_bwd, train_mid_hybrid=train_mid_hyb,
        mid=mid, mid_edge=mid_edge, serve=serve, serve_edge=serve_edge,
        serve_hybrid=serve_hyb, serve_hybrid_edge=serve_hyb_edge,
        mid_hybrid=mid_hyb, hybrid_vs_csr=hyb_csr, times_hybrid=times_hyb,
        times=times, times_biased=times_biased,
        times_biased_bwd=times_biased_bwd, train=train, train_edge=train_edge,
        train_mid=train_mid, train_mid_edge=train_mid_edge,
        kernels=kernels), indent=1, default=str))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
