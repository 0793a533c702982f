#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. Device: the card's name, count, and ``nvidia-smi`` name and power
   limit.  TF32 is set off for matmuls and cuDNN: every f32 route here
   is held to full-f32 results.
2. Build: ``nvcc`` compiles every kernel of ``pytorch_sparse_tpu_torch/
   csrc`` for ``sm_90a``, and the host C++ compiler the host libraries
   (``csrc/host_partition.cpp``, the partitioner;
   ``csrc/host_sample.cpp``, every host sampler: ``sample_adj``,
   ``neighbor_sample``, ``saint_subgraph``, ``relabel_one_hop`` and the
   typed, temporal, HGT and ego samplers; ``csrc/host_spgemm.cpp``, the
   Gustavson SpGEMM), one process per source, all in parallel.
3. Kernels against their plain PyTorch versions on the card:
   ``csr_spmm`` on the ogbn-arxiv-scale uniform graph (M=169,343,
   E=1,166,243) at K=128, 256, 40, 8 and 1, with values and implicit
   ones, on a matrix with empty rows, and on the community hybrid graph
   at K=128 (each case names the instance of the CSR walk that ran);
   ``block_spmm`` and ``block_spmm_t`` on
   the community hybrid graph with f32 and bf16 stores, and each with
   the f32 store at K=47, phase 15's last width, and with the last row
   block's slots (``block_spmm``) or column block's slots
   (``block_spmm_t``) taken away, a block with no slot; ``edge_dot`` on
   the uniform graph at K=128, 256, 40 and GAT's head width 8, on the
   empty-rows matrix, and at K=128 on the community hybrid and
   Reddit-10% graphs of phase 4b (each case names the instance of the
   per-edge walk that ran, and two launches must give the same bits).
   ``csr_spmm_minmax`` (min and max; ``out`` and ``arg`` must equal the
   plain version's exactly) on the uniform graph at K=128, 256 and 40
   with values and implicit ones, on the empty-rows matrix, on a
   tie-heavy integer operand, with a bf16 operand, and at K=128 on the
   community hybrid and Reddit-10% graphs; ``minmax_edge_dot`` and
   ``minmax_spmm_t`` on the max argout of each f32 case (each case names
   the instance of the walk that ran; two launches of
   ``csr_spmm_minmax`` and of ``minmax_edge_dot`` must give the same
   bits); ``edge_softmax`` at 8 heads and 1 on the uniform graph with
   self-loops and on the community hybrid graph, and at 1 head on
   logits 4 bytes off a 16-byte boundary (each case names the instance
   of the row sweep that ran; two launches must give the same bits);
   ``edge_softmax_bwd`` at 8 heads, 1 and 3 on the uniform graph with
   self-loops.
   ``block_spmm_dblocks`` on phase 9's block-aligned hybrid (both forms,
   f32 and bf16 stores, K=256 and 40; a bf16 store must equal the f32
   store's sums rounded once) and on a ragged case (B=100, K=70).
   ``plan_numeric`` on
   the plan of ``A_g @ A_g`` (phase 5's normalised uniform graph times
   itself) with f32 values, one side implicit ones and bf16 values, and
   in both backward orderings; ``block_spgemm_window`` on the dense-block
   x dense-block share (512x512 blocks of density 0.02, windows of 2048
   output blocks) of the community hybrid graph (f32 and bf16 stores; 8
   sampled output blocks also against float64 host products), of the
   Reddit-10% graph, and of phase 8c's community graph in 100x100 blocks
   with a bf16 store (rows of 200 bytes, padded once by the split).
   ``random_walk`` at PyG's Node2Vec configuration
   (``examples/node2vec.py``, p = q = 1: 10 walks of 20 steps from every
   node of the uniform graph, 1,693,430 walks, timed beside its byte
   bound and the count of its gathered sectors), at GraphSAINT's length
   (3 steps from 20,000 roots) on the same graph, on the uniform graph
   with every third row emptied and on a small graph with 200 rows of
   degree 0; the walks must equal the plain version's exactly, and two
   launches each other's.  ``shard_spmm``
   (K11a) and ``shard_spmm_minmax`` (K11b) on shard 0's groups of the
   community hybrid graph split over 4 ranks (tables built in this
   process), at K=128, 256 (the width of the GCN layers of phases
   14-15, which runs the walks' two-chunks-a-lane instance) and 40: the
   interior written, the halo frontier accumulated and ring group 1
   accumulated (K11a, 1e-5), the interior's
   max written, the frontier's max and ring group 1's min combined into
   a running pair (K11b: ``out`` and ``arg`` exactly; each case names
   the instance of the walk that ran).  On shard 0 of the
   same graph's hierarchical layout at (S, C) = (2, 2), at K=256 and 20
   (the columns a feature rank holds of a 40-wide operand on two feature
   ranks, the walks' 4-rows-a-warp instance): K11a accumulated over the
   intra-slice halo (C*Hi rows) and over the cross-slice union (C*S*Hx
   rows), K11b combined over the union.
   Each is timed with CUDA events beside its plain version, a PyTorch
   library yardstick that the port never calls (none computes an
   argout), and its bound on an H100
   SXM (3.35 TB/s; 67 TFLOP/s FP32 outside the tensor cores for f32
   inputs, 989 TFLOP/s dense bf16 tensor cores for a bf16 store times
   the split f32 operand).  The block products of f32 operands (K2, K5,
   K5b, K10) carry two bounds: ``bound_ms`` on the tensor cores (495
   TFLOP/s TF32, three products a product for f32 accuracy, as 3xTF32
   runs) and ``bound_fp32_ms`` on the FP32 units, each with the share of
   the kernel's time it makes.
4. The main path: routed ``spmm_sum`` through the public API, one leg per
   route, each held against a host CSR-walk oracle (head + tail + 512
   random rows): the uniform graph (CSR kernel), a Reddit-10%-density
   community graph (whole-matrix dense route, f32 store at store budget
   0 and bf16 store at 2e-3), and a Reddit-node-count community graph at
   a tenth of Reddit's edges (hybrid route: block kernel + CSR
   remainder).
4b. Backward legs: on the uniform (CSR), Reddit-10% (dense f32) and
   community hybrid (hybrid f32) graphs, ``spmm_sum(A.set_value(v), x)``
   with ``v`` and ``x`` requiring grad, backpropagated from a seeded
   ``gout``.  ``grad_x`` is held against a float64 host CSC walk (head +
   tail + 512 random columns), ``grad_v`` against a float64 host dot over
   4096 random edges.
4c. Min/max legs: ``spmm_max`` and ``spmm_min`` through the public API
   on the uniform graph and the community hybrid graph (K=128, f32,
   N(0,1) values), with both gradients from a seeded ``gout``.  ``out``
   and ``arg`` are held against a host row walk (head + tail + 512
   random rows; ``arg`` exactly), ``grad_x`` against a float64 host CSC
   walk through the argout and ``grad_v`` against a float64 host dot on
   4096 edges.
4d. Value writes: the community hybrid graph over its own copy of the
   values, written through ``.data`` (no version counter moves) and then
   in place; after each, the routed ``spmm_sum`` and its ``grad_x``
   against the host oracles on the new values, over the same structure
   (a new store written on the card, no host rebuild).  Timed: a routed
   call's check of the values with nothing written, and a write with its
   refresh, beside K2's time.
5. GCN inference at the width of OGB's ogbn-arxiv GCN (3 layers,
   128 -> 256 -> 256 -> 40) on the normalized uniform graph, held
   against the same weights run layer by layer through the plain CSR
   version.
6. GCN training, same model, graph and seed as phase 5, with seeded
   labels and ``torch.optim.Adam(lr=1e-2)``: one step at dropout 0 whose
   loss and every parameter gradient are held against the same step
   through torch autograd on the plain CSR version (with the kernel
   run's ReLU decisions; the entries where the plain run's own decisions
   differ are counted, and may be at most 1e-5 of the hidden entries),
   then three steps at
   dropout 0.5 from a seeded CUDA generator, whose loss must stay finite
   and fall.  The step needs no value gradient, so it must not launch
   ``edge_dot``.
7. GAT inference at the GAT paper's transductive architecture
   (Velickovic et al., ICLR 2018, section 3.3: 8 heads x 8 features,
   ELU, one output head) at ogbn-arxiv width, 128 -> 8x8 -> 40, on the
   uniform graph with self-loops, held against the same weights run
   through the plain edge-softmax and CSR versions.
8. SpSpMM and the Reddit pipeline.  8a: ``A_g @ A_g`` through the public
   ``@``, its structure equal to scipy's product of the 0/1 patterns and
   its values against scipy's float64 product; both value gradients from
   a seeded ``grad_C`` against float64 host dots on 4096 random entries;
   host structure seconds and device numeric ms reported apart.  8b: on
   the Reddit-10% graph, ``t()``, ``A + A.t()``,
   ``remove_diag().set_diag(ones)``, ``get_diag`` and ``spspmm_diag``
   against scipy.  8c: ``spspmm_stream_device`` of a Reddit-10%-node
   community graph at a tenth of the draws (1.5M nnz) with itself: the
   float64 total of the pieces against ``colsum . rowsum`` (1e-6), head
   + tail + 512 random rows against scipy's float64 product; then
   ``block_spgemm_window`` on 8c's own windows and ``plan_numeric`` on
   its own cross-term chunks against their plain versions (these cases
   join the kernels' entries; their launches are not counted).  8c runs
   at about 1/75 of Reddit's 115M nnz: the host structure pass of the
   cross terms bounds it.
9. GCN training on a block-aligned prebuilt hybrid: phase 6's model
   (``Adam(lr=1e-2)``, dropout 0) on ``build_hybrid_from_tensor`` of the
   community hybrid graph's structure after ``gcn_norm``, with
   ``B=512`` and the generator's own community boundaries as
   ``partptr``.  A first step with the block store frozen, then a second
   with
   ``h.blocks.requires_grad_()``, which must launch
   ``block_spmm_dblocks`` once per layer.  The logits, the first step's
   loss and every parameter gradient are held against the same step on
   the CSR route of the unaligned matrix (with this run's ReLU
   decisions), and 8 sampled slots of the blocks gradient against
   float64 host products of each layer's operand and output gradient.
10. GAT training: phase 7's model and graph, one ``Adam(lr=5e-3)`` step,
   its loss and every gradient held against the same step through torch
   autograd on the plain edge-softmax and CSR versions.
11. GraphSAGE and GIN training at ogbn-arxiv width (128 -> 256 -> 256 ->
   40) on the uniform graph (implicit ones), one ``Adam(lr=1e-2)`` step
   each, held against the plain CSR version with this run's ReLU
   decisions.
12. GraphSAINT-RW training on the ogbn-products-scale synthetic graph of
   the JAX package's ``benchmarks/products_pipeline.py`` (2,449,029
   nodes, 123,718,280 draws, 106,159,079 edges after coalescing), at
   OGB's products
   ``graph_saint.py`` setting: 20,000 roots from a seeded CUDA
   generator, ``random_walk`` of length 3 (K12), ``torch.unique``,
   ``saint_subgraph`` on the host, features gathered on the card, one
   GraphSAGE step (100 -> 256 -> 256 -> 47, ``Adam(lr=1e-3)``) a batch,
   three batches.  Every walk step must be an edge or a stay at a node
   of degree 0, each subgraph must equal scipy's ``A[idx][:, idx]``, and
   the first step's loss and gradients the plain CSR version's (with
   this run's ReLU decisions).
13. Neighbour-sampled GraphSAGE on the same graph and model at PyG's
   ``ogbn_products_sage.py`` setting (batch 1,024, fanouts 15, 10, 5):
   ``sample_adj`` per hop, innermost first, a bipartite forward in the
   form of ``examples/train_sage_minibatch.py`` (no padding); three
   batches in turn, then the same three through
   ``MinibatchPrefetcher(num_workers=2)``, which must be identical.
   Every sampled edge id must lie in its row, no row may hold a column
   twice, each row must hold ``min(deg, k)`` edges, ``n_id`` must start
   with the frontier, and the first step must match the plain CSR
   version.
14. The distributed schedules on four ranks sharing the card: four gloo
   processes (:func:`spawn_ranks`; gloo moves host tensors, so every
   collective is staged through the host, and the times are no scaling
   result) split the community hybrid graph into 4 row blocks of
   58,242.  Every schedule (all-gather, ring, halo) x every reduce at
   K=128 with the ``x`` and ``value`` gradients, and the halo's hybrid
   local format (sum, mean; ``x`` gradient).  That graph's dense
   frontier (58,242 x 4H a shard) is over the 1 GiB cap, so the hybrid
   with the dense frontier "always" runs on a smaller community graph
   (``FRONTIER_DENSE``) whose frontier must be built.  Each case is
   gathered to rank 0 and held against the CSR kernel
   and K6 on the whole matrix (sums 1e-5, ``arg`` exactly) and the
   float64 host gradient oracles of phase 4b.  Then one ``DistGCN`` Adam
   step (phase 5's widths, halo schedule, local format "auto") on
   phase 9's ``gcn_norm`` graph, its loss and every gradient against
   the single-card GCN step on the CSR route (with the DistGCN run's
   ReLU decisions); the parameters must be identical on every rank.  A
   failure on any rank fails the run.
15. The main path at full width on NCCL, world size 1: the products
   graph of phases 12-13 laid out by the port's own partition (phase
   19's, computed once, beside phase 14), ``gcn_norm``, and three
   ``DistGCN``
   steps at OGB's ogbn-products full-batch GCN
   (``examples/nodeproppred/products/gnn.py``: 100 -> 256 -> 256 -> 47,
   ``Adam(lr=0.01)``, no dropout) on the halo schedule with local format
   "auto", each timed with CUDA events.  The local format taken, the
   launches of K11a and K2 and the sharded matrix's host build are
   reported; the first step's loss and gradients must match the same
   step of the single-card GCN on the CSR route (timed too).  Then one
   step of the same model on a (1, 1) hierarchical grid of the same
   graph, also on NCCL, so that the sub-group collectives run on the
   card: its loss and gradients must equal the halo schedule's first
   step.
16. The hierarchical and 2-D layouts, in phase 14's four gloo processes
   (each holds the graph once): the community hybrid graph on a (2, 2)
   ``make_mesh_hier`` grid, every reduce on the group format with the
   ``x`` and ``value`` gradients and sum and mean on "auto" (the
   interior blocks) with the ``x`` gradient; both dense frontier tiers
   "always" on the ``FRONTIER_DENSE`` graph, which must build both; one
   ``DistGCN`` Adam step on the hierarchical layout of phase 9's
   ``gcn_norm`` graph against the single-card GCN step, parameters
   identical on every rank; then the same graph on a (2, 2)
   ``make_mesh2d`` grid at K=256 (128 columns a feature rank): every
   schedule x sum and max and the halo's hybrid sum, with the ``x``
   gradient.  Every case is gathered to rank 0 and held against K1/K6
   and the float64 oracles as in phase 14; the layout's wire report (the
   DCN deduplication factor) and staged bytes are reported.
17. The gather probe (``benchmarks.probe_vmem_gather.run``) on phase 3's
   uniform graph and the community hybrid graph: ``smem_gather`` (K13a)
   at T=2048 and 8, K=128, a column slab of the table a block, equal to
   ``index_select``, timed with it in alternating pairs; ``edge_scan_loop``
   (K13b) at R=1, 8 and 40 within 1e-5 of the looped ``torch.cumsum``,
   with device ms, and its time a pass (the R=8/R=40 slope) beside one
   pass's operations at the FP32 rate; ``tiled_spmm`` (K13c) on both
   graphs at K=128,
   tiles of 512, 256 and 128 rows, with values and implicit ones, and
   as a control with no tile staged, and on a small graph with every
   pair staged, each within 1e-5 of its plain version and equal to
   ``csr_spmm`` bit for bit.  Each is timed by the
   probe's ``device_time`` beside its bound and a library call
   (``index_select``, ``cumsum``, cuSPARSE), K13c beside ``csr_spmm``;
   K13a and K13c also by their device time in a ``torch.profiler`` trace
   (``device_ms``), beside the library's, and K13c beside the floor
   that shared memory's rate puts under its staged edges; the
   ``gather_probe`` line holds the verdict.
18. The structural op set through the public API.  On the products
   graph of phases 12-13 (the matrix already built): PyG's
   ``SparseTensor`` ``gcn_norm`` (``fill_value(1.)``, ``fill_diag(1.)``,
   ``sum(dim=1)``, ``pow(-0.5)``, ``mul`` by the degree as a column and
   as a row), whose degree must equal the CPU's ordered sum bit for bit
   and whose values and column sums (``sum(dim=0)``) must agree with
   float64 host oracles to 1e-5 of max |ref|; the subgraph ``adj[idx,
   idx]`` of the first 196,615 nodes (the size of OGB's ogbn-products
   train split) of a seeded permutation, and the same nodes through a
   boolean mask (``masked_select``), each equal to scipy's ``A[idx][:,
   idx]`` exactly; 8 row blocks by ``narrow`` and ``cat`` back, ``==`` the
   matrix.  On the uniform graph: ``to_symmetric`` and ``is_symmetric``,
   ``reverse_cuthill_mckee`` (its permutation equal to scipy's on the
   union pattern), 128 diagonal blocks by ``narrow``, ``cat_diag``, and
   each taken back out by ``__narrow_diag__`` and by ``narrow`` equal to
   its block; ``to_torch_sparse_csr_tensor()`` times the K=128 operand
   and the legacy tuple ``spmm`` against ``csr_spmm`` (1e-5); the row sums
   of ``(E, 8)`` values, equal to the CPU's bits and within 1e-5 of a
   float64 oracle.  Every output must lie on the card; each op's host
   seconds are reported (the ``structural_ops`` line).
19. Cluster-GCN on the products graph (the JAX package's
   ``benchmarks/products_pipeline.py:106-150`` and
   ``examples/train_cluster_gcn.py``).  First, in a host thread of its
   own while phase 14's processes run (it launches no kernel), the
   port's ``partition_fine(A_p, 8, fine_parts=Mp // 512,
   grouping="within")`` on one thread (the direct 8-way multilevel
   partition, each part's interior ordered by coarsening clusters), its
   walls (the partition, the reorder, the multilevel partitioner,
   ``coarsen_clusters`` and ``permute`` apart), the host's peak memory,
   the edge cut, the part sizes and the balance (the ``products_partition``
   line); its contract must hold: ``partptr`` from 0 to M and never
   falling, ``perm`` a permutation, the permuted matrix the original
   relabelled through ``perm``'s inverse, int64 outputs on the card.
   Then, after phase 18, per part in order: the diagonal block by
   ``narrow`` twice, ``gcn_norm``, the route the router takes at K=100,
   ``spmm_sum`` there and on K1 alone (within 1e-5 of max |ref|, both
   timed, uncounted), and one ``Adam(lr=0.01)`` step of phase 15's GCN
   (100 -> 256 -> 256 -> 47, no dropout) on the part's features and
   labels, unpadded; the 8 steps are an epoch.  Part 0's loss and every
   gradient are held against the plain CSR version with this run's ReLU
   decisions (as phase 6), and every loss must be finite (the
   ``cluster_gcn`` line).
20. Typed and ego sampling (PyG's ``examples/hetero/to_hetero_mag.py``
   and ``examples/shadow.py``).  A synthetic ogbn-mag at OGB's sizes
   (736,389 papers, 1,134,649 authors, 8,740 institutions, 59,965
   fields; endpoints uniform from ``--seed``), made undirected as
   ``T.ToUndirected(merge=True)`` makes it (seven relations, about 42M
   edges), 128-dim features on every type on the card, 349 paper
   classes and a year (2010-2019) a paper.  (a) Three NeighborLoader
   batches of 1,024 seed papers through ``hetero_neighbor_sample``
   (10 neighbours a relation and hop, two hops, without replacement,
   directed), each with one ``Adam(lr=0.01)`` step of ``to_hetero``
   GraphSAGE (two ``SAGEConv((-1, -1))`` layers, 128 -> 64 -> 349,
   ``aggr="sum"``, a relation's layer ``lin_l`` of the mean over its
   sources by ``matmul(adj, x, reduce="mean")`` plus ``lin_r`` of the
   destination, ReLU between the layers) on the cross-entropy of the
   seed papers: every sampled edge must be an edge of its relation,
   every destination of a hop must hold ``min(deg, 10)`` edges of each
   relation, each type's ids distinct and the papers' start with the
   seeds.  (b) ``hgt_sample`` on the same seeds, 1,024 nodes a type and
   hop, 4 hops (``--use_hgt_loader``), a step each: each type at most
   its inputs plus 4 x 1,024 nodes, each relation's edges exactly
   scipy's ``A[dst_ids][:, src_ids]``.  (c)
   ``hetero_temporal_neighbor_sample`` on batch 0 with the papers'
   years, one step: no paper source later than its root, each root's
   tree disjoint from the others.  (d) ``ego_k_hop_sample_adj`` on the
   products graph (depth 2, 5 neighbours, 512 roots of a seeded
   permutation) and one step of phase 13's GraphSAGE on the
   block-diagonal adjacency with the loss on the ``root_n_id`` rows:
   each net equal to scipy's induced subgraph on its ``n_id`` block,
   ``ptr`` delimiting the nets, ``root_n_id`` at each root.  The first
   step of each path is held against the plain CSR version with this
   run's ReLU decisions (as phase 6), and every output must be int64 on
   the card.  Each sampler's host ms a batch, the nodes and edges per
   type and relation, and each step's ms (the ``typed_sampling`` line).
21. The Reddit pipeline at Reddit's scale (the JAX package's
   ``benchmarks/reddit_pipeline.py``, BASELINE's Reddit config:
   "SpSpMM 2-hop adjacency (A.A) + transpose/diag/spadd pipeline"): its
   synthetic graph (232,965 nodes, 160,462,248 draws, 300 planted
   communities, 90% of the draws inside one) through the public API:
   construction from numpy and ``coalesce("add")`` (structure only),
   ``t()``, ``A + A.t()``, ``remove_diag().set_diag(ones)``,
   ``spspmm_diag(A, A)``, ``expansion_terms(A, A)``, then ``A.A`` over
   the pipeline's 64 scattered blocks of ``M // 4096`` rows through the
   host library's ``spgemm`` with the pipeline's ``RandomState(7)``
   values (float32 on the card, pulled once), and a ``count_only`` pass
   over the same blocks; then one ``csr_spmm`` (K1) launch of ``A`` times
   a seeded ``(M, 128)`` operand.  Checks: A's keys equal ``torch.unique``
   of the raw keys on the card; ``A.t()``'s keys A's swapped and sorted
   by ``torch.sort``; ``A + A.t()``'s keys ``torch.unique`` of both;
   exactly one diagonal entry a row after the diagonal edit;
   ``diag(A.A)`` summing to the reciprocated edges counted on the card
   (``torch.searchsorted``) and equal to a host set intersection on head,
   tail and 512 random rows; each ``A.A`` block equal to scipy's
   ``A[lo:hi] @ A`` (structure exactly, values 1e-6 of max |ref|); K1
   against the host oracle (1e-5).  Each step's host seconds, the nnz,
   terms, terms/s, the extrapolated ``A.A`` time, the host's peak memory
   and K1's ms beside its bound (the ``reddit_pipeline`` line).
22. The training recipes (``pytorch_sparse_tpu_torch.examples``, the
   JAX package's ``examples/train_*.py``) through their ``main`` on the
   card at the JAX recipes' defaults: ``train_gcn`` (Cora's widths, 50
   epochs), ``train_gat`` (4 heads, 30 epochs), ``train_cluster_gcn`` (8
   parts, 5 epochs) and ``train_sage_minibatch`` (20 steps)
   synchronously and with ``--workers 4``; and, in phase 14's four gloo
   processes after phase 16, ``train_gcn --distributed`` flat (ring) and
   with ``--slices 2`` at ``RECIPE_DIST_EPOCHS`` epochs.  Checks (after
   the main path): each recipe's first steps against the same recipe at
   ``--device cpu`` (the plain versions, the same seeds; every step's
   loss within 1e-4 of |loss|), the distributed losses against the
   single-card recipe's at the same steps (1e-4), the SAGE batches
   (``n_id``, ``e_id``, ``rowptr`` of every hop) and losses equal
   without and with the prefetcher; and, on phases 12-13's products
   graph and batches, the host library's ``sample_adj`` (every hop of
   phase 13's batches) and ``saint_subgraph`` (phase 12's node sets)
   equal to their numpy plain versions, each timed beside them in
   alternating pairs.  Each recipe's losses, accuracy, ms a step and
   route (the ``entry_point`` lines), the samplers' host ms (the
   ``host_samplers`` line) and the script's total seconds (the
   ``script`` line).

The main path is phases 4 to 22, each driven once with every launch
count set to 0 just before it and read just after it.  Each phase must
launch the kernels it runs (4: ``csr_spmm`` and ``block_spmm``; 4b:
those and ``block_spmm_t`` and ``edge_dot``; 4c: ``csr_spmm_minmax``,
``minmax_edge_dot`` and ``minmax_spmm_t``, and no block kernel; 5 and 6:
``csr_spmm``; 7: ``edge_softmax`` twice and ``csr_spmm`` once per head
plus once; 8: ``plan_numeric`` three times in 8a and in 8c's cross
terms, ``block_spgemm_window`` in 8c and not in 8a, ``csr_spmm`` once
in 8b (``A + A.t()`` sums its float32 duplicates on the card); 9: ``block_spmm``,
``block_spmm_t`` and ``csr_spmm``, ``block_spmm_dblocks`` three times,
all in the second step, and no ``edge_dot``; 10: ``edge_softmax`` and
``edge_softmax_bwd`` twice each, ``csr_spmm`` 18 times and ``edge_dot``
9 times; 11: ``csr_spmm``; 12: ``random_walk`` and ``csr_spmm``; 13:
``csr_spmm``; 12 and 13 no block kernel; 14: ``shard_spmm``,
``shard_spmm_minmax``, ``block_spmm``, ``block_spmm_t``, ``edge_dot``,
``minmax_edge_dot`` and ``minmax_spmm_t``, counted in the four worker
processes, each rank-0 oracle's launches left out; 15: ``shard_spmm``,
and ``block_spmm`` when the hybrid format is taken; 16: as 14, counted
in the same processes from 0 at the phase's start; 17:
``smem_gather``, ``edge_scan_loop`` and ``tiled_spmm``; 18:
``csr_spmm``, through the row and column sums and the legacy ``spmm``;
19: ``csr_spmm``, and ``block_spmm`` and ``block_spmm_t`` where a part
takes the hybrid route; 20: ``csr_spmm``; 21: ``csr_spmm`` once and
nothing else; 22: ``csr_spmm``, ``edge_softmax``, ``edge_softmax_bwd``
and ``edge_dot`` in this process, ``shard_spmm`` in the four ranks),
and the
``kernels`` line reports each kernel's launches summed over them.
The script prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``.
"""

import argparse
import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

K = 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, FP32 without tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
KERNEL_GATE = 1e-5             # kernel vs plain version, relative to max |ref|
GATE_F32 = 1e-5                # route legs vs host oracle, f32 stores
GATE_BF16 = 2e-3               # bf16 dense store at store budget 2e-3
RELU_FLIP_SHARE = 1e-5         # ReLU decisions the GCN reference may differ on

UNIFORM = (169_343, 1_166_243)             # ogbn-arxiv nodes and edges
REDDIT10 = (23_296, 16_000_000, 30)        # nodes, draws, communities
HYBRID = (232_965, 16_000_000, 200)
GCN_WIDTHS = (128, 256, 40, 3)             # in, hidden, out, layers
GAT_WIDTHS = (128, 8, 8, 40)               # in, heads, per-head, out
SPGEMM_SMALL = (23_296, 1_600_000, 30)     # nodes, draws, communities
SPGEMM_BB, SPGEMM_DENSITY = 512, 0.02      # block split of the SpGEMM legs
SPGEMM_WINDOW = 2048                       # output blocks per K10 window
SPGEMM_RAGGED_BB = 100                     # K10's bf16 case of 200-byte rows
ALIGNED_B = 512                            # phase 9's block size
K5B_KS = (256, 40)                         # phase 9's aggregation widths
K8B_HEADS = (8, 1, 3)
# K12 at PyG's examples/node2vec.py (p = q = 1, an unbiased walk):
# walk_length, walks_per_node.
NODE2VEC = (20, 10)
# Phases 12-13: the ogbn-products-scale graph of the JAX package's
# benchmarks/products_pipeline.py, with OGB's products widths.
PRODUCTS_SCALE = 1.0
SAGE_WIDTHS = (100, 256, 47, 3)            # in, hidden, out, layers
SAINT = (20_000, 3, 3)                     # roots, walk length, batches
NEIGHBOR = (1024, (15, 10, 5), 3)          # batch, fanouts, batches
# Phase 14: ranks sharing the one card on gloo (the community hybrid
# graph's 232,965 rows make 4 blocks of 58,242).  Phase 15: OGB's
# ogbn-products full-batch GCN (examples/nodeproppred/products/gnn.py:
# 3 layers, hidden 256, Adam(lr=0.01)), without dropout as DistGCN has
# none, three steps.
DIST_WORLD = 4
FRONTIER_DENSE = (16_384, 1_000_000, 16)   # nodes, draws, communities
# Phase 16, in phase 14's processes: the (S, C) hierarchical grid and the
# (data, feat) grid of the same shape, the 2-D grid at K=256 (128
# columns a feature rank).  Phase 3 also runs K11a/K11b at K2D_SLICE, the
# columns a feature rank holds of a 40-wide operand.
HIER_GRID = (2, 2)
K2D, K2D_SLICE = 256, 20
PRODUCTS_GCN = (100, 256, 47, 3)           # in, hidden, out, layers
DIST_STEPS = 3
# Phase 22: the training recipes.  Their first steps are held against
# the same recipe at --device cpu; the distributed one runs in phase 14's
# processes at fewer epochs, flat and on (2, 2).
RECIPE_CPU_STEPS = 3
RECIPE_DIST_EPOCHS = 5
RECIPE_DIST_SLICES = 2
# Phase 18: the structural op set.  OGB's ogbn-products train split has
# 196,615 nodes; the products matrix is cut into 8 row blocks and the
# uniform graph into 128 diagonal blocks; the (E, 8) values of the
# uniform graph's row sums.
STRUCT_SUBGRAPH = 196_615
STRUCT_ROW_BLOCKS = 8
STRUCT_DIAG_BLOCKS = 128
STRUCT_WIDTH = 8
# Phase 19: Cluster-GCN on the products graph (the JAX package's
# benchmarks/products_pipeline.py:106-150 and examples/
# train_cluster_gcn.py:55-134, at full width and without XLA's padding):
# 8 parts, each part's interior ordered by coarsening clusters of about
# 512 nodes (partition_fine, grouping "within": the pipeline's default),
# SpMM at the pipeline's width and one step of phase 15's GCN a part.
CLUSTER_PARTS = 8
CLUSTER_FINE_ROWS = 512
CLUSTER_K = 100
# Phase 20: typed and ego sampling.  ogbn-mag at OGB's sizes, made
# undirected as PyG's examples/hetero/to_hetero_mag.py does, with 128-dim
# features on every type (its preprocess='metapath2vec' setting), 349
# paper classes and a year a paper; its NeighborLoader (1,024 seed
# papers, 10 neighbours a relation and hop) and HGTLoader (1,024 nodes a
# type and hop, 4 hops) settings and its to_hetero GraphSAGE (two
# SAGEConv layers, hidden 64, aggr="sum", Adam(lr=0.01)); and PyG's
# examples/shadow.py ego sampler (depth 2, 5 neighbours) on the products
# graph, 512 roots.
MAG_NODES = {"paper": 736_389, "author": 1_134_649, "institution": 8_740,
             "field_of_study": 59_965}
MAG_RELATIONS = (("author", "affiliated_with", "institution", 1_043_998),
                 ("author", "writes", "paper", 7_145_660),
                 ("paper", "cites", "paper", 5_416_271),
                 ("paper", "has_topic", "field_of_study", 7_505_078))
MAG_SCALE = 1.0
MAG_WIDTHS = (128, 64, 349)                # features, hidden, classes
MAG_YEARS = (2010, 2019)
MAG_BATCH = (1024, (10, 10), 3)            # seed papers, fanouts, batches
HGT_SAMPLES = (1024, 4)                    # nodes a type and hop, hops
SHADOW = (512, 2, 5)                       # roots, depth, neighbours
# Phase 21: the JAX package's benchmarks/reddit_pipeline.py at scale 1
# (nodes, Reddit's nnz, oversampling of the draws, communities), its
# A.A row sample (blocks of M // 4096 rows, 64 of them) and K1's width.
REDDIT_FULL = (232_965, 114_615_892, 1.4, 300)
REDDIT_SCALE = 1.0
REDDIT_AA_BLOCKS = (4096, 64)
REDDIT_K = 128
REPS = 20
PLAIN_REPS = 5                 # the slower plain versions of slice 3


class Failure(Exception):
    pass


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=REPS) -> float:
    """Per-call milliseconds: CUDA events around ``reps`` calls after a
    warm-up."""
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


def errors(got, ref):
    """(max abs error, max abs error / max |ref|) in float64."""
    diff = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return diff, (diff / scale if scale > 0 else diff)


def walk_rows(A, n_random, seed):
    """Head + tail + random rows, and for each edge of them: its row's
    position in that list, its edge id."""
    M = A.sparse_size(0)
    rng = np.random.RandomState(seed)
    rows = np.unique(np.concatenate([
        np.arange(min(256, M)), np.arange(max(0, M - 256), M),
        rng.randint(0, M, n_random)]))
    rp = A.storage.numpy_view("rowptr")
    starts, lens = rp[rows], rp[rows + 1] - rp[rows]
    rix = np.repeat(np.arange(rows.size), lens)
    e = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) \
        + starts[rix]
    return rows, rix, e


def oracle_check(A, mat, out, gate, seed=7, n_random=512):
    """Host CSR-walk oracle over head + tail + random rows (the rule of
    the JAX package's ``bench.py``).  Returns (ok, max_rel_err)."""
    rows, rix, e = walk_rows(A, n_random, seed)
    col = A.storage.numpy_view("col")
    value = A.storage.value()
    mat_np = mat.detach().float().cpu().numpy()
    contrib = mat_np[col[e]].astype(np.float64)
    if value is not None:
        contrib = contrib * value.detach().float().cpu().numpy()[e, None]
    ref = np.zeros((rows.size, mat_np.shape[1]), np.float64)
    np.add.at(ref, rix, contrib)
    got = out.detach().float().cpu().numpy()[rows]
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate, err


def uniform_graph(ts, M, E, device, values=True):
    """The ogbn-arxiv-scale uniform graph of the JAX package's bench.py
    (same seed and draws)."""
    rng = np.random.RandomState(0)
    row = np.sort(rng.randint(0, M, E)).astype(np.int32)
    col = rng.randint(0, M, E).astype(np.int32)
    order = np.lexsort((col, row))
    val = rng.randn(E).astype(np.float32)
    return ts.SparseTensor(
        row=row[order], col=col[order], value=val if values else None,
        sparse_sizes=(M, M), is_sorted=True, trust_data=True, device=device)


def operand(torch, n, k, seed, device):
    x = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    return torch.from_numpy(x).to(device)


def csr_bounds(M, E, K_, ncols, has_value):
    nbytes = 4 * (M + 1) + 4 * E + (4 * E if has_value else 0) \
        + 4 * K_ * ncols + 4 * M * K_
    flops = 2 * E * K_
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def f32_product_bounds(nbytes, flops):
    """The two bounds of f32-accurate products that move ``nbytes``:
    ``bound_ms`` on the tensor cores, three TF32 products a product
    (3xTF32) at 495 TFLOP/s, and ``bound_fp32_ms`` on the FP32 units at
    67 TFLOP/s, each the larger of its operations time and the bytes
    time."""
    t_b = nbytes / HBM_BYTES_PER_S
    out = {}
    for key, t_f in (("bound", 3 * flops / TF32_FLOPS_PER_S),
                     ("bound_fp32", flops / FP32_FLOPS_PER_S)):
        out[f"{key}_ms"] = max(t_b, t_f) * 1e3
        out[f"{key}_by"] = "bytes" if t_b >= t_f else "operations"
    return out


def block_bounds(torch, blocks, nb, nout, nsrc, n_index, K_, split_parts):
    """A block pass's bounds: ``nb`` blocks of ``blocks``' size and
    dtype, ``nsrc`` source blocks of the operand read and ``nout`` output
    blocks written (``K_`` wide), and ``n_index`` int32 schedule entries.
    f32 blocks: :func:`f32_product_bounds`.  bf16 blocks: the products at
    the bf16 tensor-core rate, times the bf16 terms an f32 operand splits
    into for the same accuracy (``split_parts``, as the bf16 dense store
    runs), as ``bound_ms``."""
    B = blocks.shape[1]
    elem = blocks.element_size()
    nbytes = nb * B * B * elem + 4 * K_ * B * nsrc + 4 * n_index \
        + 4 * nout * B * K_
    flops = 2 * nb * B * B * K_
    if blocks.dtype != torch.bfloat16:
        return f32_product_bounds(nbytes, flops)
    t_f = split_parts * flops / BF16_FLOPS_PER_S
    t_b = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def forward_block_bounds(torch, h, blocks, K_, split_parts):
    """``block_bounds`` of the forward pass over ``h``'s slots."""
    R = h.rb_ptr.shape[0] - 1
    ncb = int(torch.unique(h.slot_col).numel())
    return block_bounds(torch, blocks, h.nb, R, ncb, h.nb + R + 1, K_,
                        split_parts)


def transpose_block_bounds(torch, h, blocks, K_, split_parts):
    """``block_bounds`` of the transpose pass: rows and columns swap,
    and ``order_t`` joins the schedule."""
    C = h.cb_ptr.shape[0] - 1
    nrb = int(torch.unique(h.slot_row).numel())
    return block_bounds(torch, blocks, h.nb, C, nrb, 2 * h.nb + C + 1, K_,
                        split_parts)


def route_bound_ms(torch, A, h, K_, split_parts):
    """Least time of one routed SpMM on an H100 SXM: the CSR bound, the
    dense product's bound, or the block pass's plus the remainder's; f32
    products priced on the FP32 units, as in every slice before."""
    def csr_of(M, col, has_value):
        return csr_bounds(M, col.shape[0], K_, int(np.unique(col).size),
                          has_value)[0]

    if h is None:
        return csr_of(A.sparse_size(0), A.storage.numpy_view("col"),
                      A.has_value())
    if hasattr(h, "dense"):
        M, N = h.M, h.N
        nbytes = M * N * h.dense.element_size() + 4 * N * K_ + 4 * M * K_
        if h.dense.dtype == torch.bfloat16:
            t_f = 2 * split_parts * M * N * K_ / BF16_FLOPS_PER_S
        else:
            t_f = 2 * M * N * K_ / FP32_FLOPS_PER_S
        return max(nbytes / HBM_BYTES_PER_S, t_f) * 1e3
    b = forward_block_bounds(torch, h, h.blocks, K_, split_parts)
    ms = b.get("bound_fp32_ms", b["bound_ms"])
    if h.rest is not None:
        ms += csr_of(h.M, h.rest[1].cpu().numpy(), True)
    return ms


def gcn_plain(torch, csr_spmm_plain, model, adj, x, masks=None):
    """The GCN forward with the same weights, written out layer by layer
    on the plain CSR version: the reference of the kernel run.  With
    ``masks`` (one boolean tensor per hidden layer) each ReLU keeps
    exactly the entries its mask marks, so that the reference takes
    another run's ReLU decisions."""
    rowptr, col, value = adj.csr()
    n = len(model.weights)
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        x = csr_spmm_plain(rowptr, col, value, x @ w) + b
        if i < n - 1:
            x = torch.relu(x) if masks is None else x * masks[i]
    return x


def plain_loss(torch, csr_spmm_plain, model, adj, x, labels, masks=None):
    """Mean negative log-likelihood of the ``gcn_plain`` logits."""
    logp = torch.log_softmax(
        gcn_plain(torch, csr_spmm_plain, model, adj, x, masks), dim=-1)
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def relu_masks(torch, spmm, model, adj, x):
    """The ReLU decisions (pre-activation > 0) of each hidden layer of a
    GCN forward whose aggregation is ``spmm(adj, h)``."""
    masks = []
    with torch.no_grad():
        for w, b in list(zip(model.weights, model.biases))[:-1]:
            x = spmm(adj, x @ w) + b
            masks.append(x > 0)
            x = torch.relu(x)
    return masks


def _segment_sums(contrib, lens):
    """Row sums of ``contrib`` over consecutive segments of ``lens``
    rows (empty segments give zero rows), in float64."""
    out = np.zeros((lens.size,) + contrib.shape[1:], np.float64)
    nz = lens > 0
    if contrib.shape[0]:
        starts = np.cumsum(lens) - lens
        out[nz] = np.add.reduceat(contrib, starts[nz], axis=0)
    return out


def grad_x_oracle_check(A, gout, grad_x, gate, arg=None, seed=9,
                        n_random=512):
    """``grad_x = A^T gout`` against a float64 host CSC walk over head +
    tail + random columns; given the argout ``arg`` of a min/max SpMM,
    only the ``(row, k)`` each edge won count.  Returns (ok,
    max_rel_err)."""
    N = A.sparse_size(1)
    rng = np.random.RandomState(seed)
    cols = np.unique(np.concatenate([
        np.arange(min(256, N)), np.arange(max(0, N - 256), N),
        rng.randint(0, N, n_random)]))
    cp = A.storage.numpy_view("colptr")
    perm = A.storage.numpy_view("csr2csc")
    row = A.storage.numpy_view("row")
    value = A.storage.value()
    starts, lens = cp[cols], cp[cols + 1] - cp[cols]
    cix = np.repeat(np.arange(cols.size), lens)
    p = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) \
        + starts[cix]
    e = perm[p]
    gout_np = gout.detach().float().cpu().numpy()
    contrib = gout_np[row[e]].astype(np.float64)
    if arg is not None:
        contrib[arg.cpu().numpy()[row[e]] != e[:, None]] = 0.0
    if value is not None:
        contrib *= value.detach().float().cpu().numpy()[e, None]
    ref = _segment_sums(contrib, lens)
    got = grad_x.detach().float().cpu().numpy()[cols]
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate, err


def grad_v_oracle_check(A, x, gout, grad_v, gate, arg=None, seed=10,
                        n_edges=4096):
    """``grad_v[e] = <x[col e], gout[row e]>`` against a float64 host dot
    over random edges; given the argout ``arg`` of a min/max SpMM, only
    the ``k`` each edge won count.  Returns (ok, max_rel_err)."""
    rng = np.random.RandomState(seed)
    e = rng.randint(0, A.nnz(), n_edges)
    row = A.storage.numpy_view("row")[e]
    col = A.storage.numpy_view("col")[e]
    x_np = x.detach().double().cpu().numpy()
    g_np = gout.detach().double().cpu().numpy()
    prod = x_np[col] * g_np[row]
    if arg is not None:
        prod[arg.cpu().numpy()[row] != e[:, None]] = 0.0
    ref = prod.sum(-1)
    got = grad_v.detach().double().cpu().numpy()[e]
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate, err


def minmax_bounds(M, E, K_, ncols, has_value, elem=4):
    """K6's bound: K1's bytes at the operand's element size, plus the
    (M, K) int32 argout."""
    nbytes = 4 * (M + 1) + 4 * E + (elem * E if has_value else 0) \
        + elem * K_ * ncols + elem * M * K_ + 4 * M * K_
    t_b, t_f = nbytes / HBM_BYTES_PER_S, 2 * E * K_ / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def minmax_bwd_bounds(torch, col, arg, N, has_value):
    """The bounds of K7a and K7b on this argout: each reads arg and the
    structure once; K7a reads only the x entries whose (row, k) some
    edge won (distinct (col, k) pairs) and writes (E,), K7b reads only
    the won g entries and writes (N, K).  Both are bytes-bound (2 flops
    per won entry)."""
    M, K_ = arg.shape
    E = col.shape[0]
    won = arg < E
    n_won = int(won.sum())
    k_idx = torch.arange(K_, device=arg.device).expand(M, K_)[won]
    pairs = col.long()[arg[won].long()] * K_ + k_idx
    n_x = int(torch.unique(pairs).numel())
    common = 4 * M * K_ + 4 * E
    b7a = 4 * (M + 1) + common + 4 * M * K_ + 4 * n_x + 4 * E
    b7b = 4 * (N + 1) + common + 4 * E + (4 * E if has_value else 0) \
        + 4 * n_won + 4 * N * K_
    t_f = 2 * n_won / FP32_FLOPS_PER_S
    out = []
    for nbytes in (b7a, b7b):
        t_b = nbytes / HBM_BYTES_PER_S
        out.append((max(t_b, t_f) * 1e3,
                    "bytes" if t_b >= t_f else "operations"))
    return out


def minmax_oracle_check(A, mat, out, arg, is_min, gate, seed=11,
                        n_random=512):
    """``out`` and ``arg`` of ``spmm_min``/``spmm_max`` against a host row
    walk (head + tail + random rows): each product rounded to float32
    as the contract rounds it to the operand's dtype, compared in
    float64, the first edge kept on ties, the sentinel on empty rows.
    Returns (ok, out_rel_err, arg_mismatches)."""
    rows, rix, e = walk_rows(A, n_random, seed)
    col = A.storage.numpy_view("col")
    E = A.nnz()
    mat_np = mat.detach().float().cpu().numpy()
    h = mat_np[col[e]]
    value = A.storage.value()
    if value is not None:
        h = h * value.detach().float().cpu().numpy()[e, None]  # f32 product
    h = h.astype(np.float64)
    ref = np.zeros((rows.size, mat_np.shape[1]), np.float64)
    ref_arg = np.full(ref.shape, E, np.int64)
    seen = np.zeros(rows.size, bool)
    for i in range(h.shape[0]):          # edges in CSR order
        r = rix[i]
        if not seen[r]:
            ref[r], ref_arg[r], seen[r] = h[i], e[i], True
            continue
        better = h[i] < ref[r] if is_min else h[i] > ref[r]
        ref[r] = np.where(better, h[i], ref[r])
        ref_arg[r] = np.where(better, e[i], ref_arg[r])
    got = out.detach().double().cpu().numpy()[rows]
    mism = int((arg.cpu().numpy()[rows] != ref_arg).sum())
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
    return err <= gate and mism == 0, err, mism


def gat_plain(torch, model, adj, x, edge_softmax_plain, csr_spmm_plain):
    """The GAT forward with the same weights, written out layer by layer
    on the plain edge-softmax and CSR versions: the reference of the
    kernel run."""
    F = torch.nn.functional
    rowptr, col = adj.storage.rowptr(), adj.storage.col()
    row, coll = adj.storage.row().long(), col.long()

    def layer(h, a_src, a_dst):
        # The model's own einsums: the same logits, so the same LeakyReLU
        # decisions, as the kernel run.
        logits = F.leaky_relu(torch.einsum("nhd,hd->nh", h, a_src)[row]
                              + torch.einsum("nhd,hd->nh", h, a_dst)[coll],
                              0.2)
        att = edge_softmax_plain(rowptr, logits)
        return torch.stack([
            csr_spmm_plain(rowptr, col, att[:, i].contiguous(),
                           h[:, i].contiguous())
            for i in range(h.shape[1])], dim=1)

    H, D = model.a1_src.shape
    h = layer((x @ model.w1).reshape(-1, H, D), model.a1_src, model.a1_dst)
    h = F.elu(h).reshape(-1, H * D)
    out_dim = model.w2.shape[1]
    h = layer((h @ model.w2).reshape(-1, 1, out_dim), model.a2_src,
              model.a2_dst)
    return h[:, 0]


def dblocks_bounds(torch, nb, B, K_, n_rows_p, n_rows_q, dtype):
    """K5b's bounds (:func:`f32_product_bounds`): ``2 B^2 K`` flops a slot
    of f32 operands for either store, against the ``(nb+1, B, B)``
    store-dtype output written once and ``p``, ``q`` and the two int32
    slot arrays read once."""
    elem = 2 if dtype == torch.bfloat16 else 4
    nbytes = (nb + 1) * B * B * elem + 4 * K_ * (n_rows_p + n_rows_q) \
        + 8 * nb
    return f32_product_bounds(nbytes, 2 * B * B * K_ * nb)


def relu_recorder(torch, log):
    """``torch.relu`` that appends each call's decisions to ``log``."""
    def relu(x):
        log.append((x > 0).detach())
        return torch.relu(x)
    return relu


def relu_replay(masks):
    """A ReLU that keeps exactly the entries of the next recorded mask."""
    it = iter(masks)
    return lambda x: x * next(it)


def sage_forward(model, agg, x, relu):
    """GraphSAGE's forward written out, with the aggregation
    ``agg(h, "mean")`` and the ReLU given."""
    n = len(model.b)
    for i in range(n):
        x = x @ model.w_self[i] + agg(x, "mean") @ model.w_neigh[i] \
            + model.b[i]
        if i < n - 1:
            x = relu(x)
    return x


def gin_forward(model, agg, x, relu):
    """GIN's forward written out, as :func:`sage_forward`."""
    n = len(model.w1)
    for i in range(n):
        x = (1.0 + model.eps[i]) * x + agg(x, "sum")
        x = relu(x @ model.w1[i] + model.b1[i])
        x = x @ model.w2[i] + model.b2[i]
        if i < n - 1:
            x = relu(x)
    return x


def gcn_agg_io(torch, agg, model, x, labels):
    """A GCN forward written out with the aggregation ``agg(h)``: each
    layer's aggregation input, and the gradient of the mean negative
    log-likelihood with respect to each layer's aggregation output."""
    ins, outs = [], []
    n = len(model.weights)
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        z = x @ w
        y = agg(z)
        ins.append(z.detach())
        outs.append(y)
        x = y + b
        if i < n - 1:
            x = torch.relu(x)
    logp = torch.log_softmax(x, dim=-1)
    loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
    return ins, torch.autograd.grad(loss, outs)


def seeded_labels(torch, x, n_classes, seed, device):
    """Class labels the features predict: the arg-max of a seeded random
    projection of ``x``, so that training has a signal to fit."""
    proj = operand(torch, x.shape[1], n_classes, seed, device)
    return (x @ proj).argmax(-1)


def kernel_case(torch, label, got, ref, failures, name, **timing):
    """One compared case of a kernel: its errors against the plain
    version and, for the timed case, its times and bound."""
    abs_e, rel_e = errors(got, ref)
    ok = rel_e <= KERNEL_GATE
    if not ok:
        failures.append(f"{name} {label}: rel err {rel_e:.3g}")
    return {"case": label, "max_abs_err": abs_e, "max_rel_err": rel_e,
            "ok": ok, **timing}


def last_instance(fn):
    """The instance of the CSR walk (``csr_spmm``, ``shard_spmm``,
    ``shard_spmm_minmax``, ``minmax_spmm_t``, ``csr_spmm_minmax``), of
    the per-edge walk (``edge_dot``, ``minmax_edge_dot``), of the row
    sweep (``edge_softmax``) or of the on-chip scan (``edge_scan_loop``)
    that the wrapper ``fn`` last launched, as a dict; None before a
    launch."""
    inst = fn.last_instance
    return None if inst is None else inst._asdict()


def bits_equal(torch, a, b):
    """Equal bit for bit (NaN included): two launches of one kernel."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(bits), b.view(bits))


def kernel_entry(name, source, replaces, cases, library, shape, units=None):
    """The ``kernels`` line entry of a kernel: the first case's times,
    the largest error over all cases.  ``launches`` is filled in from
    the main path's run.  A kernel with both bounds of f32-accurate
    products also carries the FP32 one, the share of its time that each
    makes, and the units it runs on."""
    head = cases[0]
    entry = {
        "name": name, "route": "cuda",
        "source": f"pytorch_sparse_tpu_torch/csrc/{source}",
        "replaces": f"pytorch_sparse_tpu/{replaces}", "launches": None,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err": max(c["max_rel_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library": library,
        "shape": shape, "cases": cases,
    }
    if "bound_fp32_ms" in head:
        entry.update(
            bound_fp32_ms=head["bound_fp32_ms"],
            bound_fp32_by=head["bound_fp32_by"], units=units,
            bound_share_tensor_cores=head["bound_ms"] / head["ms"],
            bound_share_fp32_units=head["bound_fp32_ms"] / head["ms"])
    return entry


def plan_numeric_bounds(n_x, n_y, T, n_out, elem, has_y):
    """K9's bound: each input read once (the value arrays, the int32 term
    indices and ``t_ptr``) and the output written once; a multiply and an
    add a term (an add alone without ``y``)."""
    nbytes = elem * n_x + 4 * T + 4 * (n_out + 1) + elem * n_out
    if has_y:
        nbytes += elem * n_y + 4 * T
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = (2 if has_y else 1) * T / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def block_spgemm_bounds(torch, blocks, n_pairs, n_out):
    """K10's bounds over one block product of a store with itself: the
    store read once, the pair schedule read and the ``(n_out, Bb, Bb)``
    f32 output written once; ``2 Bb^3`` flops a pair, for f32 blocks
    :func:`f32_product_bounds`, for bf16 blocks at the bf16 tensor-core
    rate (their products are exact in an f32 accumulator)."""
    Bb = blocks.shape[1]
    nbytes = blocks.numel() * blocks.element_size() \
        + 4 * (2 * n_pairs + n_out + 1) + 4 * n_out * Bb * Bb
    flops = 2 * Bb ** 3 * n_pairs
    if blocks.dtype != torch.bfloat16:
        return f32_product_bounds(nbytes, flops)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def entry_positions(rowC, colC, P, rows, cols):
    """Positions of the ``(rows, cols)`` entries in a (row, col)-sorted
    structure of ``P`` columns, -1 where absent."""
    key = rowC.astype(np.int64) * P + colC
    q = rows.astype(np.int64) * P + cols
    pos = np.searchsorted(key, q)
    pos_c = np.minimum(pos, max(key.size - 1, 0))
    hit = (pos < key.size) & (key[pos_c] == q) if key.size else pos < 0
    return np.where(hit, pos_c, -1)


def _expand_runs(starts, lens):
    """For runs ``[starts[i], starts[i] + lens[i])``: each element's run
    index and position."""
    ix = np.repeat(np.arange(lens.size), lens)
    return ix, np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens,
                                                 lens) + starts[ix]


def spspmm_grad_oracle_check(A, B, C, gC, gA, gB, gate, seed=12,
                             n_edges=4096):
    """Both value gradients of ``C = A @ B`` against float64 host dots
    over random entries: ``grad_valueA[e]`` sums ``gC[(i, j)] vB[(k, j)]``
    over B's row ``k`` of ``e = (i, k)``, ``grad_valueB[b]`` sums
    ``gC[(i, j)] vA[(i, k)]`` over A's column ``k`` of ``b = (k, j)``.
    Returns (ok, err_a, err_b)."""
    P = B.sparse_size(1)
    rowC, colC = C.storage.numpy_view("row"), C.storage.numpy_view("col")
    g = gC.detach().double().cpu().numpy()
    vA = A.storage.value().detach().double().cpu().numpy()
    vB = B.storage.value().detach().double().cpu().numpy()
    rowA, colA = A.storage.numpy_view("row"), A.storage.numpy_view("col")
    rowB, colB = B.storage.numpy_view("row"), B.storage.numpy_view("col")
    rng = np.random.RandomState(seed)
    e = rng.randint(0, A.nnz(), n_edges)
    rpB = B.storage.numpy_view("rowptr")
    ix, b = _expand_runs(rpB[colA[e]], rpB[colA[e] + 1] - rpB[colA[e]])
    pos_a = entry_positions(rowC, colC, P, rowA[e][ix], colB[b])
    ref_a = np.bincount(ix, weights=g[pos_a] * vB[b], minlength=n_edges)
    bb = rng.randint(0, B.nnz(), n_edges)
    cpA, perm = A.storage.numpy_view("colptr"), A.storage.numpy_view(
        "csr2csc")
    k = rowB[bb]
    ix, p = _expand_runs(cpA[k], cpA[k + 1] - cpA[k])
    a = perm[p]
    pos_b = entry_positions(rowC, colC, P, rowA[a], colB[bb][ix])
    ref_b = np.bincount(ix, weights=g[pos_b] * vA[a], minlength=n_edges)
    if (pos_a < 0).any() or (pos_b < 0).any():
        return False, float("inf"), float("inf")
    errs = []
    for got, idx, ref in ((gA, e, ref_a), (gB, bb, ref_b)):
        got = got.detach().double().cpu().numpy()[idx]
        errs.append(float(np.abs(got - ref).max() / (np.abs(ref).max()
                                                     + 1e-6)))
    return max(errs) <= gate, errs[0], errs[1]


def scipy_csr(sp, A, values=True):
    """``A`` as a float64 scipy CSR matrix (its values, or ones)."""
    v = (A.storage.value().detach().double().cpu().numpy() if values
         else np.ones(A.nnz()))
    return sp.csr_matrix((v, (A.storage.numpy_view("row"),
                              A.storage.numpy_view("col"))),
                         shape=A.sparse_sizes())


def csr_against(T, pattern, ref):
    """``T``'s structure against the scipy matrix ``pattern`` (exactly)
    and its values against ``ref`` looked up on that structure (absent
    entries count 0; scipy drops exact zeros, the port keeps them).
    Returns (same_structure, max_rel_err)."""
    pattern = pattern.tocsr()
    pattern.sort_indices()
    rp, col = T.storage.numpy_view("rowptr"), T.storage.numpy_view("col")
    same = (np.array_equal(rp, pattern.indptr)
            and np.array_equal(col, pattern.indices))
    if not same:
        return False, float("inf")
    ref = ref.tocsr()
    ref.sort_indices()
    want = np.zeros(col.size)
    rows = np.repeat(np.arange(ref.shape[0]), np.diff(ref.indptr))
    pos = entry_positions(T.storage.numpy_view("row"), col, T.sparse_size(1),
                          rows, ref.indices)
    if (pos < 0).any():
        return False, float("inf")
    want[pos] = ref.data
    got = T.storage.value().detach().double().cpu().numpy()
    return True, float(np.abs(got - want).max()
                       / (np.abs(want).max() + 1e-30))


def stream_pieces_check(torch, sp, A, pieces, Bb, seed=13, n_random=512):
    """The pieces of ``spspmm_stream_device(A, A)`` summed: their float64
    total against ``colsum(A) . rowsum(A)``, and head + tail + random
    rows against scipy's float64 product.  Returns (checksum_rel_err,
    rows_rel_err, n_block_pieces, n_coo_pieces)."""
    M, P = A.sparse_size(0), A.sparse_size(1)
    S = scipy_csr(sp, A)
    rng = np.random.RandomState(seed)
    rows = np.unique(np.concatenate([
        np.arange(min(256, M)), np.arange(max(0, M - 256), M),
        rng.randint(0, M, n_random)]))
    where = np.full(M, -1)
    where[rows] = np.arange(rows.size)
    got = np.zeros((rows.size, P))
    total = 0.0
    n_blk = n_coo = 0
    for piece in pieces:
        if piece[0] == "blocks":
            _, brow, bcol, cblk = piece
            total += float(cblk.double().sum())
            n_blk += 1
            for t in range(brow.size):
                r0, c0 = int(brow[t]) * Bb, int(bcol[t]) * Bb
                loc = np.flatnonzero(where[r0:min(r0 + Bb, M)] >= 0)
                if loc.size == 0:
                    continue
                w = min(Bb, P - c0)
                got[where[r0 + loc], c0:c0 + w] += cblk[t][
                    torch.from_numpy(loc).to(cblk.device)][:, :w].double(
                ).cpu().numpy()
        else:
            _, lo, hi, blk = piece
            n_coo += 1
            r = blk.storage.numpy_view("row") + lo
            c = blk.storage.numpy_view("col")
            v = blk.storage.value().detach().double().cpu().numpy()
            total += float(v.sum())
            sel = where[r] >= 0
            np.add.at(got, (where[r[sel]], c[sel]), v[sel])
    check = float(np.asarray(S.sum(axis=0)).ravel()
                  @ np.asarray(S.sum(axis=1)).ravel())
    ref = (S[rows] @ S).toarray()
    return (abs(total - check) / abs(check),
            float(np.abs(got - ref).max() / np.abs(ref).max()), n_blk,
            n_coo)


def products_graph(scale, seed=0):
    """The ogbn-products-scale synthetic graph of the JAX package's
    ``benchmarks/products_pipeline.py:35-56`` (a copy, same seed and
    draws): 2,449,029 nodes and 123,718,280 draws at scale 1, 8,000
    planted communities (80% of the edges stay inside one) and a fifth
    of the sources drawn from the first 1% of the nodes (hubs).
    Returns ``(M, src, dst)``."""
    rng = np.random.RandomState(seed)
    M = int(2_449_029 * scale)
    E = int(123_718_280 * scale)
    n_comm = max(int(8000 * scale), 8)
    comm = rng.randint(0, n_comm, M).astype(np.int32)
    order = np.argsort(comm, kind="stable")
    comm_ptr = np.searchsorted(comm[order], np.arange(n_comm + 1))
    src = rng.randint(0, M, E).astype(np.int64)
    hubs = rng.randint(0, max(M // 100, 1), E // 5).astype(np.int64)
    src[: hubs.shape[0]] = hubs
    intra = rng.rand(E) < 0.8
    c = comm[src[intra]]
    lo, hi = comm_ptr[c], comm_ptr[c + 1]
    dst_intra = order[
        lo + (rng.rand(int(intra.sum())) * (hi - lo)).astype(np.int64)
    ]
    dst = rng.randint(0, M, E).astype(np.int64)
    dst[intra] = dst_intra
    return M, src, dst


def reddit_graph(scale=1.0, seed=0):
    """The Reddit-scale synthetic graph of the JAX package's
    ``benchmarks/reddit_pipeline.py:37-60`` (a copy, same seed and
    draws): at scale 1, 232,965 nodes, ``int(114,615,892 * 1.4)`` =
    160,462,248 draws (oversampled against the duplicates inside the
    communities), 300 planted communities, 90% of the draws inside the
    source's.  Returns ``(M, src, dst)``."""
    nodes, nnz, over, comm_n = REDDIT_FULL
    rng = np.random.RandomState(seed)
    M_ = int(nodes * scale)
    E = int(nnz * scale * over)
    n_comm = max(int(comm_n * scale), 4)
    comm = rng.randint(0, n_comm, M_).astype(np.int32)
    order = np.argsort(comm, kind="stable")
    comm_ptr = np.searchsorted(comm[order], np.arange(n_comm + 1))
    src = rng.randint(0, M_, E).astype(np.int64)
    intra = rng.rand(E) < 0.9
    c = comm[src[intra]]
    lo, hi = comm_ptr[c], comm_ptr[c + 1]
    dst_intra = order[(lo + (rng.rand(int(intra.sum())) * (hi - lo))
                       .astype(np.int64))]
    del c, lo, hi
    dst = rng.randint(0, M_, E).astype(np.int64)
    dst[intra] = dst_intra
    return M_, src, dst


def mag_graph(torch, scale, seed, device):
    """A synthetic ogbn-mag of OGB's sizes (``MAG_NODES``,
    ``MAG_RELATIONS``), seeded, made undirected as PyG's
    ``examples/hetero/to_hetero_mag.py`` does with
    ``T.ToUndirected(merge=True)``: each relation gains its reverse
    ``rev_<rel>``, and ``cites`` is merged with its own reverse and
    coalesced.  Endpoints are uniform (not OGB's degree distribution).
    Returns ``(nodes, rels)``: each type's node count, and per relation
    key ``'src__rel__dst'`` its CSC over the destination ``(colptr,
    row)`` as host int64 arrays, in PyG's edge-type order; a relation's
    edges are grouped by destination in draw order (``cites``: by
    destination, then source).  The sorts run on ``device``."""
    rng = np.random.RandomState(seed)
    nodes = {t: max(int(n * scale), 1) for t, n in MAG_NODES.items()}

    def csc(dst, src, n_dst, merge=False):
        d = torch.from_numpy(dst).to(device)
        s_ = torch.from_numpy(src).to(device)
        if merge:
            key = torch.unique(d * max(nodes.values()) + s_)
            d, s_ = key // max(nodes.values()), key % max(nodes.values())
        else:
            order = torch.argsort(d, stable=True)
            d, s_ = d[order], s_[order]
        colptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=device)
        colptr[1:] = torch.cumsum(torch.bincount(d, minlength=n_dst), 0)
        return colptr.cpu().numpy(), s_.cpu().numpy()

    fwd, rev = {}, {}
    for src_t, rel, dst_t, n_edges in MAG_RELATIONS:
        n_edges = max(int(n_edges * scale), 1)
        src = rng.randint(0, nodes[src_t], n_edges).astype(np.int64)
        dst = rng.randint(0, nodes[dst_t], n_edges).astype(np.int64)
        if src_t == dst_t:
            fwd[f"{src_t}__{rel}__{dst_t}"] = csc(
                np.concatenate([dst, src]), np.concatenate([src, dst]),
                nodes[dst_t], merge=True)
        else:
            fwd[f"{src_t}__{rel}__{dst_t}"] = csc(dst, src, nodes[dst_t])
            rev[f"{dst_t}__rev_{rel}__{src_t}"] = csc(src, dst, nodes[src_t])
    return nodes, {**fwd, **rev}


def typed_sample_faults(colptr, row, nodes, rows, cols, eids, seeds, fanout,
                        n_hops):
    """The faults of one typed neighbour sample (``directed=True``,
    without replacement, the same fanout every hop): edges that are not
    edges of their relation, destinations of a hop whose edge count in
    a relation is not ``min(deg, fanout)`` (or that got edges without
    being a hop's frontier), repeated node ids of a type, and whether
    the seeds' type starts with the seeds.  All host arrays, keyed as
    the sampler's outputs; ``seeds`` maps a type to its inputs."""
    bounds = {t: [seeds[t].shape[0] if t in seeds else 0] for t in nodes}
    for h in range(n_hops - 1):
        for t in nodes:
            bounds[t].append(bounds[t][-1])
        for rel in rows:
            src_t, _, dst_t = rel.split("__")
            lo = bounds[dst_t][h - 1] if h else 0
            hop = (cols[rel] >= lo) & (cols[rel] < bounds[dst_t][h])
            if hop.any():
                bounds[src_t][h + 1] = max(bounds[src_t][h + 1],
                                           int(rows[rel][hop].max()) + 1)
    bad_edges = wrong_size = 0
    for rel in rows:
        src_t, _, dst_t = rel.split("__")
        cp, rw = colptr[rel], row[rel]
        e, c = eids[rel], cols[rel]
        dst_node = nodes[dst_t][c]
        bad_edges += int((~((e >= cp[dst_node]) & (e < cp[dst_node + 1])
                            & (rw[np.clip(e, 0, max(rw.shape[0] - 1, 0))]
                               == nodes[src_t][rows[rel]]))).sum())
        got = np.bincount(c, minlength=nodes[dst_t].shape[0])
        want = np.zeros_like(got)
        front = nodes[dst_t][:bounds[dst_t][-1]]
        want[:front.shape[0]] = np.minimum(cp[front + 1] - cp[front], fanout)
        wrong_size += int((got != want).sum())
    return dict(
        bad_edges=bad_edges, wrong_size_destinations=wrong_size,
        repeated_ids=sum(int(v.shape[0] - np.unique(v).shape[0])
                         for v in nodes.values()),
        seeds_first=all(np.array_equal(nodes[t][:s.shape[0]], s)
                        for t, s in seeds.items()))


def induced_faults(sp, colptr, row, n_nodes, nodes, rows, cols, eids):
    """Per relation, whether the sampled edges are exactly the relation's
    edges between the sampled nodes, with their multiplicity: scipy's
    ``A[dst_ids][:, src_ids]`` of the relation's (dst x src) CSR, against
    the same matrix of the sampled (col, row) pairs; and whether every
    edge id is the edge it stands for.  Returns the relations that
    differ."""
    bad = []
    for rel in rows:
        src_t, _, dst_t = rel.split("__")
        cp, rw = colptr[rel], row[rel]
        A = sp.csr_matrix((np.ones(rw.shape[0], np.float32), rw, cp),
                          shape=(n_nodes[dst_t], n_nodes[src_t]))
        want = A[nodes[dst_t]][:, nodes[src_t]]
        got = sp.csr_matrix(
            (np.ones(rows[rel].shape[0], np.float32), (cols[rel], rows[rel])),
            shape=want.shape)
        e, c = eids[rel], cols[rel]
        dst_node = nodes[dst_t][c]
        ids_ok = bool(((e >= cp[dst_node]) & (e < cp[dst_node + 1])).all()
                      and (rw[e] == nodes[src_t][rows[rel]]).all())
        if (got != want).nnz or not ids_ok:
            bad.append(rel)
    return bad


def temporal_faults(nodes, rows, cols, n_inputs, times):
    """The faults of a temporal typed sample (``directed=True``).  Each
    input is a root (numbered over the types in the order of
    ``nodes``); a sampled node belongs to the root of the destination
    that drew it.  Counts edges whose endpoints belong to different
    roots, nodes no edge reaches, ``(node, root)`` pairs repeated within
    a type (the trees must be disjoint), and sources of a type in
    ``times`` later than their root (a root without a time admits
    all)."""
    root, root_time, base = {}, [], 0
    for t, v in nodes.items():
        k = n_inputs.get(t, 0)
        root[t] = np.full(v.shape[0], -1, np.int64)
        root[t][:k] = base + np.arange(k)
        base += k
        root_time.append(times[t][v[:k]] if t in times
                         else np.full(k, np.iinfo(np.int64).max))
    root_time = np.concatenate(root_time)
    changed = True
    while changed:
        changed = False
        for rel in rows:
            src_t, _, dst_t = rel.split("__")
            r = root[dst_t][cols[rel]]
            new = (r >= 0) & (root[src_t][rows[rel]] < 0)
            if new.any():
                root[src_t][rows[rel][new]] = r[new]
                changed = True
    crossing = late = 0
    for rel in rows:
        src_t, _, dst_t = rel.split("__")
        rs, rd = root[src_t][rows[rel]], root[dst_t][cols[rel]]
        crossing += int((rs != rd).sum())
        if src_t in times:
            late += int((times[src_t][nodes[src_t][rows[rel]]]
                         > root_time[rd]).sum())
    repeated = sum(
        int(v.shape[0] - np.unique(v * max(base, 1) + root[t]).shape[0])
        for t, v in nodes.items())
    return dict(cross_root_edges=crossing, later_sources=late,
                repeated_pairs=repeated,
                unreached=sum(int((r < 0).sum()) for r in root.values()))


def ego_faults(sp, rowptr, col, roots, adj_rowptr, adj_col, n_id, e_id,
               ptr, root_n_id):
    """The faults of a stitched ego batch: ``ptr`` not delimiting one net
    a root, a net's ``n_id`` not sorted and distinct, ``root_n_id`` not
    at its root, a net not equal to scipy's induced subgraph on its
    nodes, edge ids not the edges they stand for."""
    n = rowptr.shape[0] - 1
    A = sp.csr_matrix((np.ones(col.shape[0], np.float32), col, rowptr),
                      shape=(n, n))
    sizes = np.diff(ptr)
    ptr_ok = bool(ptr.shape[0] == roots.shape[0] + 1 and ptr[0] == 0
                  and ptr[-1] == n_id.shape[0] and (sizes > 0).all())
    owner = np.repeat(np.arange(roots.shape[0]), sizes)
    step = np.diff(n_id)
    sorted_ok = bool((step[owner[1:] == owner[:-1]] > 0).all())
    root_ok = bool((root_n_id >= ptr[:-1]).all()
                   and (root_n_id < ptr[1:]).all()
                   and np.array_equal(n_id[root_n_id], roots))
    # Each net's induced subgraph, from scipy's induced subgraph on the
    # union of the nets' nodes (a small matrix to index per net).
    uniq = np.unique(n_id)
    U = A[uniq][:, uniq]
    pos = np.searchsorted(uniq, n_id)
    want = sp.block_diag([U[pos[a:b]][:, pos[a:b]]
                          for a, b in zip(ptr[:-1], ptr[1:])], format="csr")
    got = sp.csr_matrix((np.ones(adj_col.shape[0], np.float32), adj_col,
                         adj_rowptr), shape=want.shape)
    arow = np.repeat(np.arange(adj_rowptr.shape[0] - 1), np.diff(adj_rowptr))
    src = n_id[arow]
    ids_ok = bool(((e_id >= rowptr[src]) & (e_id < rowptr[src + 1])).all()
                  and (col[e_id] == n_id[adj_col]).all())
    return dict(ptr_ok=ptr_ok, n_id_sorted=sorted_ok, root_ok=root_ok,
                nets_equal_induced=not (got != want).nnz, e_id_ok=ids_ok)


def hetero_sage(torch, rels, dims, seed, device):
    """The parameters of PyG's ``to_hetero(GNN, aggr="sum")`` over
    ``SAGEConv((-1, -1), d)`` layers of widths ``dims`` (every type's
    input ``dims[0]`` wide): per layer and relation ``lin_l``'s weight
    and bias and ``lin_r``'s weight, Glorot-uniform from ``seed``, as a
    ``ParameterDict`` keyed ``l<layer>__<rel>__<name>``."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        bound = (6.0 / (din + dout)) ** 0.5
        for rel in rels:
            for name in ("w_l", "b_l", "w_r"):
                t = (torch.zeros(dout) if name == "b_l" else
                     (torch.rand((din, dout), generator=gen) * 2 - 1) * bound)
                params[f"l{i}__{rel}__{name}"] = torch.nn.Parameter(
                    t.to(device))
    return torch.nn.ParameterDict(params)


def hetero_sage_forward(model, rels, n_layers, adjs, xs, agg, relu):
    """``to_hetero``'s forward: each layer, per relation ``lin_l(agg(adj,
    x_src)) + lin_r(x_dst)`` (``adjs[rel]`` is the (dst x src) adjacency),
    summed into the destination type, ReLU between layers.  Returns the
    last layer's output per type."""
    for i in range(n_layers):
        out = {}
        for rel in rels:
            src_t, _, dst_t = rel.split("__")
            w_l, b_l, w_r = (model[f"l{i}__{rel}__{n}"]
                             for n in ("w_l", "b_l", "w_r"))
            h = agg(adjs[rel], xs[src_t]) @ w_l + b_l + xs[dst_t] @ w_r
            out[dst_t] = h if dst_t not in out else out[dst_t] + h
        if i < n_layers - 1:
            out = {t: relu(h) for t, h in out.items()}
        xs = out
    return xs


def random_walk_touched(rowptr, walks, rand):
    """The ``rowptr`` and ``col`` entries that the walks ``walks`` (``(n,
    L+1)``, drawn with ``rand``) read: ``rowptr[u]`` and ``rowptr[u+1]``
    of every node ``u`` stepped from, and the ``col`` position of every
    step off a node of degree > 0, each entry counted once."""
    import torch

    cur = walks[:, :-1].reshape(-1).long()
    lo = rowptr[cur]
    deg = rowptr[cur + 1] - lo
    pos = lo + (rand.reshape(-1) * deg.to(torch.float32)).to(lo.dtype)
    nodes = torch.unique(cur)
    n_rowptr = torch.unique(torch.cat([nodes, nodes + 1])).numel()
    return n_rowptr, torch.unique(pos[deg > 0]).numel()


def random_walk_bounds(rowptr, walks, rand):
    """K12's bound on these inputs: the ``(n, L)`` uniforms and ``start``
    read once, the ``rowptr`` and ``col`` entries that these walks read
    (:func:`random_walk_touched`) once, and the ``(n, L+1)`` walks
    written once; one multiply a step."""
    n, L = rand.shape
    n_rowptr, n_col = random_walk_touched(rowptr, walks, rand)
    nbytes = 4 * n * L + 4 * n + 4 * n_rowptr + 4 * n_col + 4 * n * (L + 1)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, n * L / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def random_walk_gathered_sectors(rowptr, walks):
    """K12's gathered 32-byte sectors on these walks: one of ``rowptr``
    at every step and one of ``col`` at every step off a node of degree
    > 0."""
    cur = walks[:, :-1].reshape(-1).long()
    deg = rowptr[cur + 1] - rowptr[cur]
    return cur.numel() + int((deg > 0).sum())


def edge_scan_bounds(T, K_, R):
    """K13b's bounds for ``R`` passes over a ``(T, K)`` h at the data
    sheet's rates: ``h`` read and ``out`` written once, and a pass's
    operations (h + i, the scan's adds, the accumulation: 3 a element)
    at the FP32 rate.  ``bound_ms`` is the larger of the bytes' and all
    passes' times; ``bound_sum_ms`` their sum (the bytes once a launch
    plus R passes); ``pass_bound_us`` one pass's operations, beside the
    measured slope a pass."""
    t_b = 2 * 4 * T * K_ / HBM_BYTES_PER_S
    t_pass = 3 * T * K_ / FP32_FLOPS_PER_S
    t_f = R * t_pass
    return {"bound_ms": max(t_b, t_f) * 1e3,
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "bound_sum_ms": (t_b + t_f) * 1e3,
            "pass_bound_us": t_pass * 1e6}


def walk_steps_off_graph(keys, deg, M, walks):
    """Steps of ``walks`` (host ``(n, L+1)``) that are neither an edge of
    the graph (``keys``: sorted ``row * M + col``) nor a stay at a node
    of degree 0."""
    u = walks[:, :-1].ravel().astype(np.int64)
    v = walks[:, 1:].ravel().astype(np.int64)
    q = u * M + v
    pos = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    edge = keys[pos] == q
    stay = (deg[u] == 0) & (u == v)
    return int((~(edge | stay)).sum())


def sampled_hop_faults(rowptr, col, frontier, adj, e_id, n_id, k):
    """The faults of one ``sample_adj`` hop over the CSR graph
    ``(rowptr, col)`` (host arrays): sampled edge ids outside their
    row or pointing at another node than their local column, rows that
    hold a column twice, rows with other than ``min(deg, k)`` edges, and
    whether ``n_id`` starts with the frontier."""
    rp = adj.storage.numpy_view("rowptr")
    lc = adj.storage.numpy_view("col")
    owner = np.repeat(np.arange(frontier.shape[0]), np.diff(rp))
    node = frontier[owner]
    bad_e = ~((e_id >= rowptr[node]) & (e_id < rowptr[node + 1])
              & (col[np.clip(e_id, 0, col.shape[0] - 1)] == n_id[lc]))
    dup = (np.diff(lc) <= 0) & (owner[1:] == owner[:-1])
    deg = rowptr[frontier + 1] - rowptr[frontier]
    return dict(bad_edges=int(bad_e.sum()), duplicate_rows=int(dup.sum()),
                wrong_size_rows=int((np.diff(rp) != np.minimum(deg, k)).sum()),
                n_id_prefix_ok=bool(np.array_equal(
                    n_id[:frontier.shape[0]], frontier)))


def shard_bounds(R, E, K_, n_rows_read, out_rows, has_value, accumulate,
                 has_map, minmax=False, has_pos=False):
    """K11a's (and, with ``minmax``, K11b's) bound: each input read once
    (the group's pointer, indices and values, the ``n_rows_read``
    distinct buffer rows its edges reference, ``row_map`` and ``pos``),
    the ``out_rows`` output rows written once, and read too when they
    accumulate or combine; K11b adds the int32 argout beside ``out``."""
    per_out = 4 * K_ * (2 if minmax else 1)
    nbytes = 4 * (R + 1) + 4 * E + (4 * E if has_value else 0) \
        + (4 * R if has_map else 0) + (4 * E if has_pos else 0) \
        + 4 * K_ * n_rows_read + per_out * out_rows * (2 if accumulate
                                                        else 1)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, 2 * E * K_ / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def shard_row_per_edge_ms(R, E, K_, out_rows, accumulate):
    """The bytes count of one K-row of the buffer per edge (the index and
    value, ``out`` read and written once), as a second yardstick beside
    the operand-once bound."""
    nbytes = 4 * (R + 1) + 8 * E + 4 * K_ * E \
        + 4 * K_ * out_rows * (2 if accumulate else 1)
    return nbytes / HBM_BYTES_PER_S * 1e3


class HostMesh:
    """The size, rank and device of one shard of a mesh, without a
    process group: all that ``ShardedSparseMatrix``'s host builder reads,
    so that phase 3 can build shard 0's tables of a four-rank layout in
    this process (no collective runs on it)."""

    def __init__(self, size, rank, device):
        self.size, self.rank, self.device = size, rank, device


class HostGrid:
    """The axis names, shape, rank and device of one process of a grid,
    without a process group: all that ``HierShardedSparseMatrix``'s host
    builder reads, so that phase 3 can build shard 0's hierarchical
    tables in this process."""

    def __init__(self, names, shape, rank, device):
        self.names, self.shape = names, dict(zip(names, shape))
        self.mesh = HostMesh(shape[0] * shape[1], rank, device)
        self.device = device


def _rank_main(rank, fn, world_size, backend, workdir, timeout, args):
    import datetime

    import torch
    import torch.distributed as tdist

    # Join, then wait on the rendezvous file's store until every rank has
    # joined: init_process_group ends without a barrier, and a rank that
    # left early would close its side of a slower rank's gloo handshake
    # ("Connection closed by peer" in connectFullMesh).
    limit = datetime.timedelta(seconds=timeout)
    store = tdist.FileStore(os.path.join(workdir, "rdzv"), world_size)
    store.set_timeout(limit)
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world_size, timeout=limit)
    if store.add("joined", 1) == world_size:
        store.set("all_joined", "1")
    store.wait(["all_joined"])
    try:
        torch.save(fn(rank, world_size, **args),
                   os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        tdist.destroy_process_group()
    # The result is saved.  Leave without the interpreter's teardown,
    # which a gloo group's threads can abort now and then under load.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn_ranks(fn, world_size, backend, args, timeout):
    """Run ``fn(rank, world_size, **args)`` on ``world_size`` fresh
    processes (``torch.multiprocessing``, start method "spawn") joined in
    one ``backend`` group through a rendezvous file in a new temporary
    directory; return each rank's result in rank order.  A failed rank
    raises with its exit code or traceback, and the others are stopped;
    so are all of them when the time runs out."""
    import torch
    import torch.multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, (fn, world_size, backend, workdir, timeout, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise Failure(f"{world_size} ranks of {fn.__name__} timed "
                              f"out after {timeout} s; exit codes "
                              f"{[p.exitcode for p in ctx.processes]}")
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           weights_only=True) for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


@contextlib.contextmanager
def wall_of(owner, name, log):
    """Add the wall seconds of every call of ``owner.name`` made inside
    the block to ``log[name]`` (a measurement hook; the calls run as
    they are)."""
    inner = getattr(owner, name)

    def timed(*a, **k):
        t1 = time.time()
        try:
            return inner(*a, **k)
        finally:
            log[name] = log.get(name, 0.0) + time.time() - t1

    setattr(owner, name, timed)
    try:
        yield log
    finally:
        setattr(owner, name, inner)


def host_peak_bytes():
    """This process's peak resident host memory so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def dist_gcn_forward(model, x, agg, relu):
    """``DistGCN``'s forward written out, with the aggregation
    ``agg(h)`` and the ReLU given."""
    n = len(model.weights)
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        x = agg(x @ w) + b
        if i < n - 1:
            x = relu(x)
    return x


def dist_worker(rank, world_size, coo_path, K_, K2d, widths, grid):
    """Phases 14 and 16 on one of ``world_size`` gloo processes sharing
    the card.  Phase 14, the flat layout: every schedule x reduce with
    both gradients, the hybrid local format and one DistGCN Adam step, on
    the community hybrid graph and its ``gcn_norm``, and the hybrid with
    the dense frontier "always" on the ``FRONTIER_DENSE`` graph (the big
    graph's is over the cap).  Phase 16, on the ``grid`` (S, C) =
    (data, feat) shape: the hierarchical schedule for every reduce
    ("ell" with both gradients, "auto" with the ``x`` gradient), both
    dense frontier tiers "always" on the ``FRONTIER_DENSE`` graph, one
    DistGCN Adam step on the hierarchical layout, and the flat schedules
    on the 2-D (data, feat) grid at ``K2d`` (sum and max, ``x``
    gradient).  The results are gathered to rank 0, which holds them
    against the single-card CSR kernel (K1) and K6 on the whole matrix
    and float64 host oracles, and each DistGCN step against the
    single-card GCN step on the CSR route.  Phase 22, after them: the
    distributed GCN recipe (``train_gcn --distributed`` on the default
    group) flat and with ``--slices RECIPE_DIST_SLICES``, its losses a
    step returned by every rank.  Every rank returns each phase's kernel
    launches (counts set to 0 at the phase's start, rank 0's reference
    launches excluded) and its staged bytes."""
    import torch

    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch.models import DistGCN, GCN
    from pytorch_sparse_tpu_torch.ops.kernels import (
        block_spmm, block_spmm_t, csr_spmm, csr_spmm_minmax, edge_dot,
        minmax_edge_dot, minmax_spmm_t, shard_spmm, shard_spmm_minmax)
    from pytorch_sparse_tpu_torch.ops.matmul import _CsrSum
    from pytorch_sparse_tpu_torch.parallel import (
        HierShardedSparseMatrix, ShardedSparseMatrix, dist_spmm,
        dist_spmm_hier, make_mesh, make_mesh2d, make_mesh_hier)
    from pytorch_sparse_tpu_torch.parallel import _comm

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    counted = {"shard_spmm": shard_spmm,
               "shard_spmm_minmax": shard_spmm_minmax,
               "block_spmm": block_spmm, "block_spmm_t": block_spmm_t,
               "edge_dot": edge_dot, "minmax_edge_dot": minmax_edge_dot,
               "minmax_spmm_t": minmax_spmm_t, "csr_spmm": csr_spmm,
               "csr_spmm_minmax": csr_spmm_minmax}
    excluded = {}

    def reset_counts():
        for n, f in counted.items():
            f.launches = 0
            excluded[n] = 0

    def read_counts():
        return {n: f.launches - excluded[n] for n, f in counted.items()}

    def reference(fn):
        """Run a rank-0 oracle without counting its launches."""
        before = {n: f.launches for n, f in counted.items()}
        out = fn()
        for n, f in counted.items():
            excluded[n] += f.launches - before[n]
        return out

    reset_counts()
    mesh = make_mesh(world_size, device=device)
    hier = make_mesh_hier(*grid, device=device)
    mesh2d = make_mesh2d(*grid, device=device)
    data = np.load(coo_path)
    M = int(data["M"])

    def tensor(prefix):
        M_ = int(data[prefix + "M"])
        return ts.SparseTensor(
            row=data[prefix + "row"], col=data[prefix + "col"],
            value=torch.from_numpy(data[prefix + "val"]),
            sparse_sizes=(M_, M_), is_sorted=True, trust_data=True,
            device="cpu")

    def graph(prefix, name, layout, k=K_, **kw):
        """A graph of the file on ``layout`` (the flat mesh, the
        hierarchical or the 2-D grid), with its ``(M, k)`` operands and
        the CSR of rank 0's oracles."""
        A_ = tensor(prefix)
        M_, st = A_.size(0), A_.storage
        make = (HierShardedSparseMatrix if layout is hier
                else ShardedSparseMatrix)
        g = {"name": name, "A": A_, "layout": layout,
             "sh": make.from_sparse_tensor(A_, layout, **kw),
             "x_full": operand(torch, M_, k, 2, device),
             "gout_full": operand(torch, M_, k, 8, device),
             "value": st.value().to(device),
             "deg": st.rowcount().to(device).clamp_min(1).float()[:, None],
             "rp": torch.from_numpy(st.numpy_view("rowptr").astype(
                 np.int32)).to(device),
             "cl": torch.from_numpy(st.numpy_view("col").astype(
                 np.int32)).to(device)}
        g["x"] = g["sh"].shard_dense(g["x_full"])
        g["gout"] = g["sh"].shard_dense(g["gout_full"])
        return g

    def run_cases(cases, phase, res):
        """Each ``(graph, schedule, local format, reduce, value grad)``
        case: forward and gradients on every rank, gathered and checked
        on rank 0."""
        for g, schedule, fmt, reduce, with_value in cases:
            adj, A, value, deg = g["sh"], g["A"], g["value"], g["deg"]
            x, gout, x_full, gout_full = (g["x"], g["gout"], g["x_full"],
                                          g["gout_full"])
            rp, cl = g["rp"], g["cl"]
            minmax = reduce in ("min", "max")
            xx = x.clone().requires_grad_(True)
            vv = value.clone().requires_grad_(True) if with_value else None
            local_format = "hybrid" if fmt.startswith("hybrid") else fmt
            staged0 = g["layout"].staged_bytes
            sync()
            t1 = time.time()
            if schedule == "hier":
                out = dist_spmm_hier(adj, xx, reduce, local_format, vv)
            else:
                out = dist_spmm(adj, xx, schedule, reduce, local_format, vv)
            out, arg = out if minmax else (out, None)
            sync()
            t2 = time.time()
            grads = torch.autograd.grad(out, [xx] + ([vv] if with_value
                                                     else []), gout)
            sync()
            t3 = time.time()
            case = {"graph": g["name"], "schedule": schedule,
                    "local_format": fmt, "reduce": reduce,
                    "K": x_full.shape[1], "K_per_rank": x.shape[1],
                    "forward_ms": (t2 - t1) * 1e3,
                    "backward_ms": (t3 - t2) * 1e3,
                    "staged_bytes": g["layout"].staged_bytes - staged0,
                    "has_interior_blocks": adj.has_interior_blocks(),
                    "has_frontier_dense": (
                        [adj.fi_dense is not None, adj.fx_dense is not None]
                        if schedule == "hier" else adj.has_frontier_dense())}
            out_f = adj.unshard_dense(out.detach())
            gx_f = adj.unshard_dense(grads[0])
            arg_f = adj.unshard_dense(arg) if minmax else None
            gv = (_comm.all_reduce_sum(adj.world, grads[1]) if with_value
                  else None)
            del out, grads, xx, vv
            if rank == 0:
                g_eff = gout_full / deg if reduce == "mean" else gout_full

                def check():
                    if minmax:
                        ref, ref_arg = csr_spmm_minmax(rp, cl, value, x_full,
                                                       reduce == "min")
                        case["arg_mismatches"] = int((arg_f != ref_arg).sum())
                        case["out_max_abs_err"] = errors(out_f, ref)[0]
                        ok = case["arg_mismatches"] == 0 and \
                            case["out_max_abs_err"] == 0
                    else:
                        ref = csr_spmm(rp, cl, value, x_full)
                        if reduce == "mean":
                            ref = ref / deg
                        case["out_rel_err"] = errors(out_f, ref)[1]
                        ok = case["out_rel_err"] <= GATE_F32
                    ok_x, case["grad_x_rel_err"] = grad_x_oracle_check(
                        A, g_eff, gx_f, GATE_F32, arg=arg_f)
                    ok = ok and ok_x
                    if gv is not None:
                        ok_v, case["grad_v_rel_err"] = grad_v_oracle_check(
                            A, x_full, g_eff, gv, GATE_F32, arg=arg_f)
                        ok = ok and ok_v
                    return ok

                case["ok"] = reference(check)
                if not case["ok"]:
                    res["failures"].append(
                        f"phase {phase} {schedule}/{fmt}/{reduce}: {case}")
            res["cases"].append(case)
            del out_f, gx_f, arg_f, gv

    in_dim, hid, out_dim, nl = widths
    x_g = operand(torch, M, in_dim, 5, device)
    labels = seeded_labels(torch, x_g, out_dim, 6, device)

    def gcn_step(adj, layout, agg, schedule, phase, res):
        """One DistGCN Adam step on ``adj`` (``gcn_norm`` of the graph),
        its loss and gradients against the single-card GCN step on the
        CSR route with this run's ReLU decisions (rank 0), and the
        parameters compared across ranks."""
        xs, ls = adj.shard_dense(x_g), adj.shard_dense(labels)
        mask = adj.shard_dense(torch.ones(M, device=device))
        model = DistGCN(in_dim, hid, out_dim, num_layers=nl,
                        generator=torch.Generator().manual_seed(0),
                        device=device)
        kmasks = []
        with torch.no_grad():
            dist_gcn_forward(model, xs, agg, relu_recorder(torch, kmasks))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        staged0 = layout.staged_bytes
        sync()
        t1 = time.time()
        loss = model.train_step(opt, adj, xs, ls, mask, schedule, "auto")
        sync()
        step_ms = (time.time() - t1) * 1e3
        grads = [p.grad.detach().clone() for p in model.parameters()]
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        every = _comm.all_gather(adj.world, flat[None])
        kmasks = [adj.unshard_dense(m_.to(torch.uint8)).bool()
                  for m_ in kmasks]
        gcn = {"step_ms": step_ms, "staged_bytes": layout.staged_bytes
               - staged0, "loss": float(loss),
               "local_format": ("hybrid" if adj.has_interior_blocks()
                                else "ell"),
               "params_identical_on_every_rank": bool(
                   (every == every[:1]).all())}
        if rank == 0:
            An_dev = ts.SparseTensor(
                row=data["n_row"], col=data["n_col"],
                value=torch.from_numpy(data["n_val"]), sparse_sizes=(M, M),
                is_sorted=True, trust_data=True, device=device)

            def csr_route(rowptr, col, value_, h):
                return _CsrSum.apply(An_dev.storage, value_, h)

            def gcn_reference():
                rm = GCN(in_dim, hid, out_dim, num_layers=nl,
                         generator=torch.Generator().manual_seed(0),
                         device=device)
                cmasks = relu_masks(torch,
                                    lambda a, h: csr_route(*a.csr(), h),
                                    rm, An_dev, x_g)
                flips = sum(int((k_ != c_).sum())
                            for k_, c_ in zip(kmasks, cmasks))
                ref = plain_loss(torch, csr_route, rm, An_dev, x_g, labels,
                                 kmasks)
                ref.backward()
                return ref.item(), [p.grad for p in rm.parameters()], flips

            ref_loss, ref_grads, flips = reference(gcn_reference)
            gcn["loss_rel_err_vs_csr"] = abs(gcn["loss"] - ref_loss) / abs(
                ref_loss)
            gcn["grad_rel_errs_vs_csr"] = [errors(g, r)[1]
                                           for g, r in zip(grads, ref_grads)]
            gcn["relu_flips"] = flips
            gcn["max_relu_flips"] = int(RELU_FLIP_SHARE * M * hid * (nl - 1))
            gcn["ok"] = bool(
                np.isfinite(gcn["loss"])
                and gcn["loss_rel_err_vs_csr"] <= KERNEL_GATE
                and max(gcn["grad_rel_errs_vs_csr"]) <= KERNEL_GATE
                and flips <= gcn["max_relu_flips"]
                and gcn["params_identical_on_every_rank"])
            if not gcn["ok"]:
                res["failures"].append(f"phase {phase} DistGCN step: {gcn}")
        return gcn

    # ---- phase 14: the flat layout --------------------------------------
    t0 = time.time()
    res = {"rank": rank, "cases": [], "failures": []}
    big = graph("", "community hybrid", mesh)
    cases = [(big, s, "ell", r, True) for s in ("allgather", "ring", "halo")
             for r in ("sum", "mean", "min", "max")]
    cases += [(big, "halo", "hybrid", r, False) for r in ("sum", "mean")]
    small = graph("s_", "frontier dense", mesh, frontier_dense="always")
    if not small["sh"].has_frontier_dense():
        res["failures"].append(
            "phase 14: frontier_dense='always' built no dense frontier on "
            "the FRONTIER_DENSE graph")
    cases += [(small, "halo", "hybrid-always", r, False)
              for r in ("sum", "mean")]
    run_cases(cases, 14, res)
    res["build_and_cases_s"] = time.time() - t0
    del big, small, cases
    Ahn = ShardedSparseMatrix.from_sparse_tensor(tensor("n_"), mesh)
    res["dist_gcn"] = gcn_step(
        Ahn, mesh, lambda h: dist_spmm(Ahn, h, "halo", "sum", "auto"),
        "halo", 14, res)
    del Ahn
    res["launches"] = read_counts()
    res["staged_bytes"] = mesh.staged_bytes

    # ---- phase 16: the hierarchical layout and the 2-D grid -------------
    reset_counts()
    t0 = time.time()
    r16 = {"cases": [], "failures": []}
    big = graph("", "community hybrid", hier)
    t1 = time.time()
    big["sh"]._tables
    r16["hier_tables_s"] = time.time() - t1
    hb = big["sh"]
    r16["hier"] = {"S": hb.S, "C": hb.C, "Hi": hb.Hi, "Hx": hb.Hx,
                   "wire_stats": hb.wire_stats,
                   "wire_report": hb.wire_report(K=K_),
                   "has_interior_blocks": hb.has_interior_blocks(),
                   "fi_dense": hb.fi_dense is not None,
                   "fx_dense": hb.fx_dense is not None}
    cases = [(big, "hier", "ell", r, True)
             for r in ("sum", "mean", "min", "max")]
    cases += [(big, "hier", "auto", r, False) for r in ("sum", "mean")]
    small = graph("s_", "frontier dense", hier, frontier_dense="always")
    r16["always_tiers"] = {"fi_dense": small["sh"].fi_dense is not None,
                           "fx_dense": small["sh"].fx_dense is not None}
    if not all(r16["always_tiers"].values()):
        r16["failures"].append(
            "phase 16: frontier_dense='always' did not build both dense "
            f"frontier tiers on the FRONTIER_DENSE graph: "
            f"{r16['always_tiers']}")
    cases += [(small, "hier", "hybrid-always", r, False)
              for r in ("sum", "mean")]
    run_cases(cases, 16, r16)
    del big, small, cases, hb
    Ahn = HierShardedSparseMatrix.from_sparse_tensor(tensor("n_"), hier)
    r16["dist_gcn"] = gcn_step(
        Ahn, hier, lambda h: dist_spmm_hier(Ahn, h, "sum", "auto"), "hier",
        16, r16)
    del Ahn
    r16["launches_hier"] = read_counts()
    g2 = graph("", "community hybrid", mesh2d, k=K2d)
    cases = [(g2, s, "ell", r, False) for s in ("allgather", "ring", "halo")
             for r in ("sum", "max")]
    cases += [(g2, "halo", "hybrid", "sum", False)]
    run_cases(cases, 16, r16)
    del g2, cases
    r16["seconds"] = time.time() - t0
    r16["launches"] = read_counts()
    r16["staged_bytes"] = {"hier": hier.staged_bytes,
                           "2d": mesh2d.staged_bytes}
    res["phase16"] = r16
    res["backend"] = mesh.backend

    # ---- phase 22: the distributed GCN recipe, flat and hierarchical ----
    from pytorch_sparse_tpu_torch.examples import train_gcn

    reset_counts()
    t0 = time.time()
    r22 = {}
    for slices in (1, RECIPE_DIST_SLICES):
        out = train_gcn.main(["--distributed", "--epochs",
                              str(RECIPE_DIST_EPOCHS), "--slices",
                              str(slices)])
        r22[out["schedule"]] = {k_: out[k_] for k_ in (
            "losses", "accuracy", "ms_per_step", "step_ms", "world",
            "slices", "backend", "device")}
    r22["seconds"] = time.time() - t0
    r22["launches"] = read_counts()
    res["phase22"] = r22
    if rank == 0:
        return res
    return {"rank": rank, "launches": res["launches"],
            "staged_bytes": res["staged_bytes"],
            "phase16": {"launches": r16["launches"],
                        "launches_hier": r16["launches_hier"],
                        "staged_bytes": r16["staged_bytes"],
                        "hier_tables_s": r16["hier_tables_s"]},
            "phase22": r22}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 20's graph, batches and roots")
    args = ap.parse_args(argv)
    t_script = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.models import (
        GAT, GCN, GIN, DistGCN, GraphSAGE, gcn_norm, nll_loss)
    from pytorch_sparse_tpu_torch.parallel import (
        HierShardedSparseMatrix, ShardedSparseMatrix, data_axis, dcn_axis,
        dist_spmm, make_mesh, make_mesh_hier)
    from pytorch_sparse_tpu_torch.ops.kernels import (
        block_spmm, block_spmm_dblocks, block_spmm_dblocks_plain,
        block_spmm_plain, block_spmm_t, block_spmm_t_plain,
        build_hybrid_from_tensor, csr_spmm, csr_spmm_minmax,
        csr_spmm_minmax_plain, csr_spmm_plain, edge_dot, edge_dot_plain,
        edge_softmax, edge_softmax_bwd, edge_softmax_bwd_plain,
        edge_softmax_plain, hybrid_spmm, minmax_edge_dot,
        minmax_edge_dot_plain, minmax_spmm_t, minmax_spmm_t_plain,
        block_spgemm_plan, block_spgemm_stream, block_spgemm_window,
        block_spgemm_window_plain, block_spgemm_windows, plan_numeric,
        plan_numeric_plain, random_walk_plain, shard_spmm, shard_spmm_minmax,
        shard_spmm_minmax_plain, shard_spmm_plain)
    from pytorch_sparse_tpu_torch.ops.kernels import (
        random_walk as random_walk_kernel)
    from pytorch_sparse_tpu_torch.sample import MinibatchPrefetcher
    from pytorch_sparse_tpu_torch.examples import (
        train_cluster_gcn, train_gat, train_gcn, train_sage_minibatch)
    from pytorch_sparse_tpu_torch.examples._common import route_name
    from pytorch_sparse_tpu_torch.examples.train_sage_minibatch import (
        sage_forward as sage_hops_forward)
    from pytorch_sparse_tpu_torch.ops.matmul import _CsrSum, _Plan
    from pytorch_sparse_tpu_torch.ops.spgemm import (
        PLAN_MAX_TERMS, _block_split, _dense_part, _row_chunks)
    from pytorch_sparse_tpu_torch.ops.kernels.hybrid import (
        _PRECISION_PARTS, HybridFormat, get_block_precision,
        set_store_budget)
    from pytorch_sparse_tpu_torch.testing import community_graph
    from pytorch_sparse_tpu_torch.benchmarks import probe_vmem_gather
    from pytorch_sparse_tpu_torch.ops.kernels import (
        edge_scan_loop, smem_gather, tiled_spmm)

    device = torch.device("cuda")
    split_parts = _PRECISION_PARTS[get_block_precision()]
    failures = []
    results = {"phases": {}}
    counted = {"csr_spmm": csr_spmm, "block_spmm": block_spmm,
               "block_spmm_t": block_spmm_t, "edge_dot": edge_dot,
               "csr_spmm_minmax": csr_spmm_minmax,
               "minmax_edge_dot": minmax_edge_dot,
               "minmax_spmm_t": minmax_spmm_t, "edge_softmax": edge_softmax,
               "plan_numeric": plan_numeric,
               "block_spgemm_window": block_spgemm_window,
               "block_spmm_dblocks": block_spmm_dblocks,
               "edge_softmax_bwd": edge_softmax_bwd,
               "random_walk": random_walk_kernel, "shard_spmm": shard_spmm,
               "shard_spmm_minmax": shard_spmm_minmax,
               "smem_gather": smem_gather, "edge_scan_loop": edge_scan_loop,
               "tiled_spmm": tiled_spmm}

    def record(phase, **kw):
        results["phases"].setdefault(phase, []).append(kw)
        print(json.dumps({"phase": phase, **kw}), flush=True)

    def timer(fn):
        return time_ms(torch, fn)

    def plain_timer(fn):
        return time_ms(torch, fn, reps=PLAIN_REPS)

    sync = torch.cuda.synchronize

    # ---- 1. device ----------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    record("device", kind=kind, count=count, card=card,
           torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    _build.build()
    logs = {n: [ln for ln in _build.build_log(n).splitlines()
                if "registers" in ln or "spill" in ln]
            for n in _build.SOURCES}
    record("build", seconds=round(time.time() - t0, 2), ptxas=logs,
           host_flags=list(_build.host_flags()))

    # ---- graphs (set-up) -------------------------------------------------
    t0 = time.time()
    Mu, Eu = UNIFORM
    A_u = uniform_graph(ts, Mu, Eu, device)
    A_u1 = uniform_graph(ts, Mu, Eu, device, values=False)
    Mr, Er, nr = REDDIT10
    A_r = community_graph(Mr, Er, n_comm=nr, seed=1, equal_sizes=True,
                          device=device)
    Mh, Eh, nh = HYBRID
    A_h = community_graph(Mh, Eh, n_comm=nh, seed=1, equal_sizes=True,
                          device=device)
    set_store_budget(0.0)
    h32 = A_h.storage.hybrid(K_hint=K)
    if not isinstance(h32, HybridFormat):
        raise Failure(f"community hybrid graph routed to {h32!r}")
    # The uniform graph with self-loops and GCN weights: GCN's adjacency,
    # and GAT's (which reads only its structure).
    A_g = gcn_norm(A_u1)
    for A_ in (A_u, A_u1, A_h, A_r):  # the CSC views of min/max backward
        A_.storage.csc_row()
        A_.storage.colptr()
    Ms, Es, ns = SPGEMM_SMALL
    A_s = community_graph(Ms, Es, n_comm=ns, seed=1, equal_sizes=True,
                          device=device)
    # Phase 9's adjacency: the community hybrid graph's structure after
    # gcn_norm (unit edge weights, as phase 5's), as a block-aligned hybrid
    # on the generator's own community boundaries.
    t1 = time.time()
    A_hn = gcn_norm(A_h.fill_value(1.0))
    partptr = np.linspace(0, Mh, nh + 1).astype(np.int64)
    h9 = build_hybrid_from_tensor(A_hn, B=ALIGNED_B, partptr=partptr)
    h9_s = time.time() - t1
    # Phases 12-13's graph: the ogbn-products-scale synthetic graph,
    # unweighted and coalesced, as the JAX package's products pipeline
    # builds it.
    t1 = time.time()
    Mp, src_p, dst_p = products_graph(PRODUCTS_SCALE)
    products_draw_s = time.time() - t1
    A_p = ts.SparseTensor(row=src_p, col=dst_p, sparse_sizes=(Mp, Mp),
                          device=device).coalesce("add")
    A_p.storage.rowptr()
    del src_p, dst_p
    products_s = time.time() - t1
    record("setup", seconds=round(time.time() - t0, 2),
           uniform_nnz=A_u.nnz(), reddit10_nnz=A_r.nnz(),
           hybrid_nnz=A_h.nnz(), hybrid=repr(h32), gcn_gat_nnz=A_g.nnz(),
           spgemm_small_nnz=A_s.nnz(), aligned_hybrid=repr(h9),
           aligned_hybrid_nnz=A_hn.nnz(), aligned_blocks=h9.nb,
           aligned_M_pad=h9.M_pad,
           aligned_dense_edge_share=h9.dense_nnz / A_hn.nnz(),
           aligned_block_bytes=h9.blocks.numel() * h9.blocks.element_size(),
           aligned_build_s=h9_s, products_scale=PRODUCTS_SCALE,
           products_nodes=Mp, products_nnz=A_p.nnz(),
           products_draw_s=products_draw_s, products_build_s=products_s)

    # ---- 3. kernels against their plain versions -------------------------
    t0 = time.time()
    kernels = []
    try:
        rowptr, col, val = A_u.csr()
        ncols = int(np.unique(A_u.storage.numpy_view("col")).size)
        keep = np.flatnonzero(A_u.storage.numpy_view("row") % 3 != 0)
        A_e = ts.SparseTensor(
            row=A_u.storage.numpy_view("row")[keep],
            col=A_u.storage.numpy_view("col")[keep],
            value=val[torch.from_numpy(keep).to(device)],
            sparse_sizes=(Mu, Mu), is_sorted=True, trust_data=True,
            device=device)
        cases = []
        # Timed: K=128 on the uniform graph (the head case) and on the
        # community hybrid graph (rows of about 67 edges, mostly in L2),
        # K=8 (GAT's heads) and K=1 (gcn_norm's degree), the widths at
        # which the walk puts several rows in a warp.
        A_hc = A_h.csr()
        ncols_h = int(torch.unique(A_hc[1]).numel())
        for label, (rp, cl, vv), k, n_, nc_, timed in [
            ("values K=128", (rowptr, col, val), 128, Mu, ncols, True),
            ("values K=256", (rowptr, col, val), 256, Mu, ncols, False),
            ("values K=40", (rowptr, col, val), 40, Mu, ncols, False),
            ("values K=8", (rowptr, col, val), 8, Mu, ncols, True),
            ("values K=1", (rowptr, col, val), 1, Mu, ncols, True),
            ("ones K=128", (rowptr, col, None), 128, Mu, ncols, False),
            ("ones K=40", (rowptr, col, None), 40, Mu, ncols, False),
            ("empty rows K=40", A_e.csr(), 40, Mu, ncols, False),
            ("community hybrid values K=128", A_hc, 128, Mh, ncols_h, True),
        ]:
            x = operand(torch, n_, k, 2, device)
            got = csr_spmm(rp, cl, vv, x)
            inst = last_instance(csr_spmm)
            ref = csr_spmm_plain(rp, cl, vv, x)
            sync()
            timing = {}
            if timed:
                csr_t = torch.sparse_csr_tensor(rp, cl, vv, (n_, n_))
                E_ = cl.shape[0]
                timing = {
                    "ms": timer(lambda: csr_spmm(rp, cl, vv, x)),
                    "plain_ms": (plain_timer if n_ == Mh else timer)(
                        lambda: csr_spmm_plain(rp, cl, vv, x)),
                    "library_ms": timer(lambda: csr_t @ x)}
                timing["bound_ms"], timing["bound_by"] = csr_bounds(
                    n_, E_, k, nc_, vv is not None)
                timing["bound_ms_row_per_edge"] = shard_row_per_edge_ms(
                    n_, E_, k, n_, False)
                timing["rows"], timing["edges"] = n_, E_
                del csr_t
            cases.append(kernel_case(torch, label, got, ref, failures,
                                     "csr_spmm", instance=inst, **timing))
            del got, ref, x
        kernels.append(kernel_entry(
            "csr_spmm", "csr_spmm.cu", "ops/kernels/ell.py:309", cases,
            "torch.sparse_csr_tensor(...) @ x",
            f"M={Mu} E={Eu} K=128 f32 values"))

        # edge_dot: the grad_value pass, <x[col e], g[row e]> per edge,
        # on the per-edge walk.  Besides the uniform graph (about 7 edges
        # a row) at K=128, GAT's K=8 (a head's width, 16 rows a warp) and
        # K=40 (its output layer, 2 rows a warp), the two community graphs
        # whose value gradients phase 4b takes: rows of about 67 and 494
        # edges.  Each case runs twice and must give the same bits.
        cases = []
        for label, A_, k in [
            ("K=128", A_u, 128),
            ("K=256", A_u, 256),
            ("K=40", A_u, 40),
            ("GAT head K=8", A_u, 8),
            ("empty rows K=40", A_e, 40),
            ("community hybrid K=128", A_h, 128),
            ("community Reddit-10% K=128", A_r, 128),
        ]:
            rp, cl = A_.csr()[:2]
            n_ = A_.sparse_size(0)
            x = operand(torch, n_, k, 2, device)
            g = operand(torch, n_, k, 4, device)
            got = edge_dot(rp, cl, x, g)
            inst = last_instance(edge_dot)
            ref = edge_dot_plain(rp, cl, x, g)
            again = edge_dot(rp, cl, x, g)
            sync()
            if not bits_equal(torch, got, again):
                failures.append(f"edge_dot {label}: two launches differ")
            timing = {}
            if label not in ("K=256", "empty rows K=40"):
                timing = {
                    "ms": timer(lambda: edge_dot(rp, cl, x, g)),
                    "plain_ms": timer(lambda: edge_dot_plain(rp, cl, x, g)),
                    "library_ms": None}
                # The SpMM's bytes and flops: the (E,) output takes the
                # place of the values, the (M, K) g that of the output.
                timing["bound_ms"], timing["bound_by"] = csr_bounds(
                    n_, A_.nnz(), k,
                    int(np.unique(A_.storage.numpy_view("col")).size), True)
            if label == "K=128":
                # cuSPARSE's SDDMM: (g @ x^T) sampled at the pattern.
                try:
                    pattern = torch.sparse_csr_tensor(
                        rp, cl, torch.zeros_like(val), (Mu, Mu))
                    xt = x.t().contiguous()
                    lib_out = torch.sparse.sampled_addmm(
                        pattern, g, xt, beta=0.0).values()
                    timing["library_max_abs_err"] = errors(lib_out, ref)[0]
                    timing["library_ms"] = timer(
                        lambda: torch.sparse.sampled_addmm(
                            pattern, g, xt, beta=0.0))
                except (AttributeError, RuntimeError) as exc:
                    timing["library_missing"] = repr(exc)
            cases.append(kernel_case(torch, label, got, ref, failures,
                                     "edge_dot", instance=inst, **timing))
            del got, ref, again, x, g
        kernels.append(kernel_entry(
            "edge_dot", "edge_dot.cu", "ops/kernels/ell.py:353", cases,
            "torch.sparse.sampled_addmm(csr pattern, g, x^T, beta=0) "
            "(cuSPARSE SDDMM)", f"M={Mu} E={Eu} K=128 f32"))

        B = h32.B
        C = -(-Mh // B)
        R = h32.rb_ptr.shape[0] - 1
        xh = operand(torch, Mh, K, 3, device)
        xb = torch.cat([xh, xh.new_zeros((C * B - Mh, K))])
        gh = operand(torch, Mh, K, 4, device)
        gb = torch.cat([gh, gh.new_zeros((R * B - Mh, K))])
        nb = h32.nb
        slot_row = h32.slot_row.long()
        order_t = h32.order_t.long()
        col_t = h32.slot_col.long()[order_t]
        row_t = slot_row[order_t]
        fwd_cases, t_cases = [], []
        for label, blocks in [("f32 store K=128", h32.blocks),
                              ("bf16 store K=128",
                               h32.blocks.to(torch.bfloat16))]:
            fwd = (blocks, h32.slot_col, h32.rb_ptr, xb)
            got = block_spmm(*fwd)
            ref = block_spmm_plain(*fwd)
            sync()

            def library():
                tmp = torch.bmm(blocks[:nb].float(),
                                xb.view(C, B, K)[h32.slot_col.long()])
                out = torch.zeros((R, B, K), device=device)
                return out.index_add_(0, slot_row, tmp)

            fwd_cases.append(kernel_case(
                torch, label, got, ref, failures, "block_spmm",
                ms=timer(lambda: block_spmm(*fwd)),
                plain_ms=timer(lambda: block_spmm_plain(*fwd)),
                library_ms=timer(library),
                **forward_block_bounds(torch, h32, blocks, K, split_parts)))
            del got, ref

            tr = (blocks, h32.slot_row, h32.order_t, h32.cb_ptr, gb)
            got = block_spmm_t(*tr)
            ref = block_spmm_t_plain(*tr)
            sync()

            def library_t():
                tmp = torch.bmm(blocks[order_t].float().transpose(1, 2),
                                gb.view(R, B, K)[row_t])
                out = torch.zeros((C, B, K), device=device)
                return out.index_add_(0, col_t, tmp)

            t_cases.append(kernel_case(
                torch, label, got, ref, failures, "block_spmm_t",
                ms=timer(lambda: block_spmm_t(*tr)),
                plain_ms=timer(lambda: block_spmm_t_plain(*tr)),
                library_ms=timer(library_t),
                **transpose_block_bounds(torch, h32, blocks, K,
                                         split_parts)))
            del got, ref, blocks, fwd, tr
        # K2 at phase 15's last width (47: an odd K, its operand rows
        # padded to 48 columns for TMA), and with the last row block's
        # slots taken away (the store and the first slots as they are):
        # that row block must come out zero.
        x47 = operand(torch, Mh, 47, 5, device)
        xb47 = torch.cat([x47, x47.new_zeros((C * B - Mh, 47))])
        rb_cut = h32.rb_ptr.clone()
        rb_cut[-1] = rb_cut[-2]
        cut = int(rb_cut[-1])
        for label, fwd in [
                ("f32 store K=47", (h32.blocks, h32.slot_col, h32.rb_ptr,
                                    xb47)),
                ("f32 store K=128, the last row block with no slot",
                 (h32.blocks, h32.slot_col[:cut].contiguous(), rb_cut,
                  xb))]:
            got = block_spmm(*fwd)
            ref = block_spmm_plain(*fwd)
            sync()
            fwd_cases.append(kernel_case(torch, label, got, ref, failures,
                                         "block_spmm"))
            if label.endswith("no slot") and bool(got[-B:].any()):
                failures.append("block_spmm: a row block with no slot is "
                                "not zero")
            del got, ref
        del x47, xb47
        # K5 at K=47 (gb's rows padded to 48 columns for TMA), and with
        # the last column block's slots taken away (a schedule of the
        # other slots over a copy of their blocks): that column block
        # must come out zero.
        g47 = operand(torch, Mh, 47, 6, device)
        gb47 = torch.cat([g47, g47.new_zeros((R * B - Mh, 47))])
        cb_cut = h32.cb_ptr.clone()
        cb_cut[-1] = cb_cut[-2]
        keep = h32.order_t[:int(cb_cut[-1])].long()
        blocks_cut = torch.cat([h32.blocks[keep],
                                h32.blocks.new_zeros((1, B, B))])
        for label, tr in [
                ("f32 store K=47", (h32.blocks, h32.slot_row, h32.order_t,
                                    h32.cb_ptr, gb47)),
                ("f32 store K=128, the last column block with no slot",
                 (blocks_cut, h32.slot_row[keep].contiguous(),
                  torch.arange(keep.numel(), dtype=torch.int32,
                               device=device), cb_cut, gb))]:
            got = block_spmm_t(*tr)
            ref = block_spmm_t_plain(*tr)
            sync()
            t_cases.append(kernel_case(torch, label, got, ref, failures,
                                       "block_spmm_t"))
            if label.endswith("no slot") and bool(got[-B:].any()):
                failures.append("block_spmm_t: a column block with no slot "
                                "is not zero")
            del got, ref, tr
        del g47, gb47, blocks_cut, keep
        shape = f"M={Mh} nb={nb} B={B} K={K} f32 store"
        kernels.append(kernel_entry(
            "block_spmm", "block_spmm.cu", "ops/kernels/hybrid.py:553",
            fwd_cases, "torch.bmm of the gathered blocks + index_add_",
            shape, units="tensor cores (TF32 wgmma, 3xTF32)"))
        kernels.append(kernel_entry(
            "block_spmm_t", "block_spmm.cu", "ops/kernels/hybrid.py:763",
            t_cases, "torch.bmm of the gathered transposed blocks + "
            "index_add_", shape,
            units="tensor cores (TF32 wgmma, 3xTF32; the block transposed "
            "by the consumers)"))
        del xb, gb
    except Exception:
        failures.append("phase 3 (kernels): " + traceback.format_exc())

    # block_spmm_dblocks (K5b) on phase 9's block-aligned hybrid at its
    # aggregation widths: the forward pass's form (P = grad_out, Q = x)
    # and the transpose pass's (P = g, Q = grad_out) differ only in their
    # operands.  The f32 store's sums are held against the plain version;
    # the bf16 store must equal those sums rounded once to bf16 (the same
    # kernel arithmetic, cast at the end), and its rounding is reported.
    # Then a ragged case, B=100 and K=70, against the plain version.
    try:
        B9, nb9 = h9.B, h9.nb
        rows9 = (h9.rb_ptr.shape[0] - 1) * B9
        sr9, sc9 = h9.slot_row, h9.slot_col
        k5b_cases = []
        for k in K5B_KS:
            for form, seeds in (("forward form", (64, 65)),
                                ("transpose form", (66, 67))):
                pq = (operand(torch, rows9, k, seeds[0], device),
                      operand(torch, rows9, k, seeds[1], device))
                got = block_spmm_dblocks(*pq, sr9, sc9, B9, torch.float32)
                ref = block_spmm_dblocks_plain(*pq, sr9, sc9, B9,
                                               torch.float32)
                got16 = block_spmm_dblocks(*pq, sr9, sc9, B9, torch.bfloat16)
                sync()
                same16 = bool(torch.equal(got16, got.to(torch.bfloat16)))
                rnd16 = errors(got16, ref)[1]
                timing = {}
                if form == "forward form":  # timed at each width
                    def library(pq=pq, k=k):
                        pv, qv = (t.view(-1, B9, k) for t in pq)
                        return torch.bmm(pv[sr9.long()],
                                         qv[sc9.long()].transpose(1, 2))

                    b16 = dblocks_bounds(
                        torch, nb9, B9, k, rows9, rows9, torch.bfloat16)
                    timing = {
                        "ms": timer(lambda: block_spmm_dblocks(
                            *pq, sr9, sc9, B9, torch.float32)),
                        "plain_ms": timer(lambda: block_spmm_dblocks_plain(
                            *pq, sr9, sc9, B9, torch.float32)),
                        "library_ms": timer(library),
                        **dblocks_bounds(torch, nb9, B9, k, rows9, rows9,
                                         torch.float32),
                        "bf16_store_ms": timer(lambda: block_spmm_dblocks(
                            *pq, sr9, sc9, B9, torch.bfloat16)),
                        **{f"bf16_store_{key}": v for key, v in b16.items()}}
                case = kernel_case(
                    torch, f"{form} K={k} f32 store (bf16 store: the same "
                    "sums rounded once)", got, ref, failures,
                    "block_spmm_dblocks", bf16_equals_rounded_f32=same16,
                    bf16_rel_err_vs_plain=rnd16, **timing)
                if not same16:
                    case["ok"] = False
                    failures.append(f"block_spmm_dblocks {form} K={k}: the "
                                    "bf16 store is not the f32 sums rounded")
                k5b_cases.append(case)
                del got, ref, got16, pq
        rng = np.random.RandomState(68)
        keys = np.sort(rng.choice(30, 17, replace=False))
        srr, scr = (torch.from_numpy(a.astype(np.int32)).to(device)
                    for a in (keys // 5, keys % 5))
        pq = (operand(torch, 600, 70, 69, device),
              operand(torch, 500, 70, 70, device))
        got = block_spmm_dblocks(*pq, srr, scr, 100, torch.float32)
        ref = block_spmm_dblocks_plain(*pq, srr, scr, 100, torch.float32)
        sync()
        k5b_cases.append(kernel_case(torch, "ragged B=100 K=70", got, ref,
                                     failures, "block_spmm_dblocks"))
        if not bool((got[-1] == 0).all()):
            failures.append("block_spmm_dblocks: the zero slot got a "
                            "gradient")
        kernels.append(kernel_entry(
            "block_spmm_dblocks", "block_spmm.cu",
            "ops/kernels/hybrid.py:696", k5b_cases,
            "torch.bmm(P_blocks[slot_row], Q_blocks[slot_col]^T), TF32 off",
            f"aligned hybrid M_pad={h9.M_pad} nb={nb9} B={B9} "
            f"K={K5B_KS[0]} f32 store",
            units="tensor cores (TF32 wgmma, 3xTF32)"))
        del got, ref, pq
    except Exception:
        failures.append("phase 3 (block_spmm_dblocks): "
                        + traceback.format_exc())

    # csr_spmm_minmax (K6, min and max) and its backward halves (K7a
    # minmax_edge_dot and K7b minmax_spmm_t, on the max argout).  K6's
    # out and arg must equal the plain version's exactly; K7a and K7b
    # sum in another order (KERNEL_GATE).  No single PyTorch call
    # computes an argout, so these have no library time.
    no_library = "none: no single PyTorch call computes the argout"
    try:
        int_x = torch.from_numpy(np.random.RandomState(14).randint(
            -2, 3, (Mu, K)).astype(np.float32)).to(device)
        k6_cases, k7a_cases, k7b_cases = [], [], []
        for label, A_, k, x_, dtype in [
            ("values K=128", A_u, 128, None, torch.float32),
            ("values K=256", A_u, 256, None, torch.float32),
            ("values K=40", A_u, 40, None, torch.float32),
            ("ones K=128", A_u1, 128, None, torch.float32),
            ("ones K=256", A_u1, 256, None, torch.float32),
            ("ones K=40", A_u1, 40, None, torch.float32),
            ("empty rows K=40", A_e, 40, None, torch.float32),
            ("ties: integer operand, ones K=128", A_u1, 128, int_x,
             torch.float32),
            ("values K=128 bf16", A_u, 128, None, torch.bfloat16),
            ("community hybrid K=128", A_h, 128, None, torch.float32),
            ("community Reddit-10% K=128", A_r, 128, None, torch.float32),
        ]:
            st_ = A_.storage
            rp, cl, vv = A_.csr()
            m_, n_ = A_.sparse_sizes()
            x = operand(torch, n_, k, 2, device) if x_ is None else x_
            x = x.to(dtype)
            ncols = int(np.unique(st_.numpy_view("col")).size)
            bound_ms, bound_by = minmax_bounds(m_, A_.nnz(), k, ncols,
                                               vv is not None,
                                               x.element_size())
            arg_by_min = {}
            for is_min in (False, True):
                name = f"{'min' if is_min else 'max'} {label}"
                got, arg = csr_spmm_minmax(rp, cl, vv, x, is_min)
                inst = last_instance(csr_spmm_minmax)
                ref, ref_arg = csr_spmm_minmax_plain(rp, cl, vv, x, is_min)
                again, arg_again = csr_spmm_minmax(rp, cl, vv, x, is_min)
                sync()
                abs_e, rel_e = errors(got, ref)
                mism = int((arg != ref_arg).sum())
                same_bits = bits_equal(torch, got, again) and \
                    torch.equal(arg, arg_again)
                ok = mism == 0 and abs_e == 0.0 and same_bits
                if not ok:
                    failures.append(f"csr_spmm_minmax {name}: {mism} arg "
                                    f"mismatches, out abs err {abs_e:.3g}, "
                                    f"two launches equal: {same_bits}")
                k6_cases.append({
                    "case": name, "max_abs_err": abs_e, "max_rel_err": rel_e,
                    "arg_mismatches": mism, "instance": inst, "ok": ok,
                    "ms": timer(lambda: csr_spmm_minmax(rp, cl, vv, x,
                                                        is_min)),
                    "plain_ms": plain_timer(lambda: csr_spmm_minmax_plain(
                        rp, cl, vv, x, is_min)),
                    "library_ms": None, "bound_ms": bound_ms,
                    "bound_by": bound_by})
                arg_by_min[is_min] = arg
                del got, ref, ref_arg, again, arg_again
            if dtype != torch.float32:
                continue  # the backward kernels take f32
            arg = arg_by_min[False]
            g = operand(torch, m_, k, 4, device)
            (b7a, by7a), (b7b, by7b) = minmax_bwd_bounds(
                torch, cl, arg, n_, vv is not None)
            got = minmax_edge_dot(rp, cl, x, g, arg)
            inst = last_instance(minmax_edge_dot)
            ref = minmax_edge_dot_plain(rp, cl, x, g, arg)
            if not bits_equal(torch, got, minmax_edge_dot(rp, cl, x, g, arg)):
                failures.append(f"minmax_edge_dot {label}: two launches "
                                "differ")
            sync()
            k7a_cases.append(kernel_case(
                torch, label, got, ref, failures, "minmax_edge_dot",
                instance=inst,
                ms=timer(lambda: minmax_edge_dot(rp, cl, x, g, arg)),
                plain_ms=plain_timer(
                    lambda: minmax_edge_dot_plain(rp, cl, x, g, arg)),
                library_ms=None, bound_ms=b7a, bound_by=by7a))
            t_args = (st_.colptr(), st_.csc_row(), st_.csr2csc(), vv, g, arg)
            got = minmax_spmm_t(*t_args)
            inst = last_instance(minmax_spmm_t)
            ref = minmax_spmm_t_plain(*t_args)
            sync()
            k7b_cases.append(kernel_case(
                torch, label, got, ref, failures, "minmax_spmm_t",
                instance=inst, ms=timer(lambda: minmax_spmm_t(*t_args)),
                plain_ms=plain_timer(lambda: minmax_spmm_t_plain(*t_args)),
                library_ms=None, bound_ms=b7b, bound_by=by7b))
            del got, ref, arg_by_min, arg, g, x, t_args
        shape = f"M={Mu} E={Eu} K=128 f32 values, max"
        kernels.append(kernel_entry(
            "csr_spmm_minmax", "spmm_minmax.cu", "ops/kernels/ell.py:496",
            k6_cases, no_library, shape))
        kernels.append(kernel_entry(
            "minmax_edge_dot", "spmm_minmax.cu", "ops/kernels/ell.py:383",
            k7a_cases, no_library, shape))
        kernels.append(kernel_entry(
            "minmax_spmm_t", "spmm_minmax.cu", "ops/kernels/ell.py:383",
            k7b_cases, no_library, shape))
        del A_e, int_x

        # edge_softmax (K8) on GAT's graph (the uniform graph with
        # self-loops) and the community hybrid graph, at 8 heads and 1;
        # the library yardstick is torch.sparse.softmax over the (M, N, H)
        # hybrid COO tensor.
        sm_cases = []
        for label, A_, H, off in [
                ("uniform + self-loops H=8", A_g, 8, 0),
                ("uniform + self-loops H=1", A_g, 1, 0),
                ("community hybrid H=8", A_h, 8, 0),
                ("community hybrid H=1", A_h, 1, 0),
                ("uniform + self-loops H=1, logits 4 bytes off 16 (the "
                 "edges instance)", A_g, 1, 1)]:
            rp = A_.storage.rowptr()
            m_, n_ = A_.sparse_sizes()
            logits = operand(torch, A_.nnz(), H, 15, device) * 2.0
            if off:
                flat = torch.empty(logits.numel() + off, device=device)
                logits = flat[off:].view(logits.shape).copy_(logits)
            got = edge_softmax(rp, logits)
            inst = last_instance(edge_softmax)
            ref = edge_softmax_plain(rp, logits)
            if not bits_equal(torch, got, edge_softmax(rp, logits)):
                failures.append(f"edge_softmax {label}: two launches "
                                "differ")
            sync()
            nbytes = 4 * (m_ + 1) + 8 * A_.nnz() * H
            timing = {"instance": inst,
                      "ms": timer(lambda: edge_softmax(rp, logits)),
                      "plain_ms": plain_timer(
                          lambda: edge_softmax_plain(rp, logits)),
                      "library_ms": None,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes"}
            try:
                S = torch.sparse_coo_tensor(
                    torch.stack([A_.storage.row().long(),
                                 A_.storage.col().long()]),
                    logits, (m_, n_, H)).coalesce()
                lib_out = torch.sparse.softmax(S, 1)
                if S._nnz() == A_.nnz():  # same edges in the same order
                    timing["library_max_abs_err"] = errors(
                        lib_out.values(), ref)[0]
                timing["library_ms"] = timer(
                    lambda: torch.sparse.softmax(S, 1))
                del S, lib_out
            except (RuntimeError, NotImplementedError) as exc:
                timing["library_missing"] = repr(exc)
            sm_cases.append(kernel_case(torch, label, got, ref, failures,
                                        "edge_softmax", **timing))
            del got, ref, logits
        kernels.append(kernel_entry(
            "edge_softmax", "edge_softmax.cu", "ops/kernels/ell.py:462",
            sm_cases, "torch.sparse.softmax over the (M, N, H) hybrid COO "
            "tensor", f"M={Mu} E={A_g.nnz()} H=8 f32"))

        # edge_softmax_bwd (K8b) on GAT's graph at 8 heads, 1 and 3 (the
        # generic loop): p from K8, a seeded output gradient.  The library
        # yardstick is torch's sparse softmax backward on the (M, N, H)
        # hybrid COO tensors of the logits, p and g.
        sb_cases = []
        rp = A_g.storage.rowptr()
        m_, n_ = A_g.sparse_sizes()
        for H in K8B_HEADS:
            logits = operand(torch, A_g.nnz(), H, 15, device) * 2.0
            p_ = edge_softmax(rp, logits)
            g_ = operand(torch, A_g.nnz(), H, 71, device)
            got = edge_softmax_bwd(rp, p_, g_)
            ref = edge_softmax_bwd_plain(rp, p_, g_)
            sync()
            timing = {"ms": timer(lambda: edge_softmax_bwd(rp, p_, g_)),
                      "plain_ms": plain_timer(
                          lambda: edge_softmax_bwd_plain(rp, p_, g_)),
                      "library_ms": None,
                      "bound_ms": (4 * (m_ + 1) + 12 * A_g.nnz() * H)
                      / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes"}
            try:
                idx = torch.stack([A_g.storage.row().long(),
                                   A_g.storage.col().long()])
                S = torch.sparse_coo_tensor(idx, logits,
                                            (m_, n_, H)).coalesce()
                S_out = torch.sparse.softmax(S, 1)
                vals = g_ if S._nnz() == A_g.nnz() else torch.randn_like(
                    S_out.values())
                S_g = torch.sparse_coo_tensor(S.indices(), vals, S.shape)
                lib_out = torch._sparse_softmax_backward_data(S_g, S_out, 1,
                                                              S)
                if S._nnz() == A_g.nnz():  # same edges in the same order
                    timing["library_max_abs_err"] = errors(
                        lib_out.coalesce().values(), ref)[0]
                timing["library_ms"] = timer(
                    lambda: torch._sparse_softmax_backward_data(
                        S_g, S_out, 1, S))
                del S, S_out, S_g, lib_out
            except (RuntimeError, NotImplementedError, AttributeError) as exc:
                timing["library_missing"] = repr(exc)
            sb_cases.append(kernel_case(
                torch, f"uniform + self-loops H={H}", got, ref, failures,
                "edge_softmax_bwd", **timing))
            del got, ref, logits, p_, g_
        kernels.append(kernel_entry(
            "edge_softmax_bwd", "edge_softmax.cu",
            "ops/kernels/ell.py:462", sb_cases,
            "torch._sparse_softmax_backward_data over the (M, N, H) hybrid "
            "COO tensors", f"M={Mu} E={A_g.nnz()} H=8 f32"))
    except Exception:
        failures.append("phase 3 (min/max and softmax kernels): "
                        + traceback.format_exc())

    # plan_numeric (K9) on the A_g @ A_g plan: the forward with f32
    # values, with one side implicit ones and with bf16 values, and both
    # backward orderings (grad_C through each term's output entry, the
    # terms re-sorted by A entry and by B entry).  The yardstick is
    # cuSPARSE's whole product of the two CSR tensors, structure included.
    try:
        t1 = time.time()
        plan_g = _Plan(A_g, A_g)
        plan_host_s = time.time() - t1
        vg = A_g.storage.value()
        a_pos, b_pos, t_ptr = (plan_g.dev(n) for n in ("a_pos", "b_pos",
                                                       "t_ptr"))
        T, n_out, E_g = a_pos.shape[0], plan_g.n_out, A_g.nnz()
        grad_c = operand(torch, n_out, 1, 17, device)[:, 0].contiguous()
        by_a, by_b = plan_g._by("a"), plan_g._by("b")
        k9_cases = []
        for label, pargs, shape in [
            ("A_g @ A_g f32", (vg, a_pos, vg, b_pos, t_ptr), (E_g, E_g)),
            ("A_g @ A_g one side None", (vg, a_pos, None, None, t_ptr),
             (E_g, 0)),
            ("A_g @ A_g bf16", (vg.bfloat16(), a_pos, vg.bfloat16(), b_pos,
                                t_ptr), (E_g, E_g)),
            ("backward: terms by A entry", (grad_c, by_a[0], vg, by_a[1],
                                            by_a[2]), (n_out, E_g)),
            ("backward: terms by B entry", (grad_c, by_b[0], vg, by_b[1],
                                            by_b[2]), (n_out, E_g)),
        ]:
            got = plan_numeric(*pargs)
            ref = plan_numeric_plain(*pargs)
            sync()
            n_o = pargs[4].shape[0] - 1
            bound_ms, bound_by = plan_numeric_bounds(
                shape[0], shape[1], T, n_o, pargs[0].element_size(),
                pargs[2] is not None)
            timing = {"ms": timer(lambda: plan_numeric(*pargs)),
                      "plain_ms": plain_timer(
                          lambda: plan_numeric_plain(*pargs)),
                      "library_ms": None, "bound_ms": bound_ms,
                      "bound_by": bound_by}
            if label == "A_g @ A_g f32":
                timing["structure_host_s"] = plan_host_s
                try:
                    # duplicate edges merged first: a CSR tensor must
                    # not hold them (the same matrix, so the same product)
                    S_g = torch.sparse_coo_tensor(
                        torch.stack([A_g.storage.row().long(),
                                     A_g.storage.col().long()]), vg,
                        A_g.sizes()).coalesce().to_sparse_csr()
                    lib_nnz = torch.sparse.mm(S_g, S_g)._nnz()
                    timing["library_ms"] = timer(
                        lambda: torch.sparse.mm(S_g, S_g))
                    timing["library_nnz"] = int(lib_nnz)
                    del S_g
                except (RuntimeError, NotImplementedError) as exc:
                    timing["library_missing"] = repr(exc)
            k9_cases.append(kernel_case(torch, label, got, ref, failures,
                                        "plan_numeric", **timing))
            del got, ref
        kernels.append(kernel_entry(
            "plan_numeric", "plan_numeric.cu", "ops/matmul.py:606",
            k9_cases, "torch.sparse.mm(csr, csr): the whole product, "
            "structure included (cuSPARSE SpGEMM)",
            f"A_g @ A_g: E={E_g} T={T} n_out={n_out} f32"))
        del plan_g, by_a, by_b, grad_c, a_pos, b_pos, t_ptr
    except Exception:
        failures.append("phase 3 (plan_numeric): " + traceback.format_exc())

    # block_spgemm_window (K10) on the D@D share of the community hybrid
    # graph (f32 and bf16 stores) and of the Reddit-10% graph, in windows
    # of SPGEMM_WINDOW output blocks; 8 sampled output blocks of the
    # hybrid graph also against float64 host products of the same
    # (for bf16, the rounded) operands.
    try:
        k10_cases = []
        for label, A_, Bb_ in [
                ("community hybrid", A_h, SPGEMM_BB),
                ("community Reddit-10%", A_r, SPGEMM_BB),
                (f"8c's community graph, Bb={SPGEMM_RAGGED_BB}", A_s,
                 SPGEMM_RAGGED_BB)]:
            ragged = Bb_ != SPGEMM_BB
            blocks32, srow, scol = _block_split(
                A_, Bb_, SPGEMM_DENSITY,
                torch.bfloat16 if ragged else None)[:3]
            bplan = block_spgemm_plan(srow, scol, srow, scol)
            ai, bi, oseg, n_tot = bplan[0], bplan[1], bplan[2], len(bplan[3])
            wins = [w[2:] for w in block_spgemm_windows(
                bplan, SPGEMM_WINDOW, device)]
            # The ragged case: a bf16 store whose 100-value rows are not
            # 16 bytes, padded once by the split.
            stores = [("bf16 store" if ragged else "f32 store", blocks32)]
            if A_ is A_h:
                stores.append(("bf16 store", blocks32.to(torch.bfloat16)))
            for store, blocks in stores:
                def run(fn, blocks=blocks):
                    return [fn(blocks, blocks, *w) for w in wins]

                def library(blocks=blocks):
                    outs = []
                    for a_, b_, sp_, n_ in wins:
                        prod = torch.bmm(blocks[a_.long()].float(),
                                         blocks[b_.long()].float())
                        seg = torch.repeat_interleave(
                            torch.arange(n_, device=device),
                            sp_[1:] - sp_[:-1])
                        out = torch.zeros((n_,) + prod.shape[1:],
                                          device=device)
                        outs.append(out.index_add_(0, seg, prod))
                    return outs

                got = torch.cat(run(block_spgemm_window))
                ref = torch.cat(run(block_spgemm_window_plain))
                sync()
                timing = {
                    "ms": timer(lambda: run(block_spgemm_window)),
                    "plain_ms": plain_timer(
                        lambda: run(block_spgemm_window_plain)),
                    "library_ms": plain_timer(library),
                    **block_spgemm_bounds(torch, blocks, ai.shape[0], n_tot),
                    "blocks": int(blocks.shape[0]), "pairs": int(ai.shape[0]),
                    "out_blocks": int(n_tot), "windows": len(wins)}
                if A_ is A_h:
                    # float64 host products of 8 sampled output blocks
                    pick = np.random.RandomState(18).choice(n_tot, 8, False)
                    worst = 0.0
                    for o in pick:
                        ps = np.flatnonzero(oseg == o)
                        ha = blocks[torch.from_numpy(ai[ps]).to(
                            device)].double().cpu().numpy()
                        hb = blocks[torch.from_numpy(bi[ps]).to(
                            device)].double().cpu().numpy()
                        host = np.tensordot(ha, hb, axes=([0, 2], [0, 1]))
                        diff = np.abs(got[o].double().cpu().numpy() - host)
                        worst = max(worst, float(diff.max()
                                                 / np.abs(host).max()))
                    timing["host_f64_rel_err_8_blocks"] = worst
                    if worst > KERNEL_GATE:
                        failures.append(f"block_spgemm_window {label} "
                                        f"{store}: {worst:.3g} against "
                                        "float64 host products")
                k10_cases.append(kernel_case(
                    torch, f"{label} {store}", got, ref, failures,
                    "block_spgemm_window", **timing))
                del got, ref
            del blocks32, stores, wins
        kernels.append(kernel_entry(
            "block_spgemm_window", "block_spgemm.cu",
            "ops/kernels/block_spgemm.py:88", k10_cases,
            "torch.bmm over the gathered pairs (f32, TF32 off) + "
            "index_add_", f"community hybrid D@D: Bb={SPGEMM_BB} "
            f"min_density={SPGEMM_DENSITY} f32 store",
            units="tensor cores (TF32 wgmma, 3xTF32; one TF32 product for "
            "bf16 stores)"))
    except Exception:
        failures.append("phase 3 (block_spgemm_window): "
                        + traceback.format_exc())

    # random_walk (K12) at PyG's Node2Vec configuration (p = q = 1,
    # walk_length 20, 10 walks a node) on the uniform graph: 1,693,430
    # walks, timed.  Then at GraphSAINT's length (3 steps from 20,000
    # roots) on the same graph, timed, and on two graphs with rows of
    # degree 0: the uniform graph with every third row emptied, and a
    # small graph.  The walks must equal the plain version's exactly, and
    # two launches each other's.
    try:
        L_w, per_node = NODE2VEC
        n_roots, L_saint, _ = SAINT
        gen_w = torch.Generator(device=device).manual_seed(21)
        rng_w = np.random.RandomState(22)
        small = ts.SparseTensor(
            row=rng_w.randint(0, 800, 6000), col=rng_w.randint(0, 1000, 6000),
            sparse_sizes=(1000, 1000), device=device)
        keep = np.flatnonzero(A_u.storage.numpy_view("row") % 3 != 0)
        A_sink = ts.SparseTensor(
            row=A_u.storage.numpy_view("row")[keep],
            col=A_u.storage.numpy_view("col")[keep], sparse_sizes=(Mu, Mu),
            is_sorted=True, trust_data=True, device=device)

        def every_node(n_, times):
            return torch.arange(n_, dtype=torch.int32,
                                device=device).repeat(times)

        saint_roots = torch.from_numpy(rng_w.randint(
            0, Mu, n_roots).astype(np.int32)).to(device)
        rw_cases = []
        for label, A_, start, L_ in [
                ("node2vec uniform", A_u, every_node(Mu, per_node), L_w),
                (f"uniform, L={L_saint} from {n_roots} roots", A_u,
                 saint_roots, L_saint),
                ("uniform, every third row empty", A_sink, every_node(Mu, 1),
                 L_w),
                ("small graph, 200 rows empty", small, every_node(1000, 3),
                 L_w)]:
            rp, cl = A_.csr()[:2]
            rand = torch.rand((start.shape[0], L_), generator=gen_w,
                              device=device)
            got = random_walk_kernel(rp, cl, start, rand)
            again = random_walk_kernel(rp, cl, start, rand)
            ref = random_walk_plain(rp, cl, start, rand)
            sync()
            n_diff = int((got != ref).sum())
            repeat_ok = bool(torch.equal(got, again))
            if n_diff or not repeat_ok:
                failures.append(f"random_walk {label}: {n_diff} walk entries "
                                "differ from the plain version's; two "
                                f"launches equal: {repeat_ok}")
            abs_e, rel_e = errors(got, ref)
            case = {"case": label, "walks": int(start.shape[0]),
                    "walk_length": L_, "entries_differing": n_diff,
                    "launches_bit_equal": repeat_ok,
                    "max_abs_err": abs_e, "max_rel_err": rel_e,
                    "ok": n_diff == 0 and repeat_ok}
            if A_ is A_u:
                case.update(
                    ms=timer(lambda: random_walk_kernel(rp, cl, start, rand)),
                    device_ms=probe_vmem_gather.device_ms(
                        lambda: random_walk_kernel(rp, cl, start, rand), got),
                    plain_ms=timer(lambda: random_walk_plain(rp, cl, start,
                                                             rand)),
                    library_ms=None)
                case["bound_ms"], case["bound_by"] = random_walk_bounds(
                    rp, got, rand)
                case["gathered_sectors"] = random_walk_gathered_sectors(
                    rp, got)
            rw_cases.append(case)
            del got, again, ref, rand, start
        del A_sink, small, saint_roots
        entry = kernel_entry(
            "random_walk", "random_walk.cu", "sample/rw.py:21", rw_cases,
            "none (no PyTorch call computes a random walk)",
            f"{Mu * per_node} walks of {L_w} steps on M={Mu} E={Eu}")
        entry.update({k_: rw_cases[0][k_] for k_ in (
            "device_ms", "gathered_sectors")})
        kernels.append(entry)
    except Exception:
        failures.append("phase 3 (random_walk): " + traceback.format_exc())

    # K11a and K11b on shard 0's groups of the community hybrid graph at
    # P = 4 (its tables built in this process: the host builder reads only
    # the layout's size, rank and device): the interior against the
    # shard's block of x, the halo frontier against a received buffer,
    # and ring group q = 1 against block 1, written, accumulated and
    # combined, at K = 128 and 256 (timed; 256 is the width of the GCN
    # layers of phases 14-15) and 40.
    try:
        shard0 = ShardedSparseMatrix.from_sparse_tensor(
            A_h, HostMesh(DIST_WORLD, 0, device))
        hl0 = shard0._halo
        it0, fr0, rg0 = hl0.interior, hl0.frontier, shard0._ring[1]
        Mb0, Nb0, PH0 = shard0.Mb, shard0.Nb, DIST_WORLD * hl0.H

        def n_read(grp):
            return int(torch.unique(grp.col).numel())

        def csr_of(grp, n_cols):
            R_ = grp.rowptr.shape[0] - 1
            return torch.sparse_csr_tensor(grp.rowptr, grp.col, grp.value,
                                           (R_, n_cols))

        sum_cases, mm_cases = [], []
        for k in (128, 256, 40):
            xb0 = operand(torch, Nb0, k, 31, device)
            halo0 = operand(torch, PH0, k, 32, device)
            base = operand(torch, Mb0, k, 33, device)
            timed = k != 40
            specs = [("interior, write", it0, xb0, None, Nb0),
                     ("halo frontier, accumulate", fr0, halo0, base, PH0),
                     ("ring group q=1, accumulate", rg0, xb0, base, Nb0)]
            for label, grp, buf, acc, n_cols in specs:
                sargs = (grp.rowptr, grp.col, grp.value, buf)
                kw = dict(row_map=grp.row_map, n_rows=Mb0)

                def run(fn, acc=acc, sargs=sargs, kw=kw):
                    if acc is None:
                        return fn(*sargs, **kw)
                    return fn(*sargs, out=acc.clone(), row_map=kw["row_map"])

                got = run(shard_spmm)
                inst = last_instance(shard_spmm)
                ref = run(shard_spmm_plain)
                sync()
                timing = {"instance": inst}
                if timed and label != "ring group q=1, accumulate":
                    A_csr = csr_of(grp, n_cols)
                    R_, E_ = grp.rowptr.shape[0] - 1, grp.nnz
                    acc_ = acc is not None
                    if acc_:
                        out_t = acc.clone()
                        rm_l = grp.row_map.long()

                        def library(A_csr=A_csr, buf=buf, out_t=out_t,
                                    rm_l=rm_l):
                            return out_t.index_add_(0, rm_l, A_csr @ buf)

                        def kernel(sargs=sargs, out_t=out_t, grp=grp):
                            return shard_spmm(*sargs, out=out_t,
                                              row_map=grp.row_map)

                        def plain(sargs=sargs, out_t=out_t, grp=grp):
                            return shard_spmm_plain(*sargs, out=out_t,
                                                    row_map=grp.row_map)
                    else:
                        def library(A_csr=A_csr, buf=buf):
                            return A_csr @ buf

                        def kernel(sargs=sargs):
                            return shard_spmm(*sargs)

                        def plain(sargs=sargs):
                            return shard_spmm_plain(*sargs)
                    timing.update(ms=timer(kernel), plain_ms=timer(plain),
                                  library_ms=timer(library))
                    timing["bound_ms"], timing["bound_by"] = shard_bounds(
                        R_, E_, k, n_read(grp), R_, True, acc_,
                        grp.row_map is not None)
                    timing["bound_ms_row_per_edge"] = shard_row_per_edge_ms(
                        R_, E_, k, R_, acc_)
                    timing["rows"], timing["edges"] = R_, E_
                sum_cases.append(kernel_case(
                    torch, f"{label} K={k}", got, ref, failures,
                    "shard_spmm", **timing))
                del got, ref
            # K11b: the interior's max written, the frontier's max
            # combined into it, and ring group 1's min combined into the
            # interior's min: out and arg exactly equal to the plain
            # version's.
            e0 = shard0.e0
            for label, grp, buf, is_min, into in [
                    ("interior max, write", it0, xb0, False, None),
                    ("halo frontier max, combine", fr0, halo0, False, "max"),
                    ("ring group q=1 min, combine", rg0, xb0, True, "min")]:
                sargs = (grp.rowptr, grp.col, grp.value, buf, is_min, e0)
                if into is None:
                    kw = dict(pos=grp.pos, row_map=grp.row_map, n_rows=Mb0)
                    got = shard_spmm_minmax(*sargs, **kw)
                    inst = last_instance(shard_spmm_minmax)
                    ref = shard_spmm_minmax_plain(*sargs, **kw)
                else:
                    o_, a_ = shard_spmm_minmax(
                        it0.rowptr, it0.col, it0.value, xb0, into == "min",
                        e0, pos=it0.pos)
                    got = shard_spmm_minmax(
                        *sargs, pos=grp.pos, out=o_.clone(), arg=a_.clone(),
                        row_map=grp.row_map)
                    inst = last_instance(shard_spmm_minmax)
                    ref = shard_spmm_minmax_plain(
                        *sargs, pos=grp.pos, out=o_.clone(), arg=a_.clone(),
                        row_map=grp.row_map)
                sync()
                mism = int((got[1] != ref[1]).sum())
                if mism:
                    failures.append(f"shard_spmm_minmax {label} K={k}: "
                                    f"{mism} argout entries differ")
                timing = {"instance": inst}
                if timed and into is None:
                    R_, E_ = grp.rowptr.shape[0] - 1, grp.nnz
                    timing.update({
                        "ms": timer(lambda: shard_spmm_minmax(*sargs, **kw)),
                        "plain_ms": plain_timer(
                            lambda: shard_spmm_minmax_plain(*sargs, **kw)),
                        "library_ms": None})
                    timing["bound_ms"], timing["bound_by"] = shard_bounds(
                        R_, E_, k, n_read(grp), R_, True, False, False,
                        minmax=True, has_pos=True)
                    timing["rows"], timing["edges"] = R_, E_
                case = kernel_case(torch, f"{label} K={k}", got[0], ref[0],
                                   failures, "shard_spmm_minmax", **timing)
                case["arg_mismatches"] = mism
                if case["max_abs_err"] != 0:
                    failures.append(f"shard_spmm_minmax {label} K={k}: out "
                                    "differs from the plain version's")
                mm_cases.append(case)
                del got, ref
            del xb0, halo0, base
        # The hierarchical schedule's buffers: shard 0 of the (2, 2) grid
        # (its tables built in this process), K11a accumulating over the
        # intra-slice halo (C*Hi rows) and over the cross-slice union
        # (C*S*Hx rows), K11b combining the union's max into the
        # interior's, at K=256 and at K2D_SLICE.
        hs0 = HierShardedSparseMatrix.from_sparse_tensor(
            A_h, HostGrid((dcn_axis, data_axis), HIER_GRID, 0, device))
        ht0 = hs0._tables
        hint = ht0.group(0)
        for k in (256, K2D_SLICE):
            base = operand(torch, hs0.Mb, k, 33, device)
            xb0 = operand(torch, hs0.Nb, k, 31, device)
            bufs = {i: operand(torch, ht0.sizes[i], k, 34 + i, device)
                    for i in (1, 2)}
            for label, i in (("hier intra-slice halo, accumulate", 1),
                             ("hier cross-slice union, accumulate", 2)):
                grp, buf = ht0.group(i), bufs[i]
                sargs = (grp.rowptr, grp.col, grp.value, buf)
                got = shard_spmm(*sargs, out=base.clone(),
                                 row_map=grp.row_map)
                inst = last_instance(shard_spmm)
                ref = shard_spmm_plain(*sargs, out=base.clone(),
                                       row_map=grp.row_map)
                sync()
                R_, E_ = grp.rowptr.shape[0] - 1, grp.nnz
                out_t, rm_l = base.clone(), grp.row_map.long()
                A_csr = csr_of(grp, ht0.sizes[i])
                timing = {
                    "instance": inst,
                    "ms": timer(lambda: shard_spmm(
                        *sargs, out=out_t, row_map=grp.row_map)),
                    "plain_ms": timer(lambda: shard_spmm_plain(
                        *sargs, out=out_t, row_map=grp.row_map)),
                    "library_ms": timer(lambda: out_t.index_add_(
                        0, rm_l, A_csr @ buf))}
                timing["bound_ms"], timing["bound_by"] = shard_bounds(
                    R_, E_, k, n_read(grp), R_, True, True, True)
                timing["rows"], timing["edges"] = R_, E_
                timing["buffer_rows"] = ht0.sizes[i]
                sum_cases.append(kernel_case(
                    torch, f"{label} K={k}", got, ref, failures,
                    "shard_spmm", **timing))
                del got, ref, out_t, A_csr
            grp, buf = ht0.group(2), bufs[2]
            o_, a_ = shard_spmm_minmax(hint.rowptr, hint.col, hint.value,
                                       xb0, False, hs0.e0, pos=hint.pos)
            sargs = (grp.rowptr, grp.col, grp.value, buf, False, hs0.e0)
            kw = dict(pos=grp.pos, row_map=grp.row_map)
            got = shard_spmm_minmax(*sargs, out=o_.clone(), arg=a_.clone(),
                                    **kw)
            inst = last_instance(shard_spmm_minmax)
            ref = shard_spmm_minmax_plain(*sargs, out=o_.clone(),
                                          arg=a_.clone(), **kw)
            sync()
            label = f"hier cross-slice union max, combine K={k}"
            mism = int((got[1] != ref[1]).sum())
            if mism:
                failures.append(f"shard_spmm_minmax {label}: {mism} argout "
                                "entries differ")
            R_, E_ = grp.rowptr.shape[0] - 1, grp.nnz
            o_t, a_t = o_.clone(), a_.clone()
            timing = {
                "instance": inst,
                "ms": timer(lambda: shard_spmm_minmax(
                    *sargs, out=o_t, arg=a_t, **kw)),
                "plain_ms": plain_timer(lambda: shard_spmm_minmax_plain(
                    *sargs, out=o_t, arg=a_t, **kw)),
                "library_ms": None}
            timing["bound_ms"], timing["bound_by"] = shard_bounds(
                R_, E_, k, n_read(grp), R_, True, True, True, minmax=True,
                has_pos=True)
            timing["rows"], timing["edges"] = R_, E_
            timing["buffer_rows"] = ht0.sizes[2]
            case = kernel_case(torch, label, got[0], ref[0], failures,
                               "shard_spmm_minmax", **timing)
            case["arg_mismatches"] = mism
            if case["max_abs_err"] != 0:
                failures.append(f"shard_spmm_minmax {label}: out differs "
                                "from the plain version's")
            mm_cases.append(case)
            del got, ref, o_, a_, o_t, a_t, base, xb0, bufs
        shape = (f"shard 0 of {DIST_WORLD}: Mb={Mb0} interior E="
                 f"{it0.nnz} frontier E={fr0.nnz} (P*H={PH0}) ring q=1 "
                 f"E={rg0.nnz}; hierarchical {HIER_GRID} shard 0: "
                 f"intra-slice E={ht0.group(1).nnz} (C*Hi={ht0.sizes[1]}), "
                 f"cross-slice E={ht0.group(2).nnz} "
                 f"(C*S*Hx={ht0.sizes[2]})")
        kernels.append(kernel_entry(
            "shard_spmm", "shard_spmm.cu", "parallel/dist.py:337", sum_cases,
            "torch.sparse_csr_tensor(group) @ buf (cuSPARSE), plus "
            "index_add_ into out when it accumulates", shape))
        kernels.append(kernel_entry(
            "shard_spmm_minmax", "shard_spmm.cu", "parallel/dist.py:369",
            mm_cases, "none (no PyTorch call computes an argout)", shape))
        del shard0, hl0, it0, fr0, rg0, hs0, ht0, hint
    except Exception:
        failures.append("phase 3 (shard_spmm): " + traceback.format_exc())
    record("kernel_phase", seconds=round(time.time() - t0, 2))

    # ---- 4, 4b, 5 and 6: the main path, with launch counts ---------------
    t0 = time.time()
    x_u = operand(torch, Mu, K, 2, device)
    x_r = operand(torch, Mr, K, 2, device)
    x_h = operand(torch, Mh, K, 2, device)
    A_r2 = A_r.set_value(A_r.storage.value(), layout="coo")  # no cached view
    in_dim, hid, out_dim, nlayers = GCN_WIDTHS
    x_g = operand(torch, Mu, in_dim, 5, device)
    labels = seeded_labels(torch, x_g, out_dim, 6, device)

    def make_gcn():
        return GCN(in_dim, hid, out_dim, num_layers=nlayers,
                   generator=torch.Generator().manual_seed(0), device=device)

    model = make_gcn()
    leg_specs = [
        ("uniform (ogbn-arxiv scale)", A_u, x_u, 0.0, GATE_F32, "csr"),
        ("community Reddit-10%, store budget 0", A_r, x_r, 0.0, GATE_F32,
         "dense[torch.float32]"),
        ("community Reddit-10%, store budget 2e-3", A_r2, x_r, 2e-3,
         GATE_BF16, "dense[torch.bfloat16]"),
        ("community hybrid (Reddit nodes, 1/10 edges), store budget 0", A_h,
         x_h, 0.0, GATE_F32, "hybrid[torch.float32]"),
    ]
    # Backward legs: a fresh leaf value per graph, so that the router
    # builds the view of a value that requires grad.
    bwd_specs = []
    for label, A, x, want in [
            ("uniform (ogbn-arxiv scale)", A_u, x_u, "csr"),
            ("community Reddit-10%, store budget 0", A_r, x_r,
             "dense[torch.float32]"),
            ("community hybrid (Reddit nodes, 1/10 edges), store budget 0",
             A_h, x_h, "hybrid[torch.float32]")]:
        v = A.storage.value().detach().clone().requires_grad_(True)
        bwd_specs.append((label, A.set_value(v, layout="coo"), v,
                          x.detach().clone().requires_grad_(True),
                          operand(torch, A.sparse_size(0), K, 8, device),
                          want))
    # Min/max legs: the same kind of leaf value, on the uniform graph and
    # the community hybrid graph (whose hybrid view min/max bypasses).
    mm_specs = []
    for label, A, x in [
            ("uniform (ogbn-arxiv scale)", A_u, x_u),
            ("community hybrid (Reddit nodes, 1/10 edges)", A_h, x_h)]:
        v = A.storage.value().detach().clone().requires_grad_(True)
        mm_specs.append((label, A.set_value(v, layout="coo"), v,
                         x.detach().clone().requires_grad_(True),
                         operand(torch, A.sparse_size(0), K, 16, device)))
    gat_in, gat_heads, gat_hid, gat_out = GAT_WIDTHS
    gat_model = GAT(gat_in, gat_hid, gat_out, heads=gat_heads,
                    generator=torch.Generator().manual_seed(0), device=device)

    # Each phase of the main path runs with every launch count set to 0
    # just before it and read just after it, and must launch the kernels
    # listed here.  The train steps need no value gradient, so phase 6
    # must launch no edge dot; min/max bypasses the router, so phase 4c
    # must launch no block kernel.
    must_launch = {
        "4 forward legs": ("csr_spmm", "block_spmm"),
        "4b backward legs": ("csr_spmm", "block_spmm", "block_spmm_t",
                             "edge_dot"),
        "4c min/max legs": ("csr_spmm_minmax", "minmax_edge_dot",
                            "minmax_spmm_t"),
        "5 GCN inference": ("csr_spmm",),
        "6 GCN training": ("csr_spmm",),
        "7 GAT inference": ("edge_softmax", "csr_spmm"),
        "8 SpSpMM": ("plan_numeric", "block_spgemm_window"),
        "9 GCN training on the aligned hybrid": (
            "block_spmm", "block_spmm_t", "csr_spmm", "block_spmm_dblocks"),
        "10 GAT training": ("edge_softmax", "edge_softmax_bwd", "csr_spmm",
                            "edge_dot"),
        "11 GraphSAGE and GIN training": ("csr_spmm",),
        "12 GraphSAINT-RW training": ("random_walk", "csr_spmm"),
        "13 neighbour-sampled GraphSAGE": ("csr_spmm",),
        "14 four ranks on one card (gloo)": (
            "shard_spmm", "shard_spmm_minmax", "block_spmm", "block_spmm_t",
            "edge_dot", "minmax_edge_dot", "minmax_spmm_t"),
        "15 DistGCN on products (world size 1, NCCL)": ("shard_spmm",),
        "16 hierarchical and 2-D layouts on four ranks (gloo)": (
            "shard_spmm", "shard_spmm_minmax", "block_spmm", "block_spmm_t",
            "edge_dot", "minmax_edge_dot", "minmax_spmm_t"),
        "17 gather probe": ("smem_gather", "edge_scan_loop", "tiled_spmm"),
        "18 the structural op set": ("csr_spmm",),
        "19 Cluster-GCN on the products partition": ("csr_spmm",),
        "20 typed and ego sampling": ("csr_spmm",),
        "21 Reddit pipeline at Reddit's scale": ("csr_spmm",),
        "22 the training recipes": ("csr_spmm", "edge_softmax",
                                    "edge_softmax_bwd", "edge_dot",
                                    "shard_spmm"),
    }
    phase_launches = {}

    def drive(phase, fn):
        for f in counted.values():
            f.launches = 0
        try:
            out = fn()
            sync()
        except Exception:
            failures.append(f"phase {phase}: " + traceback.format_exc())
            out = None
        phase_launches[phase] = {n: f.launches for n, f in counted.items()}
        return out

    def forward_legs():
        outs = []
        with torch.inference_mode():
            for label, A, x, budget, gate, want in leg_specs:
                set_store_budget(budget)
                try:
                    outs.append(ts.spmm_sum(A, x))
                except Exception:
                    failures.append(f"leg {label}: " + traceback.format_exc())
                    outs.append(None)
            set_store_budget(0.0)
        return outs

    def backward_legs():
        grads = []
        for label, A, v, x, gout, want in bwd_specs:
            try:
                grads.append(torch.autograd.grad(ts.spmm_sum(A, x), (v, x),
                                                 gout))
            except Exception:
                failures.append(f"backward leg {label}: "
                                + traceback.format_exc())
                grads.append(None)
        return grads

    def minmax_legs():
        res = []
        for label, A, v, x, gout in mm_specs:
            for reduce in ("max", "min"):
                fn = ts.spmm_max if reduce == "max" else ts.spmm_min
                try:
                    out, arg = fn(A, x)
                    gv, gx = torch.autograd.grad(out, (v, x), gout)
                    res.append((label, reduce, out.detach(), arg, gv, gx))
                except Exception:
                    failures.append(f"min/max leg {label} {reduce}: "
                                    + traceback.format_exc())
        return res

    def gat_inference():
        with torch.inference_mode():
            return gat_model(A_g, x_g)

    def gcn_inference():
        with torch.inference_mode():
            return model(A_g, x_g)

    def gcn_training():
        tmodel = make_gcn()
        opt = torch.optim.Adam(tmodel.parameters(), lr=1e-2)
        opt.zero_grad()
        loss0 = tmodel.loss(A_g, x_g, labels)
        loss0.backward()
        grads0 = [p.grad.detach().clone() for p in tmodel.parameters()]
        opt.step()
        gen = torch.Generator(device=device).manual_seed(0)
        losses = []
        for _ in range(3):
            opt.zero_grad()
            loss = tmodel.loss(A_g, x_g, labels, dropout_rate=0.5,
                               generator=gen)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return loss0.item(), grads0, losses, opt, tmodel, gen

    def spspmm_pipeline():
        """8a: ``A_g @ A_g`` through the public ``@`` and both value
        gradients; 8b: the Reddit pipeline's structural ops on ``A_r``;
        8c: ``spspmm_stream_device(A_s, A_s)`` with every piece.  Each
        sub-phase keeps its results, host seconds and launch counts."""
        def counts():
            return {n: f.launches for n, f in counted.items()}

        res = {}
        t1 = time.time()
        va = A_g.storage.value().detach().clone().requires_grad_(True)
        vb = A_g.storage.value().detach().clone().requires_grad_(True)
        Aa = A_g.set_value(va, layout="coo")
        Ab = A_g.set_value(vb, layout="coo")
        C = Aa @ Ab
        sync()
        product_s = time.time() - t1
        gC = operand(torch, C.nnz(), 1, 19, device)[:, 0].contiguous()
        gA, gB = torch.autograd.grad(C.storage.value(), (va, vb), gC)
        sync()
        res["8a"] = dict(C=C, Aa=Aa, Ab=Ab, va=va, vb=vb, gC=gC, gA=gA,
                         gB=gB, product_s=product_s,
                         with_grads_s=time.time() - t1, launches=counts())
        t1 = time.time()
        before = counts()
        sym = A_r + A_r.t()
        res["8b"] = dict(
            t=A_r.t(), sym=sym,
            diag_set=A_r.remove_diag().set_diag(torch.ones(Mr,
                                                           device=device)),
            get_diag=A_r.get_diag(), spspmm_diag=ts.spspmm_diag(A_r, A_r))
        sync()
        res["8b"].update(seconds=time.time() - t1, launches={
            n: v - before[n] for n, v in counts().items()})
        t1 = time.time()
        before = counts()
        pieces = list(ts.spspmm_stream_device(
            A_s, A_s, Bb=SPGEMM_BB, min_density=SPGEMM_DENSITY))
        sync()
        res["8c"] = dict(pieces=pieces, seconds=time.time() - t1, launches={
            n: v - before[n] for n, v in counts().items()})
        return res

    # Phases 9-11: the models' train steps.
    x_9 = operand(torch, Mh, in_dim, 72, device)
    labels_9 = seeded_labels(torch, x_9, out_dim, 73, device)

    def gcn_hybrid_training():
        """Phase 9: one step with the block store frozen, then one with
        ``h9.blocks`` requiring grad (its gradient is kept, the store is
        not in the optimizer)."""
        tmodel = make_gcn()
        opt = torch.optim.Adam(tmodel.parameters(), lr=1e-2)
        opt.zero_grad()
        loss0 = tmodel.loss(h9, x_9, labels_9)
        loss0.backward()
        grads0 = [p_.grad.detach().clone() for p_ in tmodel.parameters()]
        opt.step()
        k5b_step1 = block_spmm_dblocks.launches
        params1 = [p_.detach().clone() for p_ in tmodel.parameters()]
        h9.blocks.requires_grad_(True)
        try:
            opt.zero_grad()
            tmodel.loss(h9, x_9, labels_9).backward()
            opt.step()
            gblocks = h9.blocks.grad
        finally:
            h9.blocks.requires_grad_(False)
            h9.blocks.grad = None
        return dict(loss0=loss0.item(), grads0=grads0, params1=params1,
                    gblocks=gblocks, k5b_step1=k5b_step1,
                    k5b_step2=block_spmm_dblocks.launches - k5b_step1,
                    model=tmodel, opt=opt)

    def gat_training():
        """Phase 10: one Adam step of phase 7's GAT."""
        gmodel = GAT(gat_in, gat_hid, gat_out, heads=gat_heads,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
        opt = torch.optim.Adam(gmodel.parameters(), lr=5e-3)
        opt.zero_grad()
        loss = gmodel.loss(A_g, x_g, labels)
        loss.backward()
        grads = [p_.grad.detach().clone() for p_ in gmodel.parameters()]
        opt.step()
        return loss.item(), grads, gmodel, opt

    def make_sage_gin(cls):
        return cls(in_dim, hid, out_dim, num_layers=nlayers,
                   generator=torch.Generator().manual_seed(0), device=device)

    def sage_gin_training():
        """Phase 11: one Adam step each of GraphSAGE and GIN."""
        res = {}
        for cls in (GraphSAGE, GIN):
            m = make_sage_gin(cls)
            opt = torch.optim.Adam(m.parameters(), lr=1e-2)
            opt.zero_grad()
            loss = m.loss(A_u1, x_g, labels)
            loss.backward()
            grads = [p_.grad.detach().clone() for p_ in m.parameters()]
            opt.step()
            res[cls.__name__] = (loss.item(), grads, m, opt)
        return res

    # Phases 12-13: sampled GraphSAGE training on the products-scale
    # graph, at OGB's products widths (100 -> 256 -> 256 -> 47) with
    # Adam(lr=1e-3).
    in_p, hid_p, out_p, nl_p = SAGE_WIDTHS
    x_p = torch.randn((Mp, in_p), device=device,
                      generator=torch.Generator(device=device).manual_seed(81))
    labels_p = seeded_labels(torch, x_p, out_p, 82, device)

    def make_sage_p():
        return GraphSAGE(in_p, hid_p, out_p, num_layers=nl_p,
                         generator=torch.Generator().manual_seed(0),
                         device=device)

    def saint_training():
        """Phase 12: GraphSAINT random-walk batches (OGB's products
        ``graph_saint.py``: 20,000 roots, walk length 3, no
        normalisation): roots from a seeded CUDA generator, the walks
        (K12), their distinct nodes, ``saint_subgraph`` on the host, the
        features gathered on the card, one GraphSAGE step."""
        n_roots, wl, n_batches = SAINT
        m = make_sage_p()
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        gen = torch.Generator(device=device).manual_seed(83)
        res = dict(batches=[], saint_s=[], step_ms=[], losses=[])
        for b in range(n_batches):
            roots = torch.randint(0, Mp, (n_roots,), generator=gen,
                                  device=device)
            walk_state = gen.get_state()
            walks = A_p.random_walk(roots, wl, generator=gen)
            node_idx = torch.unique(walks.view(-1))
            t1 = time.time()
            sub, e_id = A_p.saint_subgraph(node_idx)
            res["saint_s"].append(time.time() - t1)
            x_b, y_b = x_p[node_idx.long()], labels_p[node_idx.long()]
            sync()
            t1 = time.time()
            opt.zero_grad()
            loss = m.loss(sub, x_b, y_b)
            loss.backward()
            if b == 0:
                res["grads0"] = [p_.grad.detach().clone()
                                 for p_ in m.parameters()]
            opt.step()
            sync()
            res["step_ms"].append((time.time() - t1) * 1e3)
            res["losses"].append(loss.item())
            res["batches"].append(dict(roots=roots, walk_state=walk_state,
                                       walks=walks, node_idx=node_idx,
                                       sub=sub, e_id=e_id, x=x_b, y=y_b))
        return res

    batch_p, fanouts_p, n_nb = NEIGHBOR
    A_ids = A_p.set_value(torch.arange(A_p.nnz(), dtype=torch.int32,
                                       device=device), layout="coo")

    def make_batch(it):
        """Batch ``it`` of phase 13 (PyG's ``ogbn_products_sage.py``:
        1,024 targets, fanouts 15, 10, 5), every seed derived from ``it``
        as ``examples/train_sage_minibatch.py:128-146`` derives them;
        ``sample_adj`` per hop, innermost hop first, on the graph whose
        values are the edge ids."""
        brng = np.random.RandomState(100_000 + it)
        targets = torch.from_numpy(
            brng.choice(Mp, batch_p, replace=False)).to(device)
        hops, hop_s, frontier = [], [], targets
        for h, k in enumerate(fanouts_p):
            t1 = time.time()
            adj, n_id = ts.sample_adj(A_ids, frontier, k, replace=False,
                                      seed=1000 + it * 10 + h)
            hop_s.append(time.time() - t1)
            hops.append((adj, n_id))
            frontier = n_id
        return dict(targets=targets, hops=hops, hop_s=hop_s,
                    adjs=[a_.set_value(None) for a_, _ in hops],
                    x=x_p[frontier.long()], y=labels_p[targets])

    def sage_mb_logits(m, batch, agg=None, relu=torch.relu):
        return sage_hops_forward(
            m, batch["adjs"], batch["x"],
            agg or (lambda a_, h_: ts.spmm_mean(a_, h_)), relu)

    def sage_mb_loss(m, batch):
        return nll_loss(sage_mb_logits(m, batch), batch["y"])

    def neighbor_training():
        """Phase 13: three batches sampled and stepped in turn, then the
        same three through ``MinibatchPrefetcher(num_workers=2)``."""
        m = make_sage_p()
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        res = dict(sync_batches=[], sync_ms=[], step_ms=[], losses=[])
        for it in range(n_nb):
            t1 = time.time()
            batch = make_batch(it)
            sync()
            t2 = time.time()
            opt.zero_grad()
            loss = sage_mb_loss(m, batch)
            loss.backward()
            if it == 0:
                res["grads0"] = [p_.grad.detach().clone()
                                 for p_ in m.parameters()]
            opt.step()
            sync()
            res["sync_ms"].append((time.time() - t1) * 1e3)
            res["step_ms"].append((time.time() - t2) * 1e3)
            res["losses"].append(loss.item())
            res["sync_batches"].append(batch)
        t1 = time.time()
        res["prefetch_batches"] = []
        for batch in MinibatchPrefetcher(make_batch, n_nb, num_workers=2):
            opt.zero_grad()
            loss = sage_mb_loss(m, batch)
            loss.backward()
            opt.step()
            res["losses"].append(loss.item())
            res["prefetch_batches"].append(batch)
        sync()
        res["prefetch_ms"] = (time.time() - t1) * 1e3 / n_nb
        return res

    # Phase 18: the structural op set through the public API.
    def structural_ops():
        """PyG's ``SparseTensor`` preprocessing on the products graph:
        ``gcn_norm`` (``torch_geometric/nn/conv/gcn_conv.py``: ones,
        ``fill_diag``, ``sum(dim=1)``, ``pow(-0.5)``, ``mul`` by the
        column and the row), the column sums, the train split's subgraph
        ``adj[idx, idx]`` from an index and from a mask, and 8 row blocks
        ``narrow``ed and ``cat`` back; then on the uniform graph
        ``to_symmetric``, ``reverse_cuthill_mckee``, 128 diagonal blocks
        ``cat_diag``ed and taken back out, ``to_torch_sparse_csr_tensor``,
        the legacy tuple ``spmm`` and the row sums of ``(E, 8)`` values.
        Each op's host seconds (the card synchronised after it)."""
        import scipy.sparse.csgraph  # noqa: F401  (imported untimed)

        r = {"host_s": {}}

        def op(name, fn):
            t1 = time.time()
            out = fn()
            sync()
            r["host_s"][name] = time.time() - t1
            return out

        adj = op("fill_value", lambda: A_p.fill_value(1.0))
        adj = op("fill_diag", lambda: adj.fill_diag(1.0))
        deg = op("sum(dim=1)", lambda: adj.sum(dim=1))
        dis = op("pow(-0.5)", lambda: deg.pow(-0.5))
        dis.masked_fill_(dis == float("inf"), 0.0)
        norm = op("mul(d.view(-1, 1))", lambda: adj.mul(dis.view(-1, 1)))
        norm = op("mul(d.view(1, -1))", lambda: norm.mul(dis.view(1, -1)))
        colsum = op("sum(dim=0)", lambda: norm.sum(dim=0))
        idx = np.random.RandomState(85).permutation(Mp)[:STRUCT_SUBGRAPH]
        idx_d = torch.from_numpy(idx).to(device)
        mask = np.zeros(Mp, bool)
        mask[idx] = True
        mask_d = torch.from_numpy(mask).to(device)
        sub = op("adj[idx, idx]", lambda: norm[idx_d, idx_d])
        sub_mask = op("adj[mask, mask]", lambda: norm[mask_d, mask_d])
        cuts = np.linspace(0, Mp, STRUCT_ROW_BLOCKS + 1).astype(np.int64)
        parts = op(f"narrow x{STRUCT_ROW_BLOCKS} (row blocks)", lambda: [
            norm.narrow(0, int(a), int(b - a))
            for a, b in zip(cuts[:-1], cuts[1:])])
        back = op("cat (row blocks)", lambda: ts.cat(parts, dim=0))
        r["cat_equal"] = op("== (products)", lambda: back == norm)
        del parts

        sym = op("to_symmetric", lambda: A_u.to_symmetric())
        r["is_symmetric"] = op("is_symmetric", lambda: sym.is_symmetric())
        rcm, perm = op("reverse_cuthill_mckee",
                       lambda: sym.reverse_cuthill_mckee(is_symmetric=True))
        bnd = np.linspace(0, Mu, STRUCT_DIAG_BLOCKS + 1).astype(np.int64)
        spans = [(int(a), int(b - a)) for a, b in zip(bnd[:-1], bnd[1:])]
        blocks = op(f"narrow x{2 * STRUCT_DIAG_BLOCKS} (diagonal blocks)",
                    lambda: [A_u.narrow(0, a, n_).narrow(1, a, n_)
                             for a, n_ in spans])
        D = op("cat_diag", lambda: ts.cat(blocks, dim=(0, 1)))
        outs_d = op(f"__narrow_diag__ x{STRUCT_DIAG_BLOCKS}", lambda: [
            D.__narrow_diag__((a, a), (n_, n_)) for a, n_ in spans])
        outs_n = op(f"narrow x{2 * STRUCT_DIAG_BLOCKS} (out of cat_diag)",
                    lambda: [D.narrow(0, a, n_).narrow(1, a, n_)
                             for a, n_ in spans])
        r["blocks_equal"] = op(
            f"== x{2 * STRUCT_DIAG_BLOCKS} (diagonal blocks)",
            lambda: all(x == b and y == b
                        for x, y, b in zip(outs_d, outs_n, blocks)))
        csr_t = op("to_torch_sparse_csr_tensor",
                   lambda: A_u.to_torch_sparse_csr_tensor())
        legacy = op("spmm (legacy tuple), K=128", lambda: ts.spmm(
            torch.stack(A_u.coo()[:2]), A_u.storage.value(), Mu, Mu, x_u))
        v8 = operand(torch, A_u.nnz(), STRUCT_WIDTH, 86, device)
        A_u8 = A_u.set_value(v8, layout="coo")
        s8 = op(f"sum(dim=1), (E, {STRUCT_WIDTH}) values",
                lambda: A_u8.sum(dim=1))
        r.update(adj=adj, deg=deg, dis=dis, norm=norm, colsum=colsum,
                 idx=idx, sub=sub, sub_mask=sub_mask, back=back, sym=sym,
                 rcm=rcm, perm=perm, blocks=blocks, D=D, outs_d=outs_d,
                 outs_n=outs_n, csr_t=csr_t, legacy=legacy, v8=v8, s8=s8)
        return r

    def uncounted(fn):
        """``fn()`` with every launch count left as it was: the launches
        of a timing loop or of a reference are none of the main path's."""
        saved = {n: f.launches for n, f in counted.items()}
        try:
            return fn()
        finally:
            for n, f in counted.items():
                f.launches = saved[n]

    def cluster_gcn():
        """Phase 19: Cluster-GCN on the products partition, one epoch of
        8 steps in part order.  Per part: the diagonal block
        (``narrow`` twice), ``gcn_norm``, the router's route at K=100
        (the first ``spmm_sum``), that route and K1 alone timed on the
        part's features (uncounted), and one Adam step of phase 15's GCN
        on the part's features and labels, timed with CUDA events.  Part
        0's step is held against the plain CSR version with this run's
        ReLU decisions (uncounted)."""
        in_, hid_, out_, nl_ = PRODUCTS_GCN
        padj, perm = part19["padj"], part19["perm"]
        pp = part19["partptr"].cpu().numpy()

        def make():
            return GCN(in_, hid_, out_, num_layers=nl_,
                       generator=torch.Generator().manual_seed(0),
                       device=device)

        model = make()
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        x_all, y_all = x_p[perm], labels_p[perm]
        res = {"parts": []}
        for p in range(CLUSTER_PARTS):
            lo, n = int(pp[p]), int(pp[p + 1] - pp[p])
            t1 = time.time()
            blk = gcn_norm(padj.narrow(0, lo, n).narrow(1, lo, n))
            sync()
            part = {"part": p, "nodes": n, "nnz": blk.nnz(),
                    "block_and_gcn_norm_host_s": time.time() - t1}
            xb, yb = x_all[lo:lo + n], y_all[lo:lo + n]
            t1 = time.time()
            out = ts.spmm_sum(blk, xb)
            sync()
            part["first_spmm_host_s"] = time.time() - t1
            h = blk.storage.hybrid(auto=False)
            part["route"] = route_name(h)
            if h is not None and hasattr(h, "blocks"):
                part.update(blocks=h.nb, dense_edge_share=h.dense_nnz
                            / blk.nnz())

            def spmm_times():
                rowptr, col, value = blk.csr()
                k1 = csr_spmm(rowptr, col, value, xb)
                part["k1_rel_err_vs_route"] = errors(out, k1)[1]
                part["spmm_ms"] = timer(lambda: ts.spmm_sum(blk, xb))
                part["k1_ms"] = timer(lambda: csr_spmm(rowptr, col, value,
                                                       xb))

            uncounted(spmm_times)
            del out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            opt.zero_grad()
            loss = model.loss(blk, xb, yb)
            loss.backward()
            if p == 0:
                grads0 = [q.grad.detach().clone() for q in model.parameters()]
            opt.step()
            end.record()
            end.synchronize()
            part["step_ms"] = start.elapsed_time(end)
            part["loss"] = loss.item()
            if p == 0:
                def reference():
                    # The same first step through torch autograd on the
                    # plain CSR version, with this run's ReLU decisions;
                    # the entries where the plain run's own decisions
                    # differ are counted, as in phase 6.
                    rm = make()
                    kmasks = relu_masks(torch, ts.spmm_sum, rm, blk, xb)
                    pmasks = relu_masks(
                        torch, lambda a, h_: csr_spmm_plain(*a.csr(), h_),
                        rm, blk, xb)
                    res["relu_flips"] = sum(int((k_ != q_).sum()) for k_, q_
                                            in zip(kmasks, pmasks))
                    del pmasks
                    ref = plain_loss(torch, csr_spmm_plain, rm, blk, xb, yb,
                                     kmasks)
                    ref.backward()
                    res["loss_rel_err_vs_plain"] = (
                        abs(part["loss"] - ref.item()) / abs(ref.item()))
                    res["grad_rel_errs_vs_plain"] = [
                        errors(g, q.grad)[1]
                        for g, q in zip(grads0, rm.parameters())]
                    res["part0_nodes"] = n

                uncounted(reference)
                del grads0
            res["parts"].append(part)
            del blk, h, loss
        res["epoch_ms"] = sum(q["step_ms"] for q in res["parts"])
        return res

    # Phase 20: typed and ego sampling.
    def typed_sampling():
        """Phase 20: the ogbn-mag graph built (host arrays, features and
        labels on the card); (a) three NeighborLoader batches through
        ``hetero_neighbor_sample``, each with one Adam step of
        ``to_hetero`` GraphSAGE; (b) ``hgt_sample`` on the same seeds,
        a step each on the induced typed adjacency (a fresh model); (c)
        ``hetero_temporal_neighbor_sample`` on batch 0 with the papers'
        years, one step; (d) ``ego_k_hop_sample_adj`` on the products
        graph from 512 roots of a seeded permutation and one step of
        phase 13's GraphSAGE with the loss on the roots.  Each sampler's
        host wall a batch (outputs on the card), each step's ms (CUDA
        events) and the views' host ms are kept."""
        t_phase = time.time()
        mag_in, mag_hid, mag_out = MAG_WIDTHS
        batch, fanouts, n_batches = MAG_BATCH
        n_hgt, hgt_hops = HGT_SAMPLES
        res = {}
        t1 = time.time()
        n_nodes, rels = mag_graph(torch, MAG_SCALE, args.seed, device)
        gen = torch.Generator(device=device).manual_seed(args.seed + 20)
        feats = {t: torch.randn((n, mag_in), device=device, generator=gen)
                 for t, n in n_nodes.items()}
        labels_m = torch.randint(0, mag_out, (n_nodes["paper"],),
                                 device=device, generator=gen)
        years = np.random.RandomState(args.seed + 21).randint(
            MAG_YEARS[0], MAG_YEARS[1] + 1, n_nodes["paper"])
        sync()
        res.update(build_s=time.time() - t1, n_nodes=n_nodes,
                   edges={k: int(v[1].shape[0]) for k, v in rels.items()},
                   feature_bytes=sum(f.numel() * 4 for f in feats.values()))
        colptr = {k: v[0] for k, v in rels.items()}
        row = {k: v[1] for k, v in rels.items()}
        rel_keys, node_types = list(rels), list(n_nodes)
        seeds = np.random.RandomState(args.seed + 22).permutation(
            n_nodes["paper"])[:n_batches * batch].reshape(n_batches, batch)

        def views(out):
            nid, rws, cls, _ = out
            adjs = {}
            for rel in rel_keys:
                src_t, _, dst_t = rel.split("__")
                adjs[rel] = ts.SparseTensor(
                    row=cls[rel], col=rws[rel], sparse_sizes=(
                        nid[dst_t].shape[0], nid[src_t].shape[0]),
                    device=device)
            return adjs, {t: feats[t][nid[t]] for t in node_types}

        def make_typed():
            return hetero_sage(torch, rel_keys, MAG_WIDTHS, 0, device)

        def typed_logits(m, vw, relu, agg=None):
            adjs, xs = vw
            return hetero_sage_forward(
                m, rel_keys, len(MAG_WIDTHS) - 1, adjs, xs,
                agg or (lambda a_, h_: ts.matmul(a_, h_, reduce="mean")),
                relu)["paper"]

        def timed_step(m, opt, lossfn, keep):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            opt.zero_grad()
            loss = lossfn(m)
            loss.backward()
            if keep is not None:
                keep["grads0"] = [None if q.grad is None
                                  else q.grad.detach().clone()
                                  for q in m.parameters()]
            opt.step()
            end.record()
            end.synchronize()
            return start.elapsed_time(end), loss.item()

        def run(name, sample, inputs, n_steps):
            """``n_steps`` batches of ``sample(b)``, a step each."""
            m = make_typed()
            opt = torch.optim.Adam(m.parameters(), lr=0.01)
            r = dict(host_ms=[], views_ms=[], step_ms=[], losses=[],
                     outs=[], nodes=[], edges=[])
            for b in range(n_steps):
                t1 = time.time()
                out = sample(b)
                sync()
                r["host_ms"].append((time.time() - t1) * 1e3)
                t1 = time.time()
                vw = views(out)
                sync()
                r["views_ms"].append((time.time() - t1) * 1e3)
                y = labels_m[out[0]["paper"][:inputs]]
                ms, loss = timed_step(
                    m, opt, lambda m_: nll_loss(
                        typed_logits(m_, vw, torch.relu)[:inputs], y),
                    r if b == 0 else None)
                r["step_ms"].append(ms)
                r["losses"].append(loss)
                r["outs"].append(out)
                r["nodes"].append({t: int(v.shape[0])
                                   for t, v in out[0].items()})
                r["edges"].append({k: int(v.shape[0])
                                   for k, v in out[1].items()})
                if b == 0:
                    r["views0"], r["y0"] = vw, y
            res[name] = r

        run("neighbor", lambda b: ts.hetero_neighbor_sample(
            node_types, rel_keys, colptr, row, {"paper": seeds[b]},
            {k: list(fanouts) for k in rel_keys}, len(fanouts),
            replace=False, directed=True, seed=args.seed + 100 + b,
            device=device), batch, n_batches)
        run("hgt", lambda b: ts.hgt_sample(
            colptr, row, {"paper": seeds[b]},
            {t: [n_hgt] * hgt_hops for t in node_types}, hgt_hops,
            seed=args.seed + 200 + b, device=device), batch, n_batches)
        run("temporal", lambda b: ts.hetero_temporal_neighbor_sample(
            node_types, rel_keys, colptr, row, {"paper": seeds[b]},
            {k: list(fanouts) for k in rel_keys}, {"paper": years},
            len(fanouts), replace=False, directed=True,
            seed=args.seed + 300 + b, device=device), batch, 1)
        res["mag"] = dict(colptr=colptr, row=row, seeds=seeds, years=years,
                          rel_keys=rel_keys, make=make_typed,
                          logits=typed_logits)
        del feats

        # (d) ShaDow ego batches on the products graph.
        n_roots, depth, k_ = SHADOW
        roots = np.random.RandomState(args.seed + 23).permutation(Mp)[
            :n_roots]
        t1 = time.time()
        ego = ts.ego_k_hop_sample_adj(A_p, torch.from_numpy(roots).to(device),
                                      depth, k_, replace=False,
                                      seed=args.seed + 400)
        sync()
        ego_ms = (time.time() - t1) * 1e3
        adj, n_id, _, _, root_n_id = ego
        x_e, y_e = x_p[n_id], labels_p[torch.from_numpy(roots).to(device)]
        m = make_sage_p()
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        d = {}
        ms, loss = timed_step(m, opt, lambda m_: nll_loss(sage_forward(
            m_, lambda h_, _: ts.spmm_mean(adj, h_), x_e,
            torch.relu)[root_n_id], y_e), d)
        res["ego"] = dict(host_ms=ego_ms, step_ms=ms, loss=loss,
                          grads0=d["grads0"], out=ego, roots=roots, x=x_e,
                          y=y_e)
        res["phase_s"] = time.time() - t_phase
        return res

    def reddit_pipeline():
        """Phase 21: the JAX package's ``benchmarks/reddit_pipeline.py``
        at Reddit's scale through the public API; each step's host
        seconds (the card synchronised after it).  What the checks
        compare is computed here beside the steps, untimed; the scipy
        comparison of the ``A.A`` blocks and K1's oracle run after the
        main path (``check_reddit21``)."""
        from pytorch_sparse_tpu_torch.storage import _to_numpy
        from pytorch_sparse_tpu_torch.utils import _native

        r = {"host_s": {}, "checks": {}}
        t_phase = time.time()

        def step(name, t1):
            sync()
            r["host_s"][name] = time.time() - t1

        def keys_of(T, swap=False):
            row, col = T.storage.row().long(), T.storage.col().long()
            return (col * M + row) if swap else (row * M + col)

        t1 = time.time()
        M, src, dst = reddit_graph(REDDIT_SCALE)
        step("build_graph", t1)
        r["nodes"], r["draws"] = M, int(src.size)
        uniq = torch.unique(torch.from_numpy(src).to(device) * M
                            + torch.from_numpy(dst).to(device))
        t1 = time.time()
        A = ts.SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                            device=device).coalesce("add")
        A.storage.rowptr()
        step("construct_coalesce", t1)
        del src, dst
        r["nnz"] = A.nnz()
        kA = keys_of(A)
        r["checks"]["coalesced"] = (A.storage.value() is None
                                    and bool(torch.equal(kA, uniq)))
        del uniq

        t1 = time.time()
        At = A.t()
        At.storage.rowptr()
        step("transpose", t1)
        kAt = keys_of(At)
        r["checks"]["transpose"] = bool(torch.equal(
            kAt, torch.sort(keys_of(A, swap=True))[0]))

        t1 = time.time()
        S = A + At
        S.storage.rowptr()
        step("spadd", t1)
        r["spadd_nnz"] = S.nnz()
        r["checks"]["spadd"] = bool(torch.equal(
            keys_of(S), torch.unique(torch.cat([kA, kAt]))))
        del S, kAt

        t1 = time.time()
        Ad = A.remove_diag().set_diag(torch.ones(M, device=device))
        Ad.storage.col()
        step("remove_set_diag", t1)
        rd, cd = Ad.storage.row(), Ad.storage.col()
        n_diag = int((A.storage.row() == A.storage.col()).sum())
        r["checks"]["one_diagonal_a_row"] = bool(
            (torch.bincount(rd[rd == cd].long(), minlength=M) == 1).all()
        ) and Ad.nnz() == A.nnz() - n_diag + M
        del Ad, rd, cd

        t1 = time.time()
        d2 = ts.spspmm_diag(A, A)
        step("diag_AA", t1)
        rev = keys_of(A, swap=True)
        pos = torch.searchsorted(kA, rev).clamp_(max=kA.numel() - 1)
        r["reciprocated_edges"] = int((kA[pos] == rev).sum())
        r["diag_AA_sum"] = float(d2.double().sum())
        del rev, pos, kA
        rpA, cA = A.storage.numpy_view("rowptr"), A.storage.numpy_view("col")
        rpT = At.storage.numpy_view("rowptr")
        cT = At.storage.numpy_view("col")
        rows, _, _ = walk_rows(A, 512, 121)
        ref = np.array([np.intersect1d(
            cA[rpA[i]:rpA[i + 1]], cT[rpT[i]:rpT[i + 1]],
            assume_unique=True).size for i in rows])
        r["checks"]["diag_AA_total"] = (r["diag_AA_sum"]
                                        == r["reciprocated_edges"])
        r["checks"]["diag_AA_rows"] = bool(np.array_equal(
            d2.cpu().numpy()[rows], ref))
        del At, d2, rpT, cT

        t1 = time.time()
        r["AA_terms_total"] = ts.expansion_terms(A, A)
        step("expansion_terms", t1)
        # A.A over the pipeline's scattered row blocks, on its values
        # (float32 on the card, pulled once as float64).
        v = torch.from_numpy(np.random.RandomState(7).rand(
            A.nnz()).astype(np.float32)).to(device)
        t1 = time.time()
        val = _to_numpy(v).astype(np.float64)
        step("AA_values_pull", t1)
        n_rows, n_blocks = REDDIT_AA_BLOCKS
        stride = max(M // min(n_rows, M), 1)
        starts = np.arange(0, M - stride, stride)[:n_rows]
        starts = starts[::max(len(starts) // n_blocks, 1)]
        blocks = []
        t1 = time.time()
        for lo in starts.tolist():
            hi = min(lo + stride, M)
            blocks.append((lo, hi, *_native.spgemm(
                rpA, cA, val, rpA, cA, val, M, row_lo=lo, row_hi=hi)))
        r["AA_s"] = time.time() - t1
        t1 = time.time()
        counts = [_native.spgemm(rpA, cA, None, rpA, cA, None, M,
                                 row_lo=lo, row_hi=hi, count_only=True)[0]
                  for lo, hi, *_ in blocks]
        r["AA_count_only_s"] = time.time() - t1
        r["checks"]["count_only"] = all(
            np.array_equal(c_, b_[2]) for c_, b_ in zip(counts, blocks))
        deg = np.diff(rpA)
        r["AA_blocks"] = len(blocks)
        r["AA_rows_a_block"] = stride
        r["AA_sampled_terms"] = int(sum(
            deg[cA[rpA[lo]:rpA[hi]]].sum() for lo, hi, *_ in blocks))
        r["AA_sampled_nnz"] = int(sum(b_[2][-1] for b_ in blocks))
        r["AA_terms_per_s"] = r["AA_sampled_terms"] / r["AA_s"]
        r["AA_extrapolated_full_s"] = (r["AA_terms_total"]
                                       / r["AA_terms_per_s"])
        r["AA_extrapolated_nnz"] = int(r["AA_sampled_nnz"] * (
            r["AA_terms_total"] / max(r["AA_sampled_terms"], 1)))
        r["AA_count_only_terms_per_s"] = (r["AA_sampled_terms"]
                                          / r["AA_count_only_s"])
        del deg, counts

        # One K1 launch over the whole matrix, the first at Reddit's size.
        x = operand(torch, M, REDDIT_K, 122, device)
        Av = A.set_value(v, layout="coo")
        csr = Av.csr()
        t1 = time.time()
        out = csr_spmm(*csr, x)
        step("k1_spmm", t1)
        r["host_peak_bytes"] = host_peak_bytes()
        r["phase_s"] = time.time() - t_phase
        r.update(Av=Av, csr=csr, x=x, out=out, blocks=blocks, val=val,
                 rpA=rpA, cA=cA)
        return r

    outs = drive("4 forward legs", forward_legs) or []
    bwd_grads = drive("4b backward legs", backward_legs) or []
    mm_res = drive("4c min/max legs", minmax_legs) or []
    logits = drive("5 GCN inference", gcn_inference)
    train = drive("6 GCN training", gcn_training)
    gat_logits = drive("7 GAT inference", gat_inference)
    spg = drive("8 SpSpMM", spspmm_pipeline)
    gcn9 = drive("9 GCN training on the aligned hybrid", gcn_hybrid_training)
    gat10 = drive("10 GAT training", gat_training)
    models11 = drive("11 GraphSAGE and GIN training", sage_gin_training)
    saint12 = drive("12 GraphSAINT-RW training", saint_training)
    if saint12 is not None:
        # K12's device time at the phase's size (its calls are the host's
        # launch path), on batch 0's roots and the seed-84 uniforms that
        # the phase's check walks: outside the phase, so that its launch
        # counts stay the main path's.
        rp_, cl_ = A_p.csr()[:2]
        roots_ = saint12["batches"][0]["roots"].to(torch.int32)
        rand_ = torch.rand((SAINT[0], SAINT[1]), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(84))
        saint12["walk_device_ms"] = probe_vmem_gather.device_ms(
            lambda: random_walk_kernel(rp_, cl_, roots_, rand_), rand_)
        del rp_, cl_, roots_, rand_
    nb13 = drive("13 neighbour-sampled GraphSAGE", neighbor_training)

    # Phase 14: four ranks on the card, gloo, collectives staged through
    # the host.  The workers load the community hybrid graph and its
    # gcn_norm from a file of this run's arrays.
    def dist_four_ranks():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_p14_")
        try:
            path = os.path.join(tmp, "graphs.npz")
            Mf, Ef, nf = FRONTIER_DENSE
            A_f = community_graph(Mf, Ef, n_comm=nf, seed=2,
                                  equal_sizes=True, device="cpu")
            arrays = {}
            for prefix, A_ in (("", A_h), ("n_", A_hn), ("s_", A_f)):
                st = A_.storage
                arrays.update({
                    prefix + "M": A_.size(0),
                    prefix + "row": st.numpy_view("row"),
                    prefix + "col": st.numpy_view("col"),
                    prefix + "val": st.value().cpu().numpy()})
            np.savez(path, **arrays)
            del A_f, arrays
            t1 = time.time()
            ranks = spawn_ranks(dist_worker, DIST_WORLD, "gloo",
                                args=dict(coo_path=path, K_=K, K2d=K2D,
                                          widths=GCN_WIDTHS,
                                          grid=HIER_GRID), timeout=900)
            return ranks, time.time() - t1
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # The products graph's partition, computed once on the host (it
    # launches no kernel): phase 15 lays the graph out by it and phase 19
    # trains on its parts.  It runs in a thread of its own while phase
    # 14's four processes run (the partitioner's C++ and numpy's sorts
    # release the GIL), and phase 15 waits for it.
    def products_partition():
        """``partition_fine(A_p, 8, fine_parts=Mp // 512, grouping=
        "within")`` on one host thread (the deterministic entry): the wall
        of the whole call, of its direct 8-way partition (the clusters of
        the multilevel partitioner) and of the reorder (each part's
        coarsening clusters and the one ``permute`` by both), the host's
        peak resident memory, the cut and the balance, and the contract:
        ``partptr`` from 0 to Mp and never falling, ``perm`` a
        permutation, the permuted matrix ``A_p`` relabelled through
        ``perm``'s inverse."""
        from pytorch_sparse_tpu_torch.partition import _native, metis

        r = {"host_peak_bytes_before": host_peak_bytes()}
        walls = {}
        t1 = time.time()
        with wall_of(metis, "_clusters", walls), \
                wall_of(_native, "multilevel_partition", walls), \
                wall_of(_native, "coarsen_clusters", walls), \
                wall_of(metis, "permute", walls):
            padj, partptr, perm = ts.partition_fine(
                A_p, CLUSTER_PARTS, fine_parts=Mp // CLUSTER_FINE_ROWS,
                grouping="within", num_workers=0)
        sync()
        r["total_s"] = time.time() - t1
        r["host_peak_bytes_after"] = host_peak_bytes()
        r["partition_s"] = walls["_clusters"]
        r["reorder_s"] = r["total_s"] - walls["_clusters"]
        r["multilevel_partitioner_s"] = walls["multilevel_partition"]
        r["coarsen_clusters_s"] = walls["coarsen_clusters"]
        r["permute_s"] = walls["permute"]
        t1 = time.time()
        pp, pm = partptr.cpu().numpy(), perm.cpu().numpy()
        prow = padj.storage.numpy_view("row")
        pcol = padj.storage.numpy_view("col")
        inv = np.empty(Mp, np.int64)
        inv[pm] = np.arange(Mp)
        # torch's sort runs on several threads; its order is numpy's.
        relabelled = torch.sort(torch.from_numpy(
            inv[A_p.storage.numpy_view("row")] * Mp
            + inv[A_p.storage.numpy_view("col")]))[0].numpy()
        part_of = np.repeat(np.arange(CLUSTER_PARTS), np.diff(pp))
        sizes = np.diff(pp)
        r.update(
            partptr_ok=bool(pp.size == CLUSTER_PARTS + 1 and pp[0] == 0
                            and pp[-1] == Mp and (sizes >= 0).all()),
            perm_ok=bool(np.array_equal(np.sort(pm), np.arange(Mp))),
            relabel_ok=bool(np.array_equal(prow * Mp + pcol, relabelled)),
            on_card=all(t.device.type == "cuda" for t in (
                partptr, perm, padj.storage.col(), padj.storage.rowptr())),
            dtypes=[str(partptr.dtype), str(perm.dtype)],
            edge_cut=float((part_of[prow] != part_of[pcol]).mean()),
            part_sizes=sizes.tolist(),
            balance=float(sizes.max() / (Mp / CLUSTER_PARTS)),
            fine_parts=Mp // CLUSTER_FINE_ROWS,
            checks_s=time.time() - t1)
        del relabelled, part_of, inv
        r.update(padj=padj, partptr=partptr, perm=perm)
        return r

    # Phase 15: DistGCN at OGB's products full-batch GCN widths on the
    # products graph laid out by the port's partition, world size 1 on
    # NCCL.
    def dist_products():
        import torch.distributed as tdist

        r = {}
        t1 = time.time()
        perm = part19["perm"]
        r["A"] = gcn_norm(part19["padj"])
        r["A"].storage.rowptr()
        r["x"], r["y"] = x_p[perm], labels_p[perm]
        sync()
        r["gcn_norm_s"] = time.time() - t1
        tmp = tempfile.mkdtemp(prefix="chip_smoke_p15_")
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv",
                                 rank=0, world_size=1)
        try:
            mesh = make_mesh(1, device=device)
            t1 = time.time()
            Ash = ShardedSparseMatrix.from_sparse_tensor(r["A"], mesh)
            r["local_format"] = ("hybrid" if Ash.has_interior_blocks()
                                 else "ell")
            Ash._halo.frontier
            sync()
            r["sharded_build_s"] = time.time() - t1
            hy = Ash._hybrid
            if hy is not None:
                r["blocks"] = hy.blocks.shape[0] - 1
                r["block_bytes"] = hy.blocks.numel() * \
                    hy.blocks.element_size()
                r["rest_nnz"] = 0 if hy.rest is None else hy.rest.nnz
            in_, hid_, out_, nl_ = PRODUCTS_GCN
            model = DistGCN(in_, hid_, out_, num_layers=nl_,
                            generator=torch.Generator().manual_seed(0),
                            device=device)
            r["kmasks"] = []
            with torch.no_grad():
                dist_gcn_forward(
                    model, r["x"],
                    lambda h: dist_spmm(Ash, h, "halo", "sum", "auto"),
                    relu_recorder(torch, r["kmasks"]))
            opt = torch.optim.Adam(model.parameters(), lr=0.01)
            mask = torch.ones(Mp, device=device)
            r["losses"], r["step_ms"] = [], []
            for s in range(DIST_STEPS):
                before = {n: f.launches for n, f in counted.items()}
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = model.train_step(opt, Ash, r["x"], r["y"], mask,
                                        "halo", "auto")
                end.record()
                end.synchronize()
                r["step_ms"].append(start.elapsed_time(end))
                r["losses"].append(loss.item())
                if s == 0:
                    r["grads0"] = [p_.grad.detach().clone()
                                   for p_ in model.parameters()]
                    r["launches_step1"] = {
                        n: f.launches - before[n]
                        for n, f in counted.items()
                        if f.launches - before[n]}
            r["peak_bytes"] = torch.cuda.max_memory_allocated()
            del Ash, model, opt
            # One step of the same model on a (1, 1) hierarchical grid
            # over NCCL: its sub-group collectives run on the card, and
            # its loss and gradients must equal the halo schedule's first
            # step.
            t1 = time.time()
            Ahh = HierShardedSparseMatrix.from_sparse_tensor(
                r["A"], make_mesh_hier(1, 1, device=device))
            h = {"local_format": ("hybrid" if Ahh.has_interior_blocks()
                                  else "ell")}
            sync()
            h["build_s"] = time.time() - t1
            model = DistGCN(in_, hid_, out_, num_layers=nl_,
                            generator=torch.Generator().manual_seed(0),
                            device=device)
            opt = torch.optim.Adam(model.parameters(), lr=0.01)
            before = {n: f.launches for n, f in counted.items()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = model.train_step(opt, Ahh, Ahh.shard_dense(r["x"]),
                                    Ahh.shard_dense(r["y"]), mask, "hier",
                                    "auto")
            end.record()
            end.synchronize()
            h["step_ms"] = start.elapsed_time(end)
            h["loss"] = loss.item()
            h["grads"] = [p_.grad.detach().clone()
                          for p_ in model.parameters()]
            h["launches"] = {n: f.launches - before[n]
                             for n, f in counted.items()
                             if f.launches - before[n]}
            h["staged_bytes"] = Ahh.grid.staged_bytes
            r["hier"] = h
            del Ahh, model, opt
        finally:
            tdist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
        return r

    # Phases 14 and 16 run in the same four processes (each rank holds
    # the whole COO of the 15.6M-edge graph once); each rank sets its
    # counts to 0 at the start of each phase and reads them at its end.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        partition_run = pool.submit(products_partition)
        p14 = drive("14 four ranks on one card (gloo)", dist_four_ranks)
        try:
            part19 = partition_run.result()
        except Exception:
            failures.append("products partition: " + traceback.format_exc())
            part19 = None
    phase_launches["16 hierarchical and 2-D layouts on four ranks (gloo)"] \
        = {n: 0 for n in counted}
    if p14 is not None:
        for rank_res in p14[0]:
            for n, c_ in rank_res["launches"].items():
                phase_launches["14 four ranks on one card (gloo)"][n] += c_
            for n, c_ in rank_res["phase16"]["launches"].items():
                phase_launches["16 hierarchical and 2-D layouts on four "
                               "ranks (gloo)"][n] += c_
    dist15 = drive("15 DistGCN on products (world size 1, NCCL)",
                   dist_products)
    # Phase 17: the gather probe's port on phase 3's uniform graph and
    # the community hybrid graph.
    probe17 = drive("17 gather probe", lambda: probe_vmem_gather.run(
        device, graphs={"uniform": A_u, "community hybrid": A_h}))
    struct18 = drive("18 the structural op set", structural_ops)
    cluster19 = drive("19 Cluster-GCN on the products partition",
                      cluster_gcn)
    typed20 = drive("20 typed and ego sampling", typed_sampling)
    reddit21 = drive("21 Reddit pipeline at Reddit's scale", reddit_pipeline)

    # Phase 22: the training recipes through their entry points, at the
    # JAX recipes' defaults; the distributed one ran in phase 14's
    # processes, whose launches join this phase's.
    recipes22 = (("train_gcn", train_gcn, []),
                 ("train_gat", train_gat, []),
                 ("train_cluster_gcn", train_cluster_gcn, []),
                 ("train_sage_minibatch", train_sage_minibatch, []),
                 ("train_sage_minibatch --workers 4", train_sage_minibatch,
                  ["--workers", "4"]))

    def entry_points():
        t1 = time.time()
        out = {}
        for label, mod, argv_ in recipes22:
            t2 = time.time()
            out[label] = mod.main(argv_)
            out[label]["wall_s"] = time.time() - t2
        out["seconds"] = time.time() - t1
        return out

    entry22 = drive("22 the training recipes", entry_points)
    if p14 is not None:
        for rank_res in p14[0]:
            for n, c_ in rank_res["phase22"]["launches"].items():
                phase_launches["22 the training recipes"][n] += c_
    launches = {n: sum(c[n] for c in phase_launches.values())
                for n in counted}
    record("main_path", seconds=round(time.time() - t0, 2),
           launches=launches, launches_by_phase=phase_launches)
    for k_ in kernels:
        k_["launches"] = launches[k_["name"]]
    for phase, names in must_launch.items():
        for name in names:
            if phase_launches[phase][name] == 0:
                failures.append(f"{name} was not launched in phase {phase}")
    if phase_launches["6 GCN training"]["edge_dot"]:
        failures.append("the GCN train steps launched edge_dot (no value "
                        "gradient is needed)")
    if (phase_launches["4c min/max legs"]["block_spmm"]
            or phase_launches["4c min/max legs"]["block_spmm_t"]):
        failures.append("the min/max legs launched a block kernel")
    gat_counts = {n: phase_launches["7 GAT inference"][n]
                  for n in ("edge_softmax", "csr_spmm")}
    if gat_counts != {"edge_softmax": 2, "csr_spmm": gat_heads + 1}:
        failures.append(f"GAT launched {gat_counts} (want edge_softmax 2, "
                        f"csr_spmm {gat_heads + 1})")
    for phase in ("12 GraphSAINT-RW training",
                  "13 neighbour-sampled GraphSAGE"):
        blk = {n: phase_launches[phase][n] for n in (
            "block_spmm", "block_spmm_t", "block_spmm_dblocks")}
        if any(blk.values()):
            failures.append(f"phase {phase} launched a block kernel: {blk}")
    if phase_launches["9 GCN training on the aligned hybrid"]["edge_dot"]:
        failures.append("the hybrid GCN steps launched edge_dot (no value "
                        "gradient is needed)")
    gat10_counts = {n: phase_launches["10 GAT training"][n] for n in (
        "edge_softmax", "edge_softmax_bwd", "csr_spmm", "edge_dot")}
    gat10_want = {"edge_softmax": 2, "edge_softmax_bwd": 2,
                  "csr_spmm": 2 * (gat_heads + 1), "edge_dot": gat_heads + 1}
    if gat10_counts != gat10_want:
        failures.append(f"GAT training launched {gat10_counts} (want "
                        f"{gat10_want})")

    def route_of(A):
        h = A.storage.hybrid(auto=False)
        return route_name(h), h

    with torch.inference_mode():
        for (label, A, x, budget, gate, want), out in zip(leg_specs, outs):
            if out is None:
                continue
            route, h = route_of(A)
            ok, err = oracle_check(A, x, out, gate)
            finite = bool(torch.isfinite(out).all())
            set_store_budget(budget)
            ms = timer(lambda: ts.spmm_sum(A, x))
            set_store_budget(0.0)
            # The CSR kernel on the same graph: the route the router
            # declined (its constants were priced for a TPU).
            csr_ms = timer(lambda: csr_spmm(*A.csr(), x))
            bound = route_bound_ms(torch, A, h, K, split_parts)
            leg = {"leg": label, "route": route, "expected_route": want,
                   "nnz": A.nnz(), "oracle_rel_err": err, "gate": gate,
                   "ms": ms, "nnz_per_s": A.nnz() / (ms * 1e-3),
                   "bound_ms": bound, "csr_kernel_ms": csr_ms,
                   "card": card}
            record("route", **leg)
            if not (ok and finite and route == want):
                failures.append(f"leg {label}: route {route} (want {want}), "
                                f"oracle err {err:.3g} (gate {gate})")
        del outs

    # ---- 4b. backward legs: checks and times -----------------------------
    for (label, A, v, x, gout, want), grads in zip(bwd_specs, bwd_grads):
        if grads is None:
            continue
        gv, gx = grads
        route, _ = route_of(A)
        ok_x, err_x = grad_x_oracle_check(A, gout, gx, GATE_F32)
        ok_v, err_v = grad_v_oracle_check(A, x, gout, gv, GATE_F32)
        finite = bool(torch.isfinite(gx).all() and torch.isfinite(gv).all())
        ms = timer(lambda: torch.autograd.grad(ts.spmm_sum(A, x), (v, x),
                                               gout))
        fwd_ms = timer(lambda: ts.spmm_sum(A, x.detach()))
        record("backward", leg=label, route=route, expected_route=want,
               nnz=A.nnz(), grad_x_rel_err=err_x, grad_v_rel_err=err_v,
               gate=GATE_F32, ms_forward_backward=ms, ms_forward=fwd_ms,
               card=card)
        if not (ok_x and ok_v and finite and route == want):
            failures.append(f"backward leg {label}: route {route} (want "
                            f"{want}), grad_x err {err_x:.3g}, grad_v err "
                            f"{err_v:.3g} (gate {GATE_F32}), finite {finite}")
    del bwd_specs, bwd_grads

    # ---- 4c. min/max legs: checks and times ------------------------------
    specs_by_label = {sp[0]: sp for sp in mm_specs}
    for label, reduce, out, arg, gv, gx in mm_res:
        _, A, v, x, gout = specs_by_label[label]
        is_min = reduce == "min"
        fn = ts.spmm_min if is_min else ts.spmm_max
        ok_o, err_o, mism = minmax_oracle_check(A, x, out, arg, is_min,
                                                GATE_F32)
        ok_x, err_x = grad_x_oracle_check(A, gout, gx, GATE_F32, arg=arg)
        ok_v, err_v = grad_v_oracle_check(A, x, gout, gv, GATE_F32, arg=arg)
        finite = bool(torch.isfinite(out).all() and torch.isfinite(gx).all()
                      and torch.isfinite(gv).all())
        shape_ok = tuple(out.shape) == (A.sparse_size(0), K)
        ms = timer(lambda: fn(A, x.detach()))
        ms_fb = timer(lambda: torch.autograd.grad(fn(A, x)[0], (v, x), gout))
        record("minmax", leg=label, reduce=reduce, nnz=A.nnz(),
               out_rel_err=err_o, arg_mismatches=mism, grad_x_rel_err=err_x,
               grad_v_rel_err=err_v, gate=GATE_F32, ms_forward=ms,
               ms_forward_backward=ms_fb, card=card)
        if not (ok_o and ok_x and ok_v and finite and shape_ok):
            failures.append(f"min/max leg {label} {reduce}: out err "
                            f"{err_o:.3g}, {mism} arg mismatches, grad_x err "
                            f"{err_x:.3g}, grad_v err {err_v:.3g} (gate "
                            f"{GATE_F32}), finite {finite}")
    del mm_specs, mm_res

    # ---- 4d. writes to a routed graph's values: checks and times ---------
    # The community hybrid graph over its own copy of the values.  After a
    # write through ``.data`` (which moves no version counter) and after
    # an in-place write, the routed product, forward and backward, must
    # match the host oracles on the new values, over the same structure
    # (no host rebuild).  Timed: holding the view against the values on
    # a routed call with nothing written (one compare on the card), and a
    # write followed by the refresh (a new store written on the card),
    # beside K2's time on the same graph.
    try:
        v_w = A_h.storage.value().detach().clone()
        A_w = A_h.set_value(v_w, layout="coo")
        x_w = x_h.detach().clone().requires_grad_(True)
        gout_w = operand(torch, Mh, K, 21, device)
        ts.spmm_sum(A_w, x_w.detach())  # builds the view
        h_w = A_w.storage.hybrid(auto=False)
        new_v = operand(torch, v_w.shape[0], 1, 22, device)[:, 0]
        for how, write in (("through .data", lambda: v_w.data.copy_(new_v)),
                           ("in place", lambda: v_w.mul_(-0.5))):
            write()
            out = ts.spmm_sum(A_w, x_w)
            gx, = torch.autograd.grad(out, x_w, gout_w)
            sync()
            h_new = A_w.storage.hybrid(auto=False)
            route, _ = route_of(A_w)
            ok_o, err_o = oracle_check(A_w, x_w.detach(), out, GATE_F32)
            ok_x, err_x = grad_x_oracle_check(A_w, gout_w, gx, GATE_F32)
            same_structure = (h_new is not h_w
                              and h_new.slot_row is h_w.slot_row
                              and h_new.index is h_w.index)
            record("value_write", write=how, route=route,
                   oracle_rel_err=err_o, grad_x_rel_err=err_x,
                   gate=GATE_F32, new_view_same_structure=same_structure)
            if not (ok_o and ok_x and same_structure
                    and route == "hybrid[torch.float32]"):
                failures.append(f"value write {how}: route {route}, oracle "
                                f"err {err_o:.3g}, grad_x err {err_x:.3g}, "
                                f"same structure {same_structure}")
            h_w = h_new
            del out, gx
        k2 = next(k_ for k_ in kernels if k_["name"] == "block_spmm")

        def write_and_refresh():
            v_w.data.neg_()
            return A_w.storage.hybrid()

        with torch.inference_mode():
            record("value_write_cost", graph="community hybrid",
                   nnz=A_w.nnz(), dense_edges=h_w.dense_nnz,
                   check_ms=timer(lambda: A_w.storage.hybrid()),
                   write_and_refresh_ms=timer(write_and_refresh),
                   routed_forward_ms=timer(
                       lambda: ts.spmm_sum(A_w, x_w.detach())),
                   k2_ms=k2["ms"], card=card)
        del A_w, v_w, x_w, gout_w, h_w, h_new, new_v
    except Exception:
        failures.append("phase 4d (value writes): " + traceback.format_exc())

    # ---- 5. GCN inference: checks and times ------------------------------
    with torch.inference_mode():
        if logits is not None:
            # The plain reference is written for the CSR route only.
            csr_route = A_g.storage.hybrid(auto=False) is None
            ref = gcn_plain(torch, csr_spmm_plain, model, A_g, x_g)
            sync()
            _, rel_e = errors(logits, ref)
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (Mu, out_dim)
            ms = timer(lambda: model(A_g, x_g))
            plain_ms = timer(
                lambda: gcn_plain(torch, csr_spmm_plain, model, A_g, x_g))
            record("gcn", layers=nlayers,
                   widths=[in_dim] + [hid] * (nlayers - 1) + [out_dim],
                   nodes=Mu, nnz=A_g.nnz(), csr_route=csr_route,
                   rel_err_vs_plain=rel_e, gate=KERNEL_GATE,
                   ms_per_forward=ms, plain_ms_per_forward=plain_ms,
                   card=card)
            if not (csr_route and finite and shape_ok
                    and rel_e <= KERNEL_GATE):
                failures.append(f"GCN: csr route={csr_route} finite={finite} "
                                f"shape={logits.shape} "
                                f"rel err vs plain {rel_e:.3g}")

    def step(m, o, lossfn):
        o.zero_grad()
        lossfn(m).backward()
        o.step()

    # ---- 6. GCN training: checks and times -------------------------------
    if train is not None:
        loss0, grads0, losses, opt, tmodel, gen = train
        # The same first step through torch autograd on the plain CSR
        # version (index_select + index_add_, no custom backward).  A
        # ReLU input within rounding of 0 can fall on either side in the
        # two runs, whose sums run in different orders, and its gradient
        # term is then kept in one and dropped in the other.  So the
        # reference takes the kernel run's ReLU decisions, and the
        # entries where the plain run's own decisions differ are counted.
        rmodel = make_gcn()
        kmasks = relu_masks(torch, ts.spmm_sum, rmodel, A_g, x_g)
        pmasks = relu_masks(
            torch, lambda a, h: csr_spmm_plain(*a.csr(), h), rmodel, A_g,
            x_g)
        flips = sum(int((k_ != p_).sum()) for k_, p_ in zip(kmasks, pmasks))
        ref_loss = plain_loss(torch, csr_spmm_plain, rmodel, A_g, x_g, labels,
                              kmasks)
        ref_loss.backward()
        del kmasks, pmasks
        grad_errs = [errors(g, p.grad)[1]
                     for g, p in zip(grads0, rmodel.parameters())]
        loss_err = abs(loss0 - ref_loss.item()) / abs(ref_loss.item())
        ms = timer(lambda: step(tmodel, opt, lambda m: m.loss(
            A_g, x_g, labels, dropout_rate=0.5, generator=gen)))
        ms_nodrop = timer(lambda: step(tmodel, opt, lambda m: m.loss(
            A_g, x_g, labels)))
        ropt = torch.optim.Adam(rmodel.parameters(), lr=1e-2)
        plain_ms = timer(lambda: step(rmodel, ropt, lambda m: plain_loss(
            torch, csr_spmm_plain, m, A_g, x_g, labels)))
        falls = all(np.isfinite(losses)) and losses[2] < losses[0]
        # The masks may absorb ties only: more flips than a small share
        # of the hidden entries is a fault of the kernel run.
        max_flips = int(RELU_FLIP_SHARE * Mu * hid * (nlayers - 1))
        record("gcn_train", layers=nlayers, nodes=Mu, nnz=A_g.nnz(),
               loss_step1=loss0, loss_rel_err_vs_plain=loss_err,
               grad_rel_errs_vs_plain=grad_errs, relu_flips=flips,
               max_relu_flips=max_flips, gate=KERNEL_GATE,
               dropout_losses=losses, ms_per_step=ms,
               ms_per_step_no_dropout=ms_nodrop,
               plain_ms_per_step_no_dropout=plain_ms, card=card)
        if not (np.isfinite(loss0) and loss_err <= KERNEL_GATE
                and max(grad_errs) <= KERNEL_GATE and falls
                and flips <= max_flips):
            failures.append(f"GCN training: loss err {loss_err:.3g}, grad "
                            f"errs {max(grad_errs):.3g} (gate "
                            f"{KERNEL_GATE}), ReLU flips {flips} (at most "
                            f"{max_flips}), dropout losses {losses}")

    # ---- 7. GAT inference: checks and times ------------------------------
    with torch.inference_mode():
        if gat_logits is not None:
            ref = gat_plain(torch, gat_model, A_g, x_g, edge_softmax_plain,
                            csr_spmm_plain)
            sync()
            _, rel_e = errors(gat_logits, ref)
            finite = bool(torch.isfinite(gat_logits).all())
            shape_ok = tuple(gat_logits.shape) == (Mu, gat_out)
            ms = timer(lambda: gat_model(A_g, x_g))
            plain_ms = timer(lambda: gat_plain(
                torch, gat_model, A_g, x_g, edge_softmax_plain,
                csr_spmm_plain))
            record("gat", widths=[gat_in, f"{gat_heads}x{gat_hid}", gat_out],
                   nodes=Mu, nnz=A_g.nnz(), launches=gat_counts,
                   rel_err_vs_plain=rel_e, gate=KERNEL_GATE,
                   ms_per_forward=ms, plain_ms_per_forward=plain_ms,
                   card=card)
            if not (finite and shape_ok and rel_e <= KERNEL_GATE):
                failures.append(f"GAT: finite={finite} shape="
                                f"{gat_logits.shape} rel err vs plain "
                                f"{rel_e:.3g}")

    # ---- 8. SpSpMM and the Reddit pipeline: checks and times -------------
    def add_cases(name, cases):
        """Append compared cases to a kernel's entry of the kernels line;
        its errors are the largest over all its cases."""
        entry = next(k_ for k_ in kernels if k_["name"] == name)
        entry["cases"].extend(cases)
        for key in ("max_abs_err", "max_rel_err"):
            entry[key] = max(c_[key] for c_ in entry["cases"])

    def check_spspmm(spg):
        import scipy.sparse as sp

        # 8a: structure exactly scipy's product of the 0/1 patterns (scipy
        # drops exact zeros of a weighted product; the port keeps every
        # entry), values against scipy's float64 product, gradients
        # against float64 host dots.  No block kernel may run.
        a = spg["8a"]
        C = a["C"]
        S1, SW = scipy_csr(sp, A_g, values=False), scipy_csr(sp, A_g)
        same, err_v = csr_against(C, S1 @ S1, SW @ SW)
        ok_g, err_ga, err_gb = spspmm_grad_oracle_check(
            a["Aa"], a["Ab"], C, a["gC"], a["gA"], a["gB"], GATE_F32)
        finite = all(bool(torch.isfinite(t_).all()) for t_ in (
            C.storage.value(), a["gA"], a["gB"]))
        blk = {n: a["launches"][n] for n in ("block_spmm", "block_spmm_t",
                                             "block_spgemm_window")}
        t1 = time.time()
        plan = _Plan(A_g, A_g)
        host_s = time.time() - t1
        va, vb, gC = a["va"], a["vb"], a["gC"]
        with torch.no_grad():
            numeric_ms = timer(lambda: plan.numeric(va, vb))
        fb_ms = timer(lambda: torch.autograd.grad(plan.numeric(va, vb),
                                                  (va, vb), gC))
        record("spspmm", leg="8a A_g @ A_g (public @)", nnz=A_g.nnz(),
               terms=int(plan.a_pos.shape[0]), nnz_out=C.nnz(),
               structure_equal=same, value_rel_err=err_v,
               grad_a_rel_err=err_ga, grad_b_rel_err=err_gb, gate=GATE_F32,
               structure_host_s=host_s, numeric_ms=numeric_ms,
               numeric_fwd_bwd_ms=fb_ms, product_host_s=a["product_s"],
               product_with_grads_host_s=a["with_grads_s"],
               launches=a["launches"], card=card)
        if not (same and err_v <= GATE_F32 and ok_g and finite
                and not any(blk.values())
                and a["launches"]["plan_numeric"] == 3):
            failures.append(f"8a A_g @ A_g: structure equal {same}, value "
                            f"err {err_v:.3g}, grad errs {err_ga:.3g} / "
                            f"{err_gb:.3g} (gate {GATE_F32}), finite "
                            f"{finite}, block launches {blk}, plan_numeric "
                            f"launches {a['launches']['plan_numeric']} "
                            "(want 3)")
        del plan, spg["8a"], a, C

        # 8b: each op of the pipeline on A_r against scipy: t(), the
        # diagonal edit and get_diag exactly, the sums to GATE_F32.
        b = spg["8b"]
        SR, SR1 = scipy_csr(sp, A_r), scipy_csr(sp, A_r, values=False)
        rr, cr = A_r.storage.numpy_view("row"), A_r.storage.numpy_view("col")
        off = rr != cr
        eye = np.arange(Mr)
        d_idx = (np.concatenate([rr[off], eye]),
                 np.concatenate([cr[off], eye]))
        errs = {}
        errs["t()"] = csr_against(b["t"], SR1.T, SR.T)
        errs["A + A.t()"] = csr_against(b["sym"], SR1 + SR1.T, SR + SR.T)
        errs["remove_diag().set_diag(ones)"] = csr_against(
            b["diag_set"], sp.csr_matrix((np.ones(d_idx[0].size), d_idx),
                                         shape=SR.shape),
            sp.csr_matrix((np.concatenate([
                A_r.storage.value().double().cpu().numpy()[off],
                np.ones(Mr)]), d_idx), shape=SR.shape))
        dg = b["get_diag"].double().cpu().numpy()
        errs["get_diag"] = (dg.shape == (Mr,), float(np.abs(
            dg - SR.diagonal()).max()))
        ref_sd = np.asarray(SR.multiply(SR.T).sum(axis=1)).ravel()
        errs["spspmm_diag(A, A)"] = (True, float(np.abs(
            b["spspmm_diag"].double().cpu().numpy() - ref_sd).max()
            / np.abs(ref_sd).max()))
        gates = {"t()": 0.0, "A + A.t()": GATE_F32,
                 "remove_diag().set_diag(ones)": 0.0, "get_diag": 0.0,
                 "spspmm_diag(A, A)": GATE_F32}
        record("spspmm", leg="8b Reddit pipeline ops on A_r", nnz=A_r.nnz(),
               rel_errs={k_: v_[1] for k_, v_ in errs.items()},
               structure_equal={k_: v_[0] for k_, v_ in errs.items()},
               gates=gates, host_s=b["seconds"], launches=b["launches"],
               card=card)
        for k_, (same_, err_) in errs.items():
            if not (same_ and err_ <= gates[k_]):
                failures.append(f"8b {k_}: structure equal {same_}, err "
                                f"{err_:.3g} (gate {gates[k_]})")
        del spg["8b"], b

        # 8c: the pieces of the device block stream sum to A_s @ A_s.
        c = spg["8c"]
        ck_err, rows_err, n_blk, n_coo = stream_pieces_check(
            torch, sp, A_s, c["pieces"], SPGEMM_BB)
        del spg["8c"]["pieces"]
        blocks_s, srow_s, scol_s, rem_s, dense_nnz, mask_s = _block_split(
            A_s, SPGEMM_BB, SPGEMM_DENSITY)
        block_ms = timer(lambda: list(block_spgemm_stream(
            blocks_s, srow_s, scol_s, blocks_s, srow_s, scol_s,
            max_out_blocks=SPGEMM_WINDOW)))
        # The kernels against their plain versions on the inputs 8c gives
        # them: the windows of A_s's block product, and the cross-term
        # chunks A @ R_B and R_A @ D_B at the stream's own chunking.
        bplan_s = block_spgemm_plan(srow_s, scol_s, srow_s, scol_s)
        wins_s = [w[2:] for w in block_spgemm_windows(
            bplan_s, SPGEMM_WINDOW, device)]
        got = torch.cat([block_spgemm_window(blocks_s, blocks_s, *w)
                         for w in wins_s])
        ref = torch.cat([block_spgemm_window_plain(blocks_s, blocks_s, *w)
                         for w in wins_s])
        k10_8c = [kernel_case(
            torch, "8c A_s D@D f32 store", got, ref, failures,
            "block_spgemm_window", pairs=int(bplan_s[0].shape[0]),
            windows=len(wins_s))]
        add_cases("block_spgemm_window", k10_8c)
        del got, ref, wins_s
        k9_8c = []
        for lab, L, R in [("8c A_s @ R_B", A_s, rem_s),
                          ("8c R_A @ D_B", rem_s, _dense_part(A_s, mask_s))]:
            rowptr_l, chunks = _row_chunks(L, R, PLAN_MAX_TERMS)
            for lo, hi in chunks:
                plan = _Plan(L, R, int(rowptr_l[lo]), int(rowptr_l[hi]))
                pargs = (L.storage.value(), plan.dev("a_pos"),
                         R.storage.value(), plan.dev("b_pos"),
                         plan.dev("t_ptr"))
                k9_8c.append(kernel_case(
                    torch, f"{lab} rows [{lo}, {hi})", plan_numeric(*pargs),
                    plan_numeric_plain(*pargs), failures, "plan_numeric",
                    terms=int(plan.a_pos.shape[0]), n_out=plan.n_out))
                del plan, pargs
        add_cases("plan_numeric", k9_8c)
        record("spspmm", leg="8c spspmm_stream_device(A_s, A_s)",
               nnz=A_s.nnz(), terms=ts.expansion_terms(A_s, A_s),
               dense_blocks=int(blocks_s.shape[0]),
               block_pairs=int(bplan_s[0].shape[0]),
               dense_edge_share=dense_nnz / A_s.nnz(), block_pieces=n_blk,
               coo_pieces=n_coo, checksum_rel_err=ck_err,
               rows_rel_err=rows_err, gates=[1e-6, GATE_F32],
               host_s=c["seconds"], block_stream_ms=block_ms,
               kernel_vs_plain=[{k_: v_ for k_, v_ in c_.items()
                                 if k_ != "ok"} for c_ in k10_8c + k9_8c],
               launches=c["launches"], card=card)
        if not (ck_err <= 1e-6 and rows_err <= GATE_F32 and n_blk > 0
                and n_coo > 0 and c["launches"]["block_spgemm_window"] > 0
                and c["launches"]["plan_numeric"] > 0):
            failures.append(f"8c stream: checksum err {ck_err:.3g} (gate "
                            f"1e-6), rows err {rows_err:.3g} (gate "
                            f"{GATE_F32}), {n_blk} block and {n_coo} coo "
                            f"pieces, launches {c['launches']}")

    if spg is not None:
        try:
            check_spspmm(spg)
        except Exception:
            failures.append("phase 8 checks: " + traceback.format_exc())
        del spg

    # ---- 9. GCN on the aligned hybrid: checks and times ------------------
    def check_gcn9(r):
        # The reference is the same step on the CSR route of the unaligned
        # matrix (the CSR kernel through its autograd function), with the
        # hybrid run's ReLU decisions; the entries where the CSR run's own
        # decisions differ are counted, as in phase 6.
        st_hn = A_hn.storage

        def csr_route(rowptr, col, value, h):
            return _CsrSum.apply(st_hn, value, h)

        rmodel = make_gcn()
        kmasks = relu_masks(torch, hybrid_spmm, rmodel, h9, x_9)
        cmasks = relu_masks(torch, lambda a, h: csr_route(*a.csr(), h),
                            rmodel, A_hn, x_9)
        flips = sum(int((k_ != c_).sum()) for k_, c_ in zip(kmasks, cmasks))
        with torch.no_grad():
            logits_h = rmodel(h9, x_9)
            logits_c = gcn_plain(torch, csr_route, rmodel, A_hn, x_9, kmasks)
        logit_err = errors(logits_h, logits_c)[1]
        ref_loss = plain_loss(torch, csr_route, rmodel, A_hn, x_9, labels_9,
                              kmasks)
        ref_loss.backward()
        del kmasks, cmasks, logits_h, logits_c
        grad_errs = [errors(g, p_.grad)[1]
                     for g, p_ in zip(r["grads0"], rmodel.parameters())]
        loss_err = abs(r["loss0"] - ref_loss.item()) / abs(ref_loss.item())
        # 8 sampled slots of the second step's blocks gradient against
        # float64 host products: the sum over layers of each layer's
        # output gradient (row block) times its aggregation input (column
        # block), both scattered to their padded positions.
        bmodel = make_gcn()
        with torch.no_grad():
            for p_, q_ in zip(bmodel.parameters(), r["params1"]):
                p_.copy_(q_)
        ins, gouts = gcn_agg_io(torch, lambda z: hybrid_spmm(h9, z), bmodel,
                                x_9, labels_9)
        rm = h9.row_map.long()
        B9 = h9.B

        def pad_rows(t):
            return t.new_zeros((h9.M_pad, t.shape[1])).index_copy(0, rm, t)

        ins = [pad_rows(t) for t in ins]
        gouts = [pad_rows(t) for t in gouts]
        gblocks = r["gblocks"]
        worst = 0.0
        for s_ in np.random.RandomState(74).choice(h9.nb, 8, replace=False):
            r_, c_ = int(h9.slot_row[s_]), int(h9.slot_col[s_])
            host = sum(
                g_[r_ * B9:(r_ + 1) * B9].double().cpu().numpy()
                @ z_[c_ * B9:(c_ + 1) * B9].double().cpu().numpy().T
                for g_, z_ in zip(gouts, ins))
            diff = np.abs(gblocks[s_].double().cpu().numpy() - host)
            worst = max(worst, float(diff.max() / np.abs(host).max()))
        zero_slot = bool((gblocks[h9.nb] == 0).all())
        del ins, gouts, gblocks, r["gblocks"], bmodel
        tmodel, opt = r["model"], r["opt"]
        ms = timer(lambda: step(tmodel, opt, lambda m: m.loss(
            h9, x_9, labels_9)))
        h9.blocks.requires_grad_(True)
        try:
            ms_blocks = timer(lambda: step(tmodel, opt, lambda m: m.loss(
                h9, x_9, labels_9)))
        finally:
            h9.blocks.requires_grad_(False)
            h9.blocks.grad = None
        ropt = torch.optim.Adam(rmodel.parameters(), lr=1e-2)
        csr_ms = timer(lambda: step(rmodel, ropt, lambda m: plain_loss(
            torch, csr_route, m, A_hn, x_9, labels_9)))
        max_flips = int(RELU_FLIP_SHARE * Mh * hid * (nlayers - 1))
        record("gcn_hybrid_train", layers=nlayers, nodes=Mh,
               nnz=A_hn.nnz(), B=h9.B, blocks=h9.nb, M_pad=h9.M_pad,
               dense_edge_share=h9.dense_nnz / A_hn.nnz(),
               loss_step1=r["loss0"], loss_rel_err_vs_csr=loss_err,
               logits_rel_err_vs_csr=logit_err,
               grad_rel_errs_vs_csr=grad_errs, relu_flips=flips,
               max_relu_flips=max_flips,
               blocks_grad_rel_err_8_slots_vs_f64=worst,
               blocks_grad_zero_slot=zero_slot,
               block_spmm_dblocks_launches=[r["k5b_step1"], r["k5b_step2"]],
               gate=KERNEL_GATE, ms_per_step=ms,
               ms_per_step_blocks_grad=ms_blocks,
               csr_route_ms_per_step=csr_ms, card=card)
        if not (np.isfinite(r["loss0"]) and loss_err <= KERNEL_GATE
                and logit_err <= KERNEL_GATE
                and max(grad_errs) <= KERNEL_GATE and flips <= max_flips
                and worst <= KERNEL_GATE and zero_slot
                and r["k5b_step1"] == 0 and r["k5b_step2"] == nlayers):
            failures.append(
                f"hybrid GCN training: loss err {loss_err:.3g}, logits err "
                f"{logit_err:.3g}, grad errs {max(grad_errs):.3g}, blocks "
                f"grad err {worst:.3g} (gate {KERNEL_GATE}), zero slot "
                f"{zero_slot}, ReLU flips {flips} (at most {max_flips}), "
                f"block_spmm_dblocks launches {r['k5b_step1']} then "
                f"{r['k5b_step2']} (want 0 then {nlayers})")

    # ---- 10. GAT training: checks and times ------------------------------
    def check_gat10(r):
        loss_k, grads_k, gmodel, gopt = r
        rg = GAT(gat_in, gat_hid, gat_out, heads=gat_heads,
                 generator=torch.Generator().manual_seed(0), device=device)

        def plain_gat_loss(m):
            return nll_loss(gat_plain(torch, m, A_g, x_g, edge_softmax_plain,
                                      csr_spmm_plain), labels)

        ref = plain_gat_loss(rg)
        ref.backward()
        grad_errs = [errors(g, p_.grad)[1]
                     for g, p_ in zip(grads_k, rg.parameters())]
        loss_err = abs(loss_k - ref.item()) / abs(ref.item())
        ms = timer(lambda: step(gmodel, gopt, lambda m: m.loss(
            A_g, x_g, labels)))
        ropt = torch.optim.Adam(rg.parameters(), lr=5e-3)
        plain_ms = plain_timer(lambda: step(rg, ropt, plain_gat_loss))
        record("gat_train", widths=[gat_in, f"{gat_heads}x{gat_hid}",
                                    gat_out], nodes=Mu, nnz=A_g.nnz(),
               launches=gat10_counts, loss_step1=loss_k,
               loss_rel_err_vs_plain=loss_err,
               grad_rel_errs_vs_plain=grad_errs, gate=KERNEL_GATE,
               ms_per_step=ms, plain_ms_per_step=plain_ms, card=card)
        if not (np.isfinite(loss_k) and loss_err <= KERNEL_GATE
                and max(grad_errs) <= KERNEL_GATE):
            failures.append(f"GAT training: loss err {loss_err:.3g}, grad "
                            f"errs {max(grad_errs):.3g} (gate {KERNEL_GATE})")

    # ---- 11. GraphSAGE and GIN training: checks and times ----------------
    def check_models11(res):
        rowptr_u, col_u = A_u1.storage.rowptr(), A_u1.storage.col()
        deg_u = A_u1.storage.rowcount().clamp_min(1).float()[:, None]

        def plain_agg(h, reduce):
            out = csr_spmm_plain(rowptr_u, col_u, None, h)
            return out / deg_u if reduce == "mean" else out

        def kernel_agg(h, reduce):
            return (ts.spmm_mean if reduce == "mean" else ts.spmm_sum)(A_u1, h)

        for cls, fwd in ((GraphSAGE, sage_forward), (GIN, gin_forward)):
            loss_k, grads_k, m, opt = res[cls.__name__]
            rm_ = make_sage_gin(cls)
            kmasks, pmasks = [], []
            with torch.no_grad():
                fwd(rm_, kernel_agg, x_g, relu_recorder(torch, kmasks))
                fwd(rm_, plain_agg, x_g, relu_recorder(torch, pmasks))
            flips = sum(int((k_ != p_).sum()) for k_, p_ in zip(kmasks,
                                                                pmasks))
            max_flips = int(RELU_FLIP_SHARE * sum(k_.numel() for k_ in kmasks))
            ref = nll_loss(fwd(rm_, plain_agg, x_g, relu_replay(kmasks)),
                           labels)
            ref.backward()
            del kmasks, pmasks
            grad_errs = [errors(g, p_.grad)[1]
                         for g, p_ in zip(grads_k, rm_.parameters())]
            loss_err = abs(loss_k - ref.item()) / abs(ref.item())
            ms = timer(lambda: step(m, opt, lambda mm: mm.loss(
                A_u1, x_g, labels)))
            ropt = torch.optim.Adam(rm_.parameters(), lr=1e-2)
            plain_ms = timer(lambda: step(rm_, ropt, lambda mm: nll_loss(
                fwd(mm, plain_agg, x_g, torch.relu), labels)))
            record("model_train", model=cls.__name__, layers=nlayers,
                   widths=[in_dim] + [hid] * (nlayers - 1) + [out_dim],
                   nodes=Mu, nnz=A_u1.nnz(), loss_step1=loss_k,
                   loss_rel_err_vs_plain=loss_err,
                   grad_rel_errs_vs_plain=grad_errs, relu_flips=flips,
                   max_relu_flips=max_flips, gate=KERNEL_GATE,
                   ms_per_step=ms, plain_ms_per_step=plain_ms, card=card)
            if not (np.isfinite(loss_k) and loss_err <= KERNEL_GATE
                    and max(grad_errs) <= KERNEL_GATE and flips <= max_flips):
                failures.append(
                    f"{cls.__name__} training: loss err {loss_err:.3g}, grad "
                    f"errs {max(grad_errs):.3g} (gate {KERNEL_GATE}), ReLU "
                    f"flips {flips} (at most {max_flips})")

    def plain_mean(adj, h):
        deg = adj.storage.rowcount().clamp_min(1).float()[:, None]
        return csr_spmm_plain(adj.storage.rowptr(), adj.storage.col(), None,
                              h) / deg

    def first_step_against_plain(loss_k, grads_k, fwd_kernel, fwd_plain,
                                 labels_, make=None):
        """A fresh model's first step (``make()``, by default phase 13's
        GraphSAGE): the loss and every gradient of the plain CSR version
        with this run's ReLU decisions, against the kernel run's; and the
        ReLU flips between the two runs.  A parameter that the loss does
        not reach has no gradient in either run (an infinite error where
        only one run has one)."""
        rm_ = (make or make_sage_p)()
        kmasks, pmasks = [], []
        with torch.no_grad():
            fwd_kernel(rm_, relu_recorder(torch, kmasks))
            fwd_plain(rm_, relu_recorder(torch, pmasks))
        flips = sum(int((k_ != p_).sum()) for k_, p_ in zip(kmasks, pmasks))
        max_flips = int(RELU_FLIP_SHARE * sum(k_.numel() for k_ in kmasks))
        ref = nll_loss(fwd_plain(rm_, relu_replay(kmasks)), labels_)
        ref.backward()
        grad_errs = [errors(g, p_.grad)[1] if g is not None
                     and p_.grad is not None else (
                         0.0 if g is None and p_.grad is None
                         else float("inf"))
                     for g, p_ in zip(grads_k, rm_.parameters())]
        loss_err = abs(loss_k - ref.item()) / abs(ref.item())
        ok = (np.isfinite(loss_k) and loss_err <= KERNEL_GATE
              and max(grad_errs) <= KERNEL_GATE and flips <= max_flips)
        return ok, dict(loss_rel_err_vs_plain=loss_err,
                        grad_rel_errs_vs_plain=grad_errs, relu_flips=flips,
                        max_relu_flips=max_flips)

    # ---- 12. GraphSAINT-RW training: checks and times ----------------------
    def check_saint12(r):
        import scipy.sparse as sp

        rowptr_h = A_p.storage.numpy_view("rowptr")
        col_h = A_p.storage.numpy_view("col")
        row_h = A_p.storage.numpy_view("row")
        keys = row_h * Mp + col_h
        deg_h = np.diff(rowptr_h)
        S = sp.csr_matrix((np.ones(col_h.shape[0], np.float32), col_h,
                           rowptr_h), shape=(Mp, Mp))
        n_roots, wl, _ = SAINT
        rp, cl = A_p.csr()[:2]
        off_graph, struct_ok, eid_ok, nodes, edges = 0, True, True, [], []
        walks_differing = 0
        for bt in r["batches"]:
            off_graph += walk_steps_off_graph(keys, deg_h, Mp,
                                              bt["walks"].cpu().numpy())
            # The plain walk on the uniforms the main path drew.
            g_ = torch.Generator(device=device)
            g_.set_state(bt["walk_state"])
            rand_b = torch.rand((n_roots, wl), generator=g_, device=device)
            walks_differing += int((random_walk_plain(
                rp, cl, bt["roots"].to(torch.int32), rand_b)
                != bt["walks"]).sum())
            idx = bt["node_idx"].cpu().numpy().astype(np.int64)
            sub = bt["sub"]
            ref = S[idx][:, idx].tocsr()
            ref.sort_indices()
            struct_ok &= bool(
                np.array_equal(sub.storage.numpy_view("rowptr"), ref.indptr)
                and np.array_equal(sub.storage.numpy_view("col"),
                                   ref.indices))
            e = bt["e_id"].cpu().numpy().astype(np.int64)
            eid_ok &= bool(
                np.array_equal(row_h[e], idx[sub.storage.numpy_view("row")])
                and np.array_equal(col_h[e],
                                   idx[sub.storage.numpy_view("col")]))
            nodes.append(int(idx.shape[0]))
            edges.append(int(sub.nnz()))
        del keys, S
        b0 = r["batches"][0]
        sub0 = b0["sub"]
        ok, errs = first_step_against_plain(
            r["losses"][0], r["grads0"],
            lambda m, relu: sage_forward(
                m, lambda h, red: ts.spmm_mean(sub0, h), b0["x"], relu),
            lambda m, relu: sage_forward(
                m, lambda h, red: plain_mean(sub0, h), b0["x"], relu),
            b0["y"])
        roots = b0["roots"].to(torch.int32)
        rand = torch.rand((n_roots, wl), device=device,
                          generator=torch.Generator(device=device).manual_seed(
                              84))
        got = random_walk_kernel(rp, cl, roots, rand)
        k12_differing = int(
            (got != random_walk_plain(rp, cl, roots, rand)).sum())
        k12_ms = timer(lambda: random_walk_kernel(rp, cl, roots, rand))
        k12_device_ms = r.get("walk_device_ms")
        k12_bound = random_walk_bounds(rp, got, rand)
        del got
        # The same step again on batch 0's subgraph, whose host views
        # (row counts, the CSC view of the backward) are now built.
        wm = make_sage_p()
        wopt = torch.optim.Adam(wm.parameters(), lr=1e-3)
        warm_ms = timer(lambda: step(wm, wopt, lambda m: m.loss(
            sub0, b0["x"], b0["y"])))
        record("saint_train", graph="products", nodes=Mp, nnz=A_p.nnz(),
               scale=PRODUCTS_SCALE, roots=n_roots, walk_length=wl,
               widths=[in_p] + [hid_p] * (nl_p - 1) + [out_p],
               launches=phase_launches["12 GraphSAINT-RW training"],
               subgraph_nodes=nodes, subgraph_edges=edges,
               walk_steps_off_graph=off_graph,
               walk_entries_differing_from_plain=walks_differing,
               random_walk_entries_differing=k12_differing,
               structure_equals_scipy=struct_ok,
               e_id_ok=eid_ok, losses=r["losses"],
               saint_subgraph_host_ms=[t_ * 1e3 for t_ in r["saint_s"]],
               step_ms=r["step_ms"], step_ms_warm_views=warm_ms,
               random_walk_ms=k12_ms, random_walk_device_ms=k12_device_ms,
               random_walk_bound_ms=k12_bound[0],
               random_walk_bound_by=k12_bound[1], gate=KERNEL_GATE, **errs,
               card=card)
        if not (ok and off_graph == 0 and walks_differing == 0
                and k12_differing == 0 and struct_ok and eid_ok
                and all(np.isfinite(r["losses"]))):
            failures.append(
                f"GraphSAINT-RW training: first step vs plain {errs}, walk "
                f"steps off the graph {off_graph}, walk entries differing "
                f"from the plain version's {walks_differing} (main path) and "
                f"{k12_differing} (seed-84 uniforms), structure equals scipy "
                f"{struct_ok}, e_id consistent {eid_ok}")

    # ---- 13. neighbour-sampled GraphSAGE: checks and times -----------------
    def check_nb13(r):
        rowptr_h = A_p.storage.numpy_view("rowptr")
        col_h = A_p.storage.numpy_view("col")
        faults = []
        for bt in r["sync_batches"]:
            frontier = bt["targets"].cpu().numpy().astype(np.int64)
            for (adj, n_id), k in zip(bt["hops"], fanouts_p):
                nid = n_id.cpu().numpy().astype(np.int64)
                faults.append(sampled_hop_faults(
                    rowptr_h, col_h, frontier, adj,
                    adj.storage.value().cpu().numpy().astype(np.int64), nid,
                    k))
                frontier = nid
        bad = [f_ for f_ in faults if f_["bad_edges"] or f_["duplicate_rows"]
               or f_["wrong_size_rows"] or not f_["n_id_prefix_ok"]]

        def same_batch(a_, b_):
            return (torch.equal(a_["targets"], b_["targets"]) and all(
                torch.equal(na, nb) and torch.equal(xa.storage.col(),
                                                    xb.storage.col())
                and torch.equal(xa.storage.rowptr(), xb.storage.rowptr())
                and torch.equal(xa.storage.value(), xb.storage.value())
                for (xa, na), (xb, nb) in zip(a_["hops"], b_["hops"])))

        same = len(r["prefetch_batches"]) == len(r["sync_batches"]) and all(
            same_batch(a_, b_) for a_, b_ in zip(r["sync_batches"],
                                                 r["prefetch_batches"]))
        b0 = r["sync_batches"][0]
        ok, errs = first_step_against_plain(
            r["losses"][0], r["grads0"],
            lambda m, relu: sage_mb_logits(m, b0, None, relu),
            lambda m, relu: sage_mb_logits(m, b0, plain_mean, relu),
            b0["y"])
        hop_edges = [[int(a_.nnz()) for a_, _ in bt["hops"]]
                     for bt in r["sync_batches"]]
        # The same step again on batch 0's hops, whose host views are
        # now built.
        wm = make_sage_p()
        wopt = torch.optim.Adam(wm.parameters(), lr=1e-3)
        warm_ms = timer(lambda: step(wm, wopt, lambda m: sage_mb_loss(m, b0)))
        hop_nodes = [[int(n_.shape[0]) for _, n_ in bt["hops"]]
                     for bt in r["sync_batches"]]
        record("sage_minibatch", graph="products", nodes=Mp, nnz=A_p.nnz(),
               batch=batch_p, fanouts=list(fanouts_p),
               widths=[in_p] + [hid_p] * (nl_p - 1) + [out_p],
               launches=phase_launches["13 neighbour-sampled GraphSAGE"],
               hop_edges=hop_edges, hop_nodes=hop_nodes, hop_faults=bad,
               prefetch_batches_equal=same, losses=r["losses"],
               sample_host_ms=[sum(bt["hop_s"]) * 1e3
                               for bt in r["sync_batches"]],
               sample_host_ms_by_hop=[[t_ * 1e3 for t_ in bt["hop_s"]]
                                      for bt in r["sync_batches"]],
               ms_per_batch_sync=r["sync_ms"], step_ms=r["step_ms"],
               step_ms_warm_views=warm_ms,
               ms_per_batch_prefetch=r["prefetch_ms"], gate=KERNEL_GATE,
               **errs, card=card)
        if not (ok and not bad and same and all(np.isfinite(r["losses"]))):
            failures.append(
                f"neighbour-sampled GraphSAGE: first step vs plain {errs}, "
                f"hop faults {bad}, prefetched batches equal {same}")

    # ---- 14. four ranks on one card: checks ------------------------------
    def check_dist14(p):
        ranks, secs = p
        r0 = ranks[0]
        failures.extend(r0["failures"])
        label = (f"{DIST_WORLD} processes share one card; collectives "
                 f"staged through the host by {r0['backend']}: not a "
                 "scaling result")
        for case in r0["cases"]:
            record("dist_four_ranks", **case, backend=r0["backend"],
                   times=label, card=card)
        record("dist_gcn_four_ranks", **r0["dist_gcn"],
               backend=r0["backend"], times=label,
               widths=[in_dim, hid, hid, out_dim],
               spawn_s=secs, worker_s=r0["build_and_cases_s"],
               staged_bytes_by_rank=[r_["staged_bytes"] for r_ in ranks],
               launches_by_rank=[r_["launches"] for r_ in ranks],
               card=card)
        # Phase 16, from the same processes.
        r16 = r0["phase16"]
        failures.extend(r16["failures"])
        for case in r16["cases"]:
            record("dist_hier_2d_four_ranks", **case, grid=list(HIER_GRID),
                   backend=r0["backend"], times=label, card=card)
        record("dist_hier_layout", **r16["hier"],
               always_tiers=r16["always_tiers"], grid=list(HIER_GRID),
               hier_tables_host_s=[r_["phase16"]["hier_tables_s"]
                                   for r_ in ranks],
               staged_bytes_by_rank=[r_["phase16"]["staged_bytes"]
                                     for r_ in ranks],
               launches_by_rank=[r_["phase16"]["launches"] for r_ in ranks],
               hier_launches_by_rank=[r_["phase16"]["launches_hier"]
                                      for r_ in ranks],
               seconds=r16["seconds"], card=card)
        record("dist_gcn_hier_four_ranks", **r16["dist_gcn"],
               grid=list(HIER_GRID), backend=r0["backend"], times=label,
               widths=[in_dim, hid, hid, out_dim], card=card)

    # ---- 15. DistGCN on products: checks and times -------------------------
    def check_dist15(r):
        A_pn, x_pp, y_pp, kmasks = r["A"], r["x"], r["y"], r["kmasks"]
        st = A_pn.storage

        def csr_route(rowptr, col, value, h):
            return _CsrSum.apply(st, value, h)

        in_, hid_, out_, nl_ = PRODUCTS_GCN

        def make():
            return GCN(in_, hid_, out_, num_layers=nl_,
                       generator=torch.Generator().manual_seed(0),
                       device=device)

        rm = make()
        cmasks = relu_masks(torch, lambda a, h: csr_route(*a.csr(), h), rm,
                            A_pn, x_pp)
        flips = sum(int((k_ != c_).sum()) for k_, c_ in zip(kmasks, cmasks))
        del cmasks
        ref = plain_loss(torch, csr_route, rm, A_pn, x_pp, y_pp, kmasks)
        ref.backward()
        grad_errs = [errors(g, p_.grad)[1]
                     for g, p_ in zip(r["grads0"], rm.parameters())]
        loss_err = abs(r["losses"][0] - ref.item()) / abs(ref.item())
        ropt = torch.optim.Adam(rm.parameters(), lr=0.01)
        csr_ms = time_ms(torch, lambda: step(rm, ropt, lambda m: plain_loss(
            torch, csr_route, m, A_pn, x_pp, y_pp)), reps=DIST_STEPS)
        max_flips = int(RELU_FLIP_SHARE * Mp * hid_ * (nl_ - 1))
        launches15 = phase_launches[
            "15 DistGCN on products (world size 1, NCCL)"]
        record("dist_gcn_products", world_size=1, backend="nccl",
               nodes=Mp, nnz=A_pn.nnz(), scale=PRODUCTS_SCALE,
               layout="the port's partition_fine(8, fine_parts=Mp // 512, "
               "grouping='within') of the graph (phase 19's)",
               widths=[in_] + [hid_] * (nl_ - 1) + [out_],
               local_format=r["local_format"],
               blocks=r.get("blocks"), block_bytes=r.get("block_bytes"),
               rest_nnz=r.get("rest_nnz"),
               gcn_norm_host_s=r["gcn_norm_s"],
               launches_step1=r["launches_step1"],
               shard_spmm_launches=launches15["shard_spmm"],
               block_spmm_launches=launches15["block_spmm"],
               losses=r["losses"], step_ms=r["step_ms"],
               csr_route_gcn_step_ms=csr_ms,
               loss_rel_err_vs_csr=loss_err,
               grad_rel_errs_vs_csr=grad_errs, relu_flips=flips,
               max_relu_flips=max_flips, gate=KERNEL_GATE,
               peak_device_bytes=r["peak_bytes"], card=card)
        record("dist_sharded_build", nodes=Mp, nnz=A_pn.nnz(),
               host_s=r["sharded_build_s"], local_format=r["local_format"],
               card=card)
        h = r["hier"]
        h_loss_err = abs(h["loss"] - r["losses"][0]) / abs(r["losses"][0])
        h_grad_errs = [errors(g, g0)[1]
                       for g, g0 in zip(h["grads"], r["grads0"])]
        record("dist_gcn_products_hier", grid=[1, 1], backend="nccl",
               graph="phase 15's products graph", widths=[in_] + [hid_] * (
                   nl_ - 1) + [out_], local_format=h["local_format"],
               host_build_s=h["build_s"], step_ms=h["step_ms"],
               loss=h["loss"], loss_rel_err_vs_halo_step=h_loss_err,
               grad_rel_errs_vs_halo_step=h_grad_errs,
               launches=h["launches"], staged_bytes=h["staged_bytes"],
               gate=KERNEL_GATE, card=card)
        ok = (np.isfinite(r["losses"]).all() and loss_err <= KERNEL_GATE
              and max(grad_errs) <= KERNEL_GATE and flips <= max_flips
              and launches15["shard_spmm"] > 0
              and (r["local_format"] != "hybrid"
                   or launches15["block_spmm"] > 0)
              and h_loss_err <= KERNEL_GATE
              and max(h_grad_errs) <= KERNEL_GATE
              and h["launches"].get("shard_spmm", 0) > 0)
        if not ok:
            failures.append(
                f"phase 15: loss err {loss_err}, grad errs {grad_errs}, "
                f"flips {flips} (max {max_flips}), format "
                f"{r['local_format']}, launches {launches15}; hierarchical "
                f"step loss err {h_loss_err}, grad errs {h_grad_errs}, "
                f"launches {h['launches']}")

    # ---- 17. the gather probe: checks, and its kernels' entries ----------
    def check_probe17(r):
        """The probe's own checks, and the ``kernels`` line entries of
        K13a/K13b/K13c: its times beside each kernel's bound and a
        library call on the same inputs, timed as the probe times
        (``device_time``'s slope), and K13a's and K13c's device ms (a
        ``torch.profiler`` trace) beside the library's."""
        failures.extend(f"phase 17: {f_}" for f_ in r["failures"])
        call_ms = probe_vmem_gather.call_ms
        src = "benchmarks/probe_vmem_gather.py"

        cases = []
        for c, (idx, table) in zip(r["gather"],
                                   probe_vmem_gather.gather_inputs(device)):
            n, (Tt, Kt) = idx.shape[0], table.shape
            t_b = (4 * n + 4 * Tt * Kt + 4 * n * Kt) / HBM_BYTES_PER_S
            cases.append({
                "case": f"T={Tt} K={Kt}", "max_abs_err": c["max_abs_err"],
                "max_rel_err": c["max_rel_err"], "ok": c["exact"],
                "ms": c["ms"], "device_ms": c["device_ms"],
                "pairs_won": c["pairs_won"], "rounds_ms": c["rounds_ms"],
                "library_rounds_ms": c["library_rounds_ms"],
                "plain_ms": c["plain_ms"], "library_ms": c["library_ms"],
                "library_device_ms": c["library_device_ms"],
                "bound_ms": t_b * 1e3, "bound_by": "bytes"})
        entry_a = kernel_entry(
            "smem_gather", "smem_gather.cu", "", cases,
            "torch.index_select(table, 0, idx)",
            f"idx ({probe_vmem_gather.T},) table ({probe_vmem_gather.T}, "
            f"{K}) f32, also T=8")
        entry_a["replaces"] = (f"{src}:45 _call <- :64 gather_kernel, "
                               ":86 gather8_kernel")
        entry_a["device_ms"] = cases[0]["device_ms"]

        h = probe_vmem_gather.scan_input(device)
        Th, Kh = h.shape
        cases = []
        for c in r["scan"]:
            case = {"case": f"R={c['R']}", "max_abs_err": c["max_abs_err"],
                    "max_rel_err": c["max_rel_err"], "ok": c["ok"],
                    "ms": c["ms"], "device_ms": c.get("device_ms"),
                    "plain_ms": c.get("plain_ms"),
                    "library_ms": None}
            b_ = edge_scan_bounds(Th, Kh, c["R"])
            case.update({k_: b_[k_] for k_ in (
                "bound_ms", "bound_by", "bound_sum_ms")})
            if c["R"] == 1:  # one pass is one torch.cumsum
                case["library_ms"] = call_ms(
                    lambda: torch.cumsum(h, dim=0), h, 3)
            cases.append(case)
        entry_b = kernel_entry(
            "edge_scan_loop", "smem_gather.cu", "", cases,
            "torch.cumsum(h, dim=0) (R=1)", f"h ({Th}, {Kh}) f32, R=1, 8, 40")
        entry_b["replaces"] = (f"{src}:45 _call <- :107 kernel of "
                               "_loop_time, :136 c_body")
        entry_b["device_ms"] = cases[0]["device_ms"]
        entry_b.update(us_per_pass=r["scan_us_per_pass"],
                       ns_per_edge=r["scan_ns_per_edge"],
                       device_us_per_pass=r.get("scan_device_us_per_pass"),
                       bound_sum_ms=cases[0]["bound_sum_ms"],
                       instance=last_instance(edge_scan_loop))

        cases = []
        for gname, A_ in (("uniform", A_u), ("community hybrid", A_h)):
            M_, E_ = A_.sparse_size(0), A_.nnz()
            ncols_ = int(torch.unique(A_.csr()[1]).numel())
            for c in r["tiled"]:
                if c["graph"] != gname:
                    continue
                bound, by = csr_bounds(M_, E_, K, ncols_, c["values"])
                cases.append({
                    "case": f"{gname} T={c['T']} "
                            f"{'values' if c['values'] else 'ones'}"
                            f"{', no tile staged' if c['no_staging'] else ''}",
                    "max_abs_err": c["max_abs_err"],
                    "max_rel_err": c["max_rel_err"], "ok": c["ok"],
                    "equal_csr_spmm": c["equal_k1"], "ms": c["ms"],
                    "device_ms": c["device_ms"],
                    "plain_ms": c["plain_ms"], "csr_spmm_ms": c["k1_ms"],
                    "csr_spmm_device_ms": c["k1_device_ms"],
                    "library_ms": c.get("library_ms"),
                    "library_device_ms": c.get("library_device_ms"),
                    "bound_ms": bound, "bound_by": by,
                    **{k_: c[k_] for k_ in (
                        "slab", "pairs", "staged_pairs", "staged_edge_share",
                        "staged_bytes", "smem_edge_bytes", "smem_floor_ms",
                        "direct_gather_bytes", "k1_gather_bytes",
                        "smem_bytes")}})
        for c in r["tiled"]:
            if c["graph"] not in ("uniform", "community hybrid"):
                cases.append({
                    "case": f"{c['graph']} T={c['T']} "
                            f"{'values' if c['values'] else 'ones'}",
                    "max_abs_err": c["max_abs_err"],
                    "max_rel_err": c["max_rel_err"], "ok": c["ok"],
                    "equal_csr_spmm": c["equal_k1"],
                    "staged_pairs": c["staged_pairs"]})
        entry_c = kernel_entry(
            "tiled_spmm", "smem_gather.cu", "", cases,
            "torch.sparse_csr_tensor(...) @ x (cuSPARSE)",
            f"M={Mu} E={Eu} K={K} f32 values, tiles of "
            f"{probe_vmem_gather.TILES[0]} rows, slabs of {r['slab']} "
            "columns")
        entry_c["replaces"] = (f"{src}:45 _call (the design judged at "
                               ":1-25, a CSR SpMM gathering from on-chip "
                               "tiles)")
        entry_c["device_ms"] = cases[0]["device_ms"]
        for e_ in (entry_a, entry_b, entry_c):
            e_["launches"] = launches[e_["name"]]
            kernels.append(e_)
        record("gather_probe", verdict=r["verdict"],
               scan_us_per_pass=r["scan_us_per_pass"],
               scan_device_us_per_pass=r.get("scan_device_us_per_pass"),
               scan_ns_per_edge=r["scan_ns_per_edge"],
               tiled=entry_c["cases"],
               launches=phase_launches["17 gather probe"], card=card)

    # ---- 18. the structural op set: checks ---------------------------------
    def off_card(objs):
        """The tensors of ``objs`` (tensors, ``SparseTensor``s and lists
        of them) that do not lie on the card."""
        n = 0
        for o in objs:
            if isinstance(o, ts.SparseTensor):
                st = o.storage
                n += off_card([t_ for t_ in (
                    st._row, st._rowptr, st._col, st._value, st._rowcount,
                    st._colptr, st._colcount, st._csr2csc, st._csc2csr)
                    if t_ is not None])
            elif isinstance(o, (list, tuple)):
                n += off_card(o)
            elif isinstance(o, torch.Tensor):
                n += o.device.type != "cuda"
        return n

    def check_struct18(r):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        from pytorch_sparse_tpu_torch.segment import segment_sum_csr

        t1 = time.time()
        adj, norm = r["adj"], r["norm"]
        # The degree: the CPU's ordered sum, bit for bit.
        deg_cpu = segment_sum_csr(adj.storage.value().cpu(),
                                  adj.storage.rowptr().cpu())
        deg_bits = bool(torch.equal(r["deg"].cpu(), deg_cpu))
        del deg_cpu
        # gcn_norm and the column sums against float64 host oracles.
        rowptr_h = norm.storage.numpy_view("rowptr")
        row_h = norm.storage.numpy_view("row")
        col_h = norm.storage.numpy_view("col")
        deg64 = np.diff(rowptr_h).astype(np.float64)
        dis64 = np.where(deg64 > 0, deg64, 1.0) ** -0.5 * (deg64 > 0)
        ref = dis64[row_h] * dis64[col_h]
        got = norm.storage.value().cpu().numpy()
        norm_err = float(np.abs(got - ref).max() / np.abs(ref).max())
        ref_col = np.bincount(col_h, weights=ref, minlength=Mp)
        col_err = float(np.abs(r["colsum"].cpu().numpy() - ref_col).max()
                        / np.abs(ref_col).max())
        del ref, ref_col
        # The subgraphs against scipy's A[idx][:, idx], exactly.
        S = sp.csr_matrix((got, col_h, rowptr_h), shape=(Mp, Mp))
        del got

        def same_as_scipy(T, ix):
            want = S[ix][:, ix].tocsr()
            want.sort_indices()
            return bool(
                T.sparse_sizes() == want.shape
                and np.array_equal(T.storage.numpy_view("rowptr"),
                                   want.indptr)
                and np.array_equal(T.storage.numpy_view("col"),
                                   want.indices)
                and np.array_equal(T.storage.value().cpu().numpy(),
                                   want.data))

        sub_ok = same_as_scipy(r["sub"], r["idx"])
        sub_mask_ok = same_as_scipy(r["sub_mask"], np.sort(r["idx"]))
        del S
        # The uniform graph: RCM against scipy's on the union pattern.
        Pat = sp.csr_matrix((np.ones(A_u.nnz()),
                             (A_u.storage.numpy_view("row"),
                              A_u.storage.numpy_view("col"))),
                            shape=(Mu, Mu))
        Pat = (Pat + Pat.T).tocsr()
        perm_ref = reverse_cuthill_mckee(Pat, symmetric_mode=True)
        perm_ok = bool(np.array_equal(r["perm"].cpu().numpy(), perm_ref))
        sym_ok = bool(r["sym"].nnz() == Pat.nnz and r["is_symmetric"])
        bw = (r["sym"].bandwidth(), r["rcm"].bandwidth())
        # The products on the card: torch.sparse's CSR and the legacy
        # tuple spmm against K1 (1e-5), the (E, 8) row sums against the
        # CPU's ordered sum (bits) and a float64 host oracle.
        k1 = csr_spmm(*A_u.csr(), x_u)
        csr_t_err = errors(r["csr_t"] @ x_u, k1)[1]
        legacy_err = errors(r["legacy"], k1)[1]
        del k1
        rp_u = A_u.storage.rowptr()
        s8_bits = bool(torch.equal(
            r["s8"].cpu(), segment_sum_csr(r["v8"].cpu(), rp_u.cpu())))
        v8 = r["v8"].double().cpu().numpy()
        ref8 = np.zeros((Mu, STRUCT_WIDTH))
        np.add.at(ref8, A_u.storage.numpy_view("row"), v8)
        s8_err = float(np.abs(r["s8"].double().cpu().numpy() - ref8).max()
                       / np.abs(ref8).max())
        del v8, ref8
        off = off_card([r[k_] for k_ in (
            "adj", "deg", "dis", "norm", "colsum", "sub", "sub_mask",
            "back", "sym", "rcm", "perm", "blocks", "D", "outs_d", "outs_n",
            "legacy", "s8")] + [r["csr_t"].crow_indices(),
                                r["csr_t"].col_indices(),
                                r["csr_t"].values()])
        launches18 = phase_launches["18 the structural op set"]
        record("structural_ops", graph_products=dict(
                   nodes=Mp, nnz=A_p.nnz(), nnz_with_diag=adj.nnz(),
                   subgraph_nodes=STRUCT_SUBGRAPH, subgraph_nnz=r["sub"].nnz(),
                   row_blocks=STRUCT_ROW_BLOCKS),
               graph_uniform=dict(
                   nodes=Mu, nnz=A_u.nnz(), symmetric_nnz=r["sym"].nnz(),
                   diag_blocks=STRUCT_DIAG_BLOCKS,
                   diag_nnz=r["D"].nnz(), bandwidth_before_after=bw),
               host_s=r["host_s"], launches=launches18,
               degree_equals_cpu_bits=deg_bits, gcn_norm_rel_err=norm_err,
               colsum_rel_err=col_err, subgraph_equals_scipy=sub_ok,
               masked_subgraph_equals_scipy=sub_mask_ok,
               cat_equal=r["cat_equal"], blocks_equal=r["blocks_equal"],
               symmetric=sym_ok, rcm_equals_scipy=perm_ok,
               csr_tensor_product_rel_err=csr_t_err,
               legacy_spmm_rel_err=legacy_err,
               sum_width8_equals_cpu_bits=s8_bits,
               sum_width8_rel_err=s8_err, tensors_off_card=off,
               gate=KERNEL_GATE, check_s=time.time() - t1, card=card)
        bad = [name for name, ok in (
            ("degree equals the CPU's bits", deg_bits),
            ("gcn_norm values", norm_err <= KERNEL_GATE),
            ("column sums", col_err <= KERNEL_GATE),
            ("adj[idx, idx] equals scipy", sub_ok),
            ("adj[mask, mask] equals scipy", sub_mask_ok),
            ("narrow + cat == adj", r["cat_equal"]),
            ("cat_diag blocks back out", r["blocks_equal"]),
            ("to_symmetric", sym_ok), ("RCM equals scipy", perm_ok),
            ("bandwidth after RCM", bw[1] <= bw[0]),
            ("torch.sparse CSR product", csr_t_err <= KERNEL_GATE),
            ("legacy spmm", legacy_err <= KERNEL_GATE),
            ("(E, 8) row sums equal the CPU's bits", s8_bits),
            ("(E, 8) row sums", s8_err <= KERNEL_GATE),
            ("every output on the card", off == 0)) if not ok]
        if bad:
            failures.append(f"phase 18 (structural op set): {bad}")

    # ---- 19. Cluster-GCN on the products partition: checks and times ------
    def check_partition19(r):
        record("products_partition", nodes=Mp, nnz=A_p.nnz(),
               parts=CLUSTER_PARTS, grouping="within", num_workers=0,
               ran_beside="phase 14's four gloo processes",
               **{k_: r[k_] for k_ in (
                   "fine_parts", "total_s", "partition_s", "reorder_s",
                   "multilevel_partitioner_s", "coarsen_clusters_s",
                   "permute_s", "edge_cut", "part_sizes", "balance",
                   "host_peak_bytes_before", "host_peak_bytes_after",
                   "partptr_ok", "perm_ok", "relabel_ok", "on_card",
                   "dtypes", "checks_s")}, card=card)
        bad = [k_ for k_ in ("partptr_ok", "perm_ok", "relabel_ok",
                             "on_card") if not r[k_]]
        if r["dtypes"] != ["torch.int64", "torch.int64"]:
            bad.append(f"dtypes {r['dtypes']}")
        if bad:
            failures.append(f"products partition: {bad}")

    def check_cluster19(r):
        launches19 = phase_launches[
            "19 Cluster-GCN on the products partition"]
        in_, hid_, out_, nl_ = PRODUCTS_GCN
        parts = r["parts"]
        max_flips = int(RELU_FLIP_SHARE * r["part0_nodes"] * hid_
                        * (nl_ - 1))
        record("cluster_gcn", graph="products", nodes=Mp,
               parts=CLUSTER_PARTS, K=CLUSTER_K,
               widths=[in_] + [hid_] * (nl_ - 1) + [out_],
               per_part=parts, epoch_ms=r["epoch_ms"],
               loss_rel_err_vs_plain=r["loss_rel_err_vs_plain"],
               grad_rel_errs_vs_plain=r["grad_rel_errs_vs_plain"],
               relu_flips=r["relu_flips"], max_relu_flips=max_flips,
               gate=KERNEL_GATE, launches=launches19, card=card)
        blocks = any(q["route"].startswith("hybrid") for q in parts)
        bad = [name for name, ok in (
            ("every loss finite", all(np.isfinite(q["loss"])
                                      for q in parts)),
            ("route vs K1 alone", max(q["k1_rel_err_vs_route"]
                                      for q in parts) <= KERNEL_GATE),
            ("part 0 loss", r["loss_rel_err_vs_plain"] <= KERNEL_GATE),
            ("part 0 gradients", max(r["grad_rel_errs_vs_plain"])
             <= KERNEL_GATE),
            ("ReLU flips", r["relu_flips"] <= max_flips),
            ("block kernels on a hybrid route", not blocks or (
                launches19["block_spmm"] > 0
                and launches19["block_spmm_t"] > 0))) if not ok]
        if bad:
            failures.append(f"phase 19 (Cluster-GCN): {bad}; routes "
                            f"{[q['route'] for q in parts]}, launches "
                            f"{launches19}")

    def check_typed20(r):
        import scipy.sparse as sp

        mag = r["mag"]
        colptr, row, seeds = mag["colptr"], mag["row"], mag["seeds"]
        n_nodes = r["n_nodes"]
        batch, fanouts, _ = MAG_BATCH
        n_hgt, hgt_hops = HGT_SAMPLES

        def host(out):
            return [{k: v.cpu().numpy() for k, v in d.items()} for d in out]

        def on_card(out):
            return all(v.device.type == "cuda" and v.dtype == torch.int64
                       for d in out for v in d.values())

        bad = []
        nb, hg, tp, eg = r["neighbor"], r["hgt"], r["temporal"], r["ego"]
        neighbor_faults = [typed_sample_faults(
            colptr, row, *host(out), {"paper": seeds[b]}, fanouts[0],
            len(fanouts)) for b, out in enumerate(nb["outs"])]
        for f_ in neighbor_faults:
            if (f_["bad_edges"] or f_["wrong_size_destinations"]
                    or f_["repeated_ids"] or not f_["seeds_first"]):
                bad.append(f"(a) neighbour sample {f_}")
        hgt_over, hgt_induced = [], []
        for b, out in enumerate(hg["outs"]):
            nid, rws, cls, eids = host(out)
            limit = {t: (batch if t == "paper" else 0) + hgt_hops * n_hgt
                     for t in nid}
            hgt_over += [t for t in nid if nid[t].shape[0] > limit[t]
                         or np.unique(nid[t]).shape[0] != nid[t].shape[0]]
            hgt_induced += induced_faults(sp, colptr, row, n_nodes, nid, rws,
                                          cls, eids)
            if not np.array_equal(nid["paper"][:batch], seeds[b]):
                bad.append(f"(b) batch {b}: papers do not start with seeds")
        if hgt_over or hgt_induced:
            bad.append(f"(b) HGT: over the budget or repeated {hgt_over}, "
                       f"induced edges differ {hgt_induced}")
        nid, rws, cls, eids = host(tp["outs"][0])
        temporal = temporal_faults(nid, rws, cls, {"paper": batch},
                                   {"paper": mag["years"]})
        if any(temporal.values()):
            bad.append(f"(c) temporal {temporal}")
        adj, n_id, e_id, ptr, root_n_id = eg["out"]
        ego = ego_faults(sp, A_p.storage.numpy_view("rowptr"),
                         A_p.storage.numpy_view("col"), eg["roots"],
                         adj.storage.numpy_view("rowptr"),
                         adj.storage.numpy_view("col"),
                         *(t_.cpu().numpy() for t_ in (n_id, e_id, ptr,
                                                       root_n_id)))
        if not all(ego.values()):
            bad.append(f"(d) ego {ego}")
        placed = (all(on_card(x_["outs"][0]) for x_ in (nb, hg, tp))
                  and all(t_.device.type == "cuda" and t_.dtype == torch.int64
                          for t_ in (n_id, e_id, ptr, root_n_id))
                  and adj.storage.col().device.type == "cuda")
        if not placed:
            bad.append("outputs not on the card (or an index not int64)")
        steps = {}
        for name, x_ in (("neighbor", nb), ("hgt", hg), ("temporal", tp)):
            vw, y0 = x_["views0"], x_["y0"]
            ok, errs = first_step_against_plain(
                x_["losses"][0], x_["grads0"],
                lambda m, relu: mag["logits"](m, vw, relu)[:batch],
                lambda m, relu: mag["logits"](m, vw, relu,
                                              plain_mean)[:batch],
                y0, make=mag["make"])
            steps[name] = errs
            if not ok or not all(np.isfinite(x_["losses"])):
                bad.append(f"({name}) step vs plain {errs}")
        adj_e, x_e, y_e = adj, eg["x"], eg["y"]
        ok, errs = first_step_against_plain(
            eg["loss"], eg["grads0"],
            lambda m, relu: sage_forward(
                m, lambda h_, _: ts.spmm_mean(adj_e, h_), x_e,
                relu)[root_n_id],
            lambda m, relu: sage_forward(
                m, lambda h_, _: plain_mean(adj_e, h_), x_e,
                relu)[root_n_id], y_e)
        steps["ego"] = errs
        if not ok:
            bad.append(f"(d) step vs plain {errs}")
        launches20 = phase_launches["20 typed and ego sampling"]
        # The share of a typed call that is the wrapper's concatenation
        # of every relation's arrays (the library's flat encoding).
        from pytorch_sparse_tpu_torch.sample import _native as s_native
        t1 = time.time()
        s_native._relations(list(n_nodes), mag["rel_keys"], colptr, row)
        concat_ms = (time.time() - t1) * 1e3

        def summary(x_):
            return {k_: x_[k_] for k_ in ("host_ms", "views_ms", "step_ms",
                                          "losses", "nodes", "edges")}

        record("typed_sampling", graph="ogbn-mag (synthetic, undirected)",
               nodes=n_nodes, relation_edges=r["edges"],
               feature_bytes=r["feature_bytes"], build_s=r["build_s"],
               phase_s=r["phase_s"], wrapper_concat_ms=concat_ms,
               batch=batch, fanouts=list(fanouts),
               hgt=list(HGT_SAMPLES), widths=list(MAG_WIDTHS),
               neighbor=summary(nb), hgt_sample=summary(hg),
               temporal=summary(tp), neighbor_faults=neighbor_faults,
               temporal_faults=temporal,
               ego=dict(graph="products", roots=SHADOW[0], depth=SHADOW[1],
                        num_neighbors=SHADOW[2], host_ms=eg["host_ms"],
                        step_ms=eg["step_ms"], loss=eg["loss"],
                        nodes=int(n_id.shape[0]), edges=adj.nnz(),
                        **ego),
               steps_vs_plain=steps, gate=KERNEL_GATE, launches=launches20,
               card=card)
        if bad:
            failures.append(f"phase 20 (typed and ego sampling): {bad}")

    def check_reddit21(r):
        import scipy.sparse as sp

        t1 = time.time()
        checks = dict(r["checks"])
        # Each sampled A.A block against scipy's product of the same
        # float64 values (structure exactly, values 1e-6 of max |ref|).
        S = sp.csr_matrix((r["val"], r["cA"], r["rpA"]),
                          shape=(r["nodes"], r["nodes"]))
        same, err = True, 0.0
        for lo, hi, rp, cc, vv in r["blocks"]:
            ref = S[lo:hi] @ S
            ref.sort_indices()
            same = same and bool(np.array_equal(ref.indptr, rp)
                                 and np.array_equal(ref.indices, cc))
            if same and ref.nnz:
                err = max(err, float(np.abs(vv - ref.data).max()
                                     / np.abs(ref.data).max()))
        checks["AA_blocks_structure"] = same
        checks["AA_blocks_values"] = same and err <= 1e-6
        del S
        ok_k1, err_k1 = oracle_check(r["Av"], r["x"], r["out"], KERNEL_GATE)
        checks["k1_oracle"] = ok_k1 and bool(torch.isfinite(r["out"]).all())
        k1_ms = uncounted(lambda: timer(lambda: csr_spmm(*r["csr"], r["x"])))
        k1_bound, k1_by = csr_bounds(r["nodes"], r["nnz"], REDDIT_K,
                                     r["nodes"], True)
        launches21 = phase_launches["21 Reddit pipeline at Reddit's scale"]
        checks["launches"] = {n: c_ for n, c_ in launches21.items()
                              if c_} == {"csr_spmm": 1}
        record("reddit_pipeline", config="BASELINE.json configs[2] (the "
               "JAX package's benchmarks/reddit_pipeline.py, scale 1)",
               nodes=r["nodes"], draws=r["draws"], nnz=r["nnz"],
               spadd_nnz=r["spadd_nnz"], host_s=r["host_s"],
               phase_s=r["phase_s"], diag_AA_sum=r["diag_AA_sum"],
               reciprocated_edges=r["reciprocated_edges"],
               AA_terms_total=r["AA_terms_total"],
               AA_blocks=r["AA_blocks"], AA_rows_a_block=r["AA_rows_a_block"],
               AA_sampled_terms=r["AA_sampled_terms"],
               AA_sampled_nnz=r["AA_sampled_nnz"], AA_s=r["AA_s"],
               AA_terms_per_s=r["AA_terms_per_s"],
               AA_extrapolated_full_s=r["AA_extrapolated_full_s"],
               AA_extrapolated_nnz=r["AA_extrapolated_nnz"],
               AA_count_only_s=r["AA_count_only_s"],
               AA_count_only_terms_per_s=r["AA_count_only_terms_per_s"],
               AA_value_rel_err=err, AA_gate=1e-6,
               host_threads="one (the host library is built without "
               "OpenMP where the compiler cannot link it)"
               if "-fopenmp" not in _build.host_flags() else "OpenMP",
               host_peak_bytes=r["host_peak_bytes"], k1_ms=k1_ms,
               k1_bound_ms=k1_bound, k1_bound_by=k1_by, k1_oracle_rel_err=err_k1,
               k1_gate=KERNEL_GATE, launches=launches21, checks=checks,
               check_s=time.time() - t1, card=card)
        bad = [k_ for k_, v_ in checks.items() if not v_]
        if bad:
            failures.append(f"phase 21 (Reddit pipeline): failed {bad}")

    # ---- 22. the training recipes: checks and times -----------------------
    def check_entry22(r):
        from pytorch_sparse_tpu_torch.sample import _native as sample_native
        from pytorch_sparse_tpu_torch.sample.saint import (
            saint_subgraph_plain)
        from pytorch_sparse_tpu_torch.sample.sample import sample_adj_plain

        t1 = time.time()
        bad = []

        def rel_errs(got, want):
            return [abs(a_ - b_) / abs(b_) for a_, b_ in zip(got, want)]

        # Each recipe's first steps against the same recipe on the CPU.
        cpu_argv = {"train_gcn": ["--epochs", str(RECIPE_CPU_STEPS)],
                    "train_gat": ["--epochs", str(RECIPE_CPU_STEPS)],
                    "train_cluster_gcn": ["--epochs", "1"],
                    "train_sage_minibatch": ["--steps",
                                             str(RECIPE_CPU_STEPS)]}
        cpu = {}
        for label, mod, argv_ in recipes22:
            base = label.split()[0]
            if base not in cpu:
                cpu[base] = mod.main(cpu_argv[base] + ["--device", "cpu"])
            res, ref = r[label], cpu[base]
            errs = rel_errs(res["losses"], ref["losses"])
            ok = (len(errs) == len(ref["losses"]) and max(errs) <= 1e-4
                  and bool(np.isfinite(res["losses"]).all()))
            line = dict(recipe=label, device=res["device"],
                        steps=len(res["losses"]),
                        losses=res["losses"], accuracy=res["accuracy"],
                        ms_per_step=res["ms_per_step"],
                        wall_s=res["wall_s"],
                        route=res.get("route", res.get("routes")),
                        cpu_losses=ref["losses"],
                        loss_rel_errs_vs_cpu=errs, gate=1e-4)
            for k_ in ("steps_per_s", "sample_ms_per_batch", "build_s",
                       "part_sizes", "nnz", "first_step_ms"):
                if k_ in res:
                    line[k_] = res[k_]
            if base == "train_sage_minibatch" and label != base:
                sync_, pre_ = r[base], res
                same = len(sync_["batches"]) == len(pre_["batches"]) and all(
                    np.array_equal(a_["targets"], b_["targets"]) and all(
                        np.array_equal(np.asarray(x_), np.asarray(y_))
                        for k_ in ("n_id", "e_id", "rowptr")
                        for x_, y_ in zip(a_[k_], b_[k_]))
                    for a_, b_ in zip(sync_["batches"], pre_["batches"]))
                line.update(batches_equal_sync=same,
                            losses_equal_sync=sync_["losses"]
                            == pre_["losses"],
                            steps_per_s_sync=sync_["steps_per_s"])
                ok = ok and same and line["losses_equal_sync"]
            record("entry_point", **line, ok=ok, card=card)
            if not ok:
                bad.append(label)

        # The distributed recipe (phase 14's four processes) against the
        # single-card recipe's steps.
        if p14 is None:
            bad.append("train_gcn --distributed (phase 14 failed)")
        else:
            single = r["train_gcn"]["losses"]
            dist_errs = {}
            for rank_res in p14[0]:
                for sched in ("ring", "hier"):
                    dist_errs.setdefault(sched, []).append(max(rel_errs(
                        rank_res["phase22"][sched]["losses"], single)))
            r0 = p14[0][0]["phase22"]
            ok = all(max(v_) <= 1e-4 for v_ in dist_errs.values())
            record("entry_point", recipe="train_gcn --distributed",
                   ran_in="phase 14's four gloo processes on the card",
                   runs={s_: {k_: r0[s_][k_] for k_ in (
                       "losses", "accuracy", "ms_per_step", "world",
                       "slices", "backend", "device")}
                       for s_ in ("ring", "hier")},
                   seconds=r0["seconds"],
                   loss_rel_errs_vs_single_card_by_rank=dist_errs,
                   gate=1e-4, launches_rank0=r0["launches"], ok=ok,
                   card=card)
            if not ok:
                bad.append("train_gcn --distributed")

        # The host library's samplers against their numpy plain versions
        # on phases 12-13's products graph and batches, timed in turn
        # (plain, library, library, plain).
        rowptr_h = A_p.storage.numpy_view("rowptr")
        col_h = A_p.storage.numpy_view("col")

        def pair(plain_fn, lib_fn):
            ms, outs = {"plain": [], "library": []}, {}
            for which in ("plain", "library", "library", "plain"):
                t2 = time.perf_counter()
                outs[which] = (plain_fn if which == "plain" else lib_fn)()
                ms[which].append((time.perf_counter() - t2) * 1e3)
            same_ = all(np.array_equal(a_, b_) for a_, b_ in zip(
                outs["plain"], outs["library"]))
            return ms, same_, outs["library"]

        hops = []
        if nb13 is None:
            bad.append("host samplers (phase 13 failed)")
        else:
            for it, bt in enumerate(nb13["sync_batches"]):
                frontier = bt["targets"].cpu().numpy().astype(np.int64)
                for h, (k_, (_, n_id)) in enumerate(zip(fanouts_p,
                                                        bt["hops"])):
                    seed = 1000 + it * 10 + h
                    ms, same_, out = pair(
                        lambda: sample_adj_plain(rowptr_h, col_h, frontier,
                                                 k_, False, seed),
                        lambda: sample_native.sample_adj(
                            rowptr_h, col_h, frontier, k_, False, seed))
                    same_ = same_ and np.array_equal(
                        out[3], n_id.cpu().numpy())
                    hops.append(dict(batch=it, hop=h,
                                     frontier=int(frontier.shape[0]),
                                     sampled=int(out[1].shape[0]),
                                     library_ms=ms["library"],
                                     plain_ms=ms["plain"], equal=same_))
                    frontier = out[3]
        saints = []
        if saint12 is None:
            bad.append("host samplers (phase 12 failed)")
        else:
            for b_, bt in enumerate(saint12["batches"]):
                idx = bt["node_idx"].cpu().numpy().astype(np.int64)
                ms, same_, out = pair(
                    lambda: saint_subgraph_plain(rowptr_h, col_h, idx, Mp),
                    lambda: sample_native.saint_subgraph(rowptr_h, col_h,
                                                         idx, Mp))
                saints.append(dict(batch=b_, nodes=int(idx.shape[0]),
                                   edges=int(out[0].shape[0]),
                                   library_ms=ms["library"],
                                   plain_ms=ms["plain"], equal=same_))
        samplers_ok = all(h_["equal"] for h_ in hops + saints)
        record("host_samplers", graph="products", nodes=Mp, nnz=A_p.nnz(),
               sample_adj_hops=hops, saint_subgraph=saints,
               host_threads="one (the host library is built without "
               "OpenMP where the compiler cannot link it)"
               if "-fopenmp" not in _build.host_flags() else "OpenMP",
               equal_to_plain=samplers_ok, card=card)
        if not samplers_ok:
            bad.append("host samplers against their plain versions")
        record("entry_points_checks", phase_s=r["seconds"],
               check_s=time.time() - t1,
               launches=phase_launches["22 the training recipes"],
               failed=bad, card=card)
        if bad:
            failures.append(f"phase 22 (training recipes): failed {bad}")

    for label, res, check in (("9", gcn9, check_gcn9),
                              ("10", gat10, check_gat10),
                              ("11", models11, check_models11),
                              ("12", saint12, check_saint12),
                              ("13", nb13, check_nb13),
                              ("14", p14, check_dist14),
                              ("15", dist15, check_dist15),
                              ("17", probe17, check_probe17),
                              ("18", struct18, check_struct18),
                              ("19 (partition)", part19, check_partition19),
                              ("19", cluster19, check_cluster19),
                              ("20", typed20, check_typed20),
                              ("21", reddit21, check_reddit21),
                              ("22", entry22, check_entry22)):
        if res is not None:
            try:
                check(res)
            except Exception:
                failures.append(f"phase {label} checks: "
                                + traceback.format_exc())

    record("script", seconds=time.time() - t_script, card=card)
    results.update(kernels=kernels, launches=launches, failures=failures,
                   card=card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    for f_ in failures:
        print("FAILED:", f_, file=sys.stderr)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
