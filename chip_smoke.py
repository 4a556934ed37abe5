#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dask_ml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --k4-yardstick ROOT`` instead times K4's step and
loss (10c, with 12d's 2^18 x 64 host block, each with its device split),
the K=1 step beside the epoch kernel run as an epoch of one minibatch, and
profiles the minibatch fits' epochs (10e) on the package under ROOT, e.g. a
parent commit unpacked there, to compare two trees in one call.  ``python3 chip_smoke.py --k5-yardstick ROOT`` likewise holds and
times K5 at every (M, K) of 11d, then runs 11b's search once on the host
clock and once under ``torch.profiler`` (K5's device time, the idle share),
on the package under ROOT.  ``python3 chip_smoke.py --k7k10-yardstick ROOT``
times K1a at phase 5's shape, and holds and times K7a (MiniBatchKMeans'
step and the stepped epoch at k = 64), K7b and K10 at 14c's shapes (with
``torch.cdist`` beside ``euclid`` and the ring tile, and the column-sum
pass apart) on the package under ROOT.  ``python3 chip_smoke.py --sweep-yardstick ROOT`` runs
13a's packed ``GridSearchCV`` (one warm search, two timed on the host
clock, one under ``torch.profiler``: K2-OvR's device time and the idle
share) and holds and times 13d's shared-target K2-OvR entries, on the
package under ROOT.  ``python3 chip_smoke.py --prep-phase`` and
``--ensemble-phase`` build their sources and run phase 15 or 16 alone.

Phases, in order; any failure exits non-zero:

1. Environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmul and cuDNN.
2. Build: every kernel source under ``dask_ml_tpu_torch/csrc`` with
   ``nvcc`` for sm_90a, all at once, timed.
3. Kernels against their plain versions on the card, at ragged row counts
   and (d, k) in {(50, 8), (64, 64), (3, 1000), (130, 300), (50, 1729)},
   with fractional masks and candidate holes; plus a bitwise repeat (the
   kernels are deterministic).  ``lloyd_assign`` also against 1729 slots
   with duplicated candidates (exact ties go to the earlier slot) and with
   a single valid slot; it computes only the valid slots.  K2 (both
   variants) at (P, m, d) in ``LOGISTIC_SHAPES``, with fractional masks, a
   last lane of only pad rows and, once more, with lane 1 inactive (its
   outputs must keep their bits); plus a bitwise repeat.  K2-OvR and K2-MN
   (both variants) likewise at ``MULTICLASS_SHAPES``, and K2-MN at
   ``MN_EDGE_SHAPES`` with labels outside [0, K), mask-0 rows and logits
   near ±80.
4. The main path at BASELINE ``configs[1]``: make_blobs 100M x 50 float32
   with 8 centres, generated on the card from a seed;
   ``KMeans(n_clusters=8, random_state=0).fit(X)`` (k-means|| init), then
   ``predict(X)``.  Every kernel must have launched in that run; the fit
   must recover the centres.  Then one more fit under ``torch.profiler``:
   device time by kernel name and the device's idle share over the fit.
   A small explicit-init fit on the card must agree with the same fit on
   the CPU (the plain versions).
5. Each kernel held against its plain version again at the main path's
   shape (100M x 50, k=8: row*d passes 2^31 there and the reduce's float32
   chains are longest), then timed there beside its plain version and its
   bound; ``lloyd_assign_reduce`` also held and timed off the main path
   (``OFF_PATH_SHAPES``: its register path at k=16, its partial path at
   k=64, and both at d=130, on X's data viewed 130 wide); ``lloyd_assign``
   also at the last k-means|| round's shape (all candidate slots, with
   holes; the kernel computes the valid ones), held and timed against its
   plain version taken over row chunks.
6. The ADMM main path at BASELINE ``configs[0]``'s shape: bench.py's
   HIGGS stand-in, 11M x 28 float32 generated on the card from a seed
   (w, X standard normal, y = [sigmoid(Xw) > U]), at 8 shards;
   ``LogisticRegression(solver="admm", C=1e4, max_iter=10,
   solver_kwargs={"inner_iter": 30}).fit(X, y)``.  Both K2 variants must
   have launched in that fit and its plain version never; the cosine of
   ``coef_`` to the true w must be >= 0.999; the same fit through the
   plain version must agree (equal ``n_iter_``, ‖Δβ‖∞ <= 1e-3·‖β‖∞).
   Prints the fit's time, ``n_iter_``, launches, host syncs and peak
   memory; one more fit under ``torch.profiler``; bench.py's fixed-work
   rounds (timed at 2 and 10 rounds, the slope per round); and K2 at the
   main shape held against its plain version, then timed beside it, its
   bound and the library pair (a batched forward and transposed gemv).
7. Multi-class LogisticRegression on the HIGGS width: 11M x 28 float32
   generated on the card from a seed, with K=4 classes drawn from a true
   softmax model (W (4, 28) standard normal, y = argmax_k(X W_k + Gumbel
   noise)), at 8 shards; the phase-6 estimator with
   ``multi_class="ovr"`` (the packed fit, 32 lanes through K2-OvR) and
   ``multi_class="multinomial"`` (through K2-MN).  Each fit must launch its
   kernel and never its plain version, reach 0.98 of the true W's train
   accuracy, and agree with the same fit through the plain versions
   (equal ``n_iter_``, ‖Δβ‖∞ <= 1e-3·‖β‖∞); the multinomial fit's
   ``coef_[k] - coef_[0]`` must have cosine >= 0.999 to ``W[k] - W[0]``.
   Prints each fit's time, ``n_iter_``, launches, host syncs, peak memory
   and, from one more profiled fit each, the idle share.  Then bench.py's
   packed-vs-sequential fixed-work A/B (1M x 28, K=4 and K=16, ``lbfgs``,
   λ=1, 20 iterations, tol 0) with every lane's executed iterations and
   K2-OvR's launches in the K=16 packed run; a multinomial ``lbfgs`` fit at
   the A/B's width with K=16 (K2-MN's launches there); both kernels at the
   phase-7 shapes and at the A/B's (1, 1M, 28), K=16 held against their
   plain versions and timed beside their bounds, their plain versions and
   (K=4) informational comparisons, with each call's launch plan (K2-MN in
   both variants at both shapes, with the MN kernel's and finalize's own
   device time from a short profiler window beside the CUDA-event time);
   and ``dryrun_multichip(8)`` on the card.
8. K2's other families (Normal, Poisson) and its bf16 variants.  8a: the
   variants of ``GLM_VARIANTS`` (Normal and Poisson in float32 and bf16,
   Logistic in bf16) against their plain versions at ``GLM_SHAPES`` (bf16
   lane bases off 16-byte boundaries, fewer rows than a tile, d = 1, 130
   and 2000), lane 1 inactive, masks weighted in [0, 3], Poisson at |η| up
   to 80.  8c, full-width fits at the HIGGS width (11M x 28, 8 shards,
   nothing cut): the phase-6 estimator on the HIGGS stand-in in bf16
   (accuracy within 1e-3 of phase 6's float32 fit, cosine to w >= 0.999);
   ``LogisticRegression`` by ``gradient_descent`` (20 iterations),
   ``proximal_grad`` with L1 (20) and ``newton`` (5) on the float32
   stand-in (accuracy >= 0.98 of phase 6's); ``LinearRegression("admm")``
   on a Normal stand-in (X, w ~ N(0, 1), y = Xw + N(0, 1); cosine to w >=
   0.9999) and ``PoissonRegression("lbfgs")`` on a Poisson stand-in (X ~
   N(0, 1), w ~ N(0, 0.1²), y ~ Poisson(exp(Xw)); cosine >= 0.999), each in
   float32 and bf16.  Each fit prints its host time, ``n_iter_``, launches
   by wrapper, host syncs and peak memory, and runs again through the
   plain versions (equal ``n_iter_``, ‖Δβ‖∞ <= 1e-3·‖β‖∞); one fit of each
   family is profiled for its idle share.  8b: each variant at the main
   path's shape (8, 1.375M, 29) held against its plain version, then timed
   (CUDA events over 20 launches) beside its plain version (3 runs), its
   bound by bytes and the ``torch.bmm`` pair (informational), with K2
   float32 logistic timed again there as the control.
9. TSQR and decomposition at bench.py's ``tsqr_4000000x64`` (4M x 64
   float32, 8 shards, nothing cut): X = Z·diag(s)·Rᵀ + μ generated on the
   card (Z standard normal, R the Q factor of a seeded Gaussian, s_j =
   10·0.9^j for j < 10 and 0.97^(j−10) after, μ_j = 5 + j/8), checked
   against its float64 covariance and uncentred Gram (2^20-row chunks,
   ``eigh``).  9a: ``tsqr`` by both strategies on the centred X
   (‖QR−X‖_F/‖X‖_F ≤ 1e-5, ‖QᵀQ−I‖_max ≤ 1e-4, cholqr2's guard accepts),
   and a 1M x 64 instance of cond ~1e6 (scales 10^(−6j/63), rotated) that
   must take the Householder route within the same bounds; each strategy
   timed (CUDA events, 10 calls) beside bench.py's cost model.  9b:
   ``PCA(10, "full")``, ``PCA(10)`` (auto, randomized here),
   ``TruncatedSVD(10)`` by tsqr and randomized and
   ``IncrementalPCA(10, batch_size=2**18)``, each timed on the host clock
   with its peak memory and host reads, and held to the float64
   eigenpairs (explained variance rtol 1e-4, IncrementalPCA 1e-3; |cos|
   ≥ 0.99999 exact, 0.9999 randomized and incremental; ``mean_`` 1e-4);
   one more PCA full fit profiled; each IncrementalPCA update timed, and
   its float64 Gram and ``eigh`` alone; the randomized sketch products and the
   sketch's TSQR beside their bounds; a small fit of each estimator on
   the card against the CPU (TOL); ``dryrun_multichip(8)`` with its PCA
   section.  9a also repeats ``linalg/tsqr.py :: _local_hh`` HH_REPS times at
   its lanes (8, 500k, 64) and at the IncrementalPCA update's stacked shape
   (262155, 64), and prints how many calls returned a non-finite R (an open
   check on cuSOLVER; printed, not gated).
10. The streamed SGD through K4 (``csrc/sgd.cu``).  10a: K4's three wrappers
   (``sgd_update``, ``sgd_loss``, ``sgd_epoch``) against their plain versions
   taken in float64 (``hold_sgd``: loss rtol 1e-5, the updated coef to
   1e-5·eta·max|g| plus its float32 rounding, t equal) at every loss × K ∈
   {1, 3, 10, 100} at 2^20 x 64, d ∈ {1, 28, 130, 2000}, B = 37 and 256,
   a strided minibatch view (n_mb = 16), margins past ±80, each penalty and
   schedule, fit_intercept off, and the tensor-core path's edges (K ∈ {2, 4,
   16} at d ∈ {1, 64}, K = 16 at d = 256, d = 97); masks weighted in [0, 2)
   with a tenth 0.  The epoch (``hold_epoch``: each step's loss rtol 1e-5,
   the final state to the steps' summed tolerance, the same bits twice)
   at both fits' epochs at full size, n_mb = 2 to 16, a zero-mask minibatch,
   margins past ±80, K ∈ {1, 2, 4, 10, 16}, d ∈ {1, 64, 200, 256, 300}.
   10b: bench.py's ``streamed_sgd_70x1048576x64`` at full size: 70
   device-born blocks of 2^20 x 64 float32 (``stream_classification_blocks``),
   one ``SGDClassifier(random_state=0).partial_fit`` a block, a scalar sync
   every 8; the first 8 blocks also through the plain version (coef within
   1e-4·‖coef‖∞); gates: 70 blocks, peak allocated < 2 GB, cosine to the
   stream's w ≥ 0.99, the last block's loss below the first's, 70 K4
   launches.  10d: the scanned minibatch fit (``batch_size=65536``, 5
   epochs, one K4 epoch launch each), a 10-class one-vs-all fit with early
   stopping (an epoch launch an epoch, K4's value-only variant on the
   held-out rows), 4 multi-class ``partial_fit`` steps on its block and
   ``Incremental(SGDRegressor)`` over a 2^20 x 64 host array, each gated on
   its launches and on accuracy or R².  10c: K4 timed at (1, 2^20, 64),
   K=1 and K=10, on a minibatch view and as an epoch (a step: the epoch's
   time over its 16 steps) (CUDA events, 20 launches; a step or a loss
   queued behind a device sleep, and also at the host's pace) beside its
   plain version, its bound and the addmm + elementwise + mm sequence; each
   step and loss with its device split (``torch.profiler``: the step
   kernel, ``finalize_kernel`` and the gap between them); gate: at K=1 a
   call is one launch, with no ``finalize_kernel``.  10e: 16 blocks of the
   stream under ``torch.profiler``: the device's idle share, device
   operations, runtime launch calls and host syncs a block (gate: K4's K=1
   step one launch a block, no ``finalize_kernel``); then one epoch of each
   minibatch fit: each kernel's device time, the idle time and the host
   clock a step.
11. The search (BASELINE ``configs[4]``) through K5 (``csrc/cohort.cu``).
   11a: K5 against its plain version taken in float64 (``hold_cohort``:
   each lane's loss and count rtol 1e-5, its coef to 1e-5·eta·max|g| plus
   its float32 rounding, t equal, the same bits twice) at M ∈ {1, 2, 5, 34,
   81}, K ∈ {1, 3, 10}, d ∈ {1, 64, 130}, M·K = 810, B = 37 and 2^20 + 3,
   a strided view, each loss, penalty and schedule, fit_intercept off,
   weighted lanes and an all-zero lane; at M = 1 also against K4's
   ``sgd_update``.  11b: 9·2^20 x 64 float32 on the card, y = [X·w +
   logistic noise > 0]; ``HyperbandSearchCV(SGDClassifier(tol=None,
   random_state=0), {"alpha": logspace(-7, 0, 200), "penalty": ["l2"]},
   max_iter=81, test_size=2^20, chunk_size=2^20, random_state=0)`` on the
   device blocks (143 models in 5 brackets, 1581 ``partial_fit`` calls),
   the counts set to 0 just before the fit; gates: ``metadata_ ==
   metadata``, K5 launched and no plain version, ``DISPATCH_STATS``'s
   dispatches equal to K5's launches and at most a quarter of the
   model-steps, ``best_score_`` ≥ 0.98 of the true w's test accuracy, the
   best coef's cosine to w ≥ 0.99; prints the fit's time, peak memory,
   launches by cohort size, host syncs and rounds; one more fit under
   ``torch.profiler`` (idle share, device time by kernel).  11c: a Cohort
   of 81 over the first 8 training blocks through K5 and through the
   plain version (each lane within 1e-4·‖coef‖∞), and 3 members replayed
   alone through K4.  11d: K5 at every cohort size the search launches
   (M in {2, 3, 5, 8, 9, 11, 15, 27, 34, 81} at K = 1) and at (8, 10) on a
   2^20 x 64 block, each held as in 11a, then timed (CUDA events over 20
   launches enqueued behind a device sleep, so that the host's call does
   not pace them) beside its plain version, its bound and the matmul +
   elementwise + matmul sequence, with a ``kernels`` entry for each size
   the search launched; ``packed_accuracy`` of 81 models.
12. The host-fed stream (``configs[3]``'s second slice): files and datasets
   through the input pipeline (``pipeline/``: a prefetch thread, page-locked
   buffers, a side stream) to K4.  A raw float32 file of 32 blocks of
   2^18 x 64 (2 GiB, bench.py's ``streamed_loader_*_262144x64`` block) is
   written from a seeded numpy generator to a temporary directory, after a
   check of its free space.  12a: ``_partial.fit(SGDClassifier(random_state=0),
   ((xb, xb[:, 0] > 0.5) for xb in io.stream_binary_blocks(...)),
   prefetch_depth=d, classes=[0, 1])`` at d = 0 and 2 in turns (0, 2, 2, 0),
   each with ms a block, rows/s, MB/s and the pipeline's split; gates: every
   state equal to a serial in-memory ``partial_fit`` loop over the same
   blocks, K4 once a block, every staged host buffer page-locked.  12b: the
   same rows and labels as a dataset (``data.write_dataset``, 8 shards of
   2^18-row blocks, zlib as by default, then uncompressed), then
   ``Incremental(SGDClassifier(random_state=0))`` over
   ``ShardedDataset(key=0, epochs=2, readers=4)`` at depths 0 and 2 (64
   blocks; gate: equal states).  12c: a depth-2 fit of 12 blocks under
   ``torch.profiler``: the idle share, the host-to-device copies a block,
   their streams against K4's and their overlap, the runtime calls of each
   host thread (the exported trace's system thread ids); gates: every kernel
   launch on the consumer thread, the other threads' calls copies, events
   and allocations only, the device's kernels K4's one-launch step, one
   launch a block, the copies from page-locked memory.  12d: the stage's parts alone (a page-locked and a
   pageable 64 MiB copy; ``read_binary`` of a block from the page cache into
   a fresh array, a reused one and a page-locked buffer; the copy into
   page-locked memory; the labels, the encode, the pad and the stager's put
   of a block; K4 at 2^18 x 64 held and timed beside its bound, with its
   device split and 10c's one-launch gate) and the stream's floor
   max(parse, H2D, K4).  12e:
   ``IncrementalPCA(10, batch_size=2**18)`` over a 2^22 x 64 host array with
   the prefetch knob at 0 and 2 (gate: equal ``components_``).
13. The grid searches (``model_selection/_search.py``) and the packed C-sweep
   (``solvers.lambda_sweep``) through K2-OvR over one shared target and its
   Normal family.  13a: phase 6's HIGGS stand-in (11M x 28 on the card, 8
   shards), ``GridSearchCV(LogisticRegression(max_iter=10,
   solver_kwargs={"inner_iter": 30}), {"C": logspace(-3, 4, 8)}, cv=3)``
   packed (``auto`` on CUDA), refit on: the wall time (host clock after a
   sync; the refit timed again alone), solves, launches by variant, host
   syncs, peak memory, ``SWEEP_STATS`` and K2-OvR's launches by plan path;
   gates: 3 packed folds and none ineligible, K2-OvR's shared-target
   tensor-core path (plan path 3) launched, no plain version,
   ``best_score_`` >= 0.98 of the true w's
   held-out accuracy, the best coef's cosine to w >= 0.99; one more fit
   under ``torch.profiler`` (idle share, device time by kernel).  13b: the
   same grid under ``DASK_ML_TPU_TORCH_GRID_PACK=sequential`` (24 fits and
   a refit), every ``mean_test_score`` within 1e-4 of 13a's, both wall
   times and their ratio.  13c: ``GridSearchCV(LinearRegression(), {"C":
   logspace(0, 6, 5)}, cv=3)`` on phase 8's Normal stand-in, packed and
   sequential, R² within 1e-5.  13d: K2-OvR at the sweep's own shape (x
   (8, m, 29) of 13a's first train fold, one shared y, B (64, 29)), both
   families and variants held against their plain versions and against the
   same kernel on a materialized (8, P, m) copy, then timed (CUDA events,
   20 launches) on both beside the plain version, the bound by bytes (x,
   one y, the mask) and the ``torch.bmm`` pair, with each call's plan path
   (the shared target's tensor-core path, 3; ``ovr_kernel``, 0, on the
   copy); then ``lambda_sweep("lbfgs")``
   against 8 sequential ``lbfgs`` solves at bench.py's
   ``grid_sweep_lbfgs_1000000x28_K8`` (20 iterations, tol 0), in turns.
   13e: ``GridSearchCV(make_pipeline(PCA(), LogisticRegression()),
   {"pca__n_components": [8, 16], "logisticregression__C": [0.1, 1, 10]},
   cv=3)`` on the first 2^22 rows: PCA fitted 2·3 times (+1 for the refit),
   not 6·3.
14. MiniBatchKMeans through K7 (``csrc/minibatch.cu``), the pairwise
   distances through K10 (``csrc/pairwise.cu``) and SpectralClustering's
   Nyström path, on phase 4's blobs (100M x 50, k = 8, made anew).  14a:
   ``MiniBatchKMeans(n_clusters=8, random_state=0, max_iter=3)`` at the
   default batch_size (97,656 steps an epoch, one K7b launch each): the wall
   time, ms an epoch and us a step, ``n_iter_``, ``n_steps_``,
   ``inertia_/n``, K7b, K1b and reseed counts, peak memory, and one epoch
   profiled (idle share, device time by kernel); gates as phase 4's.  14b:
   ``_partial.fit`` of ``MiniBatchKMeans(n_clusters=8, init=14a's
   centres)`` over 16 host blocks of 2^20 x 50 at prefetch depths 0 and 2,
   then the same blocks on the card as ``ShardedRows``: ms a block, the
   fused step's (K1a with K7a's update in its last launch) and K1a's own
   launches a block; gates: every run bit-equal, one fused launch a block
   and no K1a of its own, the centres after 8 blocks within 1e-4·max|c| of
   the plain versions'.  14c: K7a (``k7a_entry``: the fused step at 14b's
   block, bit-equal to K1a then K7a's plain version, timed beside K1a alone
   with its device time by kernel; 1024 steps of the stepped epoch at
   k = 64, its first 32 bit-equal to K1a then K7a's plain version, its host
   and device time and launches a step), K7b over 1024 steps of the first
   2^20 rows and over the main path's epoch (centres within 1e-5 and 1e-4 of
   max|c|, the mean inertia rtol 1e-5), K10 in each epilogue at 14d's and
   14e's shapes (d² within TOL of ‖x−a‖²+‖y−a‖², flagged counts equal) and
   on near-duplicates at an offset of 1e3 (the exact recompute on the card,
   held to the float64 Σ(x−y)²), each timed by CUDA events beside its plain
   version, its bound and (K10's ``euclid``) ``torch.cdist``.  14d:
   ``euclidean_distances`` of 2^20 rows against 1024, ``sqeuclidean`` at the
   same shape, the self ring of 32,768 rows in 8 shards (diagonal exactly 0,
   symmetric within 1e-5·max) and ``pairwise_distances_argmin_min`` of all
   rows against 512 through K1b (indices equal the plain version's off
   near-ties on the first 2^20 rows).  14e:
   ``SpectralClustering(n_clusters=8, random_state=0)`` (rbf, γ = 1/d,
   ``n_components=100``) on the first 10M rows: its phases' times, K10, K1a
   and K1b launches, ``eigenvalues_``; gate: each true blob in one found
   cluster, a different one each, for at least 99% of its rows.
15. Preprocessing, SimpleImputer and GaussianNB: the quantile sketch through
   K12 (``csrc/histogram.cu``), the class moments through K9 and the joint
   log-likelihood through K9b (``csrc/naive_bayes.cu``).  15a: phase 6's
   HIGGS stand-in (11M x 28 on the card) with 1% of its entries set to NaN
   from a seeded generator; ``make_pipeline(SimpleImputer(),
   QuantileTransformer(output_distribution="normal"), GaussianNB())``
   fitted and scored, the counts set to 0 just before and read just after:
   the wall time, the launches (K12 four: the sketch's passes, 11M rows
   being past the 4M-row threshold; K9 both passes; K9b), peak memory; one
   more fit profiled (idle share, device time by kernel).  Gates:
   ``quantiles_`` within the last pass's bin width plus the spread of the
   ranks next to the exact position of ``torch.nanquantile`` on the imputed
   rows (the sketch's value lies in the bin of its target order statistic,
   which is within one rank of that position), and bit-equal on a second
   sketch; ``theta_`` and ``var_`` within rtol 1e-5 of K9's plain
   version on the transformed rows (of the larger of |plain| and the
   class's mean |x|, or its largest variance); predictions equal to the
   plain jll's argmax; ``score`` within 1e-6 of the plain jll's and of the
   whole pipeline run through the plain versions, whose ``quantiles_`` must
   be bit-equal (K12's counts are exact).  15b: ``GaussianNB`` at k = 10 on
   11M x 28 standard normal rows, labels the argmax of X·W plus noise: the
   same gates, and ``predict_proba`` within 1e-6 of the plain jll's
   softmax.  15c: each kernel at its path shape held against its plain
   version (K12's counts equal, K9 as above, K9b bit-equal, each twice with
   the same bits), then timed (CUDA events) beside its plain version, its
   bound and the library call where one exists (K9: the one-hot
   ``torch.mm``; 28 ``torch.histc`` calls printed beside K12, not the same
   function); the same holds at ragged n, d = 130 and d = 1, with an
   outlier (1e9) and a constant column, a narrow window, and fractional
   weights; ``RobustScaler().fit`` (K12 at 3 probs), ``OneHotEncoder`` of 4
   integer columns of 8 categories at 11M rows, and ``StandardScaler.fit``
   against a ``partial_fit`` over 11 blocks of 1M rows (rtol 1e-5).
16. The blockwise voting ensembles through K5′ (``csrc/sgd.cu ::
   sgd_group_step``: an ensemble epoch in one launch, each member on its
   own window of X read in place) and the rest of ``metrics/``.  16a: K5′
   against its plain version taken in float64 (``hold_group``: each
   member's loss and count rtol 1e-5, its coef and intercept to 1e-5 of its
   largest step plus their float32 rounding, hinge's kink rows allowed
   their jump, t equal, the same bits twice) at (M, window, d, K) in
   ``K5P_SHAPES`` with ragged spans, the last window overlapping its
   neighbour, an all-padding member, fractional masks, each loss family,
   penalty and schedule.  16b: X 8·2^20 x 64 float32 on the card with y =
   [sigmoid(X·w) > U] (``datasets.stream_classification_blocks``), a
   10-class target argmax(X·W + N(0, 1)) and a regression target X·w +
   N(0, 1); ``BlockwiseVotingClassifier(SGDClassifier(log_loss, l2,
   tol=None, max_iter=5), n_blocks=8)``, the 10-class soft-voting ensemble
   (K = 10, K5′'s tensor-core path; constant eta0 = 20) and
   ``BlockwiseVotingRegressor(SGDRegressor)`` (constant eta0 = 0.5), the
   counts set to 0 just before each fit and read just after; gates: K5′
   launched once an epoch and its plain version never, no synchronizing
   operation between the first K5′ launch and the end of the last
   (``torch.cuda.set_sync_debug_mode``), each member within 1e-4·‖coef‖∞ of
   the same fit through the plain version on the card, ``score`` at least
   0.98 of the true model's; each fit's wall time and, profiled once more,
   its idle share.  16c: K5′ at (8, 2^20, 64, 1) and (8, 2^20, 64, 10) on
   16b's data, held as in 16a, then timed (CUDA events, queued) in turns
   with 8 launches of K4's ``sgd_update`` on the same windows, beside its
   plain version and its bound by bytes.  16d: the metrics on 16b's
   predictions against numpy float64 versions of their formulas
   (``roc_auc_score`` with ties and weights within 1e-9).  Then the
   ``kernels`` line, the card line and the result.

The script imports nothing of JAX or of the JAX package.  Without CUDA it
prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): device memory rate and float32 on the
# CUDA cores, the unit both kernels run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

MAIN_ROWS = 100_000_000
MAIN_D = 50
MAIN_K = 8
# lloyd_assign_reduce off the main path, (d, k): the register path's last
# k, the partial path, and feature chunks (d > 64) with few and many k
OFF_PATH_SHAPES = ((50, 16), (50, 64), (130, 8), (130, 300))
CHECK_ROWS = 1_000_003  # not a multiple of the 256-row tile
# (3, 1000) tiles the centers; (130, 300) also chunks the features and
# keeps the reduce's partial in global scratch; (50, 1729) is the last
# k-means|| round's candidate slots
CHECK_SHAPES = ((50, 8), (64, 64), (3, 1000), (130, 300), (50, 1729))
TOL = 1e-5
CHUNK = 1 << 20  # rows per step where a float64 or plain pass would not fit
# K2 in phase 3, (P, m, d): one lane, the HIGGS width (28 + intercept), a
# width past one 64-feature multiple with fewer rows a tile, and d = 1
LOGISTIC_SHAPES = ((1, 1001, 3), (8, 1375, 29), (8, 4097, 130), (3, 777, 1))
# phase 6: bench.py's HIGGS stand-in and its ADMM fit
HIGGS_ROWS = 11_000_000
HIGGS_D = 28
HIGGS_SHARDS = 8
ADMM_ROUNDS = 10
ADMM_INNER = 30
ADMM_RTOL = 1e-3  # the fit through the kernel against the fit through the plain version
# K2-OvR and K2-MN in phase 3, (P, m, d, K): K in {1, 2, 3, 4, 5, 16, 100} and d
# in {1, 28, 29, 130, 300, 600, 2000}; m = 1001, 1002, 1003 put the shard
# bases and the target rows off 16-byte boundaries (K2-OvR then stages them
# by cp.async, the aligned ones by bulk copies), m = 37 is less than a tile,
# d = 600 at K = 16 has more gradient columns than a block has threads
# (K2-OvR adds them to the block's record once a tile), and d = 2000 takes
# the wide path (row_kernel).  K2-MN's tensor-core path (d <= 32, K <= 16):
# K = 8 and 9 (one whole n-tile of 8 classes, and one class past it), d = 1..7
# mod 8 at the main path's m (the padded features of the last k-step), and m
# below 16 rows and below a tile; d = 130 and K = 100 take its tiled path
MULTICLASS_SHAPES = ((1, 1001, 29, 2), (8, 1375, 29, 4), (8, 4097, 130, 3), (3, 777, 1, 16),
                     (2, 3001, 29, 100), (2, 300, 2000, 4), (2, 300, 2000, 100),
                     (3, 1001, 29, 4), (2, 1002, 28, 16), (4, 1003, 29, 5), (2, 37, 29, 3),
                     (3, 1000, 29, 1), (2, 1000, 29, 16), (2, 301, 300, 5), (2, 301, 600, 16),
                     (2, 1001, 29, 8), (2, 1001, 29, 9), (2, 1375000, 25, 4),
                     (2, 1375000, 26, 4), (2, 1375000, 27, 4), (2, 1375000, 28, 4),
                     (2, 1375000, 29, 4), (2, 1375000, 30, 4), (2, 1375000, 31, 4),
                     (3, 5, 29, 4), (2, 13, 28, 16), (2, 200, 28, 16))
# K2-MN in phase 3 with labels outside [0, K), mask-0 rows and |η| up to ~80
MN_EDGE_SHAPES = ((2, 3001, 29, 4), (2, 1003, 28, 16), (3, 777, 29, 9))
# phase 7: classes of the softmax stand-in, and bench.py's packed A/B
MC_CLASSES = 4
AB_ROWS = 1_000_000
AB_CLASSES = (4, 16)
AB_ITERS = 20
# phase 8: K2's other families and its bf16 variants, (family, x dtype)
GLM_VARIANTS = (("normal", "float32"), ("normal", "bfloat16"), ("poisson", "float32"),
                ("poisson", "bfloat16"), ("logistic", "bfloat16"))
# (P, m, d) of 8a: m = 1001, 1002, 1003 put bf16 lane bases (58-byte rows at
# d = 29) off 16-byte boundaries, m = 37 is less than a tile, d = 1 and 130
# change the rows a tile, d = 2000 takes row_kernel; lane 1 inactive
GLM_SHAPES = ((3, 1001, 29), (3, 1002, 29), (3, 1003, 29), (2, 37, 29), (3, 777, 1),
              (2, 4097, 130), (2, 300, 2000))
GLM_ETA_MAX = 80.0  # Poisson's largest |η| in 8a: exp stays finite in float32
GLM_WRAPPERS = ("logistic_value_and_grad", "logistic_value", "normal_value_and_grad",
                "normal_value", "poisson_value_and_grad", "poisson_value")
SOLVER_ITERS = {"gradient_descent": 20, "proximal_grad": 20, "newton": 5}
# phase 9: bench.py's ``tsqr_4000000x64`` and the decomposition estimators
PCA_ROWS = 4_000_000
PCA_D = 64
PCA_SHARDS = 8
PCA_K = 10
PCA_PASSES = 11  # the PCA full fit's bound: passes of X (mean 1, centring 2, cholqr2 6, U 2)
ILL_ROWS = 1_000_000  # the cond ~1e6 instance that must take the Householder route
IPCA_BATCH = 1 << 18
TSQR_REPS = 10
SMALL_DECOMP = (20_011, 16)  # the small fits held between the card and the CPU
HH_REPS = 20  # _local_hh calls a shape in the cuSOLVER check
SGD_ROWS = 1 << 20  # bench.py's streamed_sgd_70x1048576x64
SGD_D = 64
SGD_BLOCKS = 70
SGD_WARM = 2
SGD_SYNC = 8  # a scalar sync every 8 blocks, as bench.py's stream
SGD_CHECK = 8  # the stream's first blocks held through K4 and through the plain version
SGD_TOL = 1e-5
SGD_FIT_BATCH = 65536  # 16 minibatch steps an epoch at 2^20 rows
SGD_OVA_K = 10
SGD_EPOCHS = 5  # the binary fits' epochs
SGD_PROFILE = 16
SGD_PARTIAL = 4  # 10d's multi-class partial_fit calls on the 10-class block
# 10c's entries: (name, K, minibatch views or not, wrapper).  Each is timed
# and held at the shape its path gives K4: the stream's blocks, the
# multi-class partial_fit's block, the binary and the 10-class minibatch
# fits' epochs (timed a step: the epoch over its SGD_ROWS // SGD_FIT_BATCH
# minibatches) and the held-out losses.  The K=1 value-only call is kept for
# the record and joins no path; so are the step on one minibatch view, the
# way the parent stepped an epoch, timed as its yardstick.
SGD_TABLE = (
    ("sgd_update", 1, False, "update"),
    ("sgd_loss_K1", 1, False, "loss"),
    ("sgd_epoch_minibatch", 1, True, "epoch"),
    ("sgd_update_minibatch", 1, True, "update"),
    ("sgd_update_K10", SGD_OVA_K, False, "update"),
    ("sgd_loss_K10", SGD_OVA_K, False, "loss"),
    ("sgd_epoch_K10_minibatch", SGD_OVA_K, True, "epoch"),
    ("sgd_update_K10_minibatch", SGD_OVA_K, True, "update"),
)

# phase 11: the search (BASELINE configs[4]) through K5
SEARCH_ROWS = 9 * (1 << 20)  # 8 training blocks of 2^20 and a test split of 2^20
SEARCH_D = 64
SEARCH_CHUNK = 1 << 20
SEARCH_MAX_ITER = 81
COHORT_TOL = 1e-5
# (M, K) of 11d at 2^20 x 64: every cohort size 11b's search launches (all at
# K = 1), and (8, 10), a multi-class cohort off its path
COHORT_TIMES = ((2, 1), (3, 1), (5, 1), (8, 1), (9, 1), (11, 1), (15, 1), (27, 1), (34, 1),
                (81, 1), (8, 10))


# phase 12: the host-fed stream (BASELINE configs[3], second slice)
HOST_ROWS = 1 << 18  # bench.py's streamed_loader_*_262144x64 block
HOST_D = 64
HOST_BLOCKS = 32  # a 2 GiB raw float32 file
HOST_SEED = 12
HOST_SHARDS = 8
HOST_EPOCHS = 2
HOST_PROFILE = 12  # blocks of 12c's profiled depth-2 fit, after a warm block
HOST_READS = 5  # 12d's timed reads of one block from the page cache
IPCA_HOST_ROWS = 1 << 22

# phase 13: the grid searches (13e's pipeline grid runs on the first 2^22 rows)
PREFIX_ROWS = 1 << 22

# phase 15: preprocessing, SimpleImputer and GaussianNB on the HIGGS stand-in
PREP_SEED = 15
PREP_NAN = 0.01  # the share of 15a's entries set to NaN
PREP_K = 10  # 15b's classes
PREP_RTOL = 1e-5
# 15c's edge shapes (n, d): ragged n (not a multiple of a tile or of a block's
# rows), d = 130 (K12's feature chunks, K9's feature tiles) and d = 1
PREP_EDGE_SHAPES = ((1_000_003, 28), (100_003, 130), (77_777, 1))
OHE_COLS, OHE_CATS = 4, 8
SCALER_BLOCK = 1_000_000  # StandardScaler.partial_fit's blocks (11 at the HIGGS rows)

def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(report):
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``, named
    by its kernel and tile (``assign_kernel<8,8,16,...>``), K2's by its
    family and element type (``tiled_kernel<Poisson,bf16,1>``)."""
    name, out = "?", []
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            kern = re.search(r"\d([a-z_]+_kernel)", mangled)
            tile = re.findall(r"L[bi](\d+)E", mangled)
            family = re.search(r"\d(Logistic|Normal|Poisson)E", mangled)  # K2's functor
            loss = re.search(r"\d(LogLoss|Hinge|SquaredHinge|ModifiedHuber|SquaredError|Huber)E",
                             mangled)  # K4's and K5's
            if family:
                tile = [family.group(1), "bf16" if "nv_bfloat16" in mangled else "f32"] + tile
            elif loss:
                tile = [loss.group(1)] + tile
            name = (kern.group(1) if kern else mangled) + (f"<{','.join(tile)}>" if tile else "")
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def check_inputs(torch, n, d, k, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device) * 3
    mask = torch.rand(n, generator=gen, device=device)
    mask[torch.rand(n, generator=gen, device=device) < 0.1] = 0.0
    centers = torch.randn(k, d, generator=gen, device=device) * 3
    cvalid = (torch.rand(k, generator=gen, device=device) < 0.7).float()
    cvalid[0] = 1.0
    return x, mask, centers, cvalid


def near_ties_only(torch, x, centers, got, want, cvalid, what):
    """Number of rows whose labels differ; raises unless each is a near-tie:
    a row whose two smallest d² are within TOL·(‖x‖²+‖c‖²), where the
    float32 expansion may pick either center."""
    rows = torch.nonzero(got != want)[:, 0]
    c64 = centers.double()
    cn = (c64 ** 2).sum(1)
    for s in range(0, rows.shape[0], 1 << 16):
        r = rows[s:s + (1 << 16)]
        xs = x[r].double()
        d2 = torch.cdist(xs, c64) ** 2
        if cvalid is not None:
            d2[:, cvalid <= 0] = float("inf")
        two = torch.topk(d2, min(2, d2.shape[1]), dim=1, largest=False).values
        scale = (xs ** 2).sum(1) + cn[want[r]]
        if not bool(((two[:, -1] - two[:, 0]) < TOL * scale).all()):
            raise AssertionError(f"labels differ off near-ties at {what}")
    return int(rows.shape[0])


def sq_norms(torch, x):
    """‖x‖² per row without an (n, d) temporary."""
    return torch.linalg.vector_norm(x, dim=1) ** 2


def hold_assign(torch, kernel, plain, x, centers, cvalid, what):
    """``lloyd_assign`` (``kernel``: labels, min d², inertia) against its
    plain version (``plain``): inertia rtol TOL, min d² within
    TOL·(‖x‖²+max‖c‖²), labels equal off near-ties, no hole chosen.
    Returns the largest absolute difference."""
    kl, kd2, ki = kernel
    rl, rd2, ri = plain
    torch.testing.assert_close(ki, ri, rtol=TOL, atol=0)
    scale = sq_norms(torch, x) + (centers * centers).sum(1).max()
    if not bool(((kd2 - rd2).abs() <= TOL * scale).all()):
        raise AssertionError(f"min_d2 differs at {what}")
    n_diff = near_ties_only(torch, x, centers, kl, rl, cvalid, what)
    if cvalid is not None and not bool((cvalid[kl] > 0).all()):
        raise AssertionError(f"a candidate hole won the argmin at {what}")
    log(f"  lloyd_assign        {what}: labels differing on near-ties {n_diff}")
    return max(float((kd2 - rd2).abs().max()), float((ki - ri).abs()))


def hold_reduce(torch, lloyd, x, mask, centers, labels, min_d2, what):
    """``lloyd_assign_reduce`` twice (the same bits both times) against the
    plain reduce taken in float64, over row chunks, on ``labels`` (the
    assign kernel's, which computes the same distances): sums within TOL
    of each cluster's Σ|mask·x|, counts and inertia rtol TOL.

    The float32 plain reduce is not the yardstick: its ``index_add_``
    accumulates in atomic order, with an error (~1e-5 of Σ|mask·x| at 10^6
    rows) as large as the tolerance.  Returns the largest absolute
    difference."""
    sums, counts, inertia = lloyd.lloyd_assign_reduce(x, mask, centers)
    again = lloyd.lloyd_assign_reduce(x, mask, centers)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again)):
        raise AssertionError(f"lloyd_assign_reduce is not deterministic at {what}")
    k, d = centers.shape
    s64 = torch.zeros(k, d, dtype=torch.float64, device=x.device)
    mag = torch.zeros_like(s64)
    c64 = torch.zeros(k, dtype=torch.float64, device=x.device)
    i64 = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], CHUNK):
        m = mask[s:s + CHUNK].double()
        lab = labels[s:s + CHUNK]
        xm = x[s:s + CHUNK].double() * m[:, None]
        s64.index_add_(0, lab, xm)
        mag.index_add_(0, lab, xm.abs())
        c64.index_add_(0, lab, m)
        i64 += torch.sum(min_d2[s:s + CHUNK].double() * m)
    worst = float(((sums.double() - s64).abs() / (mag + 1e-300)).max())
    if worst > TOL:
        raise AssertionError(f"sums differ by {worst:.3g} of Σ|mask·x| at {what}")
    torch.testing.assert_close(counts.double(), c64, rtol=TOL, atol=TOL)
    torch.testing.assert_close(inertia.double(), i64, rtol=TOL, atol=0)
    log(f"  lloyd_assign_reduce {what}: sums within {worst:.2e} of Σ|mask·x|, "
        f"deterministic")
    return max(float((sums.double() - s64).abs().max()),
               float((counts.double() - c64).abs().max()),
               float((inertia.double() - i64).abs()))


def compare_kernels(torch, lloyd, device):
    """Phase 3.  Returns the largest absolute difference per kernel."""
    err = {"lloyd_assign_reduce": 0.0, "lloyd_assign": 0.0}
    for d, k in CHECK_SHAPES:
        x, mask, centers, cvalid = check_inputs(torch, CHECK_ROWS, d, k, d * k, device)
        for cv in (None, cvalid):
            what = f"d={d} k={k} cvalid={'holes' if cv is not None else 'none'}"
            kernel = lloyd.lloyd_assign(x, mask, centers, cv)
            torch.cuda.synchronize()
            err["lloyd_assign"] = max(err["lloyd_assign"], hold_assign(
                torch, kernel, lloyd.lloyd_assign_ref(x, mask, centers, cv),
                x, centers, cv, what))
            if cv is None:
                labels, min_d2 = kernel[0], kernel[1]
        err["lloyd_assign_reduce"] = max(err["lloyd_assign_reduce"], hold_reduce(
            torch, lloyd, x, mask, centers, labels, min_d2, f"d={d} k={k}"))
        del x, mask, centers, kernel, labels, min_d2
        torch.cuda.synchronize()
    for what, n_valid, dup in (("duplicated candidates", 502, True),
                               ("one valid slot", 1, False)):
        err["lloyd_assign"] = max(err["lloyd_assign"], hold_candidates(
            torch, lloyd, device, 50, 1729, n_valid, dup, what))
    return err


def hold_candidates(torch, lloyd, device, d, slots, n_valid, dup, what):
    """``lloyd_assign`` against ``slots`` candidate rows of x with
    ``n_valid`` valid (one: the last slot).  ``dup``: six valid slots
    repeat an earlier valid one, and no row may go to the later copy.
    The kernel must compute ``n_valid`` centers, no more."""
    x, mask, _, _ = check_inputs(torch, CHECK_ROWS, d, slots, slots + n_valid, device)
    gen = torch.Generator(device=device).manual_seed(n_valid)
    cand = x[torch.randperm(CHECK_ROWS, generator=gen, device=device)[:slots]].clone()
    cvalid = torch.zeros(slots, device=device)
    if n_valid == 1:
        cvalid[-1] = 1.0
    else:
        cvalid[0] = 1.0
        cvalid[1 + torch.randperm(slots - 1, generator=gen, device=device)[:n_valid - 1]] = 1.0
    valid = torch.nonzero(cvalid)[:, 0].tolist()
    pairs = list(zip(valid[0:12:2], valid[1:12:2])) if dup else []
    for lo, hi in pairs:
        cand[hi] = cand[lo]
    kernel = lloyd.lloyd_assign(x, mask, cand, cvalid)
    torch.cuda.synchronize()
    if lloyd.lloyd_assign.last_k != n_valid:
        raise AssertionError(f"the kernel computed {lloyd.lloyd_assign.last_k} centers, "
                             f"not the {n_valid} valid of {slots} slots, at {what}")
    for lo, hi in pairs:
        if bool((kernel[0] == hi).any()):
            raise AssertionError(f"an exact tie went to slot {hi}, not {lo}, at {what}")
    err = hold_assign(torch, kernel, lloyd.lloyd_assign_ref(x, mask, cand, cvalid),
                      x, cand, cvalid, f"d={d} {slots} slots, {what}")
    log(f"  lloyd_assign        {what}: {slots} slots, {n_valid} valid, "
        f"{lloyd.lloyd_assign.last_k} computed")
    return err


def make_blobs(torch, n, d, k, seed, device):
    """make_blobs' defaults on the card: centres uniform in [-10, 10]^d,
    cluster_std 1.0, each row's centre drawn uniformly."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = torch.rand(k, d, generator=gen, device=device) * 20 - 10
    which = torch.randint(0, k, (n,), generator=gen, device=device)
    x = torch.randn(n, d, generator=gen, device=device)
    step = 1 << 22
    for s in range(0, n, step):
        x[s:s + step] += centres[which[s:s + step]]
    del which
    return x, centres


class PhaseTimes(logging.Handler):
    """Reads the fit's own phase timers (``utils._timer``), the size of the
    k-means|| candidate set (slots, valid ones) and the centers that the
    kernel computed in the last k-means|| pass, which that log line follows."""

    def __init__(self, lloyd):
        super().__init__(logging.DEBUG)
        self.lloyd = lloyd
        self.seconds = {}
        self.candidates = None
        self.computed = None

    def emit(self, record):
        if record.msg.startswith("Finished %s in"):
            self.seconds[record.args[0]] = record.args[1]
        elif record.msg.startswith("k-means|| %d candidate slots"):
            self.candidates = record.args
            self.computed = self.lloyd.lloyd_assign.last_k


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps):
    """``time_ms`` with the device kept busy (a sleep kernel) while the reps
    are enqueued, so that a call shorter than its host side is timed on the
    device, back to back, and not at the host's pace."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bytes_moved, flops):
    """The larger of the memory time and the float32 compute time."""
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def small_fit(torch, device):
    """The same explicit-init fit on the card and on the CPU (the plain
    versions): equal n_iter_, centers and inertia within TOL."""
    from dask_ml_tpu_torch import KMeans
    from dask_ml_tpu_torch.core import use_device

    gen = torch.Generator().manual_seed(3)
    truth = torch.rand(6, 16, generator=gen) * 8 - 4
    which = torch.randint(0, 6, (20_011,), generator=gen)
    xs = truth[which] + torch.randn(20_011, 16, generator=gen)
    init = (truth + 2.0 * torch.randn(6, 16, generator=gen)).numpy()
    fits = {}
    for dev in ("cpu", device):
        with use_device(dev):
            fits[str(dev)] = KMeans(n_clusters=6, init=init).fit(xs.to(dev))
    cpu, card = fits["cpu"], fits[str(device)]
    if card.n_iter_ != cpu.n_iter_:
        raise AssertionError(f"n_iter_ {card.n_iter_} on the card, {cpu.n_iter_} on the CPU")
    torch.testing.assert_close(card.cluster_centers_.cpu(), cpu.cluster_centers_,
                               rtol=TOL, atol=TOL * float(xs.abs().max()))
    if abs(card.inertia_ - cpu.inertia_) > TOL * cpu.inertia_:
        raise AssertionError(f"inertia {card.inertia_} on the card, {cpu.inertia_} on the CPU")
    log(f"small fit 20011x16 k=6: card matches the CPU plain path (n_iter {card.n_iter_}, "
        f"inertia {card.inertia_:.8g} vs {cpu.inertia_:.8g})")


def main_path(torch, lloyd, device, n, d, k):
    """Phase 4: fit + predict on make_blobs, every launch counted."""
    from dask_ml_tpu_torch import KMeans

    t0 = time.perf_counter()
    X, truth = make_blobs(torch, n, d, k, 0, device)
    torch.cuda.synchronize()
    log(f"phase 4: make_blobs {n}x{d} k={k} on the card in {time.perf_counter() - t0:.2f} s")
    timer = PhaseTimes(lloyd)
    km_logger = logging.getLogger("dask_ml_tpu_torch.cluster.k_means")
    km_logger.addHandler(timer)
    km_logger.setLevel(logging.DEBUG)
    torch.cuda.reset_peak_memory_stats()
    lloyd.lloyd_assign_reduce.launches = 0
    lloyd.lloyd_assign.launches = 0
    t0 = time.perf_counter()
    est = KMeans(n_clusters=k, random_state=0).fit(X)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = est.predict(X)
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t0
    launches = {"lloyd_assign_reduce": lloyd.lloyd_assign_reduce.launches,
                "lloyd_assign": lloyd.lloyd_assign.launches}
    km_logger.removeHandler(timer)
    t_init = timer.seconds.get("k-means|| initialization", float("nan"))
    t_lloyd = timer.seconds.get("Lloyd loop", float("nan"))
    log(f"fit {t_fit:.3f} s (k-means|| {t_init:.3f} s, Lloyd {t_lloyd:.3f} s, "
        f"n_iter {est.n_iter_}, {1e3 * t_lloyd / max(est.n_iter_, 1):.3f} ms per round "
        f"on the host clock), predict {t_predict:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    per_row = est.inertia_ / n
    if not per_row <= 1.05 * d:
        raise AssertionError(f"inertia_/n = {per_row} > 1.05 * {d}")
    gap = torch.cdist(truth, est.cluster_centers_).min(dim=1).values
    if not bool((gap <= 0.1).all()):
        raise AssertionError(f"centres not recovered: distances {gap.tolist()}")
    if labels.shape != (n,) or not bool(((labels >= 0) & (labels < k)).all()):
        raise AssertionError("predict returned malformed labels")
    log(f"inertia_/n {per_row:.4f} (<= {1.05 * d}), worst centre error {float(gap.max()):.5f}")
    if timer.candidates is None:
        raise AssertionError("the fit logged no k-means|| candidate set")
    slots, valid = timer.candidates
    log(f"last k-means|| pass: {slots} candidate slots, {valid} valid, "
        f"{timer.computed} computed by the kernel")
    if timer.computed != valid:
        raise AssertionError("the last k-means|| pass computed other centers than the valid ones")
    return X, est, launches, timer.candidates


def profiled_fit(torch, lloyd, X, k, card):
    """Phase 4: one more fit under ``torch.profiler`` (CPU and CUDA
    activities): device time by kernel name, and the device's idle share
    over the fit, (wall − Σ kernel time) / wall on one stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dask_ml_tpu_torch import KMeans

    timer = PhaseTimes(lloyd)
    km_logger = logging.getLogger("dask_ml_tpu_torch.cluster.k_means")
    km_logger.addHandler(timer)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        KMeans(n_clusters=k, random_state=0).fit(X)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    km_logger.removeHandler(timer)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    t_init = 1e3 * timer.seconds.get("k-means|| initialization", float("nan"))
    log(f"phase 4: profiled fit {wall_ms:.3f} ms on the host clock "
        f"(k-means|| {t_init:.3f} ms) [{card}]")
    if not per_name:
        log("  device time by kernel: not measured (the profiler recorded no device event)")
        return
    busy = sum(ms for ms, _ in per_name.values())
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  device {ms:12.3f} ms {count:6d}x  {name[:110]}")
    log(f"  device busy {busy:.3f} ms of {wall_ms:.3f} ms: idle share "
        f"{(wall_ms - busy) / wall_ms:.4f}")


def kernel_table(torch, lloyd, X, centers, launches, card):
    """Phase 5: each kernel held against its plain version at the main
    path's shapes, then timed there (CUDA events) beside its plain version
    and its bound.  ``max_abs_err`` is that check's."""
    (n, d), k = X.shape, centers.shape[0]
    mask = torch.ones(n, device=X.device)
    centers = centers.contiguous()
    what = f"{n}x{d} k={k}"
    log(f"phase 5: kernels vs plain versions at the main path's shape {what}, rtol {TOL}")
    kernel = lloyd.lloyd_assign(X, mask, centers)
    torch.cuda.synchronize()
    max_err = {"lloyd_assign": hold_assign(
        torch, kernel, lloyd.lloyd_assign_ref(X, mask, centers), X, centers, None, what)}
    max_err["lloyd_assign_reduce"] = hold_reduce(
        torch, lloyd, X, mask, centers, kernel[0], kernel[1], what)
    del kernel
    specs = [
        ("lloyd_assign_reduce", lambda: lloyd.lloyd_assign_reduce(X, mask, centers),
         lambda: lloyd.lloyd_assign_reduce_ref(X, mask, centers),
         n * d * 4 + n * 4 + k * d * 4 + (k * d + k + 1) * 4,
         n * (2 * d + 2 * d * k + 4 * k + 2 * d + 3),
         "dask_ml_tpu/cluster/k_means.py:88"),
        ("lloyd_assign", lambda: lloyd.lloyd_assign(X, mask, centers),
         lambda: lloyd.lloyd_assign_ref(X, mask, centers),
         n * d * 4 + n * 4 + k * d * 4 + n * 8 + n * 4 + 4,
         n * (2 * d + 2 * d * k + 4 * k + 2),
         "dask_ml_tpu/cluster/k_means.py:212"),
    ]
    out = []
    for name, kern, plain, nbytes, flops, replaces in specs:
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"{name} at {what}: {ms:.4f} ms, {n / ms * 1e3:.4g} rows/s "
            f"(plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
            f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP) [{card}]")
        out.append({"name": name, "route": "cuda",
                    "source": "dask_ml_tpu_torch/csrc/lloyd.cu", "replaces": replaces,
                    "launches": launches[name], "max_abs_err": max_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out


def reduce_off_path(torch, lloyd, X, shapes, card):
    """Phase 5: ``lloyd_assign_reduce`` at each (d, k) of ``shapes`` on X's
    data viewed d wide (as many whole rows as fit), against k of those rows
    drawn from a seed: held against the plain reduce in float64 on the
    assign kernel's labels, then timed beside its bound."""
    for d, k in shapes:
        n = X.numel() // d
        x = X.view(-1)[:n * d].view(n, d)
        gen = torch.Generator(device=X.device).manual_seed(11)
        centers = x[torch.randint(0, n, (k,), generator=gen, device=X.device)].contiguous()
        mask = torch.ones(n, device=X.device)
        what = f"{n}x{d} k={k}"
        log(f"phase 5: lloyd_assign_reduce vs its plain version at {what} (off the main path)")
        labels, min_d2, _ = lloyd.lloyd_assign(x, mask, centers)
        torch.cuda.synchronize()
        err = hold_reduce(torch, lloyd, x, mask, centers, labels, min_d2, what)
        del labels, min_d2
        ms = time_ms(torch, lambda: lloyd.lloyd_assign_reduce(x, mask, centers), 5)
        b_ms, b_by = bound_ms(n * d * 4 + n * 4 + k * d * 4 + (k * d + k + 1) * 4,
                              n * (2 * d + 2 * d * k + 4 * k + 2 * d + 3))
        log(f"lloyd_assign_reduce at {what}: {ms:.4f} ms, {n / ms * 1e3:.4g} rows/s "
            f"(bound {b_ms:.4f} ms by {b_by}; max abs err {err:.6g}) [{card}]")
        del x, mask, centers
        torch.cuda.synchronize()


def candidate_pass(torch, lloyd, X, slots, valid, card):
    """``lloyd_assign`` at the last k-means|| round's shape: every row
    against ``slots`` candidate rows, ``valid`` of them valid (the fit's
    own counts), the rest holes.  Held against its plain version, which
    runs over row chunks (its (n, slots) distances would not fit), then
    both timed.  The wrapper drops the holes, so the kernel computes the
    ``valid`` slots only; the bound counts their work."""
    n, d = X.shape
    gen = torch.Generator(device=X.device).manual_seed(7)
    cand = X[torch.randint(0, n, (slots,), generator=gen, device=X.device)].contiguous()
    cvalid = torch.zeros(slots, device=X.device)
    cvalid[torch.randperm(slots, generator=gen, device=X.device)[:valid]] = 1.0
    mask = torch.ones(n, device=X.device)
    what = f"{n}x{d} against {slots} slots, {valid} valid"
    log(f"phase 5: lloyd_assign vs its plain version at the k-means|| shape {what}")
    kl, kd2, ki = lloyd.lloyd_assign(X, mask, cand, cvalid)
    torch.cuda.synchronize()
    computed = lloyd.lloyd_assign.last_k
    if computed != valid:
        raise AssertionError(f"the kernel computed {computed} centers, not the {valid} valid")

    def plain():
        parts = [lloyd.lloyd_assign_ref(X[s:s + CHUNK], mask[s:s + CHUNK], cand, cvalid)
                 for s in range(0, n, CHUNK)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                torch.stack([p[2] for p in parts]).sum())

    err = hold_assign(torch, (kl, kd2, ki), plain(), X, cand, cvalid, what)
    del kl, kd2
    ms = time_ms(torch, lambda: lloyd.lloyd_assign(X, mask, cand, cvalid), 3)
    plain_ms = time_ms(torch, plain, 1)
    nbytes = n * d * 4 + n * 4 + slots * (d + 1) * 4 + n * 12 + 4
    flops = n * (2 * d + 2 * d * valid + 4 * valid + 2)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"lloyd_assign at {what}: {computed} centers computed, {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the bound; plain over "
        f"{CHUNK}-row chunks {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"max abs err {err:.6g}) [{card}]")


def logistic_inputs(torch, P, m, d, seed, device):
    """x, y, fractional mask, beta for K2; for P > 1 the last lane holds
    only pad rows (x zero, mask zero), as a shard of padding does."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P, m, d, generator=gen, device=device)
    beta = torch.randn(P, d, generator=gen, device=device) / d ** 0.5
    y = (torch.rand(P, m, generator=gen, device=device) < 0.4).float()
    mask = torch.rand(P, m, generator=gen, device=device)
    mask[torch.rand(P, m, generator=gen, device=device) < 0.1] = 0.0
    if P > 1:
        x[-1] = 0.0
        mask[-1] = 0.0
    return x, y, mask, beta


def logistic_magnitudes(torch, x, y, mask, beta):
    """Σ|terms| of f and of each g element in float64, lane by lane: the
    scale of the float32 rounding of any summation order."""
    f_mag, g_mag = [], []
    for p in range(x.shape[0]):
        xp, yp, mp = x[p].double(), y[p].double(), mask[p].double()
        eta = xp @ beta[p].double()
        f_mag.append((mp * (torch.logaddexp(torch.zeros_like(eta), eta).abs()
                            + (yp * eta).abs())).sum())
        g_mag.append((mp * (torch.sigmoid(eta) - yp)).abs() @ xp.abs())
        del xp
    return torch.stack(f_mag), torch.stack(g_mag)


def hold_logistic(torch, logistic, x, y, mask, beta, what, active=None):
    """Both K2 variants against the plain version on the same inputs: f and
    g within TOL of their Σ|terms| (float64) on the active lanes; lanes
    that are not active are never written (their zeros stay); the two
    variants give the same f; a second call gives the same bits.  Returns
    the largest absolute differences (value-and-grad, value)."""
    P = x.shape[0]
    f, g = logistic.logistic_value_and_grad(x, y, mask, beta, active)
    fv = logistic.logistic_value(x, y, mask, beta, active)
    again = logistic.logistic_value_and_grad(x, y, mask, beta, active)
    torch.cuda.synchronize()
    lanes = (torch.ones(P, dtype=torch.bool, device=x.device) if active is None else active)
    if not (torch.equal(f[lanes], again[0][lanes]) and torch.equal(g[lanes], again[1][lanes])):
        raise AssertionError(f"K2 is not deterministic at {what}")
    if not torch.equal(f[lanes], fv[lanes]):
        raise AssertionError(f"the two K2 variants give different f at {what}")
    off = ~lanes
    if bool(f[off].any()) or bool(fv[off].any()) or bool(g[off].any()):
        raise AssertionError(f"K2 wrote an inactive lane at {what}")
    rf, rg = logistic.logistic_value_and_grad_ref(x, y, mask, beta)
    f_mag, g_mag = logistic_magnitudes(torch, x, y, mask, beta)
    df = (f - rf).abs()[lanes]
    dg = (g - rg).abs()[lanes]
    if not bool((df.double() <= TOL * f_mag[lanes] + 1e-6).all()):
        raise AssertionError(f"K2 f differs from its plain version at {what}")
    if not bool((dg.double() <= TOL * g_mag[lanes] + 1e-6).all()):
        raise AssertionError(f"K2 g differs from its plain version at {what}")
    worst_f = float((df.double() / (f_mag[lanes] + 1e-30)).max())
    worst_g = float((dg.double() / (g_mag[lanes] + 1e-30)).max())
    log(f"  logistic {what}: f within {worst_f:.2e}, g within {worst_g:.2e} of Σ|terms|; "
        f"deterministic; inactive lanes unwritten")
    return float(torch.cat([df, dg.reshape(-1)]).max()), float(df.max())


def compare_logistic(torch, logistic, device):
    """Phase 3 for K2: each shape of LOGISTIC_SHAPES with all lanes active
    and, for P > 1, with lane 1 inactive.  Returns the largest absolute
    differences per wrapper."""
    err = {"logistic_value_and_grad": 0.0, "logistic_value": 0.0}
    for P, m, d in LOGISTIC_SHAPES:
        x, y, mask, beta = logistic_inputs(torch, P, m, d, P * m + d, device)
        actives = [None]
        if P > 1:
            act = torch.ones(P, dtype=torch.bool, device=device)
            act[1] = False
            actives.append(act)
        for act in actives:
            what = f"P={P} m={m} d={d}" + ("" if act is None else " lane 1 inactive")
            e_vg, e_v = hold_logistic(torch, logistic, x, y, mask, beta, what, act)
            err["logistic_value_and_grad"] = max(err["logistic_value_and_grad"], e_vg)
            err["logistic_value"] = max(err["logistic_value"], e_v)
    return err


def higgs_standin(torch, n, d, seed, device):
    """bench.py's stand-in at the HIGGS shape, generated on the card: w and
    X standard normal, y = [σ(Xw) > U] with U uniform on [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(d, generator=gen, device=device)
    X = torch.randn(n, d, generator=gen, device=device)
    y = (torch.sigmoid(X @ w) > torch.rand(n, generator=gen, device=device)).float()
    return X, y, w


def admm_estimator():
    """bench.py's end-to-end fit (``bench.py:1031-1035``)."""
    from dask_ml_tpu_torch import LogisticRegression

    return LogisticRegression(solver="admm", C=1e4, max_iter=ADMM_ROUNDS,
                              solver_kwargs={"inner_iter": ADMM_INNER})


def reset_logistic_counts(logistic, algorithms):
    logistic.logistic_value_and_grad.launches = 0
    logistic.logistic_value.launches = 0
    logistic.logistic_value_and_grad_ref.calls = 0
    algorithms.reset_dispatch_counts()


def admm_main_path(torch, logistic, algorithms, X, y, w, card):
    """Phase 6: ``LogisticRegression(solver='admm')`` on the HIGGS stand-in,
    every K2 launch and host sync counted."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_logistic_counts(logistic, algorithms)
    t0 = time.perf_counter()
    est = admm_estimator().fit(X, y)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = {"logistic_value_and_grad": logistic.logistic_value_and_grad.launches,
                "logistic_value": logistic.logistic_value.launches}
    plain_calls = logistic.logistic_value_and_grad_ref.calls
    syncs = algorithms.HOST_SYNCS["syncs"]
    n, d = X.shape
    log(f"phase 6: ADMM fit {n}x{d} at {HIGGS_SHARDS} shards: {t_fit:.3f} s on the host clock, "
        f"n_iter_ {int(est.n_iter_[0])}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    log(f"launches on the ADMM path: {launches}, plain-version calls {plain_calls}, "
        f"host syncs {syncs}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the ADMM path")
    if plain_calls:
        raise AssertionError(f"the ADMM path called K2's plain version {plain_calls} times")
    coef = est.coef_
    if coef.shape != (d,) or not bool(torch.isfinite(coef).all()):
        raise AssertionError("coef_ is malformed")
    cos = float(coef @ w / (coef.norm() * w.norm()))
    acc = est.score(X, y)
    log(f"train accuracy {acc:.6f}; cosine(coef_, w) {cos:.7f} (>= 0.999); "
        f"‖coef_‖ {float(coef.norm()):.4f}, ‖w‖ {float(w.norm()):.4f}")
    if not cos >= 0.999:
        raise AssertionError(f"cosine between coef_ and the true w is {cos} < 0.999")
    return est, launches, syncs, t_fit


def plain_fit_check(torch, logistic, X, y, est):
    """The same fit again through the kernel (warm: the same bits, since K2
    is deterministic), then with K2's plain version in place of the kernel
    (on the card, as a check only): ‖Δβ‖∞ ≤ ADMM_RTOL·‖β‖∞ and equal
    n_iter_."""
    t0 = time.perf_counter()
    again = admm_estimator().fit(X, y)
    torch.cuda.synchronize()
    log(f"phase 6: the same fit again through the kernel: {time.perf_counter() - t0:.3f} s")
    if not torch.equal(again.betas_, est.betas_):
        raise AssertionError("a second fit through the kernel gave other bits")
    kernel = (logistic.logistic_value_and_grad, logistic.logistic_value)

    def plain_vg(x, y, mask, beta, active=None):
        return logistic.logistic_value_and_grad_ref(x, y, mask, beta, active, True)

    def plain_v(x, y, mask, beta, active=None):
        return logistic.logistic_value_and_grad_ref(x, y, mask, beta, active, False)[0]

    logistic.logistic_value_and_grad, logistic.logistic_value = plain_vg, plain_v
    try:
        t0 = time.perf_counter()
        plain = admm_estimator().fit(X, y)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        logistic.logistic_value_and_grad, logistic.logistic_value = kernel
    diff = float((plain.betas_ - est.betas_).abs().max())
    scale = float(est.betas_.abs().max())
    log(f"phase 6: the same fit through the plain version: {t_plain:.3f} s, n_iter_ "
        f"{int(plain.n_iter_[0])}; ‖Δβ‖∞ {diff:.3e} = {diff / scale:.3e}·‖β‖∞ "
        f"(<= {ADMM_RTOL})")
    if int(plain.n_iter_[0]) != int(est.n_iter_[0]):
        raise AssertionError(f"n_iter_ {int(est.n_iter_[0])} through the kernel, "
                             f"{int(plain.n_iter_[0])} through the plain version")
    if not diff <= ADMM_RTOL * scale:
        raise AssertionError(f"β differs from the plain-version fit by {diff / scale:.3e}·‖β‖∞")


def profiled_admm_fit(torch, algorithms, X, y, card, make=None, label="phase 6: profiled ADMM fit"):
    """Phases 6 and 7: one more fit (``make()``, default the phase-6
    estimator) under ``torch.profiler``: device time by kernel name, and
    the device's idle share over the fit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    make = make or admm_estimator
    torch.cuda.synchronize()
    algorithms.reset_dispatch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make().fit(X, y)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    syncs = algorithms.HOST_SYNCS["syncs"]
    per_name = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
            launches += 1
    log(f"{label} {wall_ms:.3f} ms on the host clock, {syncs} host syncs "
        f"({wall_ms / max(syncs, 1):.4f} ms of host clock a sync) [{card}]")
    if not per_name:
        log("  device time by kernel: not measured (the profiler recorded no device event)")
        return
    busy = sum(ms for ms, _ in per_name.values())
    k2 = [(ms, count) for name, (ms, count) in per_name.items()
          if any(k in name for k in ("tiled_kernel", "ovr_kernel", "tc_kernel", "mn_kernel",
                                     "row_kernel", "finalize_kernel"))]
    k2_ms, k2_launches = sum(ms for ms, _ in k2), sum(c for _, c in k2)
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  device {ms:12.3f} ms {count:7d}x  {name[:110]}")
    log(f"  device busy {busy:.3f} ms of {wall_ms:.3f} ms: idle share "
        f"{(wall_ms - busy) / wall_ms:.4f}; the loss kernels {k2_ms:.3f} ms in {k2_launches} "
        f"launches, the other {launches - k2_launches} launches {busy - k2_ms:.3f} ms")


def fixed_work_rounds(torch, logistic, algorithms, Xi, y, card):
    """Phase 6: bench.py's ``admm_logreg_{n}x{d}_10outer`` workload: the
    solver at fixed work (abstol = reltol = inner_tol = 0, 30 inner
    iterations, λ = 1e-4), timed at 2 and 10 rounds; the slope is the time
    of one round."""
    from dask_ml_tpu_torch.solvers import L2, admm

    def solve(rounds):
        torch.cuda.synchronize()
        reset_logistic_counts(logistic, algorithms)
        t0 = time.perf_counter()
        _, n_it = admm(Xi, y, lamduh=1e-4, max_iter=rounds, regularizer=L2,
                       inner_iter=ADMM_INNER, abstol=0.0, reltol=0.0, inner_tol=0.0,
                       n_shards=HIGGS_SHARDS, return_n_iter=True)
        torch.cuda.synchronize()
        if n_it != rounds:
            raise AssertionError(f"the fixed-work solve ran {n_it} rounds, not {rounds}")
        return (time.perf_counter() - t0, algorithms.HOST_SYNCS["syncs"],
                logistic.logistic_value_and_grad.launches, logistic.logistic_value.launches)

    t2, s2, g2, v2 = solve(2)
    t10, s10, g10, v10 = solve(10)
    per_round = (t10 - t2) / 8
    n = Xi.n_samples
    log(f"phase 6: fixed-work ADMM at {n}x{Xi.data.shape[1]}: 2 rounds {t2:.4f} s "
        f"({s2} syncs), 10 rounds {t10:.4f} s ({s10} syncs): {1e3 * per_round:.3f} ms a round, "
        f"{n / per_round:.4g} rows/s; a round: {(s10 - s2) / 8:.1f} host syncs, "
        f"{(g10 - g2) / 8:.1f} value-and-grad and {(v10 - v2) / 8:.1f} value launches [{card}]")


def logistic_table(torch, logistic, Xi, y, launches, card):
    """Phase 6: K2 at the main path's shape ((8, n/8, 29) lanes of Xi) held
    against its plain version, then both variants timed (CUDA events)
    beside the plain version, the bound and the library pair (a batched
    forward and transposed gemv, informational: no single PyTorch call
    computes K2).  ``max_abs_err`` is that check's."""
    P = HIGGS_SHARDS
    n, d = Xi.data.shape
    m = n // P
    x3 = Xi.data.view(P, m, d)
    y2 = y.reshape(P, m).contiguous()
    m2 = Xi.mask.view(P, m)
    gen = torch.Generator(device=Xi.data.device).manual_seed(3)
    beta = torch.randn(P, d, generator=gen, device=Xi.data.device) / d ** 0.5
    what = f"({P}, {m}, {d})"
    log(f"phase 6: K2 vs its plain version at the main path's shape {what}")
    err_vg, err_v = hold_logistic(torch, logistic, x3, y2, m2, beta, what)
    ms_vg = time_ms(torch, lambda: logistic.logistic_value_and_grad(x3, y2, m2, beta), 20)
    ms_v = time_ms(torch, lambda: logistic.logistic_value(x3, y2, m2, beta), 20)
    plain_vg = time_ms(torch, lambda: logistic.logistic_value_and_grad_ref(x3, y2, m2, beta), 3)
    plain_v = time_ms(
        torch, lambda: logistic.logistic_value_and_grad_ref(x3, y2, m2, beta, grad=False), 3)
    wv = torch.rand(P, m, 1, generator=gen, device=Xi.data.device)
    lib_ms = time_ms(torch, lambda: (torch.bmm(x3, beta[:, :, None]),
                                     torch.bmm(x3.transpose(1, 2), wv)), 20)
    nbytes = n * (d + 2) * 4 + 2 * P * d * 4 + P * 4
    out = []
    for name, ms, plain_ms, flops, err in (
            ("logistic_value_and_grad", ms_vg, plain_vg, 4 * n * d, err_vg),
            ("logistic_value", ms_v, plain_v, 2 * n * d, err_v)):
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"{name} at {what}: {ms:.4f} ms, {n / ms * 1e3:.4g} rows/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of the bound (plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
            f"library pair, informational: {lib_ms:.4f} ms) [{card}]")
        out.append({"name": name, "route": "cuda",
                    "source": "dask_ml_tpu_torch/csrc/logistic.cu",
                    "replaces": "dask_ml_tpu/solvers/families.py:34",
                    "launches": launches[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out



def multiclass_magnitudes(torch, mode, x, y, mask, beta):
    """Σ|terms| of f and of each g element in float64, shard by shard: the
    scale of the float32 rounding of any summation order."""
    P, m, d = x.shape
    f_mag, g_mag = [], []
    for p in range(P):
        xp, mp = x[p].double(), mask[p].double()
        if mode == "ovr":
            K = y.shape[0]
            eta = xp @ beta.view(K, P, d)[:, p].double().T  # (m, K)
            yp = y[:, p].double().T
            sp = torch.logaddexp(torch.zeros_like(eta), eta)
            f_mag.append((mp[:, None] * (sp.abs() + (yp * eta).abs())).sum(0))
            w = (mp[:, None] * (torch.sigmoid(eta) - yp)).abs()
            g_mag.append(w.T @ xp.abs())  # (K, d)
        else:
            K = beta.shape[1] // d
            eta = xp @ beta[p].double().view(d, K)
            c = y[p].long()  # truncation; a label outside [0, K) picks no class
            onehot = torch.nn.functional.one_hot(c.clamp(0, K - 1), K).double()
            onehot *= ((c >= 0) & (c < K))[:, None]
            f_mag.append((mp * (torch.logsumexp(eta, 1).abs()
                                + (eta * onehot).sum(1).abs())).sum().reshape(1))
            w = (mp[:, None] * (torch.softmax(eta, 1) - onehot)).abs()
            g_mag.append((xp.abs().T @ w).reshape(1, d * K))
        del xp
    if mode == "ovr":  # lanes k*P + p
        return torch.stack(f_mag, 1).reshape(-1), torch.stack(g_mag, 1).reshape(-1, d)
    return torch.cat(f_mag), torch.cat(g_mag)


def multiclass_wrappers(multiclass, mode):
    if mode == "ovr":
        return (multiclass.logistic_ovr_value_and_grad, multiclass.logistic_ovr_value,
                multiclass.logistic_ovr_value_and_grad_ref)
    return (multiclass.multinomial_value_and_grad, multiclass.multinomial_value,
            multiclass.multinomial_value_and_grad_ref)


def hold_multiclass(torch, multiclass, mode, x, y, mask, beta, what, active=None):
    """Both variants of K2-OvR (``mode`` "ovr") or K2-MN ("mn") against the
    plain version on the same inputs taken in float64 (the float32 plain
    K2-MN's gradient is a gemm whose sums over 1.375M rows carry an error
    past TOL·Σ|terms| themselves): f and g within TOL of their Σ|terms|
    on the active lanes; inactive lanes never written; the same f from
    both variants; a second call gives the same bits.  Returns the largest
    absolute differences (value-and-grad, value)."""
    vg, v, ref = multiclass_wrappers(multiclass, mode)
    f, g = vg(x, y, mask, beta, active)
    fv = v(x, y, mask, beta, active)
    again = vg(x, y, mask, beta, active)
    torch.cuda.synchronize()
    lanes = torch.ones(f.shape[0], dtype=torch.bool, device=x.device) if active is None else active
    if not (torch.equal(f[lanes], again[0][lanes]) and torch.equal(g[lanes], again[1][lanes])):
        raise AssertionError(f"{mode} is not deterministic at {what}")
    if not torch.equal(f[lanes], fv[lanes]):
        raise AssertionError(f"the two {mode} variants give different f at {what}")
    off = ~lanes
    if bool(f[off].any()) or bool(fv[off].any()) or bool(g[off].any()):
        raise AssertionError(f"{mode} wrote an inactive lane at {what}")
    rf, rg = ref(x.double(), y.double(), mask.double(), beta.double())
    f_mag, g_mag = multiclass_magnitudes(torch, mode, x, y, mask, beta)
    df, dg = (f.double() - rf).abs()[lanes], (g.double() - rg).abs()[lanes]
    del rf, rg
    worst_f = float((df / (f_mag[lanes] + 1e-30)).max())
    worst_g = float((dg / (g_mag[lanes] + 1e-30)).max())
    if not bool((df <= TOL * f_mag[lanes] + 1e-6).all()):
        raise AssertionError(f"{mode} f differs from its plain version at {what} ({worst_f:.3g})")
    if not bool((dg <= TOL * g_mag[lanes] + 1e-6).all()):
        raise AssertionError(f"{mode} g differs from its plain version at {what} ({worst_g:.3g})")
    log(f"  {mode} {what}: f within {worst_f:.2e}, g within {worst_g:.2e} of Σ|terms|; "
        f"deterministic; inactive lanes unwritten")
    return float(torch.cat([df, dg.reshape(-1)]).max()), float(df.max())


def multiclass_inputs(torch, mode, P, m, d, K, seed, device):
    """x, targets, fractional mask, beta and the lane count; for P > 1 the
    last shard holds only pad rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P, m, d, generator=gen, device=device)
    mask = torch.rand(P, m, generator=gen, device=device)
    mask[torch.rand(P, m, generator=gen, device=device) < 0.1] = 0.0
    if P > 1:
        x[-1] = 0.0
        mask[-1] = 0.0
    if mode == "ovr":
        y = (torch.rand(K, P, m, generator=gen, device=device) < 0.4).float()
        beta = torch.randn(K * P, d, generator=gen, device=device) / d ** 0.5
        return x, y, mask, beta, K * P
    y = torch.randint(0, K, (P, m), generator=gen, device=device).float()
    beta = torch.randn(P, d * K, generator=gen, device=device) / d ** 0.5
    return x, y, mask, beta, P


def compare_multiclass(torch, multiclass, device):
    """Phase 3 for K2-OvR and K2-MN: each shape of MULTICLASS_SHAPES with
    all lanes active and with lane 1 inactive.  Returns the largest
    absolute differences per wrapper."""
    err = {}
    for mode in ("ovr", "mn"):
        vg, v, _ = multiclass_wrappers(multiclass, mode)
        err[vg.__name__] = err[v.__name__] = 0.0
        for P, m, d, K in MULTICLASS_SHAPES:
            x, y, mask, beta, lanes = multiclass_inputs(torch, mode, P, m, d, K, P * m + d + K,
                                                        device)
            act = torch.ones(lanes, dtype=torch.bool, device=device)
            act[min(1, lanes - 1)] = False
            for a in (None, act) if lanes > 1 else (None,):
                what = f"P={P} m={m} d={d} K={K}" + ("" if a is None else " lane 1 inactive")
                e_vg, e_v = hold_multiclass(torch, multiclass, mode, x, y, mask, beta, what, a)
                err[vg.__name__] = max(err[vg.__name__], e_vg)
                err[v.__name__] = max(err[v.__name__], e_v)
            del x, y, mask, beta
    vg, v = multiclass.multinomial_value_and_grad, multiclass.multinomial_value
    for P, m, d, K in MN_EDGE_SHAPES:
        x, y, mask, beta, lanes = multiclass_inputs(torch, "mn", P, m, d, K, P * m + d, device)
        y[:, ::7] = -1.0  # no class
        y[:, 3::7] = float(K)  # no class
        y[:, 5::7] = 2.7  # class 2
        beta *= 80.0 / 3.0  # η = x·β with a standard deviation near 27
        top = float(torch.einsum("pmd,pdk->pmk", x, beta.view(P, d, K)).abs().max())
        act = torch.ones(lanes, dtype=torch.bool, device=device)
        act[1] = False
        for a in (None, act):
            what = (f"P={P} m={m} d={d} K={K} labels -1, K, 2.7, max |η| {top:.1f}"
                    + ("" if a is None else " lane 1 inactive"))
            e_vg, e_v = hold_multiclass(torch, multiclass, "mn", x, y, mask, beta, what, a)
            err[vg.__name__] = max(err[vg.__name__], e_vg)
            err[v.__name__] = max(err[v.__name__], e_v)
        del x, y, mask, beta
    return err


def softmax_standin(torch, n, d, K, seed, device):
    """The HIGGS-width stand-in with K classes from a true softmax model,
    generated on the card: W (K, d) and X standard normal, y =
    argmax_k(X W_k + Gumbel noise), as float class indices."""
    gen = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn(K, d, generator=gen, device=device)
    X = torch.randn(n, d, generator=gen, device=device)
    u = torch.rand(n, K, generator=gen, device=device).clamp_(min=1e-12)
    y = torch.argmax(X @ W.T - torch.log(-torch.log(u)), dim=1).float()
    return X, y, W


def mc_estimator(multi_class):
    from dask_ml_tpu_torch import LogisticRegression

    return LogisticRegression(solver="admm", C=1e4, max_iter=ADMM_ROUNDS,
                              multi_class=multi_class,
                              solver_kwargs={"inner_iter": ADMM_INNER})


def reset_multiclass_counts(multiclass, logistic, algorithms):
    for mode in ("ovr", "mn"):
        vg, v, ref = multiclass_wrappers(multiclass, mode)
        vg.launches = v.launches = ref.calls = 0
    reset_logistic_counts(logistic, algorithms)


def multiclass_fit(torch, multiclass, logistic, algorithms, X, y, W, acc_true, multi_class,
                   card):
    """Phase 7: one multi-class fit, every launch and host sync counted.
    Returns (estimator, launches of its kernel's two wrappers)."""
    mode = "ovr" if multi_class == "ovr" else "mn"
    vg, v, ref = multiclass_wrappers(multiclass, mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_multiclass_counts(multiclass, logistic, algorithms)
    t0 = time.perf_counter()
    est = mc_estimator(multi_class).fit(X, y)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = {vg.__name__: vg.launches, v.__name__: v.launches}
    plain = {f.__name__: f.calls for f in (
        multiclass.logistic_ovr_value_and_grad_ref, multiclass.multinomial_value_and_grad_ref,
        logistic.logistic_value_and_grad_ref)}
    k2 = logistic.logistic_value_and_grad.launches + logistic.logistic_value.launches
    n, d = X.shape
    log(f"phase 7: {multi_class} ADMM fit {n}x{d} K={MC_CLASSES} at {HIGGS_SHARDS} shards "
        f"({algorithms.DISPATCH_COUNTS['solves']} solve(s)): {t_fit:.3f} s on the host clock, "
        f"n_iter_ {est.n_iter_.tolist()}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    log(f"launches in the {multi_class} fit: {launches}, K2 launches {k2}, plain-version calls "
        f"{plain}, host syncs {algorithms.HOST_SYNCS['syncs']}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched in the {multi_class} fit")
    if any(plain.values()):
        raise AssertionError(f"the {multi_class} fit called a plain version: {plain}")
    if not bool(torch.isfinite(est.betas_).all()) or tuple(est.coef_.shape) != (MC_CLASSES, d):
        raise AssertionError(f"the {multi_class} fit's coef_ is malformed")
    acc = est.score(X, y)
    log(f"train accuracy {acc:.6f} (the true W's {acc_true:.6f}; >= 0.98 of it)")
    if not acc >= 0.98 * acc_true:
        raise AssertionError(f"{multi_class} accuracy {acc} < 0.98 * {acc_true}")
    if multi_class == "multinomial":
        coef = est.coef_
        cos = [float(torch.nn.functional.cosine_similarity(coef[k] - coef[0], W[k] - W[0], dim=0))
               for k in range(1, MC_CLASSES)]
        log(f"cosine(coef_[k] - coef_[0], W[k] - W[0]) for k = 1..{MC_CLASSES - 1}: "
            f"{[round(c, 7) for c in cos]} (>= 0.999)")
        if not min(cos) >= 0.999:
            raise AssertionError(f"multinomial coefficients off the true W: cosines {cos}")
    return est, launches


def plain_multiclass_fit(torch, multiclass, X, y, est, multi_class):
    """The same fit with K2-OvR's and K2-MN's plain versions in place of the
    kernels (on the card, as a check only): equal n_iter_ and ‖Δβ‖∞ ≤
    ADMM_RTOL·‖β‖∞.  For the multinomial fit β is held with its mean over
    the classes taken out: the softmax is the same when one vector is added
    to every class's row, so that component is fixed only by the weak
    penalty (λ = 1e-4) and ADMM's ρ term, and the inner solves' stops at
    the float32 noise floor leave it wherever the last accepted step put
    it.  The raw ‖Δβ‖∞ is printed beside it."""
    names = ("logistic_ovr_value_and_grad", "logistic_ovr_value", "multinomial_value_and_grad",
             "multinomial_value")
    kernels = {name: getattr(multiclass, name) for name in names}

    def plain(ref, grad):
        def call(x, yv, mask, beta, active=None):
            out = ref(x, yv, mask, beta, active, grad)
            return out if grad else out[0]
        return call

    ovr, mn = multiclass.logistic_ovr_value_and_grad_ref, multiclass.multinomial_value_and_grad_ref
    for name, fn in zip(names, (plain(ovr, True), plain(ovr, False), plain(mn, True),
                                plain(mn, False))):
        setattr(multiclass, name, fn)
    try:
        t0 = time.perf_counter()
        other = mc_estimator(multi_class).fit(X, y)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        for name, fn in kernels.items():
            setattr(multiclass, name, fn)
    delta = other.betas_ - est.betas_
    raw = float(delta.abs().max())
    scale = float(est.betas_.abs().max())
    if multi_class == "multinomial":
        delta = delta - delta.mean(dim=0, keepdim=True)
    diff = float(delta.abs().max())
    log(f"phase 7: the {multi_class} fit through the plain versions: {t_plain:.3f} s, n_iter_ "
        f"{other.n_iter_.tolist()}; ‖Δβ‖∞ {diff:.3e} = {diff / scale:.3e}·‖β‖∞ (<= {ADMM_RTOL})"
        + (f", with the class mean taken out; raw ‖Δβ‖∞ {raw:.3e} = {raw / scale:.3e}·‖β‖∞"
           if multi_class == "multinomial" else ""))
    if other.n_iter_.tolist() != est.n_iter_.tolist():
        raise AssertionError(f"n_iter_ {est.n_iter_.tolist()} through the kernels, "
                             f"{other.n_iter_.tolist()} through the plain versions")
    if not diff <= ADMM_RTOL * scale:
        raise AssertionError(f"β differs from the plain-version fit by {diff / scale:.3e}·‖β‖∞")


def ab_data(torch, device):
    """Bench.py's packed A/B data (``bench.py:1812-1900``), generated on
    the card: X (n, 28) standard normal, W (16, 28), and the learnable
    targets Y = (X·Wᵀ > 0) as (16, n)."""
    gen = torch.Generator(device=device).manual_seed(5)
    X = torch.randn(AB_ROWS, HIGGS_D, generator=gen, device=device)
    Wall = torch.randn(max(AB_CLASSES), HIGGS_D, generator=gen, device=device)
    Yall = (X @ Wall.T > 0).float().T.contiguous()
    return X, Wall, Yall


def packed_ab(torch, multiclass, X, Yall, card):
    """Phase 7: bench.py's ``packed_ovr_fixedwork_{n}x{d}_K{K}`` A/B
    (``bench.py:1812-1900``): learnable targets (X·Wᵀ > 0), ``lbfgs`` with
    λ = 1, 20 iterations, tol 0, backtracking; the packed arm (K lanes of
    one solve through K2-OvR) against the sequential one (K solves through
    K2), each timed as the median of 3 runs after a warm-up.  Returns the
    K2-OvR launches of each K's first packed run."""
    import os

    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.solvers import packed_solve

    sX = shard_rows(X, n_shards=1)
    prev = os.environ.get("DASK_ML_TPU_TORCH_PACK")
    launches = {}
    try:
        for K in AB_CLASSES:
            Y = Yall[:K].contiguous()
            iters, times = {}, {}
            for arm in ("packed", "sequential"):
                os.environ["DASK_ML_TPU_TORCH_PACK"] = arm

                def run():
                    _, nit = packed_solve("lbfgs", sX, Y, lamduh=1.0, max_iter=AB_ITERS, tol=0.0,
                                          line_search="backtrack")
                    torch.cuda.synchronize()
                    return nit

                vg, v = multiclass.logistic_ovr_value_and_grad, multiclass.logistic_ovr_value
                vg.launches = v.launches = 0
                iters[arm] = run().tolist()
                if arm == "packed":
                    launches[K] = {vg.__name__: vg.launches, v.__name__: v.launches}
                runs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    run()
                    runs.append(time.perf_counter() - t0)
                times[arm] = sorted(runs)[1]
            matched = all(i == AB_ITERS for arm in iters for i in iters[arm])
            log(f"phase 7: packed_ovr_fixedwork_{AB_ROWS}x{HIGGS_D}_K{K}: packed "
                f"{1e3 * times['packed']:.3f} ms, sequential {1e3 * times['sequential']:.3f} ms "
                f"(median of 3, host clock): packed speedup "
                f"{times['sequential'] / times['packed']:.3f}x; executed iterations packed "
                f"{iters['packed']}, sequential {iters['sequential']}; work_matched "
                f"{str(matched).lower()} [{card}]")
            if launches[K]["logistic_ovr_value_and_grad"] < 1:
                raise AssertionError(f"the packed arm at K={K} did not launch K2-OvR")
    finally:
        if prev is None:
            os.environ.pop("DASK_ML_TPU_TORCH_PACK", None)
        else:
            os.environ["DASK_ML_TPU_TORCH_PACK"] = prev
    return launches


def ab_multinomial_fit(torch, multiclass, X, Wall, device, card):
    """Phase 7: K2-MN driven at the A/B's width and K=16: a multinomial
    ``lbfgs`` fit (no intercept, so the kernel sees (1, n, 28)) of the
    16-class labels argmax_k(X·W_kᵀ), 20 iterations.  Returns the labels
    and K2-MN's launches in that fit."""
    from dask_ml_tpu_torch import LogisticRegression
    from dask_ml_tpu_torch.core import use_device

    K = max(AB_CLASSES)
    y = torch.argmax(X @ Wall.T, dim=1).float()
    vg, v = multiclass.multinomial_value_and_grad, multiclass.multinomial_value
    vg.launches = v.launches = 0
    t0 = time.perf_counter()
    with use_device(device, n_shards=1):
        est = LogisticRegression(solver="lbfgs", multi_class="multinomial", fit_intercept=False,
                                 max_iter=AB_ITERS, tol=0.0).fit(X, y)
    torch.cuda.synchronize()
    launches = {vg.__name__: vg.launches, v.__name__: v.launches}
    acc = est.score(X, y)
    log(f"phase 7: multinomial lbfgs fit {AB_ROWS}x{HIGGS_D} K={K}: "
        f"{time.perf_counter() - t0:.3f} s on the host clock, n_iter_ {est.n_iter_.tolist()}, "
        f"train accuracy {acc:.6f}, launches {launches} [{card}]")
    if launches[vg.__name__] < 1:
        raise AssertionError(f"the K={K} multinomial fit did not launch K2-MN")
    if not bool(torch.isfinite(est.coef_).all()):
        raise AssertionError(f"the K={K} multinomial fit's coef_ is not finite")
    return y, launches


def multiclass_table(torch, multiclass, logistic, Xi, y_idx, launches, card):
    """Phase 7: K2-OvR and K2-MN at the phase-7 shape ((8, n/8, 29) lanes of
    Xi, K=4) held against their plain versions, then both variants timed
    (CUDA events, 20 launches) beside their plain versions and bounds.
    Informational comparisons (no single PyTorch call computes either
    kernel, so ``library_ms`` is null): for K2-OvR, K launches of K2 and
    the ``torch.bmm`` pair; for K2-MN, ``bmm`` + ``log_softmax`` + ``bmm``."""
    P, K = HIGGS_SHARDS, MC_CLASSES
    n, d = Xi.data.shape
    m = n // P
    dev = Xi.data.device
    x3, m2 = Xi.data.view(P, m, d), Xi.mask.view(P, m)
    y2 = y_idx.reshape(P, m).contiguous()
    Y3 = (y2[None] == torch.arange(K, device=dev, dtype=y2.dtype)[:, None, None]).float()
    gen = torch.Generator(device=dev).manual_seed(4)
    B_ovr = torch.randn(K * P, d, generator=gen, device=dev) / d ** 0.5
    B_mn = torch.randn(P, d * K, generator=gen, device=dev) / d ** 0.5
    what = f"({P}, {m}, {d}) K={K}"
    log(f"phase 7: K2-OvR and K2-MN vs their plain versions at {what}")
    err = {}
    err["logistic_ovr_value_and_grad"], err["logistic_ovr_value"] = hold_multiclass(
        torch, multiclass, "ovr", x3, Y3, m2, B_ovr, what)
    err["multinomial_value_and_grad"], err["multinomial_value"] = hold_multiclass(
        torch, multiclass, "mn", x3, y2, m2, B_mn, what)
    # informational comparisons
    k2_ms = time_ms(torch, lambda: [logistic.logistic_value_and_grad(
        x3, Y3[k], m2, B_ovr[k * P:(k + 1) * P].contiguous()) for k in range(K)], 20)
    wv = torch.rand(P, m, K, generator=gen, device=dev)
    bmm_ovr = time_ms(torch, lambda: (torch.bmm(x3, B_ovr.view(K, P, d).permute(1, 2, 0)),
                                      torch.bmm(x3.transpose(1, 2), wv)), 20)
    Bv = B_mn.view(P, d, K)
    bmm_mn = time_ms(torch, lambda: torch.bmm(
        x3.transpose(1, 2), torch.log_softmax(torch.bmm(x3, Bv), dim=2)), 20)
    out = []
    specs = [
        ("logistic_ovr_value_and_grad", "ovr", True, x3, Y3, B_ovr, K * P,
         f"K launches of K2 {k2_ms:.4f} ms; torch.bmm pair {bmm_ovr:.4f} ms",
         "dask_ml_tpu/solvers/families.py:34"),
        ("logistic_ovr_value", "ovr", False, x3, Y3, B_ovr, K * P, None,
         "dask_ml_tpu/solvers/families.py:34"),
        ("multinomial_value_and_grad", "mn", True, x3, y2, B_mn, P,
         f"bmm + log_softmax + bmm {bmm_mn:.4f} ms", "dask_ml_tpu/solvers/families.py:85"),
        ("multinomial_value", "mn", False, x3, y2, B_mn, P, None,
         "dask_ml_tpu/solvers/families.py:85"),
    ]
    for name, mode, grad, x, yv, B, lanes, info, replaces in specs:
        fn = getattr(multiclass, name)
        ref = multiclass_wrappers(multiclass, mode)[2]
        ms = time_ms(torch, lambda: fn(x, yv, m2, B), 20)
        own = ""
        if mode == "mn":
            kernel_ms = mn_device_ms(torch, lambda: fn(x, yv, m2, B), 20)
            own = f"; kernel and finalize {fmt_ms(kernel_ms)}"
        plain_ms = time_ms(torch, lambda: ref(x, yv, m2, B, None, grad), 3)
        targets = yv.numel() * 4
        nbytes = n * d * 4 + targets + n * 4 + B.numel() * 4 * (2 if grad else 1) + lanes * 4
        flops = (4 if grad else 2) * n * d * K
        b_ms, b_by = bound_ms(nbytes, flops)
        plan = plan_words(multiclass, x, 0 if mode == "ovr" else 1, K)
        log(f"{name} at {what}: {ms:.4f} ms, {n / ms * 1e3:.4g} rows/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of the bound (plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
            f"plan {plan}{own}" + (f"; informational: {info}" if info else "") + f") [{card}]")
        out.append({"name": name, "route": "cuda",
                    "source": "dask_ml_tpu_torch/csrc/multiclass.cu", "replaces": replaces,
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    del Y3, wv
    return out


def mn_device_ms(torch, fn, reps):
    """K2-MN's own device time a call: the MN kernel's mean duration plus
    finalize_kernel's, over the launches a ``torch.profiler`` window of
    ``reps`` calls recorded (a window may drop events, so each mean is over
    the launches it holds).  The CUDA-event time of a call also holds the
    wrapper's host cost where that is longer.  None when the profiler
    records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(
                k in e.name for k in ("tc_kernel", "mn_kernel", "tiled_kernel", "row_kernel",
                                      "finalize_kernel")):
            per_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not per_name:
        return None
    return sum(sum(us) / len(us) for us in per_name.values()) / 1e3


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


#: the plan paths of K2-OvR (mode 0) and K2-MN (mode 1), by (mode, plan word 0)
PLAN_PATHS = {(0, 0): "ovr_kernel", (0, 1): "row_kernel",
              (0, 3): "tc_kernel, one shared target", (1, 0): "tiled_kernel",
              (1, 1): "row_kernel", (1, 2): "tc_kernel"}


def plan_words(multiclass, x, mode, K):
    """The C plan of a K2-OvR (mode 0) or K2-MN (1) call on x: path, rows a
    tile, gradient row groups (the tensor-core paths, 2 and 3: their ring's
    stages), blocks, shared bytes, record floats, scratch floats, and (OvR
    path 0) class chunks a block or (MN path 0) loss groups (paths 2 and 3:
    n-tiles of 8 classes or lanes)."""
    P, m, d = x.shape
    return list(multiclass._plan(multiclass._load(), x.device, mode, P, m, d, K))


def ab_table(torch, multiclass, X, Yall, y16, launches, card):
    """Phase 7: K2-OvR and K2-MN at bench.py's A/B shape, one shard of
    (1M, 28) with K=16 and every row unmasked: each held against its plain
    version, then timed (CUDA events, 20 launches) beside its plain
    version and its bound: K2-OvR's value-and-grad variant, both of
    K2-MN's (with their own device time from the profiler beside).
    ``launches`` are the counts from the K=16 packed A/B run (K2-OvR) and
    the K=16 multinomial fit (K2-MN)."""
    K = max(AB_CLASSES)
    n, d = X.shape
    dev = X.device
    x3 = X.view(1, n, d)
    mask = torch.ones(1, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    B_ovr = torch.randn(K, d, generator=gen, device=dev) / d ** 0.5
    B_mn = torch.randn(1, d * K, generator=gen, device=dev) / d ** 0.5
    y2 = y16.view(1, n)
    what = f"(1, {n}, {d}) K={K}"
    out = []
    err = {}
    err["logistic_ovr_value_and_grad"], _ = hold_multiclass(torch, multiclass, "ovr", x3, Yall,
                                                            mask, B_ovr, what)
    err["multinomial_value_and_grad"], err["multinomial_value"] = hold_multiclass(
        torch, multiclass, "mn", x3, y2, mask, B_mn, what)
    for name, mode, grad, yv, B, nbytes, replaces in (
            ("logistic_ovr_value_and_grad", "ovr", True, Yall, B_ovr, n * (d + K + 1) * 4,
             "dask_ml_tpu/solvers/families.py:34"),
            ("multinomial_value_and_grad", "mn", True, y2, B_mn, n * (d + 2) * 4,
             "dask_ml_tpu/solvers/families.py:85"),
            ("multinomial_value", "mn", False, y2, B_mn, n * (d + 2) * 4,
             "dask_ml_tpu/solvers/families.py:85")):
        fn = getattr(multiclass, name)
        ref = multiclass_wrappers(multiclass, mode)[2]
        ms = time_ms(torch, lambda: fn(x3, yv, mask, B), 20)
        own = ""
        if mode == "mn":
            kernel_ms = mn_device_ms(torch, lambda: fn(x3, yv, mask, B), 20)
            own = f"; kernel and finalize {fmt_ms(kernel_ms)}"
        plain_ms = time_ms(torch, lambda: ref(x3, yv, mask, B, None, grad), 3)
        nbytes += (2 if grad else 1) * B.numel() * 4 + B.shape[0] * 4
        flops = (4 if grad else 2) * n * d * K
        b_ms, b_by = bound_ms(nbytes, flops)
        plan = plan_words(multiclass, x3, 0 if mode == "ovr" else 1, K)
        log(f"{name} at {what}: {ms:.4f} ms, {b_ms / ms:.1%} of the bound (plain {plain_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
            f"plan {plan}{own}) [{card}]")
        out.append({"name": f"{name}_K{K}", "route": "cuda",
                    "source": "dask_ml_tpu_torch/csrc/multiclass.cu", "replaces": replaces,
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out


def multiclass_phase(torch, multiclass, logistic, algorithms, device, card):
    """Phase 7 end to end; returns the four kernels' lines of the table."""
    from dask_ml_tpu_torch.core import shard_rows, use_device
    from dask_ml_tpu_torch.entry import dryrun_multichip
    from dask_ml_tpu_torch.linear_model.utils import add_intercept

    t0 = time.perf_counter()
    X, y, W = softmax_standin(torch, HIGGS_ROWS, HIGGS_D, MC_CLASSES, 1, device)
    acc_true = float((torch.argmax(X @ W.T, dim=1).float() == y).float().mean())
    torch.cuda.synchronize()
    log(f"phase 7: softmax stand-in {HIGGS_ROWS}x{HIGGS_D} K={MC_CLASSES} on the card in "
        f"{time.perf_counter() - t0:.2f} s; the true W's train accuracy {acc_true:.6f}")
    launches = {}
    with use_device(device, n_shards=HIGGS_SHARDS):
        for multi_class in ("ovr", "multinomial"):
            est, counts = multiclass_fit(torch, multiclass, logistic, algorithms, X, y, W,
                                         acc_true, multi_class, card)
            launches.update(counts)
            plain_multiclass_fit(torch, multiclass, X, y, est, multi_class)
            profiled_admm_fit(torch, algorithms, X, y, card,
                              make=lambda mc=multi_class: mc_estimator(mc),
                              label=f"phase 7: profiled {multi_class} fit")
        Xi = add_intercept(shard_rows(X))
        del X
        out = multiclass_table(torch, multiclass, logistic, Xi, y, launches, card)
    del Xi, y
    torch.cuda.synchronize()
    Xab, Wab, Yab = ab_data(torch, device)
    ab_launches = packed_ab(torch, multiclass, Xab, Yab, card)
    y16, mn_launches = ab_multinomial_fit(torch, multiclass, Xab, Wab, device, card)
    out += ab_table(torch, multiclass, Xab, Yab.view(-1, 1, AB_ROWS), y16,
                    {**ab_launches[max(AB_CLASSES)], **mn_launches}, card)
    del Xab, Yab, y16
    torch.cuda.synchronize()
    ran = dryrun_multichip(HIGGS_SHARDS)
    log(f"phase 7: dryrun_multichip({HIGGS_SHARDS}) on the card ran {len(ran)} sections")
    return out


# ------------------------------------------------------------------ phase 8


def glm_inputs(torch, family, P, m, d, seed, device, dtype):
    """x (float32 or bf16), y fitting the family (0/1, real, counts), a
    weighted mask in [0, 3] with zeros, β (Poisson: scaled to |η| up to
    GLM_ETA_MAX), and ``active`` with lane 1 off."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P, m, d, generator=gen, device=device).to(dtype)
    beta = torch.randn(P, d, generator=gen, device=device) / d ** 0.5
    if family == "logistic":
        y = (torch.rand(P, m, generator=gen, device=device) < 0.4).float()
    elif family == "normal":
        y = 3.0 * torch.randn(P, m, generator=gen, device=device)
    else:
        y = torch.poisson(torch.full((P, m), 2.0, device=device), generator=gen)
        eta = torch.einsum("pmd,pd->pm", x.float(), beta)
        beta = beta * (GLM_ETA_MAX / eta.abs().amax(dim=1, keepdim=True))
    mask = 3.0 * torch.rand(P, m, generator=gen, device=device)
    mask[torch.rand(P, m, generator=gen, device=device) < 0.1] = 0.0
    active = torch.ones(P, dtype=torch.bool, device=device)
    active[1] = False
    return x, y, mask, beta, active


def glm_magnitudes(torch, family, x, y, mask, beta):
    """Σ|terms| of f and of each g element in float64, lane by lane, with
    each row's η rounding carried through the loss: a row adds |ℓ'(η)|·s
    to f's and |w'(η)|·s·|x| to g's, s = Σ_j |x_j β_j| (the scale of the
    float32 rounding of η's dot in any order).  At Poisson's |η| ~ 80 one
    row's exp(η) is most of the sum, so that rounding, times exp'(η) =
    exp(η), is what the two summation orders differ by."""
    f_mag, g_mag = [], []
    for p in range(x.shape[0]):
        xp, yp, mp = x[p].double(), y[p].double(), mask[p].double()
        eta = xp @ beta[p].double()
        spread = xp.abs() @ beta[p].double().abs()
        if family == "logistic":
            sig = torch.sigmoid(eta)
            f_terms = torch.logaddexp(torch.zeros_like(eta), eta).abs() + (yp * eta).abs()
            w, dloss, dw = sig - yp, sig - yp, sig * (1.0 - sig)
        elif family == "normal":
            f_terms, w = 0.5 * (yp - eta) ** 2, eta - yp
            dloss, dw = eta - yp, torch.ones_like(eta)
        else:
            mu = torch.exp(eta)
            f_terms, w, dloss, dw = mu + (yp * eta).abs(), mu - yp, mu - yp, mu
        f_mag.append((mp * (f_terms + dloss.abs() * spread)).sum())
        g_mag.append((mp * (w.abs() + dw * spread)) @ xp.abs())
        del xp
    return torch.stack(f_mag), torch.stack(g_mag)


def glm_variant_name(family, dtype, grad):
    name = f"{family}_value_and_grad" if grad else f"{family}_value"
    return name + ("_bf16" if dtype == "bfloat16" else "")


def hold_glm(torch, logistic, family, x, y, mask, beta, what, active=None):
    """Both wrappers of a family against its plain version on the same
    inputs, as ``hold_logistic`` does for K2 float32 logistic, within TOL
    of ``glm_magnitudes``.  Returns the largest absolute differences
    (value-and-grad, value)."""
    P = x.shape[0]
    vg, v = getattr(logistic, f"{family}_value_and_grad"), getattr(logistic, f"{family}_value")
    f, g = vg(x, y, mask, beta, active)
    fv = v(x, y, mask, beta, active)
    again = vg(x, y, mask, beta, active)
    torch.cuda.synchronize()
    lanes = torch.ones(P, dtype=torch.bool, device=x.device) if active is None else active
    if not (torch.equal(f[lanes], again[0][lanes]) and torch.equal(g[lanes], again[1][lanes])):
        raise AssertionError(f"K2 {family} is not deterministic at {what}")
    if not torch.equal(f[lanes], fv[lanes]):
        raise AssertionError(f"the two K2 {family} variants give different f at {what}")
    off = ~lanes
    if bool(f[off].any()) or bool(fv[off].any()) or bool(g[off].any()):
        raise AssertionError(f"K2 {family} wrote an inactive lane at {what}")
    if not (bool(torch.isfinite(f[lanes]).all()) and bool(torch.isfinite(g[lanes]).all())):
        raise AssertionError(f"K2 {family} gave a value that is not finite at {what}")
    rf, rg = logistic.glm_value_and_grad_ref(family, x, y, mask, beta)
    f_mag, g_mag = glm_magnitudes(torch, family, x, y, mask, beta)
    df, dg = (f - rf).abs()[lanes], (g - rg).abs()[lanes]
    if not bool((df.double() <= TOL * f_mag[lanes] + 1e-6).all()):
        raise AssertionError(f"K2 {family} f differs from its plain version at {what}")
    if not bool((dg.double() <= TOL * g_mag[lanes] + 1e-6).all()):
        raise AssertionError(f"K2 {family} g differs from its plain version at {what}")
    worst_f = float((df.double() / (f_mag[lanes] + 1e-30)).max())
    worst_g = float((dg.double() / (g_mag[lanes] + 1e-30)).max())
    log(f"  {family} {what}: f within {worst_f:.2e}, g within {worst_g:.2e} of Σ|terms| "
        f"with η's rounding; deterministic; inactive lanes unwritten")
    return float(torch.cat([df, dg.reshape(-1)]).max()), float(df.max())


def compare_glm(torch, logistic, device):
    """8a: each variant of GLM_VARIANTS at each shape of GLM_SHAPES with
    lane 1 inactive.  Returns the largest absolute differences per entry of
    the kernels line."""
    log(f"phase 8a: K2's other families and bf16 variants vs their plain versions, rtol {TOL}")
    err = {}
    for family, dtype in GLM_VARIANTS:
        for P, m, d in GLM_SHAPES:
            x, y, mask, beta, active = glm_inputs(torch, family, P, m, d, P * m + d, device,
                                                  getattr(torch, dtype))
            what = f"{dtype} P={P} m={m} d={d} lane 1 inactive"
            e_vg, e_v = hold_glm(torch, logistic, family, x, y, mask, beta, what, active)
            for grad, e in ((True, e_vg), (False, e_v)):
                name = glm_variant_name(family, dtype, grad)
                err[name] = max(err.get(name, 0.0), e)
    return err


def glm_standin(torch, family, n, d, seed, device):
    """8c's stand-ins at the HIGGS shape, generated on the card: Normal,
    X and w standard normal, y = Xw + N(0, 1); Poisson, X standard normal,
    w ~ N(0, 0.1²), y ~ Poisson(exp(Xw))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, d, generator=gen, device=device)
    if family == "normal":
        w = torch.randn(d, generator=gen, device=device)
        y = X @ w + torch.randn(n, generator=gen, device=device)
    else:
        w = 0.1 * torch.randn(d, generator=gen, device=device)
        y = torch.poisson(torch.exp(X @ w), generator=gen)
    return X, y, w


def reset_glm_counts(logistic, algorithms):
    for name in GLM_WRAPPERS:
        getattr(logistic, name).launches = 0
    logistic.logistic_value_and_grad_ref.calls = 0
    logistic.glm_value_and_grad_ref.calls = 0
    algorithms.reset_dispatch_counts()


class PlainK2:
    """Every K2 wrapper replaced by its plain version (on the card, as a
    check only) inside a ``with`` block."""

    def __init__(self, logistic):
        self.logistic = logistic
        self.kernels = {name: getattr(logistic, name) for name in GLM_WRAPPERS}

    def __enter__(self):
        for name in GLM_WRAPPERS:
            family, grad = name.split("_")[0], name.endswith("_grad")

            def call(x, y, mask, beta, active=None, family=family, grad=grad):
                out = self.logistic.glm_value_and_grad_ref(family, x, y, mask, beta, active, grad)
                return out if grad else out[0]

            setattr(self.logistic, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.kernels.items():
            setattr(self.logistic, name, fn)


def cosine(torch, a, b):
    return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=0))


def glm_fit(torch, logistic, algorithms, label, make, X, y, family, card):
    """8c: one fit through the port's estimator, every K2 launch and host
    sync counted; both wrappers of ``family`` must have launched and no
    plain version been called.  Returns (estimator, launches, host time)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_glm_counts(logistic, algorithms)
    t0 = time.perf_counter()
    est = make().fit(X, y)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = {name: getattr(logistic, name).launches for name in GLM_WRAPPERS}
    plain = logistic.logistic_value_and_grad_ref.calls + logistic.glm_value_and_grad_ref.calls
    syncs = algorithms.HOST_SYNCS["syncs"]
    data = X.data if hasattr(X, "data") else X
    log(f"phase 8c: {label} {tuple(data.shape)} {data.dtype}: {t_fit:.3f} s on the host clock, "
        f"n_iter_ {est.n_iter_.tolist()}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, plain-version calls {plain}, "
        f"host syncs {syncs}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")
    for name in (f"{family}_value_and_grad", f"{family}_value"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the {label} fit")
    if plain:
        raise AssertionError(f"the {label} fit called a plain version {plain} times")
    if not bool(torch.isfinite(est.betas_).all()) or est.betas_.dtype != torch.float32:
        raise AssertionError(f"the {label} fit's coefficients are malformed")
    return est, launches, t_fit


def plain_glm_check(torch, logistic, label, make, X, y, est):
    """8c: the same fit through the plain versions: equal n_iter_ and
    ‖Δβ‖∞ ≤ ADMM_RTOL·‖β‖∞, the phase-6 rule."""
    with PlainK2(logistic):
        t0 = time.perf_counter()
        other = make().fit(X, y)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    diff = float((other.betas_ - est.betas_).abs().max())
    scale = float(est.betas_.abs().max())
    log(f"phase 8c: the {label} fit through the plain versions: {t_plain:.3f} s, n_iter_ "
        f"{other.n_iter_.tolist()}; ‖Δβ‖∞ {diff:.3e} = {diff / scale:.3e}·‖β‖∞ (<= {ADMM_RTOL})")
    if other.n_iter_.tolist() != est.n_iter_.tolist():
        raise AssertionError(f"{label}: n_iter_ {est.n_iter_.tolist()} through the kernels, "
                             f"{other.n_iter_.tolist()} through the plain versions")
    if not diff <= ADMM_RTOL * scale:
        raise AssertionError(f"{label}: β differs from the plain-version fit by "
                             f"{diff / scale:.3e}·‖β‖∞")


def logistic_solver_estimator(solver):
    """8c's LogisticRegression by gradient_descent, proximal_grad (L1) or
    newton at bench.py's C."""
    from dask_ml_tpu_torch import LogisticRegression

    return LogisticRegression(solver=solver, C=1e4, max_iter=SOLVER_ITERS[solver],
                              penalty="l1" if solver == "proximal_grad" else "l2")


def glm_table(torch, logistic, family, dtype, Xi, y, launches, card):
    """8b: one variant at the main path's shape ((8, n/8, 29) lanes of Xi)
    held against its plain version, then both wrappers timed (CUDA events
    over 20 launches) beside the plain version (3 runs), the bound by
    bytes and the library pair (a batched forward and transposed gemv,
    informational).  Returns the variant's entries of the kernels line."""
    P = HIGGS_SHARDS
    n, d = Xi.data.shape
    m = n // P
    x3 = Xi.data.view(P, m, d)
    y2 = y.reshape(P, m).contiguous()
    m2 = Xi.mask.view(P, m)
    gen = torch.Generator(device=Xi.data.device).manual_seed(3)
    beta = torch.randn(P, d, generator=gen, device=Xi.data.device) / d ** 0.5
    what = f"({P}, {m}, {d}) {dtype}"
    log(f"phase 8b: K2 {family} vs its plain version at the main path's shape {what}")
    err_vg, err_v = hold_glm(torch, logistic, family, x3, y2, m2, beta, what)
    vg, v = getattr(logistic, f"{family}_value_and_grad"), getattr(logistic, f"{family}_value")
    ms_vg = time_ms(torch, lambda: vg(x3, y2, m2, beta), 20)
    ms_v = time_ms(torch, lambda: v(x3, y2, m2, beta), 20)
    plain_vg = time_ms(torch, lambda: logistic.glm_value_and_grad_ref(family, x3, y2, m2, beta),
                       3)
    plain_v = time_ms(
        torch, lambda: logistic.glm_value_and_grad_ref(family, x3, y2, m2, beta, grad=False), 3)
    wv = torch.rand(P, m, 1, generator=gen, device=Xi.data.device).to(x3.dtype)
    bv = beta[:, :, None].to(x3.dtype)
    lib_ms = time_ms(torch, lambda: (torch.bmm(x3, bv), torch.bmm(x3.transpose(1, 2), wv)), 20)
    esize = x3.element_size()
    nbytes = n * d * esize + n * 8 + 2 * P * d * 4 + P * 4
    out = []
    for grad, ms, plain_ms, flops, err in ((True, ms_vg, plain_vg, 4 * n * d, err_vg),
                                            (False, ms_v, plain_v, 2 * n * d, err_v)):
        name = glm_variant_name(family, dtype, grad)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"{name} at {what}: {ms:.4f} ms, {n / ms * 1e3:.4g} rows/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of the bound (plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
            f"library pair in {dtype}, informational: {lib_ms:.4f} ms) [{card}]")
        out.append({"name": name, "route": "cuda",
                    "source": "dask_ml_tpu_torch/csrc/logistic.cu",
                    "replaces": {"logistic": "dask_ml_tpu/solvers/families.py:34",
                                 "normal": "dask_ml_tpu/solvers/families.py:53",
                                 "poisson": "dask_ml_tpu/solvers/families.py:111"}[family],
                    "launches": launches[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out


def variant_launches(launches, family, dtype):
    """The kernels line's launch counts of one variant, from the fit that
    drove it."""
    return {glm_variant_name(family, dtype, grad): launches[name]
            for grad, name in ((True, f"{family}_value_and_grad"), (False, f"{family}_value"))}


def glm_phase(torch, logistic, algorithms, device, card, acc6):
    """Phase 8 end to end; returns the new variants' lines of the table."""
    from dask_ml_tpu_torch import LinearRegression, PoissonRegression
    from dask_ml_tpu_torch.core import shard_rows, use_device
    from dask_ml_tpu_torch.linear_model.utils import add_intercept

    log(f"phase 8a largest absolute differences: {compare_glm(torch, logistic, device)}")
    out, launches = [], {}
    X, y, w = higgs_standin(torch, HIGGS_ROWS, HIGGS_D, 0, device)
    with use_device(device, n_shards=HIGGS_SHARDS):
        # 8c: the phase-6 estimator on a bf16 X, then the new solvers (float32 X)
        Xb = shard_rows(X, dtype=torch.bfloat16)
        est, counts, _ = glm_fit(torch, logistic, algorithms, "LogisticRegression(admm) bf16",
                                 admm_estimator, Xb, y, "logistic", card)
        launches.update(variant_launches(counts, "logistic", "bfloat16"))
        acc, cos = est.score(Xb, y), cosine(torch, est.coef_, w)
        log(f"train accuracy {acc:.6f} (float32 fit of phase 6: {acc6:.6f}; >= it - 1e-3); "
            f"cosine(coef_, w) {cos:.7f} (>= 0.999)")
        if not (acc >= acc6 - 1e-3 and cos >= 0.999):
            raise AssertionError(f"the bf16 logistic fit: accuracy {acc}, cosine {cos}")
        plain_glm_check(torch, logistic, "LogisticRegression(admm) bf16", admm_estimator, Xb, y,
                        est)
        profiled_admm_fit(torch, algorithms, Xb, y, card,
                          label="phase 8c: profiled LogisticRegression(admm) bf16 fit")
        for solver in SOLVER_ITERS:
            label = f"LogisticRegression({solver}, max_iter={SOLVER_ITERS[solver]})"

            def make(solver=solver):
                return logistic_solver_estimator(solver)

            est, _, _ = glm_fit(torch, logistic, algorithms, label, make, X, y, "logistic", card)
            acc, cos = est.score(X, y), cosine(torch, est.coef_, w)
            log(f"train accuracy {acc:.6f} (>= 0.98 of phase 6's {acc6:.6f}); cosine(coef_, w) "
                f"{cos:.7f}")
            if not acc >= 0.98 * acc6:
                raise AssertionError(f"{label}: accuracy {acc} < 0.98 * {acc6}")
            plain_glm_check(torch, logistic, label, make, X, y, est)
        Xi = add_intercept(shard_rows(X))
        log("phase 8b: the control, K2 float32 logistic, at the same shape")
        logistic_table(torch, logistic, Xi, y, {"logistic_value_and_grad": 0,
                                                "logistic_value": 0}, card)
        del Xi
        Xib = add_intercept(Xb)
        out += glm_table(torch, logistic, "logistic", "bfloat16", Xib, y, launches, card)
        del X, Xb, Xib, y
        torch.cuda.synchronize()
        for family, make, min_cos in (
                ("normal", lambda: LinearRegression(solver="admm"), 0.9999),
                ("poisson", lambda: PoissonRegression(solver="lbfgs"), 0.999)):
            X, y, w = glm_standin(torch, family, HIGGS_ROWS, HIGGS_D, 5, device)
            for dtype in ("float32", "bfloat16"):
                Xs = shard_rows(X, dtype=getattr(torch, dtype))
                label = f"{type(make()).__name__}({make().solver}) {dtype}"
                est, counts, _ = glm_fit(torch, logistic, algorithms, label, make, Xs, y, family,
                                         card)
                launches.update(variant_launches(counts, family, dtype))
                cos = cosine(torch, est.coef_, w)
                log(f"score {est.score(Xs, y):.7g}; cosine(coef_, w) {cos:.7f} (>= {min_cos})")
                if not cos >= min_cos:
                    raise AssertionError(f"{label}: cosine to w {cos} < {min_cos}")
                plain_glm_check(torch, logistic, label, make, Xs, y, est)
                if dtype == "float32":
                    profiled_admm_fit(torch, algorithms, Xs, y, card, make=make,
                                      label=f"phase 8c: profiled {label} fit")
                out += glm_table(torch, logistic, family, dtype, add_intercept(Xs), y, launches,
                                 card)
                del Xs
            del X, y
            torch.cuda.synchronize()
    return out


# ------------------------------------------------------------------ phase 9

def pca_standin(torch, n, d, seed, device, scales=None, mean=True):
    """X = Z·diag(s)·Rᵀ + μ on the card: Z standard normal, R the Q factor
    of a seeded d×d Gaussian, s_j = 10·0.9^j for j < 10 and 0.97^(j−10)
    after (a gap after the tenth component, condition ~50), μ_j = 5 + j/8.
    ``scales`` replaces s and ``mean=False`` drops μ."""
    gen = torch.Generator(device=device).manual_seed(seed)
    j = torch.arange(d, dtype=torch.float64)
    if scales is None:
        scales = torch.where(j < 10, 10.0 * 0.9 ** j, 0.97 ** (j - 10))
    s = scales.to(torch.float32).to(device)
    R, _ = torch.linalg.qr(torch.randn(d, d, generator=gen, device=device))
    mu = 5.0 + torch.arange(d, device=device, dtype=torch.float32) / 8
    X = torch.empty(n, d, device=device)
    for a in range(0, n, CHUNK):
        z = torch.randn(min(CHUNK, n - a), d, generator=gen, device=device)
        X[a:a + CHUNK] = (z * s) @ R.T + (mu if mean else 0.0)
    return X


def float64_moments(torch, X):
    """The float64 mean, covariance (ddof 1, centred by the float64 mean)
    and uncentred Gram of X, summed over 2^20-row chunks."""
    n, d = X.shape
    f64 = dict(dtype=torch.float64, device=X.device)
    total = torch.zeros(d, **f64)
    for a in range(0, n, CHUNK):
        total += X[a:a + CHUNK].double().sum(dim=0)
    mean = total / n
    C, G = torch.zeros(d, d, **f64), torch.zeros(d, d, **f64)
    for a in range(0, n, CHUNK):
        x = X[a:a + CHUNK].double()
        G += x.T @ x
        x -= mean
        C += x.T @ x
    return mean, C / (n - 1), G


def top_eigen(torch, M, k):
    """The k largest eigenvalues of a symmetric M, descending, and their
    eigenvectors as rows."""
    w, V = torch.linalg.eigh(M)
    return w.flip(0)[:k], V.flip(1)[:, :k].T


def worst_rel(torch, got, want):
    return float(((got.double() - want).abs() / want.abs()).max())


def min_cos(torch, comps, vecs):
    c = comps.double()
    return float(((c * vecs).sum(dim=1) / c.norm(dim=1)).abs().min())


def gate(ok, what, phase=9):
    if not ok:
        raise AssertionError(f"phase {phase}: {what}")


def gram64(torch, q):
    """QᵀQ in float64, summed over 2^20-row chunks: a float32 QᵀQ over
    millions of rows carries rounding of the order the check bounds."""
    g = torch.zeros(q.shape[1], q.shape[1], dtype=torch.float64, device=q.device)
    for a in range(0, q.shape[0], CHUNK):
        x = q[a:a + CHUNK].double()
        g += x.T @ x
    return g


def hold_tsqr(torch, tsqr_fn, X, strategy, what):
    """Phase 9a: Q R of X by ``strategy``: ‖QR−X‖_F/‖X‖_F ≤ 1e-5 and
    ‖QᵀQ−I‖_max ≤ 1e-4 (QᵀQ in float64); returns R."""
    q, r = tsqr_fn(X, strategy)
    resid = float(torch.linalg.norm(q @ r - X) / torch.linalg.norm(X))
    eye = torch.eye(X.shape[1], dtype=torch.float64, device=X.device)
    ortho = float((gram64(torch, q) - eye).abs().max())
    log(f"phase 9a: tsqr {strategy} {what}: ‖QR−X‖_F/‖X‖_F {resid:.3e}, ‖QᵀQ−I‖_max "
        f"{ortho:.3e}, min diag R {float(torch.diagonal(r).min()):.6g}")
    gate(resid <= 1e-5, f"tsqr {strategy} {what}: residual {resid} > 1e-5")
    gate(ortho <= 1e-4, f"tsqr {strategy} {what}: orthogonality {ortho} > 1e-4")
    return r


def tsqr_bound(n, d, strategy):
    """bench.py's cost models: cholqr2 six passes of X and 8nd² FLOPs,
    Householder two passes and 4nd²."""
    passes, flops = (6, 8.0) if strategy == "cholqr2" else (2, 4.0)
    return bound_ms(passes * n * d * 4, flops * n * d * d)


def tsqr_phase(torch, linalg, Xc, device, card):
    """Phase 9a: both strategies on the centred X, the guard's Householder
    route on an ill-conditioned instance, and each strategy's time."""
    from dask_ml_tpu_torch.core import use_device

    n, d = Xc.shape

    def run(X, strategy):
        with use_device(device, n_shards=PCA_SHARDS):
            return linalg.tsqr(X, strategy)

    for strategy in ("cholqr2", "householder"):
        r = hold_tsqr(torch, run, Xc, strategy, f"{n}x{d}")
        if strategy == "cholqr2":
            gate(float(torch.diagonal(r).min()) > 0, "cholqr2's guard refused the centred X")
        del r
        ms = time_ms(torch, lambda s=strategy: run(Xc, s), TSQR_REPS)
        b, by = tsqr_bound(n, d, strategy)
        log(f"phase 9a: tsqr {strategy} {n}x{d} at {PCA_SHARDS} shards: {ms:.4f} ms a call "
            f"(CUDA events, {TSQR_REPS} calls), bound {b:.4f} ms by {by} ({100 * b / ms:.1f}%) "
            f"[{card}]")
    scales = 10.0 ** (-6.0 * torch.arange(d, dtype=torch.float64) / (d - 1))
    Xill = pca_standin(torch, ILL_ROWS, d, 2, device, scales=scales, mean=False)
    linalg.HOST_READS["reads"] = 0
    r = hold_tsqr(torch, run, Xill, "cholqr2", f"{ILL_ROWS}x{d}, cond ~1e6")
    gate(float(torch.diagonal(r).min()) < 0, "the cond ~1e6 instance kept cholqr2's route")
    log(f"phase 9a: the cond ~1e6 instance took the Householder route "
        f"({linalg.HOST_READS['reads']} guard read)")
    del Xill, r
    cusolver_check(torch, linalg, Xc)


def decomposition_fit(torch, linalg, label, make, X, card):
    """Phase 9b: one fit on the host clock after a sync, with its
    n_components_, peak memory and host reads."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    linalg.HOST_READS["reads"] = 0
    t0 = time.perf_counter()
    est = make().fit(X)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    k = getattr(est, "n_components_", est.components_.shape[0])
    log(f"phase 9b: {label} {tuple(X.shape)}: {ms:.3f} ms on the host clock, n_components_ {k}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{linalg.HOST_READS['reads']} host reads [{card}]")
    return est, ms


def hold_pca(torch, label, est, mean, evals, evecs, total, min_c):
    """Phase 9b's gates for PCA and IncrementalPCA against the float64
    covariance's top eigenpairs."""
    rtol = 1e-3 if label.startswith("IncrementalPCA") else 1e-4
    ev = worst_rel(torch, est.explained_variance_, evals)
    cos = min_cos(torch, est.components_, evecs)
    dmean = float((est.mean_.double() - mean).abs().max())
    ratio = worst_rel(torch, est.explained_variance_ratio_, evals / total)
    log(f"phase 9b: {label}: explained_variance_ worst rel {ev:.3e} (≤ {rtol:g}), min |cos| "
        f"{cos:.8f} (≥ {min_c}), mean_ worst abs {dmean:.3e} (≤ 1e-4), ratio worst rel "
        f"{ratio:.3e} (≤ {rtol:g})")
    gate(ev <= rtol, f"{label}: explained_variance_ off by {ev}")
    gate(cos >= min_c, f"{label}: a component's |cos| {cos} < {min_c}")
    gate(dmean <= 1e-4, f"{label}: mean_ off by {dmean}")
    gate(ratio <= rtol, f"{label}: explained_variance_ratio_ off by {ratio}")


def hold_tsvd(torch, label, est, Cpop, gvals, gvecs, total, min_c):
    """Phase 9b's gates for TruncatedSVD against the float64 uncentred
    Gram: s² to its top eigenvalues, the components to its eigenvectors,
    explained_variance_ to the float64 variance along the fitted
    components, the ratio to it over the float64 total variance."""
    sv = worst_rel(torch, est.singular_values_.double() ** 2, gvals)
    cos = min_cos(torch, est.components_, gvecs)
    c = est.components_.double()
    var = torch.einsum("kd,de,ke->k", c, Cpop, c)
    ev = worst_rel(torch, est.explained_variance_, var)
    ratio = worst_rel(torch, est.explained_variance_ratio_, var / total)
    log(f"phase 9b: {label}: singular_values_² worst rel {sv:.3e}, min |cos| {cos:.8f} "
        f"(≥ {min_c}), explained_variance_ worst rel {ev:.3e}, ratio {ratio:.3e} (≤ 1e-4)")
    gate(sv <= 1e-4, f"{label}: singular values off by {sv}")
    gate(cos >= min_c, f"{label}: a component's |cos| {cos} < {min_c}")
    gate(ev <= 1e-4, f"{label}: explained_variance_ off by {ev}")
    gate(ratio <= 1e-4, f"{label}: explained_variance_ratio_ off by {ratio}")


def profiled_pca_fit(torch, make, X, card):
    """Phase 9b: one more PCA ``full`` fit under ``torch.profiler``: device
    time by operation, and the device's idle share over the fit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make().fit(X)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    log(f"phase 9b: profiled PCA full fit {wall_ms:.3f} ms on the host clock [{card}]")
    if not per_name:
        log("  device time by operation: not measured (the profiler recorded no device event)")
        return
    busy = sum(ms for ms, _ in per_name.values())
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  device {ms:12.3f} ms {count:6d}x  {name[:110]}")
    log(f"  device busy {busy:.3f} ms of {wall_ms:.3f} ms: idle share "
        f"{(wall_ms - busy) / wall_ms:.4f}")


def small_decomposition(torch, device):
    """Phase 9b: the same small fit of each estimator (PCA full,
    TruncatedSVD tsqr, IncrementalPCA) on the card and on the CPU, every
    fitted array within TOL (relative, with an atol of TOL of its largest
    |value|)."""
    from dask_ml_tpu_torch import PCA, IncrementalPCA, TruncatedSVD
    from dask_ml_tpu_torch.core import use_device

    n, d = SMALL_DECOMP
    X = pca_standin(torch, n, d, 5, torch.device("cpu"))
    makes = {"PCA": lambda: PCA(n_components=5, svd_solver="full"),
             "TruncatedSVD": lambda: TruncatedSVD(n_components=5),
             "IncrementalPCA": lambda: IncrementalPCA(n_components=5, batch_size=4000)}
    worst = {}
    for name, make in makes.items():
        fits = {}
        for dev in ("cpu", device):
            with use_device(dev, n_shards=PCA_SHARDS):
                fits[str(dev)] = make().fit(X.to(dev))
        cpu, card_fit = fits["cpu"], fits[str(device)]
        gap = 0.0
        for attr in ("components_", "explained_variance_", "explained_variance_ratio_",
                     "singular_values_"):
            want, got = getattr(cpu, attr), getattr(card_fit, attr).cpu()
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL * float(want.abs().max()))
            gap = max(gap, float(((got - want).abs() / want.abs().max()).max()))
        worst[name] = gap
    log(f"phase 9b: small fits {n}x{d} on the card match the CPU within {TOL} "
        f"(largest difference over the largest |value|: {worst})")


def ipca_update_times(torch, X, card):
    """Phase 9b: each IncrementalPCA update's time (CUDA events around one
    partial_fit a batch), and its factorization alone at its shape (the
    float64 Gram of the stacked matrix and its ``eigh``)."""
    from dask_ml_tpu_torch.linalg.tsqr import blocked_gram

    from dask_ml_tpu_torch import IncrementalPCA

    est = IncrementalPCA(n_components=PCA_K, batch_size=IPCA_BATCH)
    n = X.shape[0]
    times = []
    for a in range(0, n, IPCA_BATCH):
        b = min(a + IPCA_BATCH, n)
        if b - a < PCA_K:
            break
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        est.partial_fit(X[a:b])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    log(f"phase 9b: IncrementalPCA updates (CUDA events, {len(times)} batches of "
        f"{IPCA_BATCH} rows): " + ", ".join(f"{t:.3f}" for t in times) + f" ms [{card}]")
    m = IPCA_BATCH + PCA_K + 1
    stacked = X[:m] - X[:m].mean(dim=0)
    gram_ms = time_ms(torch, lambda: torch.linalg.eigh(blocked_gram(stacked.double())), 5)
    d = X.shape[1]
    b, by = bound_ms((IPCA_BATCH * d + 2 * PCA_K * d) * 4, 4.0 * m * d * d)
    log(f"phase 9b: the update's float64 Gram and eigh of ({m}, {d}): {gram_ms:.3f} ms; the "
        f"update's bound {b:.4f} ms by {by} (batch read once, 4md² FLOPs) [{card}]")


def sketch_times(torch, linalg, Xc, device, card):
    """Phase 9b: the randomized solver's products at PCA(n_components=10)'s
    sketch width k = 20 (x @ g and xᵀ @ q, each read of X once) and a TSQR
    of the (n, 20) sketch, each beside its bound."""
    from dask_ml_tpu_torch.core import use_device

    n, d = Xc.shape
    k = PCA_K + 10
    gen = torch.Generator(device=device).manual_seed(4)
    g = torch.randn(d, k, generator=gen, device=device)
    y = Xc @ g
    for name, fn in (("x @ g", lambda: Xc @ g), ("x.T @ q", lambda: Xc.T @ y)):
        ms = time_ms(torch, fn, TSQR_REPS)
        b, by = bound_ms((n * d + n * k) * 4, 2.0 * n * d * k)
        log(f"phase 9b: randomized sketch pass {name} ({n}x{d} by {k}): {ms:.4f} ms, bound "
            f"{b:.4f} ms by {by} ({100 * b / ms:.1f}%) [{card}]")
    with use_device(device, n_shards=PCA_SHARDS):
        ms = time_ms(torch, lambda: linalg.tsqr(y, "cholqr2"), TSQR_REPS)
    b, by = tsqr_bound(n, k, "cholqr2")
    log(f"phase 9b: tsqr cholqr2 of the sketch ({n}x{k}): {ms:.4f} ms, bound {b:.4f} ms by "
        f"{by} ({100 * b / ms:.1f}%) [{card}]")


def decomposition_phase(torch, device, card):
    """Phase 9 end to end: TSQR and the decomposition estimators at
    bench.py's ``tsqr_4000000x64``."""
    from dask_ml_tpu_torch import linalg
    from dask_ml_tpu_torch import PCA, IncrementalPCA, TruncatedSVD
    from dask_ml_tpu_torch.core import use_device
    from dask_ml_tpu_torch.entry import dryrun_multichip

    n, d = PCA_ROWS, PCA_D
    t0 = time.perf_counter()
    X = pca_standin(torch, n, d, 0, device)
    mean, C, G = float64_moments(torch, X)
    torch.cuda.synchronize()
    log(f"phase 9: X {n}x{d} float32 and its float64 moments on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    evals, evecs = top_eigen(torch, C, PCA_K)
    total = torch.trace(C)
    gvals, gvecs = top_eigen(torch, G, PCA_K)
    Cpop = C * (n - 1) / n

    # 9a: tsqr on the centred X
    Xc = X - X.mean(dim=0)
    tsqr_phase(torch, linalg, Xc, device, card)

    # 9b: the estimators, each fitted once untimed on 2^16 rows first (the
    # libraries' handles and workspaces)
    fits = {}
    with use_device(device, n_shards=PCA_SHARDS):
        cases = (
            ("PCA full", lambda: PCA(n_components=PCA_K, svd_solver="full"), 0.99999),
            ("PCA auto (randomized)", lambda: PCA(n_components=PCA_K), 0.9999),
            ("TruncatedSVD tsqr", lambda: TruncatedSVD(n_components=PCA_K), 0.99999),
            ("TruncatedSVD randomized",
             lambda: TruncatedSVD(n_components=PCA_K, algorithm="randomized"), 0.9999),
            ("IncrementalPCA", lambda: IncrementalPCA(n_components=PCA_K,
                                                      batch_size=IPCA_BATCH), 0.9999),
        )
        for _, make, _ in cases:
            make().fit(X[:1 << 16])
        for label, make, min_c in cases:
            est, ms = decomposition_fit(torch, linalg, label, make, X, card)
            fits[label] = ms
            if label == "PCA auto (randomized)":
                gate(est._resolve(n, d)[1] == "randomized", "PCA auto did not resolve to randomized")
            if label.startswith("TruncatedSVD"):
                hold_tsvd(torch, label, est, Cpop, gvals, gvecs, torch.trace(Cpop), min_c)
            else:
                hold_pca(torch, label, est, mean, evals, evecs, total, min_c)
            del est
        b, by = bound_ms(PCA_PASSES * n * d * 4, 0.0)
        log(f"phase 9b: PCA full fit {fits['PCA full']:.3f} ms beside its bound by bytes "
            f"{b:.4f} ms ({PCA_PASSES} passes of X) [{card}]")
        profiled_pca_fit(torch, lambda: PCA(n_components=PCA_K, svd_solver="full"), X, card)
        ipca_update_times(torch, X, card)
    sketch_times(torch, linalg, Xc, device, card)
    del X, Xc
    torch.cuda.synchronize()
    small_decomposition(torch, device)
    ran = dryrun_multichip(PCA_SHARDS)
    gate("PCA via TSQR" in ran, "dryrun_multichip ran no PCA section")
    log(f"phase 9: dryrun_multichip({PCA_SHARDS}) on the card ran {len(ran)} sections")

# ---------------------------------------------------------------- phase 10

def cusolver_check(torch, linalg, Xc):
    """Phase 9a: ``_local_hh`` repeated at the lanes of phase 9a (8 lanes of
    n/8 rows) and at the IncrementalPCA update's stacked shape (one lane of
    IPCA_BATCH + PCA_K + 1 rows), HH_REPS calls each, counting the calls
    whose R is not finite (cuSOLVER returned one on some calls there)."""
    from dask_ml_tpu_torch.linalg.tsqr import _local_hh

    n, d = Xc.shape
    m = IPCA_BATCH + PCA_K + 1
    for what, xs in ((f"({PCA_SHARDS}, {n // PCA_SHARDS}, {d})",
                      Xc[: n - n % PCA_SHARDS].view(PCA_SHARDS, -1, d)),
                     (f"({m}, {d})", Xc[:m].unsqueeze(0))):
        bad = 0
        for _ in range(HH_REPS):
            _, r = _local_hh(xs)
            bad += int(not bool(torch.isfinite(r).all()))
        log(f"phase 9a: cuSOLVER check: _local_hh at {what}: {bad} of {HH_REPS} calls returned "
            "a non-finite R")


def sgd_hyper(torch, device, eta_scale=1.0):
    """The estimators' hyperparameters at SGDClassifier's defaults (alpha
    1e-4, eta0 0.01, t0 = 1/(alpha·eta0)), epsilon 0.1 for huber."""
    return torch.tensor([1e-4, 0.01, 0.25, 1e6, 0.15, 0.1, eta_scale], dtype=torch.float32,
                        device=device)


def sgd_inputs(torch, B, d, K, loss, seed, device, scale=1.0):
    """x standard normal, targets from a true model (one-vs-all ±1 for the
    classifier losses, x·w + noise for the regressors), a mask in [0, 2)
    with a tenth of its rows 0, and a state whose margins have spread
    ``scale``."""
    from dask_ml_tpu_torch.ops.sgd import CLASSIFIER_LOSSES

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, d, generator=gen, device=device)
    W = torch.randn(d, K, generator=gen, device=device)
    if loss in CLASSIFIER_LOSSES:
        noise = torch.randn(B, K, generator=gen, device=device)
        if K == 1:
            y = torch.where(x @ W[:, 0] + noise[:, 0] > 0, 1.0, -1.0)[:, None]
        else:
            idx = torch.argmax(x @ W + noise, dim=1)
            y = 2.0 * torch.nn.functional.one_hot(idx, K).float() - 1.0
    else:
        y = x @ W + 0.3 * torch.randn(B, 1, generator=gen, device=device)
    mask = 2.0 * torch.rand(B, generator=gen, device=device)
    mask[torch.rand(B, generator=gen, device=device) < 0.1] = 0.0
    coef = scale * torch.randn(d, K, generator=gen, device=device) / d ** 0.5
    intercept = 0.1 * torch.randn(K, generator=gen, device=device)
    return x, y.contiguous(), mask, coef, intercept


def hold_sgd(torch, sgd, case, hyper, what, loss, penalty="l2", schedule="optimal",
             fit_intercept=True, update=None):
    """10a: both K4 wrappers against their plain versions taken in float64 on
    the same inputs: the mean loss to rtol SGD_TOL, the updated coef and
    intercept to SGD_TOL·eta·max|g| plus 2^-22 of each element (the float32
    rounding of the stored c − eta·g), with hinge's rows within 1e-5 of its
    kink allowed their jump of dℓ, t equal; each twice, with the same bits.
    ``update`` stands in for ``sgd.sgd_update`` (same arguments), e.g. a
    step run another way.  Returns the largest absolute differences of each
    wrapper's outputs: (``sgd_update``'s coef, intercept and mean loss;
    ``sgd_loss``'s mean loss)."""
    update = sgd.sgd_update if update is None else update
    x, y, mask, coef, intercept = case
    d64 = torch.float64
    h64 = hyper.to(d64)
    t0 = torch.tensor(5.0, device=x.device)
    c64, b64, t64 = coef.to(d64), intercept.to(d64), t0.to(d64)
    out64 = torch.empty(2, dtype=d64, device=x.device)
    sgd.sgd_update_ref(x.to(d64), y.to(d64), mask.to(d64), c64, b64, t64, h64, loss=loss,
                       penalty=penalty, schedule=schedule, fit_intercept=fit_intercept, out=out64)
    runs = []
    for _ in range(2):
        c32, b32, t32 = coef.clone(), intercept.clone(), t0.clone()
        out = update(x, y, mask, c32, b32, t32, hyper, loss=loss, penalty=penalty,
                     schedule=schedule, fit_intercept=fit_intercept)
        runs.append((c32, b32, out))
    lo = sgd.sgd_loss(x, y, mask, coef, intercept, hyper, loss=loss)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"K4 update {what}: a repeat gave other bits")
    eta = float(sgd.learning_rate(schedule, t0.to(d64), h64))
    g = torch.cat([(coef.to(d64) - c64).flatten(), (intercept.to(d64) - b64).flatten()]) / eta
    gmax = float(g.abs().max())
    allow = 0.0
    if loss == "hinge":
        z = y.to(d64) * (x.to(d64) @ coef.to(d64) + intercept.to(d64))
        near = ((z - 1.0).abs() <= 1e-5 * (1.0 + z.abs())) & (mask[:, None] > 0)
        count = max(float(out64[1]), 1.0)
        allow = eta * int(near.sum()) * float(mask.max()) * float(x.abs().max()) / count
    err_state = 0.0
    for got, want in ((c32, c64), (b32, b64)):
        diff = (got.to(d64) - want).abs()
        tol = SGD_TOL * eta * gmax + 2.0 ** -22 * want.abs() + allow
        if not bool((diff <= tol).all()):
            worst = float((diff / tol).max())
            raise AssertionError(f"K4 update {what}: {worst:.3g}x its tolerance "
                                 f"(max|Δ| {float(diff.max()):.3g}, eta·max|g| {eta * gmax:.3g})")
        err_state = max(err_state, float(diff.max()))
    if float(t32) != float(t64):
        raise AssertionError(f"K4 update {what}: t {float(t32)} against {float(t64)}")
    ref_loss, ref_count = float(out64[0]), float(out64[1])
    err_loss = {}
    for name, o in (("update", out), ("loss", lo)):
        got_loss, got_count = float(o[0]), float(o[1])
        if abs(got_loss - ref_loss) > SGD_TOL * abs(ref_loss) or \
                abs(got_count - ref_count) > SGD_TOL * ref_count:
            raise AssertionError(f"K4 {name} {what}: loss {got_loss!r} count {got_count!r}, "
                                 f"plain {ref_loss!r} {ref_count!r}")
        err_loss[name] = abs(got_loss - ref_loss)
    if not bool(torch.equal(lo, sgd.sgd_loss(x, y, mask, coef, intercept, hyper, loss=loss))):
        raise AssertionError(f"K4 loss {what}: a repeat gave other bits")
    return max(err_state, err_loss["update"]), err_loss["loss"]


def minibatch_view(case, n_mb, i=5):
    """Minibatch ``i`` of ``n_mb`` of a block's (x, y, mask, coef, intercept):
    the rows i::n_mb, read where they lie, as ``_minibatch_views`` gives
    them to K4."""
    x, y, mask, coef, intercept = case
    d, K = x.shape[1], y.shape[1]
    return (x.view(-1, n_mb, d)[:, i], y.view(-1, n_mb, K)[:, i], mask.view(-1, n_mb)[:, i],
            coef, intercept)


def sgd_edge_cases():
    """10a: (label, B, d, K, loss, options) of every case held; option
    ``n_mb`` holds a minibatch view of the B rows."""
    big, cases = SGD_ROWS, []
    n_mb = SGD_ROWS // SGD_FIT_BATCH
    for loss in ("log_loss", "hinge", "squared_hinge", "modified_huber"):
        for K in (1, 3, 10, 100):
            cases.append((f"{loss} K={K}", big, SGD_D, K, loss, {}))
    for loss in ("squared_error", "huber"):
        cases.append((loss, big, SGD_D, 1, loss, {}))
    for d in (1, 28, 130, 2000):
        cases.append((f"d={d}", 3001, d, 3, "log_loss", {}))
    cases += [
        ("d=2000 squared_error", 3001, 2000, 1, "squared_error", {"penalty": "l1"}),
        ("B=37 hinge", 37, SGD_D, 1, "hinge", {"penalty": "elasticnet"}),
        ("B=256 modified_huber K=10", 256, SGD_D, 10, "modified_huber", {"penalty": None}),
        ("strided n_mb=16", 65536, SGD_D, 3, "log_loss", {"schedule": "invscaling", "n_mb": 16}),
        (f"the binary minibatch fit's steps (n_mb={n_mb})", big, SGD_D, 1, "log_loss",
         {"n_mb": n_mb}),
        (f"the {SGD_OVA_K}-class fit's steps (n_mb={n_mb})", big, SGD_D, SGD_OVA_K, "log_loss",
         {"n_mb": n_mb}),
        ("margins past ±80 log_loss", 65536, SGD_D, 1, "log_loss", {"scale": 60.0}),
        ("margins past ±80 modified_huber K=3", 65536, SGD_D, 3, "modified_huber",
         {"scale": 60.0, "schedule": "constant"}),
        ("huber wide residuals", 65536, SGD_D, 1, "huber", {"scale": 3.0}),
        ("adaptive, no intercept", 65536, SGD_D, 10, "squared_hinge",
         {"schedule": "adaptive", "fit_intercept": False}),
    ]
    # the tensor-core path: both n-tile counts, its feature edges, the
    # 32-row tiles past d = 96
    for K in (2, 4, 16):
        for d in (1, SGD_D):
            cases.append((f"tensor cores K={K} d={d}", 65536, d, K, "log_loss", {}))
    cases.append(("tensor cores K=16 d=256", 20011, 256, 16, "hinge", {}))
    cases.append(("tensor cores K=5 d=97 margins past ±80", 20011, 97, 5, "modified_huber",
                  {"scale": 60.0}))
    return cases


def epoch_grids(sgd, device, loss, B, d, K):
    """The blocks of a step's plan and of an epoch's plan for minibatches of
    B rows (the epoch's sums are a step's where the two are equal)."""
    lib = sgd._load()
    return tuple(int(sgd._plan(lib, device, sgd.LOSSES[loss], B, d, K, epoch=e)[0][3])
                 for e in (False, True))


def hold_epoch(torch, sgd, stacks, hyper, what, loss, penalty="l2", schedule="optimal",
               fit_intercept=True):
    """10a: the epoch kernel (``sgd_epoch``) against its plain version's steps
    taken in float64 from the same state: each step's (mean loss, Σ mask) to
    rtol SGD_TOL, the final coef and intercept to SGD_TOL times the steps'
    sum of eta·max|g| (each step's own tolerance, summed) plus 2^-22 of each
    element a step, with each step's hinge allowance; t equal.  The epoch is
    run twice and must give the same bits; it is also run as n_mb calls of
    ``sgd_update``, and whether the bits agree is logged with both grids.
    Returns the largest absolute difference of its outputs."""
    xs, ys, ms, coef, intercept = stacks
    d64 = torch.float64
    n_mb = xs.shape[1]
    h64 = hyper.to(d64)
    t0 = torch.tensor(5.0, device=xs.device)
    c64, b64, t64 = coef.to(d64), intercept.to(d64), t0.to(d64)
    out64 = torch.empty((n_mb, 2), dtype=d64, device=xs.device)
    moves = allow = 0.0
    for i in range(n_mb):
        before = torch.cat([c64.flatten(), b64.flatten()])
        x, y, m = xs[:, i], ys[:, i], ms[:, i]
        if loss == "hinge":
            eta = float(sgd.learning_rate(schedule, t64, h64))
            z = y.to(d64) * (x.to(d64) @ c64 + b64)
            near = ((z - 1.0).abs() <= 1e-5 * (1.0 + z.abs())) & (m[:, None] > 0)
            allow += eta * int(near.sum()) * float(m.max()) * float(x.abs().max()) / max(
                float(m.sum()), 1.0)
        sgd.sgd_update_ref(x.to(d64), y.to(d64), m.to(d64), c64, b64, t64, h64, loss=loss,
                           penalty=penalty, schedule=schedule, fit_intercept=fit_intercept,
                           out=out64[i])
        moves += float((torch.cat([c64.flatten(), b64.flatten()]) - before).abs().max())
    kw = dict(loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    runs = []
    for _ in range(2):
        c, b, t = coef.clone(), intercept.clone(), t0.clone()
        runs.append((c, b, t, sgd.sgd_epoch(xs, ys, ms, c, b, t, hyper, **kw)))
    c, b, t = coef.clone(), intercept.clone(), t0.clone()
    steps = torch.stack([sgd.sgd_update(xs[:, i], ys[:, i], ms[:, i], c, b, t, hyper, **kw)
                         for i in range(n_mb)])
    torch.cuda.synchronize()
    (c1, b1, t1, o1), (c2, b2, t2, o2) = runs
    if not (torch.equal(c1, c2) and torch.equal(b1, b2) and torch.equal(o1, o2)):
        raise AssertionError(f"K4 epoch {what}: a repeat gave other bits")
    err = 0.0
    for got, want in ((c1, c64), (b1, b64)):
        diff = (got.to(d64) - want).abs()
        tol = SGD_TOL * moves + n_mb * 2.0 ** -22 * want.abs() + allow
        if not bool((diff <= tol).all()):
            worst = float((diff / tol).max())
            raise AssertionError(f"K4 epoch {what}: {worst:.3g}x its tolerance "
                                 f"(max|Δ| {float(diff.max()):.3g}, Σ eta·max|g| {moves:.3g})")
        err = max(err, float(diff.max()))
    if float(t1) != float(t64):
        raise AssertionError(f"K4 epoch {what}: t {float(t1)} against {float(t64)}")
    rel = (o1.to(d64) - out64).abs()  # absolute, held relative to each value
    if not bool((rel <= SGD_TOL * out64.abs()).all()):
        raise AssertionError(f"K4 epoch {what}: step losses {o1.tolist()} against "
                             f"{out64.tolist()}")
    same = torch.equal(c1, c) and torch.equal(b1, b) and torch.equal(o1, steps)
    grids = epoch_grids(sgd, xs.device, loss, xs.shape[0], xs.shape[2], ys.shape[2])
    log(f"phase 10a: K4 epoch {what}: max|Δ| {err:.3g}; the same bits as {n_mb} sgd_update "
        f"calls: {same} (grids: step {grids[0]}, epoch {grids[1]} blocks)")
    return max(err, float(rel[:, 0].max()))


def epoch_edge_cases():
    """10a: (label, rows a minibatch, n_mb, d, K, loss, options) of every
    epoch held; option ``zero_last`` zeroes the last minibatch's mask."""
    n_mb = SGD_ROWS // SGD_FIT_BATCH
    return [
        (f"the binary minibatch fit's epoch (n_mb={n_mb})", SGD_FIT_BATCH, n_mb, SGD_D, 1,
         "log_loss", {}),
        (f"the {SGD_OVA_K}-class fit's epoch (n_mb={n_mb})", SGD_FIT_BATCH, n_mb, SGD_D,
         SGD_OVA_K, "log_loss", {}),
        ("n_mb=2 hinge", 4096, 2, SGD_D, 1, "hinge", {"penalty": "elasticnet"}),
        ("n_mb=2 K=2 d=1", 4096, 2, 1, 2, "log_loss", {"schedule": "invscaling"}),
        ("n_mb=16 K=4 a zero-mask minibatch", 4096, 16, SGD_D, 4, "modified_huber",
         {"zero_last": True, "schedule": "constant"}),
        ("n_mb=16 K=1 a zero-mask minibatch", 4096, 16, SGD_D, 1, "log_loss",
         {"zero_last": True}),
        ("n_mb=16 K=16 margins past ±80", 4096, 16, SGD_D, 16, "log_loss",
         {"scale": 60.0, "fit_intercept": False}),
        ("n_mb=16 K=1 margins past ±80", 4096, 16, SGD_D, 1, "log_loss", {"scale": 60.0}),
        ("n_mb=4 K=10 d=1", 4096, 4, 1, 10, "squared_hinge", {"penalty": "l1"}),
        ("n_mb=2 huber d=200", 4096, 2, 200, 1, "huber", {}),
        ("n_mb=3 K=16 d=256", 2001, 3, 256, 16, "hinge", {}),
        ("n_mb=2 the row path d=300", 3001, 2, 300, 1, "squared_error", {}),
    ]


def compare_epoch(torch, sgd, device):
    """10a: every epoch case held; logs the largest difference."""
    worst = 0.0
    cases = epoch_edge_cases()
    for i, (label, B, n_mb, d, K, loss, opts) in enumerate(cases):
        opts = dict(opts)
        scale = opts.pop("scale", 1.0)
        zero_last = opts.pop("zero_last", False)
        hyper = sgd_hyper(torch, device)
        x, y, mask, coef, intercept = sgd_inputs(torch, B * n_mb, d, K, loss, 300 + i, device,
                                                 scale)
        stacks = (x.view(B, n_mb, d), y.view(B, n_mb, K), mask.view(B, n_mb), coef, intercept)
        if zero_last:
            stacks[2][:, -1] = 0.0
        worst = max(worst, hold_epoch(torch, sgd, stacks, hyper, label, loss, **opts))
        del x, y, mask, stacks
    log(f"phase 10a: K4's epoch held against its plain version's steps (float64) at "
        f"{len(cases)} cases, rtol {SGD_TOL}; largest absolute difference {worst:.3g}")
    return worst


def compare_sgd(torch, sgd, device):
    """10a: every edge case held; logs each wrapper's largest difference."""
    worst = {"sgd_update": 0.0, "sgd_loss": 0.0}
    for i, (label, B, d, K, loss, opts) in enumerate(sgd_edge_cases()):
        opts = dict(opts)
        scale = opts.pop("scale", 1.0)
        n_mb = opts.pop("n_mb", None)
        hyper = sgd_hyper(torch, device, 0.2 if opts.get("schedule") == "adaptive" else 1.0)
        case = sgd_inputs(torch, B, d, K, loss, 100 + i, device, scale)
        if n_mb:
            case = minibatch_view(case, n_mb)
        errs = hold_sgd(torch, sgd, case, hyper, label, loss, **opts)
        for key, err in zip(worst, errs):
            worst[key] = max(worst[key], err)
        del case
    log(f"phase 10a: K4 held against its plain version (float64) at {len(sgd_edge_cases())} "
        f"shapes, rtol {SGD_TOL}; largest absolute differences over them {worst}")


def reset_sgd_counts(sgd):
    sgd.sgd_update.launches = 0
    sgd.sgd_epoch.launches = 0
    sgd.sgd_loss.launches = 0
    sgd.sgd_update_ref.calls = 0
    sgd.sgd_epoch_ref.calls = 0
    sgd.sgd_loss_ref.calls = 0


def plain_sgd_calls(sgd):
    return sgd.sgd_update_ref.calls + sgd.sgd_epoch_ref.calls + sgd.sgd_loss_ref.calls


class PlainK4:
    """K4's wrappers replaced by their plain versions (on the card, as a
    check only) inside a ``with`` block."""

    def __init__(self, sgd):
        self.sgd = sgd
        self.kernels = (sgd.sgd_update, sgd.sgd_epoch, sgd.sgd_loss)

    def __enter__(self):
        self.sgd.sgd_update = self.sgd.sgd_update_ref
        self.sgd.sgd_epoch = self.sgd.sgd_epoch_ref
        self.sgd.sgd_loss = self.sgd.sgd_loss_ref
        return self

    def __exit__(self, *exc):
        self.sgd.sgd_update, self.sgd.sgd_epoch, self.sgd.sgd_loss = self.kernels


def sgd_stream_agreement(torch, sgd, w, device):
    """10b: the stream's first SGD_CHECK blocks through K4 and through the
    plain version: coef within 1e-4·‖coef‖∞, t equal."""
    import contextlib

    import numpy as np

    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.datasets import stream_classification_blocks

    fits = []
    for plain in (False, True):
        clf = SGDClassifier(random_state=0)
        with (PlainK4(sgd) if plain else contextlib.nullcontext()):
            for Xb, yb in stream_classification_blocks(SGD_CHECK, SGD_ROWS, SGD_D, seed=0,
                                                       coef=w, device=device):
                clf.partial_fit(Xb, yb, classes=[0.0, 1.0])
        fits.append(clf)
    kernel, plain = fits
    gap = float(np.abs(kernel.coef_ - plain.coef_).max())
    scale = float(np.abs(plain.coef_).max())
    if not gap <= 1e-4 * scale or kernel.t_ != plain.t_:
        raise AssertionError(f"phase 10b: {SGD_CHECK} blocks through K4 are {gap} from the plain "
                             f"version's coef (‖coef‖∞ {scale}), t_ {kernel.t_} {plain.t_}")
    log(f"phase 10b: the first {SGD_CHECK} blocks through K4 and through the plain version: "
        f"‖Δcoef‖∞ {gap:.3g} = {gap / scale:.3g}·‖coef‖∞, t_ {kernel.t_}")
    return gap


def sgd_stream(torch, sgd, device, card):
    """10b: bench.py's ``streamed_sgd_70x1048576x64`` on the port: SGD_BLOCKS
    device-born blocks, one ``partial_fit`` a block, a scalar sync every
    SGD_SYNC blocks; gated on the blocks done, the peak memory, the cosine
    to the stream's w and the loss.  Returns (launches, steady ms/block)."""
    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.datasets import stream_classification_blocks

    gen = torch.Generator(device=device).manual_seed(7)
    w = torch.randn(SGD_D, generator=gen, device=device)
    sgd_stream_agreement(torch, sgd, w, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_sgd_counts(sgd)
    clf = SGDClassifier(random_state=0)
    n_done, first, t0 = 0, None, time.perf_counter()
    for i, (Xb, yb) in enumerate(stream_classification_blocks(SGD_BLOCKS, SGD_ROWS, SGD_D,
                                                              seed=0, coef=w, device=device)):
        clf.partial_fit(Xb, yb, classes=[0.0, 1.0])
        if i == 0:
            first = clf._loss_
        if i + 1 == SGD_WARM:
            float(clf._loss_)  # the steady clock starts here
            t0 = time.perf_counter()
        elif i % SGD_SYNC == SGD_SYNC - 1:
            float(clf._loss_)
        n_done += 1
    final = float(clf._loss_)
    dt = time.perf_counter() - t0
    launches, plain = sgd.sgd_update.launches, sgd.sgd_update_ref.calls
    peak = torch.cuda.max_memory_allocated()
    steady = n_done - SGD_WARM
    ms_block = 1e3 * dt / steady
    rows_s = steady * SGD_ROWS / dt
    gbs = steady * SGD_ROWS * SGD_D * 4 / dt / 1e9
    coef = torch.from_numpy(clf.coef_[0]).to(device)
    cos = cosine(torch, coef, w)
    first = float(first)
    log(f"phase 10b: streamed SGD {n_done}x{SGD_ROWS}x{SGD_D} float32 "
        f"({n_done * SGD_ROWS * SGD_D * 4 / 1e9:.2f} GB over the stream): steady "
        f"{ms_block:.4f} ms/block after {SGD_WARM} warm blocks, {rows_s:.6g} rows/s, "
        f"{gbs:.2f} GB/s of x, train loss {first:.6f} (block 1) -> {final:.6f}, t_ {clf.t_}, "
        f"K4 launches {launches}, plain-version calls {plain}, peak allocated "
        f"{peak / 2**30:.3f} GiB (base {base / 2**30:.3f}), cosine to w {cos:.6f} [{card}]")
    gate(n_done == SGD_BLOCKS, f"{n_done} of {SGD_BLOCKS} blocks done", phase=10)
    gate(peak < 2e9, f"peak allocated {peak} B over the stream", phase=10)
    gate(cos >= 0.99, f"cosine of coef to w {cos}", phase=10)
    gate(final < first, f"final loss {final} not below the first block's {first}", phase=10)
    gate(launches == SGD_BLOCKS and plain == 0,
             f"K4 launched {launches} times, the plain version {plain} times", phase=10)
    return launches


def sgd_table_entry(torch, sgd, case, hyper, name, kind, card, one_launch=False):
    """10c: one entry of SGD_TABLE on its inputs: the wrapper timed (CUDA
    events over 20 launches, for a step or a loss queued behind a device
    sleep so that the host's call does not pace them, and also at the
    host's pace; an epoch's time divided by its steps) beside
    its plain version (3 runs), its bound from this view's rows (a step's),
    the addmm + elementwise + mm sequence for a step and addmm +
    elementwise + sum for the loss (informational: no single PyTorch call
    computes either), and its largest difference from the plain version in
    float64 on the same inputs (``hold_sgd``, ``hold_epoch``).  ``case``:
    a block, a minibatch view, or (an epoch) the stacks of a block's
    minibatches.  ``one_launch``: gate that a call is one launch on the
    device, with no ``finalize_kernel`` (the K = 1 step and loss)."""
    x, y, mask, coef, intercept = case
    B, d = x.shape[0], x.shape[-1]
    K = y.shape[-1]
    loss = "log_loss"
    kw = dict(loss=loss, penalty="l2", schedule="optimal")
    c, b, t = coef.clone(), intercept.clone(), torch.tensor(5.0, device=x.device)
    steps = x.shape[1] if kind == "epoch" else 1
    split = None
    if kind == "epoch":
        ms = time_ms(torch, lambda: sgd.sgd_epoch(x, y, mask, c, b, t, hyper, **kw), 20) / steps
        plain_ms = time_ms(torch, lambda: sgd.sgd_epoch_ref(x, y, mask, c, b, t, hyper, **kw),
                           3) / steps
        one = (x[:, 5], y[:, 5], mask[:, 5])
    elif kind == "update":
        call = lambda: sgd.sgd_update(x, y, mask, c, b, t, hyper, **kw)  # noqa: E731
        ms, host_ms = queued_ms(torch, call, 20), time_ms(torch, call, 20)
        plain_ms = time_ms(torch, lambda: sgd.sgd_update_ref(x, y, mask, c, b, t, hyper, **kw), 3)
        one = (x, y, mask)
        split = k4_split(torch, call)
    else:
        call = lambda: sgd.sgd_loss(x, y, mask, c, b, hyper, loss=loss)  # noqa: E731
        ms, host_ms = queued_ms(torch, call, 20), time_ms(torch, call, 20)
        plain_ms = time_ms(torch, lambda: sgd.sgd_loss_ref(x, y, mask, c, b, hyper, loss=loss), 3)
        one = (x, y, mask)
        split = k4_split(torch, call)

    def library():
        xo, yo, mo = one
        m = torch.addmm(intercept, xo, coef)
        z = yo * m
        if kind == "loss":
            return torch.sum(torch.nn.functional.softplus(-z) * mo[:, None])
        dm = -torch.sigmoid(-z) * yo * mo[:, None]
        return torch.mm(xo.T, dm)

    lib_ms = time_ms(torch, library, 20)
    if kind == "epoch":
        err = hold_epoch(torch, sgd, case, hyper, name, loss)
    else:
        err_update, err_loss = hold_sgd(torch, sgd, case, hyper, name, loss)
        err = err_update if kind == "update" else err_loss
    nbytes = B * d * 4 + B * (K + 1) * 4 + (1 if kind == "loss" else 2) * (d + 1) * K * 4
    flops = (2 if kind == "loss" else 4) * B * d * K
    b_ms, b_by = bound_ms(nbytes, flops)
    if kind == "epoch":
        rows = f"rows i::{steps} of {B * steps}, a step of {steps}"
    elif x.stride(0) != d:
        rows = f"rows 5::{x.stride(0) // d} of {B * x.stride(0) // d}"
    else:
        rows = "rows"
    log(f"phase 10c: {name} at {B} {rows} x {d}, K={K}: {ms:.4f} ms, "
        f"{B / ms * 1e3:.4g} rows/s, {nbytes / ms / 1e6:.1f} GB/s, "
        f"{b_ms / ms:.1%} of the bound (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by "
        f"{b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; the PyTorch sequence, "
        f"informational: {lib_ms:.4f} ms) [{card}]")
    if kind != "epoch":
        log(f"phase 10c: {name} at the host's pace {host_ms:.4f} ms a call; on the device, a "
            f"call: {fmt_split(split)} [{card}]")
        if one_launch and split is not None:
            gate(split["finish_ms"] == 0.0 and split["launches"] <= 1.0,
                 f"10c: {name} is not one launch a call: {fmt_split(split)}", phase=10)
    replaces = {"update": "dask_ml_tpu/linear_model/_sgd.py:146",
                "epoch": "dask_ml_tpu/linear_model/_sgd.py:203",
                "loss": "dask_ml_tpu/linear_model/_sgd.py:241"}[kind]
    return {"name": name, "route": "cuda", "source": "dask_ml_tpu_torch/csrc/sgd.cu",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def device_events(torch, fn, reps):
    """``fn()`` (warmed once) ``reps`` times under ``torch.profiler``, the
    window opened by PROFILE_PADS spin kernels and a sync, left out: the
    device events, (start us, end us, kernel name), in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, kernel_name(e.name))
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)


def by_kernel(events, reps):
    """{kernel name: (device ms, launches)} a call, from ``device_events``."""
    out = {}
    for start, end, name in events:
        ms, count = out.get(name, (0.0, 0))
        out[name] = (ms + (end - start) / 1e3 / reps, count + 1 / reps)
    return out


def k4_split(torch, fn, reps=20):
    """10c, 12d: ``fn`` (one K4 call) ``reps`` times under ``torch.profiler``
    (the window opened by PROFILE_PADS spin kernels, left out): a call's
    device launches, the step kernel's device time, the finish's
    (``finalize_kernel``, a launch of its own; 0 where the step finishes
    inside its launch) and the device's gap from the step kernel's end to
    the finish's start.  Returns {"launches", "kernel_ms", "finish_ms",
    "gap_ms"} a call, or None where the profiler recorded no device event."""
    events = device_events(torch, fn, reps)
    if not events:
        return None
    kernel = finish = gap = 0.0
    for i, (start, end, name) in enumerate(events):
        if name == "finalize_kernel":
            finish += end - start
            if i:
                gap += start - events[i - 1][1]
        else:
            kernel += end - start
    return {"launches": len(events) / reps, "kernel_ms": kernel / 1e3 / reps,
            "finish_ms": finish / 1e3 / reps, "gap_ms": gap / 1e3 / reps}


def fmt_split(split):
    if split is None:
        return "not measured (the profiler recorded no device event)"
    return (f"{split['launches']:g} launches, the step kernel {split['kernel_ms']:.4f} ms, "
            f"finalize_kernel {split['finish_ms']:.4f} ms, the gap between them "
            f"{split['gap_ms']:.4f} ms")


def k4_epoch_step(torch, sgd):
    """K4's step run as an epoch of one minibatch (``sgd_epoch_run`` with
    n_mb = 1, through the library: the wrapper takes n_mb >= 2), with
    ``sgd.sgd_update``'s arguments."""
    import ctypes

    def update(x, y, mask, coef, intercept, t, hyper, *, loss, penalty, schedule,
               fit_intercept=True):
        lib = sgd._load()
        B, d = x.shape
        K = y.shape[1]
        plan, scratch = sgd._plan(lib, x.device, sgd.LOSSES[loss], B, d, K, epoch=True)
        out = torch.empty(2, dtype=torch.float32, device=x.device)
        err = lib.sgd_epoch_run(
            plan, sgd.LOSSES[loss], sgd.PENALTIES[penalty], sgd.SCHEDULES[schedule],
            int(fit_intercept), x.data_ptr(), x.stride(0), 0, y.data_ptr(), y.stride(0), 0,
            mask.data_ptr(), mask.stride(0), 0, coef.data_ptr(), intercept.data_ptr(),
            t.data_ptr(), hyper.data_ptr(), B, 1, d, K, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sgd_epoch_run: CUDA error {err}")
        return out

    return update


def k4_step_variants(torch, sgd, case, hyper, name, card):
    """The K=1 step at ``case``'s shape two ways, in turns: (a) ``sgd_update``
    as the package under test runs it, and (b) the epoch kernel run as an
    epoch of one minibatch (``k4_epoch_step``); each held against its plain
    version in float64 (``hold_sgd``, twice with the same bits), then timed
    (CUDA events over 20 calls queued behind a device sleep) in the order a,
    b, b, a, with (b)'s device split.  Returns {"a": [ms, ms], "b": [ms,
    ms]}."""
    x, y, mask, coef, intercept = case
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    ways = {"a": sgd.sgd_update, "b": k4_epoch_step(torch, sgd)}
    errs = {}
    for way, fn in ways.items():
        errs[way] = hold_sgd(torch, sgd, case, hyper, f"{name} ({way})", "log_loss",
                             update=fn)[0]
    c, b, t = coef.clone(), intercept.clone(), torch.tensor(5.0, device=x.device)
    times = {"a": [], "b": []}
    for way in ("a", "b", "b", "a"):
        fn = ways[way]
        times[way].append(queued_ms(torch, lambda: fn(x, y, mask, c, b, t, hyper, **kw), 20))
    split = k4_split(torch, lambda: ways["b"](x, y, mask, c, b, t, hyper, **kw))
    log(f"k4 step ways at {name} ({x.shape[0]} x {x.shape[1]}): (a) sgd_update "
        f"{', '.join(f'{v:.4f}' for v in times['a'])} ms (max abs err {errs['a']:.3g}); (b) the "
        f"epoch kernel over one minibatch {', '.join(f'{v:.4f}' for v in times['b'])} ms (max "
        f"abs err {errs['b']:.3g}; on the device: {fmt_split(split)}) [{card}]")
    return times


def sgd_table(torch, sgd, device, launches, card):
    """10c: every entry of SGD_TABLE at the shape its path gives K4 (a
    2^20 x 64 block, minibatch 5 of its SGD_ROWS // SGD_FIT_BATCH strided
    views, or all of them for an epoch).  Returns the kernels line's
    entries: those a path of this run launched, with their launches."""
    out = []
    n_mb = SGD_ROWS // SGD_FIT_BATCH
    for K in (1, SGD_OVA_K):
        block = sgd_inputs(torch, SGD_ROWS, SGD_D, K, "log_loss", 1, device)
        hyper = sgd_hyper(torch, device)
        x, y, mask, coef, intercept = block
        stacks = (x.view(-1, n_mb, SGD_D), y.view(-1, n_mb, K), mask.view(-1, n_mb), coef,
                  intercept)
        for name, k, strided, kind in SGD_TABLE:
            if k != K:
                continue
            case = (stacks if kind == "epoch" else minibatch_view(block, n_mb)) if strided \
                else block
            entry = sgd_table_entry(torch, sgd, case, hyper, name, kind, card,
                                    one_launch=K == 1 and kind != "epoch")
            if launches.get(name):
                out.append(dict(entry, launches=launches[name]))
        del block, stacks, x, y, mask
    return out


def timed_fits(torch, make, X, y, reps=3):
    """``reps`` fits of ``make()``, each synced: the median host-clock ms of
    the whole fit, of its epoch loop (``linear_model/_sgd.py ::
    _run_epochs``, synced at both ends) and of the rest, its set-up."""
    from dask_ml_tpu_torch.linear_model import _sgd

    run, fits, loops = _sgd._run_epochs, [], []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_iter = run(*args, **kwargs)
        torch.cuda.synchronize()
        loops.append(1e3 * (time.perf_counter() - t0))
        return n_iter

    _sgd._run_epochs = timed
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make().fit(X, y)
            torch.cuda.synchronize()
            fits.append(1e3 * (time.perf_counter() - t0))
    finally:
        _sgd._run_epochs = run
    setups = [f - e for f, e in zip(fits, loops)]
    return tuple(sorted(v)[reps // 2] for v in (fits, loops, setups))


def sgd_fits(torch, sgd, device, card):
    """10d: the other entry points at full width, each with its launches:
    the full-batch and the scanned minibatch fits (the epoch loop timed
    apart from the rest of a fit, its set-up), a 10-class fit with early
    stopping (K4's value-only variant on its held-out rows) and
    ``Incremental(SGDRegressor)`` over a host array.  Returns {kernel
    entry: launches}."""
    import numpy as np

    from dask_ml_tpu_torch import Incremental, SGDClassifier, SGDRegressor
    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.datasets import stream_classification_blocks

    launches = {}
    n_mb = SGD_ROWS // SGD_FIT_BATCH
    gen = torch.Generator(device=device).manual_seed(11)
    w = torch.randn(SGD_D, generator=gen, device=device)
    (X, y), = stream_classification_blocks(1, SGD_ROWS, SGD_D, seed=3, coef=w, device=device)
    acc_true = float(((X.data @ w > 0).float() == y.data).float().mean())
    for label, bs in (("full batch", None), ("minibatch", SGD_FIT_BATCH)):
        def make():
            return SGDClassifier(max_iter=SGD_EPOCHS, tol=None, batch_size=bs)

        make().fit(X, y)  # warm: the plans and the allocator
        reset_sgd_counts(sgd)
        est = make().fit(X, y)
        torch.cuda.synchronize()
        steps, epochs = sgd.sgd_update.launches, sgd.sgd_epoch.launches
        n_plain = plain_sgd_calls(sgd)
        fit, loop, setup = timed_fits(torch, make, X, y)
        acc = est.score(X, y)
        log(f"phase 10d: SGDClassifier {label} fit {SGD_ROWS}x{SGD_D}, {SGD_EPOCHS} epochs: "
            f"{fit:.3f} ms, the epoch loop {loop:.3f} ms ({loop / SGD_EPOCHS:.4f} ms an epoch "
            f"of {1 if bs is None else n_mb} steps), set-up {setup:.3f} ms (medians of 3); "
            f"t_ {est.t_}, K4 launches: {steps} steps, {epochs} epochs, accuracy {acc:.6f} "
            f"(the true w: {acc_true:.6f}) [{card}]")
        gate(n_plain == 0, f"the {label} fit's plain-version calls {n_plain}", phase=10)
        gate(acc >= 0.98 * acc_true, f"the {label} fit's accuracy {acc}", phase=10)
        if bs is None:
            gate(steps == est.t_ and epochs == 0, f"the {label} fit's launches", phase=10)
        else:
            gate(est.t_ == SGD_EPOCHS * n_mb, f"minibatch steps {est.t_}", phase=10)
            gate(epochs == SGD_EPOCHS and steps == 0,
                 f"the {label} fit launched {epochs} epochs and {steps} steps", phase=10)
            launches["sgd_epoch_minibatch"] = epochs
    del X, y
    # 10 classes, one-vs-all, early stopping on the held-out rows' loss
    W = torch.randn(SGD_D, SGD_OVA_K, generator=gen, device=device)
    Xo = torch.randn(SGD_ROWS, SGD_D, generator=gen, device=device)
    yo = torch.argmax(Xo @ W + torch.randn(SGD_ROWS, SGD_OVA_K, generator=gen, device=device),
                      dim=1).float()
    acc_true = float((torch.argmax(Xo @ W, dim=1).float() == yo).float().mean())
    sX, sy = shard_rows(Xo), shard_rows(yo)
    reset_sgd_counts(sgd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = SGDClassifier(max_iter=8, tol=1e-4, early_stopping=True, batch_size=SGD_FIT_BATCH,
                        random_state=0).fit(sX, sy)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    acc = est.score(sX, sy)
    launches["sgd_epoch_K10_minibatch"] = sgd.sgd_epoch.launches
    launches["sgd_loss_K10"] = sgd.sgd_loss.launches
    log(f"phase 10d: SGDClassifier {SGD_OVA_K}-class one-vs-all fit with early stopping "
        f"{SGD_ROWS}x{SGD_D}, batch_size {SGD_FIT_BATCH}: {ms:.3f} ms, n_iter_ {est.n_iter_}, "
        f"t_ {est.t_}, K4 launches {launches['sgd_epoch_K10_minibatch']} (epochs of {n_mb} "
        f"strided minibatches), {sgd.sgd_update.launches} (steps), "
        f"{launches['sgd_loss_K10']} (loss, the whole block), accuracy {acc:.6f} (the true W: "
        f"{acc_true:.6f}) [{card}]")
    gate(launches["sgd_epoch_K10_minibatch"] == est.n_iter_ and est.t_ == est.n_iter_ * n_mb
         and sgd.sgd_update.launches == 0 and plain_sgd_calls(sgd) == 0,
         "the 10-class fit's epochs did not each go through K4 in one launch", phase=10)
    gate(launches["sgd_loss_K10"] == est.n_iter_,
         "the early-stopping fit's held-out losses did not all go through K4", phase=10)
    gate(acc >= 0.9 * acc_true, f"the {SGD_OVA_K}-class fit's accuracy {acc}", phase=10)
    # a multi-class stream: partial_fit on the whole 10-class block, a step each
    reset_sgd_counts(sgd)
    clf = SGDClassifier(random_state=0)
    classes = [float(k) for k in range(SGD_OVA_K)]
    for _ in range(SGD_PARTIAL):
        clf.partial_fit(sX, sy, classes=classes)
    torch.cuda.synchronize()
    launches["sgd_update_K10"] = sgd.sgd_update.launches
    acc = clf.score(sX, sy)
    log(f"phase 10d: SGDClassifier {SGD_OVA_K}-class partial_fit x{SGD_PARTIAL} on "
        f"{SGD_ROWS}x{SGD_D}: t_ {clf.t_}, K4 launches {launches['sgd_update_K10']}, accuracy "
        f"{acc:.6f} [{card}]")
    gate(launches["sgd_update_K10"] == SGD_PARTIAL and plain_sgd_calls(sgd) == 0,
         "the multi-class partial_fit's steps did not all go through K4", phase=10)
    gate(bool(np.isfinite(clf.coef_).all()) and acc > 1.0 / SGD_OVA_K,
         f"the multi-class partial_fit's accuracy {acc}", phase=10)
    del Xo, yo, sX, sy
    # Incremental(SGDRegressor) over a host array
    rng = np.random.RandomState(5)
    Xh = rng.standard_normal((SGD_ROWS, SGD_D)).astype(np.float32)
    wh = rng.standard_normal(SGD_D).astype(np.float32)
    yh = Xh @ wh + 0.5 + 0.1 * rng.standard_normal(SGD_ROWS).astype(np.float32)
    reset_sgd_counts(sgd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inc = Incremental(SGDRegressor(learning_rate="constant", eta0=0.5), chunk_size=SGD_FIT_BATCH,
                      random_state=0).fit(Xh, yh)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    r2 = inc.score(Xh, yh)
    log(f"phase 10d: Incremental(SGDRegressor(learning_rate='constant', eta0=0.5), "
        f"chunk_size={SGD_FIT_BATCH}).fit on a host "
        f"array {SGD_ROWS}x{SGD_D}: {ms:.3f} ms, {SGD_ROWS // SGD_FIT_BATCH} blocks, K4 launches "
        f"{sgd.sgd_update.launches}, R² {r2:.6f} [{card}]")
    gate(sgd.sgd_update.launches == SGD_ROWS // SGD_FIT_BATCH, "Incremental's launches", phase=10)
    gate(r2 >= 0.99, f"Incremental(SGDRegressor) R² {r2}", phase=10)
    return launches


def sgd_profile(torch, sgd, device, card):
    """10e: SGD_PROFILE blocks of the stream under ``torch.profiler``, after
    2 warm blocks: the device's busy and idle share, the device kernels and
    the runtime's launch calls a block, and the host syncs a block (counted
    by ``torch.cuda.set_sync_debug_mode``'s warnings)."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.datasets import stream_classification_blocks

    blocks = list(stream_classification_blocks(SGD_PROFILE + 2, SGD_ROWS, SGD_D, seed=9,
                                               device=device))
    clf = SGDClassifier(random_state=0)
    for Xb, yb in blocks[:2]:
        clf.partial_fit(Xb, yb, classes=[0.0, 1.0])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for Xb, yb in blocks[2:]:
                    clf.partial_fit(Xb, yb, classes=[0.0, 1.0])
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    per_name, launch_calls = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
        elif "LaunchKernel" in e.name:
            launch_calls += 1
    log(f"phase 10e: profiled stream of {SGD_PROFILE} blocks: {wall_ms:.3f} ms on the host "
        f"clock ({wall_ms / SGD_PROFILE:.4f} ms/block), {syncs / SGD_PROFILE:.2f} host syncs a "
        f"block, {launch_calls / SGD_PROFILE:.2f} runtime launch calls a block [{card}]")
    if not per_name:
        log("  device time by kernel: not measured (the profiler recorded no device event)")
        return
    busy = sum(ms for ms, _ in per_name.values())
    n_dev = sum(c for _, c in per_name.values())
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  device {ms:10.4f} ms {count:5d}x  {name[:110]}")
    log(f"  device busy {busy:.3f} ms of {wall_ms:.3f} ms: idle share "
        f"{(wall_ms - busy) / wall_ms:.4f}; {n_dev / SGD_PROFILE:.2f} device operations a block")
    steps = sum(c for name, (_, c) in per_name.items() if kernel_name(name) == "step_kernel")
    finishes = sum(c for name, (_, c) in per_name.items()
                   if kernel_name(name) == "finalize_kernel")
    log(f"  K4: step_kernel {steps}x, finalize_kernel {finishes}x for {SGD_PROFILE} blocks")
    gate(finishes == 0 and 0 < steps <= SGD_PROFILE,
         f"10e: K4's K=1 step is not one launch a block (step_kernel {steps}x, "
         f"finalize_kernel {finishes}x for {SGD_PROFILE} blocks)", phase=10)


def kernel_name(name):
    """A device event's kernel name without its namespace and arguments."""
    m = re.search(r"([A-Za-z_]+_kernel)", name)
    return m.group(1) if m else name.split("(")[0][:60]


def epoch_profile(torch, device, K, card):
    """10e: one epoch of ``linear_model/_sgd.py :: sgd_epoch`` (the
    minibatch fits' epoch: SGD_ROWS // SGD_FIT_BATCH steps on the strided
    views of a 2^20 x 64 block, log_loss, l2, optimal) under
    ``torch.profiler``, after a warm epoch: per step, each kernel's device
    time, the device's idle time between the epoch's first and last device
    event, and the host clock of the whole call (synced); beside them the
    call's CUDA-event time a step (outside the profiler), which a profile
    that dropped a kernel's event does not match.  Returns {"host_ms",
    "device_ms", "gap_ms", "event_ms"} a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dask_ml_tpu_torch.linear_model import _sgd

    n_mb = SGD_ROWS // SGD_FIT_BATCH
    x, y, _, coef, intercept = sgd_inputs(torch, SGD_ROWS, SGD_D, K, "log_loss", 21, device)
    mask = torch.ones(SGD_ROWS, device=device)
    views = (x.view(-1, n_mb, SGD_D), y.view(-1, n_mb, K), mask.view(-1, n_mb))
    hyper = sgd_hyper(torch, device)
    state = {"coef": coef.clone(), "intercept": intercept.clone(),
             "t": torch.tensor(0.0, device=device)}
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    _sgd.sgd_epoch(state, *views, hyper, **kw)  # warm: the plan and the allocator
    event_ms = time_ms(torch, lambda: _sgd.sgd_epoch(state, *views, hyper, **kw), 5) / n_mb
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sgd.sgd_epoch(state, *views, hyper, **kw)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / n_mb
    events = sorted(((e.time_range.start, e.time_range.end, kernel_name(e.name))
                     for e in prof.events() if e.device_type == DeviceType.CUDA))
    label = f"{'binary' if K == 1 else f'{K}-class'} minibatch fit's epoch ({n_mb} steps)"
    if not events:
        log(f"phase 10e: {label}: host {host_ms:.4f} ms a step, CUDA events {event_ms:.4f} ms; "
            f"device time: not measured (the profiler recorded no device event) [{card}]")
        return {"host_ms": host_ms, "device_ms": None, "gap_ms": None, "event_ms": event_ms}
    per_name = {}
    for start, end, name in events:
        ms, count = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + (end - start) / 1e3, count + 1)
    busy = sum(ms for ms, _ in per_name.values())
    span = (events[-1][1] - events[0][0]) / 1e3
    kernels = ", ".join(f"{name} {ms / n_mb:.4f} ms ({count}x)"
                        for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0]))
    dropped = " (below the CUDA-event time: the profiler dropped events)" \
        if busy / n_mb < 0.5 * event_ms else ""
    log(f"phase 10e: {label}, a step: host {host_ms:.4f} ms; device {busy / n_mb:.4f} ms "
        f"({kernels}){dropped}; idle between the epoch's device events "
        f"{(span - busy) / n_mb:.4f} ms; CUDA events {event_ms:.4f} ms [{card}]")
    return {"host_ms": host_ms, "device_ms": busy / n_mb, "gap_ms": (span - busy) / n_mb,
            "event_ms": event_ms}


def k4_yardstick(torch, device, card):
    """``--k4-yardstick ROOT``: 12d's host-block step (HOST_ROWS x HOST_D),
    the step and loss entries of SGD_TABLE (10c), each with its device
    split, the K=1 step at both block shapes beside the epoch kernel run as
    an epoch of one minibatch (``k4_step_variants``), and the two minibatch
    fits' epoch profiles (10e), on the package under ROOT (a parent's tree,
    or this one), so that two trees are timed in one call on one card."""
    from dask_ml_tpu_torch.ops import _build, sgd

    log(f"k4 yardstick: {sgd.__file__}")
    _build.build(["sgd"])
    n_mb = SGD_ROWS // SGD_FIT_BATCH
    hyper = sgd_hyper(torch, device)
    case = sgd_inputs(torch, HOST_ROWS, HOST_D, 1, "log_loss", 12, device)
    sgd_table_entry(torch, sgd, case, hyper, "sgd_update_host_block", "update", card)
    k4_step_variants(torch, sgd, case, hyper, "sgd_update_host_block", card)
    del case
    for K in (1, SGD_OVA_K):
        block = sgd_inputs(torch, SGD_ROWS, SGD_D, K, "log_loss", 1, device)
        for name, k, strided, kind in SGD_TABLE:
            if k == K and kind != "epoch":
                sgd_table_entry(torch, sgd, minibatch_view(block, n_mb) if strided else block,
                                hyper, name, kind, card)
        if K == 1:
            k4_step_variants(torch, sgd, block, hyper, "sgd_update", card)
        del block
    for K in (1, SGD_OVA_K):
        epoch_profile(torch, device, K, card)


def sgd_phase(torch, device, card):
    """Phase 10 end to end; returns K4's lines of the table."""
    from dask_ml_tpu_torch.ops import sgd

    compare_sgd(torch, sgd, device)
    compare_epoch(torch, sgd, device)
    launches = {"sgd_update": sgd_stream(torch, sgd, device, card)}
    launches.update(sgd_fits(torch, sgd, device, card))
    out = sgd_table(torch, sgd, device, launches, card)
    sgd_profile(torch, sgd, device, card)
    for K in (1, SGD_OVA_K):
        epoch_profile(torch, device, K, card)
    return out


def cohort_hypers(torch, M, device, loss, schedule):
    """(M, 7) hyperparameters a lane: alpha over 1e-5..1e-1 and eta0 over
    0.005..0.05 across the lanes, t0 = 1/(alpha·eta0) as the estimators set
    it, epsilon over 0.05..0.5 (huber), eta_scale 0.2 for adaptive."""
    alpha = torch.logspace(-5, -1, M, dtype=torch.float64)
    eta0 = torch.linspace(0.005, 0.05, M, dtype=torch.float64)
    cols = [alpha, eta0, torch.full((M,), 0.25, dtype=torch.float64), 1.0 / (alpha * eta0),
            torch.full((M,), 0.15, dtype=torch.float64),
            torch.linspace(0.05, 0.5, M, dtype=torch.float64),
            torch.full((M,), 0.2 if schedule == "adaptive" else 1.0, dtype=torch.float64)]
    return torch.stack(cols, 1).to(device=device, dtype=torch.float32).contiguous()


def cohort_inputs(torch, B, d, K, M, loss, seed, device, weighted=False, zero_lane=False,
                  scale=1.0, n_mb=None):
    """x, targets and a mask as ``sgd_inputs`` gives them (with ``n_mb``:
    minibatch 5 of a block of B·n_mb rows, a strided view), the M lanes'
    masks (one mask broadcast with stride 0, or with ``weighted`` each lane's
    own class-weighted copy; with ``zero_lane`` lane M // 2 all zero), and a
    state a lane (coef with margins of spread ``scale``, t from 3 up)."""
    rows = B * n_mb if n_mb else B
    x, y, mask, _, _ = sgd_inputs(torch, rows, d, K, loss, seed, device, scale)
    if n_mb:
        x, y, mask = x.view(-1, n_mb, d)[:, 5], y.view(-1, n_mb, K)[:, 5], \
            mask.view(-1, n_mb)[:, 5]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if weighted or zero_lane:
        cls = (y[:, 0] > 0).float() if K == 1 else torch.argmax(y, dim=1).float()
        w = 0.5 + torch.rand(M, 1, generator=gen, device=device) * (1.0 + cls[None, :]) \
            if weighted else torch.ones(M, 1, device=device)
        masks = (mask[None, :] * w).contiguous()
        if zero_lane:
            masks[M // 2] = 0.0
    else:
        masks = mask[None, :].expand(M, mask.shape[0])
    coef = scale * torch.randn(M, d, K, generator=gen, device=device) / d ** 0.5
    intercept = 0.1 * torch.randn(M, K, generator=gen, device=device)
    t = 3.0 + torch.arange(M, device=device, dtype=torch.float32) % 7
    return x, y.contiguous() if n_mb is None else y, masks, coef, intercept, t


def hold_cohort(torch, cohort, sgd, case, hypers, what, loss, penalty="l2",
                schedule="optimal", fit_intercept=True):
    """11a: K5 against its plain version taken in float64 on the same
    inputs, lane by lane as ``hold_sgd`` holds K4: each lane's mean loss and
    count to rtol COHORT_TOL, its coef and intercept to
    COHORT_TOL·eta·max|g| plus 2^-22 of each element (the float32 rounding
    of c − eta·g), with hinge's rows within 1e-5 of its kink allowed their
    jump of dℓ; t equal; a repeat from the same state the same bits.
    Returns (the largest absolute difference, the kernel's new coef)."""
    x, y, masks, coef, intercept, t = case
    d64 = torch.float64
    c64, b64, t64, h64 = coef.to(d64), intercept.to(d64), t.to(d64), hypers.to(d64)
    out64 = torch.empty((masks.shape[0], 2), dtype=d64, device=x.device)
    kw = dict(loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    cohort.cohort_step_ref(x.to(d64), y.to(d64), masks.to(d64), c64, b64, t64, h64, out=out64,
                           **kw)
    runs = []
    for _ in range(2):
        c32, b32, t32 = coef.clone(), intercept.clone(), t.clone()
        out = cohort.cohort_step(x, y, masks, c32, b32, t32, hypers, **kw)
        runs.append((c32, b32, t32, out))
    torch.cuda.synchronize()
    c32, b32, t32, out = runs[0]
    if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])):
        raise AssertionError(f"K5 {what}: a repeat gave other bits")
    eta = sgd.learning_rate(schedule, t.to(d64), h64.T)  # (M,)
    g = torch.cat([(coef.to(d64) - c64).flatten(1), (intercept.to(d64) - b64)], 1) / eta[:, None]
    gmax = g.abs().amax(1)
    count = torch.clamp(out64[:, 1], min=1.0)
    allow = torch.zeros_like(eta)
    if loss == "hinge":
        z = y.to(d64)[None] * (torch.matmul(x.to(d64), coef.to(d64)) + intercept.to(d64)[:, None])
        near = ((z - 1.0).abs() <= 1e-5 * (1.0 + z.abs())) & (masks[:, :, None] > 0)
        allow = eta * near.flatten(1).sum(1) * float(masks.max()) * float(x.abs().max()) / count
    err = 0.0
    for got, want in ((c32.flatten(1), c64.flatten(1)), (b32, b64)):
        diff = (got.to(d64) - want).abs()
        tol = (COHORT_TOL * eta * gmax + allow)[:, None] + 2.0 ** -22 * want.abs()
        if not bool((diff <= tol).all()):
            worst = float((diff / tol).max())
            lane = int((diff / tol).amax(1).argmax())
            raise AssertionError(f"K5 update {what}: {worst:.3g}x its tolerance at lane {lane} "
                                 f"(max|Δ| {float(diff.max()):.3g})")
        err = max(err, float(diff.max()))
    if not torch.equal(t32.to(d64), t64):
        raise AssertionError(f"K5 {what}: t {t32.tolist()} against {t64.tolist()}")
    dl = (out.to(d64) - out64).abs()
    if not bool((dl <= COHORT_TOL * out64.abs()).all()):
        raise AssertionError(f"K5 {what}: (loss, count) off by {dl.amax(0).tolist()} "
                             f"(plain {out64[:4].tolist()}...)")
    return max(err, float(dl[:, 0].max())), c32


def cohort_edge_cases():
    """11a: (label, B, d, K, M, loss, options) of every case held."""
    big = SGD_ROWS
    return [
        ("M=1 K=1 B=2^20+3", big + 3, SGD_D, 1, 1, "log_loss", {}),
        ("M=2 K=3 d=1 l1", 4099, 1, 3, 2, "hinge", {"penalty": "l1"}),
        ("M=5 K=10 d=130 elasticnet invscaling", 20011, 130, 10, 5, "squared_hinge",
         {"penalty": "elasticnet", "schedule": "invscaling"}),
        ("M=34 K=1 no penalty constant", big + 3, SGD_D, 1, 34, "modified_huber",
         {"penalty": None, "schedule": "constant"}),
        ("M=81 K=1 (the search's brackets)", big, SGD_D, 1, 81, "log_loss", {}),
        ("M=81 K=1 weighted lanes, lane 40 all zero", big + 3, SGD_D, 1, 81, "log_loss",
         {"weighted": True, "zero_lane": True}),
        ("M·K=810 (81 lanes of 10 classes) adaptive", (1 << 17) + 5, SGD_D, 10, 81, "log_loss",
         {"schedule": "adaptive"}),
        ("B=37 K=3 no intercept", 37, SGD_D, 3, 5, "hinge", {"fit_intercept": False}),
        ("strided rows 5::16 M=9", 65536, SGD_D, 1, 9, "log_loss", {"n_mb": 16}),
        ("squared_error M=9 weighted", 65539, SGD_D, 1, 9, "squared_error",
         {"weighted": True}),
        ("huber M=27 d=130 l1 adaptive", 20011, 130, 1, 27, "huber",
         {"penalty": "l1", "schedule": "adaptive", "scale": 3.0}),
        ("M=34 K=3 d=130 margins past ±80", 20011, 130, 3, 34, "modified_huber",
         {"scale": 60.0, "weighted": True}),
        ("M=2 K=1 d=1", 4099, 1, 1, 2, "log_loss", {"schedule": "invscaling"}),
    ]


def compare_cohort(torch, device):
    """11a: every edge case held against the float64 plain version; then K5
    at M = 1 against K4's ``sgd_update`` on the same inputs (each within
    its tolerance of the float64 plain version, so within twice it of each
    other).  Returns the largest absolute difference over the cases."""
    from dask_ml_tpu_torch.ops import cohort, sgd

    worst = 0.0
    cases = cohort_edge_cases()
    for i, (label, B, d, K, M, loss, opts) in enumerate(cases):
        opts = dict(opts)
        inputs = {k: opts.pop(k) for k in ("weighted", "zero_lane", "scale", "n_mb") if k in opts}
        case = cohort_inputs(torch, B, d, K, M, loss, 300 + i, device, **inputs)
        hypers = cohort_hypers(torch, M, device, loss, opts.get("schedule", "optimal"))
        err, c_k5 = hold_cohort(torch, cohort, sgd, case, hypers, label, loss, **opts)
        worst = max(worst, err)
        if M == 1:
            hold_k4_lane(torch, sgd, case, hypers, c_k5, label, loss, opts)
        del case
    log(f"phase 11a: K5 held against its plain version (float64) at {len(cases)} shapes, rtol "
        f"{COHORT_TOL}, each twice with the same bits; largest absolute difference {worst:.3g}")
    return worst


def hold_k4_lane(torch, sgd, case, hypers, c_k5, label, loss, opts):
    """11a: K5's one lane against K4's ``sgd_update`` from the same state."""
    x, y, masks, coef, intercept, t = case
    schedule = opts.get("schedule", "optimal")
    c4, b4, t4 = coef[0].clone(), intercept[0].clone(), t[0].clone()
    sgd.sgd_update(x, y, masks[0], c4, b4, t4, hypers[0], loss=loss,
                   penalty=opts.get("penalty", "l2"), schedule=schedule)
    gap = float((c4 - c_k5[0]).abs().max())
    eta = float(sgd.learning_rate(schedule, t[0].double(), hypers[0].double()))
    g = float((coef[0].double() - c4.double()).abs().max()) / eta
    lim = 2 * (COHORT_TOL * eta * g + 2.0 ** -22 * float(c4.abs().max()))
    gate(gap <= lim, f"K5 at M=1 is {gap} from K4's sgd_update (limit {lim})", phase=11)
    log(f"phase 11a: K5 at M=1 against K4's sgd_update on {label}: max|Δcoef| {gap:.3g} "
        f"(limit {lim:.3g})")


def search_standin(torch, n, d, seed, device):
    """BASELINE ``configs[4]``'s data on the card: X and w standard normal,
    y = [X·w + logistic noise > 0] (float labels 0 and 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(d, generator=gen, device=device)
    X = torch.randn(n, d, generator=gen, device=device)
    u = torch.rand(n, generator=gen, device=device).clamp_(1e-7, 1 - 1e-7)
    y = (X @ w + torch.log(u / (1.0 - u)) > 0).float()
    return X, y, w


def search_estimator():
    """11b's search (BASELINE ``configs[4]``): 200 alphas, l2, max_iter 81
    (143 models in 5 brackets), 2^20-row blocks and test split."""
    import numpy as np

    from dask_ml_tpu_torch import HyperbandSearchCV, SGDClassifier

    return HyperbandSearchCV(SGDClassifier(tol=None, random_state=0),
                             {"alpha": np.logspace(-7, 0, 200), "penalty": ["l2"]},
                             max_iter=SEARCH_MAX_ITER, test_size=SEARCH_CHUNK,
                             chunk_size=SEARCH_CHUNK, random_state=0)


class LaunchesBySize:
    """Counts the cohorts' K5 steps by cohort size (M, K) inside a ``with``
    block, by wrapping ``Cohort._advance`` (one launch each; the wrapper's
    own count is untouched)."""

    def __enter__(self):
        from dask_ml_tpu_torch.model_selection._packing import Cohort

        self.cls, self.real, self.counts = Cohort, Cohort._advance, {}

        def counted(cohort, xb, yb, masks):
            key = (masks.shape[0], yb.shape[1])
            self.counts[key] = self.counts.get(key, 0) + 1
            return self.real(cohort, xb, yb, masks)

        Cohort._advance = counted
        return self

    def __exit__(self, *exc):
        self.cls._advance = self.real


def search_main_path(torch, device, card):
    """11b: the search at BASELINE ``configs[4]`` through K5 (cohorts) and
    K4 (single models), every count set to 0 just before the fit and read
    just after.  Gates: ``metadata_ == metadata``; K5 launched and its plain
    version never (nor K4's); ``DISPATCH_STATS["dispatches"]`` equal to K5's
    launches and at most a quarter of ``models_stepped``; ``best_score_`` at
    least 0.98 of the true w's accuracy on the test split; the cosine of
    ``best_estimator_.coef_`` to w at least 0.99.  Returns (X, y, w, the
    search, K5's launches by cohort size)."""
    import warnings

    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.model_selection import _packing, train_test_split
    from dask_ml_tpu_torch.ops import cohort, sgd

    t0 = time.perf_counter()
    X, y, w = search_standin(torch, SEARCH_ROWS, SEARCH_D, 11, device)
    torch.cuda.synchronize()
    log(f"phase 11b: search stand-in {SEARCH_ROWS}x{SEARCH_D} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    sX, sy = shard_rows(X), shard_rows(y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cohort.cohort_step.launches = cohort.cohort_step_ref.calls = 0
    reset_sgd_counts(sgd)
    _packing.reset_dispatch_stats()
    with warnings.catch_warnings(record=True) as caught, LaunchesBySize() as by_size:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            hb = search_estimator().fit(sX, sy, classes=[0.0, 1.0])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    k5, k5_plain = cohort.cohort_step.launches, cohort.cohort_step_ref.calls
    k4, k4_plain = sgd.sgd_update.launches, plain_sgd_calls(sgd)
    stats = dict(_packing.DISPATCH_STATS)
    syncs = sum("synchroniz" in str(m.message) for m in caught)
    peak = torch.cuda.max_memory_allocated()
    _, X_test, _, y_test = train_test_split(sX, sy, test_size=SEARCH_CHUNK, random_state=0)
    acc_true = float(torch.mean(((X_test.unpad() @ w > 0).float() == y_test.unpad()).float()))
    coef = torch.from_numpy(hb.best_estimator_.coef_[0]).to(device)
    cos = cosine(torch, coef, w)
    sizes = ", ".join(f"M={m}: {n}" for (m, _), n in sorted(by_size.counts.items(),
                                                           reverse=True))
    log(f"phase 11b: HyperbandSearchCV fit {fit_s:.3f} s on the host clock: "
        f"{hb.metadata_['n_models']} models in {len(hb.metadata_['brackets'])} brackets, "
        f"{hb.metadata_['partial_fit_calls']} partial_fit calls, {hb._n_rounds} rounds; "
        f"K5 launches {k5} ({sizes}), K4 launches {k4} (single models), plain-version calls "
        f"{k5_plain} + {k4_plain}; DISPATCH_STATS {stats}; host syncs {syncs}; peak allocated "
        f"{peak / 2**30:.3f} GiB (base {base / 2**30:.3f}); best_score_ {hb.best_score_:.6f} "
        f"(the true w's {acc_true:.6f}), best alpha {hb.best_params_['alpha']:.4g}, cosine of "
        f"best coef to w {cos:.6f} [{card}]")
    gate(hb.metadata_ == hb.metadata, f"metadata_ {hb.metadata_} != metadata {hb.metadata}",
         phase=11)
    gate(k5 > 0 and k5_plain == 0 and k4_plain == 0,
         f"K5 launched {k5} times, its plain version {k5_plain}, K4's {k4_plain}", phase=11)
    gate(stats["dispatches"] == k5 and 4 * stats["dispatches"] <= stats["models_stepped"],
         f"dispatches {stats['dispatches']} against K5's {k5} launches and "
         f"{stats['models_stepped']} model-steps", phase=11)
    gate(hb.best_score_ >= 0.98 * acc_true,
         f"best_score_ {hb.best_score_} below 0.98 of the true w's {acc_true}", phase=11)
    gate(cos >= 0.99, f"cosine of best_estimator_.coef_ to w {cos}", phase=11)
    del X_test, y_test
    return X, y, w, sX, sy, hb, dict(by_size.counts)


def search_profile(torch, sX, sy, card):
    """11b: one more fit under ``torch.profiler``: the device's busy and
    idle share over the fit and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search_estimator().fit(sX, sy, classes=[0.0, 1.0])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e.name)
            ms, count = per_name.get(name, (0.0, 0))
            per_name[name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    if not per_name:
        log(f"phase 11b: profiled fit {wall_ms:.3f} ms; device time: not measured (the "
            f"profiler recorded no device event) [{card}]")
        return
    busy = sum(ms for ms, _ in per_name.values())
    k5 = [(ms, n) for name, (ms, n) in per_name.items() if name in K5_KERNELS]
    log(f"phase 11b: profiled fit {wall_ms:.3f} ms on the host clock, device busy {busy:.3f} "
        f"ms: idle share {(wall_ms - busy) / wall_ms:.4f}; K5 {sum(ms for ms, _ in k5):.3f} ms "
        f"in {sum(n for _, n in k5)} kernels [{card}]")
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  device {ms:10.4f} ms {count:6d}x  {name[:100]}")


# K5's kernels (csrc/cohort.cu; record_kernel was the record kernel's name
# before the ring path)
K5_KERNELS = ("record_kernel", "ring_kernel", "tile_kernel", "lanes_kernel", "update_kernel",
              "finish_kernel")


class PlainK5:
    """K5's wrapper replaced by its plain version (on the card, as a check
    only) inside a ``with`` block."""

    def __init__(self, cohort):
        self.cohort = cohort

    def __enter__(self):
        self.kernel = self.cohort.cohort_step
        self.cohort.cohort_step = self.cohort.cohort_step_ref
        return self

    def __exit__(self, *exc):
        self.cohort.cohort_step = self.kernel


def standalone_cohort(torch, sX, sy, card):
    """11c: a Cohort of 81 SGDClassifiers (alpha over 1e-7..1, as the
    search's grid) stepped over the search's first 8 training blocks
    through K5 and through the plain version: each lane's coef within
    1e-4·‖coef‖∞ of the plain one's; then 3 of its members replayed alone
    through K4 ``partial_fit`` on the same blocks, within the same."""
    import numpy as np

    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.model_selection import train_test_split
    from dask_ml_tpu_torch.model_selection._incremental import BaseIncrementalSearchCV
    from dask_ml_tpu_torch.model_selection._packing import Cohort
    from dask_ml_tpu_torch.ops import cohort

    X_train, _, y_train, _ = train_test_split(sX, sy, test_size=SEARCH_CHUNK, random_state=0)
    search = BaseIncrementalSearchCV(None, None, chunk_size=SEARCH_CHUNK)
    blocks = search._to_blocks(X_train, y_train)[:8]
    alphas = np.logspace(-7, 0, 81)

    def make():
        return [SGDClassifier(alpha=a, tol=None, random_state=0) for a in alphas]

    fits = []
    for plain in (False, True):
        models = make()
        c = Cohort(models, classes=[0.0, 1.0])
        t0 = time.perf_counter()
        with (PlainK5(cohort) if plain else contextlib.nullcontext()):
            for Xb, yb in blocks:
                c.step(Xb, yb)
            c.finalize()
            torch.cuda.synchronize()
        fits.append((models, 1e3 * (time.perf_counter() - t0)))
    (kern, kern_ms), (plain, plain_ms) = fits
    worst = 0.0
    for i, (a, b) in enumerate(zip(kern, plain)):
        gap = float(np.abs(a.coef_ - b.coef_).max())
        scale = float(np.abs(b.coef_).max())
        gate(gap <= 1e-4 * scale and a.t_ == b.t_ == 8,
             f"11c lane {i}: {gap} from the plain version (‖coef‖∞ {scale}), t_ {a.t_}",
             phase=11)
        worst = max(worst, gap / scale)
    replay = []
    for i in (0, 40, 80):
        solo = SGDClassifier(alpha=alphas[i], tol=None, random_state=0)
        for Xb, yb in blocks:
            solo.partial_fit(Xb, yb, classes=[0.0, 1.0])
        gap = float(np.abs(solo.coef_ - kern[i].coef_).max())
        scale = float(np.abs(solo.coef_).max())
        gate(gap <= 1e-4 * scale, f"11c member {i} alone through K4 is {gap} from its lane "
             f"(‖coef‖∞ {scale})", phase=11)
        replay.append(gap / scale)
    log(f"phase 11c: a Cohort of 81 over 8 blocks of {SEARCH_CHUNK}x{SEARCH_D}: through K5 "
        f"{kern_ms:.2f} ms, through the plain version {plain_ms:.2f} ms; largest lane gap "
        f"{worst:.3g}·‖coef‖∞; members 0, 40, 80 alone through K4: "
        f"{', '.join(f'{g:.3g}' for g in replay)}·‖coef‖∞ [{card}]")


def cohort_entry(torch, cohort, sgd, device, M, K, card, launches=None):
    """11d: K5 at (M, K) on a 2^20 x 64 block: held against its float64
    plain version, then timed (``queued_ms`` over 20 launches) beside its
    plain version (3 runs), its bound from these inputs and the matmul +
    elementwise + matmul sequence (informational: no one PyTorch call
    computes the step).  Returns its ``kernels`` entry."""
    case = cohort_inputs(torch, SGD_ROWS, SGD_D, K, M, "log_loss", 500 + M, device)
    hypers = cohort_hypers(torch, M, device, "log_loss", "optimal")
    err, _ = hold_cohort(torch, cohort, sgd, case, hypers, f"11d M={M} K={K}", "log_loss")
    x, y, masks, coef, intercept, t = case
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    c, b, tt = coef.clone(), intercept.clone(), t.clone()
    ms = queued_ms(torch, lambda: cohort.cohort_step(x, y, masks, c, b, tt, hypers, **kw), 20)
    plain_ms = time_ms(torch, lambda: cohort.cohort_step_ref(x, y, masks, c, b, tt, hypers,
                                                             **kw), 3)
    cols = coef.permute(1, 0, 2).reshape(SGD_D, M * K).contiguous()
    bcols = intercept.reshape(M * K)

    def library():
        z = y.repeat(1, M) * torch.addmm(bcols, x, cols)
        return torch.mm(x.T, -torch.sigmoid(-z) * y.repeat(1, M) * masks[0][:, None])

    lib_ms = time_ms(torch, library, 20)
    B = x.shape[0]
    nbytes = B * SGD_D * 4 + B * K * 4 + B * 4 + 2 * M * (SGD_D + 1) * K * 4 + 3 * M * 4
    flops = 4 * B * SGD_D * M * K
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"phase 11d: K5 at M={M}, K={K}, {B} x {SGD_D}: {ms:.4f} ms, {flops / ms / 1e6:.1f} "
        f"GFLOP/s, {b_ms / ms:.1%} of the bound (plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms by {b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; the PyTorch "
        f"sequence, informational: {lib_ms:.4f} ms) [{card}]")
    return {"name": f"cohort_step_M{M}_K{K}", "route": "cuda",
            "source": "dask_ml_tpu_torch/csrc/cohort.cu",
            "replaces": "dask_ml_tpu/model_selection/_packing.py:117",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def cohort_table(torch, device, by_size, hb_sX, hb_sy, card):
    """11d: ``cohort_entry`` at each (M, K) of COHORT_TIMES, and
    ``packed_accuracy`` of 81 models on the 2^20-row test split.  Returns
    the ``kernels`` entries of the shapes the main path launched, with
    their launches."""
    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.model_selection import train_test_split
    from dask_ml_tpu_torch.model_selection._packing import Cohort
    from dask_ml_tpu_torch.ops import cohort, sgd

    out = []
    for M, K in COHORT_TIMES:
        entry = cohort_entry(torch, cohort, sgd, device, M, K, card, by_size.get((M, K)))
        if entry["launches"]:
            out.append(entry)
    _, X_test, _, y_test = train_test_split(hb_sX, hb_sy, test_size=SEARCH_CHUNK,
                                            random_state=0)
    models = [SGDClassifier(alpha=a, tol=None) for a in torch.logspace(-7, 0, 81).tolist()]
    c = Cohort(models, classes=[0.0, 1.0])
    acc_ms = time_ms(torch, lambda: c.packed_accuracy(X_test, y_test), 20)
    log(f"phase 11d: packed_accuracy of 81 models on the {SEARCH_CHUNK}-row test split: "
        f"{acc_ms:.4f} ms a call (one (81,) read included) [{card}]")
    missing = sorted(set(by_size) - set(COHORT_TIMES))
    gate(not missing, f"the search launched K5 at {missing}, not timed in 11d", phase=11)
    return out


def k5_yardstick(torch, device, card):
    """``--k5-yardstick ROOT``: 11d's K5 entries and 11b's search (one fit
    on the host clock, then one under ``torch.profiler``) on the package
    under ROOT (a parent's tree, or this one), so that two trees are timed
    in one call on one card."""
    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.ops import _build, cohort, sgd

    log(f"k5 yardstick: {cohort.__file__}")
    _build.build(["cohort", "sgd"])
    for M, K in COHORT_TIMES:
        cohort_entry(torch, cohort, sgd, device, M, K, card)
    X, y, _ = search_standin(torch, SEARCH_ROWS, SEARCH_D, 11, device)
    sX, sy = shard_rows(X), shard_rows(y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search_estimator().fit(sX, sy, classes=[0.0, 1.0])
    torch.cuda.synchronize()
    log(f"k5 yardstick: HyperbandSearchCV fit {time.perf_counter() - t0:.3f} s on the host "
        f"clock [{card}]")
    search_profile(torch, sX, sy, card)


def search_phase(torch, device, card):
    """Phase 11 end to end; returns K5's lines of the table."""
    compare_cohort(torch, device)
    X, y, w, sX, sy, hb, by_size = search_main_path(torch, device, card)
    search_profile(torch, sX, sy, card)
    standalone_cohort(torch, sX, sy, card)
    out = cohort_table(torch, device, by_size, sX, sy, card)
    del X, y, sX, sy
    torch.cuda.synchronize()
    return out


def host_block(i):
    """Block ``i`` of the host stream: float32 standard normal from a numpy
    generator seeded by (HOST_SEED, i)."""
    import numpy as np

    return np.random.default_rng([HOST_SEED, i]).standard_normal((HOST_ROWS, HOST_D),
                                                                  dtype=np.float32)


def host_labels(xb):
    return xb[:, 0] > 0.5


def host_files(tmp):
    """12a's raw file (HOST_BLOCKS blocks written a block at a time), after a
    check that the directory holds it and 12b's dataset; returns its path."""
    import os
    import shutil

    nbytes = HOST_BLOCKS * HOST_ROWS * HOST_D * 4
    free = shutil.disk_usage(tmp).free
    need = int(2.1 * nbytes)  # the raw file and the dataset (zlib barely shrinks noise)
    gate(free >= need, f"{tmp} has {free} bytes free; the raw file and the dataset need "
         f"{need}", phase=12)
    path = os.path.join(tmp, "stream.f32")
    t0 = time.perf_counter()
    with open(path, "wb") as fh:
        for i in range(HOST_BLOCKS):
            host_block(i).tofile(fh)
    log(f"phase 12: wrote {HOST_BLOCKS} blocks of {HOST_ROWS}x{HOST_D} float32 "
        f"({nbytes / 2**30:.2f} GiB) to {path} in {time.perf_counter() - t0:.2f} s "
        f"({free / 2**30:.1f} GiB were free)")
    return path


def host_fit(torch, sgd, fit, depth, n_blocks, what):
    """One streamed fit from the host through ``fit(clf, depth)``, the K4
    counts set to 0 just before it and read just after: (clf, wall ms a
    block, the pipeline report, K4 launches, plain-version calls)."""
    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.pipeline import pipeline_report

    torch.cuda.synchronize()
    reset_sgd_counts(sgd)
    t0 = time.perf_counter()
    clf = fit(SGDClassifier(random_state=0), depth)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = sgd.sgd_update.launches, plain_sgd_calls(sgd)
    rep = pipeline_report()
    ms = 1e3 * wall / n_blocks
    split = ", ".join(f"{k[:-2]} {1e3 * rep[k] / n_blocks:.3f}" for k in
                      ("parse_s", "transfer_s", "compute_s", "stall_s", "hidden_s"))
    log(f"phase {what} at depth {depth}: {n_blocks} blocks in {1e3 * wall:.1f} ms, {ms:.3f} "
        f"ms/block, {n_blocks * HOST_ROWS / wall:.6g} rows/s, "
        f"{n_blocks * HOST_ROWS * HOST_D * 4 / wall / 1e6:.1f} MB/s of x; a block: {split} ms; "
        f"K4 launches {launches}, plain-version calls {plain}; host buffers "
        f"{rep['host_buffers']} ({rep['pinned_buffers']} page-locked), t_ {clf.t_}")
    return clf, ms, rep, launches, plain


def same_state(a, b):
    return (bool((a.coef_ == b.coef_).all()) and bool((a.intercept_ == b.intercept_).all())
            and a.t_ == b.t_)


def binary_stream(torch, sgd, path, card):
    """12a: ``_partial.fit`` over ``io.stream_binary_blocks`` at depths 0 and
    2, in turns (0, 2, 2, 0); gates: depth 2's state equals depth 0's and a
    serial in-memory ``partial_fit`` loop over the same blocks (made anew
    from the seed), K4 launched once a block, every staged host buffer
    page-locked.  Returns (depth-2 launches, depth-2 ms/block, depth-0
    ms/block, the depth-2 report)."""
    from dask_ml_tpu_torch import SGDClassifier, _partial, io

    def fit(clf, depth):
        blocks = ((xb, host_labels(xb)) for xb in io.stream_binary_blocks(path, HOST_ROWS, HOST_D))
        return _partial.fit(clf, blocks, prefetch_depth=depth, classes=[0, 1])

    runs = {0: [], 2: []}
    for depth in (0, 2, 2, 0):
        runs[depth].append(host_fit(torch, sgd, fit, depth, HOST_BLOCKS, "12a"))
    serial = SGDClassifier(random_state=0)
    for i in range(HOST_BLOCKS):
        xb = host_block(i)
        serial.partial_fit(xb, host_labels(xb), classes=[0, 1])
    for depth, fits in runs.items():
        for clf, _, rep, launches, plain in fits:
            gate(same_state(clf, serial), f"12a: the depth-{depth} fit's state differs from the "
                 "serial in-memory loop's", phase=12)
            gate(launches == HOST_BLOCKS and plain == 0,
                 f"12a: K4 launched {launches} times, its plain version {plain}", phase=12)
            if depth:
                gate(rep["staged"] and rep["host_buffers"] > 0
                     and rep["pinned_buffers"] == rep["host_buffers"],
                     f"12a: {rep['pinned_buffers']} of {rep['host_buffers']} staged host "
                     "buffers page-locked", phase=12)
    acc = float((serial.predict(xb) == host_labels(xb)).mean())
    gate(acc > 0.95, f"12a: train accuracy {acc} on the last block", phase=12)
    ms2 = [r[1] for r in runs[2]]
    ms0 = [r[1] for r in runs[0]]
    log(f"phase 12a: depth 2 {ms2[0]:.3f}, {ms2[1]:.3f} ms/block; depth 0 {ms0[0]:.3f}, "
        f"{ms0[1]:.3f} ms/block; the states of both depths equal the serial in-memory loop's "
        f"(t_ {serial.t_}, last block's accuracy {acc:.4f}) [{card}]")
    return runs[2][0][3], min(ms2), min(ms0), runs[2][-1][2]


def dataset_stream(torch, sgd, path, tmp, card):
    """12b: 12a's rows and labels as a sharded dataset (``data.write_dataset``,
    HOST_SHARDS shards of HOST_ROWS-row blocks; zlib, the default, and
    uncompressed), then ``Incremental`` over ``ShardedDataset(key=0,
    epochs=HOST_EPOCHS, readers=4)`` at depths 0 and 2; gates: equal
    states at both depths and both compressions, K4 once a block.  Returns
    {compression: depth-2 ms/block}."""
    import os

    import numpy as np

    from dask_ml_tpu_torch import Incremental, data

    X = np.fromfile(path, dtype=np.float32).reshape(-1, HOST_D)
    y = host_labels(X).astype(np.int32)
    out, states = {}, []
    for compression in ("zlib", "none"):
        where = os.path.join(tmp, f"ds_{compression}")
        t0 = time.perf_counter()
        m = data.write_dataset(where, X, y, shards=HOST_SHARDS, block_rows=HOST_ROWS,
                               compression=compression)
        log(f"phase 12b: wrote {m!r}, {compression}, in {time.perf_counter() - t0:.2f} s")
        n_blocks = HOST_EPOCHS * m.n_blocks

        def fit(clf, depth):
            ds = data.ShardedDataset(where, key=0, epochs=HOST_EPOCHS, readers=4)
            return Incremental(clf, prefetch_depth=depth).fit(ds, classes=[0, 1]).estimator_

        runs = {d: host_fit(torch, sgd, fit, d, n_blocks, f"12b ({compression})")
                for d in (0, 2)}
        states += [runs[0][0], runs[2][0]]
        for depth, (_, _, _, launches, plain) in runs.items():
            gate(launches == n_blocks and plain == 0,
                 f"12b: K4 launched {launches} times at depth {depth}, its plain version "
                 f"{plain}", phase=12)
        out[compression] = runs[2][1]
        log(f"phase 12b ({compression}): {n_blocks} blocks: depth 2 {runs[2][1]:.3f} ms/block, "
            f"depth 0 {runs[0][1]:.3f} ms/block [{card}]")
        del runs
        for name in os.listdir(where):
            os.unlink(os.path.join(where, name))
    gate(all(same_state(states[0], st) for st in states[1:]),
         "12b: the dataset fits' states differ between depths or compressions", phase=12)
    return out


def overlap_us(a, b):
    """Total time two lists of (start, end) intervals overlap."""
    total = 0.0
    for s0, e0 in a:
        for s1, e1 in b:
            total += max(0.0, min(e0, e1) - max(s0, s1))
    return total


def union_us(spans):
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def host_profile(torch, sgd, path, tmp, card):
    """12c: a depth-2 fit of HOST_PROFILE blocks of the file under
    ``torch.profiler``, after one warm block: the device's idle share, the
    host-to-device copies a block, their streams against K4's and how long
    they overlap K4, and the host thread of every runtime call (read from
    the exported trace, whose ``tid`` is the system thread id).  Gates:
    every kernel launch on the consumer thread, the staging worker's calls
    copies, events and page-locked allocations only, every device kernel
    K4's, the copies from page-locked memory."""
    import json
    import os
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dask_ml_tpu_torch import SGDClassifier, _partial, io
    from dask_ml_tpu_torch.pipeline import staging

    clf = SGDClassifier(random_state=0)
    xb = host_block(0)
    clf.partial_fit(xb, host_labels(xb), classes=[0, 1])
    workers, launchers = set(), set()
    put, update = staging.Stager.put, sgd.sgd_update

    def traced_put(self, arrays):
        workers.add(threading.get_native_id())
        return put(self, arrays)

    def traced_update(*args, **kwargs):
        launchers.add(threading.get_native_id())
        return update(*args, **kwargs)

    traced_update.launches = 0
    consumer = threading.get_native_id()
    blocks = ((xb, host_labels(xb)) for xb in io.stream_binary_blocks(
        path, HOST_ROWS, HOST_D, n_rows=(HOST_PROFILE + 1) * HOST_ROWS))
    next(blocks)  # the warm block
    torch.cuda.synchronize()
    staging.Stager.put, sgd.sgd_update = traced_put, traced_update
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _partial.fit(clf, blocks, prefetch_depth=2)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        staging.Stager.put, sgd.sgd_update = put, update
    update.launches += traced_update.launches
    trace = os.path.join(tmp, "phase12c_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    calls = {}  # system thread id -> {runtime call: count}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls.setdefault(e.get("tid"), {}).setdefault(e["name"], 0)
            calls[e.get("tid")][e["name"]] += 1

    def who(tid):
        return "consumer" if tid == consumer else "worker" if tid in workers else \
            "not the consumer"

    for tid, by_name in sorted(calls.items(), key=lambda kv: str(kv[0])):
        log(f"  host thread {tid} ({who(tid)}): " + ", ".join(
            f"{c} {k}" for c, k in sorted(by_name.items(), key=lambda kv: -kv[1])))
    launch = {tid for tid, by_name in calls.items() if any("Launch" in c for c in by_name)}
    gate(launch == {consumer}, f"12c: kernel launches on threads "
         f"{sorted((t, who(t)) for t in launch)}, the consumer is {consumer}", phase=12)
    others = {c for tid in calls if tid != consumer for c in calls[tid]}
    gate(others and all(("Memcpy" in c or "Event" in c or "Alloc" in c or "Malloc" in c or c in
                         ("cudaStreamIsCapturing", "cudaPointerGetAttributes", "cudaGetDevice",
                          "cudaSetDevice", "cudaStreamGetCaptureInfo")) for c in others),
         f"12c: threads but the consumer made runtime calls {sorted(others)}", phase=12)
    gate(launchers == {consumer}, f"12c: K4 called on threads {launchers}", phase=12)
    n = HOST_PROFILE
    copy_calls = sum(k for tid in calls if tid != consumer
                     for c, k in calls[tid].items() if "Memcpy" in c)
    launch_calls = sum(k for c, k in calls.get(consumer, {}).items() if "Launch" in c)
    gate(copy_calls == 3 * n, f"12c: {copy_calls} copy calls off the consumer for {n} blocks",
         phase=12)
    dev = [(e.time_range.start, e.time_range.end, e.name,
            getattr(e, "device_resource_id", None))
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"phase 12c: profiled depth-2 fit {wall_us / 1e3:.3f} ms; device time: not "
            f"measured (the profiler recorded no device event) [{card}]")
        return None
    h2d = [(s, e, sid) for s, e, name, sid in dev if "HtoD" in name]
    kernels = [(s, e, name, sid) for s, e, name, sid in dev if "Memcpy" not in name
               and "Memset" not in name]
    k4 = [(s, e, sid) for s, e, name, sid in kernels if kernel_name(name) == "step_kernel"]
    gate(len(k4) == len(kernels), "12c: kernels other than K4's one-launch step in the "
         f"window: {sorted({kernel_name(k[2]) for k in kernels})}", phase=12)
    gate(launch_calls == n, f"12c: {launch_calls} kernel launches for {n} blocks (K4's step "
         "is one launch a block)", phase=12)
    pinned = sum("Pinned" in name for _, _, name, _ in dev if "HtoD" in name)
    busy = union_us([(s, e) for s, e, _, _ in dev])
    h2d_us = sum(e - s for s, e, _ in h2d)
    ov = overlap_us([(s, e) for s, e, _ in h2d], [(s, e) for s, e, _ in k4])
    dropped = "" if (len(h2d), len(k4)) == (copy_calls, launch_calls) else (
        f" (the profiler recorded {len(h2d)} of {copy_calls} copies and {len(k4)} of "
        f"{launch_calls} kernels: it dropped device events, so the device times are low and "
        "the idle share high)")
    log(f"phase 12c: profiled depth-2 fit of {n} blocks: {wall_us / 1e3:.3f} ms on the host "
        f"clock ({wall_us / 1e3 / n:.3f} ms/block); device busy {busy / 1e3:.3f} ms, idle share "
        f"{(wall_us - busy) / wall_us:.4f}; HtoD copies {len(h2d)} ({pinned} from page-locked "
        f"memory), {h2d_us / 1e3 / max(len(h2d), 1) * copy_calls / n:.4f} ms a block, on "
        f"streams {sorted({str(s) for _, _, s in h2d})}; K4 kernels {len(k4)}, "
        f"{sum(e - s for s, e, _ in k4) / 1e3 / max(len(k4), 1) * launch_calls / n:.4f} ms a "
        f"block (each the mean of the recorded ones times the calls a block), on streams "
        f"{sorted({str(s) for _, _, s in k4})}; copies overlapping K4 for {ov / 1e3:.4f} ms"
        f"{dropped} [{card}]")
    gate(h2d and pinned == len(h2d),
         f"12c: {pinned} of {len(h2d)} recorded HtoD copies from page-locked memory", phase=12)
    return {"idle": (wall_us - busy) / wall_us, "dropped": bool(dropped)}


def stage_parts(torch, xb, device):
    """12d: the worker's stage of one block in parts (host clock, medians of
    HOST_READS, the device synced between): the labels ``xb[:, 0] > 0.5``,
    the ±1 encode, the bucket pad, the stager's put (with the copy into
    page-locked memory, and from a source buffer) and the whole
    ``_pf_stage``."""
    import numpy as np

    from dask_ml_tpu_torch import SGDClassifier
    from dask_ml_tpu_torch.pipeline import staging
    from dask_ml_tpu_torch.programs import pad_block

    clf = SGDClassifier(random_state=0)
    clf._set_classes([0, 1])
    stager = staging.Stager(device, 4)
    with staging.reading_for(stager):
        src = staging.host_empty(xb.shape, np.float32)
    src[...] = xb
    times = {k: [] for k in ("labels", "encode", "pad", "put", "put_source", "pf_stage")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times[name].append(1e3 * (time.perf_counter() - t0))
        return out

    for _ in range(HOST_READS):
        labels = timed("labels", lambda: host_labels(xb))
        targets = timed("encode", lambda: clf._encode_targets(labels))
        _, _, mask = timed("pad", lambda: pad_block(xb, targets))
        timed("put", lambda: stager.put((xb, targets, mask)))
        timed("put_source", lambda: stager.put((src, targets, mask)))
        timed("pf_stage", lambda: clf._pf_stage(xb, labels, stager=stager))
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in times.items()}


def host_yardstick(torch, sgd, path, device, card):
    """12d: the stage's parts alone: a page-locked and a pageable 64 MiB
    host-to-device copy (CUDA events, 20 copies); ``read_binary`` of a block
    from the page cache into a fresh array, and into a buffer a stream lends
    (reused pageable, and page-locked); the copy of a block into page-locked
    memory (host clock, medians of HOST_READS); and K4 at (HOST_ROWS,
    HOST_D), K=1 (10c's entry at this shape: held, timed, its bound).
    Returns (the kernels entry, the floor max(parse, H2D, K4) in ms, with
    the parse a read into page-locked memory as the depth-2 worker reads,
    and the parts)."""
    import numpy as np

    from dask_ml_tpu_torch import io
    from dask_ml_tpu_torch.pipeline import staging

    n = HOST_ROWS * HOST_D
    pinned = torch.empty(n, pin_memory=True)
    pageable = torch.empty(n)
    dst = torch.empty(n, device=device)
    h2d = time_ms(torch, lambda: dst.copy_(pinned, non_blocking=True), 20)
    h2d_pageable = time_ms(torch, lambda: dst.copy_(pageable), 20)
    shape = (HOST_ROWS, HOST_D)
    lenders = {"reused": staging.Stager("cpu", 2), "pinned": staging.Stager(device, 2)}
    times = {"fresh": [], "reused": [], "pinned": [], "copy": [], "np_copy": []}
    for i in range(HOST_READS):
        off = 4 * n * (i + 3)
        t0 = time.perf_counter()
        xb = io.read_binary(path, shape, offset_bytes=off)
        times["fresh"].append(1e3 * (time.perf_counter() - t0))
        for name, lender in lenders.items():  # the buffers a stream lends its reads
            with staging.reading_for(lender):
                t0 = time.perf_counter()
                io.read_binary(path, shape, offset_bytes=off)
                times[name].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        pinned.view(shape).copy_(torch.from_numpy(xb))
        times["copy"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        pinned.view(shape).numpy()[...] = xb
        times["np_copy"].append(1e3 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in times.items()}
    med.update(stage_parts(torch, xb, device))
    parse = med["pinned"]  # the depth-2 worker reads into the stream's page-locked buffers
    case = sgd_inputs(torch, HOST_ROWS, HOST_D, 1, "log_loss", 12, device)
    entry = sgd_table_entry(torch, sgd, case, sgd_hyper(torch, device), "sgd_update_host_block",
                            "update", card, one_launch=True)
    floor = max(parse, h2d, entry["ms"])
    log(f"phase 12d: a {4 * n / 2**20:.0f} MiB block: host-to-device {h2d:.4f} ms from "
        f"page-locked memory ({4 * n / h2d / 1e6:.1f} GB/s), {h2d_pageable:.4f} ms pageable; "
        f"read_binary from the page cache into a fresh array {med['fresh']:.3f} ms "
        f"({4 * n / med['fresh'] / 1e6:.1f} GB/s), into a reused one {med['reused']:.3f} ms, "
        f"into a page-locked buffer {med['pinned']:.3f} ms; the copy into page-locked memory "
        f"{med['copy']:.3f} ms (PyTorch, {torch.get_num_threads()} threads), {med['np_copy']:.3f} "
        f"ms (numpy); the worker's stage of a block: labels {med['labels']:.3f}, encode "
        f"{med['encode']:.3f}, pad {med['pad']:.3f}, put {med['put']:.3f} (from a source buffer "
        f"{med['put_source']:.3f}), all of _pf_stage {med['pf_stage']:.3f} ms; K4 "
        f"{entry['ms']:.4f} ms; the stream's floor max(parse into page-locked memory, H2D, "
        f"K4) {floor:.3f} ms/block; the worker's chain (parse, labels, _pf_stage from a source "
        f"buffer) {parse + med['labels'] + med['pf_stage'] - med['put'] + med['put_source']:.3f} "
        f"ms [{card}]")
    return entry, floor, dict(med, parse=parse, h2d=h2d)


def ipca_host_stream(torch, path, card):
    """12e: ``IncrementalPCA(10, batch_size=HOST_ROWS)`` over an
    IPCA_HOST_ROWS x HOST_D host array (the file's first rows) with the
    prefetch knob at 0 and at 2; gate: equal ``components_``."""
    import os

    import numpy as np

    from dask_ml_tpu_torch import IncrementalPCA
    from dask_ml_tpu_torch.pipeline import DEPTH_ENV, pipeline_report

    X = np.fromfile(path, dtype=np.float32, count=IPCA_HOST_ROWS * HOST_D).reshape(-1, HOST_D)
    fits, old = {}, os.environ.get(DEPTH_ENV)
    try:
        for depth in ("0", "2", "2", "0"):
            os.environ[DEPTH_ENV] = depth
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = IncrementalPCA(n_components=10, batch_size=HOST_ROWS).fit(X)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            rep = pipeline_report()
            fits.setdefault(depth, []).append((est, ms))
            log(f"phase 12e: IncrementalPCA(10, batch_size={HOST_ROWS}) over "
                f"{IPCA_HOST_ROWS}x{HOST_D} at depth {depth}: {ms:.1f} ms ({rep['blocks']} "
                f"batches; a batch: parse {1e3 * rep['parse_s'] / rep['blocks']:.3f}, transfer "
                f"{1e3 * rep['transfer_s'] / rep['blocks']:.3f}, stall "
                f"{1e3 * rep['stall_s'] / rep['blocks']:.3f} ms; host buffers "
                f"{rep['host_buffers']}, {rep['pinned_buffers']} page-locked) [{card}]")
    finally:
        if old is None:
            os.environ.pop(DEPTH_ENV, None)
        else:
            os.environ[DEPTH_ENV] = old
    ref = fits["0"][0][0]
    for depth, runs in fits.items():
        for est, _ in runs:
            gate(bool(torch.equal(est.components_, ref.components_))
                 and bool(torch.equal(est.singular_values_, ref.singular_values_)),
                 f"12e: the depth-{depth} components_ differ from depth 0's", phase=12)
    return min(ms for _, ms in fits["2"]), min(ms for _, ms in fits["0"])


def host_stream_phase(torch, device, card):
    """Phase 12 end to end; returns K4's entry at this phase's block."""
    import tempfile

    from dask_ml_tpu_torch.ops import sgd

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = host_files(tmp)
        launches, ms2, ms0, rep = binary_stream(torch, sgd, path, card)
        ds_ms = dataset_stream(torch, sgd, path, tmp, card)
        profiled = host_profile(torch, sgd, path, tmp, card)
        entry, floor, parts = host_yardstick(torch, sgd, path, device, card)
        ipca2, ipca0 = ipca_host_stream(torch, path, card)
    log(f"phase 12: binary stream {ms2:.3f} ms/block at depth 2 ({ms0:.3f} at depth 0), "
        f"dataset stream {ds_ms['zlib']:.3f} ms/block at depth 2 ({ds_ms['none']:.3f} "
        f"uncompressed), against the floor {floor:.3f} "
        f"ms/block (parse {parts['parse']:.3f}, H2D {parts['h2d']:.4f}, K4 {entry['ms']:.4f}); "
        f"idle share "
        f"{'not measured' if profiled is None else format(profiled['idle'], '.4f')}"
        f"{' (an upper bound: the profiler dropped events)' if profiled and profiled['dropped'] else ''}; "
        f"IncrementalPCA {ipca2:.1f} ms at depth 2, {ipca0:.1f} ms at depth 0 [{card}]")
    return [dict(entry, launches=launches)]


# ----------------------------------------------------------------- phase 13
OVR_SWEEP_WRAPPERS = ("logistic_ovr_value_and_grad", "logistic_ovr_value",
                      "normal_ovr_value_and_grad", "normal_ovr_value")


def reset_grid_counts(multiclass, logistic, algorithms):
    for name in OVR_SWEEP_WRAPPERS:
        getattr(multiclass, name).launches = 0
    multiclass.logistic_ovr_value_and_grad_ref.calls = 0
    multiclass.normal_ovr_value_and_grad_ref.calls = 0
    reset_glm_counts(logistic, algorithms)


def grid_search(make, Xs, ys, grid, cv):
    """A GridSearchCV fit on sharded input (its unshuffled-KFold notice
    silenced: the rows are in random order)."""
    import warnings

    from dask_ml_tpu_torch.model_selection import GridSearchCV

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return GridSearchCV(make(), grid, cv=cv).fit(Xs, ys)


@contextlib.contextmanager
def launches_by_path(multiclass):
    """Counts K2-OvR's and K2-MN's launches by (mode, plan path) while open:
    each launch takes its plan from ``multiclass._plan`` once."""
    from collections import Counter

    counts, plan = Counter(), multiclass._plan

    def counted(lib, device, mode, *args, **kw):
        words = plan(lib, device, mode, *args, **kw)
        counts[PLAN_PATHS.get((mode, int(words[0])), (mode, int(words[0])))] += 1
        return words

    multiclass._plan = counted
    try:
        yield counts
    finally:
        multiclass._plan = plan


def timed_search(torch, multiclass, logistic, algorithms, label, make, Xs, ys, grid, strategy,
                 card):
    """One search under ``DASK_ML_TPU_TORCH_GRID_PACK=strategy``, every launch
    and host sync counted (K2-OvR's also by plan path), its wall time on the
    host clock after a sync, split into the folds and the refit (the refit
    timed again alone: the same fit of the winner on all rows).  Returns
    (search, launches, wall s, K2-OvR and K2-MN launches by plan path)."""
    from dask_ml_tpu_torch.base import clone
    from dask_ml_tpu_torch.entry import _env
    from dask_ml_tpu_torch.model_selection import _search

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_grid_counts(multiclass, logistic, algorithms)
    _search.reset_sweep_stats()
    with _env("DASK_ML_TPU_TORCH_GRID_PACK", strategy), launches_by_path(multiclass) as by_path:
        t0 = time.perf_counter()
        gs = grid_search(make, Xs, ys, grid, 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: getattr(multiclass, name).launches for name in OVR_SWEEP_WRAPPERS}
    launches.update({name: getattr(logistic, name).launches for name in GLM_WRAPPERS})
    plain = (multiclass.logistic_ovr_value_and_grad_ref.calls
             + multiclass.normal_ovr_value_and_grad_ref.calls
             + logistic.logistic_value_and_grad_ref.calls + logistic.glm_value_and_grad_ref.calls)
    solves, syncs = algorithms.DISPATCH_COUNTS["solves"], algorithms.HOST_SYNCS["syncs"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = {"packed_folds": _search.SWEEP_STATS["packed_folds"],
             "ineligible": dict(_search.SWEEP_STATS["ineligible"])}
    t0 = time.perf_counter()
    clone(make()).set_params(**gs.best_params_).fit(Xs, ys)
    torch.cuda.synchronize()
    refit = time.perf_counter() - t0
    log(f"{label} [{strategy}]: {wall:.3f} s on the host clock (folds ~{wall - refit:.3f} s, "
        f"refit {refit:.3f} s timed alone), solves {solves}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, plain-version calls {plain}, host syncs "
        f"{syncs}, peak memory {peak:.2f} GiB, SWEEP_STATS {stats}; K2-OvR and K2-MN launches by "
        f"plan path {dict(by_path)}; best_params_ {gs.best_params_}, best_score_ "
        f"{gs.best_score_:.7f} [{card}]")
    log(f"  mean_test_score {[round(s, 7) for s in gs.cv_results_['mean_test_score']]}")
    if plain:
        raise AssertionError(f"{label} [{strategy}] called a plain version {plain} times")
    if strategy == "packed" and (stats["packed_folds"] != 3 or stats["ineligible"]):
        raise AssertionError(f"{label}: the packed search's folds ran {stats}")
    return gs, launches, wall, by_path


def hold_close(label, a, b, tol):
    import numpy as np

    gap = float(np.max(np.abs(np.subtract(a, b))))
    log(f"  {label}: largest |Δ mean_test_score| {gap:.3e} (<= {tol})")
    if not gap <= tol:
        raise AssertionError(f"{label}: mean_test_score differs by {gap} > {tol}")


def grid_main_path(torch, multiclass, logistic, algorithms, device, card):
    """13a and 13b: the packed C-grid over LogisticRegression(admm) on the
    HIGGS stand-in, then the same grid fit a candidate at a time."""
    import numpy as np

    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y, w = higgs_standin(torch, HIGGS_ROWS, HIGGS_D, 0, device)
    sX, sy = shard_rows(X), shard_rows(y)
    acc_true = float(((X @ w > 0).float() == y).float().mean())

    def make():
        return LogisticRegression(max_iter=ADMM_ROUNDS, solver_kwargs={"inner_iter": ADMM_INNER})

    grid = {"C": np.logspace(-3, 4, 8)}
    label = (f"phase 13a: GridSearchCV(LogisticRegression(admm), 8 values of C, cv=3) "
             f"{HIGGS_ROWS}x{HIGGS_D}")
    gs, launches, wall_p, by_path = timed_search(torch, multiclass, logistic, algorithms, label,
                                                 make, sX, sy, grid, "auto", card)
    coef = gs.best_estimator_.coef_
    cos = float(coef @ w / (coef.norm() * w.norm()))
    log(f"  best_score_ {gs.best_score_:.7f} (>= 0.98 of the true w's held-out accuracy "
        f"{acc_true:.7f}); best coef's cosine to w {cos:.7f} (>= 0.99)")
    if not gs.best_score_ >= 0.98 * acc_true:
        raise AssertionError(f"13a best_score_ {gs.best_score_} < 0.98 * {acc_true}")
    if not cos >= 0.99:
        raise AssertionError(f"13a best coef's cosine to w {cos} < 0.99")
    for name in ("logistic_ovr_value_and_grad", "logistic_ovr_value"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the packed search")
    if by_path[PLAN_PATHS[(0, 3)]] < 1:
        raise AssertionError(f"13a launched no K2-OvR on the shared-target path: {dict(by_path)}")
    profiled_admm_fit(torch, algorithms, sX, sy, card,
                      make=lambda: _Search(make, grid),
                      label="phase 13a: profiled packed grid search")
    label_b = "phase 13b: the same grid, a fit a candidate and fold"
    gs_s, _, wall_s, _ = timed_search(torch, multiclass, logistic, algorithms, label_b, make,
                                      sX, sy, grid, "sequential", card)
    log(f"  sequential {wall_s:.3f} s / packed {wall_p:.3f} s = {wall_s / wall_p:.3f}x [{card}]")
    hold_close("13b against 13a", gs_s.cv_results_["mean_test_score"],
               gs.cv_results_["mean_test_score"], 1e-4)
    return sX, sy, len(grid["C"]), launches


class _Search:
    """The packed grid search as ``profiled_admm_fit``'s estimator."""

    def __init__(self, make, grid):
        self.make, self.grid = make, grid

    def fit(self, X, y):
        return grid_search(self.make, X, y, self.grid, 3)


def grid_regression(torch, multiclass, logistic, algorithms, device, card):
    """13c: the packed C-grid over LinearRegression on the Normal stand-in,
    then the same grid a candidate at a time; R² within 1e-5."""
    import numpy as np

    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.linear_model import LinearRegression

    X, y, _ = glm_standin(torch, "normal", HIGGS_ROWS, HIGGS_D, 5, device)
    sX, sy = shard_rows(X), shard_rows(y)
    grid = {"C": np.logspace(0, 6, 5)}
    label = (f"phase 13c: GridSearchCV(LinearRegression(admm), 5 values of C, cv=3) "
             f"{HIGGS_ROWS}x{HIGGS_D}")
    gs, launches, wall_p, _ = timed_search(torch, multiclass, logistic, algorithms, label,
                                           LinearRegression, sX, sy, grid, "auto", card)
    for name in ("normal_ovr_value_and_grad", "normal_ovr_value"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the packed regression search")
    gs_s, _, wall_s, _ = timed_search(torch, multiclass, logistic, algorithms, label,
                                      LinearRegression, sX, sy, grid, "sequential", card)
    log(f"  sequential {wall_s:.3f} s / packed {wall_p:.3f} s = {wall_s / wall_p:.3f}x [{card}]")
    hold_close("13c sequential against packed", gs_s.cv_results_["mean_test_score"],
               gs.cv_results_["mean_test_score"], 1e-5)
    return sX, sy, len(grid["C"]), launches


def ovr_family_magnitudes(torch, family, x, Y, mask, beta):
    """Σ|terms| of f and of each g element of K2-OvR's ``family`` in
    float64, shard by shard (lanes k·P + p)."""
    P, m, d = x.shape
    K = Y.shape[0]
    f_mag, g_mag = [], []
    for p in range(P):
        xp, mp = x[p].double(), mask[p].double()
        eta = xp @ beta.view(K, P, d)[:, p].double().T  # (m, K)
        yp = Y[:, p].double().T
        if family == "logistic":
            sp = torch.logaddexp(torch.zeros_like(eta), eta)
            f_mag.append((mp[:, None] * (sp.abs() + (yp * eta).abs())).sum(0))
            w = (mp[:, None] * (torch.sigmoid(eta) - yp)).abs()
        else:
            f_mag.append((mp[:, None] * 0.5 * (yp - eta) ** 2).sum(0))
            w = (mp[:, None] * (eta - yp)).abs()
        g_mag.append(w.T @ xp.abs())
        del xp, eta, yp, w
    return torch.stack(f_mag, 1).reshape(-1), torch.stack(g_mag, 1).reshape(-1, d)


def hold_ovr_family(torch, multiclass, family, x, Y, mask, beta, what):
    """Both variants of K2-OvR's ``family`` on ``Y`` (shared or not)
    against the float64 plain version, within TOL of Σ|terms|; the same f
    from both; the same bits twice.  Returns the largest absolute
    differences (value-and-grad, value) and the outputs."""
    vg = getattr(multiclass, f"{family}_ovr_value_and_grad")
    v = getattr(multiclass, f"{family}_ovr_value")
    ref = getattr(multiclass, f"{family}_ovr_value_and_grad_ref")
    f, g = vg(x, Y, mask, beta)
    fv = v(x, Y, mask, beta)
    again = vg(x, Y, mask, beta)
    torch.cuda.synchronize()
    if not (torch.equal(f, again[0]) and torch.equal(g, again[1])):
        raise AssertionError(f"{family} OvR is not deterministic at {what}")
    if not torch.equal(f, fv):
        raise AssertionError(f"the two {family} OvR variants give different f at {what}")
    rf, rg = ref(x.double(), Y.double(), mask.double(), beta.double())
    f_mag, g_mag = ovr_family_magnitudes(torch, family, x, Y, mask, beta)
    df, dg = (f.double() - rf).abs(), (g.double() - rg).abs()
    del rf, rg
    worst_f, worst_g = float((df / (f_mag + 1e-30)).max()), float((dg / (g_mag + 1e-30)).max())
    if not (bool((df <= TOL * f_mag + 1e-6).all()) and bool((dg <= TOL * g_mag + 1e-6).all())):
        raise AssertionError(f"{family} OvR differs from its plain version at {what} "
                             f"(f {worst_f:.3g}, g {worst_g:.3g} of Σ|terms|)")
    log(f"  {family} OvR {what}: f within {worst_f:.2e}, g within {worst_g:.2e} of Σ|terms|; "
        "deterministic")
    return float(torch.cat([df, dg.reshape(-1)]).max()), float(df.max()), (f, g), (f_mag, g_mag)


def sweep_kernel_table(torch, multiclass, cases, launches, card):
    """13d: K2-OvR at the shapes the sweeps give it: for each (family,
    sharded X, sharded y, L) of ``cases``, x (8, m, 29) of that search's
    first train fold, its y as the one shared target and B (L·8, 29), with
    L the search's number of values of C (13a's 8 for the logistic
    family, 13c's 5 for the Normal one).  Each variant is held against its
    plain version and against the same kernel on a materialized (L, 8, m)
    copy of the target, then timed (CUDA events, 20 launches) on the
    shared target and on the copy, beside the plain version (3 runs), the
    bound by bytes (x, one y, the mask) and the ``torch.bmm`` pair
    (informational)."""
    import numpy as np

    from dask_ml_tpu_torch.linear_model.utils import add_intercept
    from dask_ml_tpu_torch.model_selection._split import _take, check_cv

    replaces = {"logistic": "dask_ml_tpu/solvers/families.py:34",
                "normal": "dask_ml_tpu/solvers/families.py:53"}
    out = []
    for family, sX, sy, L in cases:
        train, _ = next(check_cv(3).split(np.empty((sX.n_samples, 0))))
        Xi = add_intercept(_take(sX, train))
        P = HIGGS_SHARDS
        n, d = Xi.data.shape
        m = n // P
        dev = Xi.data.device
        x3, m2 = Xi.data.view(P, m, d), Xi.mask.view(P, m)
        shared = _take(sy, train).data.view(P, m).expand(L, P, m)
        copy = shared.contiguous()
        gen = torch.Generator(device=dev).manual_seed(13)
        B = torch.randn(L * P, d, generator=gen, device=dev) / d ** 0.5
        what = f"({P}, {m}, {d}) L={L}"
        log(f"phase 13d: K2-OvR {family} at its sweep's shape {what}, one shared target [{card}]")
        wv = torch.rand(P, m, L, generator=gen, device=dev)
        bmm_ms = time_ms(torch, lambda: (torch.bmm(x3, B.view(L, P, d).permute(1, 2, 0)),
                                         torch.bmm(x3.transpose(1, 2), wv)), 20)
        del wv
        e_vg, e_v, (f, g), (f_mag, g_mag) = hold_ovr_family(
            torch, multiclass, family, x3, shared, m2, B, what + " shared")
        fc, gc = getattr(multiclass, f"{family}_ovr_value_and_grad")(x3, copy, m2, B)
        gap_f = float(((f - fc).abs().double() / (f_mag + 1e-30)).max())
        gap_g = float(((g - gc).abs().double() / (g_mag + 1e-30)).max())
        log(f"  {family} OvR shared against the materialized copy: f within {gap_f:.2e}, "
            f"g within {gap_g:.2e} of Σ|terms| (<= {TOL}); bitwise equal "
            f"{torch.equal(f, fc) and torch.equal(g, gc)}")
        if not (gap_f <= TOL and gap_g <= TOL):
            raise AssertionError(f"{family} OvR on a shared target differs from the copy")
        del fc, gc, f_mag, g_mag
        for grad, err in ((True, e_vg), (False, e_v)):
            name = f"{family}_ovr_value_and_grad" if grad else f"{family}_ovr_value"
            fn = getattr(multiclass, name)
            ref = getattr(multiclass, f"{family}_ovr_value_and_grad_ref")
            ms = time_ms(torch, lambda: fn(x3, shared, m2, B), 20)
            ms_copy = time_ms(torch, lambda: fn(x3, copy, m2, B), 20)
            plain_ms = time_ms(torch, lambda: ref(x3, shared, m2, B, None, grad), 3)
            nbytes = n * d * 4 + 2 * n * 4 + B.numel() * 4 * (2 if grad else 1) + L * P * 4
            flops = (4 if grad else 2) * n * d * L
            b_ms, b_by = bound_ms(nbytes, flops)
            plan = list(multiclass._plan(multiclass._load(), dev, 0, P, m, d, L,
                                         multiclass._FAMILIES[family], True))
            plan_copy = list(multiclass._plan(multiclass._load(), dev, 0, P, m, d, L,
                                              multiclass._FAMILIES[family], False))
            log(f"{name} (shared target) at {what}: {ms:.4f} ms, {b_ms / ms:.1%} of the bound "
                f"(on a materialized target {ms_copy:.4f} ms; plain "
                f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.4f} GB, "
                f"{flops / 1e9:.3f} GFLOP; plan path {plan[0]} "
                f"({PLAN_PATHS.get((0, plan[0]))}), plan {plan}; on the copy path "
                f"{plan_copy[0]} ({PLAN_PATHS.get((0, plan_copy[0]))}), plan {plan_copy}; "
                f"informational: torch.bmm pair {bmm_ms:.4f} ms) [{card}]")
            out.append({"name": f"{name}_shared", "route": "cuda",
                        "source": "dask_ml_tpu_torch/csrc/multiclass.cu",
                        "replaces": replaces[family], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
        del Xi, x3, m2, shared, copy, f, g, B
    torch.cuda.synchronize()
    return out


def sweep_lane_gaps(label, lams, betas_sweep, betas_seq, held, tol, card):
    """Print ‖Δβ_k‖∞ / ‖β_k‖∞ lane by lane between the sweep and the
    sequential solves, and fail where a lane of ``held`` exceeds ``tol``."""
    gap = (betas_sweep - betas_seq).abs().amax(1)
    scale = betas_seq.abs().amax(1)
    rel = (gap / scale).tolist()
    log(f"  {label}: ‖Δβ_k‖∞ / ‖β_k‖∞ by λ "
        f"{[(f'{lam:.3g}', f'{r:.3e}') for lam, r in zip(lams.tolist(), rel)]}, ‖β_k‖∞ "
        f"{[round(b, 4) for b in scale.tolist()]} (held <= {tol} where λ >= {held}) [{card}]")
    bad = [(float(lam), r) for lam, r in zip(lams, rel) if lam >= held and not r <= tol]
    if bad:
        raise AssertionError(f"{label}: the sweep's lanes {bad} differ from the sequential "
                             f"solves by more than {tol}·‖β_k‖∞")


def sweep_yardstick(torch, algorithms, device, card):
    """13d: ``lambda_sweep("lbfgs")`` against 8 sequential ``lbfgs`` solves at
    bench.py's ``grid_sweep_lbfgs_1000000x28_K8`` (X (1M, 28) standard
    normal, y = [X·w > 0], λ = logspace(-4, 1, 8), 20 iterations, tol 0),
    in turns (sweep, sequential, sequential, sweep) after one warm call of
    each, each on the host clock after a sync; every lane must run its 20
    iterations to finite coefficients.  The two arms' β are compared lane
    by lane.  The targets are separable, so β grows with the iterations
    and two float32 summation orders (K2-OvR's and K2's) may part within
    20 fixed iterations: only the lanes with λ >= 0.1 are held there, to
    1e-3·‖β_k‖∞.  The same X with noisy labels (y = [X·w + ‖w‖·ε > 0], ε
    standard normal), whose β stays bounded, is the witness: every lane
    held to 1e-3·‖β_k‖∞.  That is the float32 floor of a line search on
    these lanes: f ≈ 5e5 is resolved to ~0.03, the Hessian is ≈ 0.2·n·I,
    so β is pinned only to √(2·0.03 / 2e5) ≈ 5.5e-4, or 6.6e-4·‖β‖∞ (≈ 0.83)."""
    import numpy as np

    from dask_ml_tpu_torch.core import shard_rows

    gen = torch.Generator(device=device).manual_seed(5)
    X = torch.randn(AB_ROWS, HIGGS_D, generator=gen, device=device)
    w = torch.randn(HIGGS_D, generator=gen, device=device)
    sX, y = shard_rows(X), (X @ w > 0).float()
    lams = np.logspace(-4, 1, 8).astype(np.float32)

    def sweep(y=y):
        B, its = algorithms.lambda_sweep("lbfgs", sX, y, lams, max_iter=AB_ITERS, tol=0.0)
        return B, its.cpu().numpy()

    def sequential(y=y):
        outs = [algorithms.lbfgs(sX, y, lamduh=float(lam), max_iter=AB_ITERS, tol=0.0,
                                 line_search="backtrack", return_n_iter=True) for lam in lams]
        return torch.stack([b for b, _ in outs]), np.asarray([k for _, k in outs])

    times = {"sweep": [], "sequential": []}
    results = {"sweep": sweep(), "sequential": sequential()}  # warm: plans, allocator
    for arm in ("sweep", "sequential", "sequential", "sweep"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[arm] = (sweep if arm == "sweep" else sequential)()
        torch.cuda.synchronize()
        times[arm].append(time.perf_counter() - t0)
    its_sw, its_sq = results["sweep"][1], results["sequential"][1]
    log(f"phase 13d: grid_sweep_lbfgs_{AB_ROWS}x{HIGGS_D}_K8: sweep "
        f"{[round(t, 4) for t in times['sweep']]} s, 8 sequential lbfgs "
        f"{[round(t, 4) for t in times['sequential']]} s, ratio "
        f"{min(times['sequential']) / min(times['sweep']):.3f}x; iterations {its_sw.tolist()} / "
        f"{its_sq.tolist()} [{card}]")
    if not (np.all(its_sw == AB_ITERS) and np.all(its_sq == AB_ITERS)):
        raise AssertionError("a lane of the fixed-work sweep A/B stopped early")
    if not (bool(torch.isfinite(results["sweep"][0]).all())
            and bool(torch.isfinite(results["sequential"][0]).all())):
        raise AssertionError("the fixed-work sweep A/B gave non-finite coefficients")
    sweep_lane_gaps("separable y", lams, results["sweep"][0], results["sequential"][0], 0.1,
                    1e-3, card)
    noisy = (X @ w + w.norm() * torch.randn(AB_ROWS, generator=gen, device=device) > 0).float()
    (b_sw, it_sw), (b_sq, it_sq) = sweep(noisy), sequential(noisy)
    log(f"  noisy y: iterations {it_sw.tolist()} / {it_sq.tolist()}")
    if not np.array_equal(it_sw, it_sq):
        raise AssertionError("the noisy-label sweep's lanes ran other iterations than the "
                             "sequential solves")
    sweep_lane_gaps("noisy y", lams, b_sw, b_sq, 0.0, 1e-3, card)


def prefix_cache_search(torch, device, card):
    """13e: a Pipeline(PCA, LogisticRegression) grid on the first 2^22 rows
    of the HIGGS stand-in: each PCA is fitted once a (n_components, fold),
    2·3 times, not once a candidate and fold (6·3)."""
    from collections import Counter

    from dask_ml_tpu_torch.compose import make_pipeline
    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y, _ = higgs_standin(torch, PREFIX_ROWS, HIGGS_D, 0, device)
    sX, sy = shard_rows(X), shard_rows(y)
    grid = {"pca__n_components": [8, 16], "logisticregression__C": [0.1, 1.0, 10.0]}
    fits = []
    fit_transform = PCA.fit_transform

    def counted(self, X, y=None):
        fits.append(self.n_components)
        return fit_transform(self, X, y)

    PCA.fit_transform = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = grid_search(lambda: make_pipeline(PCA(), LogisticRegression()), sX, sy, grid, 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PCA.fit_transform = fit_transform
    log(f"phase 13e: GridSearchCV(make_pipeline(PCA(), LogisticRegression()), 6 candidates, "
        f"cv=3) {PREFIX_ROWS}x{HIGGS_D}: {wall:.3f} s on the host clock, PCA fits "
        f"{len(fits)} (n_components {sorted(Counter(fits).items())}; 2·3 with the prefix cache, "
        f"6·3 without), best_params_ {gs.best_params_}, best_score_ {gs.best_score_:.6f} "
        f"[{card}]")
    # the folds' prefixes, then the refit's PCA
    if len(fits) != 2 * 3 + 1:
        raise AssertionError(f"13e fitted PCA {len(fits)} times, not 2·3 + the refit's 1")
    if not gs.best_score_ >= 0.7:
        raise AssertionError(f"13e best_score_ {gs.best_score_} < 0.7")


def grid_phase(torch, multiclass, logistic, algorithms, device, card):
    """Phase 13 end to end; returns its lines of the kernels table."""
    from dask_ml_tpu_torch.core import use_device

    with use_device(device, n_shards=HIGGS_SHARDS):
        sX, sy, L, launches = grid_main_path(torch, multiclass, logistic, algorithms, device,
                                             card)
        sX_c, sy_c, L_c, launches_c = grid_regression(torch, multiclass, logistic, algorithms,
                                                      device, card)
        launches.update({k: v for k, v in launches_c.items() if k.startswith("normal_ovr")})
        out = sweep_kernel_table(torch, multiclass, [("logistic", sX, sy, L),
                                                     ("normal", sX_c, sy_c, L_c)],
                                 launches, card)
        del sX, sy, sX_c, sy_c
        torch.cuda.synchronize()
        sweep_yardstick(torch, algorithms, device, card)
        prefix_cache_search(torch, device, card)
    return out


MBK_K = 8
MBK_ITER = 3
MBK_BATCH = 1024  # MiniBatchKMeans' default batch_size
MBK_EPOCH_REPS = 3  # K7b launches timed at the full epoch (each ~97,656 steps)
STREAM_ROWS = 1 << 20
STREAM_BLOCKS = 16
STREAM_PLAIN = 8  # 14b's blocks also stepped through the plain versions
EPOCH_CHECK_STEPS = 1024  # 14c: K7b over one epoch of the first 2^20 rows
EPOCH_CHECK_START = 12345
PAIR_ROWS = 1 << 20
PAIR_M = 1024
RING_ROWS = 32768
RING_SHARDS = 8
ARGMIN_M = 512
SPECTRAL_ROWS = 10_000_000
SPECTRAL_M = 100
SPECTRAL_PHASES = ("affinities", "m x m solves", "embedding", "KMeans")  # its _timer names
NEAR_DUP_ROWS = 1 << 16
K10_REPS = 20


def reset_minibatch_counts():
    """Every launch count of phase 14's kernels, and the reseed count, to 0."""
    from dask_ml_tpu_torch.cluster import minibatch_kmeans
    from dask_ml_tpu_torch.ops import lloyd, minibatch, pairwise

    for fn in (minibatch.mbk_step, minibatch.mbk_epoch, pairwise.sq_euclidean_safe,
               lloyd.lloyd_assign, lloyd.lloyd_assign_reduce):
        fn.launches = 0
    minibatch.mbk_epoch.stepped = 0
    minibatch_kmeans._reassign_starved.calls = 0


def minibatch_counts():
    from dask_ml_tpu_torch.cluster import minibatch_kmeans
    from dask_ml_tpu_torch.ops import lloyd, minibatch, pairwise

    return {"mbk_epoch": minibatch.mbk_epoch.launches,
            "mbk_epoch_stepped": minibatch.mbk_epoch.stepped,
            "mbk_step": minibatch.mbk_step.launches,
            "lloyd_assign_reduce": lloyd.lloyd_assign_reduce.launches,
            "lloyd_assign": lloyd.lloyd_assign.launches,
            "sq_euclidean_safe": pairwise.sq_euclidean_safe.launches,
            "reassign": minibatch_kmeans._reassign_starved.calls}


PROFILE_PADS = 512  # spin kernels that open a device_profile window


def device_profile(torch, fn):
    """``fn()`` under ``torch.profiler``: (host-clock ms after a sync, {kernel
    name: (device ms, count)}).  After profiles of tens of thousands of
    launches earlier in the process, a profiler window loses the first device
    events it sees, more after each such profile; so the window opens with
    PROFILE_PADS short spin kernels and a sync, and leaves them out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            ms, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return wall_ms, per_name


def log_profile(label, wall_ms, per_name, card, top=8):
    log(f"{label}: {wall_ms:.3f} ms on the host clock [{card}]")
    if not per_name:
        log("  device time by kernel: not measured (the profiler recorded no device event)")
        return
    busy = sum(ms for ms, _ in per_name.values())
    for name, (ms, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  device {ms:12.3f} ms {count:7d}x  {kernel_name(name)}")
    log(f"  device busy {busy:.3f} ms of {wall_ms:.3f} ms: idle share "
        f"{(wall_ms - busy) / wall_ms:.4f}")


def mbk_main_path(torch, X, truth, card):
    """14a: ``MiniBatchKMeans(n_clusters=8, random_state=0, max_iter=3)`` on
    the blobs at the default batch_size, every count set to 0 just before
    the fit and read just after; gates as phase 4's.  Then one epoch as the
    fit runs it (the reseed check, K7b, the scalar read) under
    ``torch.profiler``.  Returns (the estimator, the counts)."""
    from dask_ml_tpu_torch.cluster import MiniBatchKMeans, minibatch_kmeans

    n, d = X.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_minibatch_counts()
    t0 = time.perf_counter()
    est = MiniBatchKMeans(n_clusters=MBK_K, random_state=0, max_iter=MBK_ITER).fit(X)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = minibatch_counts()
    steps = n // MBK_BATCH
    log(f"phase 14a: MiniBatchKMeans({MBK_K}, max_iter={MBK_ITER}) fit on {n}x{d} in "
        f"{t_fit:.3f} s (host clock after a sync; {1e3 * t_fit / est.n_iter_:.3f} ms an epoch, "
        f"{1e6 * t_fit / est.n_steps_:.3f} us a step with the init and the final labels); "
        f"n_iter_ {est.n_iter_}, n_steps_ {est.n_steps_}, inertia_/n {est.inertia_ / n:.4f}; "
        f"K7b launches {counts['mbk_epoch']} (stepped epochs {counts['mbk_epoch_stepped']}), "
        f"K1b {counts['lloyd_assign']}, reseeds {counts['reassign']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    gate(est.n_steps_ == est.n_iter_ * steps, f"14a: {est.n_steps_} steps", phase=14)
    gate(counts["mbk_epoch"] == est.n_iter_ and counts["mbk_epoch_stepped"] == 0,
         f"14a: K7b launched {counts['mbk_epoch']} times for {est.n_iter_} epochs", phase=14)
    gate(counts["lloyd_assign"] >= 1, "14a: K1b made no final labels", phase=14)
    per_row = est.inertia_ / n
    gate(per_row <= 1.05 * d, f"14a: inertia_/n = {per_row} > 1.05 * {d}", phase=14)
    gap = torch.cdist(truth, est.cluster_centers_).min(dim=1).values
    gate(bool((gap <= 0.1).all()), f"14a: centres not recovered: {gap.tolist()}", phase=14)
    log(f"phase 14a: worst centre error {float(gap.max()):.5f} (gate 0.1)")

    gen = torch.Generator(device=X.device).manual_seed(1)
    mask = torch.ones(n, device=X.device)
    centers, pair = est.cluster_centers_, est._counts

    def one_epoch():
        c, p = minibatch_kmeans._reassign_starved(centers, pair, X, mask, gen, 0.01)
        _, _, mean = minibatch_kmeans._mbk_epoch_fn(c, p, X, mask, 0, batch_size=MBK_BATCH,
                                                    n_batches=steps)
        float(mean)

    log_profile("phase 14a: one profiled epoch", *device_profile(torch, one_epoch), card)
    return est, counts


def stream_blocks(torch, X):
    """14b's host blocks: the first STREAM_BLOCKS blocks of 2^20 rows of X,
    copied to the host."""
    return [X[i * STREAM_ROWS:(i + 1) * STREAM_ROWS].cpu().numpy()
            for i in range(STREAM_BLOCKS)]


def mbk_stream(torch, X, init, card):
    """14b: ``_partial.fit`` of ``MiniBatchKMeans(n_clusters=8, init=14a's
    centres)`` over 16 host blocks at prefetch depths 0 and 2, then the same
    blocks already on the card as ``ShardedRows``; gates: every run's state
    bit-equal, one launch of the fused step (K1a with K7a's update in its
    last launch) a block and no K1a or K7a launch of its own, and after 8
    blocks the centres within 1e-4·max|c| of the plain versions'.  Returns
    the depth-2 counts."""
    from dask_ml_tpu_torch import _partial
    from dask_ml_tpu_torch.cluster import MiniBatchKMeans
    from dask_ml_tpu_torch.core import shard_rows
    from dask_ml_tpu_torch.ops import minibatch

    t0 = time.perf_counter()
    blocks = stream_blocks(torch, X)
    log(f"phase 14b: {STREAM_BLOCKS} host blocks of {STREAM_ROWS}x{X.shape[1]} copied from the "
        f"card in {time.perf_counter() - t0:.2f} s [{card}]")
    runs = {}
    for depth in (0, 2):
        torch.cuda.synchronize()
        reset_minibatch_counts()
        t0 = time.perf_counter()
        m = _partial.fit(MiniBatchKMeans(n_clusters=MBK_K, init=init),
                         (b for b in blocks), prefetch_depth=depth)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / STREAM_BLOCKS
        runs[depth] = (m, minibatch_counts())
        c = runs[depth][1]
        log(f"phase 14b: host blocks at depth {depth}: {ms:.3f} ms a block; the fused K1a+K7a "
            f"step {c['mbk_step'] / STREAM_BLOCKS:g} and K1a alone "
            f"{c['lloyd_assign_reduce'] / STREAM_BLOCKS:g} launches a block [{card}]")
    dev_blocks = [shard_rows(X[i * STREAM_ROWS:(i + 1) * STREAM_ROWS])
                  for i in range(STREAM_BLOCKS)]
    torch.cuda.synchronize()
    reset_minibatch_counts()
    t0 = time.perf_counter()
    on_card = MiniBatchKMeans(n_clusters=MBK_K, init=init)
    for b in dev_blocks:
        on_card.partial_fit(b)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / STREAM_BLOCKS
    c = minibatch_counts()
    log(f"phase 14b: blocks on the card: {ms:.3f} ms a block; the fused K1a+K7a step "
        f"{c['mbk_step'] / STREAM_BLOCKS:g} and K1a alone "
        f"{c['lloyd_assign_reduce'] / STREAM_BLOCKS:g} launches a block [{card}]")
    runs["on the card"] = (on_card, c)
    for name, m in (("depth 2", runs[2][0]), ("on the card", on_card)):
        gate(torch.equal(m.cluster_centers_, runs[0][0].cluster_centers_)
             and torch.equal(m._counts, runs[0][0]._counts),
             f"14b: the {name} stream's state differs from depth 0's", phase=14)
    for run, (m, cnt) in runs.items():
        gate(cnt["mbk_step"] == STREAM_BLOCKS and cnt["lloyd_assign_reduce"] == 0,
             f"14b: the run {run!r} launched the fused step {cnt['mbk_step']} times and K1a "
             f"alone {cnt['lloyd_assign_reduce']} times for {STREAM_BLOCKS} blocks", phase=14)
    kern = MiniBatchKMeans(n_clusters=MBK_K, init=init)
    centers = torch.as_tensor(init, device=X.device).clone()
    pair = torch.zeros(2, MBK_K, device=X.device)
    for b in dev_blocks[:STREAM_PLAIN]:
        kern.partial_fit(b)
        centers, pair, _ = minibatch.mbk_step_ref(centers, pair, b.data, b.mask)
    torch.cuda.synchronize()
    gap = float((kern.cluster_centers_ - centers).abs().max())
    scale = float(centers.abs().max())
    log(f"phase 14b: after {STREAM_PLAIN} blocks the centres are within {gap:.3g} of the "
        f"plain versions' ({gap / scale:.3g} of max|c|)")
    gate(gap <= 1e-4 * scale, f"14b: centres {gap} from the plain versions'", phase=14)
    return runs[2][1]


def k7_table(torch, X, est, stream_counts, fit_counts, card):
    """14c for K7: K7a, the epilogue of K1a's last launch (``k7a_entry``);
    K7b over one epoch of the first 2^20 rows (1024 steps from a fixed
    start) and at the main path's epoch (all rows), each held against its
    plain version, then timed by CUDA events beside the plain version and
    the bound."""
    out = [k7a_entry(torch, X, est.cluster_centers_ + 0.5, stream_counts["mbk_step"], card)]

    # K7b over the first 2^20 rows, and at the main path's epoch
    c0 = est.cluster_centers_ + 0.5  # off the optimum, so the steps move the centres
    out.append(k7b_entry(torch, X, c0, fit_counts["mbk_epoch"], card))
    return out


# the kernels of a MiniBatchKMeans step through K1a and K7a (a parent's K7a
# launched update_kernel after K1a's finalize_kernel)
K1A_K7A_KERNELS = ("pack_centers_kernel", "reduce_kernel", "finalize_kernel",
                   "finalize_update_kernel", "update_kernel")


def k7a_entry(torch, X, c0, launches, card):
    """14c for K7a, since PR 20 the update epilogue of K1a's last launch
    (``ops.minibatch.mbk_step``, ``finalize_update_kernel``), at 14b's
    block: the first 2^20 rows of X, all weight 1, the centres ``c0`` (k =
    8) and a pair of masses past 2^24 with one centre at 0.  The step is
    held bitwise against K1a followed by K7a's plain version; then, in
    turns, the step and K1a alone (CUDA events, 20 calls queued behind a
    device sleep); the step's device time by kernel (``torch.profiler``),
    with the finish that carries the update beside its bound; and 1024
    steps of the stepped epoch at k = 64 (``mbk_epoch`` past K7b's shapes:
    a step a window), its first 32 steps held bitwise against K1a then
    K7a's plain version, timed on the host clock and by its device time.
    On a parent's tree whose ``ops/minibatch.py`` has no ``mbk_step``, the
    step is K1a then K7a's own launch (``mbk_update``), timed alike.
    Returns K7a's line of the kernels table."""
    from dask_ml_tpu_torch.ops import lloyd, minibatch

    k, d = c0.shape
    x1 = X[:STREAM_ROWS]
    m1 = torch.ones(STREAM_ROWS, device=X.device)
    pair = torch.stack([torch.full((k,), 2.0 ** 25, device=X.device),
                        torch.full((k,), 0.25, device=X.device)])
    pair[:, -1] = 0.0
    fused = hasattr(minibatch, "mbk_step")

    def step(c, p, xb, mb):
        if fused:
            return minibatch.mbk_step(c, p, xb, mb)
        sums, bmass, inertia = lloyd.lloyd_assign_reduce(xb, mb, c)
        return (*minibatch.mbk_update(sums, bmass, c, p), inertia)

    err = None
    if fused:
        got = step(c0, pair, x1, m1)
        sums, bmass, inertia = lloyd.lloyd_assign_reduce(x1, m1, c0)
        want = (*minibatch.mbk_update_ref(sums, bmass, c0, pair), inertia)
        torch.cuda.synchronize()
        gate(all(torch.equal(a, b) for a, b in zip(got, want)),
             "14c: the fused step differs from K1a followed by K7a's plain version", phase=14)
        err = 0.0
    times = {"step": [], "k1a": []}
    calls = {"step": lambda: step(c0, pair, x1, m1),
             "k1a": lambda: lloyd.lloyd_assign_reduce(x1, m1, c0)}
    for what in ("step", "k1a", "k1a", "step"):
        times[what].append(queued_ms(torch, calls[what], K10_REPS))
    per = by_kernel(device_events(torch, calls["step"], K10_REPS), K10_REPS)
    sums_, bmass_, _ = lloyd.lloyd_assign_reduce(x1, m1, c0)
    plain_ms = time_ms(torch, lambda: minibatch.mbk_update_ref(sums_, bmass_, c0, pair), 3)
    plan, _ = lloyd._plan(lloyd._load(), "lloyd_plan", 8, STREAM_ROWS, d, k, X.device)
    blocks, rec = int(plan[5]), int(plan[6])
    finish = "finalize_update_kernel" if fused else "update_kernel"
    # the finish that carries the update: K1a's block records read, the
    # sums written, the state read and the new state written
    nbytes = 4 * (blocks * rec + rec + 2 * (k * d + 2 * k)) if fused else \
        4 * (3 * k * d + k + 4 * k)
    b_ms, b_by = bound_ms(nbytes, blocks * rec + 4 * k * d + 12 * k)
    ms = per[finish][0] if finish in per else None
    launches_a_step = sum(c for name, (_, c) in per.items() if name in K1A_K7A_KERNELS)
    held = "; bit-equal to K1a then K7a's plain version" if fused else ""
    log(f"phase 14c: K1a {'with K7a as its epilogue' if fused else 'then K7a'} at {STREAM_ROWS}x"
        f"{d}, k={k}: {', '.join(f'{v:.4f}' for v in times['step'])} ms a step, K1a alone "
        f"{', '.join(f'{v:.4f}' for v in times['k1a'])} ms (CUDA events, queued); "
        f"{launches_a_step:g} launches a step; device a step: "
        + ", ".join(f"{name} {v:.4f} ms ({c:g}x)" for name, (v, c) in per.items())
        + f"; {finish} {'not measured' if ms is None else f'{ms:.4f} ms'} against its bound "
        f"{b_ms:.6f} ms by {b_by} ({nbytes} bytes); K7a's plain version {plain_ms:.4f} ms"
        f"{held} [{card}]")

    # the stepped epoch past K7b's shapes: k = 64
    c64 = X[STREAM_ROWS:STREAM_ROWS + 64].clone()
    z64 = torch.zeros(2, 64, device=X.device)
    args = (c64, z64, x1, m1, EPOCH_CHECK_START)
    if fused:
        got = minibatch.mbk_epoch(*args, MBK_BATCH, 32)
        c, p = c64, z64
        for i in range(32):
            off = minibatch.window_start(EPOCH_CHECK_START, i, MBK_BATCH, STREAM_ROWS)
            sums, bmass, _ = lloyd.lloyd_assign_reduce(x1[off:off + MBK_BATCH].clone(),
                                                       m1[off:off + MBK_BATCH], c)
            c, p = minibatch.mbk_update_ref(sums, bmass, c, p)
        torch.cuda.synchronize()
        gate(torch.equal(got[0], c) and torch.equal(got[1], p),
             "14c: the stepped epoch at k = 64 differs from K1a then K7a's plain version",
             phase=14)
    stepped = minibatch.mbk_epoch.stepped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    minibatch.mbk_epoch(*args, MBK_BATCH, EPOCH_CHECK_STEPS)
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / EPOCH_CHECK_STEPS
    gate(minibatch.mbk_epoch.stepped == stepped + 1, "14c: the k = 64 epoch was not stepped",
         phase=14)
    per = by_kernel(device_events(
        torch, lambda: minibatch.mbk_epoch(*args, MBK_BATCH, EPOCH_CHECK_STEPS), 1),
        EPOCH_CHECK_STEPS)
    dev_us = 1e3 * sum(v for v, _ in per.values())
    kern = sum(c for name, (_, c) in per.items() if name in K1A_K7A_KERNELS)
    log(f"phase 14c: the stepped epoch at k=64, bs={MBK_BATCH}, {EPOCH_CHECK_STEPS} steps over "
        f"{STREAM_ROWS}x{d}: {host_us:.3f} us a step on the host clock, {dev_us:.3f} us a step "
        f"of device time, K1a and K7a {kern:g} launches a step; device a step: "
        + ", ".join(f"{name} {1e3 * v:.3f} us ({c:g}x)" for name, (v, c) in per.items())
        + f" [{card}]")
    return {"name": "mbk_update", "route": "cuda", "source": "dask_ml_tpu_torch/csrc/lloyd.cu",
            "replaces": "dask_ml_tpu/cluster/minibatch_kmeans.py:54", "launches": launches,
            "max_abs_err": err, "ms": ms if ms is not None else times["step"][0],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def k7b_entry(torch, X, c0, launches, card, plain_epoch=True):
    """14c for K7b: over one epoch of the first 2^20 rows (1024 steps from
    a fixed start) and at the main path's epoch (all rows), each held
    against its plain version (``plain_epoch=False``: the main epoch only
    timed), then timed by CUDA events beside the plain version and the
    bound; returns its line of the kernels table."""
    from dask_ml_tpu_torch.ops import minibatch

    k, d = c0.shape
    # 1024 steps from a fixed start
    x1 = X[:STREAM_ROWS]
    m1 = torch.ones(STREAM_ROWS, device=X.device)
    z = torch.zeros(2, k, device=X.device)
    args = (c0, z, x1, m1, EPOCH_CHECK_START, MBK_BATCH, EPOCH_CHECK_STEPS)
    got = minibatch.mbk_epoch(*args)
    again = minibatch.mbk_epoch(*args)
    want = minibatch.mbk_epoch_ref(*args)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    gate(all(torch.equal(a, b) for a, b in zip(got, again)), "14c: K7b is not deterministic",
         phase=14)
    gate(err <= 1e-5 * float(want[0].abs().max())
         and abs(float(got[2]) - float(want[2])) <= 1e-5 * abs(float(want[2])),
         f"14c: K7b over {EPOCH_CHECK_STEPS} steps: centres {err} from the plain version's, "
         f"inertia {float(got[2])} vs {float(want[2])}", phase=14)
    ms = time_ms(torch, lambda: minibatch.mbk_epoch(*args), K10_REPS)
    plain_ms = time_ms(torch, lambda: minibatch.mbk_epoch_ref(*args), 1)
    log(f"mbk_epoch (K7b) over {EPOCH_CHECK_STEPS} steps of {MBK_BATCH} rows (2^20 x {d}, "
        f"k={k}): {ms:.4f} ms, {1e3 * ms / EPOCH_CHECK_STEPS:.3f} us a step (plain "
        f"{plain_ms:.4f} ms); centres within {err:.3g}, mean inertia {float(got[2]):.8g} vs "
        f"{float(want[2]):.8g} [{card}]")

    # K7b at the main path's epoch: every row of X
    n = X.shape[0]
    steps = n // MBK_BATCH
    mask = torch.ones(n, device=X.device)
    args = (c0, z, X, mask, 0, MBK_BATCH, steps)
    got = minibatch.mbk_epoch(*args)
    torch.cuda.synchronize()
    err = ierr = plain_ms = None
    if plain_epoch:
        t0 = time.perf_counter()
        want = minibatch.mbk_epoch_ref(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = float((got[0] - want[0]).abs().max())
        ierr = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
        gate(err <= 1e-4 * float(want[0].abs().max()) and ierr <= 1e-5,
             f"14c: K7b over the main path's epoch: centres {err} from the plain version's, "
             f"inertia rel. {ierr}", phase=14)
    ms = time_ms(torch, lambda: minibatch.mbk_epoch(*args), MBK_EPOCH_REPS)
    nbytes = n * d * 4 + n * 4 + 2 * (k * d + 2 * k) * 4 + 4
    flops = n * (2 * d * k + 2 * d + 4 * k + 2 * (d + 1))
    b_ms, b_by = bound_ms(nbytes, flops)
    held = (f"plain {plain_ms:.1f} ms, its host clock; " if plain_epoch else "")
    within = (f"centres within {err:.3g}, mean inertia rel. {ierr:.3g}" if plain_epoch
              else "not held against the plain version here")
    log(f"mbk_epoch (K7b) at the main path's epoch ({steps} steps of {MBK_BATCH} rows of "
        f"{n}x{d}, k={k}): {ms:.4f} ms an epoch, {1e3 * ms / steps:.3f} us a step ({held}bound "
        f"{b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP; "
        f"{b_ms / ms:.2%} of it); {within} [{card}]")
    return {"name": "mbk_epoch", "route": "cuda", "source": "dask_ml_tpu_torch/csrc/minibatch.cu",
            "replaces": "dask_ml_tpu/cluster/minibatch_kmeans.py:124", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def k10_bound(n, m, d):
    """K10's least time: x, y read once and the (n, m) output written once;
    2d FLOPs an entry for the product, 6 for the epilogue, and 2d a row of
    x or y for its norm."""
    nbytes = 4 * (n * d + m * d + n * m)
    flops = n * m * (2 * d + 6) + 2 * d * (n + m)
    return nbytes, flops, bound_ms(nbytes, flops)


def hold_k10(torch, pairwise, x, y, kind, gamma=None, row0=0, col0=0, self_pairs=False):
    """K10 against its plain version on the same inputs: d² within
    1e-5·(‖x−a‖²+‖y−a‖²) (√d² through its square, exp(−γd²) to
    1e-5·γ·(‖x−a‖²+‖y−a‖²)), the flagged counts equal.  Returns (largest
    absolute difference, flagged)."""
    got = pairwise.sq_euclidean_safe(x, y, row0, col0, self_pairs, kind, gamma)
    flagged = int(pairwise.sq_euclidean_safe.last_flagged)
    want, want_flagged = pairwise.sq_euclidean_safe_ref(x, y, row0, col0, self_pairs, kind,
                                                         gamma)
    torch.cuda.synchronize()
    gate(flagged == int(want_flagged),
         f"14c: K10 {kind} flagged {flagged}, the plain version {int(want_flagged)}", phase=14)
    a = 0.5 * (x.double().mean(0) + y.double().mean(0))
    xn = ((x.double() - a) ** 2).sum(1)
    yn = ((y.double() - a) ** 2).sum(1)
    worst, err = 0.0, 0.0
    for s in range(0, x.shape[0], 1 << 16):
        g, w = got[s:s + (1 << 16)].double(), want[s:s + (1 << 16)].double()
        err = max(err, float((g - w).abs().max()))
        if kind == "euclid":
            g, w = g ** 2, w ** 2
        scale = (xn[s:s + (1 << 16), None] + yn[None, :]) * (gamma if kind == "rbf" else 1.0)
        worst = max(worst, float(((g - w).abs() / scale).max()))
    gate(worst <= TOL, f"14c: K10 {kind} at {tuple(x.shape)}x{tuple(y.shape)} is {worst:.3g} of "
         "its scale from the plain version", phase=14)
    del got, want
    return err, flagged


#: K10's launch split into its passes, by the kernel names of csrc/pairwise.cu
#: (this tree's and the first design's)
K10_PASSES = {"column sums": ("colsum_kernel", "anchor_kernel"), "y staged": ("prep_y_kernel",),
              "tiles": ("band_kernel", "wide_kernel", "tile_kernel")}
K10_SPLIT_REPS = 5


def k10_split(torch, fn):
    """Device ms a call of each of K10's passes (``K10_PASSES``), from
    ``torch.profiler`` over K10_SPLIT_REPS calls of ``fn``; None where the
    profiler did not record every call's tile kernel."""
    _, per_name = device_profile(torch, lambda: [fn() for _ in range(K10_SPLIT_REPS)])
    split, counts = {}, {}
    for label, names in K10_PASSES.items():
        hits = [v for name, v in per_name.items() if any(k in name for k in names)]
        split[label] = sum(ms for ms, _ in hits) / K10_SPLIT_REPS
        counts[label] = sum(count for _, count in hits)
    return split if counts["tiles"] == K10_SPLIT_REPS else None


def k10_entry(torch, pairwise, name, x, y, kind, gamma, launches, card, row0=0, col0=0,
              self_pairs=False, library=None):
    err, flagged = hold_k10(torch, pairwise, x, y, kind, gamma, row0, col0, self_pairs)
    out = torch.empty(x.shape[0], y.shape[0], device=x.device)
    kw = dict(row0=row0, col0=col0, self_pairs=self_pairs, kind=kind, gamma=gamma, out=out)
    ms = time_ms(torch, lambda: pairwise.sq_euclidean_safe(x, y, **kw), K10_REPS)
    split = k10_split(torch, lambda: pairwise.sq_euclidean_safe(x, y, **kw))
    plain_ms = time_ms(torch, lambda: pairwise.sq_euclidean_safe_ref(x, y, row0, col0,
                                                                      self_pairs, kind, gamma), 3)
    lib_ms = time_ms(torch, library, K10_REPS) if library is not None else None
    del out
    (n, d), m = x.shape, y.shape[0]
    nbytes, flops, (b_ms, b_by) = k10_bound(n, m, d)
    log(f"{name} (K10, {kind}) at x {n}x{d}, y {m}x{d}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"library {fmt_ms(lib_ms)}, bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.2f} GFLOP; {b_ms / ms:.2%} of it); flagged {flagged}, max abs err "
        f"{err:.3g}, launches on the path {launches} [{card}]")
    passes = ("not measured (the profiler did not record every call's kernels)" if split is None
              else ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log(f"{name} (K10, {kind}): device ms a call by pass ({K10_SPLIT_REPS} calls under "
        f"torch.profiler): {passes} [{card}]")
    return {"name": name, "route": "cuda", "source": "dask_ml_tpu_torch/csrc/pairwise.cu",
            "replaces": "dask_ml_tpu/metrics/pairwise.py:153", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def near_duplicates(torch, pairwise, X, card):
    """14c: rows at a common offset of 1e3, a quarter of y repeating rows of
    x and a quarter within 1e-2 of one, so the exact recompute runs on the
    card: the flagged count, and every surely flagged entry (exact d² below
    τ/2 of its scale) held to the float64 Σ(x−y)², repeated rows to 0."""
    x = (X[:NEAR_DUP_ROWS] + 1e3).contiguous()
    gen = torch.Generator(device=X.device).manual_seed(5)
    pick = torch.randperm(NEAR_DUP_ROWS, generator=gen, device=X.device)[:256]
    y = x[pick].clone()
    y[64:128] += (torch.rand(64, x.shape[1], generator=gen, device=X.device) - 0.5) * 2e-2
    y[128:] = X[-128:] + 1e3
    got = pairwise.sq_euclidean_safe(x, y)
    flagged = int(pairwise.sq_euclidean_safe.last_flagged)
    exact = torch.cdist(x.double(), y.double(),
                        compute_mode="donot_use_mm_for_euclid_dist") ** 2
    a = 0.5 * (x.double().mean(0) + y.double().mean(0))
    scale = ((x.double() - a) ** 2).sum(1)[:, None] + ((y.double() - a) ** 2).sum(1)[None, :]
    sure = exact < 0.5 * pairwise.SAFE_TAU * scale
    rel = float(((got.double() - exact).abs()[sure] / exact[sure].clamp_min(1e-300)).max())
    zeros_ok = bool((got[exact == 0] == 0).all())
    log(f"phase 14c: near-duplicates (x {NEAR_DUP_ROWS}x{x.shape[1]} at offset 1e3, y 256 rows): "
        f"{flagged} entries recomputed on the card, {int(sure.sum())} surely flagged, within "
        f"{rel:.3g} of the float64 sum; repeated rows exactly 0: {zeros_ok} [{card}]")
    gate(flagged >= int(sure.sum()) >= 128 and rel <= TOL and zeros_ok,
         "14c: the near-duplicate entries are not the exact sums", phase=14)
    hold_k10(torch, pairwise, x, y, "sq")


def pairwise_path(torch, X, device, card):
    """14d: the distance functions at full width, each count set to 0 just
    before and read just after; returns the counts by epilogue."""
    from dask_ml_tpu_torch.core import shard_rows, use_device
    from dask_ml_tpu_torch.metrics import (
        euclidean_distances, pairwise_distances, pairwise_distances_argmin_min)
    from dask_ml_tpu_torch.ops import lloyd, pairwise

    x, y = X[:PAIR_ROWS], X[-PAIR_M:]
    launches = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        before = pairwise.sq_euclidean_safe.launches
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        launches[label] = pairwise.sq_euclidean_safe.launches - before
        return res, 1e3 * (time.perf_counter() - t0)

    reset_minibatch_counts()
    D, t_e = timed("euclid", lambda: euclidean_distances(x, y))
    gate(tuple(D.shape) == (PAIR_ROWS, PAIR_M) and bool(torch.isfinite(D).all()),
         "14d: euclidean_distances returned a malformed matrix", phase=14)
    del D
    D, t_s = timed("sq", lambda: pairwise_distances(x, y, metric="sqeuclidean"))
    del D
    with use_device(device, n_shards=RING_SHARDS):
        S = shard_rows(X[:RING_ROWS])
        R, t_r = timed("ring", lambda: euclidean_distances(S, S))
    gate(tuple(R.shape) == (RING_ROWS, RING_ROWS), "14d: the ring's shape", phase=14)
    diag_zero = bool((torch.diagonal(R) == 0).all())
    asym = max(float((R[s:s + 4096] - R[:, s:s + 4096].T).abs().max())
               for s in range(0, RING_ROWS, 4096))
    top = float(R.max())
    del R
    gate(diag_zero and asym <= 1e-5 * top,
         f"14d: the self ring's diagonal zero {diag_zero}, asymmetry {asym} of max {top}",
         phase=14)
    torch.cuda.synchronize()
    before = lloyd.lloyd_assign.launches
    t0 = time.perf_counter()
    idx, dist = pairwise_distances_argmin_min(X, y[:ARGMIN_M])
    torch.cuda.synchronize()
    t_a = 1e3 * (time.perf_counter() - t0)
    k1b = lloyd.lloyd_assign.launches - before
    ones = torch.ones(PAIR_ROWS, device=X.device)
    pl, pd2, _ = lloyd.lloyd_assign_ref(x, ones, y[:ARGMIN_M])
    n_tie = near_ties_only(torch, x, y[:ARGMIN_M], idx[:PAIR_ROWS], pl, None,
                           "14d argmin_min")
    derr = float((dist[:PAIR_ROWS] - torch.sqrt(torch.clamp_min(pd2, 0))).abs().max())
    gate(k1b == 1 and idx.shape == (X.shape[0],), f"14d: argmin_min launched K1b {k1b} times",
         phase=14)
    log(f"phase 14d: euclidean_distances {PAIR_ROWS}x{PAIR_M} {t_e:.3f} ms, sqeuclidean "
        f"{t_s:.3f} ms, the self ring {RING_ROWS}x{RING_ROWS} in {RING_SHARDS} shards "
        f"{t_r:.3f} ms (diagonal exactly 0, asymmetry {asym:.3g} of max {top:.4g}), "
        f"argmin_min over {X.shape[0]} rows against {ARGMIN_M} {t_a:.3f} ms (K1b {k1b} launch; "
        f"on the first {PAIR_ROWS} rows {n_tie} near-tie labels differ from the plain "
        f"version's, distances within {derr:.3g}); K10 launches {launches} [{card}]")
    del idx, dist
    return launches


class SyncedPhases(logging.Handler):
    """Host-clock seconds of each ``utils._timer`` phase, with the device
    synchronised at the phase's start and end, so that the time is the
    phase's work and not its enqueue."""

    def __init__(self, torch):
        super().__init__(logging.DEBUG)
        self.torch = torch
        self.started = {}
        self.seconds = {}

    def emit(self, record):
        if record.msg.startswith("Starting %s"):
            self.torch.cuda.synchronize()
            self.started[record.args[0]] = time.perf_counter()
        elif record.msg.startswith("Finished %s in"):
            self.torch.cuda.synchronize()
            name = record.args[0]
            self.seconds[name] = time.perf_counter() - self.started.pop(name)


def spectral_path(torch, X, truth, card):
    """14e: ``SpectralClustering(n_clusters=8, random_state=0)`` (rbf, γ =
    1/d, n_components=100) on the first 10M rows; gate: each true blob maps
    to one found cluster, a different one each, for at least 99% of its
    rows.  Returns (the K10 launches, the estimator's sample)."""
    from dask_ml_tpu_torch.cluster import SpectralClustering
    from dask_ml_tpu_torch.ops import lloyd, pairwise

    x = X[:SPECTRAL_ROWS]
    ones = torch.ones(SPECTRAL_ROWS, device=X.device)
    blob, _, _ = lloyd.lloyd_assign(x, ones, truth.contiguous())  # the true blob of each row
    timer = SyncedPhases(torch)
    sc_logger = logging.getLogger("dask_ml_tpu_torch.cluster.spectral")
    sc_logger.addHandler(timer)
    sc_logger.setLevel(logging.DEBUG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_minibatch_counts()
    t0 = time.perf_counter()
    est = SpectralClustering(n_clusters=MBK_K, random_state=0).fit(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sc_logger.removeHandler(timer)
    c = minibatch_counts()
    labels = est.labels_
    table = torch.zeros(MBK_K, MBK_K, dtype=torch.int64, device=X.device)
    table.index_put_((blob, labels), torch.ones_like(blob), accumulate=True)
    share = (table.max(dim=1).values.double() / table.sum(dim=1).double()).min()
    distinct = len(set(table.argmax(dim=1).tolist())) == MBK_K
    split = ", ".join(f"{k} {v:.3f} s" for k, v in timer.seconds.items())
    log(f"phase 14e: SpectralClustering({MBK_K}) on {SPECTRAL_ROWS}x{X.shape[1]} in {wall:.3f} s "
        f"({split}; each phase synchronised at its ends); K10 launches "
        f"{c['sq_euclidean_safe']}, K1a {c['lloyd_assign_reduce']}, K1b {c['lloyd_assign']}; "
        f"eigenvalues_ {[round(v, 6) for v in est.eigenvalues_.tolist()]}; each blob's largest "
        f"share in one cluster >= {float(share):.6f}, one cluster a blob: {distinct}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    gate(set(timer.seconds) == set(SPECTRAL_PHASES),
         f"14e: the fit's timed phases {sorted(timer.seconds)}, not {SPECTRAL_PHASES}", phase=14)
    gate(float(share) >= 0.99 and distinct, f"14e: blob shares {float(share)}, distinct "
         f"{distinct}", phase=14)
    gate(c["sq_euclidean_safe"] == 2 and c["lloyd_assign_reduce"] >= 1
         and c["lloyd_assign"] >= 1, f"14e: launches {c}", phase=14)
    return c["sq_euclidean_safe"]


def k7k10_yardstick(torch, device, card):
    """``--k7k10-yardstick ROOT``: K1a at the KMeans main path's shape
    (phase 5's call), 14c's K7a (``k7a_entry``: MiniBatchKMeans' step at
    14b's block and 1024 steps of the stepped epoch at k = 64), K7b (1024
    steps of the first 2^20 rows, held; the main path's epoch, timed) and
    K10 (``sq`` and ``euclid``
    at 2^20 x 1024, the ring tile and ``rbf`` at 10M x 100, each held, with
    ``torch.cdist`` beside ``euclid`` and the ring tile and the column-sum
    pass apart) on the package under ROOT (a parent's tree, or this one),
    so that two trees are timed in one call on one card."""
    from dask_ml_tpu_torch.ops import _build, lloyd, minibatch, pairwise

    log(f"k7k10 yardstick: {minibatch.__file__}, {pairwise.__file__}")
    _build.build(["lloyd", "minibatch", "pairwise"])
    X, truth = make_blobs(torch, MAIN_ROWS, MAIN_D, MBK_K, 0, device)
    torch.cuda.synchronize()
    mask = torch.ones(MAIN_ROWS, device=device)
    k1a = [time_ms(torch, lambda: lloyd.lloyd_assign_reduce(X, mask, truth), 10) for _ in range(2)]
    log(f"k7k10 yardstick: K1a (lloyd_assign_reduce) at {MAIN_ROWS}x{MAIN_D}, k={MBK_K}: "
        f"{', '.join(f'{v:.4f}' for v in k1a)} ms [{card}]")
    k7a_entry(torch, X, truth + 0.5, 0, card)
    k7b_entry(torch, X, truth + 0.5, 0, card, plain_epoch=False)
    k10_entries(torch, pairwise, X, {"sq": 0, "euclid": 0, "ring": 0, "rbf": 0}, card)


def k10_entries(torch, pairwise, X, launches, card):
    """14c for K10: its lines of the kernels table, each epilogue at the
    shape its path gives it."""
    x, y = X[:PAIR_ROWS], X[-PAIR_M:]
    out = [k10_entry(torch, pairwise, "sq_euclidean_safe_sq", x, y, "sq", None,
                     launches["sq"], card),
           k10_entry(torch, pairwise, "sq_euclidean_safe_euclid", x, y, "euclid", None,
                     launches["euclid"], card, library=lambda: torch.cdist(x, y))]
    ring_x, ring_y = X[:RING_ROWS], X[RING_ROWS - RING_ROWS // RING_SHARDS:RING_ROWS]
    out.append(k10_entry(torch, pairwise, "sq_euclidean_safe_ring", ring_x, ring_y, "euclid",
                         None, launches["ring"], card, row0=0,
                         col0=RING_ROWS - RING_ROWS // RING_SHARDS, self_pairs=True,
                         library=lambda: torch.cdist(ring_x, ring_y)))
    xs = X[:SPECTRAL_ROWS]
    out.append(k10_entry(torch, pairwise, "sq_euclidean_safe_rbf", xs, spectral_sample(torch, X),
                         "rbf", 1.0 / MAIN_D, launches["rbf"], card))
    return out


def spectral_sample(torch, X):
    """SPECTRAL_M rows of 14e's rows drawn from a seed: the Nystrom sample's shape."""
    gen = torch.Generator(device=X.device).manual_seed(0)
    idx = torch.randperm(SPECTRAL_ROWS, generator=gen, device=X.device)[:SPECTRAL_M]
    return X[:SPECTRAL_ROWS][idx].contiguous()


def minibatch_phase(torch, device, card):
    """Phase 14 end to end; returns its lines of the kernels table."""
    from dask_ml_tpu_torch.ops import pairwise

    t0 = time.perf_counter()
    X, truth = make_blobs(torch, MAIN_ROWS, MAIN_D, MBK_K, 0, device)
    torch.cuda.synchronize()
    log(f"phase 14: make_blobs {MAIN_ROWS}x{MAIN_D} k={MBK_K} on the card in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    est, fit_counts = mbk_main_path(torch, X, truth, card)
    stream_counts = mbk_stream(torch, X, est.cluster_centers_.cpu().numpy(), card)
    out = k7_table(torch, X, est, stream_counts, fit_counts, card)
    launches = pairwise_path(torch, X, device, card)
    launches["rbf"] = spectral_path(torch, X, truth, card)
    near_duplicates(torch, pairwise, X, card)
    out += k10_entries(torch, pairwise, X, launches, card)
    x, y = X[:PAIR_ROWS], X[-PAIR_M:]
    xs, sample = X[:SPECTRAL_ROWS], spectral_sample(torch, X)
    # every epilogue at both shapes: the ones no entry above holds
    for a, b, kind in ((x, y, "rbf"), (xs, sample, "sq"), (xs, sample, "euclid")):
        gamma = 1.0 / MAIN_D if kind == "rbf" else None
        err, flagged = hold_k10(torch, pairwise, a, b, kind, gamma)
        log(f"phase 14c: K10 {kind} at x {tuple(a.shape)}, y {tuple(b.shape)} holds against its "
            f"plain version (max abs err {err:.3g}, flagged {flagged}) [{card}]")
    del X
    torch.cuda.synchronize()
    return out


def sweep_tree_yardstick(torch, device, card):
    """``--sweep-yardstick ROOT``: 13a's packed ``GridSearchCV`` on the
    HIGGS stand-in (one warm search, then two timed on the host clock after
    a sync, then one under ``torch.profiler``: the loss kernels' device
    time and the idle share) and 13d's shared-target K2-OvR entries
    (logistic at 13a's first train fold and L=8, Normal at 13c's stand-in
    and L=5: held against the plain version and the materialized copy,
    then timed) on the package under ROOT (a parent's tree, or this one),
    so that two trees are timed in one call on one card."""
    import numpy as np

    from dask_ml_tpu_torch.core import shard_rows, use_device
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import _build, logistic, multiclass
    from dask_ml_tpu_torch.solvers import algorithms

    log(f"sweep yardstick: {multiclass.__file__}")
    _build.build(["logistic", "multiclass"])
    with use_device(device, n_shards=HIGGS_SHARDS):
        X, y, _ = higgs_standin(torch, HIGGS_ROWS, HIGGS_D, 0, device)
        sX, sy = shard_rows(X), shard_rows(y)

        def make():
            return LogisticRegression(max_iter=ADMM_ROUNDS,
                                      solver_kwargs={"inner_iter": ADMM_INNER})

        grid = {"C": np.logspace(-3, 4, 8)}
        for i in range(3):
            timed_search(torch, multiclass, logistic, algorithms,
                         f"sweep yardstick: 13a packed search {'warm' if i == 0 else i}", make,
                         sX, sy, grid, "auto", card)
        profiled_admm_fit(torch, algorithms, sX, sy, card, make=lambda: _Search(make, grid),
                          label="sweep yardstick: 13a profiled packed search")
        Xr, yr, _ = glm_standin(torch, "normal", HIGGS_ROWS, HIGGS_D, 5, device)
        sweep_kernel_table(torch, multiclass, [("logistic", sX, sy, 8),
                                               ("normal", shard_rows(Xr), shard_rows(yr), 5)],
                           {name: 0 for name in OVR_SWEEP_WRAPPERS}, card)



# ----------------------------------------------------------------- phase 15

def reset_prep_counts():
    """Every launch count of phase 15's kernels to 0."""
    from dask_ml_tpu_torch.ops import histogram, naive_bayes

    for fn in (histogram.hist_pass_counts, naive_bayes.class_sums,
               naive_bayes.class_deviations, naive_bayes.gaussian_jll):
        fn.launches = 0


def prep_counts():
    from dask_ml_tpu_torch.ops import histogram, naive_bayes

    return {"hist_pass_counts": histogram.hist_pass_counts.launches,
            "class_sums": naive_bayes.class_sums.launches,
            "class_deviations": naive_bayes.class_deviations.launches,
            "gaussian_jll": naive_bayes.gaussian_jll.launches}


@contextlib.contextmanager
def prep_plain_versions():
    """Phase 15's kernels replaced by their plain versions where the
    estimators call them (on the card, as a check only)."""
    from dask_ml_tpu_torch import naive_bayes as nb_mod
    from dask_ml_tpu_torch.ops import histogram, naive_bayes
    from dask_ml_tpu_torch.preprocessing import data

    saved = (data.hist_pass_counts, nb_mod.class_moments, nb_mod.gaussian_jll)
    data.hist_pass_counts = histogram.hist_pass_counts_ref
    nb_mod.class_moments = naive_bayes.class_moments_ref
    nb_mod.gaussian_jll = naive_bayes.gaussian_jll_ref
    try:
        yield
    finally:
        data.hist_pass_counts, nb_mod.class_moments, nb_mod.gaussian_jll = saved


def prep_pipeline():
    from dask_ml_tpu_torch import GaussianNB, QuantileTransformer, SimpleImputer, make_pipeline

    return make_pipeline(SimpleImputer(), QuantileTransformer(output_distribution="normal"),
                         GaussianNB())


def nan_standin(torch, device):
    """Phase 6's HIGGS stand-in with PREP_NAN of its entries set to NaN, the
    entries drawn from a seeded generator on the card."""
    X, y, _ = higgs_standin(torch, HIGGS_ROWS, HIGGS_D, 0, device)
    gen = torch.Generator(device=device).manual_seed(PREP_SEED)
    X[torch.rand(X.shape, generator=gen, device=device) < PREP_NAN] = float("nan")
    return X, y


def close_to(torch, label, got, want, scale, rtol):
    """|got − want| <= rtol·max(|want|, scale), elementwise; returns the
    largest |got − want| / max(|want|, scale)."""
    ref = torch.maximum(want.abs(), scale)
    worst = float(((got - want).abs() / ref).max())
    log(f"  {label}: largest |Δ| / max(|plain|, scale) {worst:.3g} (<= {rtol})")
    if not worst <= rtol:
        raise AssertionError(f"{label}: {worst:.3g} > {rtol}")
    return worst


def class_scale(torch, x, labels, weights, k):
    """Each class's mean |x| (k, d): the scale of a float32 sum's rounding
    in its moments, which a mean near 0 does not have."""
    from dask_ml_tpu_torch.ops import naive_bayes

    return naive_bayes.class_sums_ref(x.abs(), labels, weights, k)[1]


def hold_nb(torch, est, Xt, labels, weights, label):
    """A fitted GaussianNB's theta_ and var_ against K9's plain version on
    the same rows (rtol PREP_RTOL of the larger of |plain| and the class's
    mean |x| or its variance), its predictions against the plain jll's
    argmax (equal: K9b gives the plain version's bits); returns the plain
    jll's argmax."""
    from dask_ml_tpu_torch.ops import naive_bayes

    k = len(est.classes_)
    counts, means, var = naive_bayes.class_moments_ref(Xt, labels, weights, k)
    close_to(torch, f"{label} theta_ vs K9's plain version", est.theta_, means,
             class_scale(torch, Xt, labels, weights, k), PREP_RTOL)
    eps = est.var_smoothing * est._max_var
    close_to(torch, f"{label} var_ vs K9's plain version", est.var_ - eps, var,
             var.abs().amax(dim=1, keepdim=True), PREP_RTOL)
    if not torch.equal(est.class_count_, counts):
        worst = float(((est.class_count_ - counts).abs() / counts).max())
        log(f"  {label} class_count_ vs plain: rtol {worst:.3g}")
        if not worst <= PREP_RTOL:
            raise AssertionError(f"{label}: class_count_ differs by {worst:.3g}")
    pred = naive_bayes.gaussian_jll(Xt, est.theta_, est.var_, est.class_prior_, predict=True)
    plain = naive_bayes.gaussian_jll_ref(Xt, est.theta_, est.var_, est.class_prior_,
                                         predict=True)
    differ = int((pred != plain).sum())
    log(f"  {label} predictions: {differ} of {pred.shape[0]} differ from the plain jll's argmax")
    if differ:
        raise AssertionError(f"{label}: {differ} predictions differ from the plain version's")
    return plain


def prep_main_path(torch, X, y, card):
    """15a: the pipeline fitted and scored on the stand-in with NaNs, every
    count set to 0 just before and read just after; then the same pipeline
    through the plain versions, and the gates."""
    from dask_ml_tpu_torch.preprocessing.data import _hist_quantiles

    reset_prep_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = prep_pipeline().fit(X, y)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = pipe.score(X, y)
    t_score = time.perf_counter() - t0
    launches = prep_counts()
    log(f"phase 15a: make_pipeline(SimpleImputer(), QuantileTransformer(normal), GaussianNB()) "
        f"on {HIGGS_ROWS}x{HIGGS_D} with {PREP_NAN:.0%} NaN: fit {t_fit:.3f} s, score "
        f"{t_score:.3f} s on the host clock after a sync, score {score:.6f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    log(f"phase 15a: launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    if launches["hist_pass_counts"] != 4:
        raise AssertionError(f"the quantile sketch made {launches['hist_pass_counts']} passes, "
                             "not 4")
    imp, qt, nb = (pipe.steps[i][1] for i in range(3))
    Xi = imp.transform(X)
    mask = torch.ones(Xi.shape[0], device=Xi.device)
    sketch, binw = _hist_quantiles(Xi, mask, qt.references_, with_width=True)
    if not torch.equal(sketch, qt.quantiles_):
        raise AssertionError("the sketch gave other bits on a second run")
    exact = torch.nanquantile(Xi, qt.references_, dim=0)
    # the sketch's value lies within a bin width of its target order
    # statistic, which is within one rank of the exact quantile's position
    srt = torch.sort(Xi, dim=0).values
    pos = qt.references_.double() * (srt.shape[0] - 1)
    below = torch.clamp(torch.floor(pos) - 1, 0, srt.shape[0] - 1).long()
    above = torch.clamp(torch.ceil(pos) + 1, 0, srt.shape[0] - 1).long()
    tol = binw[None, :] + (srt[above] - srt[below]) + 1e-6 * exact.abs()
    del srt
    gap = (qt.quantiles_ - exact).abs()
    worst = float((gap / tol).max())
    log(f"  quantiles_ vs torch.nanquantile on the card: largest |Δ| {float(gap.max()):.3g}, "
        f"{float((gap / binw[None, :]).max()):.3f} of the last pass's bin width (bin widths "
        f"{float(binw.min()):.3g} to {float(binw.max()):.3g}); largest |Δ| / (bin width + "
        f"the spread of the ranks next to the exact position) {worst:.3f} (<= 1)")
    if not worst <= 1.0:
        raise AssertionError(f"quantiles_ part from the exact ones by {worst:.3f} of the bound")
    Xt = qt.transform(Xi)
    del Xi
    labels = nb._class_index(y, Xt.shape[0], Xt.device)
    plain_pred = hold_nb(torch, nb, Xt, labels, mask, "15a")
    yd = y.to(plain_pred.device)
    plain_score = float((torch.as_tensor(nb.classes_).to(yd)[plain_pred] == yd).double().mean())
    log(f"  score {score:.8f}, the plain jll's {plain_score:.8f} (|Δ| <= 1e-6)")
    if not abs(score - plain_score) <= 1e-6:
        raise AssertionError(f"score {score} against the plain path's {plain_score}")
    with prep_plain_versions():
        t0 = time.perf_counter()
        plain = prep_pipeline().fit(X, y)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        plain_whole = plain.score(X, y)
    same_q = torch.equal(plain.steps[1][1].quantiles_, qt.quantiles_)
    log(f"  the pipeline through the plain versions: fit {t_plain:.3f} s, score "
        f"{plain_whole:.8f}; quantiles_ bit-equal {same_q}")
    if not same_q:
        raise AssertionError("quantiles_ differ from the plain path's: K12's counts are exact")
    if not abs(score - plain_whole) <= 1e-6:
        raise AssertionError(f"score {score} against the plain pipeline's {plain_whole}")
    wall_ms, per_name = device_profile(torch, lambda: prep_pipeline().fit(X, y))
    log_profile("phase 15a: profiled pipeline fit", wall_ms, per_name, card, top=12)
    return launches, Xt, labels, nb


def nb_k10(torch, device, card):
    """15b: GaussianNB at k = PREP_K on 11M x 28 standard normal rows,
    labels the argmax of X·W plus noise (W from the seed); the gates of
    15a and ``predict_proba`` against the plain jll's softmax (atol 1e-6)."""
    from dask_ml_tpu_torch import GaussianNB
    from dask_ml_tpu_torch.ops import naive_bayes

    gen = torch.Generator(device=device).manual_seed(PREP_SEED + 1)
    X = torch.randn(HIGGS_ROWS, HIGGS_D, generator=gen, device=device)
    W = torch.randn(HIGGS_D, PREP_K, generator=gen, device=device)
    noise = torch.randn(HIGGS_ROWS, PREP_K, generator=gen, device=device)
    y = torch.argmax(X @ W + noise, dim=1)
    del noise
    reset_prep_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = GaussianNB().fit(X, y)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    proba = est.predict_proba(X)
    torch.cuda.synchronize()
    t_proba = time.perf_counter() - t0
    acc = est.score(X, y)
    launches = prep_counts()
    log(f"phase 15b: GaussianNB k={PREP_K} on {HIGGS_ROWS}x{HIGGS_D}: fit {t_fit:.3f} s, "
        f"predict_proba {t_proba:.3f} s, accuracy {acc:.6f}; launches {launches} [{card}]")
    for name in ("class_sums", "class_deviations", "gaussian_jll"):
        if launches[name] < 1:
            raise AssertionError(f"15b: {name} was not launched")
    labels = est._class_index(y, HIGGS_ROWS, device)
    ones = torch.ones(HIGGS_ROWS, device=device)
    hold_nb(torch, est, X, labels, ones, "15b")
    jll = naive_bayes.gaussian_jll_ref(X, est.theta_, est.var_, est.class_prior_)
    err = float((proba - torch.softmax(jll, dim=1)).abs().max())
    log(f"  predict_proba vs the plain jll's softmax: max |Δ| {err:.3g} (<= 1e-6)")
    if not err <= 1e-6:
        raise AssertionError(f"15b: predict_proba differs by {err}")
    return X, labels, est, launches["gaussian_jll"]


def k12_inputs(torch, n, d, seed, device, edges=True):
    """Rows for K12's checks: standard normal, with an outlier (1e9) and a
    constant column where d >= 3, a mask with a twentieth 0, and the
    full window of the masked min and max."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device)
    if edges and d >= 3:
        x[:, 1] = 3.0
        x[n // 2, 2] = 1e9
    mask = (torch.rand(n, generator=gen, device=device) > 0.05).float()
    inf = float("inf")
    lo = torch.where(mask[:, None] > 0, x, inf).amin(dim=0)
    hi = torch.where(mask[:, None] > 0, x, -inf).amax(dim=0)
    return x, mask, lo, hi


def hold_k12(torch, histogram, x, mask, lo, hi, what):
    """K12's counts and below equal to its plain version's, and the same
    bits twice."""
    width = torch.clamp_min(hi - lo, 1e-30)
    c, b = histogram.hist_pass_counts(x, mask, lo, hi, width)
    c2, b2 = histogram.hist_pass_counts(x, mask, lo, hi, width)
    cr, br = histogram.hist_pass_counts_ref(x, mask, lo, hi, width)
    torch.cuda.synchronize()
    if not (torch.equal(c, cr) and torch.equal(b, br)):
        raise AssertionError(f"K12 at {what}: counts differ from the plain version's by "
                             f"{float((c - cr).abs().max())}")
    if not (torch.equal(c, c2) and torch.equal(b, b2)):
        raise AssertionError(f"K12 at {what}: two launches gave other bits")
    return 0.0


def k9_inputs(torch, n, d, k, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device) * 2 + 1
    labels = torch.randint(0, k, (n,), generator=gen, device=device, dtype=torch.int32)
    w = torch.rand(n, generator=gen, device=device) * 2
    w[torch.rand(n, generator=gen, device=device) < 0.1] = 0.0
    return x, labels, w


def hold_k9(torch, naive_bayes, x, labels, w, k, what):
    """K9's two passes against their plain version (rtol PREP_RTOL of the
    larger of |plain| and the class's mean |x|, or of its largest
    variance), the same bits twice; returns the largest |Δ|."""
    counts, means, var = naive_bayes.class_moments(x, labels, w, k)
    again = naive_bayes.class_moments(x, labels, w, k)
    rc, rm, rv = naive_bayes.class_moments_ref(x, labels, w, k)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((counts, means, var), again)):
        raise AssertionError(f"K9 at {what}: two launches gave other bits")
    close_to(torch, f"K9 counts at {what}", counts, rc, rc.abs().amax(), PREP_RTOL)
    close_to(torch, f"K9 means at {what}", means, rm, class_scale(torch, x, labels, w, k),
             PREP_RTOL)
    close_to(torch, f"K9 var at {what}", var, rv, rv.abs().amax(dim=1, keepdim=True), PREP_RTOL)
    return max(float((means - rm).abs().max()), float((var - rv).abs().max()))


def hold_k9b(torch, naive_bayes, x, theta, var, prior, what):
    """K9b's jll and predictions bit-equal to its plain version's, twice."""
    for predict in (False, True):
        got = naive_bayes.gaussian_jll(x, theta, var, prior, predict)
        again = naive_bayes.gaussian_jll(x, theta, var, prior, predict)
        want = naive_bayes.gaussian_jll_ref(x, theta, var, prior, predict)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"K9b at {what} (predict={predict}): not the plain version's "
                                 f"bits")
    return 0.0


def nb_params(torch, k, d, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    theta = torch.randn(k, d, generator=gen, device=device)
    var = torch.rand(k, d, generator=gen, device=device) + 0.5
    prior = torch.softmax(torch.randn(k, generator=gen, device=device), dim=0)
    return theta, var, prior


def prep_edges(torch, device, card):
    """15c: each kernel at ragged n, d = 130 and d = 1; K12 with an outlier
    and a constant column, K9 with fractional weights."""
    from dask_ml_tpu_torch.ops import histogram, naive_bayes

    for n, d in PREP_EDGE_SHAPES:
        x, mask, lo, hi = k12_inputs(torch, n, d, n + d, device)
        hold_k12(torch, histogram, x, mask, lo, hi, f"{n}x{d}")
        mid, half = 0.5 * (lo + hi), 0.05 * (hi - lo)
        hold_k12(torch, histogram, x, mask, mid - half, mid + half, f"{n}x{d}, a narrow window")
        for k in (2, PREP_K):
            xk, labels, w = k9_inputs(torch, n, d, k, n + k, device)
            hold_k9(torch, naive_bayes, xk, labels, w, k, f"{n}x{d} k={k}")
            hold_k9b(torch, naive_bayes, xk, *nb_params(torch, k, d, k, device),
                     f"{n}x{d} k={k}")
        log(f"phase 15c: K12, K9 and K9b hold at {n}x{d} (k = 2 and {PREP_K}) [{card}]")


def prep_bound(kind, n, d, k):
    """(bytes, flops) of one call at its path shape: each input read once,
    each output written once."""
    if kind == "k12":
        return n * d * 4 + n * 4 + 3 * d * 4 + d * 4097 * 4, 4 * n * d
    if kind == "k9_sums":
        return n * d * 4 + 8 * n + k * d * 4 + k * 4, 2 * n * d + n
    if kind == "k9_dev":
        return n * d * 4 + 8 * n + 2 * k * d * 4 + k * 4, 4 * n * d
    out = n * 8 if kind == "k9b_predict" else n * k * 4
    return n * d * 4 + 3 * k * d * 4 + k * 4 + out, 5 * n * k * d


def prep_entry(torch, name, kernel, plain, library, kind, shape, launches, err, replaces, card):
    n, d, k = shape
    ms = time_ms(torch, kernel, 10)
    plain_ms = time_ms(torch, plain, 3)
    lib_ms = time_ms(torch, library, 10) if library is not None else None
    nbytes, flops = prep_bound(kind, n, d, k)
    b_ms, b_by = bound_ms(nbytes, flops)
    shape = f"{n}x{d} k={k}" if k else f"{n}x{d}"
    log(f"{name} at {shape}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
        f"{fmt_ms(lib_ms)}, bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.2f} GFLOP; {b_ms / ms:.2%} of it); launches on the path {launches}, "
        f"max abs err {err:.3g} [{card}]")
    source = "histogram.cu" if kind == "k12" else "naive_bayes.cu"
    return {"name": name, "route": "cuda", "source": f"dask_ml_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def prep_table(torch, Xt, labels, nb, launches, Xb, labels_b, est_b, jll_b_launches, card):
    """15c: each kernel at its path shape held against its plain version,
    then timed beside it, its bound and, where one exists, the library
    call: K12 at the first pass's window of 15a's imputed rows (28
    ``torch.histc`` calls timed beside it, not the same function: no mask,
    no below, float bins), K9 on 15a's transformed rows (the one-hot
    ``torch.mm`` of each pass), K9b at k = 2 (predict) and k = PREP_K (jll)."""
    from dask_ml_tpu_torch.ops import histogram, naive_bayes

    n, d = Xt.shape
    mask = torch.ones(n, device=Xt.device)
    lo, hi = Xt.amin(dim=0), Xt.amax(dim=0)
    width = torch.clamp_min(hi - lo, 1e-30)
    err = hold_k12(torch, histogram, Xt, mask, lo, hi, f"{n}x{d} (15a's path)")
    los, his = lo.tolist(), hi.tolist()
    histc_ms = time_ms(torch, lambda: [torch.histc(Xt[:, j], bins=4096, min=los[j], max=his[j])
                                       for j in range(d)], 3)
    log(f"  informational: {d} torch.histc calls (no mask, no below) {histc_ms:.4f} ms [{card}]")
    out = [prep_entry(torch, "hist_pass_counts",
                      lambda: histogram.hist_pass_counts(Xt, mask, lo, hi, width),
                      lambda: histogram.hist_pass_counts_ref(Xt, mask, lo, hi, width), None,
                      "k12", (n, d, 0), launches["hist_pass_counts"], err,
                      "dask_ml_tpu/preprocessing/data.py:94", card)]
    k = len(nb.classes_)
    err = hold_k9(torch, naive_bayes, Xt, labels, mask, k, f"{n}x{d} k={k} (15a's path)")
    counts, means = naive_bayes.class_sums(Xt, labels, mask, k)
    onehot = naive_bayes._onehot(labels, k, Xt.dtype)
    dev2 = (Xt - onehot @ means) ** 2
    out.append(prep_entry(
        torch, "class_sums", lambda: naive_bayes.class_sums(Xt, labels, mask, k),
        lambda: naive_bayes.class_sums_ref(Xt, labels, mask, k),
        lambda: torch.mm(onehot.T, Xt), "k9_sums", (n, d, k), launches["class_sums"], err,
        "dask_ml_tpu/naive_bayes.py:18", card))
    out.append(prep_entry(
        torch, "class_deviations",
        lambda: naive_bayes.class_deviations(Xt, labels, mask, counts, means),
        lambda: naive_bayes.class_deviations_ref(Xt, labels, mask, counts, means),
        lambda: torch.mm(onehot.T, dev2), "k9_dev", (n, d, k), launches["class_deviations"],
        err, "dask_ml_tpu/naive_bayes.py:18", card))
    del onehot, dev2
    args = (Xt, nb.theta_, nb.var_, nb.class_prior_)
    err = hold_k9b(torch, naive_bayes, *args, f"{n}x{d} k={k} (15a's path)")
    out.append(prep_entry(
        torch, "gaussian_jll", lambda: naive_bayes.gaussian_jll(*args, predict=True),
        lambda: naive_bayes.gaussian_jll_ref(*args, predict=True), None, "k9b_predict",
        (n, d, k), launches["gaussian_jll"], err, "dask_ml_tpu/naive_bayes.py:138", card))
    args = (Xb, est_b.theta_, est_b.var_, est_b.class_prior_)
    kb = len(est_b.classes_)
    err = hold_k9b(torch, naive_bayes, *args, f"{n}x{d} k={kb} (15b's path)")
    out.append(prep_entry(
        torch, f"gaussian_jll_k{kb}", lambda: naive_bayes.gaussian_jll(*args),
        lambda: naive_bayes.gaussian_jll_ref(*args), None, "k9b_jll", (n, d, kb),
        jll_b_launches, err, "dask_ml_tpu/naive_bayes.py:138", card))
    return out


def prep_other_work(torch, X, card):
    """15c: RobustScaler().fit (the sketch at 3 probs), OneHotEncoder of 4
    integer columns of 8 categories at 11M rows, and StandardScaler.fit
    against a partial_fit over 11 blocks of 1M rows (var_ and scale_ rtol
    PREP_RTOL, mean_ within PREP_RTOL of scale_: a mean near 0 has no
    relative digits)."""
    import numpy as np

    from dask_ml_tpu_torch import OneHotEncoder, RobustScaler, StandardScaler

    reset_prep_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = RobustScaler().fit(X)
    torch.cuda.synchronize()
    log(f"phase 15c: RobustScaler().fit at {tuple(X.shape)}: {time.perf_counter() - t0:.3f} s, "
        f"K12 launches {prep_counts()['hist_pass_counts']}, scale_ in "
        f"[{float(rs.scale_.min()):.4f}, {float(rs.scale_.max()):.4f}] [{card}]")
    codes = np.random.RandomState(PREP_SEED).randint(0, OHE_CATS, (HIGGS_ROWS, OHE_COLS))
    t0 = time.perf_counter()
    enc = OneHotEncoder().fit(codes)
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    oh = enc.transform(codes)
    torch.cuda.synchronize()
    t_tr = time.perf_counter() - t0
    if tuple(oh.shape) != (HIGGS_ROWS, OHE_COLS * OHE_CATS) or float(oh.sum()) != HIGGS_ROWS * OHE_COLS:
        raise AssertionError(f"OneHotEncoder gave {tuple(oh.shape)}")
    log(f"phase 15c: OneHotEncoder of {OHE_COLS} integer columns of {OHE_CATS} categories at "
        f"{HIGGS_ROWS} rows (host numpy in): fit {t_fit:.3f} s, transform {t_tr:.3f} s [{card}]")
    del oh
    t0 = time.perf_counter()
    whole = StandardScaler().fit(X)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    stream = StandardScaler()
    t0 = time.perf_counter()
    for s in range(0, X.shape[0], SCALER_BLOCK):
        stream.partial_fit(X[s:s + SCALER_BLOCK])
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    log(f"phase 15c: StandardScaler.fit {t_whole:.3f} s, partial_fit over "
        f"{-(-X.shape[0] // SCALER_BLOCK)} blocks {t_stream:.3f} s [{card}]")
    close_to(torch, "StandardScaler var_ stream vs fit", stream.var_, whole.var_,
             torch.zeros_like(whole.var_), PREP_RTOL)
    close_to(torch, "StandardScaler scale_ stream vs fit", stream.scale_, whole.scale_,
             torch.zeros_like(whole.scale_), PREP_RTOL)
    close_to(torch, "StandardScaler mean_ stream vs fit", stream.mean_, whole.mean_,
             whole.scale_, PREP_RTOL)
    if stream.n_samples_seen_ != whole.n_samples_seen_:
        raise AssertionError("StandardScaler: n_samples_seen_ differs")


def prep_phase(torch, device, card):
    """Phase 15 end to end; returns its lines of the kernels table."""
    t0 = time.perf_counter()
    X, y = nan_standin(torch, device)
    torch.cuda.synchronize()
    log(f"phase 15: HIGGS stand-in {HIGGS_ROWS}x{HIGGS_D} with {PREP_NAN:.0%} NaN on the card "
        f"in {time.perf_counter() - t0:.2f} s [{card}]")
    launches, Xt, labels, nb = prep_main_path(torch, X, y, card)
    del X
    Xb, labels_b, est_b, jll_b = nb_k10(torch, device, card)
    out = prep_table(torch, Xt, labels, nb, launches, Xb, labels_b, est_b, jll_b, card)
    del Xb, labels_b
    prep_edges(torch, device, card)
    prep_other_work(torch, Xt, card)
    del Xt
    torch.cuda.synchronize()
    return out


# ----------------------------------------------------------------- phase 16
ENS_ROWS = 8 * (1 << 20)  # 16b: 8 blocks of streamed_sgd_70x1048576x64's 2^20 x 64
ENS_D = 64
ENS_BLOCKS = 8
ENS_ITER = 5
ENS_K = 10
ENS_SEED = 16
ENS_RTOL = 1e-4  # each member's coef against the same fit through the plain version
K5P_TOL = 1e-5
K5P_SHAPES = ((2, 1000, 3, 1), (5, 4097, 64, 1), (8, (1 << 20) + 3, 64, 1), (3, 12345, 64, 10),
              (4, 999, 130, 1))
K5P_REPS = 20
METRIC_ROWS = 1 << 20  # 16d's log_loss on the 10-class probabilities of the first rows
SGD_LOSSES = ("log_loss", "hinge", "squared_hinge", "modified_huber", "squared_error", "huber")
SGD_PENALTIES = ("l2", "l1", "elasticnet", None)
SGD_SCHEDULES = ("optimal", "constant", "invscaling", "adaptive")


def group_inputs(torch, M, size_hint, d, K, loss, seed, device):
    """16a's inputs: x (n, d) cut into M ragged spans as the ensemble cuts
    it (windows as long as the longest span, the last pulled left over its
    neighbour), targets, masks in [0, 2) with a tenth 0 and the last
    member's own rows all padding, a state and per-member hyperparameters."""
    import numpy as np

    from dask_ml_tpu_torch.ops.sgd import CLASSIFIER_LOSSES

    gen = torch.Generator(device=device).manual_seed(seed)
    n = M * size_hint - (M - 1)
    bounds = np.linspace(0, n, M + 1, dtype=int)
    spans = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    size = max(b - a for a, b in spans)
    starts = tuple(min(a, n - size) for a, _ in spans)
    x = torch.randn(n, d, generator=gen, device=device)
    if loss in CLASSIFIER_LOSSES:
        idx = torch.randint(0, max(K, 2), (n,), generator=gen, device=device)
        y = (2.0 * torch.nn.functional.one_hot(idx, max(K, 2)).float() - 1.0)[:, -K:].contiguous()
    else:
        y = 2.0 * torch.randn(n, 1, generator=gen, device=device)
    mask = 2.0 * torch.rand(n, generator=gen, device=device)
    mask[torch.rand(n, generator=gen, device=device) < 0.1] = 0.0
    mask[spans[-1][0]:] = 0.0
    valid = torch.zeros(M, size, device=device)
    for b, ((lo, hi), st) in enumerate(zip(spans, starts)):
        valid[b, lo - st:hi - st] = 1.0
    masks = torch.stack([mask[s:s + size] for s in starts]) * valid
    coef = torch.randn(M, d, K, generator=gen, device=device) / d ** 0.5
    intercept = 0.1 * torch.randn(M, K, generator=gen, device=device)
    t = 3.0 * torch.arange(M, dtype=torch.float32, device=device)
    hypers = torch.stack([sgd_hyper(torch, device, eta_scale=0.5)] * M)
    hypers[:, 0] *= torch.linspace(0.5, 2.0, M, device=device)
    return x, y, starts, masks, coef, intercept, t, hypers


def hinge_allowance(torch, x, y, starts, masks, coef, intercept, eta):
    """Per member, what its rows within 1e-5 of hinge's kink may move the
    update by (each such row's dℓ may jump by mask·|x| over the count)."""
    f64 = torch.float64
    B = masks.shape[1]
    out = []
    for m, s in enumerate(starts):
        xm, ym = x[s:s + B].to(f64), y[s:s + B].to(f64)
        z = ym * (xm @ coef[m].to(f64) + intercept[m].to(f64))
        near = ((z - 1.0).abs() <= 1e-5 * (1.0 + z.abs())) & (masks[m][:, None] > 0)
        count = max(float(masks[m].sum()), 1.0)
        out.append(float(eta[m]) * int(near.sum()) * float(masks[m].max())
                   * float(xm.abs().max()) / count)
    return out


def hold_group(torch, k5p, case, what, loss, penalty="l2", schedule="optimal",
               fit_intercept=True):
    """16a: K5′ against its plain version taken in float64 on the same
    inputs: each member's mean loss and Σ mask to rtol K5P_TOL, its coef and
    intercept to K5P_TOL of its largest step plus 2^-22 of each element (the
    float32 rounding of the stored c − eta·g), with hinge's rows within
    1e-5 of its kink allowed their jump, t equal; twice, with the same bits.
    Returns the largest absolute difference of coef, intercept and loss."""
    from dask_ml_tpu_torch.ops.sgd import learning_rate

    x, y, starts, masks, coef, intercept, t, hypers = case
    kw = dict(loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    runs = []
    for _ in range(2):
        state = [v.clone() for v in (coef, intercept, t)]
        out = k5p.group_step(x, y, starts, masks, *state, hypers, **kw)
        runs.append(state + [out])
    torch.cuda.synchronize()
    gate(all(torch.equal(a, b) for a, b in zip(*runs)), f"16a: {what}: a repeat gave other bits",
         phase=16)
    f64 = torch.float64
    ref = [v.to(f64) for v in (coef, intercept, t)]
    ref_out = k5p.group_step_ref(x.to(f64), y.to(f64), starts, masks.to(f64), *ref,
                                 hypers.to(f64), **kw)
    got_c, got_b, got_t, got_out = (v.to(f64) for v in runs[0])
    M = masks.shape[0]
    step_c = (coef.to(f64) - ref[0]).abs().reshape(M, -1).amax(dim=1)
    step_b = (intercept.to(f64) - ref[1]).abs().amax(dim=1)
    slack = torch.zeros(M, dtype=f64, device=x.device)
    if loss == "hinge":
        eta = [learning_rate(schedule, t[m].to(f64), hypers[m].to(f64)) for m in range(M)]
        slack += torch.tensor(hinge_allowance(torch, x, y, starts, masks, coef, intercept, eta),
                              dtype=f64, device=x.device)
    tol_c = (K5P_TOL * step_c + slack)[:, None, None] + 2.0 ** -22 * ref[0].abs()
    tol_b = (K5P_TOL * step_b + slack)[:, None] + 2.0 ** -22 * ref[1].abs()
    err_c, err_b = (got_c - ref[0]).abs(), (got_b - ref[1]).abs()
    err_out = (got_out - ref_out).abs()
    gate(bool((err_c <= tol_c).all()) and bool((err_b <= tol_b).all()),
         f"16a: {what}: coef off by {float(err_c.max()):.3g} (tolerance {float(tol_c.min()):.3g}"
         f"..), intercept by {float(err_b.max()):.3g}", phase=16)
    gate(bool((err_out <= K5P_TOL * ref_out.abs()).all()),
         f"16a: {what}: (loss, count) off by {float(err_out.max()):.3g}", phase=16)
    gate(torch.equal(got_t, ref[2]), f"16a: {what}: t differs", phase=16)
    return max(float(err_c.max()), float(err_b.max()), float(err_out[:, 0].max()))


def compare_group(torch, k5p, device):
    """16a: K5′ at every shape of K5P_SHAPES, each loss family (three at the
    full-size shape), penalty and schedule in turn, fit_intercept off in a
    fifth of the cases."""
    worst, n_cases = 0.0, 0
    for (M, s, d, K) in K5P_SHAPES:
        losses = SGD_LOSSES if K == 1 else SGD_LOSSES[:4]
        if s > 1 << 19:
            losses = ("log_loss", "hinge", "squared_error")
        for loss in losses:
            i = n_cases
            penalty, schedule = SGD_PENALTIES[i % 4], SGD_SCHEDULES[i % 4]
            case = group_inputs(torch, M, s, d, K, loss, i, device)
            what = (f"M={M} window {case[3].shape[1]} of {case[0].shape[0]} rows, d={d} K={K} "
                    f"{loss} {penalty} {schedule}")
            worst = max(worst, hold_group(torch, k5p, case, what, loss, penalty, schedule,
                                          fit_intercept=i % 5 != 3))
            n_cases += 1
            del case
    log(f"phase 16a: K5′ held against its plain version (float64) at {n_cases} cases of "
        f"{len(K5P_SHAPES)} shapes (ragged windows, the last overlapping, an all-padding "
        f"member, fractional masks), each twice with the same bits: largest |Δ| {worst:.3g}")
    return worst


def ens_standin(torch, device):
    """16b's data, made on the card from ENS_SEED: X 8·2^20 x 64 standard
    normal and y = [sigmoid(X·w) > U] (``datasets.stream_classification_blocks``,
    one block, w standard normal); the 10-class labels argmax(X·W + N(0, 1));
    the regression target X·w + N(0, 1)."""
    from dask_ml_tpu_torch.core import ShardedRows
    from dask_ml_tpu_torch.datasets import stream_classification_blocks

    gen = torch.Generator(device=device).manual_seed(ENS_SEED)
    w = torch.randn(ENS_D, generator=gen, device=device)
    W = torch.randn(ENS_D, ENS_K, generator=gen, device=device)
    X, y = next(stream_classification_blocks(1, ENS_ROWS, ENS_D, seed=ENS_SEED + 1, coef=w,
                                             device=device))
    noise = torch.randn(ENS_ROWS, ENS_K, generator=gen, device=device)
    y10 = torch.argmax(X.data @ W + noise, dim=1).to(torch.float32)
    yr = X.data @ w + torch.randn(ENS_ROWS, generator=gen, device=device)
    as_rows = lambda v: ShardedRows(data=v, mask=X.mask, n_samples=ENS_ROWS)  # noqa: E731
    return X, y, as_rows(y10), as_rows(yr), w, W


def ens_makers():
    """16b's three ensembles: (label, maker taking max_iter, truth kind)."""
    from dask_ml_tpu_torch import (
        BlockwiseVotingClassifier, BlockwiseVotingRegressor, SGDClassifier, SGDRegressor)

    return (
        ("BlockwiseVotingClassifier(SGDClassifier(log_loss, l2), n_blocks=8)",
         lambda it: BlockwiseVotingClassifier(
             SGDClassifier(loss="log_loss", penalty="l2", tol=None, max_iter=it),
             n_blocks=ENS_BLOCKS)),
        (f"BlockwiseVotingClassifier(SGDClassifier(log_loss, constant eta0=20), soft), "
         f"{ENS_K} classes",
         lambda it: BlockwiseVotingClassifier(
             SGDClassifier(loss="log_loss", tol=None, max_iter=it, learning_rate="constant",
                           eta0=20.0), voting="soft", n_blocks=ENS_BLOCKS)),
        ("BlockwiseVotingRegressor(SGDRegressor(constant eta0=0.5))",
         lambda it: BlockwiseVotingRegressor(
             SGDRegressor(tol=None, max_iter=it, learning_rate="constant", eta0=0.5),
             n_blocks=ENS_BLOCKS)),
    )


def loop_syncs(torch, k5p, fn):
    """The synchronizing CUDA operations ``fn`` makes (host reads among
    them), counted by ``torch.cuda.set_sync_debug_mode("warn")``: (those
    from the start of its first K5′ call to the end of its last, the epoch
    loop; all of them)."""
    import warnings

    real = k5p.group_step
    marks = []

    def marked(*args, **kwargs):
        marks.append(len(caught))
        out = real(*args, **kwargs)
        marks.append(len(caught))
        return out

    marked.launches = real.launches  # the wrapper counts its launches here while it stands in
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        k5p.group_step = marked
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            k5p.group_step = real
            real.launches = marked.launches
    syncs = ["synchroniz" in str(c.message) for c in caught]
    return sum(syncs[marks[0]:marks[-1]]), sum(syncs)


def ensemble_fit(torch, k5p, label, make, X, y, truth, card):
    """16b: one ensemble fit at full width, the counts set to 0 just before
    it and read just after; gates: K5′ once an epoch and its plain version
    never, no synchronizing operation from the first K5′ launch to the end
    of the last (no host read in the epoch loop),
    each member's coef within ENS_RTOL·‖coef‖∞ of the same fit through the
    plain version on the card, and ``score`` at least 0.98 of ``truth``.
    Prints the fit's wall time (host clock after a sync) and, from one more
    fit under ``torch.profiler``, its idle share.  Returns (the fitted
    ensemble, K5′'s launches)."""
    k5p.group_step.launches = 0
    k5p.group_step_ref.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = make(ENS_ITER).fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, plain = k5p.group_step.launches, k5p.group_step_ref.calls
    gate(launches == ENS_ITER and plain == 0,
         f"16b: {label}: {launches} K5′ launches and {plain} plain calls for {ENS_ITER} epochs",
         phase=16)
    in_loop, syncs = loop_syncs(torch, k5p, lambda: make(ENS_ITER).fit(X, y))
    gate(in_loop == 0, f"16b: {label}: {in_loop} synchronizing operations in the epoch loop",
         phase=16)
    real = k5p.group_step
    k5p.group_step = k5p.group_step_ref
    try:
        plain_est = make(ENS_ITER).fit(X, y)
    finally:
        k5p.group_step = real
    gap = 0.0
    for a, b in zip(est.estimators_, plain_est.estimators_):
        ca, cb = a._state["coef"], b._state["coef"]
        scale = float(cb.abs().max())
        gap = max(gap, float((ca - cb).abs().max()) / scale,
                  float((a._state["intercept"] - b._state["intercept"]).abs().max()) / scale)
    gate(gap <= ENS_RTOL, f"16b: {label}: a member is {gap:.3g}·‖coef‖∞ from the plain "
         "version's fit", phase=16)
    score = est.score(X, y)
    gate(score >= 0.98 * truth, f"16b: {label}: score {score:.5f} below 0.98 of the true "
         f"model's {truth:.5f}", phase=16)
    log(f"phase 16b: {label} on {ENS_ROWS}x{ENS_D}: fit {fit_s:.3f} s on the host clock, "
        f"{launches} K5′ launches (one an epoch), synchronizing operations {syncs} in a fit, "
        f"{in_loop} of them in the epoch loop, score {score:.5f} (the true model "
        f"{truth:.5f}, {score / truth:.4f} of it), members within {gap:.3g}·‖coef‖∞ of the "
        f"plain version's fit [{card}]")
    wall_ms, per_name = device_profile(torch, lambda: make(ENS_ITER).fit(X, y))
    log_profile(f"phase 16b: {label}, profiled fit", wall_ms, per_name, card)
    return est, launches


def ensemble_main_path(torch, k5p, device, card):
    """16b: the three ensembles on one dataset; returns the data, the fitted
    ensembles and K5′'s launches by target width."""
    t0 = time.perf_counter()
    X, y, y10, yr, w, W = ens_standin(torch, device)
    torch.cuda.synchronize()
    log(f"phase 16: {ENS_ROWS}x{ENS_D} float32 on the card in {time.perf_counter() - t0:.2f} s "
        f"[{card}]")
    xw = X.data @ w
    truths = (float(((xw > 0).to(torch.float32) == y.data).to(torch.float32).mean()),
              float((torch.argmax(X.data @ W, dim=1).to(torch.float32) == y10.data)
                    .to(torch.float32).mean()),
              float(1.0 - torch.sum((yr.data - xw) ** 2)
                    / torch.sum((yr.data - yr.data.mean()) ** 2)))
    del xw
    fits, launches = [], {1: 0, ENS_K: 0}
    for (label, make), target, truth in zip(ens_makers(), (y, y10, yr), truths):
        est, n = ensemble_fit(torch, k5p, label, make, X, target, truth, card)
        fits.append(est)
        launches[ENS_K if target is y10 else 1] += n
    return X, (y, y10, yr), fits, launches


def encoded(torch, y, K):
    """±1 one-vs-all targets (n, K) of labels 0..K-1 (K = 1: the binary
    column)."""
    if K == 1:
        return torch.where(y > 0, 1.0, -1.0)[:, None].contiguous()
    return 2.0 * torch.nn.functional.one_hot(y.to(torch.int64), K).to(torch.float32) - 1.0


def group_table(torch, k5p, X, targets, launches, card):
    """16c: K5′ at the main path's shapes, (8, 2^20, 64, 1) and (8, 2^20, 64,
    10) on 16b's X and labels (windows of 2^20 rows, log_loss, l2,
    optimal), held as in 16a, then timed (CUDA events over K5P_REPS
    launches queued behind a device sleep) in turns with 8 launches of K4's
    ``sgd_update`` on the same windows (K5′, K4 x 8, K5′, K4 x 8), beside the
    plain version's time and the bound by bytes (the windows' x, targets
    and masks read once)."""
    from dask_ml_tpu_torch.ops import sgd

    M, B, d = ENS_BLOCKS, ENS_ROWS // ENS_BLOCKS, ENS_D
    starts = tuple(range(0, ENS_ROWS, B))
    masks = X.mask.reshape(M, B)
    gen = torch.Generator(device=X.data.device).manual_seed(ENS_SEED + 2)
    out = []
    for K, y in ((1, targets[0]), (ENS_K, targets[1])):
        Y = encoded(torch, y.data, K)
        coef = torch.randn(M, d, K, generator=gen, device=X.data.device) / d ** 0.5
        intercept = 0.1 * torch.randn(M, K, generator=gen, device=X.data.device)
        t = torch.full((M,), 5.0, device=X.data.device)
        hypers = torch.stack([sgd_hyper(torch, X.data.device)] * M)
        name = "group_step" if K == 1 else f"group_step_K{K}"
        err = hold_group(torch, k5p, (X.data, Y, starts, masks, coef, intercept, t, hypers),
                         f"16c's {name}", "log_loss")
        kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
        c, b, tt = coef.clone(), intercept.clone(), t.clone()
        group = lambda: k5p.group_step(X.data, Y, starts, masks, c, b, tt, hypers, **kw)  # noqa
        k4 = lambda: [sgd.sgd_update(X.data[s:s + B], Y[s:s + B], masks[m], c[m], b[m], tt[m],  # noqa
                                     hypers[m], **kw) for m, s in enumerate(starts)]
        ms, k4_ms = [], []
        for _ in range(2):
            ms.append(queued_ms(torch, group, K5P_REPS))
            k4_ms.append(queued_ms(torch, k4, K5P_REPS))
        plain_ms = time_ms(torch, lambda: k5p.group_step_ref(X.data, Y, starts, masks, c, b, tt,
                                                             hypers, **kw), 3)
        nbytes = M * B * (d + K + 1) * 4 + 2 * M * (d + 1) * K * 4
        b_ms, b_by = bound_ms(nbytes, 4 * M * B * d * K)
        log(f"phase 16c: {name} at ({M}, {B}, {d}, {K}): {ms[0]:.4f}, {ms[1]:.4f} ms "
            f"({b_ms / ms[0]:.1%}, {b_ms / ms[1]:.1%} of the bound); {M} launches of K4's "
            f"sgd_update on the same windows {k4_ms[0]:.4f}, {k4_ms[1]:.4f} ms; plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.4f} GB); "
            f"launches on the path {launches[K]}, max abs err {err:.3g} [{card}]")
        out.append({"name": name, "route": "cuda", "source": "dask_ml_tpu_torch/csrc/sgd.cu",
                    "replaces": "dask_ml_tpu/ensemble/_blockwise.py:64", "launches": launches[K],
                    "max_abs_err": err, "ms": ms[0], "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
        del Y
    return out


def auc64(np, t, s, w):
    """ROC AUC in float64 by distinct scores: each positive's weight times
    the negatives' weight below its score plus half of that at it."""
    vals, inv = np.unique(s, return_inverse=True)
    pos = np.bincount(inv, weights=w * t, minlength=len(vals))
    neg = np.bincount(inv, weights=w * (1 - t), minlength=len(vals))
    below = np.cumsum(neg) - neg
    return float(np.sum(pos * (below + 0.5 * neg)) / (pos.sum() * neg.sum()))


def close(label, got, want, rtol, atol=0.0):
    gate(abs(got - want) <= rtol * abs(want) + atol,
         f"16d: {label} {got!r} against the float64 formula's {want!r}", phase=16)
    return abs(got - want)


def ens_metrics(torch, X, targets, fits, card):
    """16d: the new metrics on 16b's predictions against numpy float64
    versions of their formulas: the binary ensemble's labels (precision,
    recall, F1, the confusion matrix, balanced accuracy, weighted by
    w = k/4, k in 1..4, rtol 1e-12: the counts are exact), ROC AUC of the
    first member's margins rounded to 0.01 (ties) with those weights (AUC
    within 1e-9), log_loss of the 10-class ensemble's probabilities on the
    first METRIC_ROWS rows (rtol 1e-9, float64 in both) and the regression
    metrics of the regressor's predictions (float32 sums on the card: rtol
    1e-5; the median exact)."""
    import numpy as np

    from dask_ml_tpu_torch import metrics

    y, y10, yr = targets
    est, est10, est_r = fits
    n = ENS_ROWS
    t = y.data.cpu().numpy().astype(np.int64)
    pred = est.predict(X)
    p = pred.astype(np.int64)
    w = np.random.RandomState(ENS_SEED).randint(1, 5, n) / 4.0
    t0 = time.perf_counter()
    got = {k: getattr(metrics, f"{k}_score")(y, pred, sample_weight=w)
           for k in ("precision", "recall", "f1")}
    cm = metrics.confusion_matrix(y, pred, sample_weight=w)
    bal = metrics.balanced_accuracy_score(y, pred, sample_weight=w)
    tp, pp, tpos = (w * (t == 1) * (p == 1)).sum(), (w * (p == 1)).sum(), (w * (t == 1)).sum()
    want = {"precision": tp / pp, "recall": tp / tpos}
    want["f1"] = 2 * want["precision"] * want["recall"] / (want["precision"] + want["recall"])
    for k in want:
        close(k, got[k], want[k], 1e-12)
    cm64 = np.array([[(w * (t == i) * (p == j)).sum() for j in (0, 1)] for i in (0, 1)])
    gate(np.allclose(cm, cm64, rtol=1e-12, atol=0), f"16d: confusion_matrix {cm} against "
         f"{cm64}", phase=16)
    close("balanced_accuracy", bal, float(np.mean(np.diag(cm64) / cm64.sum(axis=1))), 1e-12)
    s = torch.round(est.estimators_[0].decision_function(X) * 100.0) / 100.0
    auc = metrics.roc_auc_score(y, s, sample_weight=w)
    gap_auc = close("roc_auc_score", auc, auc64(np, t, s.cpu().numpy().astype(np.float64), w),
                    0.0, 1e-9)
    proba = est10.predict_proba(X.data[:METRIC_ROWS])
    t10 = y10.data[:METRIC_ROWS].cpu().numpy().astype(np.int64)
    ll = metrics.log_loss(t10, proba)
    pc = np.clip(proba, np.finfo(np.float64).eps, 1 - np.finfo(np.float64).eps)
    pc = pc / pc.sum(axis=1, keepdims=True)
    close("log_loss", ll, float(-np.mean(np.log(pc[np.arange(METRIC_ROWS), t10]))), 1e-9)
    pr = est_r.predict(X)
    yt64, pr64 = yr.data.cpu().numpy().astype(np.float64), pr.cpu().numpy().astype(np.float64)
    e = yt64 - pr64
    regs = {"mean_squared_error": np.mean(e ** 2), "mean_absolute_error": np.mean(np.abs(e)),
            "r2_score": 1 - np.sum(e ** 2) / np.sum((yt64 - yt64.mean()) ** 2),
            "explained_variance_score": 1 - np.var(e) / np.var(yt64),
            "mean_absolute_percentage_error": np.mean(np.abs(e) / np.maximum(
                np.abs(yt64), np.finfo(np.float64).eps))}
    for k, v in regs.items():
        close(k, getattr(metrics, k)(yr, pr), float(v), 1e-5)
    close("median_absolute_error", metrics.median_absolute_error(yr, pr),
          float(np.median(np.abs(yr.data.cpu().numpy() - pr.cpu().numpy()))), 1e-7)
    msle = np.mean((np.log1p(np.abs(yt64)) - np.log1p(np.abs(pr64))) ** 2)
    close("mean_squared_log_error", metrics.mean_squared_log_error(yr.data.abs(), pr.abs()),
          float(msle), 1e-5)
    log(f"phase 16d: metrics on {n} predictions against float64 formulas in "
        f"{time.perf_counter() - t0:.2f} s: precision {got['precision']:.6f}, recall "
        f"{got['recall']:.6f}, f1 {got['f1']:.6f}, balanced accuracy {bal:.6f}, roc_auc "
        f"{auc:.9f} (|Δ| {gap_auc:.3g}, {len(np.unique(s.cpu().numpy()))} distinct scores), "
        f"log_loss {ll:.6f} ({METRIC_ROWS} rows, 10 classes), r2 "
        f"{metrics.r2_score(yr, pr):.6f} [{card}]")


def ensemble_phase(torch, device, card):
    """Phase 16 end to end; returns its lines of the kernels table."""
    from dask_ml_tpu_torch.ops import ensemble as k5p

    compare_group(torch, k5p, device)
    X, targets, fits, launches = ensemble_main_path(torch, k5p, device, card)
    out = group_table(torch, k5p, X, targets, launches, card)
    ens_metrics(torch, X, targets, fits, card)
    del X, targets, fits
    torch.cuda.synchronize()
    return out


def main() -> int:
    yardstick = None
    for flag in ("--k4-yardstick", "--k5-yardstick", "--k7k10-yardstick", "--sweep-yardstick"):
        if flag in sys.argv:
            yardstick = flag
            sys.path.insert(0, sys.argv[sys.argv.index(flag) + 1])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from dask_ml_tpu_torch.core import set_device
    from dask_ml_tpu_torch.ops import _build, lloyd, logistic, multiclass
    from dask_ml_tpu_torch.solvers import algorithms

    # 1. environment
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    set_device(device)
    if yardstick == "--k4-yardstick":
        k4_yardstick(torch, device, card)
        return 0
    if yardstick == "--k5-yardstick":
        k5_yardstick(torch, device, card)
        return 0
    if yardstick == "--k7k10-yardstick":
        k7k10_yardstick(torch, device, card)
        return 0
    if yardstick == "--sweep-yardstick":
        sweep_tree_yardstick(torch, device, card)
        return 0
    if "--prep-phase" in sys.argv:
        _build.build(["histogram", "naive_bayes"])
        print(json.dumps({"kernels": prep_phase(torch, device, card)}), flush=True)
        return 0
    if "--ensemble-phase" in sys.argv:
        _build.build(["sgd"])
        print(json.dumps({"kernels": ensemble_phase(torch, device, card)}), flush=True)
        return 0

    # 2. build every kernel source, in parallel
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    _build.build(sources)
    log(f"build: {sources} in {time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in ptxas_lines((_build.BUILD_DIR / f"{src}.ptxas.txt").read_text()):
            log(f"  ptxas {src}: {line}")

    # 3. kernels against their plain versions
    log(f"phase 3: kernels vs plain versions, n={CHECK_ROWS}, rtol {TOL}")
    log(f"phase 3 largest absolute differences: {compare_kernels(torch, lloyd, device)}")
    log(f"phase 3 K2 largest absolute differences: {compare_logistic(torch, logistic, device)}")
    log("phase 3 K2-OvR and K2-MN largest absolute differences: "
        f"{compare_multiclass(torch, multiclass, device)}")

    small_fit(torch, device)

    # 4. the main path
    X, est, launches, (slots, valid) = main_path(torch, lloyd, device, MAIN_ROWS,
                                                 MAIN_D, MAIN_K)
    profiled_fit(torch, lloyd, X, MAIN_K, card)

    # 5. kernels at the main path's shapes: check, time, plain time, bound
    out = kernel_table(torch, lloyd, X, est.cluster_centers_, launches, card)
    reduce_off_path(torch, lloyd, X, OFF_PATH_SHAPES, card)
    candidate_pass(torch, lloyd, X, slots, valid, card)
    del X, est
    torch.cuda.synchronize()

    # 6. the ADMM main path: LogisticRegression on the HIGGS stand-in
    from dask_ml_tpu_torch.core import shard_rows, use_device
    from dask_ml_tpu_torch.linear_model.utils import add_intercept
    t0 = time.perf_counter()
    X, y, w = higgs_standin(torch, HIGGS_ROWS, HIGGS_D, 0, device)
    torch.cuda.synchronize()
    log(f"phase 6: HIGGS stand-in {HIGGS_ROWS}x{HIGGS_D} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    with use_device(device, n_shards=HIGGS_SHARDS):
        est, k2_launches, _, _ = admm_main_path(torch, logistic, algorithms, X, y, w, card)
        acc6 = est.score(X, y)
        plain_fit_check(torch, logistic, X, y, est)
        profiled_admm_fit(torch, algorithms, X, y, card)
        Xi = add_intercept(shard_rows(X))
        fixed_work_rounds(torch, logistic, algorithms, Xi, y, card)
        out += logistic_table(torch, logistic, Xi, y, k2_launches, card)
    del X, Xi, y
    torch.cuda.synchronize()

    # 7. multi-class LogisticRegression: packed one-vs-rest and multinomial
    out += multiclass_phase(torch, multiclass, logistic, algorithms, device, card)

    # 8. K2's other families and bf16 x: LinearRegression, PoissonRegression,
    # a bf16 LogisticRegression and the new solvers
    out += glm_phase(torch, logistic, algorithms, device, card, acc6)

    # 9. TSQR and the decomposition estimators (plain PyTorch, no kernel)
    decomposition_phase(torch, device, card)

    # 10. the streamed SGD through K4: SGDClassifier, SGDRegressor, Incremental
    out += sgd_phase(torch, device, card)

    # 11. the search through K5: HyperbandSearchCV over SGD cohorts
    out += search_phase(torch, device, card)

    # 12. the host-fed stream: files and datasets through the input pipeline to K4
    out += host_stream_phase(torch, device, card)

    # 13. the grid searches: the packed C-sweep through K2-OvR over one shared target
    out += grid_phase(torch, multiclass, logistic, algorithms, device, card)

    # 14. MiniBatchKMeans through K7, the pairwise distances through K10,
    # SpectralClustering's Nystrom path
    out += minibatch_phase(torch, device, card)

    # 15. preprocessing, SimpleImputer and GaussianNB: the quantile sketch
    # through K12, the class moments through K9, the likelihood through K9b
    out += prep_phase(torch, device, card)

    # 16. the blockwise voting ensembles through K5', and the rest of metrics/
    out += ensemble_phase(torch, device, card)

    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
