#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA card and hold its kernels to
their plain PyTorch versions.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # device, builds and kernel-vs-plain only (1-6)

Phases, each of which fails the run when it fails:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``cornac_tpu_torch/csrc/fused_topk.cu``,
   ``cosine_topk.cu``, ``accumulate_rows.cu`` and ``canary.cu`` with nvcc,
   one process each, in parallel, and prints ptxas's registers and spills;
3. fused_topk vs plain: the fused score + top-k kernel against
   ``fused_topk_torch`` on the card, with and without bias, for k in
   {1, 100, 128, 1000, N} and k > N, ties across distant chunks, the
   full serving shape, and small batches whose catalog is split across
   blocks and merged (k above a slice's items, integer ties across
   slices);
4. cosine_topk vs plain: the sparse co-support cosine + top-k kernel
   against ``cosine_topk_torch`` on binary, integer and half-star data
   (exact, index for index), mean-centred data with negative similarities
   (within rtol 1e-5 / atol 1e-6, indices up to near-ties), k = n - 1 and
   k past n, m = 1, all-zero rows, a scipy matrix with explicit zeros and
   duplicates, n above one shared-memory range, and a half-dense matrix
   at the ML-1M widths;
5. accumulate_rows vs plain: the deterministic row-accumulation kernel
   against ``accumulate_rows_torch`` on the CPU, on duplicate-heavy
   batches (16,384 ids into 17,700 and into 480,000 rows, 4,096 ids into
   943 rows, at d = 11, 33 and 51), a 1-D table, d = 200 (column blocks),
   R < B with a run longer than a round of ids, R >> B (over a thousand
   row ranges), ids outside [0, R) (dropped) and strided ids, at the
   four shapes the BPR trainers hand it (the U and V updates at the bench
   shape and at full width) and at the factor family's (NMF's 80,000 ids
   into 943 and 789 rows at d = 15 and 1-D, PMF's 1,024, IBPR's 100 and
   200, COE's 1,000 and 2,000, MF-adam's 256 at d = 10 and 1-D), at the
   neural family's (NeuMF's 256 ids at d = 16 and 8, LightGCN's 1,024 at
   d = 64), at LightGCN's edge form at the ML-10M widths (10,000,054
   ids into 69,878 and into 10,677 rows at d = 64), at HPF's (the same ids
   at d = 5; 80,000 ids into 943 and 789 rows at the bench shape) and at
   FM-SGD's (2,048 ids over the user and the offset item block into 1,732
   feature rows, 1-D and d = 8), bit for bit (on the
   CPU, ``index_add_`` sums each row's updates in batch order and adds
   the sum once, as the kernel does; the gap to the plain version on the
   card, whose ``index_add_`` is atomic, is printed); two launches must
   give the same bits, and the
   profiler must see one kernel per call and nothing else (its device
   time per launch, at the four BPR shapes, is taken here, early: late in
   the process the profiler loses a short kernel's events);
6. canary vs plain: ``csrc/canary.cu`` against ``x * 2``, bit for bit, at
   (128, 128), at sizes that are no multiple of 4, end inside a block or
   span 64M elements, and on views that are not 16-byte aligned (the
   scalar kernel);
7. on-silicon probe (the canary's path): ``tools/cuda_on_silicon.py``'s
   three steps, canary, fused_topk and cosine_topk, each cold and warm
   under its own timeout and held to its plain version;
8. BPR serving slice: a BPR model (k=50 + item bias, so d=51) over
   480,000 users and 17,700 items, random factors from the seed, wrapped
   in TPUExactANN, saved, loaded by ``load_model`` and served by the
   standalone HTTP server on localhost (/recommend, /feedback, /evaluate),
   then ``recommend_batch`` for 8,192 users; every answer is checked
   against lists computed from the same vectors with the plain version;
   then ``TPUExactANN(bpr, mesh=...)`` for those 8,192 users at k=100
   through ``parallel.sharded.sharded_topk``, on the (data, model) mesh of
   one rank over NCCL that ``make_mesh`` starts in this process (before
   phase 8, after the bench processes are spawned, which never join it),
   the plain index's ids and distances;
9. KNN slice at the MovieLens 1M widths (6,040 users x 3,706 items,
   1,000,209 seeded whole-star ratings): RatioSplit -> Experiment with
   ItemKNN(k=50) and UserKNN(k=50) on Recall@10, NDCG@10 and AUC ->
   nearest_items / nearest_users (kernel launches, held exactly to the
   plain version) -> the ItemKNN saved and served by the standalone server;
10. related items at the MovieLens 10M widths (69,878 users x 10,677 items,
   10,000,054 seeded half-star ratings): ItemKNN(k=50).fit and
   nearest_items(50) (which builds no dense W: its peak device memory is
   checked), held exactly to the plain version;
10b. LightGCN's edge form at those widths (``NormAdjacency`` of that train
   set, 10,000,054 edges, d = 64): one propagation step forward and
   backward (4 accumulate_rows launches) and the 3-layer mean forward and
   backward; the step's four outputs held bit for bit to the same step on
   the CPU (where accumulate_rows is its plain version), two calls bit for
   bit; times beside the plain version on the card (``index_add_``), four
   cuSPARSE products and the bound; then ``NormAdjacency(mesh=...)`` on the
   world-size-1 NCCL mesh (12 accumulate_rows launches): the 3-layer mean
   forward and backward equal to the plain adjacency's, bit for bit, timed
   beside it;
10c. HPF at those widths (``examples/hpf_movielens.py``: k = 5, seed 123)
   on phase 10's train set: fits of 1 and 3 sweeps held to the same fits
   on the CPU (rtol 3e-5), the first sweep's two accumulate_rows inputs
   held bit for bit to the plain version on the CPU and timed, a second
   3-sweep fit bit for bit, the 100-sweep fit timed (seconds per sweep
   beside the byte bound, the busy share, peak device memory), then
   recommend_batch of 8,192 users at k = 100 through fused_topk at d = 5,
   every list held to the plain version;
11. trainers at the bench.py shape (``make_ml100k_like(seed=7)``, 943 users
   x 1,682 items, 100,000 ratings): RatioSplit(0.2, 4.0, seed=123) ->
   BPR(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01,
   seed=123, batch_size=4096).fit -> ranking_eval (AUC, MAP, NDCG@10, P@10,
   R@10), timed after a one-epoch warm-up; AUC and NDCG@10 must fall in the
   band of the JAX package's CPU runs (``tools/bpr_quality_band.py``); a
   second fit with the same seed and verbose=True must give the same
   factors, bit for bit; ``RatioSplit(mesh=...)`` on that mesh evaluating
   the fitted BPR, its AUC, NDCG@10 and Recall@5 equal to the plain split's
   exactly; then one Experiment with BPR, MMMF, WBPR,
   MF(k=10, max_iter=20), BaselineOnly, GlobalAvg and MostPop on those
   metrics and RMSE, MAE;
12. factor family at the bench shape: one Experiment with
   ``benchmarks/model_sweep.py``'s PMF, NMF, WMF, EASE, IBPR, COE and
   MF(optimizer="adam", dropout=0.1) on AUC, NDCG@10, Recall@10, RMSE and
   MAE: each model's AUC and NDCG@10 in the band of the JAX package's CPU
   fits (``tools/bpr_quality_band.py --model``), fit seconds per model,
   fused_topk behind each model's serving entry point held to the plain
   version, a second seeded fit of each (verbose) bit for bit, whose
   accumulate_rows inputs (the first at each shape) are held to the plain
   version on the CPU, bit for bit (IBPR's and MF-adam's second fits, and
   the first they are held to, run 2 epochs); the profile of one IBPR
   epoch over the first 5,000 ratings;
12b. neural family at the bench shape: one Experiment with
   ``benchmarks/model_sweep.py``'s VAECF, RecVAE, BiVAECF and NeuMF, GMF
   and MLP at NeuMF's depth, LightGCN, and NGCF at LightGCN's, on AUC,
   NDCG@10 and Recall@10, each AUC and NDCG@10 in the band of the JAX
   package's CPU fits, fit seconds per model, fused_topk behind
   BiVAECF's recommend_batch held to the plain version, VAECF's
   recommend_batch(k > 0) refused as the JAX package refuses it; two
   seeded fits of each at 2 epochs (the second verbose) bit for bit,
   whose accumulate_rows inputs are held to the plain version on the CPU; the
   profile of one NeuMF epoch over the first 5,000 ratings;
13. trainer at full width (``benchmarks/scale_10m.py``'s configuration:
   100,000 users x 10,000 items, about 10M unique seeded pairs, so the
   membership test is the CSR binary search): BPR(k=32, batch_size=16384,
   seed=123), one warm epoch, one epoch of ``BPR(mesh=...)`` on that mesh
   held bit for bit to the plain 1-epoch fit (both fits' seconds printed,
   the mesh epoch's as a 1-epoch minus a 0-epoch fit), then 10 timed
   epochs; samples/s beside the
   byte bound of a sample, launches per minibatch and the device-busy
   share; then ``recommend_batch`` for 8,192 users at k=100 through
   fused_topk, every list held to the plain version;
14. WMF at the Netflix widths (``benchmarks/scale_netflix.py:130-157``:
   480,000 x 17,700, k=64, cut to 20M seeded pairs): a 3-sweep fit, then
   one warm and two timed sweeps beside the FLOP bound, peak device
   memory, recommend_batch of 8,192 users at k=100, TPUExactANN with
   recall_target=0.95 and the bf16 route, each held to the plain version;
   then one sweep of ``WMF(mesh=...)`` (k = 64) on the world-size-1 mesh,
   which solves its share of the degree buckets' chunks, beside a plain
   one-sweep fit, bit for bit; each fit's peak device memory;
14b. VAECF at the Netflix widths (``benchmarks/vaecf_sparse_stream.py:38-39``:
   k=32, [100], batch 1,024, lr 0.001, seed 1) on phase 14's 20M pairs, in
   the index-resident mode: fits of 1 and of 4 epochs, seconds per steady
   epoch ((4 - 1) / 3) beside the FP32 FLOP bound, peak device memory;
   score_batch of 8,192 users, their top-100 held to a float64 scoring of
   the same parameters, and recommend for one user;
12c. the factor family's rest at the bench shape: one Experiment with
   ``benchmarks/model_sweep.py``'s HPF, SKMeans and FM (als), PF, FM's sgd
   and mcmc learners at ``examples/fm_example.py``'s settings and
   ``examples/sansa_movielens.py``'s SANSA on AUC, NDCG@10, Recall@10, RMSE
   and MAE: each AUC and NDCG@10 (and FM's RMSE) in the band of the JAX
   package's CPU fits, fit seconds per model, fused_topk behind HPF's, PF's
   and SANSA's recommend_batch held to the plain version, a second seeded
   fit of each bit for bit, whose accumulate_rows inputs are held to the
   plain version on the CPU; one FM-ALS sweep held to the CPU's and
   ``_seg_sum`` beside accumulate_rows (error against float64, time);
12d. the protocols at the bench shape, in the same process:
   CrossValidation(5 folds, seed 123) over MF(k=10, max_iter=25) and
   PMF(k=10, max_iter=100) on MAE and RMSE; StratifiedSplit (by user,
   chronological) and TimestampSplit (ratio mode) on the bench data with
   seeded timestamps and PropensityStratifiedEvaluation (2 strata), each an
   Experiment with HPF and MostPop; GridSearch and RandomSearch (4 trials)
   over HPF's k and hierarchical on validation AUC. The folds, splits and
   strata are held to the same protocols built on the CPU, each search's
   trials (within 1e-4) and best_params to the same search on the CPU;
15. SBPR at the Epinions widths (``examples/sbpr_epinions.py``: k = 10, lr
   0.001, seed 123; seeded data at Cornac's Epinions counts, 40,163 users x
   139,738 items, 664,824 star ratings, 487,183 trust edges), after phase
   10c: RatioSplit(0.1, 0.5) with the user graph, the split and the social
   arrays timed on the host, the membership structure and its bytes
   printed; the first minibatch's five accumulate_rows inputs held bit for
   bit to the plain version on the CPU and timed beside ``index_add_``; two
   seeded 2-epoch fits bit for bit; the 4-epoch fit (the example's 50, cut
   for the run's time) timed (seconds per epoch, samples/s
   beside the byte bound of a sample, device events per minibatch and the
   busy share of one epoch, peak device memory); a fit with checkpoints
   every 2 epochs stopped at 2 and resumed to 4, equal to the
   uninterrupted one bit for bit; ranking_eval's AUC, NDCG@10 and Recall@10 over the first 4,096 test
   users (all of them while that takes 15 s or less; 26-30 s on the host,
   cut for the run's time); recommend_batch of 8,192 users at k = 100 through fused_topk
   (d = 11), every list held to the plain version;
15b. C2PF at the Amazon Office widths (``examples/c2pf_example.py``: k =
   100, 80 sweeps then 16; seeded data at Cornac's counts, 3,703 users x
   6,523 items, 53,282 ratings) with the item graph of
   ``GraphModality.from_feature(k=10, symmetric=True)`` over seeded
   features: fits of max_iter 1 and 3 held to the CPU's (rtol 1e-4), the
   first sweep's nine accumulate_rows inputs held bit for bit and timed
   beside ``index_add_``, a second fit bit for bit, ms a sweep beside its
   byte bound, peak memory, the example's Experiment (MAE, RMSE, P@10, R@10,
   NDCG@10), recommend_batch of 8,192 users (with replacement) through
   fused_topk at d = 100, held to the plain version;
12e. the modality layer's models at the bench shape, in a sixth spawned
   process: SBPR, VEBPR and C2PF (c2pf, tc2pf, rc2pf) on
   ``tests/golden_models.py``'s block data (user graph, purchases and views,
   item graph), each train AUC in the band of the JAX package's CPU fits,
   seeded refits bit for bit with their accumulate_rows inputs held to the
   plain version; ``Experiment(checkpoint_dir=...)`` with bench.py's BPR,
   MF and VAECF (checkpoints every 50 epochs), and BPR stopped at epoch 100
   and resumed to 200 equal to the Experiment's, bit for bit;
16. SASRec at the Diginetica counts (``examples/sasrec_example.py``: d =
   64, 2 blocks, 1 head, max_len 50, batch 128, lr 0.001, seed 123, the
   class defaults otherwise; sessions seeded at SR-GNN's Diginetica counts,
   982,961 clicks, 43,097 items, 60,858 test sessions, mean length 5.12,
   each session its own user), after the serving slice:
   ``NextItemEvaluation.from_splits(fmt="USIT", exclude_unknowns=True,
   mode="last")``; a fit of 1 epoch over the first half of the train
   sessions (the example's 10 epochs over all of them cut to that, to keep
   the whole run inside its time limit): ms a step from CUDA events over
   its steady steps, the steady epoch and training sequences per second
   from it, beside the bound of a step, its last 5 steps profiled (device
   events a step, busy share); the first step's three accumulate_rows
   inputs held bit for bit to the plain version on the CPU and timed
   beside ``index_add_``; peak device memory; the NextItemEvaluation
   metrics (MRR, HitRatio@20, NDCG@20) and seconds; 64 histories' scores
   held to a float64 scoring on the CPU; on the first 3,200 train sessions
   at the same widths, a 2-epoch fit's epoch-1 checkpoint equal to a
   second seeded fit of 1 epoch, and that fit resumed to 2 held to the
   uninterrupted one, bit for bit;
16b. TransformerRec at the Diginetica widths (``examples/
   transformer_rec_diginetica.py``: BERT4Rec and a gpt2/clm TransformerRec,
   d = 64, 2 blocks of 2 heads, max_len 50, 128 sessions a step, the class
   defaults otherwise) on phase 16's split: trained on the first 6,400 train
   sessions over the whole item table, after a warm-up fit of two steps
   a fit of 2 epochs (the example's 10 cut), seconds per epoch (its last) and
   training sequences/s beside the bound of a step
   (``transformer_step_bound``), one epoch over 640 sessions profiled
   (device events a step, busy share), peak device memory, ``NextItemEvaluation``
   over the first 2,048 test sessions (MRR, HitRatio@20, NDCG@20), 64
   histories' scores held to a float64 scoring on the CPU, the first step's
   five accumulate_rows inputs held bit for bit to the plain version on the
   CPU and timed beside ``index_add_``;
16c. TIGER at ``examples/tiger_example.py``'s settings (rqvae, 3 levels of
   256 codes, d_model 128, d_ff 1,024, seed 123, the class defaults
   otherwise) on ``NextItemEvaluation.leave_last_out`` of
   ``make_ml100k_like(7)`` (the generation order as timestamps) with seeded
   TF-IDF-like features (1,682 x 512; the plots are not in the repository):
   one fit of 1 seq2seq epoch (the example's 20 cut) on the first half of
   the users' sessions after the RQ-VAE's 200 epochs, each epoch timed, the
   RQ-VAE's seconds, its dead codes restarted, the collision level, seconds
   of the (first, cold) seq2seq epoch and ms a step over its steps after the
   first 40 (CUDA events) beside ``tiger_step_bound``, 4 steps
   profiled, peak device memory, the beam
   evaluation (HitRatio@10, NDCG@10), 64 histories' beam scores and 4
   histories' exact scores held to the same scoring on the CPU, the first
   RQ-VAE and seq2seq steps' accumulate_rows inputs held bit for bit and
   timed;
17. the next-basket family at the Ta Feng counts (``tools/seq_bench_data.py::
   tafeng_like``: 32,266 customers, 23,812 products, about 817,741 purchase
   lines; the files are not in the repository), after the serving slice:
   ``NextBasketEvaluation(test_size=0.2, seed=123)`` with GPTop as GTop, PTop
   and GPTop (repetition and exploration breakdowns), TIFUKNN, UPCF, Beacon
   and DNNTSP at the ``examples/*_tafeng.py`` settings, each through
   ``evaluate`` (Recall@10, Recall@50, HitRatio@10; fit and evaluation
   seconds, peak device memory); Beacon and DNNTSP fit 1 epoch (the
   examples' 15 and 30 cut to 1): ms a step from CUDA events over the
   steady steps, the steady epoch and training sequences/s from it beside
   the bound of a step, the fit's last 5 steps profiled (device events a
   step, busy share); DNNTSP's first step's three
   accumulate_rows inputs held bit for bit to the plain version on the CPU;
   8 histories' scores of each held to a float64 scoring of the same
   parameters; the family's host loops timed on their own;
12f. the next-item models, CVAECF and GCMC at the bench shapes, in a
   seventh spawned process: SPop, FPMC, GRU4Rec and SASRec on
   ``tools/seq_bench_data.py``'s sessions (2,000 sessions over 500 items,
   NextItemEvaluation mode 'next'), CVAECF with a seeded user graph and
   GCMC on ``make_ml100k_like(7)``, each metric in the band of the JAX
   package's CPU fits, seeded refits bit for bit with their
   accumulate_rows inputs held to the plain version; one GRU4Rec epoch on
   draws made on the CPU, on the card and on the CPU from the same
   parameters, every parameter within 1e-5 (``gru4rec_witness``, with and
   without dropout); the native reader on
   a UIRT file the phase writes (the native path taken, the line-by-line
   parser's tuples);
12g. the next-basket family at the bench shape, in an eighth spawned
   process: GPTop, TIFUKNN and UPCF on ``gen_baskets``' baskets and on
   ``tests/data/basket.txt`` scored on the card equal to the CPU's, TIFUKNN's
   neighbour sets identical but for members at a near-tie (rtol 1e-5) of the
   last distance; Beacon and DNNTSP at the Ta Feng examples'
   settings, each metric in the band of the JAX package's CPU fits over ten
   seeds, seeded refits bit for bit with their accumulate_rows inputs held to
   the plain version; one epoch of each on draws made on the CPU, on the card
   and on the CPU from the same parameters, every parameter within 1e-5
   (``basket_witness``; DNNTSP's three biases of zero exact gradient held to
   Adam's step bound instead);
12h. the generative next-item models at the bench shape, in a ninth spawned
   process: BERT4Rec, TransformerRec (clm at 'all' and 'last', plm, rtd),
   TIGER with rqvae and beam scoring and with rkmeans and exact scoring on
   ``gen_sessions``' sessions (TIGER over ``seq_bench_data.session_features``),
   each metric in the band of the JAX package's CPU fits over ten seeds,
   seeded refits bit for bit with their accumulate_rows inputs held to the
   plain version, BERT4Rec and TIGER-rkmeans stopped at epoch 1 and resumed
   bit for bit, TIGER-rkmeans' semantic IDs equal to the CPU's bytes; one
   epoch of BERT4Rec, of TIGER's RQ-VAE and of its seq2seq on draws made on
   the CPU, on the card and on the CPU, every parameter within 1e-5 (the
   card's BERT4Rec epoch held instead to the CPU's float64 epoch, within
   the CPU float32 epoch's own distance from it, the parameters more than
   1e-5 away named) (``generative_witness``);
18b. SoRec, MCF and PCRL on data already built, after phase 15b: SoRec at
   ``examples/sorec_filmtrust.py``'s settings (k = 5, lr 0.001, lambda_c 10,
   batch 1,024; 2 of its 100 epochs, each timed) on phase 15's Epinions split
   with its trust graph, 20 rating-stream steps profiled (device events a
   step, busy share), MAE and RMSE, a second seeded fit bit for bit; MCF
   (``examples/mcf_office.py``: k = 10, 40 iterations) and PCRL
   (``examples/pcrl_example.py``: k = 100, z_dims [300], batch 300, 60
   iterations) on phase 15b's Amazon Office split with its item graph, fits
   timed, Precision, Recall and NDCG@10; each of the three serving 1,024
   users at k = 100 through fused_topk, held to the plain version;
18. VBPR at Cornac's Tradesy counts (19,243 users, 165,906 items, 394,421
   seeded binary feedback; seeded 4,096-wide non-negative visual features,
   made on the card, 2.72 GB there during the fit), ``examples/
   vbpr_tradesy.py``'s split and settings (k = 10, k2 = 20, batch 100, lr
   0.005, lambda_w 1, lambda_b 0.01), 1 of its 50 epochs over the first
   half of the train feedback: the split with
   ``ImageModality(normalized=True)`` timed on the host, the steps after the
   first 100 timed with CUDA events beside the bound of a step (Adam's 28 B
   a parameter and the triplets' feature rows), 20 steps profiled (device
   events a step, busy share), peak device memory; ranking_eval's AUC and
   Recall@50 (over the first 4,096 test users when all would take more than
   30 s); recommend_batch of 8,192 users through fused_topk at d = 31, held
   to the plain version;
18c. at Cornac's Amazon Clothing counts (5,377 users, 3,393 items, 13,689
   seeded star ratings, seeded 4,096-wide features and a seeded corpus),
   in this process (short and host-bound, it would crowd the processes
   beside phase 16): AMR, CausalRec and VMF on RatioSplit(0.1, 0.5) with the
   image modality and DMRL on RatioSplit(0.2, 0.5) with the text (TF-IDF
   over the corpus' count matrix) and image modalities, each at its
   example's settings, through ``evaluate`` (AMR and CausalRec at 3 of their
   50 epochs, VMF at 5 of its 100, DMRL at its 20); AMR serving 1,024 users
   through fused_topk, held to the plain version;
12i. the side-information models at the bench shape, in a tenth spawned
   process: SoRec, MCF, VBPR, AMR, CausalRec, VMF, DMRL and PCRL on
   ``make_ml100k_like(7)`` with ``seq_bench_data.side_modalities`` (a seeded
   trust graph, 64-wide image-like features, their k-NN item graph,
   TF-IDF-like text) at ``tools/bpr_quality_band.py``'s ``SIDE_CONFIGS``,
   each AUC and NDCG@10 in the band of the JAX package's CPU fits over ten
   seeds, SoRec's and MCF's tables held to the JAX fit's own (its first rows
   and column sums), seeded refits bit for bit with their accumulate_rows
   inputs held to the plain version; one VBPR and one AMR epoch on draws
   made on the CPU, on the card and on the CPU, every parameter within 1e-5
   (``visual_witness``);
19. the item-text models at citeulike-a's counts (5,551 users, 16,980 items,
   204,986 seeded pairs with mild skews, the largest degrees in the
   hundreds, a seeded abstract an item), after 18c: the four CiteULike
   examples' split (RatioSplit(0.2, 0.5) with ``TextModality(max_vocab=8000,
   max_doc_freq=0.5)``, timed on the host) and settings, CDL at 1 of its 30
   epochs, CDR at 1 of 30 over the first half of the train pairs, CVAE at 1
   of 30 and CTR at 1 of its 50 iterations (``CITEULIKE_MODELS``), each fit
   timed with its peak device
   memory, NDCG@100 and Recall@300 over the first 2,048 test users (all of
   them while that takes 15 s or less), each serving 1,024 users at k = 100
   through fused_topk, held to the plain version;
19b. NARRE and HRDR at Cornac's Amazon Digital Music counts (5,541 users,
   3,568 items, 64,706 seeded star ratings skewed toward 4-5, a seeded
   review each, most past 50 tokens): ``examples/narre_example.py``'s and
   ``hrdr_example.py``'s split (RatioSplit(0.2) with
   ``ReviewModality(max_vocab=4000, max_doc_freq=0.5)``) and settings
   (embedding 100, ids 32, 32 factors, attention 16, 64 filters of width 3,
   L 50, R 32, batch 64, Adam), 1 of their 10 epochs each over the first
   half of the train ratings: the steps after
   the first 100 timed with CUDA events beside the bound of a step (the text
   CNN's FLOPs forward and backward, Adam's bytes), the first step's
   word-table gradient held bit for bit to the plain version on the CPU and
   timed with the empty review slots dropped (as the fit runs it) and summed
   into the padding row (NARRE's), the same bits either way, 5 steps
   profiled (device events a step, busy share), peak device memory; MAE and RMSE
   over the test ratings, NDCG@10 over the test users; each serving 1,024
   users at k = 100 through fused_topk, held to the plain version;
19c. ConvMF and HFT at ``conv_mf_example.py``'s and ``hft_example.py``'s
   settings (HFT at 8 of its 40 iterations) on ``make_ml100k_like(7)``
   with seeded plots for its 1,682 items, each through ``evaluate``; the
   first CNN step's embedding gradient held bit for bit to the plain version
   on the CPU and timed; HFT serving its 943 train users through fused_topk,
   held to the plain version;
12j. the text and review models at the bench shape, in an eleventh
   spawned process (the first of the four that wait for a worker): NARRE, HRDR, CDL, CDR, CVAE, ConvMF, CTR and HFT on
   ``make_ml100k_like(7)`` with ``seq_bench_data.text_modalities`` (a seeded
   document an item, a seeded review a rating) at
   ``tools/bpr_quality_band.py``'s ``TEXT_CONFIGS``, each AUC and NDCG@10
   (NARRE's and HRDR's RMSE too) in the band of the JAX package's CPU fits
   over ten seeds, ConvMF's, CTR's and HFT's tables held to the JAX fit's
   own (their first rows and column sums), seeded refits bit for bit with
   their accumulate_rows inputs held to the plain version; one CDL and one CDR
   epoch on draws made on the CPU, on the card within twice the CPU float32
   epoch's distance from the CPU's float64 epoch (``text_witness``), and one
   NARRE and one HRDR epoch on the CPU with each step's gradients computed
   again on the card from the CPU's parameters, within 1e-4 of each tensor's
   largest (``review_witness``: a float32 epoch of these models is chaotic);
20. the sentiment and explainable models at the Amazon Toys & Games 5-core
   counts (19,412 users, 11,924 items, 167,597 seeded star ratings with
   seeded timestamps, one to four seeded (aspect, opinion, polarity) tuples
   each over an assumed lexicon of 200 aspects and 500 opinions), after
   19c: the examples' split (RatioSplit(0.15), TriRank's 0.2) and settings
   (``TOYS_MODELS``): EFM and ComparERObj at 40 explicit and 60 latent
   factors for 100 and 5 iterations (the examples' 100), MTER, ComparERSub, LRPPM and Companion
   at 150 iterations each (the examples' 10,000, 200,000, 20,000 and
   500,000), TriRank's 100 power iterations, HypAR at its defaults for 12
   steps (its epoch has some 1,113); every host build timed; ms an iteration (a step) by CUDA
   events, device events a call and the busy share over 3 profiled (HypAR's
   2); peak
   device memory; NDCG@50 (and RMSE for the rating models) over the first
   500 test users; the accumulate_rows inputs of HypAR's first step (its
   first hyperedge scatters into the review rows and into the node rows)
   and of Companion's first item-table update recorded from the fits and
   held bit for bit to the plain version on the CPU (phase 21 times them);
   the stemmer HypAR ran printed;
12k. the sentiment and explainable models at the bench shape, in a twelfth
   spawned process (the second queued): EFM, ComparERObj, MTER, ComparERSub,
   LRPPM, Companion, TriRank and HypAR on ``make_ml100k_like(7)`` with
   seeded timestamps and sentiment (``bpr_quality_band.sentiment_split``;
   the ComparER models on its first 150 users) at ``SENTIMENT_CONFIGS``,
   each AUC and NDCG@10 (RMSE for the rating models) in the band of the JAX
   package's CPU fits over ten seeds (LRPPM's thirty), seeded refits bit for
   bit with their accumulate_rows inputs held to the plain version; one
   iteration of each sampled fit on the CPU's draws, its gradients on the
   card held to the CPU's and its step to the CPU's step on the card's
   gradients, and one HypAR step's gradients held to float64
   (``sentiment_witness``);
21. times: each kernel, its plain version and library yardsticks
   (``torch.matmul`` + ``torch.topk``; for the cosine also cuSPARSE
   products through ``torch.sparse``; for accumulate_rows ``index_add_``,
   atomic, and ``index_add_`` in PyTorch's deterministic mode, whose bits
   over two launches and whether it runs without a sync are recorded)
   with CUDA events, beside the bound; fused_topk at B = 1, 256 and 8192,
   fused_topk also at HPF's d = 5 (B = 8192 over the ML-10M catalog),
   SBPR's d = 11 over Epinions', C2PF's d = 100 over Amazon Office's and
   VBPR's d = 31 over Tradesy's,
   cosine_topk at both ML-1M shapes, a half-dense ML-1M-wide matrix and
   ML-10M, where two launches must give the same bits; accumulate_rows at
   the labelled shapes of phase 5 (the BPR trainers' four, NeuMF's and
   LightGCN's at the bench shape, LightGCN's and HPF's two each at ML-10M,
   SBPR's three at Epinions, C2PF's three at Amazon Office, SASRec's two
   embedding gradients and FPMC's item-table scatter at the Diginetica
   widths, BERT4Rec's embedding and output-bias gradients there, TIGER's
   token table and an RQ-VAE codebook at the example's settings, GCMC's two
   edge sums at the bench shape, VBPR's item-factor gradient at Tradesy,
   SoRec's trust stream at Epinions, MCF's item-graph stream at Amazon
   Office, DMRL's item embeddings at Amazon Clothing, NARRE's word table
   with the empty review slots dropped and summed into the padding row at
   the Digital Music widths, ConvMF's embeddings at the ML-100K plots',
   and the inputs phase 20 recorded from HypAR's and Companion's fits at
   the Amazon Toys counts), on
   the inputs phase 5 (phase 20) checked; the canary at (128, 128) beside ``torch.mul`` and ``x *
   2``, each call split into its device time (the profiler's, and CUDA
   events around one call) and its host time, the canary's host time into
   its steps.

12l. the factor and neural families' ``mesh=`` (ROADMAP A8 (b)) at the
   bench shape, in a thirteenth spawned process, on a world-size-1 NCCL
   mesh of its own: PMF, NMF, WMF, IBPR, OnlineIBPR, COE, HPF, PF, FM-als
   and FM-sgd at ``factor_configs``' and ``factor_rest_configs``' widths,
   SBPR, VEBPR (seeded views) and the three C2PF at ``GOLDEN_CONFIGS``',
   the neural family at ``neural_configs``', CVAECF and GCMC at
   ``AUX_CONFIGS``', on ``RatioSplit(0.2, 4.0, seed=123)`` with
   ``seq_bench_data.side_modalities``' graphs: each at one epoch or sweep
   fitted with the mesh and without, the two bit for bit, each pair's
   seconds;
   the fitted models with vectors serving 256 users through fused_topk,
   held to the plain version. Then (``phase_mesh_seq_side``) the A8 (c)
   configurations and the side-information half of A8 (d) at the bench
   shapes of 12f, 12g, 12h and 12i (``MESH_SEQ_SIDE``: FPMC, GRU4Rec,
   SASRec, BERT4Rec, a gpt2/clm TransformerRec, TIGER-rkmeans, Beacon,
   DNNTSP, SoRec, MCF, VBPR, AMR, CausalRec, VMF, DMRL and PCRL), one epoch
   or iteration each with the mesh and without, bit for bit, each pair's
   seconds; SASRec and DNNTSP fitted and scored by
   ``NextItemEvaluation(mesh=)`` and ``NextBasketEvaluation(mesh=)``, the
   plain protocols' metrics; 64 histories' scores of each next-item and
   basket model on the mesh equal to the plain model's; the side models
   with vectors serving 256 users through fused_topk. Phases 16, 16b,
   16c, 17, 18, 18b and 18c each end with one mesh/plain pair of each of
   their A8 (c) or side-information models at their full widths on the
   main process's mesh, a few minibatches of the phase's rows over its
   whole catalog, bit for bit (``full_width_pair``). Then
   (``phase_mesh_text_sentiment``) the text, review and sentiment models
   (the rest of A8 (d)) at the bench shapes of 12j and 12k
   (``MESH_TEXT_SENTIMENT``), one epoch, sweep or a few iterations each with
   the mesh and without: EFM, ComparERObj, MTER, ComparERSub, LRPPM,
   Companion, CTR, CDL, CDR, CVAE, ConvMF, NARRE, HRDR and HypAR bit for
   bit (at world size 1 a share of a minibatch is the whole of it, and the
   fit runs the plain operations); CDL, CDR, CVAE, CTR, NARRE and HRDR
   serving 256 users through fused_topk. Phases 19, 19b, 19c and 20 each
   end with one mesh/plain pair of each of their models (but HFT and
   TriRank, which take no mesh) at their full widths, bit for bit
   (``full_width_pair``; phase 20's on two iterations or steps with the
   phase's own host builds, ``reused_builds``).

Phases 12, 12b, 12c-12d, 12e, 12f, 12g, 12h, 12i, 12j, 12k and 12l run in
thirteen spawned processes, eight at a time (the factor family, three groups of the neural
family, the factor family's rest with the protocols, the mesh fits,
the modality layer's
models with the checkpointed Experiment, the next-item models with CVAECF
and GCMC, the next-basket models, the generative next-item models, the
side-information models, the text and review models and the sentiment
models), at a lower CPU
priority, beside phases 17, 16c and 16, and are collected before 16b. This
process runs 8, then 17, 16c, 16 (beside them), 16b, then 9-15b in the order
9, 10, 10b, 10c, 15, 15b, then 18b, 18, 18c, 19, 19b, 19c, 20, 11, 13, 14,
14b, then 21. The card time-slices between processes and they share the
host's cores: the times of phases 17, 16c and 16 carry that load (their
host-bound steps lose the host's share, Beacon's card-bound steps the
card's slices as well), every other time runs alone, and the thirteen
processes' own fit seconds and busy shares carry each other's load.

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers (fused_topk once per batch size, B = 8192 first,
then at HPF's d = 5, SBPR's d = 11, C2PF's d = 100 and VBPR's d = 31;
accumulate_rows at the full-width V update, LightGCN's and HPF's two ML-10M
shapes each, SBPR's V update, C2PF's ratings into the item rows, SASRec's
two embedding gradients, FPMC's item-table scatter, BERT4Rec's two
gradients, TIGER's token table and RQ-VAE codebook, GCMC's two edge sums,
VBPR's item-factor gradient, SoRec's trust stream, MCF's item-graph stream,
DMRL's item embeddings, NARRE's word table both ways, ConvMF's
embeddings, HypAR's two hyperedge scatters and Companion's item-table
update as their fits at Amazon Toys handed them to the kernel),
and ``{"ok": true, "device": {...}}``. The
script imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import copy
import functools
import itertools
import json
import multiprocessing
import os
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))
try:
    from card_measure import (PEAK_BYTES, PEAK_F32_FLOPS, card_line, compare_topk,
                              library_cosine_topk, plain_scores, time_ms)
    from quality_bands import band, seq_band
except ImportError:
    sys.exit("chip_smoke: run it from a checkout that holds tools/ and cornac_tpu_torch/")

N_USERS, N_ITEMS, FACTORS, TOPK, SERVE_BATCH = 480_000, 17_700, 50, 100, 8192
N_INTERACTIONS = 1_000_000  # Netflix has ~100M; cut so Dataset.build stays quick
RTOL = ATOL = 1e-5
DEV = "cuda"
# benchmarks/scale_10m.py's configuration, the full-width trainer phase
FULL_USERS, FULL_ITEMS, FULL_DRAWS, FULL_K, FULL_BATCH = 100_000, 10_000, 10_000_000, 32, 16_384
ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS = 69_878, 10_677, 10_000_054
# Cornac's published Epinions and Amazon Office counts (phases 15, 15b)
EPINIONS_USERS, EPINIONS_ITEMS, EPINIONS_RATINGS, EPINIONS_TRUST = (
    40_163, 139_738, 664_824, 487_183)
OFFICE_USERS, OFFICE_ITEMS, OFFICE_RATINGS = 3_703, 6_523, 53_282
# Cornac's published Tradesy and Amazon Clothing counts (cornac/datasets/
# README.md; phases 18 and 18c): users, items, feedback, and the width of
# their CNN visual features
TRADESY_USERS, TRADESY_ITEMS, TRADESY_FEEDBACK = 19_243, 165_906, 394_421
CLOTHING_USERS, CLOTHING_ITEMS, CLOTHING_RATINGS = 5_377, 3_393, 13_689
VISUAL_WIDTH = 4_096
# the Amazon Toys & Games 5-core counts (McAuley et al., SIGIR 2015; the data
# Cornac's amazon_toy loader reads) (phase 20), and the lexicon's size, an
# assumption: the repository does not record it
TOYS_USERS, TOYS_ITEMS, TOYS_RATINGS = 19_412, 11_924, 167_597
TOYS_ASPECTS, TOYS_OPINIONS = 200, 500
# Diginetica's counts as SR-GNN (Wu et al., AAAI 2019, Table 1) reports them
# (phase 16): clicks, items, test sessions, mean session length
DIGI_CLICKS, DIGI_ITEMS, DIGI_TEST, DIGI_MEAN_LEN = 982_961, 43_097, 60_858, 5.12


def log(msg):
    print(msg, flush=True)


# a copy of bench.py's generator (tests/test_torch_bpr_train.py holds the two
# byte-identical): the script imports nothing of the JAX package's tree
def make_ml100k_like(seed=7):
    """Seeded implicit-feedback data, ML-100K shape, with popularity and
    preference structure (exposure correlates with preference so ranking
    models have signal)."""
    rng = np.random.RandomState(seed)
    n_users, n_items, n_ratings = 943, 1682, 100_000

    item_pop = rng.zipf(1.3, size=n_items).astype(np.float64)
    item_pop /= item_pop.sum()
    u_f = rng.normal(0, 1.0, (n_users, 6))
    i_f = rng.normal(0, 1.0, (n_items, 6))

    data = []
    seen = set()
    while len(data) < n_ratings:
        m = (n_ratings - len(data)) * 2
        users = rng.randint(n_users, size=m)
        items = rng.choice(n_items, size=m, p=item_pop)
        affinity = np.einsum("ij,ij->i", u_f[users], i_f[items])
        keep = rng.rand(m) < 1.0 / (1.0 + np.exp(-affinity))  # exposure ~ preference
        for u, i, a in zip(users[keep], items[keep], affinity[keep]):
            if len(data) == n_ratings:
                break
            if (u, i) in seen:
                continue
            seen.add((u, i))
            r = float(np.clip(np.round(3.5 + a + rng.normal(0, 0.8)), 1, 5))
            data.append((f"u{u}", f"i{i}", r))
    return data


class Clock:
    """Host-clock seconds of named steps, each ending in a synchronise."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn):
        import torch

        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t
        return out

    def report(self, what):
        for name, sec in self.seconds.items():
            log(f"  {what}, host clock: {name}: {sec:.3f} s")


@contextlib.contextmanager
def swapped(owner, name, value):
    """While open, ``owner.name`` is ``value``; the real one after."""
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


def phase_kernel(gen):
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

    def rand(*shape, ints=False):
        if ints:  # entries in {-1, 0, 1}: small integer scores, ties everywhere
            return torch.randint(-1, 2, shape, generator=gen, device=DEV).float()
        return 0.5 * torch.randn(*shape, generator=gen, device=DEV)

    N, d = N_ITEMS, FACTORS + 1
    # (label, B, N, d, k, bias, duplicated vectors, integer entries)
    cases = []
    for bias in (True, False):
        cases.append((f"bias={bias} B=300 k=100", 300, N, d, 100, bias, False, False))
    for k in (1, 100, 128, 1000, N):
        cases.append((f"k={k} B=77", 77, N, d, k, True, False, False))
    cases += [
        ("k>N (k=N+5) B=40", 40, N, d, N + 5, True, False, False),
        ("ties across chunks, k=N B=13", 13, N, d, N, True, True, False),
        ("ties across chunks N=1400 d=16 k=N B=6", 6, 1400, 16, 1400, False, True, False),
        ("integer scores (exact ties) d=4 k=100 B=64", 64, N, 4, 100, False, False, True),
        ("integer scores (exact ties) d=4 k=N B=5", 5, N, 4, N, True, False, True),
        ("N below one chunk N=50 k=200 B=9", 9, 50, d, 200, True, False, False),
        ("d=1 B=33 k=10", 33, N, 1, 10, True, False, False),
        ("d=300 B=40 k=64", 40, N, 300, 64, False, False, False),
        ("B=1 k=100", 1, N, d, TOPK, False, False, False),
        (f"serving shape B={SERVE_BATCH} k={TOPK}", SERVE_BATCH, N, d, TOPK, False, False, False),
        # split across blocks, then merged: one-chunk slices hold 512 items
        ("split B=1 k=600, k above a slice", 1, N, d, 600, True, False, False),
        ("split B=5 integer ties across slices d=4 k=600", 5, N, 4, 600, False, False, True),
        ("split B=17 duplicated vectors k=300", 17, N, d, 300, True, True, False),
        ("split B=16 N=3000 k=N//5, last slice short", 16, 3000, d, 600, False, False, False),
        ("split B=256 k=100", 256, N, d, TOPK, True, False, False),
    ]

    max_err, relaxed = 0.0, 0
    for what, B, n, dd, k, bias, dup, ints in cases:
        U, V = rand(B, dd, ints=ints), rand(n, dd, ints=ints)
        b = rand(n, ints=ints) if bias else None
        if dup:  # the same vector in chunks far apart: exact score ties
            V[n - 100] = V[70]
            V[n // 2 + 3] = V[70]
            if b is not None:
                b[n - 100] = b[n // 2 + 3] = b[70]
        before = FUSED_TOPK.launches
        ks, ki = fused_topk(U, V, k, bias=b, force="kernel")
        torch.cuda.synchronize()
        if FUSED_TOPK.launches != before + 1:
            raise AssertionError(f"{what}: the kernel was not launched")
        k_eff = min(k, n)
        ps, pi = fused_topk_torch(U, V, min(k_eff + 1, n), b)
        S = plain_scores(U, V, b)
        err, n_rel = compare_topk(ks, ki, ps, pi, S, what, exact=ints)
        slices = FUSED_TOPK.plan(U, n, k_eff)
        if what.startswith("split") and slices < 2:
            raise AssertionError(f"{what}: split_plan did not split the catalog")
        if dup and k_eff == n:
            row = ki[0].tolist()
            order = [row.index(i) for i in sorted((70, n // 2 + 3, n - 100))]
            if order != sorted(order):
                raise AssertionError(f"{what}: tied items out of index order")
        max_err, relaxed = max(max_err, err), relaxed + n_rel
        log(f"  {what}: ok (S={slices}, max |err| {err:.3e}, "
            f"near-tie index swaps {n_rel})")
        del U, V, b, ks, ki, ps, pi, S
    log(f"kernel vs plain: ok, {len(cases)} cases, max |err| {max_err:.3e}, "
        f"positions relaxed as near-ties: {relaxed} (tolerance rtol={RTOL} atol={ATOL})")
    return max_err


SIM_RTOL, SIM_ATOL = 1e-5, 1e-6  # similarities on inexact data: f32 sums in another order


def star_weights(n, m, density, kind, gen):
    """(n, m) sparse weights on the card: ``binary`` (every co-rated pair
    has similarity 1.0), ``integer`` 1-5 or ``half_star`` 0.5-5.0, on
    which every sum of the cosine is exact in float32; ``centred``: random
    normals, mean-centred per row, so negative similarities occur."""
    import torch

    mask = torch.rand(n, m, generator=gen, device=DEV) < density
    if kind == "binary":
        vals = torch.ones(n, m, device=DEV)
    elif kind == "integer":
        vals = torch.randint(1, 6, (n, m), generator=gen, device=DEV).float()
    elif kind == "half_star":
        vals = torch.randint(1, 11, (n, m), generator=gen, device=DEV).float() / 2
    else:
        vals = torch.randn(n, m, generator=gen, device=DEV)
    W = torch.where(mask, vals, 0.0)
    if kind == "centred":
        cnt = mask.sum(1, keepdim=True).clamp_min(1)
        W = torch.where(mask, W - (W.sum(1, keepdim=True) / cnt - 1e-4), 0.0)
    return W.contiguous()


def check_cosine(W, k, exclude_self, what, exact):
    """One kernel launch on W against the plain version; returns
    (max abs error, positions relaxed as near-ties)."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import (
        COSINE_TOPK, all_pairs_cosine, cosine_topk, cosine_topk_torch)

    n = W.shape[0]
    cap = n - 1 if exclude_self else n
    before = COSINE_TOPK.launches
    ks, ki = cosine_topk(W, k, exclude_self=exclude_self, force="kernel")
    torch.cuda.synchronize()
    if COSINE_TOPK.launches != before + 1:
        raise AssertionError(f"{what}: the kernel was not launched")
    k_eff = min(k, cap)
    if ks.shape != (n, k_eff):
        raise AssertionError(f"{what}: kernel gave {tuple(ks.shape)}, want {(n, k_eff)}")
    if exclude_self and (ki == torch.arange(n, device=DEV)[:, None]).any():
        raise AssertionError(f"{what}: a row is its own neighbour")
    ps, pi = cosine_topk_torch(W, min(k_eff + 1, cap), exclude_self)
    return compare_topk(ks, ki, ps, pi, all_pairs_cosine(W, exclude_self), what, exact=exact,
                        rtol=SIM_RTOL, atol=SIM_ATOL)


def check_cosine_entries(gen):
    """The sparse entry point on a scipy matrix with explicit zeros,
    duplicates (some summing to 0) and a value that rounds to 0 in
    float32, held exactly to the plain version on the dense float32 W."""
    import torch
    from scipy.sparse import coo_matrix

    from cornac_tpu_torch.models.knn import dense_f32
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK, cosine_topk_sparse, cosine_topk_torch

    rng = np.random.RandomState(int(torch.randint(2**31 - 1, (1,), generator=gen, device=DEV)))
    n, m, nnz = 2000, 1500, 150_000
    rows, cols = rng.randint(n, size=nnz), rng.randint(m, size=nnz)
    vals = rng.randint(0, 6, size=nnz).astype(np.float64)  # a sixth are explicit zeros
    rows = np.concatenate([rows, [1, 1, 2]])
    cols = np.concatenate([cols, [m - 1, m - 1, m - 1]])
    vals = np.concatenate([vals, [2.0, -2.0, 1e-50]])
    mat = coo_matrix((vals, (rows, cols)), shape=(n, m))
    before = COSINE_TOPK.launches
    ks, ki = cosine_topk_sparse(mat, KNN_K, device=DEV)
    torch.cuda.synchronize()
    if COSINE_TOPK.launches != before + 1:
        raise AssertionError("explicit zeros: the kernel was not launched")
    ps, pi = cosine_topk_torch(dense_f32(mat, torch.device(DEV)), KNN_K)
    if not (torch.equal(ks, ps) and torch.equal(ki, pi)):
        raise AssertionError("explicit zeros and duplicates: kernel differs from the plain version")
    log(f"  scipy entries with explicit zeros and duplicates (n={n} m={m} k={KNN_K}): ok, "
        "exact index for index")
    return (ks - ps).abs().max().item()


def plain_topk_by_rows(W, k, block=2048):
    """``cosine_topk_torch(W, k)`` a block of rows at a time, for an n
    whose (n, n) similarity matrix is too large to sort whole: the same
    co-support cosine, diagonal and stable descending sort per row."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import NEG_INF, co_support_cosine

    n = W.shape[0]
    parts_s, parts_i = [], []
    for s in range(0, n, block):
        rows = torch.arange(s, min(s + block, n), device=W.device)
        sim = co_support_cosine(W[rows], W)
        sim[rows - s, rows] = NEG_INF
        v, i = torch.sort(sim, dim=1, descending=True, stable=True)
        parts_s.append(v[:, :k])
        parts_i.append(i[:, :k].to(torch.int32))
    return torch.cat(parts_s), torch.cat(parts_i)


def check_cosine_ranges(gen):
    """n = 40,000 candidate rows, more than one pass of shared memory
    holds, so the kernel walks each row's support once per range. The
    density rises across one range and falls across the next, so the warps'
    spans (cut by work) do not line up from one range to the next. Held
    exactly to the plain version."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK, cosine_topk

    n, m, k = 40_000, 32, 12
    C, _ = COSINE_TOPK.plan(n, DEV)
    ranges = -(-n // C)
    if ranges < 2:
        raise AssertionError(f"n={n} fits one range of C={C} rows: the case tests nothing")
    r = torch.arange(n, device=DEV)
    starts = torch.arange(ranges + 1, device=DEV) * n // ranges  # as ops.cosine_topk.partition cuts
    q = torch.searchsorted(starts, r, right=True) - 1  # the range of row r
    t = (r - starts[q]).float() / (starts[q + 1] - starts[q]).float()
    density = 0.02 + 0.4 * torch.where(q % 2 == 0, t, 1.0 - t)
    mask = torch.rand(n, m, generator=gen, device=DEV) < density[:, None]
    W = torch.where(mask, torch.randint(1, 6, (n, m), generator=gen, device=DEV).float(), 0.0)
    ks, ki = cosine_topk(W, k, force="kernel")
    ps, pi = plain_topk_by_rows(W, k)
    if not (torch.equal(ks, ps) and torch.equal(ki, pi)):
        bad = int((ki != pi).any(1).sum())
        raise AssertionError(f"{ranges} ranges: {bad} rows differ from the plain version")
    log(f"  n={n} m={m} k={k} over {ranges} shared-memory ranges of at most {C} rows, spans "
        "misaligned between ranges: ok, exact index for index")
    return (ks - ps).abs().max().item()


def phase_cosine(gen):
    import torch

    # (label, n, m, density, kind, k, exclude_self)
    cases = [
        ("binary, sims mostly 1.0", 1000, 700, 0.05, "binary", 50, True),
        ("integer 1-5", 1000, 700, 0.05, "integer", 50, True),
        ("half-star", 1000, 700, 0.05, "half_star", 50, True),
        ("integer, exclude_self=False", 1000, 700, 0.05, "integer", 50, False),
        ("centred, negatives, exclude_self=True", 777, 300, 0.2, "centred", 776, True),
        ("centred, negatives, exclude_self=False", 777, 300, 0.2, "centred", 777, False),
        ("k = n - 1", 300, 200, 0.1, "half_star", 299, True),
        ("k past n (capped)", 300, 200, 0.1, "integer", 1000, True),
        ("n = 161", 161, 97, 0.1, "integer", 40, True),
        ("m = 45", 500, 45, 0.1, "integer", 30, True),
        ("m = 1", 400, 1, 0.5, "integer", 20, True),
        ("n = 20, fewer rows than a block has warps x 3", 20, 64, 0.2, "integer", 8, True),
        ("ML-1M item side 3706 x 6040, k=50", 3706, 6040, 0.045, "integer", 50, True),
        ("half dense at the ML-1M item widths", 3706, 6040, 0.5, "integer", 50, True),
    ]
    max_err, relaxed = 0.0, 0
    for what, n, m, density, kind, k, excl in cases:
        W = star_weights(n, m, density, kind, gen)
        W[min(5, n - 1)] = 0.0  # an all-zero row: the first k other rows, similarity 0
        err, n_rel = check_cosine(W, k, excl, what, exact=kind != "centred")
        max_err, relaxed = max(max_err, err), relaxed + n_rel
        log(f"  {what} (n={n} m={m} k={k}): ok (max |err| {err:.3e}, near-tie index swaps {n_rel})")
        del W
    max_err = max(max_err, check_cosine_entries(gen), check_cosine_ranges(gen))
    torch.cuda.empty_cache()
    log(f"cosine kernel vs plain: ok, {len(cases) + 2} cases, max |err| {max_err:.3e}, exact index "
        f"for index on star data, near-tie swaps elsewhere: {relaxed} "
        f"(tolerance rtol={SIM_RTOL} atol={SIM_ATOL})")
    return max_err


def popular_ids(R, B, gen):
    """B row ids in [0, R), duplicate-heavy: rank r comes with probability
    proportional to 1 / (r + 1) (a Zipf-like popularity, as item ids of
    the negatives and positives are), the ranks scattered over the rows."""
    import torch

    p = 1.0 / torch.arange(1, R + 1, device=DEV, dtype=torch.float64)
    ranks = torch.multinomial(p, B, replacement=True, generator=gen)
    return torch.randperm(R, generator=gen, device=DEV)[ranks]


def launches_per_call(fn, calls=4):
    """What the profiler sees per call of ``fn`` (warmed once): the host's
    launches of device work (the CUDA runtime's kernel launches, memsets
    and copies), the device-side events, the device events' names, and
    their mean device time in ms (None if it kept none). The host count is
    the exact one: the device side has been seen to miss an event of a
    short kernel."""
    from torch.autograd import DeviceType

    fn()
    _, busy_ms, count, events, prof = profile_call(lambda: [fn() for _ in range(calls)],
                                                   with_prof=True)
    host = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CPU
               and e.key.startswith("cu") and any(w in e.key for w in ("Launch", "Memset", "Memcpy")))
    return host / calls, count / calls, sorted({e.key for e in events}), (
        busy_ms / count if count else None)


# label (the trainers' shapes, timed later on the same inputs), rows, ids,
# d (None: a 1-D table), the ids' distribution, their stride (2: a column
# of (user, item) pairs, as the trainers' user ids are)
ACC_CASES = [
    *((None, R, B, d, "popular", 1) for R, B in ((17_700, 16_384), (480_000, 16_384))
      for d in (11, 33, 51)),
    (None, 943, 4_096, 33, "popular", 1),
    (None, 943, 4_096, 51, "popular", 1),
    (None, 50, 3_000, None, "popular", 1),  # a 1-D table, as the baselines' biases
    (None, 5_000, 16_384, 200, "popular", 2),  # four column blocks
    (None, 64, 32_768, 11, "popular", 1),  # R < B: a run longer than a round and the stage
    (None, 2_000_000, 4_096, 33, "uniform", 1),  # R >> B: over a thousand row ranges
    (None, 100_000, 16_384, 33, "out of range", 2),  # 5% of the ids outside [0, R)
    ("full width, V update (positives + negatives)", FULL_ITEMS, 2 * FULL_BATCH, FULL_K + 1,
     "uniform", 1),
    ("full width, U update", FULL_USERS, FULL_BATCH, FULL_K + 1, "uniform", 2),
    ("bench shape, V update", 1_682, 2 * 4_096, 11, "popular", 1),
    ("bench shape, U update", 943, 4_096, 11, "popular", 2),
    # the factor family's shapes at the bench shape, whose train set holds
    # 943 users and 789 items (phase 12 also holds the kernel to the plain
    # version on the inputs the trainers hand it)
    (None, 943, 80_000, 15, "popular", 1),  # NMF's U numerator and denominator
    (None, 789, 80_000, 15, "popular", 1),  # NMF's V sums
    (None, 789, 80_000, None, "popular", 1),  # NMF's item biases (use_bias)
    (None, 943, 1_024, 10, "popular", 2),  # PMF's U update
    (None, 789, 1_024, 10, "popular", 2),  # PMF's V update
    (None, 943, 100, 10, "popular", 2),  # IBPR's U gradient
    (None, 789, 200, 10, "popular", 1),  # IBPR's V gradient (positives + negatives)
    (None, 943, 1_000, 10, "popular", 2),  # COE's U gradient
    (None, 789, 2_000, 10, "popular", 1),  # COE's V gradient
    (None, 943, 256, 10, "popular", 2),  # MF-adam's U gradient
    (None, 789, 256, None, "popular", 2),  # MF-adam's item-bias gradient
    # the neural family (phase 12b also holds the kernel to the plain
    # version on the inputs its trainers hand it): the embedding gradients
    # of a NeuMF minibatch (256 ids, the MLP tower's 16 columns; GMF's 8)
    # and of LightGCN's gathers from its propagated tables (1,024 ids at
    # d = 64), then LightGCN's edge-form propagation at the ML-10M widths,
    # every edge into the user rows and into the item rows (phase 10b)
    ("NeuMF, bench shape, MLP user embeddings", 943, 256, 16, "popular", 1),
    (None, 1_682, 256, 8, "popular", 1),  # NeuMF's GMF item embeddings
    ("LightGCN, bench shape, propagated item rows", 1_682, 1_024, 64, "popular", 1),
    ("LightGCN edge form, ML-10M, into user rows", ML10M_USERS, ML10M_RATINGS, 64, "popular", 1),
    ("LightGCN edge form, ML-10M, into item rows", ML10M_ITEMS, ML10M_RATINGS, 64, "popular", 1),
    # the factor family's rest: HPF's two scatters a sweep at the ML-10M
    # widths (phase 10c, every rating into the user rows and into the item
    # rows, k = 5) and at the bench shape (phase 12c), and FM-SGD's w and V
    # updates (a minibatch of 1,024 ratings: its user ids, then its item ids
    # offset by the 943 users, into the 943 + 789 feature rows)
    ("HPF, ML-10M, into user rows", ML10M_USERS, ML10M_RATINGS, 5, "popular", 1),
    ("HPF, ML-10M, into item rows", ML10M_ITEMS, ML10M_RATINGS, 5, "popular", 1),
    (None, 943, 80_000, 5, "popular", 1),  # HPF's user shapes at the bench shape
    (None, 789, 80_000, 5, "popular", 1),  # HPF's item shapes
    (None, 1_732, 2_048, None, "feature blocks", 1),  # FM-SGD's w
    (None, 1_732, 2_048, 8, "feature blocks", 1),  # FM-SGD's V
    # the modality layer's models at their published widths (phases 15 and
    # 15b also hold the kernel to the plain version on the inputs their
    # first minibatch or sweep hands it): SBPR's three scatters at Epinions
    # (a minibatch of 1,024: the user rows, [i; j; k] into the item rows,
    # and each bias scatter) and C2PF's at Amazon Office (about 42,600 train
    # ratings into the item and the user rows at k = 100, about 100,000
    # context edges into the item rows, at k = 100 and 1-D)
    ("SBPR, Epinions, U update", EPINIONS_USERS, 1_024, 10, "popular", 2),
    ("SBPR, Epinions, V update (i, j, k)", EPINIONS_ITEMS, 3_072, 10, "popular", 1),
    ("SBPR, Epinions, item bias", EPINIONS_ITEMS, 1_024, None, "popular", 2),
    ("C2PF, Amazon Office, ratings into item rows", OFFICE_ITEMS, 42_626, 100, "popular", 1),
    ("C2PF, Amazon Office, ratings into user rows", OFFICE_USERS, 42_626, 100, "popular", 1),
    ("C2PF, Amazon Office, context edges into item rows", OFFICE_ITEMS, 100_000, 100, "popular",
     1),
    (None, OFFICE_ITEMS, 100_000, None, "popular", 1),  # C2PF's kappa sums
    # the next-item family (phase 16 also holds the kernel to the plain
    # version on SASRec's first step, 12f on every trainer's own inputs):
    # SASRec's embedding gradients at the Diginetica widths (31 sessions x
    # 50 positions of a step, and the 2,048 shared negatives, into the
    # 43,098 x 64 table), FPMC's item-table scatters at the same widths
    # (examples/fpmc_diginetica.py: 1,024 transitions, d = 32) and GCMC's
    # edge sums at the bench shape (80,000 edges into the 943 user and 789
    # item rows, 100 columns a rating)
    ("SASRec, Diginetica, embedding gradient (positions)", DIGI_ITEMS + 1, 1_550, 64,
     "popular", 1),
    ("SASRec, Diginetica, embedding gradient (negatives)", DIGI_ITEMS + 1, 2_048, 64,
     "popular", 1),
    ("FPMC, Diginetica, item-table scatter", DIGI_ITEMS, 1_024, 32, "popular", 1),
    # the generative next-item models (phases 16b and 16c also hold the
    # kernel to the plain version on their first steps' inputs, 12h on every
    # trainer's own): BERT4Rec's embedding and output-bias gradients at the
    # Diginetica widths (128 sessions x 50 positions into the 43,099-row
    # table with its padding and mask rows), TIGER's token table at
    # examples/tiger_example.py's settings (256 histories x 20 items x 4
    # levels into 1 + 3 x 256 + 2 rows at d_model 128) and an RQ-VAE codebook
    # (a batch of 1,024 items into 256 codes at latent 32)
    ("BERT4Rec, Diginetica, embedding gradient (positions)", DIGI_ITEMS + 2, 6_400, 64,
     "popular", 1),
    ("BERT4Rec, Diginetica, output-bias gradient (positions)", DIGI_ITEMS + 2, 6_400, None,
     "popular", 1),
    ("TIGER, ML-100K, token table (encoder tokens)", 771, 20_480, 128, "popular", 1),
    ("TIGER, ML-100K, RQ-VAE codebook", 256, 1_024, 32, "popular", 1),
    ("GCMC, bench shape, edges into item rows", 789, 80_000, 100, "popular", 1),
    ("GCMC, bench shape, edges into user rows", 943, 80_000, 100, "popular", 1),
    # the side-information models (phases 18, 18b, 18c and 12i, which also
    # hold the kernel to the plain version on the inputs their trainers hand
    # it): VBPR's gathers' gradients at the Tradesy counts (a step of 100
    # triplets: [i; j] into the item factors and biases, u into Gu and Tu),
    # SoRec's trust-stream U update at Epinions (1,024 edges, k = 5), MCF's
    # item-graph stream at Amazon Office (1,024 edges into V, k = 10), DMRL's
    # item-embedding gradient at Amazon Clothing (1,024 x 5 slots, d = 100)
    ("VBPR, Tradesy, item-factor gradient (positives + negatives)", TRADESY_ITEMS, 200, 10,
     "popular", 1),
    (None, TRADESY_ITEMS, 200, None, "popular", 1),  # VBPR's item-bias gradient
    (None, TRADESY_USERS, 100, 20, "popular", 2),  # VBPR's Tu gradient
    ("SoRec, Epinions, U update (trust stream)", EPINIONS_USERS, 1_024, 5, "popular", 2),
    ("MCF, Amazon Office, V update (item-graph stream)", OFFICE_ITEMS, 1_024, 10, "popular", 2),
    ("DMRL, Amazon Clothing, item-embedding gradient", CLOTHING_ITEMS, 5_120, 100, "popular", 1),
    # the text and review models (phases 19b and 19c also hold the kernel to
    # the plain version on the inputs their first steps hand it, 12j on every
    # trainer's own): NARRE's word-table gradient at examples/narre_example.py's
    # widths (64 entities x 32 review slots x 50 tokens into 4,004 x 100, some
    # 60% of the slots empty at the Digital Music counts), with the empty
    # slots dropped (ids past the table, as the fit sends them) and with them
    # summed into the padding row, and ConvMF's embedding gradient at
    # conv_mf_example.py's (128 plots x 300 tokens into 8,004 x 200, the
    # plots' padding into row 0)
    ("NARRE, Digital Music, word-table gradient (empty slots dropped)", 4_004, 102_400, 100,
     "review slots", 1),
    ("NARRE, Digital Music, word-table gradient (empty slots into row 0)", 4_004, 102_400, 100,
     "review pads", 1),
    ("ConvMF, ML-100K plots, embedding gradient", 8_004, 38_400, 200, "plot docs", 1),
]
FM_USERS = 943  # the bench shape's train users: the first feature block of FM's ids


def accumulate_inputs(R, B, d, kind, stride, gen):
    """A seeded (table, ids, updates) of one ``ACC_CASES`` case; ids with
    ``stride`` 2 are the first column of a (B, 2) tensor."""
    import torch

    shape = (R,) if d is None else (R, d)
    table = torch.randn(*shape, generator=gen, device=DEV)
    if kind == "feature blocks":  # FM's users, then its items past the users
        half = B // 2
        ids = torch.cat([popular_ids(FM_USERS, half, gen),
                         FM_USERS + popular_ids(R - FM_USERS, B - half, gen)])
    elif kind == "popular":
        ids = popular_ids(R, B, gen)
    elif kind in ("review slots", "review pads", "plot docs"):
        ids = padded_doc_ids(R, B, kind, gen)
    else:
        ids = torch.randint(R, (B,), generator=gen, device=DEV)
    if kind == "out of range":
        bad = torch.tensor([-1, -7, R, R + 3, 2**40], device=DEV)
        pick = torch.rand(B, generator=gen, device=DEV) < 0.05
        ids = torch.where(pick, bad[torch.randint(5, (B,), generator=gen, device=DEV)], ids)
    if stride == 2:
        ids = torch.stack([ids, torch.zeros_like(ids)], 1)[:, 0]
    upd = torch.randn(B, *shape[1:], generator=gen, device=DEV)
    return table, ids, upd


def padded_doc_ids(R, B, kind, gen):
    """B token ids of padded documents: "review slots" and "review pads" are
    NARRE's word gathers, slots of 50 tokens, 60% of them empty (their ids
    R, past the table, for "review slots"; 0, the padding row, for "review
    pads"), each filled slot a review of 30-149 tokens cut to 50, padded
    with 0; "plot docs" are ConvMF's, rows of 300 tokens, each a plot of
    40-199 tokens padded with 0. The tokens are Zipf-like over [4, R)."""
    import torch

    L = 300 if kind == "plot docs" else 50
    rows = B // L
    lo, hi = (40, 200) if kind == "plot docs" else (30, 150)
    lengths = torch.randint(lo, hi, (rows, 1), generator=gen, device=DEV)
    ids = (4 + popular_ids(R - 4, B, gen)).reshape(rows, L)
    ids = torch.where(torch.arange(L, device=DEV)[None, :] < lengths, ids, 0)
    if kind != "plot docs":
        empty = torch.rand((rows, 1), generator=gen, device=DEV) < 0.6
        ids = torch.where(empty, R if kind == "review slots" else 0, ids)
    return ids.reshape(-1)


def check_accumulate(what, table, ids, upd, calls=4):
    """Hold one accumulate_rows call to its plain version: two launches
    give the same bits, and those are the bits of the plain version on the
    CPU, whose ``index_add_`` sums each row's updates in batch order and
    adds the sum once, as the kernel does (both drop ids outside [0, R));
    the profiler sees one kernel and nothing else per call over ``calls``
    calls (none: not profiled; where it keeps no device event in two tries,
    one more call must give the kernel's bits). ``table`` is left as it was. Returns (max
    |kernel - plain on the CPU|, 0 when it passes; max |kernel - plain on
    the card|, where ``index_add_`` sums with atomics in no fixed order;
    launches per call; the kernel's mean device ms per event the profiler
    kept, and kept per call, both None unprofiled)."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows, ids_in_table

    before = ACCUMULATE_ROWS.launches
    got = [accumulate_rows(table.clone(), ids, upd) for _ in range(2)]
    torch.cuda.synchronize()
    if ACCUMULATE_ROWS.launches != before + 2:
        raise AssertionError(f"{what}: the kernel was not launched")
    if not torch.equal(got[0], got[1]):
        raise AssertionError(f"{what}: two launches of the kernel differ")
    per_call, device_per_call, device_ms = 1, None, None
    if calls:
        scratch = table.clone()
        for _ in range(2):  # once more when the profiler kept no device event at all
            per_call, device_per_call, names, device_ms = launches_per_call(
                lambda: accumulate_rows(scratch, ids, upd), calls)
            if device_per_call:
                break
        if not device_per_call:
            # some machines' profilers keep no event of a short kernel for
            # a while: the launch is shown by its result instead, one call
            # on a fresh copy giving the bits of the two above
            shown, before = table.clone(), ACCUMULATE_ROWS.launches
            accumulate_rows(shown, ids, upd)
            torch.cuda.synchronize()
            if (ACCUMULATE_ROWS.launches != before + 1 or torch.equal(shown, table)
                    or not torch.equal(shown, got[0])):
                raise AssertionError(f"{what}: the profiler kept no device event and a call "
                                     f"did not give the kernel's result")
            device_per_call, names = None, []
            log(f"  {what}: the profiler kept no device event of {2 * calls} calls; the "
                f"launch shown by its result")
        if (per_call != 1 or (device_per_call is not None and not 0 < device_per_call <= 1)
                or not all("accumulate_rows_kernel" in k for k in names)):
            raise AssertionError(f"{what}: {per_call} launches and {device_per_call} device "
                                 f"events per call ({names}), not one kernel")
        del scratch
    want = accumulate_rows(table.to("cpu", copy=True), ids.cpu(), upd.cpu())
    kernel = got[0].cpu()
    err = (kernel - want).abs().max().item()
    if not torch.equal(kernel, want):
        raise AssertionError(f"{what}: the kernel differs from the plain version on the CPU, "
                             f"max |kernel - plain| {err:.3e}")
    del want, kernel
    card_err = (got[0] - accumulate_rows(table.clone(), ids, upd, force="torch")
                ).abs().max().item()
    ok_ids = ids_in_table(table, ids, upd)[0]
    runs = torch.unique(ok_ids, return_counts=True)[1]
    log(f"  {what}: ok ({runs.numel()} runs, the longest {int(runs.max())} ids"
        + (f"; {ids.numel() - ok_ids.numel()} ids outside [0, R) dropped"
           if ok_ids.numel() < ids.numel() else "")
        + f"; the plain version's bits on the CPU; max |kernel - plain on the card| "
        f"{card_err:.3e}; two launches "
        + ("bit-identical)" if not calls else f"bit-identical; per call {per_call:g} launch, "
           + ("device events not measured)" if device_per_call is None
              else f"{device_per_call:g} device event, the kernel)")))
    return err, card_err, per_call, device_ms, device_per_call


def phase_accumulate(gen):
    """The row-accumulation kernel against its plain version on the CPU,
    bit for bit, on duplicate-heavy batches, a 1-D table, column blocks, R
    below and far above B, strided and out-of-range ids (held to the plain
    version on the in-range ids) and the trainers' shapes; two launches
    must give the same bits, and the profiler must see one kernel and
    nothing else per call. Returns the largest |kernel - plain on the CPU|
    and, for the labelled cases, their inputs, launches per call, the
    kernel's device time per launch (profiled over 20 calls here, before
    the later phases' long profiles) and their own max |kernel - plain|
    on the CPU and on the card, for timing."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err, max_card_err, most_ranges = 0.0, 0.0, 0
    timed = {}
    for label, R, B, d, kind, stride in ACC_CASES:
        table, ids, upd = accumulate_inputs(R, B, d, kind, stride, gen)
        plan = ACCUMULATE_ROWS.plan(R, B, 1 if d is None else d, table.device)
        most_ranges = max(most_ranges, plan.grid[0])
        what = (f"{B} ids into {R} rows, d={d}, {kind}, id stride {stride}"
                + (f" ({label})" if label else "")
                + f", grid {plan.grid[0]} x {plan.grid[1]} of {plan.rows} rows x {plan.cols}")
        err, card_err, per_call, device_ms, kept = check_accumulate(
            what, table, ids, upd, calls=20 if label else 4)
        max_err, max_card_err = max(max_err, err), max(max_card_err, card_err)
        if label:
            timed[label] = (table, ids, upd, per_call, device_ms, kept, err, card_err)
    if most_ranges <= 4 * sms:
        raise AssertionError(f"no case planned more than {4 * sms} row ranges")
    torch.cuda.empty_cache()
    log(f"accumulate_rows vs plain: ok, {len(ACC_CASES)} cases, the plain version's bits on the "
        f"CPU (max |err| {max_err:.3e}; against the plain version on the card, atomic, "
        f"{max_card_err:.3e}), up to {most_ranges} row ranges, one kernel per call")
    return max_err, timed


def make_slice(seed, work):
    """Seeded BPR factors at the serving width and a train set that holds
    every user and item, then both models saved under ``work``."""
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.models import BPR, TPUExactANN

    rng = np.random.RandomState(seed)
    U = (0.5 * rng.standard_normal((N_USERS, FACTORS))).astype(np.float32)
    V = (0.5 * rng.standard_normal((N_ITEMS, FACTORS))).astype(np.float32)
    Bi = rng.standard_normal(N_ITEMS).astype(np.float32)
    # every user once (in index order), every item once, then random pairs
    users = np.concatenate([
        np.arange(N_USERS), rng.randint(N_USERS, size=N_ITEMS),
        rng.randint(N_USERS, size=N_INTERACTIONS - N_USERS - N_ITEMS),
    ])
    items = np.concatenate([
        rng.randint(N_ITEMS, size=N_USERS), rng.permutation(N_ITEMS),
        rng.randint(N_ITEMS, size=N_INTERACTIONS - N_USERS - N_ITEMS),
    ])
    ratings = rng.randint(1, 6, size=N_INTERACTIONS).astype(float)
    uids = [f"u{u}" for u in range(N_USERS)]
    iids = [f"i{i}" for i in range(N_ITEMS)]
    data = [(uids[u], iids[i], r) for u, i, r in zip(users, items, ratings)]
    t0 = time.perf_counter()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # duplicate pairs are dropped, as designed
        train = Dataset.build(data, seed=seed)
    log(f"  Dataset.build: {train.num_ratings} interactions over {train.num_users} users x "
        f"{train.num_items} items in {time.perf_counter() - t0:.1f} s "
        f"(cut from Netflix's ~100M interactions to keep the build quick)")
    if (train.num_users, train.num_items) != (N_USERS, N_ITEMS):
        raise AssertionError("train set does not cover every user and item")
    # index i of the train set is raw id u{i}/i{i}: the factors line up
    perm_u = np.array([int(u[1:]) for u in train.uid_map])
    perm_i = np.array([int(i[1:]) for i in train.iid_map])
    bpr = BPR(k=FACTORS, trainable=False, seed=seed,
              init_params={"U": U[perm_u], "V": V[perm_i], "Bi": Bi[perm_i]}).fit(train)
    ann = TPUExactANN(bpr)
    ann.build_index()
    paths = {
        "bpr": bpr.save(str(work), save_trainset=True),
        "ann": ann.save(str(work), save_trainset=True),
    }
    # held-out triples for /evaluate: known users and items, unseen pairs
    eu = rng.randint(N_USERS, size=3000)
    ei = rng.randint(N_ITEMS, size=3000)
    csr = train.csr_matrix
    test = [
        (train.user_ids[u], train.item_ids[i], float(rng.randint(1, 6)))
        for u, i in zip(eu, ei) if csr[u, i] == 0
    ][:2000]
    return bpr, ann, train, paths, test


class Served:
    """The port's standalone server for one saved model, on localhost."""

    def __init__(self, model_path, model_class):
        from http.server import ThreadingHTTPServer

        from cornac_tpu_torch.serving.core import load_model
        from cornac_tpu_torch.serving.standalone import make_handler

        os.environ["MODEL_PATH"] = model_path
        os.environ["MODEL_CLASS"] = model_class
        os.environ.pop("TRAIN_SET", None)
        self.model, self.train_set = load_model(".")
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(self.model, self.train_set))
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=600) as resp:
            return json.loads(resp.read())

    def post(self, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def reference_lists(U_rows, V, k, seen_rows):
    """Item-index lists from the plain version with the models' seen-item
    filter (over-fetch k + max seen, drop seen, keep k)."""
    import torch

    from cornac_tpu_torch.ops.fused_topk import fused_topk_torch

    fetch = min(k + max((len(s) for s in seen_rows), default=0), V.shape[0])
    _, idx = fused_topk_torch(U_rows, V, fetch)
    out = []
    for row, seen in zip(idx.cpu().numpy(), seen_rows):
        out.append([i for i in row if i not in seen][:k])
    torch.cuda.synchronize()
    return out


def check_lists(got, want, S, what):
    """Item lists equal, up to swaps of items whose plain scores tie within
    the tolerance. Returns the number of relaxed positions."""
    relaxed = 0
    for b, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, dtype=np.int64), np.asarray(w, dtype=np.int64)
        if len(g) != len(w) or len(set(g.tolist())) != len(g):
            raise AssertionError(f"{what}: row {b} has {len(g)} items, want {len(w)} distinct")
        diff = np.flatnonzero(g != w)
        if len(diff):
            sg, sw = S[b, g[diff]], S[b, w[diff]]
            if not np.all(np.abs(sg - sw) <= ATOL + RTOL * np.abs(sw)):
                raise AssertionError(f"{what}: row {b} differs beyond near-ties")
            relaxed += len(diff)
    return relaxed


def phase_slice(seed, work, mesh):
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    t0 = time.perf_counter()
    bpr, ann, train, paths, test = make_slice(seed, work)
    log(f"  models built and saved in {time.perf_counter() - t0:.1f} s")
    os.chdir(work)  # /feedback appends to data/feedback.csv under the cwd
    servers = [Served(paths["ann"], "cornac_tpu_torch.models.TPUExactANN"),
               Served(paths["bpr"], "cornac_tpu_torch.models.BPR")]
    ann_srv, bpr_srv = servers
    csr = train.csr_matrix
    rng = np.random.RandomState(seed + 1)
    ask = [train.user_ids[u] for u in rng.randint(N_USERS, size=3)]
    batch_users = [train.user_ids[u] for u in rng.choice(N_USERS, SERVE_BATCH, replace=False)]
    try:
        # ---- the main path, counted ----
        timed = Clock()
        FUSED_TOPK.launches = 0
        answers = {
            "k100": timed("ANN /recommend k=100",
                          lambda: ann_srv.get(f"/recommend?uid={ask[0]}&k={TOPK}")),
            "k100_seen": timed("ANN /recommend k=100 remove_seen", lambda: ann_srv.get(
                f"/recommend?uid={ask[1]}&k={TOPK}&remove_seen=true")),
            "all": timed("ANN /recommend (no k: whole catalog)",
                         lambda: ann_srv.get(f"/recommend?uid={ask[2]}")),
            "bpr": timed("BPR /recommend k=100",
                         lambda: bpr_srv.get(f"/recommend?uid={ask[0]}&k={TOPK}")),
        }
        feedback = timed("BPR /feedback", lambda: bpr_srv.post(
            f"/feedback?uid={ask[0]}&iid={train.item_ids[0]}&rating=5"))
        evaluated = timed("BPR /evaluate", lambda: bpr_srv.post(
            "/evaluate", {"metrics": ["RMSE()", "Recall(k=10)"], "data": test}))
        batch_recs = timed(f"BPR.recommend_batch {SERVE_BATCH} users k={TOPK}",
                           lambda: bpr.recommend_batch(batch_users, k=TOPK))
        launches = FUSED_TOPK.launches
        timed.report("main path")
        log(f"  main path: {sum(timed.seconds.values()):.2f} s, fused_topk launches {launches}")
        if launches <= 0:
            raise AssertionError("the main path never launched the fused_topk kernel")
    finally:
        for s in servers:
            s.close()
    launches += mesh_index_check(mesh, bpr, ann, batch_users, train)

    # ---- check every answer against the plain version ----
    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(bpr.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(bpr.get_item_vectors(), np.float32), device=dev)
    iid = train.iid_map
    relaxed = 0

    def seen_of(u):
        return set(csr.getrow(u).indices.tolist())

    for key, uid, k, remove in (("k100", ask[0], TOPK, False), ("k100_seen", ask[1], TOPK, True),
                                ("all", ask[2], N_ITEMS, False), ("bpr", ask[0], TOPK, False)):
        u = train.uid_map[uid]
        got = [[iid[i] for i in answers[key]["recommendations"]]]
        want = reference_lists(Ud[[u]], Vd, k, [seen_of(u) if remove else set()])
        S = plain_scores(Ud[[u]], Vd).cpu().numpy()
        relaxed += check_lists(got, want, S, f"/recommend {key}")
    users = np.array([train.uid_map[u] for u in batch_users])
    got = [[iid[i] for i in row] for row in batch_recs]
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    S = plain_scores(Ud[users], Vd).cpu().numpy()
    relaxed += check_lists(got, want, S, "recommend_batch")
    if feedback.get("message") != "Feedback added":
        raise AssertionError(f"/feedback answered {feedback}")
    res = evaluated["result"]
    recall, rmse = res["Recall@10"], res["RMSE"]
    want_recall = reference_recall(bpr, csr, test, train, 10)
    if not (np.isfinite(rmse) and rmse > 0 and abs(recall - want_recall) <= 1e-6):
        raise AssertionError(f"/evaluate answered {res}, plain Recall@10 {want_recall}")
    log(f"  /evaluate: RMSE {rmse:.4f}, Recall@10 {recall:.6f} (plain {want_recall:.6f}) "
        f"over {len(evaluated['user_result']['RMSE'])} users")
    log(f"slice: ok, answers match the plain version (positions relaxed as near-ties: {relaxed})")
    device_share(f"recommend_batch {SERVE_BATCH} users",
                 lambda: bpr.recommend_batch(batch_users, k=TOPK))
    return launches, bpr, users


def start_mesh():
    """The (data, model) mesh of one rank over NCCL that ``make_mesh``
    starts in a process with no group (this process only: the spawned
    bench processes never join it). Raises unless it is NCCL's."""
    import torch.distributed as dist

    from cornac_tpu_torch.parallel import make_mesh

    import torch

    t = time.perf_counter()
    mesh = make_mesh()
    if dist.get_backend() != "nccl" or tuple(mesh.mesh.shape) != (1, 1):
        raise AssertionError(f"make_mesh gave {mesh} over {dist.get_backend()}")
    for axis in ("data", "model"):  # NCCL makes a group's communicator at its first call
        dist.all_reduce(torch.ones(1, device=DEV), group=mesh.get_group(axis))
    torch.cuda.synchronize()
    log(f"  world-size-1 NCCL group and (data, model) mesh {tuple(mesh.mesh.shape)}, both "
        f"axes' communicators made: {time.perf_counter() - t:.3f} s")
    return mesh


def mesh_index_check(mesh, bpr, ann, batch_users, train):
    """``TPUExactANN(bpr, mesh=...)`` (world size 1) at the serving widths:
    the top-k of ``SERVE_BATCH`` users through ``sharded_topk``, the same
    ids as the plain index's. Returns its fused_topk launches, which must
    be more than none."""
    from cornac_tpu_torch.models import TPUExactANN
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    q = bpr.get_user_vectors()[[train.uid_map[u] for u in batch_users]]
    clock = Clock()
    before = FUSED_TOPK.launches
    sharded = TPUExactANN(bpr, mesh=mesh)
    clock("TPUExactANN(mesh=...).build_index", sharded.build_index)
    got, dist_got = clock("its knn_query, first", lambda: sharded.knn_query(q, TOPK))
    clock("its knn_query, again", lambda: sharded.knn_query(q, TOPK))
    launches = FUSED_TOPK.launches - before
    want, dist_want = clock("the plain index's knn_query", lambda: ann.knn_query(q, TOPK))
    clock.report("the sharded index")
    if launches <= 0 or sharded._rows_per_shard != N_ITEMS:
        raise AssertionError(f"the sharded index launched fused_topk {launches} times over "
                             f"{sharded._rows_per_shard} rows a shard")
    if not np.array_equal(got, want) or not np.array_equal(dist_got, dist_want):
        raise AssertionError("TPUExactANN(mesh=...) differs from the plain index")
    log(f"  TPUExactANN(mesh=...), world size 1, {SERVE_BATCH} users x {N_ITEMS:,} items, "
        f"k={TOPK}: the plain index's ids and distances; fused_topk launches {launches}")
    return launches


def profile_call(fn, with_prof=False):
    """One call of ``fn`` under torch.profiler: (host-clock ms, summed time
    of the device-side events (kernels, copies) in ms, their count, the
    events, and the profiler itself if ``with_prof``). Host-side ops
    (``aten::topk``) are left out, since their device time is that of the
    kernels they launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = wall_ms, busy_ms, sum(e.count for e in events), events
    return (*out, prof) if with_prof else out


def top_ops(events, n=4):
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
    return ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms" for e in top)


def device_share(label, fn):
    """Device-busy share of one warm call of ``fn``: the device-side time
    the profiler saw over the call's host-clock duration."""
    fn()  # warm
    wall_ms, busy_ms, _, events = profile_call(fn)
    if not events:
        log(f"  profile, {label}: the profiler saw no device time (device share not measured)")
        return
    log(f"  profile, {label}: {wall_ms:.1f} ms host clock, "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%); top device ops: "
        + top_ops(events))


def reference_recall(bpr, csr, test, train, k):
    """Recall@k per test user, averaged, from plain scores with train items
    excluded (the eval loop's candidate rule, rating threshold 1)."""
    import torch

    by_user = {}
    for uid, iid, _ in test:
        by_user.setdefault(train.uid_map[uid], set()).add(train.iid_map[iid])
    users = sorted(by_user)
    U, V, Bi = (torch.as_tensor(a, device=DEV)
                for a in (bpr.u_factors[users], bpr.i_factors, bpr.i_biases))
    S = plain_scores(U, V, Bi)
    for b, u in enumerate(users):
        S[b, torch.as_tensor(csr.getrow(u).indices, device=S.device, dtype=torch.long)] = -torch.inf
    top = torch.sort(S, dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
    return float(np.mean([len(set(top[b].tolist()) & by_user[u]) / len(by_user[u])
                          for b, u in enumerate(users)]))


# MovieLens 1M and 10M widths; the ratings are generated from the seed
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS, ML1M_MAX_DEGREE = 6_040, 3_706, 1_000_209, 2_314
KNN_K = 50


def ml1m_triples(seed):
    """(user, item, whole-star rating) triples at the MovieLens 1M widths:
    every user rates at least 20 items (heavy-tailed activity, at most
    2,314 as in ML-1M), items are drawn by a Zipf-like popularity without
    replacement per user (Gumbel top-k), ratings 1-5 from user and item
    offsets plus noise."""
    rng = np.random.RandomState(seed)
    n_u, n_i, total = ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS
    weights = rng.lognormal(0.0, 1.2, n_u)
    deg = 20 + np.floor(weights / weights.sum() * (total - 20 * n_u)).astype(np.int64)
    deg = np.minimum(deg, ML1M_MAX_DEGREE)
    while deg.sum() < total:
        room = np.flatnonzero(deg < ML1M_MAX_DEGREE)
        deg[rng.choice(room, size=min(total - deg.sum(), len(room)), replace=False)] += 1
    logp = -0.8 * np.log(np.arange(1, n_i + 1))
    users, items = [], []
    for s0 in range(0, n_u, 512):
        block = np.arange(s0, min(s0 + 512, n_u))
        order = np.argsort(-(logp[None, :] + rng.gumbel(size=(len(block), n_i))), axis=1)
        for b, u in enumerate(block):
            items.append(order[b, : deg[u]])
            users.append(np.full(deg[u], u))
    users, items = np.concatenate(users), np.concatenate(items)
    ub, ib = rng.normal(0, 0.5, n_u), rng.normal(0, 0.6, n_i)
    r = np.clip(np.rint(3.6 + ub[users] + ib[items] + rng.normal(0, 0.9, total)), 1, 5)
    perm = rng.permutation(total)
    uids = [f"u{u}" for u in range(n_u)]
    iids = [f"i{i}" for i in range(n_i)]
    return [(uids[u], iids[i], float(x)) for u, i, x in zip(users[perm], items[perm], r[perm])]


def ml10m_dataset(seed):
    """A ``Dataset`` at the MovieLens 10M widths straight from seeded numpy
    arrays: 10,000,054 distinct (user, item) pairs (duplicates dropped
    in draw order), heavy-tailed user activity, Zipf-like item popularity,
    half-star ratings 0.5-5.0."""
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    rng = np.random.RandomState(seed + 10)
    n_u, n_i, n_r = ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS
    act = rng.lognormal(0.0, 1.0, n_u)
    pop = np.arange(1, n_i + 1) ** -0.8
    draw = int(n_r * 1.4)  # about 1 in 6 of the first draws repeats a pair
    u = rng.choice(n_u, size=draw, p=act / act.sum())
    i = rng.choice(n_i, size=draw, p=pop / pop.sum())
    _, first = np.unique(u.astype(np.int64) * n_i + i, return_index=True)
    if len(first) < n_r:
        raise AssertionError(f"only {len(first)} distinct pairs drawn")
    keep = np.sort(first)[:n_r]
    return Dataset(
        num_users=n_u, num_items=n_i,
        uid_map=OrderedDict((x, x) for x in range(n_u)),
        iid_map=OrderedDict((x, x) for x in range(n_i)),
        uir_tuple=(u[keep].astype(np.int64), i[keep].astype(np.int64),
                   rng.randint(1, 11, size=n_r) / 2.0),
        seed=seed,
    )


def check_neighbours(model, ids, sims, what):
    """A model's neighbour table (from the kernel) equal, index for index
    and bit for bit, to the plain version on the same weight matrix;
    returns that matrix, on the card."""
    import torch

    from cornac_tpu_torch.models.knn import dense_f32
    from cornac_tpu_torch.ops.cosine_topk import cosine_topk_torch

    W = dense_f32(model._weight_mat, torch.device(DEV))
    ps, pi = cosine_topk_torch(W, ids.shape[1])
    if not np.array_equal(ids, pi.cpu().numpy()):
        raise AssertionError(f"{what}: {int((ids != pi.cpu().numpy()).sum())} neighbour "
                             "indices differ from the plain version")
    if not np.array_equal(sims, ps.cpu().numpy().astype(np.float64)):
        raise AssertionError(f"{what}: neighbour similarities differ from the plain version")
    log(f"  {what}: {ids.shape[0]} x {ids.shape[1]} table equal to the plain version, "
        f"index for index")
    return W


def phase_knn_ml1m(seed, work):
    """RatioSplit -> Experiment(ItemKNN, UserKNN) -> nearest_items /
    nearest_users -> save -> the standalone server, at the ML-1M widths."""
    import torch

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, NDCG, Recall
    from cornac_tpu_torch.models import ItemKNN, UserKNN
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    data = clock("generate 1,000,209 ratings (set-up)", lambda: ml1m_triples(seed))
    iknn, uknn = ItemKNN(k=KNN_K, verbose=False), UserKNN(k=KNN_K, verbose=False)

    # ---- the main path, counted ----
    COSINE_TOPK.launches = FUSED_TOPK.launches = 0
    split = clock("RatioSplit", lambda: RatioSplit(
        data, test_size=0.2, rating_threshold=4.0, exclude_unknowns=True, seed=123))
    exp = Experiment(split, [iknn, uknn], [Recall(k=10), NDCG(k=10), AUC()])
    clock("Experiment.run (fit + ranking eval, both models)", exp.run)
    item_nn = clock("ItemKNN.nearest_items(50)", lambda: iknn.nearest_items(num_neighbors=KNN_K))
    user_nn = clock("UserKNN.nearest_users(50)", lambda: uknn.nearest_users(num_neighbors=KNN_K))
    path = clock("ItemKNN.save", lambda: iknn.save(str(work / "knn")))
    rng = np.random.RandomState(seed + 2)
    ask = [iknn.user_ids[u] for u in rng.choice(iknn.num_users, 4, replace=False)]
    srv = clock("load_model + start the server", lambda: Served(path, "cornac_tpu_torch.models.ItemKNN"))
    try:
        answers = [clock(f"ItemKNN /recommend uid={uid} k=10",
                         lambda uid=uid: srv.get(f"/recommend?uid={uid}&k=10")) for uid in ask]
    finally:
        srv.close()
    launches, fused = COSINE_TOPK.launches, FUSED_TOPK.launches
    clock.report("KNN main path")
    log(f"  KNN main path (ML-1M): {sum(clock.seconds.values()):.2f} s, cosine_topk launches "
        f"{launches}, fused_topk launches {fused}")
    if launches < 2:
        raise AssertionError("nearest_items / nearest_users did not launch the cosine kernel")

    # ---- check what came out ----
    for res in exp.result:
        vals = [v for k, v in res.metric_avg_results.items() if "(s)" not in k]
        if len(vals) != 3 or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"{res.model_name}: bad metrics {res.metric_avg_results}")
    log("  metric table (ML-1M widths, seeded ratings):\n" + str(exp.result).rstrip())
    W_items = check_neighbours(iknn, *item_nn, "ItemKNN.nearest_items")
    W_users = check_neighbours(uknn, *user_nn, "UserKNN.nearest_users")
    inv = {v: k for k, v in iknn.iid_map.items()}
    for uid, ans in zip(ask, answers):
        scores = iknn.score_batch(np.array([iknn.uid_map[uid]]))[0]
        got = np.array([iknn.iid_map[i] for i in ans["recommendations"]])
        want = np.argsort(-scores, kind="stable")[:10]
        # np.argsort in rank() is not stable: equal scores may come in any order
        if len(set(got.tolist())) != 10 or not np.array_equal(scores[got], scores[want]):
            raise AssertionError(f"/recommend uid={uid}: {[inv[i] for i in got]} is not a "
                                 f"best-10 ranking of score_batch")
    log(f"  served ItemKNN: {len(ask)} /recommend answers equal to a stable ranking of score_batch")
    batch = np.arange(256)  # one eval batch scores users like this, 16 per device call
    for model in (iknn, uknn):
        device_share(f"{model.name}.score_batch of 256 users", lambda m=model: m.score_batch(batch))
    log(f"KNN slice (ML-1M): ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, W_items, W_users


def phase_knn_ml10m(seed):
    """ItemKNN(k=50).fit + nearest_items(50) at the ML-10M widths."""
    import torch

    from cornac_tpu_torch.models import ItemKNN
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK

    clock = Clock()
    train = clock("Dataset from numpy (set-up)", lambda: ml10m_dataset(seed))
    model = ItemKNN(k=KNN_K, verbose=False)

    # ---- the main path, counted ----
    COSINE_TOPK.launches = 0
    clock("ItemKNN.fit", lambda: model.fit(train))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ids, sims = clock("ItemKNN.nearest_items(50)", lambda: model.nearest_items(num_neighbors=KNN_K))
    peak = torch.cuda.max_memory_allocated() - held
    launches = COSINE_TOPK.launches
    clock.report("related items")
    dense_bytes = 4 * train.num_items * train.num_users
    log(f"  nearest_items(50): peak device memory {peak / 1e9:.3f} GB above what the fit left, "
        f"against {dense_bytes / 1e9:.3f} GB for a dense float32 W")
    if peak >= dense_bytes:
        raise AssertionError("nearest_items built a dense W on the card")
    log(f"  related items (ML-10M): {train.num_ratings} ratings, {train.num_users} users x "
        f"{train.num_items} items, ui_centered {model.ui_centered.nbytes / 1e9:.2f} GB and "
        f"sim_mat {model.sim_mat.nbytes / 1e9:.2f} GB float64 on the host; cosine_topk launches "
        f"{launches}")
    if launches < 1:
        raise AssertionError("nearest_items did not launch the cosine kernel")
    W = check_neighbours(model, ids, sims, "ItemKNN.nearest_items (ML-10M)")
    log(f"related items (ML-10M): ok in {sum(clock.seconds.values()):.1f} s")
    from cornac_tpu_torch.models.knn import compute_similarity

    part = Clock()  # where the fit's time goes: the similarity matrix alone
    part("compute_similarity (dense W on the card, 6 x 3 products, to host f64)",
         lambda: compute_similarity(model._weight_mat))
    part.report("ItemKNN.fit part")
    return launches, W, train


BENCH_R05 = {"AUC": 0.9331, "NDCG@10": 0.1694}  # BENCH_r05.json: the TPU run, its W16 path
BENCH_BPR = dict(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01, seed=123,
                 batch_size=4096)


def ranking_quality(model, split):
    """bench.py's metrics of ``model`` on the split's test users."""
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval
    from cornac_tpu_torch.metrics import AUC, MAP, NDCG, Precision, Recall

    metrics = [AUC(), MAP(), NDCG(k=10), Precision(k=10), Recall(k=10)]
    avg, _ = ranking_eval(model, metrics, split.train_set, split.test_set,
                          rating_threshold=4.0, exclude_unknowns=True)
    return {m.name: float(a) for m, a in zip(metrics, avg)}


def epoch_profile(fit, n_batches, epochs):
    """Device-busy share and device events per minibatch of ``epochs``
    epochs: profiles of a fit of ``epochs`` epochs and of one of none
    (the fit's set-up alone), differenced."""
    one = profile_call(lambda: fit(0))
    more = profile_call(lambda: fit(epochs))
    wall, busy = more[0] - one[0], more[1] - one[1]
    return dict(wall_ms=wall, busy_ms=busy, share=busy / wall,
                launches_per_minibatch=(more[2] - one[2]) / (epochs * n_batches),
                top=top_ops(more[3]))


def phase_trainer_bench(bench_data, mesh):
    """RatioSplit -> BPR.fit -> ranking_eval at the bench.py shape, the
    quality band, a verbose refit bit for bit, then an Experiment with the
    other trainers and the baselines. ``bench_data()`` gives
    ``make_ml100k_like(seed=7)``'s triples."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, MAE, MAP, NDCG, RMSE, Precision, Recall
    from cornac_tpu_torch.models import BPR, MF, MMMF, WBPR, BaselineOnly, GlobalAvg, MostPop
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    clock = Clock()
    data = clock("make_ml100k_like(seed=7) (set-up; what is left of it, made in a second "
                 "process)", bench_data)
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    clock("BPR.fit, 1 epoch (warm-up)", lambda: BPR(**{**BENCH_BPR, "max_iter": 1}).fit(train))
    bpr = clock("BPR.fit", lambda: BPR(**BENCH_BPR).fit(train))
    quality = clock("ranking_eval (AUC, MAP, NDCG@10, P@10, R@10)",
                    lambda: ranking_quality(bpr, split))
    mesh_eval = mesh_eval_check(clock, mesh, data, split, bpr)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        again = clock("BPR.fit, verbose=True",
                      lambda: BPR(**BENCH_BPR, verbose=True).fit(train))
    exp = Experiment(split, [
        BPR(**BENCH_BPR), MMMF(**{**BENCH_BPR, "lambda_reg": 0.001}), WBPR(**BENCH_BPR),
        MF(k=10, max_iter=20, seed=123),
        BaselineOnly(seed=123), GlobalAvg(), MostPop(),
    ], [AUC(), MAP(), NDCG(k=10), Precision(k=10), Recall(k=10), RMSE(), MAE()])
    clock("Experiment.run (7 models)", exp.run)
    launches = ACCUMULATE_ROWS.launches
    clock.report("trainers at the bench shape")
    train_s = clock.seconds["BPR.fit"]
    test_s = clock.seconds["ranking_eval (AUC, MAP, NDCG@10, P@10, R@10)"]
    log(f"  BPR at the bench shape: train {train_s:.3f} s, test {test_s:.3f} s (host clock, after "
        f"a 1-epoch warm-up); " + ", ".join(f"{k} {v:.4f}" for k, v in quality.items())
        + f"; accumulate_rows launches {launches}")
    if launches <= 0:
        raise AssertionError("the trainers never launched the accumulate_rows kernel")

    # ---- check what came out ----
    for name in ("AUC", "NDCG@10"):
        lo, hi, mean, spread = band("BPR", name)
        log(f"  {name} {quality[name]:.6f}: band [{lo:.6f}, {hi:.6f}] (JAX package on a CPU, "
            f"mean {mean:.6f} +/- 3 x {spread:.3e}); BENCH_r05.json (TPU) {BENCH_R05[name]} is "
            + ("inside" if lo <= BENCH_R05[name] <= hi else "outside") + " the band")
        if not lo <= quality[name] <= hi:
            raise AssertionError(f"bench-shape {name} {quality[name]:.6f} is outside its band")
    for name in ("u_factors", "i_factors", "i_biases"):
        if not np.array_equal(getattr(bpr, name), getattr(again, name)):
            raise AssertionError(f"two seeded fits differ in {name} (one verbose)")
    lines = out.getvalue().strip().splitlines()
    epochs = BENCH_BPR["max_iter"]
    if len(lines) != epochs + 1 or not lines[-2].startswith(f"Epoch {epochs}/{epochs}, correct: "):
        raise AssertionError(f"verbose fit printed {len(lines)} lines, the last {lines[-2:]}")
    log(f"  two seeded fits, one verbose (chunks of one epoch): factors identical, bit for bit; "
        f"its last report: {lines[-2]}")
    for res in exp.result:
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        bad = [k for k, v in vals.items() if not np.isfinite(v)
               or (k not in ("RMSE", "MAE") and not 0.0 <= v <= 1.0)]
        if len(vals) != 7 or bad:
            raise AssertionError(f"{res.model_name}: bad metrics {res.metric_avg_results}")
    n_batches = -(-train.num_ratings // BENCH_BPR["batch_size"])
    prof = epoch_profile(lambda e: BPR(**{**BENCH_BPR, "max_iter": e}).fit(train), n_batches, 10)
    log(f"  profile, 10 BPR epochs at the bench shape (a 10-epoch fit minus a 0-epoch fit): "
        f"{prof['wall_ms']:.1f} ms host clock, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['share']:.2f}%), {prof['launches_per_minibatch']:.1f} device events per "
        f"minibatch; top device ops: {prof['top']}")
    log(f"trainers at the bench shape: ok in {sum(clock.seconds.values()):.1f} s")
    return launches, dict(quality=quality, train_s=train_s, test_s=test_s, mesh_eval=mesh_eval,
                          **prof)


def mesh_eval_check(clock, mesh, data, split, bpr):
    """``RatioSplit(mesh=...)`` (world size 1) evaluating the fitted BPR
    (frozen: ``init_params``, ``trainable=False``) at the bench shape: its
    AUC, NDCG@10 and Recall@5 must equal the plain split's evaluation of
    the same model exactly. Returns the sharded evaluation's seconds."""
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, NDCG, Recall
    from cornac_tpu_torch.models import BPR

    def frozen():
        return BPR(k=bpr.k, trainable=False, init_params={
            "U": bpr.u_factors, "V": bpr.i_factors, "Bi": bpr.i_biases})

    def evaluate(method):
        res, _ = method.evaluate(frozen(), [AUC(), NDCG(k=10), Recall(k=5)], user_based=True,
                                 show_validation=False)
        return {k: res.metric_avg_results[k] for k in ("AUC", "NDCG@10", "Recall@5")}

    msplit = clock("RatioSplit(0.2, 4.0, seed=123, mesh=...) (set-up)", lambda: RatioSplit(
        data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False, mesh=mesh))
    got = clock("RatioSplit(mesh=...).evaluate, world size 1", lambda: evaluate(msplit))
    want = clock("RatioSplit.evaluate (the plain split)", lambda: evaluate(split))
    if got != want:
        raise AssertionError(f"RatioSplit(mesh=...) gave {got}, the plain split {want}")
    log("  RatioSplit(mesh=...), world size 1, evaluating the fitted BPR: " + ", ".join(
        f"{k} {v:.6f}" for k, v in got.items()) + " (the plain evaluation's, exactly)")
    return clock.seconds["RatioSplit(mesh=...).evaluate, world size 1"]


def phase_canary(gen):
    """The canary kernel against ``x * 2`` on the card, bit for bit, at the
    probe's (128, 128), at sizes that are no multiple of 4, end inside a
    block or span many, and on views that are not 16-byte aligned (the
    scalar kernel)."""
    import torch

    from cornac_tpu_torch.ops.canary import CANARY, scale2, scale2_torch

    shapes = [(128, 128), (1,), (3,), (255,), (257,), (1026,), (3, 1000, 7),
              (64 * 1024 * 1024 + 3,)]
    cases = [(str(shape), torch.randn(shape, generator=gen, device=DEV)) for shape in shapes]
    base = torch.randn(4 * 4099, generator=gen, device=DEV)
    cases += [(f"view at offset {off} of {n}", base[off:off + n])
              for off, n in ((1, 16384), (2, 1027), (3, 5), (4, 4095))]
    cases.append(("rows 1-127 of (128, 129)",
                  torch.randn(128, 129, generator=gen, device=DEV)[1:]))
    unaligned = 0
    for what, x in cases:
        unaligned += x.data_ptr() % 16 != 0
        before = CANARY.launches
        y = scale2(x, force="kernel")
        torch.cuda.synchronize()
        if CANARY.launches != before + 1:
            raise AssertionError(f"canary {what}: the kernel was not launched")
        if not torch.equal(y, scale2_torch(x)):
            raise AssertionError(f"canary {what}: differs from x * 2")
    del cases, base
    log(f"canary vs plain: ok, {len(shapes) + 5} inputs up to {shapes[-1][0]:,} elements, "
        f"{unaligned} of them not 16-byte aligned (the scalar kernel), bit for bit x * 2")
    return 0.0


def load_probe():
    """``tools/cuda_on_silicon.py`` as a module (``tools/`` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("cuda_on_silicon",
                                                  ROOT / "tools" / "cuda_on_silicon.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_probe():
    """The canary's path: the on-silicon probe (``tools/cuda_on_silicon.py``),
    canary, fused_topk and cosine_topk, each cold and warm under its own
    timeout, held to their plain versions; it writes
    ``build/cuda_silicon.json``."""
    from cornac_tpu_torch.ops.canary import CANARY
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    probe = load_probe()
    # ---- the main path, counted ----
    CANARY.launches = FUSED_TOPK.launches = COSINE_TOPK.launches = 0
    record = probe.probe(timeout=240)
    launches = dict(canary=CANARY.launches, fused_topk=FUSED_TOPK.launches,
                    cosine_topk=COSINE_TOPK.launches)
    for name, step in record["steps"].items():
        log(f"  probe {name}: cold {step.get('cold_s', float('nan')):.4f} s (host clock: load "
            f"or build, first launch, synchronise), warm {step.get('ms', float('nan')):.4f} ms "
            f"(CUDA events), plain {step.get('plain_ms', float('nan')):.4f} ms, library "
            f"{step.get('library_ms', float('nan')):.4f} ms; error {step['error']}")
    if not record["ok"]:
        raise AssertionError(f"the on-silicon probe failed: {record['steps']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the probe did not launch every kernel: {launches}")
    log(f"on-silicon probe: ok, launches {launches}, wrote build/cuda_silicon.json")
    return launches, record


def host_us(fn, reps):
    """Host microseconds a call of ``fn`` takes to return, over ``reps``
    calls in a row (no sync inside)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    out = 1e6 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return out


def device_us(fn, name, reps=100):
    """(the profiler's mean device time of the kernels whose name holds
    ``name``, over ``reps`` calls of ``fn``; the median of CUDA events
    around one call after a synchronise, over ``reps`` calls), in us. The
    first is None where the profiler kept no such event."""
    import torch

    _, _, _, events = profile_call(lambda: [fn() for _ in range(reps)])
    hits = [e for e in events if name in e.key]
    prof = (sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits)
            if hits else None)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end))
    return prof, float(np.median(times))


def phase_canary_times():
    """The canary at the probe's (128, 128) beside ``torch.mul`` and ``x *
    2``: CUDA-event ms over 500 calls in a row (what a caller's loop sees),
    the bound (64 KiB read and 64 KiB written over 3.35 TB/s), and each
    call split into its device time (the profiler's kernel time; CUDA
    events around one call) and its host time (``time.perf_counter`` over
    500 calls), the canary's host time split into its steps: the checks,
    ``torch.empty_like``, the device and its stream, the packed ctypes call
    that returns before the launch (n = 0), and the C side's launch (the
    full call on a kept output minus that)."""
    import torch

    from cornac_tpu_torch.ops.canary import CANARY, scale2_torch

    x = torch.randn(128, 128, device=DEV)
    reps = 500
    plain_ms = time_ms(lambda: scale2_torch(x), reps)
    ms = time_ms(lambda: CANARY(x), reps)
    library_ms = time_ms(lambda: torch.mul(x, 2), reps)
    bound_ms = 1e3 * 2 * 4.0 * x.numel() / PEAK_BYTES

    calls = {"canary": lambda: CANARY(x), "torch.mul": lambda: torch.mul(x, 2),
             "x * 2": lambda: x * 2}
    # every host time before the profiles of the device times
    split = {what: dict(host_us=host_us(fn, reps)) for what, fn in calls.items()}
    out = torch.empty_like(x)
    index = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    call = CANARY._call
    steps = {
        "checks": lambda: (isinstance(x, torch.Tensor) and x.is_cuda
                           and x.dtype == torch.float32 and x.is_contiguous()),
        "torch.empty_like": lambda: torch.empty_like(x),
        "device and stream": lambda: torch._C._cuda_getCurrentRawStream(x.get_device()),
        "packed ctypes call, no launch": lambda: call(index, x.data_ptr(), out.data_ptr(), 0,
                                                      stream),
        "packed ctypes call with the launch": lambda: call(index, x.data_ptr(), out.data_ptr(),
                                                           x.numel(), stream),
    }
    step_us = {what: host_us(fn, reps) for what, fn in steps.items()}
    step_us["the launch (C side)"] = (step_us.pop("packed ctypes call with the launch")
                                      - step_us["packed ctypes call, no launch"])
    for what, fn in calls.items():
        prof, event = device_us(fn, "scale2" if what == "canary" else "elementwise")
        split[what].update(device_prof_us=prof, device_event_us=event)
    if not torch.equal(out, x * 2):
        raise AssertionError("canary: the timed launches left a wrong output")

    def fmt(v):
        return "not measured" if v is None else f"{v:.3f} us"

    log(f"  times canary (128, 128): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mul "
        f"{library_ms:.4f} ms (CUDA events over {reps} calls in a row), bound {bound_ms:.6f} ms "
        f"(bytes), {100 * bound_ms / ms:.3f}% of bound")
    for what, row in split.items():
        log(f"  split {what}: host {row['host_us']:.3f} us a call (perf_counter over {reps}), "
            f"device {fmt(row['device_prof_us'])} (profiler) / {row['device_event_us']:.3f} us "
            f"(events around one call)")
    log("  canary's host steps: " + ", ".join(f"{k} {v:.3f} us" for k, v in step_us.items())
        + f"; sum {sum(step_us.values()):.3f} us")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes", split=split, host_steps_us=step_us)


def factor_configs():
    """(band name, maker, fitted attributes) of ``benchmarks/model_sweep.py``'s
    configurations of the factor family, and MF with adam and dropout."""
    from cornac_tpu_torch import models as M

    return [
        ("PMF", lambda **kw: M.PMF(k=10, max_iter=100, seed=123, **kw), ("U", "V")),
        ("NMF", lambda **kw: M.NMF(k=15, max_iter=50, seed=123, **kw),
         ("u_factors", "i_factors")),
        ("WMF", lambda **kw: M.WMF(k=50, max_iter=30, seed=123, **kw), ("U", "V")),
        ("EASE", lambda **kw: M.EASE(lamb=500, **kw), ("B",)),
        ("IBPR", lambda **kw: M.IBPR(**{"k": 10, "max_iter": 20, "seed": 123, **kw}), ("U", "V")),
        ("COE", lambda **kw: M.COE(k=10, max_iter=20, seed=123, **kw), ("U", "V")),
        ("MF-adam", lambda **kw: M.MF(**{"k": 10, "max_iter": 20, "optimizer": "adam",
                                         "dropout": 0.1, "seed": 123, **kw}),
         ("u_factors", "i_factors", "u_biases", "i_biases")),
    ]


# the second seeded fits that hold a trainer's bits run this many epochs
# (or sweeps) where a whole fit's eager steps take tens of seconds
SHORT_DEPTH = 2
SHORT_REFITS = ("IBPR", "MF-adam")


def serve_factor_model(model, train, users, k=10):
    """B1 behind the model's serving entry point, held to the plain
    version: ``recommend_batch`` for a dot-measure model, else
    ``TPUExactANN(recall_target=0.95).knn_query`` (COE's L2). Returns the
    positions relaxed as near-ties."""
    import torch

    from cornac_tpu_torch.models import MEASURE_DOT, TPUExactANN

    dev = torch.device(DEV)
    U = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32)[users], device=dev)
    V = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    if model.get_vector_measure() == MEASURE_DOT:
        recs = model.recommend_batch([train.user_ids[u] for u in users], k=k)
        got = [[model.iid_map[i] for i in row] for row in recs]
        S = plain_scores(U, V)
    else:
        ann = TPUExactANN(model, recall_target=0.95)
        ann.build_index()
        got, _ = ann.knn_query(U.cpu().numpy(), k)
        S = -((U[:, None, :] - V[None, :, :]) ** 2).sum(-1)
    _, want = torch.sort(S, dim=1, descending=True, stable=True)
    return check_lists(got, want[:, :k].cpu().numpy(), S.cpu().numpy(),
                       f"{model.name} serving")


@contextlib.contextmanager
def recording_accumulate(store):
    """While open, the accumulate_rows wrapper keeps in ``store`` a copy of
    the inputs of its first call at each (table shape, ids, id stride) --
    the table as it was before the call -- and then launches as always."""
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, AccumulateRowsKernel

    class Recording(AccumulateRowsKernel):
        def __call__(self, table, ids, updates):
            key = (tuple(table.shape), ids.shape[0], ids.stride(0))
            if key not in store:
                store[key] = (table.clone(), ids.clone(), updates.clone())
            return super().__call__(table, ids, updates)

    ACCUMULATE_ROWS.__class__ = Recording
    try:
        yield store
    finally:
        ACCUMULATE_ROWS.__class__ = AccumulateRowsKernel


def check_recorded_accumulate(name, store):
    """Hold accumulate_rows to its plain version on the inputs a trainer
    handed it (``recording_accumulate``), with the ids at the stride the
    trainer gave them; not profiled (phase 5 sees one kernel a call at
    these shapes, and this late in the process the profiler loses a short
    kernel's events). Returns the largest |kernel - plain on the CPU|."""
    import torch

    max_err = 0.0
    for (shape, B, stride), (table, ids, upd) in store.items():
        if stride != 1:  # the first column of a (B, stride) tensor
            ids = torch.stack([ids, *[torch.zeros_like(ids)] * (stride - 1)], 1)[:, 0]
        err = check_accumulate(f"{name}'s own input, {B} ids into {shape}, id stride {stride}",
                               table, ids, upd, calls=0)[0]
        max_err = max(max_err, err)
    return max_err


def phase_factor_bench(bench_data):
    """RatioSplit -> Experiment with the factor family at the bench shape:
    each model's AUC and NDCG@10 in its band, fit seconds per model, B1
    behind each model's serving entry point, then a second seeded fit of
    each (verbose: one epoch or sweep a chunk) bit for bit, whose
    accumulate_rows inputs (the first at each shape) are held to the plain
    version."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set
    configs = factor_configs()
    users = np.random.RandomState(5).choice(train.num_users, 512, replace=False)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    exp = Experiment(split, [make(verbose=False) for _, make, _ in configs],
                     [AUC(), NDCG(k=10), Recall(k=10), RMSE(), MAE()])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clock("Experiment.run (7 factor models)", exp.run)
    relaxed = clock("B1 behind each model's serving entry point", lambda: [
        serve_factor_model(m, train, users) for m in exp.models if m.name != "EASEᴿ"])
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("factor family at the bench shape")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"the factor family launched accumulate_rows {launches} and "
                             f"fused_topk {fused} times")

    # ---- check what came out ----
    fit_s = {}
    for (name, _, _), model, res in zip(configs, exp.models, exp.result):
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{res.model_name}: non-finite metrics {vals}")
        fit_s[name] = res.metric_avg_results["Train (s)"]
        checks = []
        for metric in ("AUC", "NDCG@10"):
            lo, hi, _, spread = band(name, metric)
            value = vals[metric]
            inside = lo <= value <= hi
            checks.append(inside)
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] "
                f"({'one deterministic JAX fit +/- 1e-3' if spread is None else '5 JAX seeds'})"
                f" {'inside' if inside else 'OUTSIDE'}")
        log(f"  {name}: fit {fit_s[name]:.3f} s, test {res.metric_avg_results['Test (s)']:.3f} s "
            f"(host clock); " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(checks):
            raise AssertionError(f"{name}: outside its quality band")
    acc_err, recorded = 0.0, 0
    refits = Clock()
    for (name, make, attrs), model in zip(configs, exp.models):
        # IBPR's and MF-adam's eager steps took 40.8 and 42.4 s a fit: their
        # bits are held at a depth of 2 epochs, two fits of it
        short = {"max_iter": SHORT_DEPTH} if name in SHORT_REFITS else {}
        if short:
            model = refits(f"{name}.fit, {SHORT_DEPTH} epochs", lambda: make(**short).fit(train))
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = refits(f"{name}.fit, verbose=True" + (f", {SHORT_DEPTH} epochs" if short
                                                            else ""),
                           lambda: make(verbose=True, **short).fit(train))
        for attr in attrs:
            if not np.array_equal(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr} (one verbose)")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    refits.report("factor family, second fits")
    if recorded == 0:
        raise AssertionError("no trainer of the factor family handed accumulate_rows an input")
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.models import IBPR

    # a whole epoch of 800 minibatches would give the profiler about 160,000
    # device events, which costs a minute and makes later profiles in this
    # process lose events: one epoch over the first 5,000 ratings instead
    part = Dataset.from_uir(bench_data()[:5_000], seed=123)
    n_batches = -(-part.num_ratings // 100)
    prof = epoch_profile(lambda e: IBPR(k=10, max_iter=e, seed=123).fit(part), n_batches, 1)
    log(f"  profile, one IBPR epoch over the first {part.num_ratings} ratings ({n_batches} "
        f"minibatches of 100; a 1-epoch fit minus a 0-epoch fit): {prof['wall_ms']:.1f} ms host "
        f"clock, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['share']:.2f}%), {prof['launches_per_minibatch']:.1f} device events per "
        f"minibatch; top device ops: {prof['top']}")
    log(f"  every model: two seeded fits (the second verbose, in chunks of one epoch or sweep) "
        f"identical, bit for bit; accumulate_rows on the trainers' own inputs ({recorded} "
        f"shapes) equal to the plain version on the CPU, bit for bit (max |err| "
        f"{acc_err:.3e}); serving lists equal to the plain version (positions relaxed as "
        f"near-ties: {sum(relaxed)}); accumulate_rows launches {launches}, fused_topk "
        f"launches {fused}")
    log(f"factor family at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} s, "
        f"second fits {sum(refits.seconds.values()):.1f} s")
    return launches, fused, fit_s, acc_err


def factor_rest_configs():
    """(band name, maker, fitted attributes) of the factor family's rest:
    ``benchmarks/model_sweep.py``'s HPF, SKMeans and FM (als), PF (HPF with
    ``hierarchical=False``), FM's sgd and mcmc learners at
    ``examples/fm_example.py``'s settings, and ``examples/sansa_movielens.py``'s
    SANSA."""
    from cornac_tpu_torch import models as M

    fm = dict(k0=1, k1=1, k2=8, max_iter=100, learning_rate=0.01, seed=123)
    hpf = ("Gs", "Gr", "Ls", "Lr")
    return [
        ("HPF", lambda **kw: M.HPF(k=5, max_iter=100, seed=123, **kw), hpf),
        ("PF", lambda **kw: M.HPF(k=5, max_iter=100, seed=123, hierarchical=False, name="PF",
                                  **kw), hpf),
        ("SKMeans", lambda **kw: M.SKMeans(k=5, max_iter=100, seed=123, **kw),
         ("centroids", "final_par")),
        ("FM-als", lambda **kw: M.FM(k2=8, max_iter=50, method="als", seed=123, name="FM-als",
                                     **kw), ("w", "V")),
        ("FM-sgd", lambda **kw: M.FM(method="sgd", name="FM-sgd", **fm, **kw), ("w", "V")),
        ("FM-mcmc", lambda **kw: M.FM(method="mcmc", name="FM-mcmc", **fm, **kw), ("w", "V")),
        ("SANSA", lambda **kw: M.SANSA(l2=500.0, weight_matrix_density=0.01, **kw),
         ("W1", "W2")),
    ]


def same_bits(a, b):
    """Two fitted arrays (numpy or scipy sparse) equal bit for bit."""
    import scipy.sparse as sp

    if sp.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data))
    return np.array_equal(a, b)


def phase_factor_rest_bench(bench_data):
    """Phase 12c, RatioSplit -> Experiment with the factor family's rest at
    the bench shape: each model's AUC and NDCG@10 (and FM's RMSE) in its
    band, fit seconds per model, B1 behind HPF's, PF's and SANSA's
    recommend_batch held to the plain version, then a second seeded fit of
    each bit for bit, whose accumulate_rows inputs (the first at each
    shape) are held to the plain version on the CPU. Then phase 12d, the
    protocols (``phase_protocols_bench``), in the same process."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit, rating_eval
    from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set
    configs = factor_rest_configs()
    users = np.random.RandomState(5).choice(train.num_users, 512, replace=False)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    exp = Experiment(split, [make(verbose=False) for _, make, _ in configs],
                     [AUC(), NDCG(k=10), Recall(k=10), RMSE(), MAE()])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clock(f"Experiment.run ({len(configs)} models)", exp.run)
    relaxed = clock("B1 behind HPF's, PF's and SANSA's recommend_batch", lambda: [
        serve_factor_model(m, train, users) for m in exp.models if m.name in ("HPF", "PF", "SANSA")])
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("factor family's rest at the bench shape")
    if launches <= 0 or fused < 3:
        raise AssertionError(f"the factor family's rest launched accumulate_rows {launches} and "
                             f"fused_topk {fused} times")

    # ---- check what came out ----
    fit_s = {}
    for (name, _, _), model, res in zip(configs, exp.models, exp.result):
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{res.model_name}: non-finite metrics {vals}")
        fit_s[name] = res.metric_avg_results["Train (s)"]
        if name.startswith("FM"):
            # the band's RMSE is over the test ratings (the Experiment's
            # averages each user's first)
            vals["RMSE over ratings"] = rating_eval(model, [RMSE()], split.test_set)[0][0]
        checks = []
        for metric in ("AUC", "NDCG@10") + (("RMSE",) if name.startswith("FM") else ()):
            lo, hi, _, spread = band(name, metric)
            value = vals["RMSE over ratings" if metric == "RMSE" else metric]
            inside = lo <= value <= hi
            checks.append(inside)
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] "
                f"({'one deterministic JAX fit +/- 1e-3' if spread is None else '5 JAX seeds'})"
                f" {'inside' if inside else 'OUTSIDE'}")
        log(f"  {name}: fit {fit_s[name]:.3f} s, test {res.metric_avg_results['Test (s)']:.3f} s "
            f"(host clock); " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(checks):
            raise AssertionError(f"{name}: outside its quality band")
    acc_err, recorded = 0.0, 0
    refits = Clock()
    for (name, make, attrs), model in zip(configs, exp.models):
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = refits(f"{name}.fit", lambda: make(verbose=False).fit(train))
        for attr in attrs:
            if not same_bits(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    refits.report("factor family's rest, second fits")
    seg = seg_sum_probe(train)
    if recorded < 4:  # HPF's and PF's two shapes, FM-sgd's w and V
        raise AssertionError(f"the factor family's rest recorded {recorded} accumulate_rows shapes")
    log(f"  every model: two seeded fits identical, bit for bit; accumulate_rows on the trainers' "
        f"own inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit (max "
        f"|err| {acc_err:.3e}); serving lists equal to the plain version (positions relaxed as "
        f"near-ties: {sum(relaxed)}); accumulate_rows launches {launches}, fused_topk launches "
        f"{fused}")
    log(f"factor family's rest at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} "
        f"s, second fits {sum(refits.seconds.values()):.1f} s")
    proto = phase_protocols_bench(bench_data)
    proto["seg_sum"] = seg
    return (launches + proto["launches"], fused + proto["fused"], fit_s, acc_err, proto)


def seg_sum_probe(train):
    """FM-ALS's ``_seg_sum`` at the bench shape: the segment sums of 80,000
    rows of two columns into the user block on the card, held to the same
    sums on the CPU and to a float64 sum (atol 1e-3: a float32 prefix sum's
    error grows with its running total), beside ``accumulate_rows``' sums
    (batch order), both timed with CUDA events; and, reported, how far one
    float32 ALS sweep on the card lies from the same sweep in float64 on the
    CPU (with no regularisation a feature of few ratings divides by a small
    sum of squares). Returns the numbers."""
    import torch

    from cornac_tpu_torch.models import fm as fm_mod
    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    rid, cid, val = train.uir_tuple
    n_feat = train.num_users + train.num_items
    cid_off = np.asarray(cid, np.int64) + train.num_users
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (len(rid), 2)).astype(np.float32)
    blocks = {dev: fm_mod.make_blocks(rid, cid_off, n_feat, dev)[0] for dev in (DEV, "cpu")}
    sums = {dev: fm_mod._seg_sum(torch.as_tensor(x, device=dev), b.perm, b.starts, b.ends)
            for dev, b in blocks.items()}
    exact = torch.zeros(n_feat, 2, dtype=torch.float64).index_add_(
        0, torch.as_tensor(rid, dtype=torch.long), torch.as_tensor(x, dtype=torch.float64))
    seg_err = (sums[DEV].cpu().double() - exact).abs().max().item()
    cpu_err = (sums[DEV].cpu() - sums["cpu"]).abs().max().item()
    if seg_err > 1e-3 or cpu_err > 1e-3:
        raise AssertionError(f"_seg_sum on the card: {seg_err:.3e} from a float64 sum, "
                             f"{cpu_err:.3e} from the CPU's")
    x_d, block = torch.as_tensor(x, device=DEV), blocks[DEV]
    acc = accumulate_rows(torch.zeros(n_feat, 2, device=DEV), block.ids, x_d)
    out = dict(seg_err=seg_err, cpu_err=cpu_err,
               acc_err=(acc.cpu().double() - exact).abs().max().item(),
               seg_ms=time_ms(lambda: fm_mod._seg_sum(x_d, block.perm, block.starts, block.ends),
                              200),
               acc_ms=time_ms(lambda: accumulate_rows(torch.zeros(n_feat, 2, device=DEV),
                                                      block.ids, x_d), 200))
    w = rng.normal(0, 0.1, n_feat).astype(np.float32)
    V = rng.normal(0, 0.1, (n_feat, 8)).astype(np.float32)
    sweeps = {}
    for dev, dt in ((DEV, torch.float32), ("cpu", torch.float64)):
        blocks = [b._replace(cnt=b.cnt.to(dt)) for b in fm_mod.make_blocks(rid, cid_off, n_feat,
                                                                           dev)]
        t = [torch.as_tensor(a, dtype=dt, device=dev) for a in (np.float32(0.0), w, V.copy(),
                                                                np.asarray(val, np.float32))]
        sweeps[dev] = fm_mod._fm_als(*t[:3], t[3], blocks, 0.0, 0.0, 0.0, True, True, True, 1)[2]
    out["sweep_v_err"] = (sweeps[DEV].cpu().double() - sweeps["cpu"]).abs().max().item()
    out["sweep_v_max"] = sweeps["cpu"].abs().max().item()
    log(f"  FM-ALS's _seg_sum, 80,000 x 2 into {n_feat} feature rows (the user block): "
        f"{out['seg_ms']:.4f} ms, max |err| {seg_err:.3e} against a float64 sum, "
        f"{cpu_err:.3e} from the CPU's (both within 1e-3); accumulate_rows (batch order) "
        f"{out['acc_ms']:.4f} ms, max |err| {out['acc_err']:.3e} (CUDA events); one float32 "
        f"ALS sweep (no regularisation) on the card lies {out['sweep_v_err']:.3e} from the "
        f"float64 sweep in V (largest |V| {out['sweep_v_max']:.3e})")
    return out


def bench_quadruples(bench_data, seed=123):
    """The bench data with seeded timestamps: (user, item, rating, time)."""
    data = bench_data()
    times = np.random.RandomState(seed).randint(0, 10**6, size=len(data))
    return [(u, i, r, int(t)) for (u, i, r), t in zip(data, times)]


def same_sets(a, b, what):
    """Two eval methods' train/test/val sets hold the same triples."""
    for split in ("train_set", "test_set", "val_set"):
        x, y = getattr(a, split), getattr(b, split)
        if (x is None) != (y is None) or (x is not None and not all(
                np.array_equal(p, q) for p, q in zip(x.uir_tuple, y.uir_tuple))):
            raise AssertionError(f"{what}: the {split}s differ")


def search_trials(search):
    return [(params, float(score)) for params, score in search.trial_results]


def phase_protocols_bench(bench_data):
    """Phase 12d, the protocols at the bench shape: CrossValidation(5 folds,
    seed 123) over MF(k=10, max_iter=25) and PMF(k=10, max_iter=100) on MAE
    and RMSE (``examples/cross_validation_example.py``); StratifiedSplit
    (by user, chronological) and TimestampSplit (ratio mode) on the bench
    data with seeded timestamps, and PropensityStratifiedEvaluation, each
    an Experiment with HPF and MostPop; GridSearch and RandomSearch (4
    trials) over HPF's k and hierarchical. The folds, splits and strata
    are held to the same protocol built again with the port on the CPU,
    and each search's best_params and per-trial validation scores (within
    1e-4) to the same search run on the CPU."""
    import io

    import cornac_tpu_torch
    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch import models as M
    from cornac_tpu_torch.eval_methods import (CrossValidation, PropensityStratifiedEvaluation,
                                               RatioSplit, StratifiedSplit, TimestampSplit)
    from cornac_tpu_torch.hyperopt import Discrete, GridSearch, RandomSearch
    from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    data = bench_data()
    quads = bench_quadruples(bench_data)
    hpf = dict(k=5, max_iter=100, seed=123)
    protocols = {
        "CrossValidation": lambda: CrossValidation(data, n_folds=5, seed=123),
        "StratifiedSplit": lambda: StratifiedSplit(quads, group_by="user", chrono=True,
                                                   test_size=0.2, rating_threshold=4.0,
                                                   seed=123),
        "TimestampSplit": lambda: TimestampSplit(quads, test_size=0.2, val_size=0.1,
                                                 rating_threshold=4.0, seed=123),
        "PropensityStratifiedEvaluation": lambda: PropensityStratifiedEvaluation(
            data, n_strata=2, rating_threshold=4.0, seed=123),
    }
    built = {name: clock(f"{name} (set-up)", make) for name, make in protocols.items()}
    search_split = clock("RatioSplit(0.2, 4.0, val 0.1, seed=123)", lambda: RatioSplit(
        data, test_size=0.2, val_size=0.1, rating_threshold=4.0, seed=123))
    space = [Discrete("k", [5, 10]), Discrete("hierarchical", [True, False])]

    def searches(device):
        return [GridSearch(M.HPF(device=device, **hpf), space, AUC(), search_split),
                RandomSearch(M.HPF(device=device, **hpf), space, AUC(), search_split,
                             n_trails=4)]

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    results = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name in protocols:
            if name == "CrossValidation":
                models = [M.MF(k=10, max_iter=25, seed=123), M.PMF(k=10, max_iter=100, seed=123)]
                metrics = [MAE(), RMSE()]
            else:
                models = [M.HPF(**hpf), M.MostPop()]
                metrics = [AUC(), NDCG(k=10), Recall(k=10), RMSE()]
            exp = Experiment(built[name], models, metrics)
            clock(f"{name}: Experiment ({', '.join(m.name for m in models)})", exp.run)
            results[name] = exp.result
        on_card = [clock(f"{type(s).__name__}: 4 HPF trials", lambda s=s: s.fit(
            search_split.train_set, search_split.val_set)) for s in searches(None)]
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the protocols at the bench shape")
    if launches <= 0:
        raise AssertionError("the protocols' fits launched no accumulate_rows")

    # ---- check what came out: the same protocols on the CPU ----
    cpu = Clock()
    cornac_tpu_torch.set_default_device("cpu")
    try:
        again = {name: cpu(f"{name} (set-up)", make) for name, make in protocols.items()}
        cv, cv_cpu = built["CrossValidation"], again["CrossValidation"]
        if not np.array_equal(cv._partition, cv_cpu._partition):
            raise AssertionError("CrossValidation: the fold labels differ from the CPU's")
        for fold in range(cv.n_folds):
            cv._build_fold(fold)
            cv_cpu._build_fold(fold)
            same_sets(cv, cv_cpu, f"CrossValidation fold {fold}")
        for name in ("StratifiedSplit", "TimestampSplit", "PropensityStratifiedEvaluation"):
            same_sets(built[name], again[name], name)
        pse, pse_cpu = built["PropensityStratifiedEvaluation"], again[
            "PropensityStratifiedEvaluation"]
        if list(pse.stratified_sets) != list(pse_cpu.stratified_sets) or not all(
                np.array_equal(p, q) for name, s in pse.stratified_sets.items()
                for p, q in zip(s.uir_tuple, pse_cpu.stratified_sets[name].uir_tuple)):
            raise AssertionError("PropensityStratifiedEvaluation: the strata differ from the CPU's")
        with contextlib.redirect_stdout(io.StringIO()):
            on_cpu = [cpu(f"{type(s).__name__} on the CPU: 4 HPF trials", lambda s=s: s.fit(
                search_split.train_set, search_split.val_set)) for s in searches("cpu")]
    finally:
        cornac_tpu_torch.set_default_device(None)
    cpu.report("the protocols on the CPU")
    for card_search, cpu_search in zip(on_card, on_cpu):
        what = type(card_search).__name__
        got, want = search_trials(card_search), search_trials(cpu_search)
        if [p for p, _ in got] != [p for p, _ in want]:
            raise AssertionError(f"{what}: the trial points differ from the CPU's")
        worst = max(abs(g - w) for (_, g), (_, w) in zip(got, want))
        if worst > 1e-4 or card_search.best_params != cpu_search.best_params:
            raise AssertionError(f"{what}: trials {got} on the card, {want} on the CPU")
        log(f"  {what} over HPF k and hierarchical (AUC on the validation set): best "
            f"{card_search.best_params} as on the CPU, trials within {worst:.2e} of the CPU's: "
            + ", ".join(f"{p} {s:.6f}" for p, s in got))
    for name, res in results.items():
        for model_res in res:
            rows = model_res if isinstance(model_res, list) else [model_res]
            for row in rows:
                vals = {k: v for k, v in row.metric_avg_results.items() if "(s)" not in k}
                if not all(np.isfinite(v) for v in vals.values()):
                    raise AssertionError(f"{name}, {row.model_name}: non-finite metrics {vals}")
        log(f"  {name}:\n" + "\n".join("    " + line for line in str(res).splitlines()))
    log(f"  folds, splits and strata equal to the CPU's: CrossValidation {cv.n_folds} folds, "
        f"StratifiedSplit, TimestampSplit, PropensityStratifiedEvaluation "
        f"({len(pse.stratified_sets)} strata); accumulate_rows launches {launches}")
    log(f"the protocols at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} s, "
        f"on the CPU {sum(cpu.seconds.values()):.1f} s")
    return dict(launches=launches, fused=fused, seconds=dict(clock.seconds))


# benchmarks/scale_netflix.py:130-157, WMF at the Netflix widths: the
# interactions cut from ~100M to 20M seeded uniform pairs (item degrees
# about 1,130 instead of 5,650) so that the host build fits the run
WMF_PAIRS, WMF_K, WMF_CHUNK = 20_000_000, 64, 256


def netflix_dataset():
    """20M uniform (user, item) draws from RandomState(0) over 480,000 x
    17,700, duplicates dropped, ratings 1, as ``scale_netflix.build_dataset``
    makes its data."""
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    rng = np.random.RandomState(0)
    u = rng.randint(N_USERS, size=WMF_PAIRS).astype(np.int64)
    i = rng.randint(N_ITEMS, size=WMF_PAIRS).astype(np.int64)
    _, first = np.unique(u * N_ITEMS + i, return_index=True)
    u, i = u[first], i[first]
    return Dataset(
        num_users=N_USERS, num_items=N_ITEMS,
        uid_map=OrderedDict((x, x) for x in range(N_USERS)),
        iid_map=OrderedDict((x, x) for x in range(N_ITEMS)),
        uir_tuple=(u, i, np.ones(len(u))), seed=0,
    )


def phase_wmf_full(seed, ds):
    """WMF(k=64, batch_size=256) at 480,000 x 17,700: a 3-sweep fit (set-up
    included), then one warm and two timed sweeps of the fit's own sweep
    function on its buckets, beside the FLOP bound; peak device memory;
    then recommend_batch of 8,192 users at k=100 through fused_topk, the
    recall_target and bf16 routes, each held to the plain version."""
    import torch

    from cornac_tpu_torch.models import WMF, TPUExactANN
    from cornac_tpu_torch.models import wmf as wmf_mod
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

    clock = Clock()
    nnz = ds.num_ratings
    dev = torch.device(DEV)

    # ---- the main path, counted ----
    FUSED_TOPK.launches = 0
    torch.cuda.reset_peak_memory_stats()
    model = clock("WMF.fit, 3 sweeps (set-up included)", lambda: WMF(
        k=WMF_K, batch_size=WMF_CHUNK, max_iter=3, seed=123, verbose=False).fit(ds))
    peak_fit = torch.cuda.max_memory_allocated()
    users = np.random.RandomState(seed + 5).choice(N_USERS, SERVE_BATCH, replace=False)
    recs = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                 lambda: model.recommend_batch(list(users), k=TOPK))
    Ud = torch.as_tensor(model.U[users], device=dev)
    Vd = torch.as_tensor(model.V, device=dev)
    ann = TPUExactANN(model, recall_target=0.95)
    ann.build_index()
    ann_ids, _ = clock("TPUExactANN(recall_target=0.95).knn_query", lambda: ann.knn_query(
        model.U[users], TOPK))
    bf16 = clock("fused_topk(precision='bf16')", lambda: fused_topk(Ud, Vd, TOPK,
                                                                   precision="bf16"))
    fused = FUSED_TOPK.launches
    if fused < 3:
        raise AssertionError(f"the WMF path launched fused_topk {fused} times, want 3")

    # ---- check and measure ----
    if not (np.isfinite(model.U).all() and np.isfinite(model.V).all()):
        raise AssertionError("the full-width WMF fit has non-finite factors")
    S = plain_scores(Ud, Vd)
    want = reference_lists(Ud, Vd, TOPK, [set()] * len(users))
    relaxed = check_lists([[model.iid_map[i] for i in row] for row in recs], want,
                          S.cpu().numpy(), "WMF recommend_batch")
    relaxed += check_lists(ann_ids, want, S.cpu().numpy(), "WMF TPUExactANN(recall_target=0.95)")
    rU, rV = (t.to(torch.bfloat16).float() for t in (Ud, Vd))
    ps, pi = fused_topk_torch(rU, rV, TOPK + 1)
    _, bf_rel = compare_topk(*bf16, ps, pi, plain_scores(rU, rV), "WMF bf16 route")
    del S, ps, pi
    csr = ds.csr_matrix
    groups = clock("the fit's buckets again (host)", lambda: [
        wmf_mod._bucketed_csr(m, WMF_K, dev) for m in (csr, csr.T.tocsr())])
    consts = tuple(float(np.float32(x)) for x in (model.a, model.b, model.lambda_u,
                                                  model.lambda_v))
    U, V = torch.as_tensor(model.U, device=dev), torch.as_tensor(model.V, device=dev)
    torch.cuda.reset_peak_memory_stats()
    U, V = clock("one warm sweep", lambda: wmf_mod._als_sweeps_bucketed(U, V, *groups,
                                                                          *consts, 1))
    sweep_s = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        U, V = wmf_mod._als_sweeps_bucketed(U, V, *groups, *consts, 1)
        end.record()
        torch.cuda.synchronize()
        sweep_s.append(start.elapsed_time(end) / 1e3)
    peak_sweep = torch.cuda.max_memory_allocated()
    wall_ms, busy_ms, events, ops = profile_call(
        lambda: wmf_mod._als_sweeps_bucketed(U, V, *groups, *consts, 1))
    flops = 2 * 2 * nnz * WMF_K**2 + (N_USERS + N_ITEMS) * WMF_K**3 / 3
    bound_s = flops / PEAK_F32_FLOPS
    clock.report("WMF at the Netflix widths")
    deg_items = np.diff(csr.tocsc().indptr)
    log(f"  WMF k={WMF_K} over {nnz:,} pairs ({N_USERS:,} users x {N_ITEMS:,} items, cut from "
        f"~100M; item degrees {deg_items.min()}-{deg_items.max()}): seconds per sweep "
        f"{sweep_s[0]:.4f}, {sweep_s[1]:.4f} (CUDA events); FLOP bound {flops:.4e} FLOP = "
        f"2*2*nnz*k^2 + (users + items)*k^3/3 over {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{bound_s:.5f} s, {100 * bound_s / min(sweep_s):.2f}% of it; "
        f"{len(groups[0])} user and {len(groups[1])} item buckets")
    log(f"  profile, one sweep: {wall_ms:.1f} ms host clock, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}%), {events} device events; top device ops: "
        f"{top_ops(ops, 6)}")
    log(f"  peak device memory: the 3-sweep fit {peak_fit / 2**30:.3f} GiB, the timed sweeps "
        f"{peak_sweep / 2**30:.3f} GiB")
    log(f"  recommend_batch ({SERVE_BATCH} users, k={TOPK}) and TPUExactANN(recall_target=0.95):"
        f" the exact lists of the plain version (positions relaxed as near-ties: {relaxed}); "
        f"bf16 route equal to the plain version on rounded operands (relaxed {bf_rel}); "
        f"fused_topk launches {fused}")
    log(f"WMF at the Netflix widths: ok in {sum(clock.seconds.values()):.1f} s")
    del groups, U, V, Ud, Vd, ann
    torch.cuda.empty_cache()
    return fused, dict(sweep_s=sweep_s, bound_s=bound_s, peak_fit=peak_fit,
                       peak_sweep=peak_sweep, nnz=nnz)


def scale_10m_dataset():
    """``benchmarks/scale_10m.py``'s data: 10M uniform (user, item) draws
    from RandomState(0) over 100,000 x 10,000, duplicates dropped."""
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    rng = np.random.RandomState(0)
    u = rng.randint(FULL_USERS, size=FULL_DRAWS)
    i = rng.randint(FULL_ITEMS, size=FULL_DRAWS)
    _, first = np.unique(u.astype(np.int64) * FULL_ITEMS + i, return_index=True)
    u, i = u[first], i[first]
    return Dataset(
        num_users=FULL_USERS, num_items=FULL_ITEMS,
        uid_map=OrderedDict((x, x) for x in range(FULL_USERS)),
        iid_map=OrderedDict((x, x) for x in range(FULL_ITEMS)),
        uir_tuple=(u.astype(np.int64), i.astype(np.int64), np.ones(len(u))),
        seed=0,
    )


def sample_bytes(csr, k):
    """The least bytes one BPR sample moves: the (user, item) pair (8), the
    membership probe (the user's row bounds, 8, and one 4-byte index per
    step of a binary search over the row, averaged over samples, which
    pick users in proportion to their degree), and the three factor rows
    (k + 1 floats with the bias) read and written once each."""
    deg = np.diff(csr.indptr).astype(np.float64)
    steps = np.ceil(np.log2(deg + 1))
    probe = 8.0 + 4.0 * float((deg * steps).sum() / deg.sum())
    return 8.0 + probe + 3 * 2 * (k + 1) * 4.0, probe


def phase_trainer_full(seed, mesh):
    """BPR at benchmarks/scale_10m.py's configuration: one warm epoch, ten
    timed, samples/s beside the byte bound, the busy share of an epoch;
    then recommend_batch for 8,192 users through fused_topk, held to the
    plain version."""
    import torch

    from cornac_tpu_torch.models import BPR
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    ds = clock("scale_10m data (set-up)", scale_10m_dataset)
    n = ds.num_ratings
    kw = dict(k=FULL_K, batch_size=FULL_BATCH, seed=123)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    clock("BPR.fit, 1 epoch (warm)", lambda: BPR(max_iter=1, **kw).fit(ds))
    one = clock("BPR.fit, 1 epoch", lambda: BPR(max_iter=1, **kw).fit(ds))
    sharded = clock("BPR(mesh=...).fit, 1 epoch, world size 1",
                    lambda: BPR(max_iter=1, mesh=mesh, **kw).fit(ds))
    clock("BPR(mesh=...).fit, 0 epochs, world size 1 (set-up)",
          lambda: BPR(max_iter=0, mesh=mesh, **kw).fit(ds))
    model = clock("BPR.fit, 11 epochs", lambda: BPR(max_iter=11, **kw).fit(ds))
    rng = np.random.RandomState(seed + 3)
    users = rng.choice(FULL_USERS, SERVE_BATCH, replace=False)
    recs = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                 lambda: model.recommend_batch(list(users), k=TOPK))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("trainer at full width")
    if launches <= 0 or fused <= 0:
        raise AssertionError("the full-width path did not launch accumulate_rows and fused_topk")

    # ---- check and measure ----
    for name in ("u_factors", "i_factors", "i_biases"):
        if not np.array_equal(getattr(sharded, name), getattr(one, name)):
            raise AssertionError(f"BPR(mesh=...) differs from the plain fit in {name}")
    mesh_fit_s = clock.seconds["BPR(mesh=...).fit, 1 epoch, world size 1"]
    mesh_epoch_s = mesh_fit_s - clock.seconds["BPR(mesh=...).fit, 0 epochs, world size 1 (set-up)"]
    log(f"  BPR(mesh=...) at world size 1 (NCCL), one epoch: the plain fit's factors bit for "
        f"bit; {mesh_fit_s:.3f} s against the plain 1-epoch fit's "
        f"{clock.seconds['BPR.fit, 1 epoch']:.3f} s (host clock, set-up included); the epoch "
        f"alone (a 1-epoch minus a 0-epoch mesh fit) {mesh_epoch_s:.3f} s")
    del one, sharded
    epoch_s = (clock.seconds["BPR.fit, 11 epochs"] - clock.seconds["BPR.fit, 1 epoch"]) / 10
    n_batches = -(-n // FULL_BATCH)
    per_sample, probe = sample_bytes(ds.csr_matrix, FULL_K)
    bound_s = n_batches * FULL_BATCH * per_sample / PEAK_BYTES
    if not all(np.isfinite(getattr(model, a)).all() for a in ("u_factors", "i_factors", "i_biases")):
        raise AssertionError("the full-width fit has non-finite factors")
    prof = epoch_profile(lambda e: BPR(max_iter=e, **kw).fit(ds), n_batches, 1)
    stats = dict(samples_per_s=n / epoch_s, epoch_s=epoch_s, bound_s=bound_s,
                 bytes_per_sample=per_sample, setup_s=clock.seconds["BPR.fit, 1 epoch"] - epoch_s,
                 plain_fit_s=clock.seconds["BPR.fit, 1 epoch"], mesh_fit_s=mesh_fit_s,
                 mesh_epoch_s=mesh_epoch_s, **prof)
    log(f"  BPR k={FULL_K} batch {FULL_BATCH} over {n:,} pairs ({FULL_USERS:,} users x "
        f"{FULL_ITEMS:,} items, membership by binary search): {epoch_s:.3f} s per epoch (10 "
        f"epochs: an 11-epoch fit minus a 1-epoch fit), {n / epoch_s / 1e6:.3f} M samples/s; "
        f"fit set-up {stats['setup_s']:.3f} s")
    log(f"  byte bound: {per_sample:.1f} B per sample (8 pair + {probe:.1f} probe + 3 x 2 x "
        f"{FULL_K + 1} x 4 rows) over {PEAK_BYTES / 1e12:.2f} TB/s = {bound_s * 1e3:.3f} ms per "
        f"epoch ({PEAK_BYTES / per_sample / 1e6:,.0f} M samples/s): "
        f"{100 * bound_s / epoch_s:.3f}% of it")
    log(f"  profile, one epoch (a 1-epoch fit minus a 0-epoch fit): {prof['wall_ms']:.1f} ms host "
        f"clock, device busy {prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
        f"{prof['launches_per_minibatch']:.1f} device events per minibatch; top device ops: "
        f"{prof['top']}")
    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    got = [[model.iid_map[i] for i in row] for row in recs]
    relaxed = check_lists(got, want, plain_scores(Ud[users], Vd).cpu().numpy(), "trained recommend_batch")
    log(f"  recommend_batch of the trained model ({SERVE_BATCH} users, k={TOPK}): equal to the plain "
        f"version (positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}")
    log(f"trainer at full width: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, stats


# ---------------------------------------------------------------------- #
# the factor and neural families' mesh= (ROADMAP A8 (b)) at world size 1
# ---------------------------------------------------------------------- #
MESH_VIEWS = 50_000  # VEBPR's seeded views at the bench shape (the data has none)
MESH_SERVED = 256  # users each mesh-fitted model with vectors serves through fused_topk
# the pairs fitted on the first half of the train ratings (the whole user
# and item tables), cut in PR 18 for the run's time: the longest of 12l's
MESH_HALVED = ("IBPR", "OnlineIBPR", "GMF", "MLP", "NeuMF")


def mesh_family_configs():
    """(name, maker, depth attribute, fitted attributes or None for
    ``fitted_arrays``) of every configuration whose class takes ``mesh=``
    since A8 (b), at the widths of ``factor_configs``, ``factor_rest_configs``
    and ``neural_configs`` (OnlineIBPR at IBPR's), of
    ``bpr_quality_band.GOLDEN_CONFIGS`` (SBPR, VEBPR, the three C2PF) and
    ``AUX_CONFIGS`` (CVAECF, GCMC); a fit's depth is set to one epoch or
    sweep through the attribute after construction."""
    from bpr_quality_band import AUX_CONFIGS, GOLDEN_CONFIGS

    from cornac_tpu_torch import models as M

    out = [(n, maker, "max_iter", attrs) for n, maker, attrs in factor_configs()
           if n in ("PMF", "NMF", "WMF", "IBPR", "COE")]
    out.insert(4, ("OnlineIBPR", lambda **kw: M.OnlineIBPR(k=10, max_iter=20, seed=123, **kw),
                   "max_iter", ("U", "V")))
    out += [(n, maker, "max_iter", attrs) for n, maker, attrs in factor_rest_configs()
            if n in ("HPF", "PF", "FM-als", "FM-sgd")]
    for name in ("SBPR", "VEBPR", "C2PF", "TC2PF", "RC2PF"):
        cls, kw, seeded, _ = GOLDEN_CONFIGS[name]
        attrs = (("Gs", "Gr", "Ls", "Lr", "L2s", "L2r", "L3s", "L3r", "Xi") if cls == "C2PF"
                 else ("u_factors", "i_factors") + (("i_biases",) if name == "SBPR" else ()))
        out.append((name, functools.partial(getattr(M, cls), seed=123, **kw), "max_iter",
                    attrs))
    out += [(n, maker, depth, None) for n, depth, maker in neural_configs()]
    for name, depth in (("CVAECF", "n_epochs"), ("GCMC", "max_iter")):
        cls, kw, _ = AUX_CONFIGS[name]
        out.append((name, functools.partial(getattr(M, cls), seed=123, **kw), depth, None))
    return out


def mesh_family_data(data):
    """(train set, VEBPR's purchase/view train set) at the bench shape:
    ``RatioSplit(0.2, 4.0, seed=123)`` of ``make_ml100k_like(7)``'s triples
    with ``seq_bench_data.side_modalities``' user graph (SBPR, CVAECF) and
    item graph (C2PF), and ``PurchaseViewDataset.build`` of the triples with
    ``MESH_VIEWS`` seeded (user, item) views over the same ids."""
    from seq_bench_data import side_modalities

    from cornac_tpu_torch import data as pdata
    from cornac_tpu_torch.eval_methods import RatioSplit

    side = side_modalities(data, pdata)
    split = RatioSplit(data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False,
                       user_graph=side["user_graph"], item_graph=side["item_graph"])
    rng = np.random.RandomState(77)
    users = sorted({u for u, _, _ in data})
    items = sorted({i for _, i, _ in data})
    views = [(users[u], items[i], 1.0) for u, i in zip(rng.randint(len(users), size=MESH_VIEWS),
                                                       rng.randint(len(items), size=MESH_VIEWS))]
    return split.train_set, pdata.PurchaseViewDataset.build(data, views, seed=123)


def phase_mesh_families(bench_data, mesh):
    """Every A8 (b) configuration at the bench shape and its full width, one
    epoch or sweep (``MESH_HALVED``'s over the first half of the train
    ratings), fitted with ``mesh=`` (the world-size-1 NCCL mesh) and
    without, counted; the two fits' arrays held bit for bit, each pair's
    seconds printed; every mesh-fitted model with vectors serving
    ``MESH_SERVED`` users through fused_topk, held to the plain version.
    Returns (accumulate_rows launches, fused_topk launches, {name: (mesh s,
    plain s)})."""
    import torch

    from cornac_tpu_torch.models.recommender import ANNMixin
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    data = clock("make_ml100k_like(seed=7) (set-up)", bench_data)
    train, views = clock("the split with the side modalities, and the views (set-up)",
                         lambda: mesh_family_data(data))
    half = clock("the first half of the train ratings (set-up)",
                 lambda: rating_prefix(train, train.num_ratings // 2))
    configs = mesh_family_configs()
    fits = {}

    def warm_up():  # the process's first DTensor and first all-gather, apart from PMF's fit
        from cornac_tpu_torch.parallel import shard_tables
        from cornac_tpu_torch.parallel.sharded import gather_batch, local_shard

        table = local_shard(shard_tables(mesh, torch.zeros((8, 2), device=DEV)))
        return gather_batch(mesh, table, 8, 8)

    clock("the first DTensor and all-gather on the mesh (set-up)", warm_up)

    def fit(name, maker, depth, mesh_):
        model = maker(mesh=mesh_)
        setattr(model, depth, 1)
        return model.fit(views if name == "VEBPR" else half if name in MESH_HALVED else train)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    for name, maker, depth, attrs in configs:
        sharded = clock(f"{name} mesh", lambda: fit(name, maker, depth, mesh))
        plain = clock(f"{name} plain", lambda: fit(name, maker, depth, None))
        fits[name] = (sharded, plain, attrs)
    relaxed = 0
    served = []
    users = np.arange(MESH_SERVED)
    for name, (sharded, _, _) in fits.items():
        # the models with vectors (VAECF's recommend_batch refuses k > 0)
        if isinstance(sharded, ANNMixin) and name != "VAECF":
            own = views if name == "VEBPR" else train
            relaxed += clock(f"{name} serving", lambda: serve_factor_model(sharded, own, users))
            served.append(name)
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the A8 (b) configurations at the bench shape, mesh and plain")
    if launches <= 0 or fused < len(served):
        raise AssertionError(f"the mesh fits launched accumulate_rows {launches} times and "
                             f"fused_topk {fused} times for {len(served)} served models")

    # ---- check what came out ----
    seconds = {}
    for name, (sharded, plain, attrs) in fits.items():
        got = ({a: np.asarray(getattr(sharded, a)) for a in attrs} if attrs
               else fitted_arrays(sharded))
        want = ({a: np.asarray(getattr(plain, a)) for a in attrs} if attrs
                else fitted_arrays(plain))
        if set(got) != set(want) or not got:
            raise AssertionError(f"{name}: the mesh fit holds {sorted(got)}, the plain "
                                 f"{sorted(want)}")
        for a in want:
            if not np.isfinite(want[a]).all():
                raise AssertionError(f"{name}: the plain fit's {a} is not finite")
            if not np.array_equal(got[a], want[a]):
                err = np.abs(np.asarray(got[a], np.float64) - want[a]).max()
                raise AssertionError(f"{name}(mesh=...) differs from the plain fit in {a} "
                                     f"(max |diff| {err:.3e})")
        seconds[name] = (clock.seconds[f"{name} mesh"], clock.seconds[f"{name} plain"])
    log("  the A8 (b) configurations, one epoch or sweep each at the bench shape, world size 1 "
        "(NCCL): every mesh fit equal to the plain fit bit for bit; seconds, mesh / plain "
        "(host clock): " + ", ".join(
            f"{n} {m:.3f} / {p:.3f}" for n, (m, p) in seconds.items()))
    log(f"  {len(served)} mesh-fitted models ({', '.join(served)}) serving {MESH_SERVED} users "
        f"at k=10: the plain version's lists (positions relaxed as near-ties: {relaxed}); "
        f"accumulate_rows launches {launches}, fused_topk launches {fused}")
    log(f"the A8 (b) mesh fits at the bench shape: ok in {sum(clock.seconds.values()):.1f} s")
    del fits
    torch.cuda.empty_cache()
    return launches, fused, seconds


# the A8 (c) configurations and the side-information half of A8 (d) at
# their bench shapes (phases 12f, 12g, 12h and 12i): name -> (cell, the
# depth's attribute); each fitted one epoch or iteration, with mesh= and
# without. FPMC's plain fit takes the general path (fused_path False), as
# its mesh fit does; SASRec and DNNTSP are fitted by their protocols'
# evaluate, with mesh= and without
MESH_SEQ_SIDE = {
    "FPMC": ("sessions", "n_epochs"), "GRU4Rec": ("sessions", "n_epochs"),
    "SASRec": ("sessions", "n_epochs"), "BERT4Rec": ("sessions", "n_epochs"),
    "TransformerRec-clm": ("sessions", "n_epochs"), "TIGER-rkmeans": ("sessions", "n_epochs"),
    "Beacon": ("baskets", "n_epochs"), "DNNTSP": ("baskets", "n_epochs"),
    "SoRec": ("side", "max_iter"), "MCF": ("side", "max_iter"), "VBPR": ("side", "n_epochs"),
    "AMR": ("side", "n_epochs"), "CausalRec": ("side", "n_epochs"), "VMF": ("side", "n_epochs"),
    "DMRL": ("side", "epochs"), "PCRL": ("side", "max_iter"),
}
MESH_EVALUATED = ("SASRec", "DNNTSP")
MESH_PAIR_STEPS = 4  # minibatches of a mesh/plain pair at a phase's full widths
MESH_HISTORIES = 64  # histories each next-item and basket model scores on the mesh and off it
# the fitted tables a model keeps outside a module's parameters
MESH_TABLES = ("U", "V", "Z", "P", "E", "Q", "beta_item", "gamma_user", "gamma_item",
               "theta_user", "theta_item", "ind_theta_item", "visual_bias", "emb_matrix",
               "beta_prime", "Gs", "Gr", "Ls", "Lr", "Theta", "Beta", "theta", "beta", "U1",
               "U2", "H1", "H2", "G1", "G2", "G3", "I", "A", "O", "UA", "IA")


def model_arrays(model):
    """A fitted model's state as {name: numpy array}: ``fitted_arrays``,
    the arrays of its dicts of parameters (``params``, the text models'
    ``vae``, ``cnn`` and ``sdae``), and the tables of ``MESH_TABLES`` it
    keeps."""
    out = fitted_arrays(model)
    for tree in ("params", "vae", "cnn", "sdae"):
        if isinstance(getattr(model, tree, None), dict):
            out.update({f"{tree}.{n}": t.detach().cpu().numpy() if hasattr(t, "detach") else
                        np.asarray(t) for n, t in getattr(model, tree).items()})
    for attr in MESH_TABLES:
        if isinstance(getattr(model, attr, None), np.ndarray):
            out[attr] = getattr(model, attr)
    return out


def held_bits(what, got, want):
    """Raise unless the fitted states ``got`` and ``want`` (``model_arrays``)
    hold the same arrays, bit for bit, each finite."""
    if set(got) != set(want) or not got:
        raise AssertionError(f"{what}: the mesh fit holds {sorted(got)}, the plain "
                             f"{sorted(want)}")
    for a in want:
        if not np.isfinite(want[a]).all():
            raise AssertionError(f"{what}: the plain fit's {a} is not finite")
        if not np.array_equal(got[a], want[a]):
            err = float(np.abs(np.asarray(got[a], np.float64) - want[a]).max())
            raise AssertionError(f"{what}: the mesh fit differs from the plain fit in {a} (max "
                                 f"|diff| {err:.3e}), held bit for bit")


def rating_prefix(train, n):
    """The first ``n`` ratings of ``train`` as a Dataset over its whole user
    and item maps (the full catalog: the tables keep their widths), its
    modalities attached."""
    from cornac_tpu_torch.data import Dataset

    u, i, r = (np.asarray(a)[:n] for a in train.uir_tuple)
    rows = [(train.user_ids[a], train.item_ids[b], float(c)) for a, b, c in zip(u, i, r)]
    sub = Dataset.build(rows, global_uid_map=copy.copy(train.uid_map),
                        global_iid_map=copy.copy(train.iid_map), seed=123)
    sub.add_modalities(**{attr: getattr(train, attr) for attr in train._MODALITY_ATTRS})
    return sub


def full_width_pair(what, make, data, mesh, on="on a prefix of the rows"):
    """One mesh/plain pair at a phase's full widths: ``make(mesh=...)``
    fitted on ``data`` (a prefix of the phase's rows, a few minibatches, over
    its whole catalog) with the main process's world-size-1 mesh and
    without, counted, the two fitted states held bit for bit
    (``model_arrays``); ``on`` says what the pair fits for the log. Returns
    (accumulate_rows launches, mesh s, plain s)."""
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    clock = Clock()
    ACCUMULATE_ROWS.launches = 0
    sharded = clock("mesh", lambda: make(mesh=mesh).fit(data))
    plain = clock("plain", lambda: make().fit(data))
    launches = ACCUMULATE_ROWS.launches
    held_bits(f"{what}(mesh=...) at the full widths", model_arrays(sharded), model_arrays(plain))
    m, p = clock.seconds["mesh"], clock.seconds["plain"]
    log(f"  {what}(mesh=...) at the full widths {on}, world size 1 (NCCL): "
        f"the plain fit's state bit for bit; seconds (host clock, set-up included) mesh "
        f"{m:.3f}, plain {p:.3f}; accumulate_rows launches {launches}")
    return launches, m, p


def mesh_seq_side_model(name, mesh=None, **extra):
    """The bench configuration ``name`` (``bpr_quality_band``'s tables) at
    seed 123, with ``mesh``."""
    from bpr_quality_band import BASKET_CONFIGS, GENERATIVE_CONFIGS, SEQ_CONFIGS, SIDE_CONFIGS

    from cornac_tpu_torch import models as M

    table = next(t for t in (SEQ_CONFIGS, GENERATIVE_CONFIGS, BASKET_CONFIGS, SIDE_CONFIGS)
                 if name in t)
    cls, kw = table[name][:2]
    model = getattr(M, cls)(**kw, seed=123, mesh=mesh, **extra)
    if name == "FPMC":
        model.fused_path = False  # the plain fit on the general path, as a mesh fit takes
    return model


def seq_side_cells(bench_data, mesh):
    """The three cells of ``MESH_SEQ_SIDE``: ({cell: (protocol or split
    with ``mesh``, the same without)}, {cell: metrics}). ``seq_eval``'s
    sessions (with ``session_features``) under ``NextItemEvaluation``,
    ``basket_eval``'s baskets under ``NextBasketEvaluation``, each built
    twice from one draw of the data, and ``side_split``'s ratings with the
    side modalities (no protocol runs there)."""
    from bpr_quality_band import side_split
    from seq_bench_data import gen_baskets, gen_sessions, session_features, session_split

    from cornac_tpu_torch import data as pdata, eval_methods as pe, metrics as pm

    train, test = session_split(gen_sessions())
    feats, ids = session_features()
    baskets = gen_baskets()

    def protocols(mesh_):
        return (pe.NextItemEvaluation.from_splits(
            train_data=train, test_data=test, fmt="USIT", exclude_unknowns=True, seed=123,
            mode="next", item_feature=pdata.FeatureModality(features=feats, ids=ids),
            mesh=mesh_),
            pe.NextBasketEvaluation(data=baskets, test_size=0.2, fmt="UBI", seed=123,
                                    mesh=mesh_))

    (sessions, basket_ev), (plain_sessions, plain_baskets) = protocols(mesh), protocols(None)
    side = side_split(pdata, pe, bench_data())
    metrics = {"sessions": [pm.MRR(), pm.HitRatio(k=20), pm.NDCG(k=20)],
               "baskets": [pm.Recall(k=10), pm.Recall(k=50), pm.HitRatio(k=10)]}
    return {"sessions": (sessions, plain_sessions), "baskets": (basket_ev, plain_baskets),
            "side": (side, side)}, metrics


def phase_mesh_seq_side(bench_data, mesh):
    """The A8 (c) configurations and the side-information half of A8 (d)
    at their bench shapes, one epoch or iteration each, fitted with
    ``mesh=`` (the world-size-1 NCCL mesh) and without, counted: every
    pair's fitted state held bit for bit and its seconds printed; SASRec and
    DNNTSP fitted and scored by ``NextItemEvaluation(mesh=)`` and
    ``NextBasketEvaluation(mesh=)`` against the plain protocols, the metrics
    equal; the next-item and basket models' ``score_history_batch`` /
    ``score_baskets_batch`` on the mesh (the histories split over its
    ranks) equal to the plain models'; the mesh-fitted models with vectors
    serving ``MESH_SERVED`` users through fused_topk, held to the plain
    version. Returns (accumulate_rows launches, fused_topk launches, {name:
    (mesh s, plain s)})."""
    import torch

    from cornac_tpu_torch.models.recommender import ANNMixin
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    cells, metrics = clock("the three cells, each protocol with mesh= and without (set-up)",
                           lambda: seq_side_cells(bench_data, mesh))
    rng = np.random.RandomState(12)
    n_items = {kind: cells[kind][0].train_set.num_items for kind in ("sessions", "baskets")}
    histories = {"sessions": [list(rng.randint(0, n_items["sessions"], size=rng.randint(1, 8)))
                              for _ in range(MESH_HISTORIES)],
                 "baskets": [[list(rng.choice(n_items["baskets"], size=rng.randint(1, 4),
                                              replace=False)) for _ in range(rng.randint(1, 5))]
                             for _ in range(MESH_HISTORIES)]}

    def fit(name, mesh_):
        kind, depth = MESH_SEQ_SIDE[name]
        model = mesh_seq_side_model(name, mesh_)
        setattr(model, depth, 1)
        cell = cells[kind][0 if mesh_ is not None else 1]
        if name in MESH_EVALUATED:  # the protocol fits it, then scores the test split
            return model, cell.evaluate(model, metrics[kind], user_based=False)[0]
        return model.fit(cell.train_set), None

    def scores(model, kind):
        hs = histories[kind]
        if kind == "sessions":
            return model.score_history_batch(np.zeros(len(hs), int), hs)
        return model.score_baskets_batch(np.zeros(len(hs), int), hs)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    fits, served, relaxed = {}, [], 0
    for name, (kind, _) in MESH_SEQ_SIDE.items():
        sharded, result = clock(f"{name} mesh", lambda: fit(name, mesh))
        plain, plain_result = clock(f"{name} plain", lambda: fit(name, None))
        got = want = None
        if kind != "side":
            got = clock(f"{name} scoring, mesh", lambda: scores(sharded, kind))
            want = scores(plain, kind)
        fits[name] = (sharded, plain, result, plain_result, got, want)
    for name, (sharded, *_) in fits.items():
        if isinstance(sharded, ANNMixin):
            train = cells["side"][0].train_set
            relaxed += clock(f"{name} serving", lambda: serve_factor_model(
                sharded, train, np.arange(MESH_SERVED)))
            served.append(name)
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the A8 (c) and side-information configurations at the bench shape, mesh and "
                 "plain")
    if launches <= 0 or fused < len(served):
        raise AssertionError(f"the mesh fits launched accumulate_rows {launches} times and "
                             f"fused_topk {fused} times for {len(served)} served models")

    # ---- check what came out ----
    seconds = {}
    for name, (sharded, plain, result, plain_result, got, want) in fits.items():
        held_bits(f"{name}(mesh=...)", model_arrays(sharded), model_arrays(plain))
        if got is not None and not (np.isfinite(want).all() and np.array_equal(got, want)):
            raise AssertionError(f"{name}: the scores on the mesh differ from the plain "
                                 f"model's")
        if result is not None:
            keep = [m.name for m in metrics[MESH_SEQ_SIDE[name][0]]]
            mesh_vals = {m: result.metric_avg_results[m] for m in keep}
            plain_vals = {m: plain_result.metric_avg_results[m] for m in keep}
            if mesh_vals != plain_vals or not all(np.isfinite(v) for v in mesh_vals.values()):
                raise AssertionError(f"{name}: the protocol with mesh= gave {mesh_vals}, the "
                                     f"plain one {plain_vals}")
            log(f"  {name}: the protocol with mesh= (the model fitted and scored on the mesh) "
                f"gives the plain protocol's metrics, " + ", ".join(
                    f"{m} {v:.6f}" for m, v in mesh_vals.items()))
        seconds[name] = (clock.seconds[f"{name} mesh"], clock.seconds[f"{name} plain"])
    log("  the A8 (c) and side-information configurations, one epoch or iteration each at the "
        "bench shape, world size 1 (NCCL): every mesh fit equal to the plain fit bit for bit, "
        f"the next-item and basket models' scores of {MESH_HISTORIES} histories on the mesh equal "
        "to the plain models'; seconds, mesh / plain (host clock): " + ", ".join(
            f"{n} {m:.3f} / {p:.3f}" for n, (m, p) in seconds.items()))
    log(f"  {len(served)} mesh-fitted models ({', '.join(served)}) serving {MESH_SERVED} users "
        f"at k=10: the plain version's lists (positions relaxed as near-ties: {relaxed}); "
        f"accumulate_rows launches {launches}, fused_topk launches {fused}")
    log(f"the A8 (c) and side-information mesh fits at the bench shape: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    del fits
    torch.cuda.empty_cache()
    return launches, fused, seconds


# the text, review and sentiment models (the rest of A8 (d)) at their bench
# shapes (12j, 12k): name -> (cell, the depth's attribute, the depth). One
# epoch or sweep, or a few of the sampled iterations, each
MESH_TEXT_SENTIMENT = {
    "CDL": ("text", "max_iter", 1), "CDR": ("text", "max_iter", 1),
    "CVAE": ("text", "n_epochs", 1), "ConvMF": ("text", "n_epochs", 1),
    "CTR": ("text", "max_iter", 1), "NARRE": ("text", "max_iter", 1),
    "HRDR": ("text", "max_iter", 1), "EFM": ("sentiment", "max_iter", 5),
    "ComparERObj": ("comparer", "max_iter", 5), "MTER": ("sentiment", "max_iter", 20),
    "ComparERSub": ("comparer", "max_iter", 20), "LRPPM": ("sentiment", "max_iter", 20),
    "Companion": ("sentiment", "max_iter", 20), "HypAR": ("sentiment", "num_epochs", 1),
}
# cut for the run's time: the pairs of the models whose minibatches are the
# ratings fit on the first 1 / MESH_TEXT_SHARE of the train ratings (the
# whole catalog), HypAR's on MESH_HYPAR_STEPS of its epoch's steps
MESH_TEXT_CUT, MESH_TEXT_SHARE, MESH_HYPAR_STEPS = ("CDR", "NARRE", "HRDR"), 4, 8


def mesh_text_sentiment_model(name, mesh=None, **extra):
    """The bench configuration ``name`` (``bpr_quality_band``'s
    ``TEXT_CONFIGS`` and ``SENTIMENT_CONFIGS``) at seed 123, with ``mesh``,
    at the depth of ``MESH_TEXT_SENTIMENT``."""
    from bpr_quality_band import SENTIMENT_CONFIGS, TEXT_CONFIGS

    from cornac_tpu_torch import models as M

    cls, kw = {**TEXT_CONFIGS, **SENTIMENT_CONFIGS}[name]
    _, depth, value = MESH_TEXT_SENTIMENT[name]
    return getattr(M, cls)(**{**kw, depth: value}, seed=123, mesh=mesh, **extra)


def phase_mesh_text_sentiment(bench_data, mesh):
    """The text, review and sentiment models (the rest of A8 (d)) at the
    bench shapes of 12j and 12k (``make_ml100k_like(7)`` with
    ``seq_bench_data.text_modalities``, and with seeded timestamps and
    sentiment, the ComparER models on its first users), one epoch or sweep
    or a few iterations each (``MESH_TEXT_SENTIMENT``; ``MESH_TEXT_CUT``'s
    over a part of the ratings, HypAR's over a few steps), the two fits of
    a pair building the host data once (``reused_builds``), fitted with
    ``mesh=`` (the world-size-1 NCCL mesh) and without, counted: the
    fitted state held bit for bit; each pair's seconds printed; the
    mesh-fitted models with vectors serving ``MESH_SERVED`` users through
    fused_topk, held to the plain version. Returns (accumulate_rows
    launches, fused_topk launches, {name: (mesh s, plain s)})."""
    import torch

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.models.hypar as hypar_mod
    from bpr_quality_band import sentiment_split, text_split
    from cornac_tpu_torch.models.hypar import fixed_svds_start
    from cornac_tpu_torch.models.recommender import ANNMixin
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    triples = bench_data()
    cells = clock("the text, sentiment and ComparER splits (set-up)", lambda: {
        "text": text_split(pdata, peval, triples).train_set,
        "sentiment": sentiment_split(pdata, peval, triples).train_set,
        "comparer": sentiment_split(pdata, peval, triples, "ComparERObj").train_set})
    text = cells["text"]
    cells["text cut"] = rating_prefix(text, text.num_ratings // MESH_TEXT_SHARE)

    def fit(name, mesh_):
        cell = MESH_TEXT_SENTIMENT[name][0]
        with limited_steps(hypar_mod, MESH_HYPAR_STEPS), fixed_svds_start(0):
            return mesh_text_sentiment_model(name, mesh_).fit(
                cells["text cut" if name in MESH_TEXT_CUT else cell])

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    fits, served, relaxed = {}, [], 0
    with reused_builds(SENTIMENT_BUILDS, {}):  # a pair's two fits build once
        for name in MESH_TEXT_SENTIMENT:
            fits[name] = (clock(f"{name} mesh", lambda: fit(name, mesh)),
                          clock(f"{name} plain", lambda: fit(name, None)))
    for name, (sharded, _) in fits.items():
        if isinstance(sharded, ANNMixin):
            relaxed += clock(f"{name} serving", lambda: serve_factor_model(
                sharded, text, np.arange(MESH_SERVED)))
            served.append(name)
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the text, review and sentiment configurations at the bench shape, mesh and "
                 "plain")
    if launches <= 0 or fused < len(served):
        raise AssertionError(f"the mesh fits launched accumulate_rows {launches} times and "
                             f"fused_topk {fused} times for {len(served)} served models")

    # ---- check what came out ----
    seconds = {}
    for name, (sharded, plain) in fits.items():
        held_bits(f"{name}(mesh=...)", model_arrays(sharded), model_arrays(plain))
        seconds[name] = (clock.seconds[f"{name} mesh"], clock.seconds[f"{name} plain"])
    log("  the text, review and sentiment configurations at the bench shape, world size 1 "
        "(NCCL): equal to the plain fits bit for bit; seconds, mesh / plain (host clock): "
        + ", ".join(
            f"{n} {m:.3f} / {p:.3f}" for n, (m, p) in seconds.items()))
    log(f"  {len(served)} mesh-fitted models ({', '.join(served)}) serving {MESH_SERVED} users "
        f"at k=10: the plain version's lists (positions relaxed as near-ties: {relaxed}); "
        f"accumulate_rows launches {launches}, fused_topk launches {fused}")
    log(f"the text, review and sentiment mesh fits at the bench shape: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    del fits
    torch.cuda.empty_cache()
    return launches, fused, seconds


def phase_mesh_bench(bench_data):
    """Phase 12l, in a spawned process: ``phase_mesh_families``,
    ``phase_mesh_seq_side`` and ``phase_mesh_text_sentiment`` on a
    world-size-1 NCCL mesh of this process's own (``start_mesh``: a group
    kept in memory, which no other process joins), ended with the phase;
    two CPU threads.
    Returns (accumulate_rows launches, fused_topk launches, {name: (mesh s,
    plain s)}), the three phases' summed."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)  # beside phase 16's host-bound steps, as 12j and 12k
    mesh = start_mesh()
    try:
        launches, fused, seconds = 0, 0, {}
        for phase in (phase_mesh_families, phase_mesh_seq_side, phase_mesh_text_sentiment):
            more, more_fused, more_seconds = phase(bench_data, mesh)
            launches, fused, seconds = launches + more, fused + more_fused, {**seconds,
                                                                             **more_seconds}
        return launches, fused, seconds
    finally:
        dist.destroy_process_group()


def mesh_wmf_netflix(ds, mesh):
    """WMF(mesh=...) at the Netflix widths (k = 64): one sweep on the
    world-size-1 mesh (its share of the degree buckets' chunks, all of them
    at world size 1) beside a plain one-sweep fit, held bit for bit; each
    fit's peak device memory printed. Returns the two fits' seconds and
    peaks."""
    import torch

    from cornac_tpu_torch.models import WMF

    clock = Clock()
    kw = dict(k=WMF_K, max_iter=1, seed=123, verbose=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sharded = clock("WMF(mesh=...).fit, 1 sweep (set-up included)",
                    lambda: WMF(mesh=mesh, **kw).fit(ds))
    peak_mesh = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    plain = clock("WMF.fit, 1 sweep (set-up included)", lambda: WMF(**kw).fit(ds))
    peak_plain = torch.cuda.max_memory_allocated() - base
    clock.report("WMF(mesh=...) at the Netflix widths")
    for a in ("U", "V"):
        if not np.isfinite(getattr(plain, a)).all():
            raise AssertionError(f"the plain one-sweep WMF fit's {a} is not finite")
        if not np.array_equal(getattr(sharded, a), getattr(plain, a)):
            err = np.abs(getattr(sharded, a) - getattr(plain, a)).max()
            raise AssertionError(f"WMF(mesh=...) at the Netflix widths differs from the plain "
                                 f"fit in {a} (max |diff| {err:.3e})")
    log(f"  WMF(mesh=...) k={WMF_K}, world size 1: one sweep equal to the plain one-sweep fit "
        f"bit for bit; peak device memory above what the run held: mesh fit "
        f"{peak_mesh / 2**30:.3f} GiB, plain fit {peak_plain / 2**30:.3f} GiB; seconds (host "
        f"clock, set-up "
        f"included): mesh {clock.seconds['WMF(mesh=...).fit, 1 sweep (set-up included)']:.3f},"
        f" plain {clock.seconds['WMF.fit, 1 sweep (set-up included)']:.3f}")
    del sharded, plain
    torch.cuda.empty_cache()
    return dict(mesh_s=clock.seconds["WMF(mesh=...).fit, 1 sweep (set-up included)"],
                plain_s=clock.seconds["WMF.fit, 1 sweep (set-up included)"],
                peak_mesh=peak_mesh, peak_plain=peak_plain)


def neural_configs():
    """(band name, the depth's keyword, maker) of ``benchmarks/model_sweep.py``'s
    configurations of the neural family, with GMF and MLP at NeuMF's depth
    and NGCF at LightGCN's."""
    from cornac_tpu_torch import models as M

    def make(cls, **fixed):
        return lambda **kw: cls(**{**fixed, **kw})

    return [
        ("VAECF", "n_epochs", make(M.VAECF, k=10, n_epochs=100, seed=123)),
        ("RecVAE", "n_epochs", make(M.RecVAE, n_epochs=20, seed=123)),
        ("BiVAECF", "n_epochs", make(M.BiVAECF, k=10, n_epochs=100, seed=123)),
        ("GMF", "num_epochs", make(M.GMF, num_factors=8, num_epochs=10, seed=123)),
        ("MLP", "num_epochs", make(M.MLP, layers=(32, 16, 8), num_epochs=10, seed=123)),
        ("NeuMF", "num_epochs", make(M.NeuMF, num_factors=8, layers=(32, 16, 8),
                                     num_epochs=10, seed=123)),
        ("LightGCN", "num_epochs", make(M.LightGCN, emb_size=64, num_layers=3, num_epochs=40,
                                        seed=2020)),
        ("NGCF", "num_epochs", make(M.NGCF, emb_size=64, num_epochs=40, seed=2020)),
    ]


def fitted_arrays(model):
    """A neural model's fitted state as {name: numpy array}: its modules'
    parameters (``params``, or RecVAE's ``enc`` and ``dec``) and its
    scoring tables (BiVAECF's means, LightGCN's propagated ``U``, ``V``)."""
    import torch

    out = {}
    for attr in ("params", "enc", "dec"):
        module = getattr(model, attr, None)
        if isinstance(module, torch.nn.Module):
            out.update({f"{attr}.{n}": p.detach().cpu().numpy()
                        for n, p in module.named_parameters()})
    for attr in ("mu_theta", "mu_beta", "U", "V"):
        if hasattr(model, attr):
            out[attr] = np.asarray(getattr(model, attr))
    return out


def phase_neural_bench(bench_data, names):
    """RatioSplit -> Experiment with the neural family's configurations
    ``names`` at the bench shape: each model's AUC and NDCG@10 in its band,
    fit seconds per model, B1 behind BiVAECF's recommend_batch, VAECF's
    recommend_batch(k > 0) refused as in the JAX package; then two seeded
    fits of each at a depth of 2 epochs (the second verbose) bit for bit,
    whose accumulate_rows inputs (the first at each shape) are held to the
    plain version; the profile of one NeuMF epoch over the first 5,000
    ratings. Returns (accumulate_rows launches, fused_topk launches, fit
    seconds by name, max |kernel - plain| of the recorded inputs, the
    profile or None)."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, NDCG, Recall
    from cornac_tpu_torch.models import NeuMF
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set
    configs = [c for c in neural_configs() if c[0] in names]
    users = np.random.RandomState(5).choice(train.num_users, 512, replace=False)
    gathers = set(names) & {"GMF", "MLP", "NeuMF", "LightGCN", "NGCF"}  # via gather_rows
    what = "neural family (" + ", ".join(names) + ")"

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    exp = Experiment(split, [make(verbose=False) for _, _, make in configs],
                     [AUC(), NDCG(k=10), Recall(k=10)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clock(f"Experiment.run ({len(configs)} neural models)", exp.run)
    models = dict(zip((name for name, _, _ in configs), exp.models))
    relaxed = 0
    if "BiVAECF" in models:
        relaxed = clock("B1 behind BiVAECF.recommend_batch",
                        lambda: serve_factor_model(models["BiVAECF"], train, users))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report(what)
    if (gathers and launches <= 0) or ("BiVAECF" in models and fused <= 0):
        raise AssertionError(f"{what} launched accumulate_rows {launches} and fused_topk "
                             f"{fused} times")

    # ---- check what came out ----
    if "VAECF" in models:
        try:  # the JAX package raises TypeError here: k=10 means against 20-wide item rows
            models["VAECF"].recommend_batch([train.user_ids[u] for u in users[:4]], k=10)
            raise AssertionError("VAECF.recommend_batch(k=10) with a 20-wide decoder answered")
        except ValueError as err:
            log(f"  VAECF.recommend_batch(k=10): refused as in the JAX package ({err})")
    fit_s = {}
    for (name, _, _), model, res in zip(configs, exp.models, exp.result):
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{res.model_name}: non-finite metrics {vals}")
        fit_s[name] = res.metric_avg_results["Train (s)"]
        checks = []
        for metric in ("AUC", "NDCG@10"):
            lo, hi, _, _ = band(name, metric)
            inside = lo <= vals[metric] <= hi
            checks.append(inside)
            log(f"  {name}: {metric} {vals[metric]:.6f}, band [{lo:.6f}, {hi:.6f}] (5 JAX "
                f"seeds) {'inside' if inside else 'OUTSIDE'}")
        log(f"  {name}: fit {fit_s[name]:.3f} s, test {res.metric_avg_results['Test (s)']:.3f} s "
            f"(host clock); " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(checks):
            raise AssertionError(f"{name}: outside its quality band")
    acc_err, recorded = 0.0, 0
    refits = Clock()
    for name, depth, make in configs:
        short = {depth: SHORT_DEPTH}
        first = refits(f"{name}.fit, {SHORT_DEPTH} epochs", lambda: make(**short).fit(train))
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = refits(f"{name}.fit, verbose=True, {SHORT_DEPTH} epochs",
                           lambda: make(verbose=True, **short).fit(train))
        want, got = fitted_arrays(first), fitted_arrays(again)
        if not want or want.keys() != got.keys():
            raise AssertionError(f"{name}: fitted state {sorted(want)} vs {sorted(got)}")
        for key in want:
            if not np.array_equal(want[key], got[key]):
                raise AssertionError(f"{name}: two seeded fits differ in {key} (one verbose)")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    refits.report(f"{what}, second fits")
    if gathers and recorded == 0:
        raise AssertionError(f"no trainer of the {what} handed accumulate_rows an input")
    prof = None
    if "NeuMF" in models:
        part = Dataset.from_uir(bench_data()[:5_000], seed=123)
        n_batches = -(-part.num_ratings * 5 // 256)
        prof = epoch_profile(lambda e: NeuMF(num_factors=8, layers=(32, 16, 8), num_epochs=e,
                                             seed=123, verbose=False).fit(part), n_batches, 1)
        log(f"  profile, one NeuMF epoch over the first {part.num_ratings} ratings ({n_batches} "
            f"minibatches of 256; a 1-epoch fit minus a 0-epoch fit): {prof['wall_ms']:.1f} ms "
            f"host clock, device busy {prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
            f"{prof['launches_per_minibatch']:.1f} device events per minibatch; top device ops: "
            f"{prof['top']}")
    log(f"  every model: two seeded fits of {SHORT_DEPTH} epochs (the second verbose, in chunks "
        f"of one epoch) identical, bit for bit; accumulate_rows on the trainers' own inputs "
        f"({recorded} shapes) equal to the plain version on the CPU, bit for bit (max |err| "
        f"{acc_err:.3e}); BiVAECF's serving lists equal to the plain version (positions relaxed "
        f"as near-ties: {relaxed}); accumulate_rows launches {launches}, fused_topk launches "
        f"{fused}")
    log(f"{what} at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} s, "
        f"second fits {sum(refits.seconds.values()):.1f} s")
    return launches, fused, fit_s, acc_err, prof


def phase_lightgcn_ml10m(train, gen, mesh):
    """LightGCN's edge-form propagation at the ML-10M widths (69,878 users x
    10,677 items, 10,000,054 edges, d = 64), the adjacency as LightGCN.fit
    builds it (far past the dense budget): one step forward and backward
    through gather_rows and accumulate_rows, then LightGCN's 3-layer mean
    forward and backward, counted; the step's four outputs held bit for bit
    to the same step on the CPU, where ``accumulate_rows`` is its plain
    version (``index_add_`` in edge order), two calls bit for bit; times of
    the step and the 3 layers beside the plain version on the card
    (``index_add_``, atomic), four cuSPARSE products (the same function's
    forward and backward as CSR x dense) and the bound. Then
    ``NormAdjacency(mesh=...)`` on the world-size-1 NCCL mesh, counted: its
    3-layer mean forward and backward equal to the plain adjacency's bits."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.graph import NormAdjacency, layer_mean, propagate, propagate_torch

    clock = Clock()
    adj = clock("NormAdjacency (set-up)", lambda: NormAdjacency(train))
    if adj.dense is not None:
        raise AssertionError("the ML-10M adjacency took the dense form")
    nu, ni, E, d = train.num_users, train.num_items, adj.edge_u.numel(), 64
    ue, ie, gu, gi = (torch.randn(n, d, generator=gen, device=DEV) for n in (nu, ni, nu, ni))
    eu, ei, w = adj.edge_u, adj.edge_i, adj.edge_norm

    def fwd_bwd(fn, x=(ue, ie, gu, gi)):
        u, i = x[0].clone().requires_grad_(True), x[1].clone().requires_grad_(True)
        a, b = fn(u, i)
        return (a.detach(), b.detach(), *torch.autograd.grad([a, b], [u, i], x[2:]))

    def layers(u, i):
        return adj.lightgcn(u, i, 3)

    def plain(u, i):
        return propagate_torch(u, i, eu, ei, w)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    got = clock("one step, forward and backward", lambda: fwd_bwd(adj.propagate))
    step_launches = ACCUMULATE_ROWS.launches
    clock("3 layers, forward and backward", lambda: fwd_bwd(layers))
    launches = ACCUMULATE_ROWS.launches
    clock.report("LightGCN edge form at ML-10M")
    if step_launches != 4 or launches != 4 + 12:
        raise AssertionError(f"{step_launches} and {launches} accumulate_rows launches, want 4 "
                             f"and 16")

    # ---- check and measure ----
    again = fwd_bwd(adj.propagate)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("two calls of the edge-form step differ")
    names = ("messages to users", "messages to items", "gradient of users", "gradient of items")
    on_cpu = [t.cpu() for t in (eu, ei, w)]
    want = fwd_bwd(lambda u, i: propagate(u, i, *on_cpu), tuple(t.cpu() for t in (ue, ie, gu, gi)))
    max_err = 0.0
    for name, k_out, c_out in zip(names, got, want):
        k_out = k_out.cpu()
        max_err = max(max_err, (k_out - c_out).abs().max().item())
        if not torch.equal(k_out, c_out):
            raise AssertionError(f"ML-10M {name}: the kernel differs from the plain version on "
                                 f"the CPU, max |kernel - plain| {max_err:.3e}")
    del want, on_cpu
    ref = fwd_bwd(plain)
    card_err = max((k_out - p_out).abs().max().item() for k_out, p_out in zip(got, ref))
    del ref, again
    torch.cuda.empty_cache()
    rows_u = torch.sparse_coo_tensor(torch.stack([eu, ei]), w, (nu, ni)).coalesce().to_sparse_csr()
    rows_i = torch.sparse_coo_tensor(torch.stack([ei, eu]), w, (ni, nu)).coalesce().to_sparse_csr()

    def library():  # A·ie, Aᵀ·ue forward; Aᵀ·gu, A·gi backward
        return (torch.sparse.mm(rows_u, ie), torch.sparse.mm(rows_i, ue),
                torch.sparse.mm(rows_i, gu), torch.sparse.mm(rows_u, gi))

    ms = time_ms(lambda: fwd_bwd(adj.propagate), 5, 1)
    plain_ms = time_ms(lambda: fwd_bwd(plain), 5, 1)
    library_ms = time_ms(library, 5, 1)
    layers_ms = time_ms(lambda: fwd_bwd(layers), 3, 1)
    layers_plain_ms = time_ms(lambda: fwd_bwd(lambda u, i: layer_mean(plain, u, i, 3)), 3, 1)
    nbytes = 4.0 * 2 * 2 * (nu + ni) * d + 20.0 * E
    flops = 2.0 * 4 * E * d
    bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    log(f"  LightGCN edge form, ML-10M ({nu:,} users x {ni:,} items, {E:,} edges, d={d}): one "
        f"step forward and backward (4 accumulate_rows launches) {ms:.3f} ms, plain "
        f"(index_add_ and autograd's gather) {plain_ms:.3f} ms, 4 cuSPARSE CSR x dense "
        f"products {library_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {flops:.3e} FLOP, "
        f"{nbytes / 1e6:.1f} MB), {100 * bound_ms / ms:.3f}% of it; 3 layers forward and "
        f"backward {layers_ms:.3f} ms, plain {layers_plain_ms:.3f} ms (CUDA events)")
    log(f"  the step's four outputs equal to the step on the CPU (accumulate_rows' plain "
        f"version), bit for bit; max |kernel - plain on the card (index_add_, atomic)| "
        f"{card_err:.3e}; two calls bit-identical; accumulate_rows launches {launches}")
    del rows_u, rows_i

    # ---- NormAdjacency(mesh=...), world size 1: the main path, counted ----
    madj = clock("NormAdjacency(mesh=...) (set-up)", lambda: NormAdjacency(train, mesh=mesh))
    ACCUMULATE_ROWS.launches = 0
    sharded = clock("3 layers through NormAdjacency(mesh=...), forward and backward",
                    lambda: fwd_bwd(lambda u, i: madj.lightgcn(u, i, 3)))
    mesh_launches = ACCUMULATE_ROWS.launches
    if mesh_launches != 12 or madj.dense is not None:
        raise AssertionError(f"NormAdjacency(mesh=...) launched accumulate_rows {mesh_launches} "
                             f"times (dense form: {madj.dense is not None}), want 12 on edges")
    whole = fwd_bwd(layers)
    for name, m_out, p_out in zip(("layer mean of users", "layer mean of items",
                                   "gradient of users", "gradient of items"), sharded, whole):
        if not torch.equal(m_out, p_out):
            raise AssertionError(f"ML-10M 3 layers, {name}: NormAdjacency(mesh=...) differs from "
                                 f"the plain adjacency, max |diff| "
                                 f"{(m_out - p_out).abs().max().item():.3e}")
    mesh_ms = time_ms(lambda: fwd_bwd(lambda u, i: madj.lightgcn(u, i, 3)), 3, 1)
    log(f"  NormAdjacency(mesh=...), world size 1 (NCCL), the same {E:,} edges: 3 layers forward "
        f"and backward equal to the plain adjacency's, bit for bit; {mesh_ms:.3f} ms against "
        f"{layers_ms:.3f} (CUDA events); set-up "
        f"{clock.seconds['NormAdjacency(mesh=...) (set-up)']:.3f} s against "
        f"{clock.seconds['NormAdjacency (set-up)']:.3f} (host clock); accumulate_rows launches "
        f"{mesh_launches}")
    del madj, sharded, whole
    log(f"LightGCN edge form at ML-10M: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches + mesh_launches, dict(
        mesh_ms=mesh_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, layers_ms=layers_ms, layers_plain_ms=layers_plain_ms,
        max_abs_err=max_err, card_plain_max_abs_err=card_err)


# examples/hpf_movielens.py's HPF (k = 5, 100 sweeps) on phase 10's train set
HPF_ML10M = dict(k=5, seed=123)
HPF_SWEEPS = 100
HPF_RTOL, HPF_ATOL = 3e-5, 1e-6


def phase_hpf_ml10m(train, seed):
    """HPF at the ML-10M widths (69,878 users x 10,677 items, 10,000,054
    ratings, k = 5), phase 10's train set: fits of 1 and of 3 sweeps on
    the card held to the same fits on the CPU (rtol ``HPF_RTOL``: digamma,
    exp and the column sums differ by ulps between the two devices; the
    scatters do not), the first sweep's two accumulate_rows inputs held bit
    for bit to the plain version on the CPU and timed, a second 3-sweep
    fit bit for bit, the 100-sweep fit timed (seconds per sweep from a
    100-sweep fit minus a 3-sweep fit) beside a sweep's byte bound, the
    device-busy share and peak device memory; then recommend_batch for
    8,192 users at k = 100 through fused_topk (d = 5), every list held to
    the plain version. Returns (accumulate_rows launches, fused_topk
    launches, the fitted model, the users served, the stats)."""
    import torch

    from cornac_tpu_torch.models import HPF
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    tables = ("Gs", "Gr", "Ls", "Lr")

    def fit(sweeps, device=None):
        return HPF(max_iter=sweeps, device=device, **HPF_ML10M).fit(train)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    with recording_accumulate({}) as store:
        one = clock("HPF.fit, 1 sweep", lambda: fit(1))
    three = clock("HPF.fit, 3 sweeps", lambda: fit(3))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = clock(f"HPF.fit, {HPF_SWEEPS} sweeps", lambda: fit(HPF_SWEEPS))
    peak = torch.cuda.max_memory_allocated() - held
    rng = np.random.RandomState(seed + 4)
    users = rng.choice(train.num_users, SERVE_BATCH, replace=False)
    recs = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                 lambda: model.recommend_batch(list(users), k=TOPK))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("HPF at ML-10M")
    if launches != 2 * (1 + 3 + HPF_SWEEPS) or fused <= 0:
        raise AssertionError(f"HPF launched accumulate_rows {launches} times (want "
                             f"{2 * (4 + HPF_SWEEPS)}) and fused_topk {fused}")

    # ---- check and measure ----
    again = clock("HPF.fit, 3 sweeps, again", lambda: fit(3))
    for name in tables:
        if not np.array_equal(getattr(three, name), getattr(again, name)):
            raise AssertionError(f"HPF at ML-10M: two seeded 3-sweep fits differ in {name}")
    worst = 0.0
    for sweeps, on_card in ((1, one), (3, three)):
        on_cpu = clock(f"HPF.fit on the CPU, {sweeps} sweep(s)", lambda: fit(sweeps, "cpu"))
        for name in tables:
            a, b = getattr(on_card, name), getattr(on_cpu, name)
            rel = float(np.max(np.abs(a - b) / (HPF_ATOL + np.abs(b))))
            worst = max(worst, rel)
            if not np.allclose(a, b, rtol=HPF_RTOL, atol=HPF_ATOL):
                raise AssertionError(f"HPF at ML-10M, {sweeps} sweep(s): {name} on the card "
                                     f"differs from the CPU's beyond rtol {HPF_RTOL}")
    if len(store) != 2:
        raise AssertionError(f"the first sweep recorded {len(store)} accumulate_rows shapes")
    acc_err, acc_ms = 0.0, {}
    for (shape, B, stride), (table, ids, upd) in store.items():
        # not profiled: this late in the process the profiler loses the
        # kernel's events; at tens of ms a launch, CUDA events time it
        err = check_accumulate(f"HPF's first sweep, {B} ids into {shape}", table, ids, upd,
                               calls=0)[0]
        acc_err, acc_ms[shape[0]] = max(acc_err, err), time_ms(
            lambda: accumulate_rows(table.clone(), ids, upd), 3, 1)
    del store
    if not all(np.isfinite(getattr(model, name)).all() for name in ("Theta", "Beta")):
        raise AssertionError("the 100-sweep fit has non-finite tables")
    # the 1-sweep fit records its scatters' inputs (copies of 10M rows): the
    # 3-sweep fit is the set-up to subtract
    sweep_s = (clock.seconds[f"HPF.fit, {HPF_SWEEPS} sweeps"]
               - clock.seconds["HPF.fit, 3 sweeps"]) / (HPF_SWEEPS - 3)
    nu, ni, n, k = train.num_users, train.num_items, train.num_ratings, HPF_ML10M["k"]
    # a sweep must read the ratings (two int64 ids and a float32 value) once
    # and read and write each table row once (G_s, G_r, L_s, L_r and the
    # rates K_r, T_r)
    nbytes = 20.0 * n + 2 * 4.0 * (2 * (nu + ni) * k + nu + ni)
    bound_s = nbytes / PEAK_BYTES
    # the busy share of 3 sweeps alone (the sweep function on the fit's own
    # device tensors, no uploads), from the profiler's device events; this
    # late in the process it may lose some, and then the share is not
    # measured (6 accumulate_rows launches must be seen)
    state = [torch.as_tensor(np.asarray(t, np.float32), device=DEV)
             for t in HPF(**HPF_ML10M, max_iter=0).fit(train)._initial_tables()]
    state += [torch.ones(nu, device=DEV), torch.ones(ni, device=DEV)]
    edges = [torch.as_tensor(np.asarray(a, dt), device=DEV)
             for a, dt in zip(train.uir_tuple, (np.int64, np.int64, np.float32))]
    from cornac_tpu_torch.models.hpf import _hpf_cavi

    _hpf_cavi(*state, *edges, 1, True)  # warm
    wall_ms, busy_ms, _, events = profile_call(lambda: _hpf_cavi(*state, *edges, 3, True))
    kept = sum(e.count for e in events if "accumulate_rows_kernel" in e.key)
    share = busy_ms / wall_ms if kept == 6 else None
    log(f"  HPF k={k} over {n:,} ratings ({nu:,} users x {ni:,} items): {sweep_s * 1e3:.3f} ms per "
        f"sweep (a {HPF_SWEEPS}-sweep fit minus a 3-sweep fit, over {HPF_SWEEPS - 3}); byte bound "
        f"{bound_s * 1e3:.4f} ms per sweep ({nbytes / 1e6:.1f} MB over {PEAK_BYTES / 1e12:.2f} "
        f"TB/s), {100 * bound_s / sweep_s:.3f}% of it; accumulate_rows "
        + ", ".join(f"{ms:.3f} ms into {R:,} rows" for R, ms in acc_ms.items())
        + " (CUDA events, the table copied in each)"
        + "; 3 sweeps busy "
        + (f"{100 * share:.2f}%" if share is not None else
           f"not measured (the profiler kept {kept} of 6 accumulate_rows events)")
        + f" ({wall_ms:.1f} ms host clock, {busy_ms:.3f} ms device, top device ops "
        f"{top_ops(events)}); peak device memory of the fit {peak / 2**30:.3f} GiB above "
        f"what the run held")
    del state, edges
    log(f"  fits of 1 and 3 sweeps equal to the CPU's within rtol {HPF_RTOL} / atol {HPF_ATOL} "
        f"(max |card - cpu| / (atol + |cpu|) {worst:.3e}); two seeded 3-sweep fits bit for bit; "
        f"the first sweep's accumulate_rows inputs equal to the plain version on the CPU, bit "
        f"for bit (max |err| {acc_err:.3e})")
    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    got = [[model.iid_map[i] for i in row] for row in recs]
    relaxed = check_lists(got, want, plain_scores(Ud[users], Vd).cpu().numpy(),
                          "HPF recommend_batch")
    log(f"  recommend_batch ({SERVE_BATCH} users, k={TOPK}, d={k}): equal to the plain version "
        f"(positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}")
    log(f"HPF at ML-10M: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, model, users, dict(
        sweep_s=sweep_s, bound_s=bound_s, share=share, peak=peak, acc_ms=acc_ms,
        max_abs_err=acc_err, worst_rel=worst)


# benchmarks/vaecf_sparse_stream.py:38-39, VAECF at the Netflix widths
VAECF_FULL = dict(k=32, autoencoder_structure=[100], batch_size=1024, learning_rate=0.001, seed=1)


def phase_vaecf_full(ds, seed):
    """VAECF at 480,000 x 17,700 on the WMF phase's 20M pairs: fits of 1 and
    of 1 + 3 epochs (the index-resident mode: 34 GB dense, 160 MB of
    coordinates), seconds per steady epoch beside the FP32 FLOP bound, peak
    device memory; the fit's input and progress (three batches' blocks
    densified on the card equal to the binarized rows of the train matrix,
    every parameter tensor moved from its initial value, a 0-epoch fit's,
    by the first epoch and again by the next three); score_batch of 8,192
    users, their top-100 held to a float64 scoring of the same parameters;
    recommend for one user."""
    import torch

    from cornac_tpu_torch.engine.nn import ACTIVATIONS
    from cornac_tpu_torch.models import VAECF
    from cornac_tpu_torch.models.vaecf import _decode, _encode, batch_source

    clock = Clock()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors the times phase reuses
    fit1 = clock("VAECF.fit, 1 epoch", lambda: VAECF(n_epochs=1, **VAECF_FULL).fit(ds))
    model = clock("VAECF.fit, 4 epochs", lambda: VAECF(n_epochs=4, **VAECF_FULL).fit(ds))
    peak = torch.cuda.max_memory_allocated()
    users = np.random.RandomState(seed + 7).choice(N_USERS, SERVE_BATCH, replace=False)
    scores = clock(f"score_batch {SERVE_BATCH} users", lambda: model.score_batch(users))
    uid = ds.user_ids[int(users[0])]
    rec = clock("recommend (one user, k=100)", lambda: model.recommend(uid, k=TOPK))
    clock.report("VAECF at the Netflix widths")
    if model.data_mode != "index-resident":
        raise AssertionError(f"the full-width VAECF fit took the {model.data_mode} mode")
    if not all(torch.isfinite(p).all() for p in model.params.parameters()):
        raise AssertionError("the full-width VAECF fit has non-finite parameters")
    if scores.shape != (SERVE_BATCH, N_ITEMS) or not np.isfinite(scores).all():
        raise AssertionError(f"score_batch gave {scores.shape}")

    # what the fit trained on: the index-resident blocks of the first, a
    # middle and the last (padded) batch are the binarized rows
    dev, bsz = torch.device(DEV), VAECF_FULL["batch_size"]
    n_rows = model.r_mat.shape[0]
    n_batches = -(-n_rows // bsz)
    mode, fetch = batch_source(model.r_mat, bsz, dev)
    if mode != "index-resident":
        raise AssertionError(f"the batch source took the {mode} mode")
    for b in (0, n_batches // 2, n_batches - 1):
        rows = model._rows(np.arange(b * bsz, min((b + 1) * bsz, n_rows)))
        want = torch.zeros((bsz, N_ITEMS))
        want[:rows.shape[0]] = torch.from_numpy(rows)
        if not torch.equal(fetch(b).cpu(), want):
            raise AssertionError(f"batch {b}'s densified block differs from the train rows")
    del fetch
    # and that it trained: every tensor moved, the decoder's too (it has no
    # gradient where the blocks are zeros)
    init = VAECF(n_epochs=0, **VAECF_FULL).fit(ds).params
    stages = [dict(m.named_parameters()) for m in (init, fit1.params, model.params)]
    steps = (("epoch 1", stages[0], stages[1]), ("epochs 2-4", stages[1], stages[2]))
    still = [f"{name} ({when})" for name in stages[0] for when, a, b in steps
             if torch.equal(a[name], b[name])]
    if still:
        raise AssertionError(f"VAECF parameters that did not move: {still}")
    del init, stages, fit1

    # the plain scoring: the same parameters and rows in float64
    vae64, act = copy.deepcopy(model.params).double(), ACTIVATIONS[model.act_fn]
    S = torch.empty((SERVE_BATCH, N_ITEMS), dtype=torch.float64)
    with torch.no_grad():
        for s in range(0, SERVE_BATCH, 1024):
            x = torch.as_tensor(model._rows(users[s:s + 1024]), device=dev).double()
            S[s:s + 1024] = _decode(vae64, _encode(vae64, x, act)[0], act, model.likelihood).cpu()
    want = torch.sort(S, dim=1, descending=True, stable=True)[1][:, :TOPK].numpy()
    got = np.argsort(-scores, axis=1, kind="stable")[:, :TOPK]
    relaxed = check_lists(got, want, S.numpy(), "VAECF score_batch top-100")
    if [model.iid_map[i] for i in rec] != [ds.item_ids[i] for i in got[0]]:
        raise AssertionError("recommend for one user differs from its score_batch row")
    epoch_s = (clock.seconds["VAECF.fit, 4 epochs"] - clock.seconds["VAECF.fit, 1 epoch"]) / 3
    # where a batch's time goes: an epoch over the first 50 batches' users
    # (the same shapes a batch; a whole epoch would give the profiler some
    # 50,000 events), a 1-epoch fit minus a 0-epoch fit
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    n_part = 50 * VAECF_FULL["batch_size"]
    u, i, r = ds.uir_tuple
    keep = u < n_part
    part = Dataset(num_users=n_part, num_items=N_ITEMS,
                   uid_map=OrderedDict((x, x) for x in range(n_part)),
                   iid_map=OrderedDict((x, x) for x in range(N_ITEMS)),
                   uir_tuple=(u[keep], i[keep], r[keep]), seed=0)
    prof = epoch_profile(lambda e: VAECF(n_epochs=e, **VAECF_FULL).fit(part), 50, 1)
    h, z = VAECF_FULL["autoencoder_structure"][0], VAECF_FULL["k"]
    row_flops = 2.0 * (N_ITEMS * h + 2 * h * z + z * h + h * N_ITEMS)
    flops = 3 * row_flops * n_batches * VAECF_FULL["batch_size"]
    bound_s = flops / PEAK_F32_FLOPS
    log(f"  VAECF k={z} [{h}] batch {VAECF_FULL['batch_size']} over {ds.num_ratings:,} pairs "
        f"({N_USERS:,} users x {N_ITEMS:,} items, {model.data_mode}): {epoch_s:.3f} s per steady "
        f"epoch ((fit of 4 epochs - fit of 1) / 3, host clock); FP32 FLOP bound {flops:.4e} FLOP "
        f"= 3 x {row_flops / 1e6:.3f} MFLOP x {n_batches} x {VAECF_FULL['batch_size']} rows over "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = {bound_s:.4f} s, {100 * bound_s / epoch_s:.2f}% "
        f"of it; peak device memory {peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB "
        f"above the {held / 2**30:.3f} GiB the run held before the fits")
    log(f"  profile, one epoch over the first {n_part:,} users (50 batches; a 1-epoch fit minus "
        f"a 0-epoch fit): {prof['wall_ms']:.1f} ms host clock, device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
        f"{prof['launches_per_minibatch']:.1f} device events per batch; top device ops: "
        f"{prof['top']}")
    log(f"  the fit's input: batches 0, {n_batches // 2} and {n_batches - 1} densified on the "
        f"card equal to the train rows; all {len(dict(model.params.named_parameters()))} "
        f"parameter tensors moved in epoch 1 and again in epochs 2-4")
    log(f"  score_batch ({SERVE_BATCH} users): top-{TOPK} equal to a float64 scoring of the same "
        f"parameters (positions relaxed as near-ties: {relaxed}); recommend for one user equal "
        f"to its row")
    log(f"VAECF at the Netflix widths: ok in {sum(clock.seconds.values()):.1f} s")
    del model, vae64, scores, S
    torch.cuda.empty_cache()
    return dict(epoch_s=epoch_s, bound_s=bound_s, peak=peak - held, share=prof["share"],
                fit1_s=clock.seconds["VAECF.fit, 1 epoch"],
                fit4_s=clock.seconds["VAECF.fit, 4 epochs"])


def phase_times(bpr, users, batches=(1, 256, SERVE_BATCH), what="BPR"):
    """CUDA-event times of fused_topk at each batch size of ``batches``
    (the serving model's vectors, for the first B of ``users``), each with
    its split S, against its plain version and ``matmul`` + ``topk`` timed
    in turn (plain, kernel, library), beside the bound."""
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk_torch

    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(bpr.get_user_vectors()[users], np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(bpr.get_item_vectors(), np.float32), device=dev)
    N, d = Vd.shape
    rows = {}
    for B in batches:
        U = Ud[:B].contiguous()
        reps = 20 if B == SERVE_BATCH else 200
        plain_ms = time_ms(lambda: fused_topk_torch(U, Vd, TOPK), reps)
        ms = time_ms(lambda: FUSED_TOPK(U, Vd, TOPK), reps)
        library_ms = time_ms(lambda: torch.topk(torch.matmul(U, Vd.T), TOPK, dim=1), reps)
        flops = 2.0 * B * N * d
        nbytes = 4.0 * (B * d + N * d) + 8.0 * B * TOPK
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        S = FUSED_TOPK.plan(U, N, TOPK)
        rows[B] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, slices=S, d=d, items=N)
        log(f"  times ({what}) B={B} N={N} d={d} k={TOPK} S={S}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, matmul+topk {library_ms:.4f} ms ({library_ms / ms:.2f}x the "
            f"kernel), bound {bound_ms:.4f} ms ({bound_by}), {B / ms * 1e3:,.0f} users/s, "
            f"{100 * bound_ms / ms:.2f}% of bound")
    return rows


def sparse_library_cosine_topk(A, A2, Wt, Bt, k):
    """The sparse library yardstick: ``num = A·Wᵀ`` and ``d1 = (A∘A)·Bᵀ``
    as CSR x dense products (cuSPARSE SpMM through ``torch.sparse``), then
    the elementwise step and ``torch.topk``. ``A`` and ``A2`` are CSR
    tensors, ``Wt`` and ``Bt`` (``[W ≠ 0]ᵀ``) dense, all built once outside
    the time. CSR x CSR (SpGEMM) ran out of cuSPARSE's resources on the
    half-dense matrix, so it is not the yardstick. Timed only; the port
    never calls it."""
    import torch

    num = torch.sparse.mm(A, Wt)
    d1 = torch.sparse.mm(A2, Bt)
    sim = torch.where(num != 0, num / torch.clamp_min(torch.sqrt(d1) * torch.sqrt(d1.T), 1e-12), 0.0)
    sim.fill_diagonal_(-3e38)
    return torch.topk(sim, k, dim=1)


def phase_cosine_times(shapes):
    """CUDA-event times of the sparse cosine kernel (on views built once),
    its plain version and the dense and sparse library yardsticks, beside
    the bound; two launches on one input must give the same bits.

    The bound counts what these inputs need, as for a sparse product: each
    co-rated pair of rows in a column is one update of three sums, so
    ``3·Σ_j c_j²`` operations for column counts ``c_j`` over 67 TFLOP/s,
    against the bytes the kernel reads once (the CSR: row pointers and 8
    bytes an entry; the CSC's 8 bytes an entry; the warps' split of every
    column, ``ops.cosine_topk.partition``) and the (n, k) table it writes
    (8 bytes an entry) over 3.35 TB/s; the larger of the two. The kernel's
    time includes building that split. Beside it, what a dense kernel
    would need: ``3·n²·m`` operations (``num = W·Wᵀ`` is symmetric,
    ``d2 = d1ᵀ``) and the dense W's bytes."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import (
        COSINE_TOPK, cosine_topk_torch, dense_views, partition)

    rows = {}
    for label, W in shapes:
        n, m = W.shape
        k = KNN_K
        t = time.perf_counter()
        views = dense_views(W)
        torch.cuda.synchronize()
        views_s = time.perf_counter() - t
        nnz = views.row_val.numel()
        dense_flops = 3.0 * n * n * m
        reps, warm = (3, 1) if dense_flops > 5e12 else (10, 2)
        first, second = COSINE_TOPK(views, k), COSINE_TOPK(views, k)
        if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
            raise AssertionError(f"{label}: two launches of the cosine kernel differ")
        del first, second
        plain_ms = time_ms(lambda: cosine_topk_torch(W, k), reps, warm)
        ms = time_ms(lambda: COSINE_TOPK(views, k), reps, warm)
        library_ms = time_ms(lambda: library_cosine_topk(W, k), reps, warm)
        A, A2 = W.to_sparse_csr(), (W * W).to_sparse_csr()
        Wt, Bt = W.T.contiguous(), (W != 0).float().T.contiguous()
        sparse_ms = time_ms(lambda: sparse_library_cosine_topk(A, A2, Wt, Bt, k), reps, warm)
        del A, A2, Wt, Bt
        torch.cuda.empty_cache()
        col_nnz = torch.diff(views.col_ptr.long()).double()
        flops = 3.0 * float((col_nnz * col_nnz).sum())
        bounds, split = partition(views, COSINE_TOPK.plan(n, W.device)[0])
        nbytes = 4.0 * (n + 1 + bounds.numel() + split.numel()) + 16.0 * nnz + 8.0 * n * k
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        dense_bytes = 4.0 * n * m + 8.0 * n * k
        dense_bound_ms = 1e3 * max(dense_flops / PEAK_F32_FLOPS, dense_bytes / PEAK_BYTES)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, dense_bound_ms=dense_bound_ms,
                           sparse_library_ms=sparse_ms)
        log(f"  times {label} n={n} m={m} nnz={nnz} k={k} (reps {reps}): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, 2 matmul + topk {library_ms:.3f} ms, 2 cuSPARSE CSR x dense "
            f"products + topk {sparse_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops:.3e} FLOP = 3 x sum of squared column counts, {nbytes / 1e6:.1f} MB), "
            f"{100 * bound_ms / ms:.2f}% of bound; a dense kernel's bound {dense_bound_ms:.3f} ms "
            f"({dense_flops:.3e} FLOP); views built from dense W in {views_s:.3f} s (host "
            f"clock); two launches bit-identical")
    return rows


def deterministic_index_add(table, ids, upd, reps):
    """``index_add_`` under ``torch.use_deterministic_algorithms(True)``:
    its CUDA-event ms, whether two launches give the same bits, whether
    those are the kernel's (the plain version's sums in batch order) and
    whether it runs under ``torch.cuda.set_sync_debug_mode("error")`` (no
    wait for the card). Both modes are restored; the port calls neither."""
    import torch

    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        ms = time_ms(lambda: table.index_add_(0, ids, upd), reps)
        a, b = (table.clone().index_add_(0, ids, upd) for _ in range(2))
        same_bits = torch.equal(a, b)
        as_kernel = torch.equal(a, accumulate_rows(table.clone(), ids, upd))
        t = table.clone()
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t.index_add_(0, ids, upd)
            no_sync = True
        except RuntimeError:
            no_sync = False
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    return ms, same_bits, as_kernel, no_sync


def phase_accumulate_times(cases):
    """CUDA-event times of accumulate_rows at the trainers' shapes, on the
    inputs ``phase_accumulate`` checked: the wrapper (one kernel), the plain
    version, ``index_add_`` (one library call, atomics) and ``index_add_``
    in PyTorch's deterministic mode, timed in turn, beside the bound; and
    the kernel's own device time per launch, which ``phase_accumulate``
    took from the profiler's events (None where it kept none). The
    bound counts what the function must move: the ids (8 bytes each) read
    once, the updates of the ids inside the table read once (the kernel
    never reads the others), each touched table row read and written once;
    its additions, one an element of those updates, are far below the
    float32 peak."""
    import torch

    from cornac_tpu_torch.ops.accumulate import (accumulate_rows, accumulate_rows_torch,
                                                 ids_in_table)

    rows = {}
    for label, (table, ids, upd, per_call, device_ms, kept, err, card_err) in cases.items():
        R, B = table.shape[0], ids.shape[0]
        d = table.shape[1] if table.dim() > 1 else 1
        reps = 200 if B < 1_000_000 else 10
        # the library calls on the ids inside the table: the kernel and
        # the plain version drop the others, index_add_ refuses them
        ok_ids, ok_upd = ids_in_table(table, ids, upd)
        plain_ms = time_ms(lambda: accumulate_rows_torch(table, ids, upd), reps)
        ms = time_ms(lambda: accumulate_rows(table, ids, upd), reps)
        library_ms = time_ms(lambda: table.index_add_(0, ok_ids, ok_upd), reps)
        # deterministic index_add_ sorts: 0.6-0.7 s a call at 10M ids
        det_ms, det_bits, det_as_kernel, det_no_sync = deterministic_index_add(
            table, ok_ids, ok_upd, reps if B < 100_000 else 3)
        # the profiler again, after the run's long profiles: it has been seen
        # to keep fewer of a short kernel's events late in the process
        late = profile_call(lambda: [accumulate_rows(table, ids, upd) for _ in range(20)])[2]
        touched = torch.unique(ok_ids).numel()
        # every id is read, only the updates of the ids inside are
        nbytes = 8.0 * B + 4.0 * ok_ids.numel() * d + 8.0 * touched * d
        flops = float(ok_ids.numel() * d)
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        rows[label] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                           deterministic_library_ms=det_ms, deterministic_same_bits=det_bits,
                           deterministic_bits_as_kernel=det_as_kernel,
                           deterministic_no_sync=det_no_sync, launches_per_call=per_call,
                           bound_ms=bound_ms, bound_by=bound_by, shape=f"{B} ids into {R} x {d}",
                           max_abs_err=err, card_plain_max_abs_err=card_err)
        as_kernel = "the kernel's bits" if det_as_kernel else "not the kernel's bits"
        log(f"  times accumulate_rows, {label}: {B} ids into {R} rows x {d} ({touched} touched): "
            f"kernel {ms:.4f} ms (device "
            + ("not measured" if device_ms is None else
               f"{device_ms:.4f} ms, mean of the {20 * kept:g} events the profiler kept of 20 "
               f"calls in phase 5; it keeps {late} of 20 here")
            + f"; {per_call:g} launch per call), plain {plain_ms:.4f} ms, "
            f"index_add_ {library_ms:.4f} ms, deterministic index_add_ {det_ms:.4f} ms (two "
            f"launches {'bit-identical' if det_bits else 'DIFFER'}, "
            f"{as_kernel}; "
            f"{'runs' if det_no_sync else 'does NOT run'} without a sync); bound "
            f"{bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.3f} MB), "
            f"{100 * bound_ms / ms:.2f}% of bound")
    return rows


# ---------------------------------------------------------------------------
# the modality layer's models at published widths: SBPR at Cornac's Epinions
# counts (its dataset documentation: 40,163 users, 139,738 items, 664,824
# ratings, 487,183 trust edges), C2PF at its Amazon Office counts (3,703
# users, 6,523 items, 53,282 ratings), the constants above; the data are
# seeded, not the files
# examples/sbpr_epinions.py's SBPR and examples/c2pf_example.py's C2PF
SBPR_EPINIONS = dict(k=10, learning_rate=0.001, seed=123)
# the example's 50 cut for the run's time (6 and 3, 10 and 5, 20 and 10 before)
SBPR_EPOCHS, SBPR_STOP = 4, 2
C2PF_OFFICE = dict(k=100, variant="c2pf", seed=123)
C2PF_ITERS = 80
C2PF_RTOL, C2PF_ATOL = 1e-4, 1e-6


def zipf_pairs(rng, n_users, n_items, n, user_skew, item_skew, cover=True):
    """``n`` distinct (user, item) pairs: users drawn with probability
    proportional to 1 / rank^user_skew and items to 1 / rank^item_skew,
    the ranks scattered over the ids, duplicates dropped in draw order.
    With ``cover``, every user and every item is in at least one pair (one
    pair each first, the other side drawn), as in a published dataset's
    counts."""
    def weights(m, skew):
        p = 1.0 / np.arange(1, m + 1) ** skew
        return rng.permutation(m), p / p.sum()

    (uperm, up), (iperm, ip) = weights(n_users, user_skew), weights(n_items, item_skew)
    keys = np.empty(0, np.int64)
    if cover:
        every_item = uperm[rng.choice(n_users, n_items, p=up)] * n_items + np.arange(n_items)
        every_user = np.arange(n_users) * n_items + iperm[rng.choice(n_items, n_users, p=ip)]
        keys = np.concatenate([every_item, every_user]).astype(np.int64)
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    while len(keys) < n:
        draw = int(1.3 * (n - len(keys))) + 1024
        u = uperm[rng.choice(n_users, draw, p=up)].astype(np.int64)
        i = iperm[rng.choice(n_items, draw, p=ip)].astype(np.int64)
        keys = np.concatenate([keys, u * n_items + i])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:n]
    return keys // n_items, keys % n_items


def star_triples(rng, users, items, prefix=("u", "i")):
    stars = rng.choice(np.arange(1, 6), len(users), p=[0.06, 0.08, 0.16, 0.32, 0.38])
    return [(f"{prefix[0]}{u}", f"{prefix[1]}{i}", float(r))
            for u, i, r in zip(users.tolist(), items.tolist(), stars.tolist())]


def epinions_like(seed):
    """Seeded data at the Epinions counts: star ratings over Zipf-like
    users and items, and directed trust edges (no self loops) toward
    Zipf-like popular users."""
    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, EPINIONS_USERS, EPINIONS_ITEMS, EPINIONS_RATINGS, 0.5, 0.8)
    ratings = star_triples(rng, users, items)
    src, dst = zipf_pairs(rng, EPINIONS_USERS, EPINIONS_USERS, EPINIONS_TRUST + 50_000, 0.4, 0.7,
                          cover=False)
    keep = src != dst
    src, dst = src[keep][:EPINIONS_TRUST], dst[keep][:EPINIONS_TRUST]
    trust = [(f"u{a}", f"u{b}", 1.0) for a, b in zip(src.tolist(), dst.tolist())]
    return ratings, trust


def office_like(seed):
    """Seeded data at the Amazon Office counts, and 64 seeded float32
    features an item (tie-free cosines) for the item graph."""
    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, OFFICE_USERS, OFFICE_ITEMS, OFFICE_RATINGS, 0.3, 0.6)
    feats = rng.normal(size=(OFFICE_ITEMS, 64)).astype(np.float32)
    return star_triples(rng, users, items), feats, [f"i{i}" for i in range(OFFICE_ITEMS)]


@contextlib.contextmanager
def recording_first_calls(store, limit, calls=None):
    """While open, the accumulate_rows wrapper keeps in ``store`` copies of
    the inputs of its first ``limit`` calls, or of the calls numbered
    ``calls`` (from 0) (the table as it was before the call), in order, and
    launches as always."""
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, AccumulateRowsKernel

    wanted = set(range(limit) if calls is None else calls)
    seen = [0]

    class Recording(AccumulateRowsKernel):
        def __call__(self, table, ids, updates):
            if seen[0] in wanted:
                store.append((table.clone(), ids.clone(), updates.clone()))
            seen[0] += 1
            return super().__call__(table, ids, updates)

    ACCUMULATE_ROWS.__class__ = Recording
    try:
        yield store
    finally:
        ACCUMULATE_ROWS.__class__ = AccumulateRowsKernel


def hold_and_time_calls(what, calls):
    """Each recorded accumulate_rows call held bit for bit to the plain
    version on the CPU, then timed with CUDA events on a scratch copy of its
    table beside ``index_add_`` (atomic) on the same inputs, and beside the
    bound (the ids and the updates of the ids inside the table read once,
    each touched row read and written once). Returns (max |err|, [(shape, ms, index_add_ ms, bound
    ms)])."""
    import torch

    from cornac_tpu_torch.ops.accumulate import accumulate_rows, ids_in_table

    max_err, rows = 0.0, []
    for n, (table, ids, upd) in enumerate(calls):
        R, B = table.shape[0], ids.shape[0]
        d = table.shape[1] if table.dim() > 1 else 1
        err = check_accumulate(f"{what}, call {n + 1}: {B} ids into {tuple(table.shape)}",
                               table, ids, upd, calls=0)[0]
        max_err = max(max_err, err)
        scratch = table.clone()
        ms = time_ms(lambda: accumulate_rows(scratch, ids, upd), 50)
        ok_ids, ok_upd = ids_in_table(table, ids, upd)  # index_add_ refuses the others
        lib = time_ms(lambda: scratch.index_add_(0, ok_ids, ok_upd), 50)
        touched = torch.unique(ok_ids).numel()
        # every id is read, only the updates of the ids inside are
        bound = 1e3 * (8.0 * B + 4.0 * ok_ids.numel() * d + 8.0 * touched * d) / PEAK_BYTES
        rows.append((f"{B} ids into {R} x {d}", ms, lib, bound))
        log(f"  {what}, call {n + 1}: {B} ids into {R} x {d} ({touched} touched): kernel "
            f"{ms:.4f} ms, index_add_ {lib:.4f} ms, bound {bound:.5f} ms (bytes), "
            f"{100 * bound / ms:.2f}% of it")
    return max_err, rows


def serve_check(model, train, users, what):
    """recommend_batch of the raw ids of ``users`` at k = TOPK through
    fused_topk, every list held to the plain version on the model's own
    vectors. Returns the positions relaxed as near-ties."""
    import torch

    dev = torch.device(DEV)
    recs = model.recommend_batch([train.user_ids[u] for u in users], k=TOPK)
    Ud = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    got = [[model.iid_map[i] for i in row] for row in recs]
    return check_lists(got, want, plain_scores(Ud[users], Vd).cpu().numpy(), what)


def sbpr_sample_bytes(csr, membership, k):
    """The least bytes one SBPR sample moves: the (user, item) pair (8),
    the membership probe (as ``sample_bytes`` counts it for the CSR binary
    search; one 4-byte word for the bitmap), the user's social row bounds
    and one social item and count (16), the four factor rows (user,
    positive, negative, social item) read and written once (2 x 4 x k x 4)
    and the three item biases read and written once (2 x 3 x 4)."""
    if membership.kind == "bitmap":
        probe = 4.0
    else:
        probe = sample_bytes(csr, k)[1]
    return 8.0 + probe + 16.0 + 2 * 4 * k * 4.0 + 2 * 3 * 4.0, probe


def phase_sbpr_epinions(seed, work):
    """Phase 15, SBPR at the Epinions widths: examples/sbpr_epinions.py's
    configuration on seeded data at its counts (``epinions_like``). Times
    the split with the user graph's build and the social arrays on the
    host; holds the first minibatch's five accumulate_rows inputs bit for
    bit to the plain version on the CPU; two seeded 2-epoch fits (the
    second one epoch a chunk) bit for bit; the ``SBPR_EPOCHS``-epoch fit
    timed (seconds per epoch, samples/s beside the byte bound of a sample,
    device events per minibatch and the busy share of one epoch, peak device
    memory); a checkpointed fit stopped at epoch ``SBPR_STOP`` and resumed
    to ``SBPR_EPOCHS`` equal to it bit for bit; ranking_eval's AUC, NDCG@10
    and Recall@10 (``evaluate_in_budget``); recommend_batch of
    8,192 users at k = 100 through fused_topk (d = 11), every list held to
    the plain version. Returns (accumulate_rows launches, fused_topk
    launches, the model, the users served, the stats, the split among
    them)."""
    import io
    import shutil

    import torch

    from cornac_tpu_torch.data import GraphModality
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, NDCG, Recall
    from cornac_tpu_torch.models import SBPR
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK
    from cornac_tpu_torch.ops.membership import build_membership

    clock = Clock()
    ratings, trust = clock("Epinions-like data (set-up)", lambda: epinions_like(seed + 15))
    split = clock("RatioSplit(0.1) with the user graph's build", lambda: RatioSplit(
        ratings, test_size=0.1, rating_threshold=0.5, exclude_unknowns=True, seed=123,
        user_graph=GraphModality(data=trust), verbose=False))
    train = split.train_set
    probe = SBPR(**SBPR_EPINIONS)
    probe.num_users = train.num_users
    social = clock("the social arrays (social_items)", lambda: probe._prepare_social_data(train))
    membership = build_membership(train.csr_matrix, device=DEV)
    mem_bytes = sum(a.numel() * a.element_size() for a in membership.arrays)
    wpr = (train.num_items + 31) // 32
    log(f"  {train.num_users:,} train users x {train.num_items:,} items, {train.num_ratings:,} "
        f"train ratings, {split.user_graph.matrix.nnz:,} trust edges in the graph over "
        f"{split.user_graph.matrix.shape[0]:,} users; {len(social[0]):,} social positives; "
        f"membership: {membership.kind}, {mem_bytes / 2**20:.1f} MiB (a bitmap would take "
        f"{train.num_users * wpr * 4 / 2**20:.1f} MiB)")
    ck_dir = work / "sbpr_checkpoints"
    shutil.rmtree(ck_dir, ignore_errors=True)

    def fit(epochs, **extra):
        return SBPR(max_iter=epochs, **SBPR_EPINIONS, **extra).fit(train)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    with recording_first_calls([], 5) as first:
        two = clock("SBPR.fit, 2 epochs", lambda: fit(2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = clock(f"SBPR.fit, {SBPR_EPOCHS} epochs", lambda: fit(SBPR_EPOCHS))
    peak = torch.cuda.max_memory_allocated() - held
    clock(f"SBPR.fit, checkpointed, stopped at epoch {SBPR_STOP}", lambda: SBPR(
        max_iter=SBPR_STOP, **SBPR_EPINIONS).enable_checkpointing(ck_dir, every=SBPR_STOP
                                                                   ).fit(train))
    resumed = clock(f"SBPR.fit, resumed to epoch {SBPR_EPOCHS}", lambda: SBPR(
        max_iter=SBPR_EPOCHS, **SBPR_EPINIONS).enable_checkpointing(ck_dir, every=SBPR_STOP
                                                                    ).fit(train))
    metrics = [AUC(), NDCG(k=10), Recall(k=10)]
    # all 40,000 test users over 136,000 items take 26-30 s on the host: the
    # first 4,096, and the others only while all would take 15 s or less
    quality, evaluated, n_test = evaluate_in_budget(
        model, metrics, train, split.test_set, 0.5, clock, "SBPR", head=EVAL_SUBSET_USERS)
    rng = np.random.RandomState(seed + 15)
    users = rng.choice(train.num_users, SERVE_BATCH, replace=False)
    relaxed = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                    lambda: serve_check(model, train, users, "SBPR recommend_batch"))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("SBPR at Epinions")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"SBPR launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")

    # ---- check and measure ----
    with contextlib.redirect_stdout(io.StringIO()):
        again = clock("SBPR.fit, 2 epochs, one a chunk", lambda: fit(2, verbose=True))
    attrs = ("u_factors", "i_factors", "i_biases")
    for name in attrs:
        if not np.array_equal(getattr(two, name), getattr(again, name)):
            raise AssertionError(f"SBPR at Epinions: two seeded fits differ in {name}")
        if not np.array_equal(getattr(model, name), getattr(resumed, name)):
            raise AssertionError(f"SBPR at Epinions: the resumed fit differs in {name}")
        if not np.isfinite(getattr(model, name)).all():
            raise AssertionError(f"SBPR at Epinions: non-finite {name}")
    if len(first) != 5:
        raise AssertionError(f"the first minibatch recorded {len(first)} accumulate_rows calls")
    acc_err, acc_rows = hold_and_time_calls("SBPR's first minibatch", first)
    del first
    n, k = train.num_ratings, SBPR_EPINIONS["k"]
    epoch_s = (clock.seconds[f"SBPR.fit, {SBPR_EPOCHS} epochs"]
               - clock.seconds["SBPR.fit, 2 epochs"]) / (SBPR_EPOCHS - 2)
    bsz = min(1024, n)
    n_batches = -(-n // bsz)
    per_sample, probe_b = sbpr_sample_bytes(train.csr_matrix, membership, k)
    bound_s = n_batches * bsz * per_sample / PEAK_BYTES
    prof = epoch_profile(lambda e: fit(e), n_batches, 1)
    log(f"  SBPR k={k} over {n:,} ratings: {epoch_s:.3f} s per epoch (a {SBPR_EPOCHS}-epoch fit "
        f"minus a 2-epoch fit, over {SBPR_EPOCHS - 2}), {n / epoch_s / 1e6:.3f} M samples/s; "
        f"byte bound {per_sample:.1f} B a sample (8 pair + {probe_b:.1f} probe + 16 social + 4 x "
        f"2 x {k} x 4 rows + 3 x 2 x 4 biases) = {bound_s * 1e3:.3f} ms per epoch, "
        f"{100 * bound_s / epoch_s:.4f}% of it; one epoch profiled: {prof['wall_ms']:.1f} ms "
        f"host clock, device busy {prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
        f"{prof['launches_per_minibatch']:.1f} device events per minibatch; top device ops "
        f"{prof['top']}; peak device memory of the fit {peak / 2**30:.3f} GiB above what the "
        f"run held")
    log(f"  two seeded 2-epoch fits (the second one epoch a chunk) bit for bit; the fit stopped at "
        f"epoch {SBPR_STOP} and resumed to {SBPR_EPOCHS} from its checkpoints equal to the "
        f"uninterrupted one, bit for bit; the first minibatch's five accumulate_rows inputs equal "
        f"to the plain version on the CPU, bit for bit (max |err| {acc_err:.3e})")
    log(f"  ranking_eval over {evaluated:,} of {n_test:,} test users: AUC {quality[0]:.6f}, "
        f"NDCG@10 {quality[1]:.6f}, Recall@10 {quality[2]:.6f} (no band at this size); "
        f"recommend_batch ({SERVE_BATCH} users, "
        f"k={TOPK}, d={k + 1}) equal to the plain version (positions relaxed as near-ties: "
        f"{relaxed}); fused_topk launches {fused}")
    log(f"SBPR at Epinions: ok in {sum(clock.seconds.values()):.1f} s")
    shutil.rmtree(ck_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, fused, model, users, dict(
        epoch_s=epoch_s, bound_s=bound_s, peak=peak, quality=quality, acc=acc_rows,
        max_abs_err=acc_err, setup_s={name: clock.seconds[name] for name in (
            "RatioSplit(0.1) with the user graph's build", "the social arrays (social_items)")},
        split=split, **prof)


def phase_c2pf_office(seed):
    """Phase 15b, C2PF at the Amazon Office widths: examples/c2pf_example.py's
    configuration (k = 100, 80 sweeps and 16 refinement sweeps) on seeded
    data at its counts, the item graph from ``GraphModality.from_feature(k=10,
    symmetric=True)`` over seeded item features. Fits of max_iter 1 and 3 on
    the card held to the same fits on the CPU (rtol ``C2PF_RTOL``); the first
    sweep's nine accumulate_rows inputs held bit for bit to the plain version
    on the CPU; a second seeded fit bit for bit; the whole fit timed (ms a
    sweep beside the byte bound of a sweep, peak device memory); the
    example's Experiment (MAE, RMSE, P@10, R@10, NDCG@10); recommend_batch
    of 8,192 users (with replacement) at k = 100 through fused_topk (d =
    100), every list held to the plain version. Returns (accumulate_rows
    launches, fused_topk launches, the model, the users served, the stats,
    the split among them)."""
    import io

    import torch

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.data import GraphModality
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import MAE, NDCG, RMSE, Precision, Recall
    from cornac_tpu_torch.models import C2PF
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    ratings, feats, item_ids = clock("Amazon-Office-like data (set-up)",
                                     lambda: office_like(seed + 16))
    graph = clock("GraphModality.from_feature(k=10, symmetric=True)",
                  lambda: GraphModality.from_feature(feats, k=10, ids=item_ids, symmetric=True))
    split = clock("RatioSplit(0.2) with the item graph's build", lambda: RatioSplit(
        ratings, test_size=0.2, rating_threshold=1.0, exclude_unknowns=True, seed=123,
        item_graph=graph, verbose=False))
    train = split.train_set
    probe = C2PF(**C2PF_OFFICE)
    probe.num_items = train.num_items
    edges = len(probe._context_edges(train)[0])
    log(f"  {train.num_users:,} train users x {train.num_items:,} items, {train.num_ratings:,} "
        f"train ratings; the item graph: {len(graph.raw_data):,} edges, {edges:,} between train "
        f"items")
    tables = ("Gs", "Gr", "Ls", "Lr", "L2s", "L2r", "L3s", "L3r", "Xi")

    def fit(iters, device=None):
        return C2PF(max_iter=iters, device=device, **C2PF_OFFICE).fit(train)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    with recording_first_calls([], 9) as first:
        one = clock("C2PF.fit, max_iter 1 (2 sweeps)", lambda: fit(1))
    three = clock("C2PF.fit, max_iter 3 (4 sweeps)", lambda: fit(3))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sweeps = C2PF_ITERS + max(1, int(0.2 * C2PF_ITERS))
    model = clock(f"C2PF.fit, max_iter {C2PF_ITERS} ({sweeps} sweeps)", lambda: fit(C2PF_ITERS))
    peak = torch.cuda.max_memory_allocated() - held
    exp = Experiment(split, [C2PF(max_iter=C2PF_ITERS, **C2PF_OFFICE)],
                     [MAE(), RMSE(), Precision(k=10), Recall(k=10), NDCG(k=10)])
    with contextlib.redirect_stdout(io.StringIO()):
        clock("Experiment.run (MAE, RMSE, P@10, R@10, NDCG@10)", exp.run)
    users = np.random.RandomState(seed + 16).choice(train.num_users, SERVE_BATCH, replace=True)
    relaxed = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                    lambda: serve_check(model, train, users, "C2PF recommend_batch"))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("C2PF at Amazon Office")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"C2PF launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")

    # ---- check and measure ----
    again = clock("C2PF.fit, max_iter 3, again", lambda: fit(3))
    for name in tables:
        if not np.array_equal(getattr(three, name), getattr(again, name)):
            raise AssertionError(f"C2PF at Amazon Office: two seeded fits differ in {name}")
        if not np.isfinite(getattr(model, name)).all():
            raise AssertionError(f"C2PF at Amazon Office: non-finite {name}")
    worst = 0.0
    for iters, on_card in ((1, one), (3, three)):
        on_cpu = clock(f"C2PF.fit on the CPU, max_iter {iters}", lambda: fit(iters, "cpu"))
        for name in tables:
            a, b = getattr(on_card, name), getattr(on_cpu, name)
            worst = max(worst, float(np.max(np.abs(a - b) / (C2PF_ATOL + np.abs(b)))))
            if not np.allclose(a, b, rtol=C2PF_RTOL, atol=C2PF_ATOL):
                raise AssertionError(f"C2PF at Amazon Office, max_iter {iters}: {name} on the "
                                     f"card differs from the CPU's beyond rtol {C2PF_RTOL}")
    if len(first) != 9:
        raise AssertionError(f"the first sweep recorded {len(first)} accumulate_rows calls")
    acc_err, acc_rows = hold_and_time_calls("C2PF's first sweep", first)
    del first
    sweep_s = (clock.seconds[f"C2PF.fit, max_iter {C2PF_ITERS} ({sweeps} sweeps)"]
               - clock.seconds["C2PF.fit, max_iter 3 (4 sweeps)"]) / (sweeps - 4)
    nu, ni, nnz, k = train.num_users, train.num_items, train.num_ratings, C2PF_OFFICE["k"]
    # a sweep must read the ratings (two int64 ids, a float32 value) and the
    # context edges (two int64 ids, their two float32 kappa parameters read
    # and written) once, and read and write each table once
    nbytes = 20.0 * nnz + 32.0 * edges + 2 * 4.0 * ((2 * nu + 4 * ni) * k + ni)
    bound_s = nbytes / PEAK_BYTES
    res = exp.result[0].metric_avg_results
    log(f"  C2PF k={k} over {nnz:,} ratings and {edges:,} context edges: {sweep_s * 1e3:.3f} ms "
        f"per sweep (a {sweeps}-sweep fit minus a 4-sweep fit, over {sweeps - 4}); byte bound "
        f"{bound_s * 1e3:.5f} ms per sweep ({nbytes / 1e6:.2f} MB), {100 * bound_s / sweep_s:.3f}% "
        f"of it; peak device memory of the fit {peak / 2**30:.3f} GiB above what the run held")
    log(f"  fits of max_iter 1 and 3 equal to the CPU's within rtol {C2PF_RTOL} / atol "
        f"{C2PF_ATOL} (max |card - cpu| / (atol + |cpu|) {worst:.3e}); two seeded fits bit for "
        f"bit; the first sweep's nine accumulate_rows inputs equal to the plain version on the "
        f"CPU, bit for bit (max |err| {acc_err:.3e})")
    log("  Experiment: " + ", ".join(f"{name} {value:.4f}" for name, value in res.items()))
    log(f"  recommend_batch ({SERVE_BATCH} users with replacement, k={TOPK}, d={k}): equal to the "
        f"plain version (positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}")
    log(f"C2PF at Amazon Office: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, model, users, dict(
        sweep_s=sweep_s, bound_s=bound_s, peak=peak, worst_rel=worst, acc=acc_rows,
        max_abs_err=acc_err, experiment=dict(res), edges=edges,
        graph_s=clock.seconds["GraphModality.from_feature(k=10, symmetric=True)"], split=split)


def phase_modality_bench(bench_data):
    """Phase 12e, in a spawned process: SBPR, VEBPR and C2PF (all three
    variants) on tests/golden_models.py's block data (the user graph, the
    purchases and views, the item graph), each train AUC in the band of the
    JAX package's CPU fits (``tools/bpr_quality_band.py --model``), a second
    seeded fit of each (one epoch a chunk) bit for bit, whose accumulate_rows
    inputs (the first at each shape) are held to the plain version on the
    CPU; then ``Experiment(checkpoint_dir=...)`` with bench.py's BPR, MF and
    VAECF at the bench shape, and the BPR fit stopped at epoch 100 and
    resumed to 200 from its checkpoints, bit for bit against the
    Experiment's."""
    import io
    import shutil

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    from bpr_quality_band import GOLDEN_CONFIGS, golden_auc, golden_split
    from cornac_tpu_torch import Experiment, models
    from cornac_tpu_torch.metrics import AUC, NDCG
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.utils.checkpoint import CheckpointManager

    clock = Clock()
    splits = {kind: golden_split(kind, pdata, peval)
              for kind in ("user_graph", "item_graph", "purchase_view")}

    def make(name, **extra):
        cls, kwargs, _, _ = GOLDEN_CONFIGS[name]
        return getattr(models, cls)(seed=123, **kwargs, **extra)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    fitted = {name: clock(f"{name}.fit", lambda: make(name).fit(splits[kind].train_set))
              for name, (_, _, _, kind) in GOLDEN_CONFIGS.items()}
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: peval.RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    ck_dir = ROOT / "build" / "chip_smoke" / "checkpoints_12e"
    shutil.rmtree(ck_dir, ignore_errors=True)
    bpr_kw = dict(BENCH_BPR)
    exp = Experiment(split, [models.BPR(**bpr_kw), models.MF(k=10, max_iter=20, seed=123),
                             models.VAECF(k=10, n_epochs=100, seed=123)],
                     [AUC(), NDCG(k=10)], checkpoint_dir=str(ck_dir), checkpoint_every=50)
    with contextlib.redirect_stdout(io.StringIO()):
        clock("Experiment(checkpoint_dir=...).run (BPR, MF, VAECF)", exp.run)
    stop_dir = ck_dir / "interrupted"
    clock("BPR.fit, checkpointed, stopped at epoch 100", lambda: models.BPR(
        **{**bpr_kw, "max_iter": 100}).enable_checkpointing(stop_dir, every=50).fit(split.train_set))
    resumed = clock("BPR.fit, resumed to epoch 200", lambda: models.BPR(
        **bpr_kw).enable_checkpointing(stop_dir, every=50).fit(split.train_set))
    launches = ACCUMULATE_ROWS.launches
    clock.report("the modality layer's models at the bench shape")
    if launches <= 0:
        raise AssertionError("phase 12e did not launch accumulate_rows")

    # ---- check what came out ----
    fit_s, acc_err, recorded = {}, 0.0, 0
    for name, (cls, _, _, kind) in GOLDEN_CONFIGS.items():
        train, model = splits[kind].train_set, fitted[name]
        fit_s[name] = clock.seconds[f"{name}.fit"]
        auc = golden_auc(model, train)
        lo, hi, _, spread = band(name, "AUC")
        inside = lo <= auc <= hi
        log(f"  {name}: train AUC {auc:.6f}, band [{lo:.6f}, {hi:.6f}] "
            f"({'one deterministic JAX fit +/- 1e-3' if spread is None else '5 JAX seeds'}) "
            f"{'inside' if inside else 'OUTSIDE'}; fit {fit_s[name]:.3f} s (host clock)")
        if not inside:
            raise AssertionError(f"{name}: outside its quality band")
        verbose = {} if cls == "C2PF" else {"verbose": True}
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = make(name, **verbose).fit(train)
        attrs = (("Gs", "Gr", "Ls", "Lr", "L2s", "L2r", "L3s", "L3r", "Xi") if cls == "C2PF"
                 else ("u_factors", "i_factors", "i_biases"))
        for attr in attrs:
            if not same_bits(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    steps = {m.name: CheckpointManager(ck_dir / m.name).all_steps() for m in exp.models}
    if steps != {"BPR": [100, 150, 200], "MF": [20], "VAECF": [50, 100]}:
        raise AssertionError(f"the Experiment's checkpoints: {steps}")
    for attr in ("u_factors", "i_factors", "i_biases"):
        if not same_bits(getattr(exp.models[0], attr), getattr(resumed, attr)):
            raise AssertionError(f"BPR: the resumed fit differs from the Experiment's in {attr}")
    shutil.rmtree(ck_dir, ignore_errors=True)
    log(f"  every model: two seeded fits identical, bit for bit; accumulate_rows on the trainers' "
        f"own inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit (max "
        f"|err| {acc_err:.3e}); Experiment(checkpoint_dir=...) checkpoints {steps}; BPR stopped at "
        f"epoch 100 and resumed to 200 equal to the Experiment's BPR, bit for bit; "
        + ", ".join(f"{r.model_name} AUC {r.metric_avg_results['AUC']:.4f}" for r in exp.result)
        + f"; accumulate_rows launches {launches}")
    log(f"the modality layer's models at the bench shape: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


# ---------------------------------------------------------------------------
# the next-item family at published counts: SASRec with
# examples/sasrec_example.py's settings on sessions seeded at Diginetica's
# counts (DIGI_*, SR-GNN's preprocessing: 982,961 clicks, 43,097 items, 60,858
# test sessions, mean session length 5.12). The data are seeded, not the
# files.
SASREC_DIGINETICA = dict(embedding_dim=64, n_layers=2, n_heads=1, max_len=50, batch_size=128,
                         learning_rate=0.001, seed=123)
# the example's 10 epochs cut to 1 over every train session (earlier runs
# fitted 1 and 2 and differenced them): the whole run keeps well inside its
# 1,200 s; the subset's fits run 2 and stop at 1
SASREC_EPOCHS, SASREC_STOP = 2, 1
SASREC_TIMED_FROM = 100  # the steps after the first 100 are timed
SASREC_PROFILED_STEPS = 5
SASREC_SUBSET_SESSIONS = 3_200  # the subset's train sessions (about 100 steps an epoch)
# the timed fit's train sessions: the first half of them (some 2,100 steps),
# cut from all 131,127 in PR 18 to pay for the mesh checks' time
SASREC_FIT_SESSIONS = 65_600
SEQ_BLOCK = 100  # items a block of the transitions holds


def diginetica_like(seed):
    """USIT tuples at the Diginetica counts: round(clicks / mean length)
    sessions, each its own user, of at least 2 clicks, lengths 2 + Poisson
    adjusted to sum to the clicks exactly; a session's first click and each
    jump draw an item Zipf-like (1/rank^0.8, the ranks scattered over the
    ids); otherwise, with probability 0.8, the next item follows in the same
    block of ``SEQ_BLOCK`` items (``benchmarks/head_to_head_seq.py``'s
    transitions); every item is clicked at least once."""
    rng = np.random.RandomState(seed)
    n_sessions = int(round(DIGI_CLICKS / DIGI_MEAN_LEN))
    lengths = 2 + rng.poisson(DIGI_MEAN_LEN - 2, n_sessions)
    while lengths.sum() != DIGI_CLICKS:
        diff = DIGI_CLICKS - int(lengths.sum())
        pick = rng.randint(n_sessions, size=abs(diff))
        if diff > 0:
            np.add.at(lengths, pick, 1)
        else:
            np.subtract.at(lengths, pick, 1)
            lengths = np.maximum(lengths, 2)
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    p = 1.0 / np.arange(1, DIGI_ITEMS + 1) ** 0.8
    perm = rng.permutation(DIGI_ITEMS)
    zipf = perm[rng.choice(DIGI_ITEMS, DIGI_CLICKS, p=p / p.sum())]
    pos = np.arange(DIGI_CLICKS)
    jump = rng.rand(DIGI_CLICKS) >= 0.8
    jump[starts] = True
    last = np.maximum.accumulate(np.where(jump, pos, 0))
    anchor = zipf[last]
    block0 = (anchor // SEQ_BLOCK) * SEQ_BLOCK
    size = np.minimum(SEQ_BLOCK, DIGI_ITEMS - block0)
    items = block0 + (anchor - block0 + pos - last) % size
    missing = np.setdiff1d(np.arange(DIGI_ITEMS), items)
    items[rng.choice(DIGI_CLICKS, missing.size, replace=False)] = missing
    sess = np.repeat(np.arange(n_sessions), lengths)
    return [(f"u{s}", f"s{s}", f"i{i}", t)
            for t, (s, i) in enumerate(zip(sess.tolist(), items.tolist()))], lengths


@contextlib.contextmanager
def timed_epoch_ends(stamps):
    """While open, the card is synchronised and the host clock appended to
    ``stamps`` where an epoch of a checkpointed fit starts (its generator's
    draw, ``utils.checkpoint.epoch_generator``) and where its checkpoint is
    saved: between them lies one epoch on the card."""
    import torch

    from cornac_tpu_torch.utils import checkpoint

    real_gen, real_save = checkpoint.epoch_generator, checkpoint.CheckpointManager.save

    def stamp():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def epoch_generator(*args, **kwargs):
        stamp()
        return real_gen(*args, **kwargs)

    def save(self, *args, **kwargs):
        stamp()
        return real_save(self, *args, **kwargs)

    checkpoint.epoch_generator, checkpoint.CheckpointManager.save = epoch_generator, save
    try:
        yield stamps
    finally:
        checkpoint.epoch_generator, checkpoint.CheckpointManager.save = real_gen, real_save


def sasrec_step_bound(bsz, L, d, n_blocks, n_neg, vocab):
    """(FLOPs, bytes) of one SASRec training step as the port computes it:
    per block the four d x d projections and the two-layer feed-forward
    (12 B L d^2) and the attention's two (L x L) products (4 B L^2 d),
    the loss's in-batch and sampled score blocks (2 B L (B + N) d) and the
    positives (2 B L d), three times over for the backward; the bytes are
    those of Adam's dense update (the parameters, their gradients and two
    moments read, the parameters and the moments written, 7 x 4 bytes a
    parameter) and the batch's ids and mask."""
    BL = bsz * L
    fwd = n_blocks * (12 * BL * d * d + 4 * bsz * L * L * d) + 2 * BL * (bsz + n_neg) * d \
        + 2 * BL * d
    n_params = (vocab + 1) * d + L * d + 2 * d + n_blocks * (6 * d * d + 6 * d + d)
    return 3.0 * fwd, 7 * 4.0 * n_params + BL * (8 + 8 + 4)


def phase_sasrec_diginetica(seed, work, mesh):
    """Phase 16, SASRec at the Diginetica counts (``diginetica_like``): the
    last 60,858 sessions test, through ``NextItemEvaluation.from_splits(
    fmt="USIT", exclude_unknowns=True, mode="last")``. A fit of 1 epoch
    over the first ``SASREC_FIT_SESSIONS`` train sessions (half of them,
    the whole item table): ms a step from CUDA events over the steps
    after the first ``SASREC_TIMED_FROM``, the steady epoch and training
    sequences per second from it, beside the bound of a step, and its last
    ``SASREC_PROFILED_STEPS`` steps profiled (device events a step, busy
    share); the first step's three accumulate_rows inputs are held bit for
    bit to the plain version on the CPU and timed beside ``index_add_``;
    peak device memory of the fit; the NextItemEvaluation metrics (MRR,
    HitRatio@20, NDCG@20) over the test sessions and their seconds; 64
    histories scored on the card held to a float64 scoring of the same
    parameters on the CPU. On the first 3,200 train sessions at the same
    widths (the item table of all 43,097 items, about 100 steps an epoch):
    a 2-epoch fit's epoch-1 checkpoint must equal a second seeded fit of 1
    epoch bit for bit, and that fit, resumed to 2 from its checkpoint, the
    uninterrupted one. One ``SASRec(mesh=...)`` fit on the main process's
    mesh beside a plain one, on the first ``MESH_PAIR_STEPS`` steps'
    sessions, held bit for bit (``full_width_pair``). Returns
    (accumulate_rows launches, the stats, the NextItemEvaluation, which
    phase 16b reuses)."""
    import shutil

    import torch

    from cornac_tpu_torch.eval_methods import NextItemEvaluation
    from cornac_tpu_torch.metrics import MRR, NDCG, HitRatio
    from cornac_tpu_torch.models import SASRec
    from cornac_tpu_torch.models import sasrec as sasrec_mod
    from cornac_tpu_torch.models.seq_utils import build_session_examples, sessions_per_batch
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.utils.checkpoint import CheckpointManager

    clock = Clock()
    rows, lengths = clock("Diginetica-like sessions (set-up)", lambda: diginetica_like(seed + 16))
    n_sessions = len(lengths)
    cut = f"s{n_sessions - DIGI_TEST}"
    first_test = next(k for k, r in enumerate(rows) if r[1] == cut)
    ev = clock("NextItemEvaluation.from_splits (USIT)", lambda: NextItemEvaluation.from_splits(
        train_data=rows[:first_test], test_data=rows[first_test:], fmt="USIT",
        exclude_unknowns=True, seed=123, mode="last"))
    del rows
    train, test = ev.train_set, ev.test_set
    fit_set = clock(f"the first {SASREC_FIT_SESSIONS:,} train sessions (set-up)",
                    lambda: session_subset(train, SASREC_FIT_SESSIONS, train.iid_map))
    _, _, _, mask = build_session_examples(fit_set, SASREC_DIGINETICA["max_len"])
    n_train = mask.shape[0]
    bsz = sessions_per_batch(SASREC_DIGINETICA["batch_size"], mask, n_train)
    steps = -(-n_train // bsz)
    log(f"  {n_sessions:,} sessions ({DIGI_CLICKS:,} clicks, lengths {int(lengths.min())}-"
        f"{int(lengths.max())}, mean {lengths.mean():.3f}); train {train.num_sessions:,} "
        f"sessions over {train.num_items:,} items, the fit on the first {n_train:,}; test "
        f"{test.num_sessions:,} sessions; {bsz} sessions a step "
        f"({SASREC_DIGINETICA['batch_size']} events), {steps:,} steps an epoch")
    ck_dir = work / "sasrec_checkpoints"
    shutil.rmtree(ck_dir, ignore_errors=True)

    def fit(epochs, data, where=None, **extra):
        model = SASRec(n_epochs=epochs, **SASREC_DIGINETICA, **extra)
        if where is not None:
            model.enable_checkpointing(ck_dir / where, every=1, max_to_keep=SASREC_EPOCHS)
        return model.fit(data)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    last = steps - SASREC_PROFILED_STEPS
    with recording_first_calls([], 3) as first, timed_calls(
            SASRec, "loss_fn", SASREC_TIMED_FROM, last, {}, profiled=SASREC_PROFILED_STEPS,
            at_start=True) as timed:
        model = clock(f"SASRec.fit, {SASREC_STOP} epoch", lambda: fit(SASREC_STOP, fit_set))
    peak = torch.cuda.max_memory_allocated() - held
    metrics = [MRR(), HitRatio(k=20), NDCG(k=20)]
    result = clock("NextItemEvaluation over the test sessions", lambda: ev.eval(
        model, train, test, True, metrics, mode="last"))
    launches = ACCUMULATE_ROWS.launches
    clock.report("SASRec at Diginetica")
    if launches <= 0:
        raise AssertionError("SASRec did not launch accumulate_rows")

    # ---- check and measure ----
    if timed["count"] != SASREC_STOP * steps:
        raise AssertionError(f"SASRec took {timed['count']} steps, not {SASREC_STOP * steps}")
    step_ms = timed["events"][0].elapsed_time(timed["events"][1]) / (last - SASREC_TIMED_FROM)
    for name, p in model.params.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"SASRec at Diginetica: non-finite {name}")
    if len(first) != 3:
        raise AssertionError(f"the first step recorded {len(first)} accumulate_rows calls")
    acc_err, acc_rows = hold_and_time_calls("SASRec's first step", first)
    del first
    vals = result.metric_avg_results
    if not all(np.isfinite(vals[m.name]) and 0.0 < vals[m.name] <= 1.0 for m in metrics):
        raise AssertionError(f"SASRec at Diginetica: metrics {dict(vals)}")

    # 64 test histories: the card's scores against a float64 scoring of the
    # same parameters on the CPU
    hist = [[int(x) for x in items[:-1]] for _, _, [items] in
            itertools.islice(test.si_iter(batch_size=1), 64)]
    got = model.score_history_batch(np.zeros(len(hist), int), hist)
    cpu = copy.deepcopy(model.params).to("cpu").double()
    seq = torch.as_tensor(sasrec_mod.pad_histories(hist, model.max_len, model.num_items)[0],
                          dtype=torch.int64)
    with torch.no_grad():
        want = sasrec_mod._sasrec_scores(cpu, seq, model.num_items, model.num_heads,
                                         model.num_items).numpy()
    score_err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"SASRec at Diginetica: scores differ from float64 by {score_err}")

    # the steady epoch: every step at the timed steps' mean
    epoch_s = step_ms * steps / 1e3
    flops, nbytes = sasrec_step_bound(bsz, SASREC_DIGINETICA["max_len"],
                                      SASREC_DIGINETICA["embedding_dim"],
                                      SASREC_DIGINETICA["n_layers"], 2048, train.num_items)
    step_bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"

    # the first 3,200 train sessions at the same widths (the whole item map)
    sub = session_subset(train, SASREC_SUBSET_SESSIONS, train.iid_map)
    sub_mask = build_session_examples(sub, SASREC_DIGINETICA["max_len"])[3]
    sub_steps = -(-sub_mask.shape[0] // sessions_per_batch(
        SASREC_DIGINETICA["batch_size"], sub_mask, sub_mask.shape[0]))
    prof = dict(wall_ms=timed["wall_ms"], busy_ms=timed["busy_ms"],
                share=timed["busy_ms"] / timed["wall_ms"],
                launches_per_minibatch=timed["device_events"], top=timed["top"])
    straight = clock(f"SASRec.fit, {SASREC_EPOCHS} epochs, the subset",
                     lambda: fit(SASREC_EPOCHS, sub, "straight"))
    stopped = clock(f"SASRec.fit, the subset, stopped at epoch {SASREC_STOP}",
                    lambda: fit(SASREC_STOP, sub, "stopped"))
    at_one = CheckpointManager(ck_dir / "straight").restore(SASREC_STOP)
    for name, p in stopped.params.named_parameters():
        if not torch.equal(p.cpu(), at_one[f"resident/{name}"]):
            raise AssertionError(f"SASRec at Diginetica widths: two seeded fits differ at epoch "
                                 f"{SASREC_STOP} in {name}")
    resumed = clock(f"SASRec.fit, the subset, resumed to epoch {SASREC_EPOCHS}",
                    lambda: fit(SASREC_EPOCHS, sub, "stopped"))
    for (name, p), q in zip(straight.params.named_parameters(), resumed.params.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"SASRec at Diginetica widths: the resumed fit differs in {name}")

    log(f"  SASRec d={SASREC_DIGINETICA['embedding_dim']}, {SASREC_DIGINETICA['n_layers']} "
        f"blocks, max_len {SASREC_DIGINETICA['max_len']} over {n_train:,} train sequences: "
        f"{step_ms:.3f} ms a step (CUDA events over steps {SASREC_TIMED_FROM + 1}-{last}), "
        f"{epoch_s:.3f} s a steady epoch at that rate ({steps:,} steps; the {SASREC_STOP}-epoch "
        f"fit {clock.seconds[f'SASRec.fit, {SASREC_STOP} epoch']:.3f} s host clock, its set-up "
        f"included), {n_train / epoch_s:,.0f} training sequences/s; bound of a step "
        f"{flops / 1e9:.3f} GFLOP and {nbytes / 1e6:.1f} MB = {1e3 * step_bound_s:.4f} ms "
        f"({bound_by}), {steps * step_bound_s:.3f} s an epoch, "
        f"{100 * steps * step_bound_s / epoch_s:.3f}% of it; its last {SASREC_PROFILED_STEPS} "
        f"steps profiled: {prof['wall_ms']:.1f} ms host clock, device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
        f"{prof['launches_per_minibatch']:.1f} device events a step; top device ops "
        f"{prof['top']}; peak device memory of the fit {peak / 2**30:.3f} GiB above what the run "
        f"held")
    log(f"  on the {sub_mask.shape[0]:,} sequences ({sub_steps} steps an epoch), two seeded fits "
        f"bit for bit at epoch {SASREC_STOP} (the {SASREC_EPOCHS}-epoch fit's checkpoint), and "
        f"the fit stopped at epoch "
        f"{SASREC_STOP} and resumed to {SASREC_EPOCHS} from its checkpoints equal to the "
        f"uninterrupted one, bit for bit; the first step's three accumulate_rows inputs equal to "
        f"the plain version on the CPU, bit for bit (max |err| {acc_err:.3e}); 64 histories' "
        f"scores within {score_err:.3e} of float64 on the CPU")
    eval_s = clock.seconds["NextItemEvaluation over the test sessions"]
    log(f"  NextItemEvaluation (mode last, {test.num_sessions:,} test sessions): MRR "
        f"{vals['MRR']:.6f}, HitRatio@20 {vals['HitRatio@20']:.6f}, NDCG@20 {vals['NDCG@20']:.6f} "
        f"in {eval_s:.3f} s; accumulate_rows launches {launches}")
    del straight, stopped, resumed
    pair = full_width_pair("SASRec", lambda **kw: SASRec(n_epochs=1, **SASREC_DIGINETICA, **kw),
                           session_subset(train, MESH_PAIR_STEPS * bsz, train.iid_map), mesh)
    log(f"SASRec at Diginetica: ok in {sum(clock.seconds.values()):.1f} s")
    shutil.rmtree(ck_dir, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    return launches + pair[0], dict(mesh_pairs={"SASRec": pair[1:]}, epoch_s=epoch_s,
                          seq_per_s=n_train / epoch_s, step_ms=step_ms,
                          step_bound_ms=1e3 * step_bound_s,
                          bound_by=bound_by, steps=steps, peak=peak,
                          metrics={m.name: vals[m.name] for m in metrics}, eval_s=eval_s,
                          acc=acc_rows, max_abs_err=acc_err, **prof), ev


def session_subset(ds, n, iid_map):
    """The first ``n`` sessions of ``ds`` (a SequentialDataset) as one
    built over the global item map ``iid_map`` (the whole item table, as
    the full data's), each session its own user."""
    from cornac_tpu_torch.data import SequentialDataset

    rows = [(f"u{s}", f"s{s}", ds.item_ids[int(ds.uir_tuple[1][k])], t)
            for t, (s, k) in enumerate((s, k) for s, idx in itertools.islice(
                ds.sessions.items(), n) for k in idx)]
    return SequentialDataset.build(rows, fmt="USIT", global_iid_map=copy.copy(iid_map), seed=123)


# the two models of examples/transformer_rec_diginetica.py (phase 16b), the
# class defaults otherwise (loss ce, 2,048 sampled negatives, alpha 0.5,
# dropout 0.2, lr 0.001); the example's 10 epochs cut to a fit of 2 on the
# first 6,400 train sessions (50 steps of 128), evaluated on the first
# 2,048 test sessions, to keep the whole run inside its 1,200 s
TRANSFORMER_DIGINETICA = dict(embedding_dim=64, n_layers=2, n_heads=2, max_len=50,
                              batch_size=128, seed=123)
TRANSFORMER_MODELS = {"BERT4Rec": ("BERT4Rec", dict(mask_prob=0.2)),
                      "TransformerRec gpt2/clm": ("TransformerRec",
                                                  dict(backbone="gpt2", objective="clm"))}
TRANSFORMER_TRAIN_SESSIONS, TRANSFORMER_TEST_SESSIONS = 6_400, 2_048
TRANSFORMER_PROFILED_SESSIONS = 640  # the profiled epoch's sessions (5 steps)
TRANSFORMER_EPOCHS = 2


def transformer_step_bound(bsz, L, d, n_blocks, n_neg, vocab):
    """(FLOPs, bytes) of one TransformerRec training step as the port
    computes it (mlm and clm alike: the loss's score blocks cover every
    position): per block the four d x d projections and the 4 d wide
    feed-forward (24 B L d^2) and the attention's two (L x L) products
    (4 B L^2 d), the loss's in-batch and sampled score blocks
    (2 B L (B + N) d) and the positives (2 B L d), three times over for the
    backward; the bytes are Adam's dense update (7 x 4 bytes a parameter)
    and the batch's ids and mask."""
    BL = bsz * L
    fwd = n_blocks * (24 * BL * d * d + 4 * bsz * L * L * d) + 2 * BL * (bsz + n_neg) * d \
        + 2 * BL * d
    n_params = (vocab + 2) * (d + 1) + L * d + 2 * d + n_blocks * (12 * d * d + 9 * d)
    return 3.0 * fwd, 7 * 4.0 * n_params + BL * (8 + 8 + 4)


def phase_transformer_diginetica(ev, mesh):
    """Phase 16b, TransformerRec at the Diginetica widths on phase 16's
    NextItemEvaluation ``ev``: BERT4Rec and a gpt2/clm TransformerRec at
    ``examples/transformer_rec_diginetica.py``'s settings, trained on the
    first 6,400 train sessions over the whole item table (after a warm-up
    fit of two steps: a fit of 2 epochs checkpointed every epoch, seconds
    per epoch from its last, training sequences/s, ms a step beside
    ``transformer_step_bound``), peak device
    memory, ``NextItemEvaluation.eval`` over the first 2,048 test sessions
    (MRR, HitRatio@20, NDCG@20), 64 test histories scored on the card held
    to a float64 scoring of the same parameters on the CPU, the first
    step's five accumulate_rows inputs held bit for bit to the plain
    version on the CPU and timed beside ``index_add_``, and one epoch over
    the first 640 sessions profiled (a fit of 1 epoch minus a fit of
    none: device events a step, busy share). Each model fitted with the
    main process's mesh beside a plain fit on the first 256 sessions (two
    steps), held bit for bit (``full_width_pair``). Returns
    (accumulate_rows launches, {model: stats})."""
    import shutil

    import torch

    from cornac_tpu_torch import models
    from cornac_tpu_torch.metrics import MRR, NDCG, HitRatio
    from cornac_tpu_torch.models import transformer_rec as tr_mod
    from cornac_tpu_torch.models.seq_utils import pad_histories
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    clock = Clock()
    train_full, test_full = ev.train_set, ev.test_set
    train = clock(f"the first {TRANSFORMER_TRAIN_SESSIONS:,} train sessions (set-up)",
                  lambda: session_subset(train_full, TRANSFORMER_TRAIN_SESSIONS,
                                         train_full.iid_map))
    test = clock(f"the first {TRANSFORMER_TEST_SESSIONS:,} test sessions (set-up)",
                 lambda: session_subset(test_full, TRANSFORMER_TEST_SESSIONS,
                                        train_full.iid_map))
    few = session_subset(train_full, 256, train_full.iid_map)
    profiled = session_subset(train_full, TRANSFORMER_PROFILED_SESSIONS, train_full.iid_map)

    def make(name, epochs, **extra):
        cls, kw = TRANSFORMER_MODELS[name]
        return getattr(models, cls)(n_epochs=epochs, **TRANSFORMER_DIGINETICA, **kw, **extra)

    ck_dir = ROOT / "build" / "chip_smoke" / "transformer_checkpoints"

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    fits, firsts, results, peaks, stamps = {}, {}, {}, {}, {}
    metrics = [MRR(), HitRatio(k=20), NDCG(k=20)]
    for name in TRANSFORMER_MODELS:
        with recording_first_calls([], 5) as first:
            # two steps at the same shapes: the process's first use of them
            clock(f"{name}.fit, 1 epoch of 256 sessions (warm-up)",
                  lambda: make(name, 1).fit(few))
        firsts[name] = first
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        shutil.rmtree(ck_dir, ignore_errors=True)
        with timed_epoch_ends(stamps.setdefault(name, [])):
            fits[name] = clock(f"{name}.fit, {TRANSFORMER_EPOCHS} epochs", lambda: make(
                name, TRANSFORMER_EPOCHS).enable_checkpointing(ck_dir, every=1).fit(train))
        peaks[name] = torch.cuda.max_memory_allocated() - held
        results[name] = clock(f"{name}: NextItemEvaluation", lambda: ev.eval(
            fits[name], train, test, True, metrics, mode="last"))
    launches = ACCUMULATE_ROWS.launches
    if launches <= 0:
        raise AssertionError("TransformerRec did not launch accumulate_rows")

    # ---- check and measure ----
    rows_bsz = fits["BERT4Rec"].training_rows(train)
    n_train, bsz = rows_bsz[0].shape[0], rows_bsz[3]
    steps = n_train // bsz
    prof_steps = fits["BERT4Rec"].training_rows(profiled)[0].shape[0] // bsz
    hist = [[int(x) for x in items[:-1]] for _, _, [items] in
            itertools.islice(test.si_iter(batch_size=1), 64)]
    stats = {}
    for name, model in fits.items():
        for key, p in model.params.named_parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"{name} at Diginetica: non-finite {key}")
        vals = results[name].metric_avg_results
        if not all(np.isfinite(vals[m.name]) and 0.0 < vals[m.name] <= 1.0 for m in metrics):
            raise AssertionError(f"{name} at Diginetica: metrics {dict(vals)}")
        if len(firsts[name]) != 5:
            raise AssertionError(f"{name}'s first step recorded {len(firsts[name])} "
                                 f"accumulate_rows calls")
        acc_err, acc_rows = clock(f"{name}: the first step's accumulate_rows held and timed",
                                  lambda: hold_and_time_calls(f"{name}'s first step",
                                                              firsts[name]))

        # 64 test histories: the card's scores against a float64 scoring of
        # the same parameters on the CPU
        def scores():
            got = model.score_history_batch(np.zeros(len(hist), int), hist)
            cpu = copy.deepcopy(model.params).to("cpu").double()
            extra = [model.num_items + 1] if model.objective != "clm" else []
            seq = torch.as_tensor(pad_histories([h + extra for h in hist], model.max_len,
                                                model.num_items)[0], dtype=torch.int64)
            with torch.no_grad():
                want = tr_mod._encode_scores(cpu, seq, model.num_items, model.num_heads,
                                             model.backbone == "gpt2", model.num_items).numpy()
            return got, want

        got, want = clock(f"{name}: 64 histories on the card and in float64 on the CPU", scores)
        score_err = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{name} at Diginetica: scores differ from float64 by "
                                 f"{score_err}")
        prof = clock(f"{name}: one epoch over {TRANSFORMER_PROFILED_SESSIONS:,} sessions profiled",
                     lambda: epoch_profile(lambda e: make(name, e).fit(profiled), prof_steps, 1))
        # the last epoch: from its generator's draw to its checkpoint
        if len(stamps[name]) != 2 * TRANSFORMER_EPOCHS:
            raise AssertionError(f"{name}: {len(stamps[name])} epoch stamps")
        epoch_s = stamps[name][-1] - stamps[name][-2]
        flops, nbytes = transformer_step_bound(bsz, model.max_len, model.embedding_dim,
                                               model.num_blocks, model.n_sample, model.num_items)
        bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        eval_s = clock.seconds[f"{name}: NextItemEvaluation"]
        stats[name] = dict(epoch_s=epoch_s, seq_per_s=n_train / epoch_s,
                           step_ms=1e3 * epoch_s / steps, step_bound_ms=1e3 * bound_s,
                           bound_by=bound_by, peak=peaks[name], eval_s=eval_s,
                           metrics={m.name: vals[m.name] for m in metrics}, acc=acc_rows,
                           max_abs_err=acc_err, score_err=score_err, **prof)
        log(f"  {name} d={model.embedding_dim}, {model.num_blocks} blocks of {model.num_heads} "
            f"heads, max_len {model.max_len}, over {n_train:,} train sequences ({steps} steps of "
            f"{bsz}): {epoch_s:.3f} s per epoch (the fit's last, from its start to its "
            f"checkpoint), {n_train / epoch_s:,.0f} training sequences/s, "
            f"{1e3 * epoch_s / steps:.3f} ms a step; bound of a step {flops / 1e9:.3f} GFLOP and "
            f"{nbytes / 1e6:.1f} MB = {1e3 * bound_s:.4f} ms ({bound_by}), "
            f"{100 * bound_s * steps / epoch_s:.3f}% of it; one epoch of {prof_steps} steps "
            f"profiled: {prof['wall_ms']:.1f} ms host clock, device busy {prof['busy_ms']:.3f} ms "
            f"({100 * prof['share']:.2f}%), {prof['launches_per_minibatch']:.1f} device events a "
            f"step; top device ops {prof['top']}; peak device memory of the "
            f"{TRANSFORMER_EPOCHS}-epoch fit {peaks[name] / 2**30:.3f} GiB above what the run held")
        log(f"  {name}: NextItemEvaluation (mode last, {test.num_sessions:,} test sessions): MRR "
            f"{vals['MRR']:.6f}, HitRatio@20 {vals['HitRatio@20']:.6f}, NDCG@20 "
            f"{vals['NDCG@20']:.6f} in {eval_s:.3f} s; the first step's five accumulate_rows "
            f"inputs equal to the plain version on the CPU, bit for bit (max |err| "
            f"{acc_err:.3e}); 64 histories' scores within {score_err:.3e} of float64 on the CPU")
    clock.report("TransformerRec at Diginetica")
    log(f"  accumulate_rows launches {launches}")
    for name in TRANSFORMER_MODELS:
        pair = full_width_pair(name, functools.partial(make, name, 1), few, mesh)
        launches += pair[0]
        stats[name]["mesh_pair"] = pair[1:]
    log(f"TransformerRec at Diginetica: ok in {sum(clock.seconds.values()):.1f} s")
    shutil.rmtree(ck_dir, ignore_errors=True)
    del fits, firsts
    torch.cuda.empty_cache()
    return launches, stats


# examples/tiger_example.py's settings (phase 16c), the class defaults
# otherwise (latent 32, hidden (512, 256, 128), 200 RQ-VAE epochs of 1,024,
# 6 heads of 64, 4 + 4 layers, max_len 20, batch 256, lr 0.001, weight decay
# 1e-4, the constant schedule, beam scoring with 20 beams); the example's 20
# seq2seq epochs cut to one fit of 1, whose steps after the first
# TIGER_TIMED_FROM are timed as the steady state
TIGER_EXAMPLE = dict(tokenizer="rqvae", rqvae_num_levels=3, rqvae_codebook_size=256,
                     d_model=128, d_ff=1024, seed=123)
TIGER_EPOCHS = 1  # the example's 20, cut for the run's time
# the mesh/plain pair's cut: some 1,000 examples (four steps of 256), the
# RQ-VAE's 200 epochs cut to 2 (it is single-program on a mesh too)
TIGER_MESH_USERS, TIGER_MESH_RQVAE_EPOCHS = 10, 2
TIGER_TIMED_FROM = 40  # seq2seq steps of warm-up before the steps timed
TIGER_FEATURES = 512  # TfidfVectorizer(max_features=512) over the plots
TIGER_PROFILE_STEPS = 4  # seq2seq steps profiled (some 6,600 device events)
TIGER_TRAIN_USERS = 472  # the seq2seq trains on the first half of the users' sessions


def tiger_step_bound(B, S, T, d, a, ff, n_enc, n_dec, level_sizes, n_params):
    """(FLOPs, bytes) of one TIGER seq2seq training step as the port
    computes it: per encoder layer the four projections (8 B S d a), the
    attention (4 B S^2 a) and the feed-forward (4 B S d ff); per decoder
    layer (T positions) the self-attention's (8 B T d a + 4 B T^2 a), the
    cross attention's queries and output (4 B T d a), its keys and values
    over the S encoder positions (4 B S d a) and products (4 B T S a), the
    feed-forward (4 B T d ff); the heads (2 B d x each level's size); three
    times over for the backward. The bytes are AdamW's dense update (7 x 4
    bytes a parameter) and the batch's tokens."""
    enc = n_enc * (8 * B * S * d * a + 4 * B * S * S * a + 4 * B * S * d * ff)
    dec = n_dec * (8 * B * T * d * a + 4 * B * T * T * a + 4 * B * T * d * a
                   + 4 * B * S * d * a + 4 * B * T * S * a + 4 * B * T * d * ff)
    heads = 2 * B * d * sum(level_sizes)
    return 3.0 * (enc + dec + heads), 7 * 4.0 * n_params + 8.0 * B * (S + T)


@contextlib.contextmanager
def timed_epochs(seconds):
    """While open, every call of ``models.tiger._train_epoch`` (an RQ-VAE
    or a seq2seq epoch) appends its seconds to ``seconds``, the card
    synchronised at both ends."""
    import torch

    from cornac_tpu_torch.models import tiger as tiger_mod

    real = tiger_mod._train_epoch

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out

    with swapped(tiger_mod, "_train_epoch", timed):
        yield seconds


def phase_tiger_ml100k(bench_data, mesh):
    """Phase 16c, TIGER at ``examples/tiger_example.py``'s settings:
    ``NextItemEvaluation.leave_last_out(seed=123)`` of ``make_ml100k_like(7)``
    with the generation order as timestamps and seeded TF-IDF-like item
    features (``seq_bench_data.tfidf_like``: 1,682 x 512, nonnegative,
    sparse, L2-normalised; the plots are not in the repository); the
    seq2seq trains on the first 472 users' sessions (the whole catalog).
    One fit of ``TIGER_EPOCHS`` seq2seq epochs after the RQ-VAE's 200, each
    epoch timed on the synchronised card (the last is reported) and the
    seq2seq steps after the first ``TIGER_TIMED_FROM`` with CUDA events: the
    RQ-VAE's seconds, the dead codes restarted, the collision level's size,
    seconds per seq2seq epoch and ms a step (the steps timed) beside
    ``tiger_step_bound``; peak device
    memory; the beam evaluation (HitRatio@10, NDCG@10) and its seconds; 64
    histories' beam scores on the card held to the same scoring on the CPU
    (the beams as sets, a swap allowed only at a near-tie of the last kept
    score) and 4 histories' exact scores over the first 256 items; the
    first RQ-VAE step's three and the first seq2seq step's two
    accumulate_rows inputs held bit for bit to the plain version on the CPU
    and timed beside ``index_add_``; 4 seq2seq steps profiled (device
    events a step, busy share). One ``TIGER(mesh=...)`` fit on the main
    process's mesh beside a plain one, at the example's widths on the first
    ``TIGER_MESH_USERS`` users' sessions (a few seq2seq steps) with the
    RQ-VAE's epochs cut to ``TIGER_MESH_RQVAE_EPOCHS``, held bit for bit
    (``full_width_pair``). Returns (accumulate_rows launches, stats)."""
    import torch

    from cornac_tpu_torch.data import FeatureModality
    from cornac_tpu_torch.eval_methods import NextItemEvaluation
    from cornac_tpu_torch.metrics import NDCG, HitRatio
    from cornac_tpu_torch.models import TIGER
    from cornac_tpu_torch.models import tiger as tiger_mod
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.optim import step
    from seq_bench_data import tfidf_like

    clock = Clock()
    triples = bench_data()
    items = sorted({i for _, i, _ in triples}, key=lambda s: int(s[1:]))
    feats = clock("TF-IDF-like features (set-up)", lambda: tfidf_like(len(items), TIGER_FEATURES))
    ev = clock("NextItemEvaluation.leave_last_out (UIRT)", lambda: NextItemEvaluation.leave_last_out(
        [(u, i, r, t) for t, (u, i, r) in enumerate(triples)], fmt="UIRT", seed=123,
        item_feature=FeatureModality(features=feats, ids=items)))
    test = ev.test_set
    # the first half of the users' sessions, over the whole catalog and its
    # features (the time budget's cut)
    train = clock(f"the first {TIGER_TRAIN_USERS} users' sessions (set-up)",
                  lambda: session_subset(ev.train_set, TIGER_TRAIN_USERS, ev.train_set.iid_map))
    train.add_modalities(item_feature=ev.train_set.item_feature)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    # the RQ-VAE's codebook lookups come first: a level's a step
    probe = TIGER(**TIGER_EXAMPLE)
    n_rq_calls = probe.rqvae_num_levels * probe.rqvae_n_epochs * -(
        -len(items) // min(probe.rqvae_batch_size, len(items)))
    n_rq_steps = n_rq_calls // probe.rqvae_num_levels
    host, epochs, first, steady = {}, [], [], {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with timed_methods([("TIGER", "_fit_rqvae"), ("TIGER", "_build_examples")], host), \
            timed_epochs(epochs), recording_first_calls(first, 0, calls=(
                0, 1, 2, n_rq_calls, n_rq_calls + 1)), \
            timed_calls(tiger_mod, "step", n_rq_steps + TIGER_TIMED_FROM, None, steady):
        model = clock(f"TIGER.fit, {TIGER_EPOCHS} seq2seq epochs",
                      lambda: TIGER(n_epochs=TIGER_EPOCHS, **TIGER_EXAMPLE).fit(train))
    peak = torch.cuda.max_memory_allocated() - held
    metrics = [HitRatio(k=10), NDCG(k=10)]
    result = clock("NextItemEvaluation (beam) over the test users", lambda: ev.eval(
        model, train, test, True, metrics, mode="last"))
    launches = ACCUMULATE_ROWS.launches
    if launches <= 0:
        raise AssertionError("TIGER did not launch accumulate_rows")

    # ---- check and measure ----
    for key, p in model.params.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"TIGER at ML-100K: non-finite {key}")
    vals = result.metric_avg_results
    if not all(np.isfinite(vals[m.name]) and 0.0 <= vals[m.name] <= 1.0 for m in metrics):
        raise AssertionError(f"TIGER at ML-100K: metrics {dict(vals)}")
    if len(epochs) != probe.rqvae_n_epochs + TIGER_EPOCHS or len(first) != 5:
        raise AssertionError(f"TIGER: {len(epochs)} epochs timed, {len(first)} accumulate_rows "
                             f"calls recorded")
    acc_err, acc_rows = clock("the first steps' accumulate_rows held and timed", lambda: (
        hold_and_time_calls("TIGER's first RQ-VAE step", first[:3])))
    err2, rows2 = hold_and_time_calls("TIGER's first seq2seq step", first[3:])
    acc_err, acc_rows = max(acc_err, err2), acc_rows + rows2

    # the card's scores against the same parameters scored on the CPU
    hist = [[int(x) for x in items_[:-1]] for _, _, [items_] in
            itertools.islice(test.si_iter(batch_size=1), 64)]
    cpu = copy.copy(model)
    cpu.params = copy.deepcopy(model.params).to("cpu")
    got = model.score_history_batch([None] * len(hist), hist)
    want = clock("64 histories' beams on the CPU",
                 lambda: cpu.score_history_batch([None] * len(hist), hist))
    beam_swaps, beam_err = beams_match(got, want)
    enc_c, mask_c = model._encode_history_batch(hist[:4])
    sid = torch.as_tensor(model.sid_table[:256], device=enc_c.device)
    offsets = torch.as_tensor(model.offsets, device=enc_c.device)

    def exact_on_cpu():
        enc_h, mask_h = cpu._encode_history_batch(hist[:4])
        return tiger_mod._exact_cross_scores(cpu.params, offsets.cpu(), sid.cpu(), enc_h,
                                             mask_h, model.num_heads).numpy()

    with torch.no_grad():
        exact = tiger_mod._exact_cross_scores(model.params, offsets, sid, enc_c, mask_c,
                                              model.num_heads).cpu().numpy()
        exact_cpu = clock("4 histories' exact scores over 256 items on the CPU", exact_on_cpu)
    exact_err = float(np.abs(exact - exact_cpu).max())
    if not np.allclose(exact, exact_cpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"TIGER's exact scores on the card differ from the CPU's by "
                             f"{exact_err}")

    # the seq2seq step: its bound and a profile of TIGER_PROFILE_STEPS steps
    hists, outs = model._build_examples(train)
    dev = model.params.tok_emb.device
    enc = torch.as_tensor(model.enc_token_table[hists].reshape(len(hists), -1), device=dev)
    tgt = torch.as_tensor(model.sid_table[outs], device=dev)
    bsz = model.batch_size
    steps = -(-len(hists) // bsz)
    if steady["count"] != n_rq_steps + TIGER_EPOCHS * steps:
        raise AssertionError(f"TIGER took {steady['count']} optimizer steps, not the "
                             f"{n_rq_steps} of the RQ-VAE and {TIGER_EPOCHS} x {steps}")
    timed = steady["count"] - n_rq_steps - TIGER_TIMED_FROM
    step_ms = steady["events"][0].elapsed_time(steady["events"][1]) / timed
    params = copy.deepcopy(model.params)
    named = dict(params.named_parameters())
    opt = model._optimizer(steps)
    state = opt.init(named)
    perm = tiger_mod._epoch_perm(1, 0, steps * bsz, len(hists), dev)

    def some_steps():
        nonlocal state
        for b in range(TIGER_PROFILE_STEPS):
            idx = perm[b * bsz:(b + 1) * bsz]
            state = step(named, opt, state, tiger_mod._seq2seq_loss(
                params, offsets, enc[idx], tgt[idx], model.num_heads))

    wall_ms, busy_ms, n_events, events = clock(
        f"{TIGER_PROFILE_STEPS} seq2seq steps profiled", lambda: profile_call(some_steps))
    n_params = sum(p.numel() for p in named.values())
    S, T = model.max_len * len(model.level_sizes), len(model.level_sizes)
    flops, nbytes = tiger_step_bound(bsz, S, T, model.d_model, model.num_heads * model.d_kv,
                                     model.d_ff, model.num_enc_layers, model.num_dec_layers,
                                     model.level_sizes, n_params)
    bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    rq_s = host[("TIGER", "_fit_rqvae")]
    epoch_s = epochs[-1]
    eval_s = clock.seconds["NextItemEvaluation (beam) over the test users"]
    share = busy_ms / wall_ms if events else None
    clock.report("TIGER at ML-100K")
    log(f"  {len(items):,} items x {TIGER_FEATURES} features; {train.num_sessions:,} train "
        f"sessions, {len(hists):,} seq2seq examples ({steps} steps of {bsz}); the RQ-VAE "
        f"({probe.rqvae_n_epochs} epochs) {rq_s:.3f} s, its epochs on the card "
        f"{sum(epochs[:-TIGER_EPOCHS]):.3f} s, {model.rqvae_restarts} dead codes restarted, the "
        f"collision level {model.level_sizes[-1]} wide; the examples' host loop "
        f"{host[('TIGER', '_build_examples')]:.3f} s")
    log(f"  TIGER seq2seq (d {model.d_model}, {model.num_heads} heads of {model.d_kv}, "
        f"{model.num_enc_layers} + {model.num_dec_layers} layers, S {S}, T {T}): epochs "
        + ", ".join(f"{e:.3f}" for e in epochs[-TIGER_EPOCHS:])
        + f" s (the first, cold: {1e3 * epoch_s / steps:.3f} ms a step), {step_ms:.3f} ms a step "
        f"(CUDA events over seq2seq steps {TIGER_TIMED_FROM + 1}-{TIGER_EPOCHS * steps}); bound "
        f"of a step {flops / 1e9:.3f} GFLOP and {nbytes / 1e6:.1f} MB = {1e3 * bound_s:.4f} ms "
        f"({bound_by}), {1e5 * bound_s / step_ms:.3f}% of it; {TIGER_PROFILE_STEPS} steps "
        f"profiled: {wall_ms:.1f} ms host clock, device busy {busy_ms:.3f} ms ("
        + ("not measured" if share is None else f"{100 * share:.2f}%")
        + f"), {n_events / TIGER_PROFILE_STEPS:.1f} device events a step; top device ops "
        f"{top_ops(events)}; peak device memory of the fit {peak / 2**30:.3f} GiB above what "
        f"the run held")
    log(f"  NextItemEvaluation (beam, {model.n_beams} beams, {test.num_sessions:,} test users): "
        f"HitRatio@10 {vals['HitRatio@10']:.6f}, NDCG@10 {vals['NDCG@10']:.6f} in "
        f"{eval_s:.3f} s; 64 histories' beams on the card equal to the CPU's but for "
        f"{beam_swaps} swaps at near-ties, scores within {beam_err:.3e}; 4 histories' exact "
        f"scores over 256 items within {exact_err:.3e}; the first steps' accumulate_rows "
        f"inputs equal to the plain version on the CPU, bit for bit (max |err| {acc_err:.3e}); "
        f"accumulate_rows launches {launches}")
    restarts, collisions = model.rqvae_restarts, model.level_sizes[-1]
    del model, cpu, params, state
    few = session_subset(ev.train_set, TIGER_MESH_USERS, ev.train_set.iid_map)
    few.add_modalities(item_feature=ev.train_set.item_feature)
    pair = full_width_pair("TIGER", lambda **kw: TIGER(
        n_epochs=1, **{**TIGER_EXAMPLE, "rqvae_n_epochs": TIGER_MESH_RQVAE_EPOCHS}, **kw), few,
        mesh)
    log(f"TIGER at ML-100K: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches + pair[0], dict(mesh_pair=pair[1:], rq_s=rq_s, restarts=restarts,
                          collisions=collisions, epoch_s=epoch_s,
                          step_ms=step_ms, step_bound_ms=1e3 * bound_s,
                          bound_by=bound_by, share=share,
                          launches_per_minibatch=n_events / TIGER_PROFILE_STEPS, peak=peak,
                          eval_s=eval_s, metrics={m.name: vals[m.name] for m in metrics},
                          acc=acc_rows, max_abs_err=acc_err)


def beams_match(got, want, tol=1e-4):
    """Hold TIGER's beam scores ``got`` (the card's) to ``want`` (the
    CPU's), row by row: the items a row's beams reached (scores above the
    -1e10 fill) as sets, and their scores within ``tol``. A member may
    differ only where its score lies within ``tol`` of the row's last kept
    score (float32 log-softmax rounding can swap near-tied beams). Returns
    (members swapped, max |score difference| over the common members)."""
    swaps, err = 0, 0.0
    for g, w in zip(got, want):
        gs, ws = np.flatnonzero(g > -1e9), np.flatnonzero(w > -1e9)
        common = np.intersect1d(gs, ws)
        if common.size:
            err = max(err, float(np.abs(g[common] - w[common]).max()))
        odd = np.setxor1d(gs, ws)
        if odd.size:
            edge = min(w[ws].min(), g[gs].min())
            near = np.abs(np.where(g[odd] > -1e9, g[odd], w[odd]) - edge) <= tol
            if not near.all():
                raise AssertionError("TIGER: the card's beams differ from the CPU's beyond "
                                     "near-ties")
            swaps += odd.size
    if err > tol:
        raise AssertionError(f"TIGER: beam scores on the card differ from the CPU's by {err}")
    return swaps, err


GRU_WITNESS_TOL = 1e-5  # max |card - CPU| of a parameter after one epoch


def gru4rec_witness(models, train, dropout, card=DEV):
    """One epoch of GRU4Rec's bench configuration, with ``dropout`` =
    (p_embed, p_hidden), on ``card`` and on the CPU from the same initial
    parameters and on the same draws, all made on the CPU: the permutation
    of the padded session rows, every batch's dropout masks and its shared
    negatives. The epoch is ``GRU4Rec.fit``'s (its rows, padding, batch
    size, ``loss_on`` and ``adagrad_m`` steps) with the draws handed in.
    Returns (steps, max |card - CPU| over the parameters, over the batch
    losses)."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch.models.seq_utils import (build_session_examples, neg_sampling_table,
                                                   sample_negatives, sessions_per_batch)
    from cornac_tpu_torch.ops.optim import adagrad_m, step

    model = make_model(models, "GRU4Rec", 123)
    model.dropout_p_embed, model.dropout_p_hidden = dropout
    model.n_epochs = 0
    model.fit(train)  # the initial parameters, on the card
    init = copy.deepcopy(model.params).to("cpu")
    _, inputs, targets, mask = build_session_examples(train, model.max_len)
    L = max(1, int(mask.sum(axis=1).max()))
    inputs, targets, mask = inputs[:, :L], targets[:, :L], mask[:, :L]
    bsz = sessions_per_batch(model.batch_size, mask, len(mask))
    pad = (-len(mask)) % bsz
    inputs, targets = (np.concatenate([a, np.zeros((pad, L), np.int32)]).astype(np.int64)
                       for a in (inputs, targets))
    mask = np.concatenate([mask, np.zeros((pad, L), np.float32)])
    gen = torch.Generator().manual_seed(123)
    cum = neg_sampling_table(train, model.sample_alpha, model.total_items, "cpu")
    order = torch.randperm(len(mask), generator=gen)
    draws = [(order[b * bsz:(b + 1) * bsz], model._drop_masks(gen, bsz, L, "cpu"),
              sample_negatives(gen, cum, (model.n_sample,))) for b in range(len(mask) // bsz)]

    def epoch(dev):
        model.params = copy.deepcopy(init).to(dev)
        params = dict(model.params.named_parameters())
        opt = adagrad_m(model.learning_rate, model.momentum)
        state = opt.init(params)
        seq, tgt, m = (torch.as_tensor(a, device=dev) for a in (inputs, targets, mask))
        losses = []
        for idx, drop, negs in draws:
            idx = idx.to(dev)
            if drop is not None:
                drop = {"embed": drop["embed"].to(dev), "hidden": [h.to(dev) for h in drop["hidden"]]}
            loss = model.loss_on(seq[idx], tgt[idx], m[idx], drop, negs.to(dev))
            state = step(params, opt, state, loss)
            losses.append(loss.detach())
        return {k: p.detach().cpu() for k, p in params.items()}, torch.stack(losses).cpu()

    on_card, card_losses = epoch(card)
    on_cpu, cpu_losses = epoch("cpu")
    param_err = max((on_card[k] - on_cpu[k]).abs().max().item() for k in on_cpu)
    return len(draws), param_err, (card_losses - cpu_losses).abs().max().item()


# next-item models, CVAECF and GCMC at the bench shapes (phase 12f): the
# configurations of tools/bpr_quality_band.py (SEQ_CONFIGS, AUX_CONFIGS)
def phase_seq_bench(bench_data):
    """Phase 12f, in a spawned process: SPop, FPMC, GRU4Rec and SASRec on
    ``seq_bench_data.gen_sessions``' sessions under NextItemEvaluation
    (mode 'next'), CVAECF (with ``seeded_trust`` as its user graph) and
    GCMC on ``make_ml100k_like(7)``, each metric in the band of the JAX
    package's CPU fits (``tools/bpr_quality_band.py --model``); a second
    seeded fit of each trained model (one epoch a chunk where it chunks)
    bit for bit, whose accumulate_rows inputs (the first at each shape) are
    held to the plain version on the CPU; GRU4Rec's epoch on the CPU's
    draws, on the card within ``GRU_WITNESS_TOL`` of the CPU's
    (``gru4rec_witness``); then the native reader on a UIRT
    file the phase writes: the native path taken, its tuples the line-by-line
    parser's. Returns (accumulate_rows launches, fit seconds, max |err|)."""
    import io

    import torch

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.metrics as pmetrics
    from bpr_quality_band import (AUX_CONFIGS, SEQ_CONFIGS, SEQ_METRICS, aux_metrics, aux_split,
                                  make_model, seq_eval)
    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import Reader
    from cornac_tpu_torch.data.reader import PARSERS
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    clock = Clock()
    ev, seq_metrics = clock("NextItemEvaluation.from_splits (gen_sessions)",
                            lambda: seq_eval(peval, pmetrics))
    triples = bench_data()
    splits = {name: clock(f"{name}'s split", lambda: aux_split(name, pdata, peval, triples))
              for name in AUX_CONFIGS}

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    results = {}
    for name in SEQ_CONFIGS:
        results[name] = clock(f"{name} evaluate", lambda: ev.evaluate(
            make_model(models, name, 123), seq_metrics, user_based=False))
    for name in AUX_CONFIGS:
        results[name] = clock(f"{name} evaluate", lambda: splits[name].evaluate(
            make_model(models, name, 123), aux_metrics(name, pmetrics), user_based=False))
    launches = ACCUMULATE_ROWS.launches
    clock.report("next-item models, CVAECF and GCMC at the bench shapes")
    if launches <= 0:
        raise AssertionError("phase 12f did not launch accumulate_rows")

    # ---- check what came out ----
    fit_s, acc_err, recorded, outside = {}, 0.0, 0, []
    for name, (test_result, _) in results.items():
        names = SEQ_METRICS if name in SEQ_CONFIGS else AUX_CONFIGS[name][2]
        fit_s[name] = test_result.metric_avg_results["Train (s)"]
        for metric in names:
            value = test_result.metric_avg_results[metric]
            lo, hi, _, spread = seq_band(name, metric)
            inside = lo <= value <= hi
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] "
                f"({'one deterministic JAX fit +/- 1e-3' if spread is None else '10 JAX seeds'}) "
                f"{'inside' if inside else 'OUTSIDE'}")
            if not inside:
                outside.append(f"{name} {metric}")
        if name == "SPop":
            continue
        train = ev.train_set if name in SEQ_CONFIGS else splits[name].train_set
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            a = make_model(models, name, 123).fit(train)
            b = make_model(models, name, 123)
            b.verbose = True
            b.fit(train)
        pa, pb = (m.params.items() if isinstance(m.params, dict)
                  else m.params.state_dict().items() for m in (a, b))
        for (key, x), (_, y) in zip(pa, pb):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: two seeded fits differ in {key}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    # GRU4Rec's training on the card is the CPU's: one epoch on the same
    # draws, so the card's fits differ from the CPU's by their stream alone
    for dropout in ((0.0, 0.0), (0.1, 0.2)):
        steps, param_err, loss_err = clock(
            f"GRU4Rec's epoch on the CPU's draws, dropout {dropout}",
            lambda: gru4rec_witness(models, ev.train_set, dropout))
        log(f"  GRU4Rec, one epoch ({steps} steps, dropout (embedding, hidden) {dropout}) on the "
            f"CPU's draws, on the card and on the CPU: max |card - CPU| {param_err:.3e} over the "
            f"parameters (held to {GRU_WITNESS_TOL:g}), {loss_err:.3e} over the batch losses")
        if not param_err <= GRU_WITNESS_TOL:
            raise AssertionError(f"GRU4Rec's epoch on the card differs from the CPU's on the same "
                                 f"draws by {param_err:.3e}")
    if outside:
        raise AssertionError(f"outside their quality bands: {', '.join(outside)}")

    path = ROOT / "build" / "chip_smoke" / "ratings_12f.tsv"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{u}\t{i}\t{r:g}\t{k}\n" for k, (u, i, r) in enumerate(triples)))
    reader = Reader()
    native = clock("Reader.read (UIRT, native)", lambda: reader.read(str(path), fmt="UIRT"))
    if not reader.parsed_natively:
        raise AssertionError("the native reader did not run on this host")
    python = clock("Reader.read (UIRT, line by line)", lambda: Reader().read(
        str(path), fmt="UIRT", parser=PARSERS["UIRT"]))
    if [tuple((type(v), v) for v in t) for t in native] != \
            [tuple((type(v), v) for v in t) for t in python]:
        raise AssertionError("the native reader's tuples differ from the Python parser's")
    log(f"  every trained model: two seeded fits identical, bit for bit; accumulate_rows on the "
        f"trainers' own inputs ({recorded} shapes) equal to the plain version on the CPU, bit "
        f"for bit (max |err| {acc_err:.3e}); the native reader: {len(native):,} UIRT tuples equal "
        f"to the line-by-line parser's ({clock.seconds['Reader.read (UIRT, native)']:.3f} s "
        f"against {clock.seconds['Reader.read (UIRT, line by line)']:.3f} s); accumulate_rows "
        f"launches {launches}")
    log(f"next-item models, CVAECF and GCMC at the bench shapes: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


GENERATIVE_WITNESS_TOL = 1e-5  # max |card - CPU| of a parameter after one epoch
# (BERT4Rec's, held to the float64 epoch, at least)


def _draws_to(draws, dev):
    """A step's draws (tensors, lists of tensors, None) moved to ``dev``."""
    if isinstance(draws, dict):
        return {k: _draws_to(v, dev) for k, v in draws.items()}
    if isinstance(draws, list):
        return [x.to(dev) for x in draws]
    return None if draws is None else draws.to(dev)


def generative_witness(models, train, card=DEV):
    """One epoch of BERT4Rec, one of TIGER's RQ-VAE and one of its
    seq2seq, at their bench configurations, on ``card`` and on the CPU from
    the same initial parameters and on the same draws, all made on the CPU
    (the permutations; BERT4Rec's mask uniforms, negatives and dropout
    masks). BERT4Rec's epoch runs on the CPU in float64 too: the CPU's
    float32 epoch's distance from it is how far float32 rounding alone
    carries a parameter (Adam divides each gradient by its own running
    size, so a gradient's relative rounding error becomes an error of that
    size times the learning rate in its step, and the epoch's 27 steps add
    up to some 1e-4 at lr 0.005). Returns {epoch: (steps, the card's parameters, the CPU's, the
    CPU's float64 epoch's or None)}, each {leaf: float64 tensor on the
    CPU}."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch.models import tiger as tiger_mod
    from cornac_tpu_torch.models.seq_utils import neg_sampling_table
    from cornac_tpu_torch.ops.optim import adam, adamw, step

    def params_of(module):
        return {k: p.detach().cpu().double() for k, p in module.named_parameters()}

    def witness(epoch, reach=False):
        return (epoch(card, torch.float32), epoch("cpu", torch.float32),
                epoch("cpu", torch.float64) if reach else None)

    gen = torch.Generator().manual_seed(123)
    out = {}
    bert = make_model(models, "BERT4Rec", 123)
    bert.n_epochs = 0
    bert.fit(train)  # the initial parameters, on the card
    init = copy.deepcopy(bert.params).to("cpu")
    inputs, targets, mask, bsz = bert.training_rows(train)
    cum = neg_sampling_table(train, bert.sample_alpha, bert.num_items, "cpu")
    order = torch.randperm(len(inputs), generator=gen)
    draws = [(order[b * bsz:(b + 1) * bsz], bert.draws(gen, bsz, inputs.shape[1], "cpu", cum))
             for b in range(len(inputs) // bsz)]

    def bert_epoch(dev, dtype):
        bert.params = copy.deepcopy(init).to(dev, dtype)
        params = dict(bert.params.named_parameters())
        opt = adam(bert.learning_rate)
        state = opt.init(params)
        seq, tgt = (torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (inputs, targets))
        m = torch.as_tensor(mask, dtype=dtype, device=dev)
        for idx, d in draws:
            idx = idx.to(dev)
            state = step(params, opt, state,
                         bert.loss_on(seq[idx], tgt[idx], m[idx], _draws_to(d, dev)))
        return params_of(bert.params)

    out["BERT4Rec"] = (len(draws), *witness(bert_epoch, reach=True))

    tiger = make_model(models, "TIGER-rqvae", 123)
    tiger.rqvae_n_epochs, tiger.n_epochs = 0, 0
    tiger.fit(train)  # k-means codebooks and the seq2seq's initial parameters
    feats = tiger._get_item_features()
    rq_init = copy.deepcopy(tiger.rqvae_params).to("cpu")
    n = feats.shape[0]
    rq_bsz = min(tiger.rqvae_batch_size, n)
    rq_perm = torch.randperm(n + (-n) % rq_bsz, generator=gen) % n

    def rq_epoch(dev, dtype):
        p = copy.deepcopy(rq_init).to(dev, dtype)
        opt = adamw(tiger.rqvae_learning_rate, weight_decay=tiger.rqvae_weight_decay)
        x = torch.as_tensor(feats, dtype=dtype, device=dev)
        tiger_mod._train_epoch(p, opt, opt.init(dict(p.named_parameters())),
                               lambda idx: tiger_mod._rqvae_loss(p, x[idx], tiger.rqvae_beta),
                               rq_perm.to(dev), rq_bsz)
        return params_of(p)

    out["TIGER's RQ-VAE"] = (len(rq_perm) // rq_bsz, *witness(rq_epoch))

    hists, outs = tiger._build_examples(train)
    enc = tiger.enc_token_table[hists].reshape(len(hists), -1)
    tgt = tiger.sid_table[outs]
    s_init = copy.deepcopy(tiger.params).to("cpu")
    s_bsz = min(tiger.batch_size, len(hists))
    s_perm = torch.randperm(len(hists) + (-len(hists)) % s_bsz, generator=gen) % len(hists)

    def seq2seq_epoch(dev, dtype):
        p = copy.deepcopy(s_init).to(dev, dtype)
        opt = tiger._optimizer(len(s_perm) // s_bsz)
        e, t, off = (torch.as_tensor(a, device=dev) for a in (enc, tgt, tiger.offsets))
        tiger_mod._train_epoch(p, opt, opt.init(dict(p.named_parameters())),
                               lambda idx: tiger_mod._seq2seq_loss(p, off, e[idx], t[idx],
                                                                   tiger.num_heads),
                               s_perm.to(dev), s_bsz)
        return params_of(p)

    out["TIGER's seq2seq"] = (len(s_perm) // s_bsz, *witness(seq2seq_epoch))
    return out


# the generative next-item models at the bench shape (process 12h): the
# configurations of tools/bpr_quality_band.py (GENERATIVE_CONFIGS)
GENERATIVE_RESUMED = ("BERT4Rec", "TIGER-rkmeans")  # stopped at epoch 1 and resumed


def phase_generative_bench(bench_data):
    """Process 12h, spawned: BERT4Rec, TransformerRec (clm at 'all' and
    'last', plm, rtd), TIGER with rqvae and beam scoring and with rkmeans
    and exact scoring on ``seq_bench_data.gen_sessions``' sessions (TIGER
    over ``session_features``) under NextItemEvaluation (mode 'next'), each
    metric in the band of the JAX package's CPU fits over ten seeds; a
    second seeded fit of each (one epoch a chunk) bit for bit, whose
    accumulate_rows inputs (the first at each shape) are held to the plain
    version on the CPU; BERT4Rec and TIGER-rkmeans stopped at epoch 1 and
    resumed from their checkpoints equal to the uninterrupted fits; TIGER
    rkmeans' semantic IDs on the card equal to the CPU's bytes; the card
    witness (``generative_witness``). Returns (accumulate_rows launches,
    fit seconds, max |err|)."""
    import io
    import shutil

    import torch

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.metrics as pmetrics
    from bpr_quality_band import GENERATIVE_CONFIGS, SEQ_METRICS, make_model, seq_eval
    from cornac_tpu_torch import models
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    clock = Clock()
    ev, seq_metrics = clock("NextItemEvaluation.from_splits (gen_sessions, features)",
                            lambda: seq_eval(peval, pmetrics, data=pdata))
    train = ev.train_set

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    fitted, results = {}, {}
    for name in GENERATIVE_CONFIGS:
        fitted[name] = make_model(models, name, 123)
        results[name] = clock(f"{name} evaluate", lambda: ev.evaluate(
            fitted[name], seq_metrics, user_based=False))
    launches = ACCUMULATE_ROWS.launches
    clock.report("the generative next-item models at the bench shape")
    if launches <= 0:
        raise AssertionError("process 12h did not launch accumulate_rows")

    # ---- check what came out ----
    fit_s, acc_err, recorded, outside = {}, 0.0, 0, []
    work = ROOT / "build" / "chip_smoke" / "generative_checkpoints"
    for name, (test_result, _) in results.items():
        fit_s[name] = test_result.metric_avg_results["Train (s)"]
        for metric in SEQ_METRICS:
            value = test_result.metric_avg_results[metric]
            lo, hi, _, _ = seq_band(name, metric)
            inside = lo <= value <= hi
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] (10 JAX seeds) "
                f"{'inside' if inside else 'OUTSIDE'}")
            if not inside:
                outside.append(f"{name} {metric}")
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = make_model(models, name, 123)
            again.verbose = True
            again.fit(train)
        a, b = (m.params.state_dict() for m in (fitted[name], again))
        for key in a:
            if not torch.equal(a[key], b[key]):
                raise AssertionError(f"{name}: two seeded fits differ in {key}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
        if name in GENERATIVE_RESUMED:
            shutil.rmtree(work, ignore_errors=True)
            stopped = make_model(models, name, 123)
            stopped.n_epochs = 1
            stopped.enable_checkpointing(work, every=1).fit(train)
            resumed = make_model(models, name, 123)
            resumed.enable_checkpointing(work, every=1).fit(train)
            for key, value in resumed.params.state_dict().items():
                if not torch.equal(value, a[key]):
                    raise AssertionError(f"{name}: the resumed fit differs in {key}")
            shutil.rmtree(work, ignore_errors=True)
    # rkmeans runs on the host: the card's fit has the CPU's semantic IDs
    tiger = fitted["TIGER-rkmeans"]
    on_cpu = make_model(models, "TIGER-rkmeans", 123)
    on_cpu._build_semantic_ids(on_cpu._fit_rkmeans(tiger._get_item_features()))
    if not (np.array_equal(on_cpu.sid_table, tiger.sid_table)
            and on_cpu.sid_table.dtype == tiger.sid_table.dtype):
        raise AssertionError("TIGER-rkmeans: the card's semantic IDs differ from the CPU's")
    witness = clock("the card witness: one epoch each on the CPU's draws",
                    lambda: generative_witness(models, train))
    for what, (steps, card, cpu, exact) in witness.items():
        to_cpu = max((card[k] - cpu[k]).abs().max().item() for k in cpu)
        if exact is None:
            log(f"  {what}, one epoch ({steps} steps) on the CPU's draws, on the card and on the "
                f"CPU: max |card - CPU| {to_cpu:.3e} over the parameters, held to "
                f"{GENERATIVE_WITNESS_TOL:g}")
            if not to_cpu <= GENERATIVE_WITNESS_TOL:
                raise AssertionError(f"{what}: the card's epoch differs from the CPU's on the "
                                     f"same draws by {to_cpu:.3e}")
            continue
        # float32 rounding alone carries the CPU's epoch this far from the
        # float64 one; the card's float32 epoch is held to the float64
        # epoch within that reach, and its parameters more than 1e-5 from
        # it are named, each beside the CPU's own distance there
        reach = max((cpu[k] - exact[k]).abs().max().item() for k in cpu)
        tol = max(GENERATIVE_WITNESS_TOL, reach)
        off, worst = [], 0.0
        for k in card:
            d = (card[k] - exact[k]).abs()
            worst = max(worst, d.max().item())
            off += [f"{k}{list(i)} {d[tuple(i)].item():.3e} (CPU "
                    f"{(cpu[k] - exact[k]).abs()[tuple(i)].item():.3e})"
                    for i in torch.nonzero(d > GENERATIVE_WITNESS_TOL).tolist()]
        log(f"  {what}, one epoch ({steps} steps) on the CPU's draws, on the card, on the CPU "
            f"and on the CPU in float64: max |card - float64| {worst:.3e} over the parameters, "
            f"held to the CPU float32 epoch's own distance from the float64 one, {reach:.3e} "
            f"(at least {GENERATIVE_WITNESS_TOL:g}); max |card - CPU| {to_cpu:.3e}; parameters "
            f"of the card's epoch more than {GENERATIVE_WITNESS_TOL:g} from the float64 one: "
            f"{'; '.join(off) or 'none'}")
        if not worst <= tol:
            raise AssertionError(f"{what}: the card's epoch lies {worst:.3e} from the float64 "
                                 f"epoch, the CPU's float32 epoch {reach:.3e}")
    if outside:
        raise AssertionError(f"outside their quality bands: {', '.join(outside)}")
    log(f"  every model: two seeded fits identical, bit for bit; {', '.join(GENERATIVE_RESUMED)} "
        f"stopped at epoch 1 and resumed equal to the uninterrupted fits; TIGER-rkmeans' "
        f"semantic IDs ({tiger.sid_table.shape[0]} x {tiger.sid_table.shape[1]}, collision level "
        f"{tiger.level_sizes[-1]}) equal to the CPU's bytes; accumulate_rows on the trainers' "
        f"own inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit "
        f"(max |err| {acc_err:.3e}); accumulate_rows launches {launches}")
    log(f"the generative next-item models at the bench shape: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


# ---------------------------------------------------------------------- #
# the next-basket family (phases 17 and 12g)
# ---------------------------------------------------------------------- #
BASKET_METRICS = ("Recall@10", "Recall@50", "HitRatio@10")
# the Ta Feng examples' settings (examples/*_tafeng.py)
TAFENG_MODELS = {
    "GTop": ("GPTop", dict(use_personalized_popularity=False)),
    "PTop": ("GPTop", dict(use_global_popularity=False)),
    "GPTop": ("GPTop", {}),
    "TIFUKNN": ("TIFUKNN", dict(n_neighbors=300, within_decay_rate=0.9, group_decay_rate=0.7,
                                alpha=0.7, n_groups=7)),
    "UPCF": ("UPCF", dict(recency=1, locality=1, asymmetry=0.25)),
    "Beacon": ("Beacon", dict(emb_dim=2, rnn_unit=4, alpha=0.5, rnn_cell_type="LSTM",
                              batch_size=32, lr=0.001, seed=123)),
    "DNNTSP": ("DNNTSP", dict(emb_dim=32, loss_type="bpr", lr=0.001, batch_size=64, seed=123)),
}
BASKET_EPOCHS = 1  # the examples' 15 (Beacon) and 30 (DNNTSP) cut to 1
TAFENG_MESH_USERS = 256  # the mesh pairs' users: some 8 Beacon and 4 DNNTSP steps
BASKET_TIMED_FROM = 100  # the steps after the first 100 are timed
BASKET_PROFILED_STEPS = 5  # the fit's last steps, profiled
# the host loops of the family, timed on their own during the fits
BASKET_HOST_LOOPS = (("Beacon", "_build_correlation_matrix"), ("DNNTSP", "_pack"),
                     ("TIFUKNN", "_compute_user_vector"), ("UPCF", "_user_wise_popularity"))


@contextlib.contextmanager
def timed_methods(methods, seconds):
    """While open, each (class name, method) of the port's models adds its
    host seconds to ``seconds[(class name, method)]``."""
    from cornac_tpu_torch import models

    # each class's own method, taken before any is swapped: a subclass
    # (ComparERObj of EFM) must not add its seconds to its parent's
    reals = {key: getattr(getattr(models, key[0]), key[1]) for key in methods}
    with contextlib.ExitStack() as stack:
        for (cls_name, name), real in reals.items():
            cls = getattr(models, cls_name)

            def timed(*args, _real=real, _key=(cls_name, name), **kwargs):
                t = time.perf_counter()
                try:
                    return _real(*args, **kwargs)
                finally:
                    seconds[_key] = seconds.get(_key, 0.0) + time.perf_counter() - t

            stack.enter_context(swapped(cls, name, timed))
        yield seconds


def beacon_step_bound(B, T, n, E, units):
    """(FLOPs, bytes) of one Beacon training step as the port computes it:
    the multi-hot baskets times A (2 B T n^2), the encoder's dense layer
    forward and its weight gradient (4 B T n E), the head (2 B units n,
    three times) and the correlation term probs @ A forward and its input
    gradient (4 B n^2); the bytes are A read once, RMSProp's update of the
    parameters (5 x 4 bytes a parameter: parameter, gradient and moment
    read, parameter and moment written) and the batch's targets."""
    flops = 2.0 * B * T * n * n + 4.0 * B * n * n + 4.0 * B * T * n * E + 6.0 * B * units * n
    n_params = n * (E + units + 1) + E + 1 + 4 * units * (E + units + 1)
    return flops, 4.0 * n * n + 5 * 4.0 * n_params + 4.0 * B * n


def dnntsp_step_bound(B, T, N, E, n):
    """(FLOPs, bytes) of one DNNTSP training step as the port computes it,
    three times the forward: two graph convolutions (2 B T N^2 E + 2 B T N
    E^2 each), the three attention projections (2 B T N E^2 each), the
    attention's two (T x T) products (2 B N T^2 E each), the temporal
    weights (2 B T N E), the gated table (3 B n E), its output layer
    (2 B n E) and bpr's loss (10 B n); the bytes are Adam's update of the
    parameters (7 x 4 bytes a parameter), the batch's graph blocks, its
    targets and its negatives."""
    fwd = (2 * (2.0 * B * T * N * N * E + 2.0 * B * T * N * E * E) + 3 * 2.0 * B * T * N * E * E
           + 2 * 2.0 * B * N * T * T * E + 2.0 * B * T * N * E + 5.0 * B * n * E + 10.0 * B * n)
    n_params = n * (E + 1) + 7 * E * E + 8 * E + 2
    return 3.0 * fwd, 7 * 4.0 * n_params + 4.0 * B * T * N * N + 12.0 * B * n


def phase_basket_tafeng(seed, mesh):
    """Phase 17, the next-basket family at the Ta Feng counts
    (``tools/seq_bench_data.py::tafeng_like``: 32,266 customers, 23,812
    products, about 817,741 purchase lines): ``NextBasketEvaluation(
    test_size=0.2, seed=123)`` with the repetition and exploration
    breakdowns for GPTop as GTop, PTop and GPTop, then TIFUKNN, UPCF, Beacon
    and DNNTSP at the examples' settings, each through ``evaluate`` (fit,
    then the basket ranking_eval; Recall@10, Recall@50, HitRatio@10): fit
    and evaluation seconds, peak device memory. Beacon and DNNTSP fit 1
    epoch (the examples' 15 and 30 cut to 1): ms a step from CUDA events
    over the steps after the first ``BASKET_TIMED_FROM``, the steady epoch
    and training sequences/s from it, and the bound of a step; the fit's
    last ``BASKET_PROFILED_STEPS`` steps profiled (device events a step,
    busy share); the first step's three accumulate_rows inputs of DNNTSP's
    fit held bit for bit to the plain version on the CPU; 8 histories'
    scores of each held to a float64 scoring of the same parameters. The
    family's host loops are timed on their own. Beacon and DNNTSP each
    fitted with the main process's mesh beside a plain fit, on the first
    ``TAFENG_MESH_USERS`` users' baskets over the whole catalog, held bit
    for bit (``full_width_pair``). Returns (accumulate_rows launches, the
    stats)."""
    import torch

    import cornac_tpu_torch.metrics as pmetrics
    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import BasketDataset
    from cornac_tpu_torch.eval_methods import NextBasketEvaluation
    from cornac_tpu_torch.models import beacon as beacon_mod, dnntsp as dnntsp_mod
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from seq_bench_data import TAFENG_ITEMS, TAFENG_LINES, TAFENG_USERS, tafeng_like

    clock = Clock()
    rows = clock("Ta Feng-like baskets (set-up)", lambda: tafeng_like(seed + 17))
    ev = clock("NextBasketEvaluation (the user split, UBIT)", lambda: NextBasketEvaluation(
        data=rows, fmt="UBIT", test_size=0.2, seed=123))
    n_lines = len(rows)
    # the rows are in user order: the first users' baskets, for the mesh pairs
    prefix = rows[:next(k for k, r in enumerate(rows) if int(r[0][1:]) >= TAFENG_MESH_USERS)]
    del rows
    train, test = ev.train_set, ev.test_set
    metrics = [pmetrics.Recall(k=10), pmetrics.Recall(k=50), pmetrics.HitRatio(k=10)]

    def make(name, **extra):
        cls, kw = TAFENG_MODELS[name]
        return getattr(models, cls)(name=name, **{**kw, **extra})

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    n_seq = sum(1 for b in train.user_basket_data.values() if len(b) >= 2)
    results, peaks, loops, first, timed = {}, {}, {}, [], {}
    with timed_methods(BASKET_HOST_LOOPS, loops):
        for name in TAFENG_MODELS:
            ev.repetition_eval = ev.exploration_eval = name in ("GTop", "PTop", "GPTop")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with contextlib.ExitStack() as stack:
                extra = {}
                if name in ("Beacon", "DNNTSP"):
                    extra = {"n_epochs": BASKET_EPOCHS}
                    steps = BASKET_EPOCHS * -(-n_seq // TAFENG_MODELS[name][1]["batch_size"])
                    timed[name] = stack.enter_context(timed_calls(
                        getattr(models, TAFENG_MODELS[name][0]), "loss_on", BASKET_TIMED_FROM,
                        steps - BASKET_PROFILED_STEPS, {}, profiled=BASKET_PROFILED_STEPS,
                        at_start=True))
                    timed[name]["steps"] = steps
                if name == "DNNTSP":
                    stack.enter_context(recording_first_calls(first, 3))
                model = make(name, **extra)
                results[name] = (model, clock(f"{name} evaluate", lambda: ev.evaluate(
                    model, metrics, user_based=False)[0]))
            peaks[name] = torch.cuda.max_memory_allocated() - held
    launches = ACCUMULATE_ROWS.launches
    clock.report("the next-basket family at Ta Feng")
    if launches <= 0:
        raise AssertionError("DNNTSP did not launch accumulate_rows")

    # ---- check and measure ----
    vals = {}
    for name, (model, result) in results.items():
        vals[name] = {k: result.metric_avg_results[k] for k in result.metric_avg_results
                      if not k.endswith("(s)")}
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals[name].values()):
            raise AssertionError(f"{name} at Ta Feng: metrics {vals[name]}")
        if set(BASKET_METRICS) - set(vals[name]):
            raise AssertionError(f"{name} at Ta Feng: missing metrics in {list(vals[name])}")
    if len(first) != 3:
        raise AssertionError(f"DNNTSP's first step recorded {len(first)} accumulate_rows calls")
    acc_err, acc_rows = hold_and_time_calls("DNNTSP's first step at Ta Feng", first)
    del first

    # 8 test histories: the float32 scores against a float64 scoring of the
    # same parameters (on the card: A in float64 is 4.5 GB, and on the host
    # its products would take most of the phase)
    hist = [[list(b) for b in baskets[:-1]] for _, _, [baskets] in
            itertools.islice(test.ubi_iter(batch_size=1), 8)]
    beacon, dnntsp = results["Beacon"][0], results["DNNTSP"][0]
    got = beacon.score_baskets_batch(np.zeros(8, int), hist)
    ids, lengths = (torch.as_tensor(a, device=DEV) for a in beacon._pack(hist))
    with torch.no_grad():
        want = torch.sigmoid(beacon_mod.beacon_logits(
            copy.deepcopy(beacon.params).double(), beacon._A().double(), ids, lengths,
            beacon.alpha, beacon.rnn_unit, beacon.rnn_cell_type)).cpu().numpy()
    score_err = {"Beacon": float(np.abs(got - want).max())}
    got = dnntsp.score_baskets_batch(np.zeros(8, int), hist)
    packed, _ = dnntsp._scoring_blocks(hist)
    blocks = [torch.as_tensor(a, device=DEV) for a in packed]
    blocks[2] = blocks[2].double()
    with torch.no_grad():
        want = dnntsp_mod.dnntsp_scores(copy.deepcopy(dnntsp.params).double(),
                                        *blocks).cpu().numpy()[:8]
    score_err["DNNTSP"] = float(np.abs(got - want).max())
    del ids, lengths, blocks
    torch.cuda.empty_cache()
    for name, err in score_err.items():
        if not err <= 1e-4:
            raise AssertionError(f"{name} at Ta Feng: scores differ from float64 by {err}")

    # steady steps, the bound of a step, the last steps profiled
    T = beacon.max_seq_length
    n = beacon.total_items
    stats = {}
    for name in ("Beacon", "DNNTSP"):
        model = results[name][0]
        bsz = model.batch_size
        tm = timed[name]
        steps = tm["steps"] // BASKET_EPOCHS
        if tm["count"] != tm["steps"]:
            raise AssertionError(f"{name} at Ta Feng took {tm['count']} steps, not {tm['steps']}")
        last = tm["steps"] - BASKET_PROFILED_STEPS
        step_ms = tm["events"][0].elapsed_time(tm["events"][1]) / (last - BASKET_TIMED_FROM)
        epoch_s = step_ms * steps / 1e3
        fit_s = results[name][1].metric_avg_results["Train (s)"]
        if name == "Beacon":
            flops, nbytes = beacon_step_bound(bsz, T, n, model.emb_dim, model.rnn_unit)
        else:
            flops, nbytes = dnntsp_step_bound(bsz, model._train_T, model._train_N,
                                              model.emb_dim, n)
        step_bound_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        prof = dict(wall_ms=tm["wall_ms"], busy_ms=tm["busy_ms"],
                    share=tm["busy_ms"] / tm["wall_ms"],
                    launches_per_minibatch=tm["device_events"], top=tm["top"])
        stats[name] = dict(epoch_s=epoch_s, seq_per_s=n_seq / epoch_s,
                           step_ms=step_ms, step_bound_ms=1e3 * step_bound_s,
                           bound_by=bound_by, steps=steps, n_seq=n_seq, flops=flops,
                           nbytes=nbytes, fit_s=fit_s, **prof)
        log(f"  {name} over {n_seq:,} train sequences ({steps:,} steps of {bsz}): "
            f"{step_ms:.3f} ms a step (CUDA events over steps {BASKET_TIMED_FROM + 1}-{last}), "
            f"{epoch_s:.3f} s a steady epoch at that rate (the {BASKET_EPOCHS}-epoch fit "
            f"{fit_s:.3f} s host clock, its set-up included), {n_seq / epoch_s:,.0f} training "
            f"sequences/s; bound of a step {flops / 1e9:.3f} GFLOP and {nbytes / 1e6:.1f} MB = "
            f"{1e3 * step_bound_s:.4f} ms ({bound_by}), {100 * step_bound_s * steps / epoch_s:.3f}% "
            f"of it; the fit's last {BASKET_PROFILED_STEPS} steps profiled: "
            f"{prof['wall_ms']:.1f} ms host clock, device busy {prof['busy_ms']:.3f} ms "
            f"({100 * prof['share']:.2f}%), {prof['launches_per_minibatch']:.1f} device events a "
            f"step; top device ops {prof['top']}")
    log(f"  Beacon's T (the most baskets of a train user) {T}, X @ A "
        f"{2.0 * beacon.batch_size * T * n * n / 1e9:.1f} GFLOP a step; DNNTSP's graph blocks "
        f"T {dnntsp._train_T}, N {dnntsp._train_N}")
    log(f"  {n_lines:,} purchase lines ({TAFENG_LINES:,} published) of {ev.total_users:,} users "
        f"({TAFENG_USERS:,}) over {ev.total_items:,} items ({TAFENG_ITEMS:,}); train "
        f"{train.num_users:,} users, {train.num_baskets:,} baskets; test "
        f"{len(test.user_basket_data):,} users")
    for name, (model, result) in results.items():
        r = result.metric_avg_results
        log(f"  {name}: fit {r['Train (s)']:.3f} s, evaluation {r['Test (s)']:.3f} s, peak device "
            f"memory {peaks[name] / 2**30:.3f} GiB; " + ", ".join(
                f"{k} {v:.6f}" for k, v in vals[name].items()))
    log("  host loops (host clock, summed over the fits and the evaluations): " + ", ".join(
        f"{cls}.{meth} {loops.get((cls, meth), 0.0):.3f} s" for cls, meth in BASKET_HOST_LOOPS))
    log(f"  DNNTSP's first step's three accumulate_rows inputs equal to the plain version on the "
        f"CPU, bit for bit (max |err| {acc_err:.3e}); 8 histories' scores within "
        + ", ".join(f"{k} {v:.3e}" for k, v in score_err.items())
        + f" of float64; accumulate_rows launches {launches}")
    del results, beacon, dnntsp
    few = BasketDataset.build(prefix, fmt="UBIT", global_iid_map=copy.copy(train.iid_map),
                              seed=123)
    pairs = {}
    for name in ("Beacon", "DNNTSP"):
        pair = full_width_pair(name, functools.partial(make, name, n_epochs=1), few, mesh)
        launches += pair[0]
        pairs[name] = pair[1:]
    log(f"the next-basket family at Ta Feng: ok in {sum(clock.seconds.values()):.1f} s")
    del ev
    torch.cuda.empty_cache()
    return launches, dict(mesh_pairs=pairs, stats=stats, metrics=vals, peaks=peaks, T=T,
                          acc=acc_rows,
                          max_abs_err=acc_err, loops=loops,
                          seconds=sum(clock.seconds.values()))


BASKET_WITNESS_TOL = 1e-5  # max |card - CPU| of a parameter after one epoch


def basket_witness(name, train, card=DEV):
    """One epoch of Beacon's or DNNTSP's bench configuration on ``card``
    and on the CPU from the same initial parameters and on the same draws,
    all made on the CPU: the permutation, and every step's dropout mask
    (Beacon) or negatives (DNNTSP). Returns (steps, max |card - CPU| over
    the parameters whose gradient is not zero in exact arithmetic, the
    names of those whose gradient is, their max |value| on either device).
    DNNTSP's graph-convolution biases come right before a batch
    normalisation and bpr's differences cancel its output bias: their
    gradients are float32 rounding, which Adam scales to about lr a step."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch import models
    from cornac_tpu_torch.ops.optim import rmsprop, step

    model = make_model(models, name, 123)
    model.n_epochs = 0
    model.device = "cpu"
    model.fit(train)
    init = copy.deepcopy(model.params)
    data = model._training_data(train, "cpu")
    n_rows = data[-1].shape[0] if name == "Beacon" else data[1].shape[0]
    bsz = min(model.batch_size, n_rows)
    n_total = n_rows + (-n_rows) % bsz
    gen = torch.Generator().manual_seed(123)
    order = torch.randperm(n_total, generator=gen) % n_rows
    draws = []
    for b in range(n_total // bsz):
        if name == "Beacon":
            extra = model._drop_mask(gen, (bsz, model.max_seq_length, model.emb_dim), "cpu")
        else:
            extra = torch.randint(0, model.total_items, (bsz, model.total_items), generator=gen)
        draws.append((order[b * bsz:(b + 1) * bsz], extra))
    zero_grad = () if name == "Beacon" else ("gcn_b.0", "gcn_b.1", "fc_b")

    def epoch(dev):
        model.device = dev
        model.params = copy.deepcopy(init).to(dev)
        if name == "Beacon":
            model._A_dense = None  # rebuilt on ``dev``
        params = dict(model.params.named_parameters())
        opt = model._make_optimizer() if name == "DNNTSP" else rmsprop(model.lr)
        state = opt.init(params)
        tensors = [[x.to(dev) for x in t] if isinstance(t, list) else t.to(dev) for t in data]
        for idx, extra in draws:
            idx, extra = idx.to(dev), None if extra is None else extra.to(dev)
            if name == "Beacon":
                ids, lengths, y = tensors
                loss = model.loss_on(ids[idx], lengths[idx], y[idx], extra)
            else:
                blocks, y, cls_w = tensors
                loss = model.loss_on([a[idx] for a in blocks], y[idx], extra, cls_w)
            state = step(params, opt, state, loss)
        return {k: p.detach().cpu() for k, p in params.items()}

    on_card, on_cpu = epoch(card), epoch("cpu")
    err = max((on_card[k] - on_cpu[k]).abs().max().item() for k in on_cpu if k not in zero_grad)
    noise = max([max(on_card[k].abs().max().item(), on_cpu[k].abs().max().item())
                 for k in zero_grad] or [0.0])
    return len(draws), err, zero_grad, noise


def neighbour_sets_match(got, want, queries, X, rtol=1e-5):
    """Hold TIFUKNN's neighbour lists ``got`` (the card's) to ``want``
    (the CPU's), row by row, as sets: the order within a list may differ
    where float32 distances nearly tie, and so may a member, but only one
    whose float64 distance lies within ``rtol`` of the list's last. Returns
    the number of such swapped members."""
    swapped = 0
    for q, g, w in zip(queries, got, want):
        extra = np.setdiff1d(g, w)
        if not extra.size:
            continue
        d2 = ((X.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
        edge = d2[w].max()
        near = np.abs(d2[np.concatenate([extra, np.setdiff1d(w, g)])] - edge) <= rtol * edge
        if not near.all():
            raise AssertionError("TIFUKNN: the card's neighbour sets differ from the CPU's "
                                 "beyond near-ties")
        swapped += extra.size
    return swapped


def phase_basket_bench(bench_data):
    """Process 12g, spawned: the next-basket family at the bench shape
    (``seq_bench_data.gen_baskets``: 300 users, 120 items, seed 7, under
    ``NextBasketEvaluation(test_size=0.2, seed=123)``) and on
    ``tests/data/basket.txt``: GPTop, TIFUKNN and UPCF scored on the card
    equal to the port's CPU scores (rtol 1e-5 / atol 1e-6) with TIFUKNN's
    neighbour sets identical (``neighbour_sets_match``); Beacon and DNNTSP
    at the Ta Feng examples'
    settings, each metric in the band of the JAX package's CPU fits over ten
    seeds (``tools/quality_bands.py::BASKET_BANDS``); a second seeded fit of
    each bit for bit, whose accumulate_rows inputs are held to the plain
    version on the CPU; one epoch of each on the CPU's draws, on the card
    within ``BASKET_WITNESS_TOL`` of the CPU's (``basket_witness``). Returns
    (accumulate_rows launches, fit seconds, max |err|)."""
    import io

    import torch

    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.metrics as pmetrics
    from bpr_quality_band import BASKET_CONFIGS, BASKET_METRICS as METRICS, basket_eval, make_model
    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import Reader
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from quality_bands import basket_band

    clock = Clock()
    ev, metrics = clock("NextBasketEvaluation (gen_baskets)", lambda: basket_eval(peval, pmetrics))
    txt = clock("NextBasketEvaluation (tests/data/basket.txt)", lambda: peval.NextBasketEvaluation(
        data=Reader().read(str(ROOT / "tests" / "data" / "basket.txt"), fmt="UBIT"),
        test_size=0.25, fmt="UBIT", seed=123))

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    results = {name: clock(f"{name} evaluate", lambda: ev.evaluate(
        make_model(models, name, 123), metrics, user_based=False)[0]) for name in BASKET_CONFIGS}
    launches = ACCUMULATE_ROWS.launches
    clock.report("the next-basket family at the bench shape")
    if launches <= 0:
        raise AssertionError("process 12g did not launch accumulate_rows")

    # ---- check what came out ----
    outside, fit_s = [], {}
    for name, result in results.items():
        fit_s[name] = result.metric_avg_results["Train (s)"]
        for metric in METRICS:
            value = result.metric_avg_results[metric]
            lo, hi, _, _ = basket_band(name, metric)
            inside = lo <= value <= hi
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] (10 JAX seeds) "
                f"{'inside' if inside else 'OUTSIDE'}")
            if not inside:
                outside.append(f"{name} {metric}")

    # the deterministic models: the card's scores are the CPU's
    checked, swapped = 0, 0
    for split in (ev, txt):
        users, hist = [], []
        for [u], _, [baskets] in split.test_set.ubi_iter(1):
            users.append(int(u))
            hist.append([list(b) for b in baskets[:-1]])
        for name in ("GPTop", "TIFUKNN", "UPCF"):
            cls, kw = TAFENG_MODELS[name]
            if name == "TIFUKNN" and split is txt:
                kw = dict(kw, n_neighbors=3)
            extra = {} if name == "GPTop" else {"device": "cpu"}
            card = getattr(models, cls)(**kw).fit(split.train_set)
            cpu = getattr(models, cls)(**kw, **extra).fit(split.train_set)
            got, want = card.score_baskets_batch(users, hist), cpu.score_baskets_batch(users, hist)
            if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"{name}: the card's scores differ from the CPU's by "
                                     f"{np.abs(got - want).max():.3e}")
            if name == "TIFUKNN":
                q = np.stack([cpu._compute_user_vector(h) for h in hist])
                swapped += neighbour_sets_match(card.neighbors(q).cpu().numpy(),
                                                cpu.neighbors(q).numpy(), q, cpu.user_vectors)
            checked += 1

    acc_err, recorded = 0.0, 0
    for name in BASKET_CONFIGS:
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            a = make_model(models, name, 123).fit(ev.train_set)
            b = make_model(models, name, 123)
            b.verbose = True
            b.fit(ev.train_set)
        for (key, x), y in zip(a.params.named_parameters(), b.params.parameters()):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: two seeded fits differ in {key}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    for name in BASKET_CONFIGS:
        steps, err, zero_grad, noise = clock(f"{name}'s epoch on the CPU's draws",
                                             lambda: basket_witness(name, ev.train_set, DEV))
        log(f"  {name}, one epoch ({steps} steps) on the CPU's draws, on the card and on the CPU: "
            f"max |card - CPU| {err:.3e} over the parameters (held to {BASKET_WITNESS_TOL:g})"
            + (f"; {', '.join(zero_grad)} (zero gradient in exact arithmetic) within "
               f"{noise:.3e} of 0 on either" if zero_grad else ""))
        if not err <= BASKET_WITNESS_TOL:
            raise AssertionError(f"{name}'s epoch on the card differs from the CPU's on the same "
                                 f"draws by {err:.3e}")
        # an Adam or RMSProp step moves a parameter by at most about
        # lr x (1 - b1) / sqrt(1 - b2), or lr / sqrt(1 - decay): 3.16 lr
        if zero_grad and not noise <= 3.2 * steps * make_model(models, name, 123).lr:
            raise AssertionError(f"{name}: {zero_grad} moved by {noise:.3e}")
    if outside:
        raise AssertionError(f"outside their quality bands: {', '.join(outside)}")
    log(f"  GPTop, TIFUKNN and UPCF on the card equal to the CPU's scores on {checked} fits "
        f"(gen_baskets and tests/data/basket.txt), TIFUKNN's neighbour sets identical (members "
        f"swapped at a near-tie of the last distance: {swapped}); Beacon "
        f"and DNNTSP: two seeded fits identical, bit for bit; accumulate_rows on their own inputs "
        f"({recorded} shapes) equal to the plain version on the CPU, bit for bit (max |err| "
        f"{acc_err:.3e}); accumulate_rows launches {launches}")
    log(f"the next-basket family at the bench shape: ok in {sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


# ---------------------------------------------------------------------------
# the side-information models (phases 18, 18b, 18c and process 12i), at the
# counts of TRADESY_* and CLOTHING_*. The data are seeded, not the files.
# examples/vbpr_tradesy.py; its 50 epochs cut to 1 (about 3,550 steps)
VBPR_TRADESY = dict(k=10, k2=20, batch_size=100, learning_rate=0.005, lambda_w=1, lambda_b=0.01,
                    lambda_e=0.0, seed=123)
VBPR_EPOCHS = 1
# the timed fit runs over the first 1 / VBPR_FIT_SHARE of the train
# feedback, cut for the run's time (the whole train set before)
VBPR_FIT_SHARE = 2
VBPR_TIMED_FROM = 100  # the steps after the first 100 are timed
VBPR_PROFILED_STEPS = 20
EVAL_SUBSET_USERS, EVAL_BUDGET_S = 4_096, 10.0
# examples/sorec_filmtrust.py's settings on phase 15's Epinions split (2 of
# its 100 epochs), examples/mcf_office.py's and examples/pcrl_example.py's
# on phase 15b's Amazon Office split
SOREC_EPINIONS = dict(k=5, learning_rate=0.001, lambda_c=10, lambda_reg=0.001, batch_size=1024,
                      seed=123)
SOREC_EPOCHS = 2
SOREC_PROFILED_STEPS = 20
MCF_OFFICE = dict(k=10, max_iter=40, learning_rate=0.001, seed=123)
PCRL_OFFICE = dict(k=100, z_dims=[300], max_iter=60, batch_size=300, learning_rate=0.001,
                   seed=123)
SERVED_USERS = 1_024  # users each 18b/18c model serves through fused_topk
# the Clothing examples (amr_clothing.py, causalrec_clothing.py,
# vmf_clothing.py, dmrl_clothes_example.py), each with its epochs cut: name
# -> (class, settings, epochs, the example's epochs, metrics)
CLOTHING_MODELS = {
    "AMR": ("AMR", dict(k=10, k2=20, batch_size=100, learning_rate=0.001, lambda_w=1,
                        lambda_b=0.01, lambda_e=0.0, lambda_adv=1.0, epsilon_adv=0.05,
                        verbose=False), ("n_epochs", 3, 50), ("AUC", "Recall@50")),
    "CausalRec": ("CausalRec", dict(k=10, k2=20, batch_size=100, learning_rate=0.005, lambda_w=1,
                                    lambda_b=0.01, lambda_e=0.0, tanh=1, lambda_2=0.8,
                                    verbose=False), ("n_epochs", 3, 50), ("AUC", "Recall@50")),
    "VMF": ("VMF", dict(k=10, d=10, batch_size=100, learning_rate=0.001), ("n_epochs", 5, 100),
            ("RMSE", "Recall@50", "NDCG@50")),
    "DMRL": ("DMRL", dict(batch_size=1024, learning_rate=0.001, embedding_dim=100, num_factors=4,
                          num_neg=4), ("epochs", 20, 20), ("Precision@10", "Recall@10",
                                                            "NDCG@10")),
}
SIDE_WITNESS_TOL = 1e-5  # max |card - CPU| of a parameter after one epoch
# the largest inner gradient at which the card's and the CPU's FGSM signs may
# differ, over its step's largest: float32 rounding of a sum of terms
SIGN_FLIP_TOL = 1e-5


def tradesy_like(seed):
    """Seeded binary feedback at the Tradesy counts over Zipf-like users and
    items."""
    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, TRADESY_USERS, TRADESY_ITEMS, TRADESY_FEEDBACK, 0.5, 0.7)
    return [(f"u{u}", f"i{i}", 1.0) for u, i in zip(users.tolist(), items.tolist())]


def visual_features(n_items, seed, rank=32):
    """(n_items, VISUAL_WIDTH) float32 on the host, non-negative like CNN
    activations: the ReLU of a seeded rank-``rank`` product plus noise,
    made on the card (680M normal draws would take the host tens of
    seconds) and copied to the host once."""
    import torch

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    a = torch.randn(n_items, rank, generator=gen, device=DEV)
    b = torch.randn(rank, VISUAL_WIDTH, generator=gen, device=DEV) / rank ** 0.5
    out = torch.randn(n_items, VISUAL_WIDTH, generator=gen, device=DEV).mul_(0.3)
    out.addmm_(a, b).relu_()
    host = out.cpu().numpy()
    del out
    torch.cuda.empty_cache()
    return host


def clothing_like(seed):
    """Seeded star ratings at the Amazon Clothing counts, seeded visual
    features and a seeded corpus (10-60 words an item, Zipf-like over a
    vocabulary of 12,000)."""
    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, CLOTHING_USERS, CLOTHING_ITEMS, CLOTHING_RATINGS, 0.4, 0.6)
    ratings = star_triples(rng, users, items)
    p = 1.0 / np.arange(1, 12_001) ** 0.9
    p /= p.sum()
    # letters only: the tokenizer's rules drop digits
    vocab = ["".join(chr(97 + (w // 26 ** j) % 26) for j in range(3)) + "x"
             for w in range(12_000)]
    docs = [" ".join(vocab[w] for w in rng.choice(12_000, size=rng.randint(10, 61), p=p))
            for _ in range(CLOTHING_ITEMS)]
    return ratings, visual_features(CLOTHING_ITEMS, seed), docs, [
        f"i{i}" for i in range(CLOTHING_ITEMS)]


@contextlib.contextmanager
def timed_calls(owner, name, first, last, out, profiled=0, at_start=False):
    """While open, ``owner.name`` (a step or an iteration function) is
    wrapped: a CUDA event is recorded after call ``first`` (counting from
    1) and after call ``last`` (None: after every later call, the latest
    kept), or before each with ``at_start`` (then the span holds whatever
    runs between the calls, as a step's backward and optimizer after its
    loss); the ``profiled`` calls after the span run under torch.profiler.
    ``out``: "count" (calls), "events" (the two CUDA events), and, where
    profiled, "wall_ms", "busy_ms", "device_events" (device events a call)
    and "top"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    real = getattr(owner, name)
    lo = None if last is None else last if at_start else last + 1  # the first call profiled
    out.update(count=0, events=[None, None], wall_ms=None, busy_ms=None, device_events=None,
               top="")
    state = {}

    def stop():
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t"]
        prof = state.pop("prof")
        prof.__exit__(None, None, None)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        out.update(wall_ms=1e3 * wall, busy_ms=sum(e.self_device_time_total for e in events) / 1e3,
                   device_events=sum(e.count for e in events) / profiled, top=top_ops(events))

    def mark(n):
        if n == first or (n > first and (last is None or n == last)):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            out["events"][n > first] = event

    def wrapped(*args, **kwargs):
        out["count"] += 1
        n = out["count"]
        if at_start:
            mark(n)
            if profiled and n == lo + profiled and "prof" in state:
                stop()
        if profiled and n == lo:
            torch.cuda.synchronize()
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
            state["t"] = time.perf_counter()
        result = real(*args, **kwargs)
        if not at_start:
            mark(n)
            if profiled and n == lo + profiled - 1:
                stop()
        return result

    try:
        with swapped(owner, name, wrapped):
            yield out
    finally:
        if "prof" in state:
            stop()


def ratings_subset(test, users):
    """The ratings of ``users`` in ``test``, with the attributes
    ``ranking_eval`` reads."""
    import types

    from scipy.sparse import csr_matrix

    keep = np.isin(test.uir_tuple[0], users)
    u, i, r = (a[keep] for a in test.uir_tuple)
    return types.SimpleNamespace(uir_tuple=(u, i, r), num_items=test.num_items,
                                 csr_matrix=csr_matrix((r, (u, i)), shape=test.csr_matrix.shape))


def vbpr_step_bound(n_params, bsz, f_dim, k2):
    """(FLOPs, bytes) of one VBPR step as the port computes it: Adam's dense
    update over every parameter (p, g, m, v read, p, m, v written: 28 B a
    parameter), the 2B feature rows of the positives and negatives read
    once and the triplets' ids; the projections of those rows through E and
    Bp (2 x 2B x f x (k2 + 1)), three times over for the backward."""
    flops = 3 * 2.0 * 2 * bsz * f_dim * (k2 + 1)
    return flops, 28.0 * n_params + 4.0 * 2 * bsz * f_dim + 8.0 * 3 * bsz


def phase_vbpr_tradesy(seed, mesh):
    """Phase 18, VBPR at the Tradesy counts (``examples/vbpr_tradesy.py``'s
    split and settings; seeded feedback, seeded 4,096-wide features):
    RatioSplit(0.1, 0.5) with ``ImageModality(normalized=True)``, the split
    timed on the host; a fit of ``VBPR_EPOCHS`` epoch over the first 1 /
    ``VBPR_FIT_SHARE`` of the train feedback (the whole catalog), the steps
    after the first 100 timed with CUDA events (ms a step beside the bound
    of a step),
    ``VBPR_PROFILED_STEPS`` steps profiled (device events a step, busy
    share), peak device memory; ranking_eval's AUC and Recall@50 over the
    first 4,096 test users, and over the others too unless all of them
    would take more than 30 s;
    recommend_batch of 8,192 users at k = 100 through fused_topk (d = 31),
    every list held to the plain version; one ``VBPR(mesh=...)`` fit on the
    main process's mesh beside a plain one, on the first
    ``MESH_PAIR_STEPS`` minibatches' ratings over the whole catalog and its
    features, held bit for bit (``full_width_pair``). Returns
    (accumulate_rows launches, fused_topk launches, the model, the users
    served, the stats)."""
    import torch

    from cornac_tpu_torch.data import ImageModality
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval
    from cornac_tpu_torch.metrics import AUC, Recall
    from cornac_tpu_torch.models import VBPR
    from cornac_tpu_torch.models import vbpr as vbpr_mod
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK
    from cornac_tpu_torch.ops.optim import adam
    from cornac_tpu_torch.utils.checkpoint import epoch_generator

    clock = Clock()
    feedback = clock("Tradesy-like feedback (set-up)", lambda: tradesy_like(seed + 18))
    feats = clock("visual features, made on the card and copied to the host (set-up)",
                  lambda: visual_features(TRADESY_ITEMS, seed + 18))
    ids = [f"i{i}" for i in range(TRADESY_ITEMS)]
    split = clock("RatioSplit(0.1) with ImageModality(normalized=True)", lambda: RatioSplit(
        feedback, test_size=0.1, rating_threshold=0.5, exclude_unknowns=True, seed=123,
        item_image=ImageModality(features=feats, ids=ids, normalized=True), verbose=False))
    del feats, feedback
    train = split.train_set
    n, bsz = train.num_ratings, VBPR_TRADESY["batch_size"]
    fit_set = clock(f"the first 1/{VBPR_FIT_SHARE} of the train feedback (set-up)",
                    lambda: rating_prefix(train, n // VBPR_FIT_SHARE))
    n_fit = fit_set.num_ratings
    n_batches = -(-n_fit // bsz)
    log(f"  {train.num_users:,} train users x {train.num_items:,} items, {n:,} train feedback; "
        f"the fit over the first {n_fit:,}, {n_batches:,} steps an epoch; features "
        f"{train.item_image.features.shape}, {train.item_image.features.nbytes / 2**30:.2f} GiB")

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with timed_calls(vbpr_mod, "step", VBPR_TIMED_FROM, VBPR_EPOCHS * n_batches, {}) as timed:
        model = clock(f"VBPR.fit, {VBPR_EPOCHS} epoch", lambda: VBPR(
            n_epochs=VBPR_EPOCHS, verbose=False, **VBPR_TRADESY).fit(fit_set))
    peak = torch.cuda.max_memory_allocated() - held
    if timed["count"] != VBPR_EPOCHS * n_batches:
        raise AssertionError(f"VBPR took {timed['count']} steps, not {VBPR_EPOCHS * n_batches}")
    events = timed["events"]
    step_ms = events[0].elapsed_time(events[1]) / (VBPR_EPOCHS * n_batches - VBPR_TIMED_FROM)
    metrics = [AUC(), Recall(k=50)]
    test_users = np.unique(split.test_set.uir_tuple[0])
    head, rest = test_users[:EVAL_SUBSET_USERS], test_users[EVAL_SUBSET_USERS:]
    per_user = clock(f"ranking_eval (AUC, Recall@50), the first {len(head):,} test users",
                     lambda: ranking_eval(model, metrics, train, ratings_subset(split.test_set, head),
                                          rating_threshold=0.5)[1])
    projected = (clock.seconds[f"ranking_eval (AUC, Recall@50), the first {len(head):,} test "
                               f"users"] * len(test_users) / len(head))
    if len(rest) and projected <= EVAL_BUDGET_S:  # the rest of the test users too
        more = clock(f"ranking_eval (AUC, Recall@50), the other {len(rest):,} test users",
                     lambda: ranking_eval(model, metrics, train, ratings_subset(split.test_set, rest),
                                          rating_threshold=0.5)[1])
        per_user = [{**a, **b} for a, b in zip(per_user, more)]
    evaluated = len(per_user[0])
    quality = [sum(d.values()) / len(d) for d in per_user]
    users = np.random.RandomState(seed + 18).choice(train.num_users, SERVE_BATCH, replace=False)
    relaxed = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                    lambda: serve_check(model, train, users, "VBPR recommend_batch"))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("VBPR at Tradesy")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"VBPR launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")

    # ---- check and measure ----
    for arr in model._arrays() + (model.theta_item, model.visual_bias):
        if not np.isfinite(arr).all():
            raise AssertionError("VBPR at Tradesy: a non-finite parameter")
    dev = torch.device(DEV)
    params = {t: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
              for t, a in zip(vbpr_mod.TABLES, model._arrays())}
    F = torch.as_tensor(np.asarray(train.item_image.features[: model.total_items], np.float32),
                        device=dev)
    pairs = torch.as_tensor(np.stack(train.uir_tuple[:2], axis=1).astype(np.int64), device=dev)
    pos, negs = vbpr_mod.vbpr_draws(epoch_generator(seed, 0, dev), n,
                                    VBPR_PROFILED_STEPS * bsz, train.num_items)
    opt = adam(VBPR_TRADESY["learning_rate"])
    hyper = (model.lambda_w, model.lambda_b, model.lambda_e, 0.0, 0.0)

    def some_steps():
        vbpr_mod.vbpr_epoch(params, opt, opt.init(params), (pos, negs), pairs, F, hyper, bsz,
                            False)

    some_steps()  # warm
    wall_ms, busy_ms, events_n, top = profile_call(some_steps)
    share = busy_ms / wall_ms if top else None
    del F, params
    n_params = sum(np.asarray(a).size for a in model._arrays())
    flops, nbytes = vbpr_step_bound(n_params, bsz, VISUAL_WIDTH, model.k2)
    bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    epoch_s = clock.seconds[f"VBPR.fit, {VBPR_EPOCHS} epoch"] / VBPR_EPOCHS
    log(f"  VBPR k={model.k} k2={model.k2} over {n_fit:,} feedback: {epoch_s:.3f} s an epoch (host "
        f"clock, the fit's set-up and the features' copy to the card included), {step_ms:.3f} ms "
        f"a step (CUDA events over steps {VBPR_TIMED_FROM + 1}-{VBPR_EPOCHS * n_batches}) "
        f"against a {bound_ms:.4f} ms bound ({bound_by}: {n_params:,} parameters x 28 B + "
        f"{2 * bsz} feature rows x {VISUAL_WIDTH * 4:,} B = {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP), {100 * bound_ms / step_ms:.3f}% of it; {VBPR_PROFILED_STEPS} "
        f"steps profiled: {wall_ms / VBPR_PROFILED_STEPS:.3f} ms a step host clock, busy "
        + ("not measured" if share is None else f"{100 * share:.2f}%")
        + f", {events_n / VBPR_PROFILED_STEPS:.1f} device events a step; top device ops "
        f"{top_ops(top) if top else 'none seen'}; peak device memory of the fit "
        f"{peak / 2**30:.3f} GiB above what the run held")
    log(f"  ranking_eval over {evaluated:,} of {len(test_users):,} test users: AUC "
        f"{quality[0]:.6f}, Recall@50 {quality[1]:.6f} (projected for all: {projected:.1f} s; no "
        f"band at this size); recommend_batch ({SERVE_BATCH} users, k={TOPK}, d="
        f"{model.k + model.k2 + 1}) equal to the plain version (positions relaxed as near-ties: "
        f"{relaxed}); fused_topk launches {fused}, accumulate_rows launches {launches}")
    pair = full_width_pair("VBPR", lambda **kw: VBPR(n_epochs=1, verbose=False, **VBPR_TRADESY,
                                                     **kw),
                           rating_prefix(train, MESH_PAIR_STEPS * bsz), mesh)
    log(f"VBPR at Tradesy: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches + pair[0], fused, model, users, dict(
        mesh_pair=pair[1:], epoch_s=epoch_s, step_ms=step_ms, bound_ms=bound_ms,
        bound_by=bound_by, share=share,
        launches_per_step=events_n / VBPR_PROFILED_STEPS, peak=peak, quality=quality,
        evaluated=evaluated, n_test_users=len(test_users),
        split_s=clock.seconds["RatioSplit(0.1) with ImageModality(normalized=True)"])


@contextlib.contextmanager
def timed_stream_epochs(module, stamps):
    """While open, the card is synchronised and the host clock appended to
    ``stamps`` before the first and after the second of each pair of
    ``module.run_stream_epoch`` calls (SoRec's trust then rating stream:
    one epoch)."""
    import torch

    real, count = module.run_stream_epoch, [0]

    def stamp():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def run(*args, **kwargs):
        if count[0] % 2 == 0:
            stamp()
        out = real(*args, **kwargs)
        if count[0] % 2 == 1:
            stamp()
        count[0] += 1
        return out

    with swapped(module, "run_stream_epoch", run):
        yield stamps


def phase_side_published(epinions, office, mesh):
    """Phase 18b, on data already built: SoRec (``examples/sorec_filmtrust.py``'s
    settings, 2 epochs) on phase 15's Epinions split with its trust graph,
    each epoch timed, MAE and RMSE, a second seeded fit bit for bit; MCF
    (``examples/mcf_office.py``: 40 iterations) and PCRL
    (``examples/pcrl_example.py``: 60) on phase 15b's Amazon Office split
    with its item graph, fits timed, Precision, Recall and NDCG@10; each of
    the three serving 1,024 users at k = 100 through fused_topk, every list
    held to the plain version. Each of the three fitted with the main
    process's mesh beside a plain fit, one epoch or iteration on the first
    ``MESH_PAIR_STEPS`` minibatches' ratings over the whole catalog (PCRL's
    item batches over every item), held bit for bit (``full_width_pair``).
    Returns (accumulate_rows launches, fused_topk launches, the stats)."""
    import io

    import torch

    from cornac_tpu_torch.eval_methods.base_method import ranking_eval, rating_eval
    from cornac_tpu_torch.metrics import MAE, NDCG, RMSE, Precision, Recall
    from cornac_tpu_torch.models import MCF, PCRL, SoRec
    from cornac_tpu_torch.models import sorec as sorec_mod
    from cornac_tpu_torch.models.sorec import scaled_ratings, stream_tensors
    from cornac_tpu_torch.ops.rmsprop import rmsprop_stream_epoch, stream_order
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    ep_train, of_train = epinions.train_set, office.train_set

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    with timed_stream_epochs(sorec_mod, []) as stamps:
        sorec = clock(f"SoRec.fit, {SOREC_EPOCHS} epochs", lambda: SoRec(
            max_iter=SOREC_EPOCHS, **SOREC_EPINIONS).fit(ep_train))
    epoch_s = [b - a for a, b in zip(stamps[::2], stamps[1::2])]
    errors = clock("rating_eval (MAE, RMSE)", lambda: rating_eval(
        sorec, [MAE(), RMSE()], epinions.test_set)[0])
    mcf = clock(f"MCF.fit, {MCF_OFFICE['max_iter']} iterations", lambda: MCF(**MCF_OFFICE).fit(
        of_train))
    pcrl = clock(f"PCRL.fit, {PCRL_OFFICE['max_iter']} iterations", lambda: PCRL(
        **PCRL_OFFICE).fit(of_train))
    ranking = [Precision(k=10), Recall(k=10), NDCG(k=10)]
    quality = {name: clock(f"{name} ranking_eval (P@10, R@10, NDCG@10)", lambda: ranking_eval(
        m, ranking, of_train, office.test_set, rating_threshold=1.0)[0])
        for name, m in (("MCF", mcf), ("PCRL", pcrl))}
    rng = np.random.RandomState(18)
    relaxed = {}
    for name, m, train in (("SoRec", sorec, ep_train), ("MCF", mcf, of_train),
                           ("PCRL", pcrl, of_train)):
        users = rng.choice(train.num_users, SERVED_USERS, replace=False)
        relaxed[name] = clock(f"{name} recommend_batch {SERVED_USERS} users k={TOPK}",
                              lambda: serve_check(m, train, users, f"{name} recommend_batch"))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("SoRec at Epinions, MCF and PCRL at Amazon Office")
    if launches <= 0 or fused < 3:
        raise AssertionError(f"18b launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")

    # ---- check what came out ----
    with contextlib.redirect_stdout(io.StringIO()):
        again = clock(f"SoRec.fit, {SOREC_EPOCHS} epochs, again (verbose)", lambda: SoRec(
            max_iter=SOREC_EPOCHS, verbose=True, **SOREC_EPINIONS).fit(ep_train))
    for name in ("U", "V", "Z"):
        if not same_bits(getattr(sorec, name), getattr(again, name)):
            raise AssertionError(f"SoRec at Epinions: two seeded fits differ in {name}")
    for m in (sorec, mcf):
        if not all(np.isfinite(getattr(m, t)).all() for t in ("U", "V", "Z")):
            raise AssertionError(f"{m.name}: non-finite tables")
    if not (np.isfinite(pcrl.Theta).all() and np.isfinite(pcrl.Beta).all()):
        raise AssertionError("PCRL: non-finite Theta or Beta")
    n_trust = len(ep_train.user_graph.get_train_triplet(set(ep_train.uir_tuple[0]),
                                                        set(ep_train.uir_tuple[0]))[0])
    # SOREC_PROFILED_STEPS minibatches of the rating stream profiled, from
    # the fitted tables
    dev = torch.device(DEV)
    U, V = (torch.tensor(np.asarray(a, np.float32), device=dev) for a in (sorec.U, sorec.V))
    rid, iid, rat = ep_train.uir_tuple
    pairs, vals = stream_tensors(rid, iid, scaled_ratings(rat, sorec.min_rating,
                                                          sorec.max_rating), dev)
    perm, mask, bsz = stream_order(len(rat), SOREC_EPINIONS["batch_size"],
                                   np.random.RandomState(0), dev)
    perm, mask = perm[:SOREC_PROFILED_STEPS * bsz], mask[:SOREC_PROFILED_STEPS * bsz]
    lr, reg = SOREC_EPINIONS["learning_rate"], SOREC_EPINIONS["lambda_reg"]

    def some_steps():
        rmsprop_stream_epoch(U, V, torch.zeros_like(U), torch.zeros_like(V), perm, mask, pairs,
                             vals, lr, lr, reg, 0.9, bsz)

    some_steps()  # warm
    wall_ms, busy_ms, events_n, top = profile_call(some_steps)
    share = busy_ms / wall_ms if top else None
    per_step = events_n / SOREC_PROFILED_STEPS
    log(f"  SoRec k={SOREC_EPINIONS['k']} over {ep_train.num_ratings:,} ratings and {n_trust:,} "
        f"trust edges: epochs " + ", ".join(f"{s:.3f}" for s in epoch_s) + " s (host clock, "
        f"synchronised at both ends), "
        f"{-(-n_trust // 1024) + -(-ep_train.num_ratings // 1024):,} steps an epoch; "
        f"{SOREC_PROFILED_STEPS} rating-stream steps profiled: {wall_ms / SOREC_PROFILED_STEPS:.3f} "
        f"ms a step host clock, busy " + ("not measured" if share is None else f"{100 * share:.2f}%")
        + f", {per_step:.1f} device events a step; top device ops "
        f"{top_ops(top) if top else 'none seen'}; MAE {errors[0]:.6f}, RMSE {errors[1]:.6f}; two "
        f"seeded fits identical, bit for bit")
    for name in ("MCF", "PCRL"):
        fit_name = next(k for k in clock.seconds if k.startswith(f"{name}.fit"))
        log(f"  {name} at Amazon Office: {fit_name} {clock.seconds[fit_name]:.3f} s (host "
            f"clock); P@10 {quality[name][0]:.6f}, R@10 {quality[name][1]:.6f}, NDCG@10 "
            f"{quality[name][2]:.6f}")
    log(f"  recommend_batch ({SERVED_USERS} users each, k={TOPK}) equal to the plain version "
        f"(positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}, "
        f"accumulate_rows launches {launches}")
    pairs = {}
    for name, make, train, bsz in (
            ("SoRec", lambda **kw: SoRec(max_iter=1, **SOREC_EPINIONS, **kw), ep_train,
             SOREC_EPINIONS["batch_size"]),
            ("MCF", lambda **kw: MCF(**{**MCF_OFFICE, "max_iter": 1}, **kw), of_train, 1024),
            ("PCRL", lambda **kw: PCRL(**{**PCRL_OFFICE, "max_iter": 1}, **kw), of_train, 1024)):
        pair = full_width_pair(name, make, rating_prefix(train, MESH_PAIR_STEPS * bsz), mesh)
        launches += pair[0]
        pairs[name] = pair[1:]
    log(f"SoRec, MCF and PCRL on the published splits: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, dict(
        mesh_pairs=pairs, sorec_epoch_s=epoch_s, sorec_errors=errors, quality=quality,
        sorec_share=share,
        sorec_events=per_step, sorec_step_ms=wall_ms / SOREC_PROFILED_STEPS,
        mcf_s=clock.seconds[f"MCF.fit, {MCF_OFFICE['max_iter']} iterations"],
        pcrl_s=clock.seconds[f"PCRL.fit, {PCRL_OFFICE['max_iter']} iterations"])


def phase_clothing(seed, mesh):
    """Phase 18c, at the Amazon Clothing counts (seeded ratings, seeded
    4,096-wide features, a seeded corpus): AMR, CausalRec and VMF on
    RatioSplit(0.1, 0.5) with the image modality, DMRL on RatioSplit(0.2,
    0.5) with the text (TF-IDF over the corpus' count matrix) and image
    modalities, each at its example's settings with its epochs cut
    (``CLOTHING_MODELS``), through ``evaluate`` (fit and metric seconds);
    AMR serving 1,024 users through fused_topk, held to the plain version;
    each model fitted with the main process's mesh beside a plain fit, one
    epoch on the first ``MESH_PAIR_STEPS`` minibatches' ratings over the
    whole catalog, held bit for bit (``full_width_pair``). Returns
    (accumulate_rows launches, fused_topk launches, the stats)."""
    import torch

    import cornac_tpu_torch.metrics as pmetrics
    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import ImageModality, TextModality
    from cornac_tpu_torch.data.text import BaseTokenizer
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    ratings, feats, docs, ids = clock("Amazon-Clothing-like data (set-up)",
                                      lambda: clothing_like(seed + 19))
    visual = clock("RatioSplit(0.1) with ImageModality(normalized=True)", lambda: RatioSplit(
        ratings, test_size=0.1, rating_threshold=0.5, exclude_unknowns=True, seed=123,
        item_image=ImageModality(features=feats, ids=ids, normalized=True), verbose=False))
    textual = clock("RatioSplit(0.2) with the text and image modalities", lambda: RatioSplit(
        ratings, test_size=0.2, rating_threshold=0.5, exclude_unknowns=True, seed=123,
        item_text=TextModality(corpus=docs, ids=ids, tokenizer=BaseTokenizer(
            stop_words="english"), max_vocab=8000, max_doc_freq=0.5),
        item_image=ImageModality(features=feats, ids=ids, normalized=True), verbose=False))
    metric = {"AUC": pmetrics.AUC(), "Recall@50": pmetrics.Recall(k=50),
              "NDCG@50": pmetrics.NDCG(k=50), "RMSE": pmetrics.RMSE(),
              "Precision@10": pmetrics.Precision(k=10), "Recall@10": pmetrics.Recall(k=10),
              "NDCG@10": pmetrics.NDCG(k=10)}

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    results, fitted = {}, {}
    for name, (cls, kw, (arg, epochs, _), names) in CLOTHING_MODELS.items():
        split = textual if name == "DMRL" else visual
        model = getattr(models, cls)(seed=123, **{arg: epochs}, **kw)
        results[name] = clock(f"{name} evaluate", lambda: split.evaluate(
            model, [metric[m] for m in names], user_based=False)[0].metric_avg_results)
        fitted[name] = model
    users = np.random.RandomState(seed + 19).choice(visual.train_set.num_users, SERVED_USERS,
                                                    replace=False)
    relaxed = clock(f"AMR recommend_batch {SERVED_USERS} users k={TOPK}", lambda: serve_check(
        fitted["AMR"], visual.train_set, users, "AMR recommend_batch"))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the Clothing models")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"18c launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")
    for name, (_, _, (arg, epochs, full), names) in CLOTHING_MODELS.items():
        res = results[name]
        if not all(np.isfinite(res[m]) for m in names):
            raise AssertionError(f"{name} at Clothing: non-finite metrics {res}")
        log(f"  {name} ({arg} {epochs}, the example's {full}): fit {res['Train (s)']:.3f} s, "
            f"evaluation {res['Test (s)']:.3f} s (host clock); "
            + ", ".join(f"{m} {res[m]:.6f}" for m in names))
    text = textual.train_set.item_text
    log(f"  {visual.train_set.num_users:,} train users x {visual.train_set.num_items:,} items, "
        f"{visual.train_set.num_ratings:,} train ratings; DMRL's text: {text.count_matrix.shape[1]:,} "
        f"terms (TF-IDF over the count matrix); AMR's recommend_batch ({SERVED_USERS} users, "
        f"k={TOPK}) equal to the plain version (positions relaxed as near-ties: {relaxed}); "
        f"fused_topk launches {fused}, accumulate_rows launches {launches}")
    pairs = {}
    for name, (cls, kw, (arg, _, _), _) in CLOTHING_MODELS.items():
        train = (textual if name == "DMRL" else visual).train_set
        pair = full_width_pair(name, functools.partial(getattr(models, cls), seed=123,
                                                       **{arg: 1}, **kw),
                               rating_prefix(train, MESH_PAIR_STEPS * kw["batch_size"]), mesh)
        launches += pair[0]
        pairs[name] = pair[1:]
    log(f"the Clothing models: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, dict(mesh_pairs=pairs, results=results, seconds=dict(clock.seconds))


@contextlib.contextmanager
def fgsm_signs(record=None, replay=None):
    """While open, ``torch.sign`` (AMR's FGSM step, the only sign its epoch
    takes) appends (its input, its output) to ``record``, or returns the
    next of ``replay``'s outputs instead of its own (moved to the input's
    device) after appending its own pair to ``record``."""
    import torch

    real, count = torch.sign, [0]

    def sign(x):
        own = real(x)
        if record is not None:
            record.append((x.detach().cpu(), own.cpu()))
        if replay is None:
            return own
        count[0] += 1
        return replay[count[0] - 1][1].to(x.device)

    with swapped(torch, "sign", sign):
        yield record


def visual_witness(name, train, card=DEV):
    """One epoch of VBPR's or AMR's bench configuration on ``card`` and on
    the CPU from the same initial parameters and on the same draws, made on
    the CPU (``vbpr_draws`` from a CPU generator). AMR's FGSM step takes the
    sign of an inner gradient, and where that gradient is within rounding of
    0 the card and the CPU can take opposite signs (a step of 2 epsilon in
    a feature): the CPU's epoch replays the card's signs, and the entries
    where its own sign differs are returned with their size against the
    step's largest. Returns (steps, max |card - CPU| over the parameters,
    the signs that differ, the largest |inner gradient| among them over
    its step's largest)."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch import models
    from cornac_tpu_torch.models import vbpr as vbpr_mod
    from cornac_tpu_torch.ops.optim import adam

    model = make_model(models, name, 123)
    model.trainable = False
    model.fit(train)  # the initial parameters
    n, bsz = train.num_ratings, model.batch_size
    n_total = -(-n // bsz) * bsz
    draws = vbpr_mod.vbpr_draws(torch.Generator().manual_seed(123), n, n_total, train.num_items)
    hyper = (model.lambda_w, model.lambda_b, model.lambda_e, model._adv_lambda,
             model._adv_epsilon)
    feats = np.asarray(train.item_image.features[: model.total_items], np.float32)
    pairs = np.stack(train.uir_tuple[:2], axis=1).astype(np.int64)

    def epoch(dev):
        params = {t: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
                  for t, a in zip(vbpr_mod.TABLES, model._arrays())}
        opt = adam(model.learning_rate)
        vbpr_mod.vbpr_epoch(params, opt, opt.init(params), tuple(d.to(dev) for d in draws),
                            torch.as_tensor(pairs, device=dev), torch.as_tensor(feats, device=dev),
                            hyper, bsz, model._adversarial)
        return {t: p.detach().cpu() for t, p in params.items()}

    card_signs, cpu_signs = [], []
    with fgsm_signs(record=card_signs):
        on_card = epoch(card)
    with fgsm_signs(record=cpu_signs, replay=card_signs):
        on_cpu = epoch("cpu")
    flips, worst = 0, 0.0
    for (_, theirs), (g, own) in zip(card_signs, cpu_signs):
        differ = own != theirs
        flips += int(differ.sum())
        if differ.any():
            worst = max(worst, float(g.abs()[differ].max() / g.abs().max()))
    err = max((on_card[t] - on_cpu[t]).abs().max().item() for t in on_cpu)
    return n_total // bsz, err, flips, worst


def phase_side_bench(bench_data):
    """Process 12i, spawned: the side-information models at the bench shape
    (``make_ml100k_like(7)`` with ``seq_bench_data.side_modalities``: the
    seeded trust graph, 64-wide image-like features, their k-NN item graph,
    TF-IDF-like text), at ``tools/bpr_quality_band.py``'s ``SIDE_CONFIGS``:
    each model's AUC and NDCG@10 in the band of the JAX package's CPU fits
    over ten seeds (``tools/quality_bands.py::SIDE_BANDS``); SoRec's and
    MCF's tables held to the JAX fit's own (its first rows and column sums,
    ``SIDE_FINGERPRINTS``, within ``FINGERPRINT_TOL``); a second seeded fit
    of each bit for bit, whose accumulate_rows inputs are held to the plain
    version on the CPU; one VBPR and one AMR epoch on the CPU's draws, on the
    card within ``SIDE_WITNESS_TOL`` of the CPU's, which replays the card's
    FGSM signs, those that differ from its own at inner gradients within
    ``SIGN_FLIP_TOL`` of 0 (``visual_witness``).
    Returns (accumulate_rows launches, fit seconds, max |err|)."""
    import io

    import torch

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.metrics as pmetrics
    from bpr_quality_band import SIDE_CONFIGS, make_model, side_split
    from cornac_tpu_torch import models
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from quality_bands import FINGERPRINT_TOL, SIDE_FINGERPRINTS, side_band

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0) with the side modalities", lambda: side_split(
        pdata, peval, bench_data()))
    metrics = [pmetrics.AUC(), pmetrics.NDCG(k=10), pmetrics.Recall(k=10)]

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    results, fitted = {}, {}
    for name in SIDE_CONFIGS:
        model = make_model(models, name, 123)
        results[name] = clock(f"{name} evaluate", lambda: split.evaluate(
            model, metrics, user_based=False)[0].metric_avg_results)
        fitted[name] = model
    launches = ACCUMULATE_ROWS.launches
    clock.report("the side-information models at the bench shape")
    if launches <= 0:
        raise AssertionError("process 12i did not launch accumulate_rows")

    # ---- check what came out ----
    outside, fit_s = [], {}
    for name, res in results.items():
        fit_s[name] = res["Train (s)"]
        for metric in ("AUC", "NDCG@10"):
            lo, hi, _, _ = side_band(name, metric)
            inside = lo <= res[metric] <= hi
            log(f"  {name}: {metric} {res[metric]:.6f}, band [{lo:.6f}, {hi:.6f}] (10 JAX seeds) "
                f"{'inside' if inside else 'OUTSIDE'}; fit {fit_s[name]:.3f} s (host clock)")
            if not inside:
                outside.append(f"{name} {metric}")
    for name, tables in SIDE_FINGERPRINTS.items():
        for table, want in tables.items():
            got = np.asarray(getattr(fitted[name], table))
            rows = np.abs(got[:len(want["rows"])] - np.asarray(want["rows"])).max()
            sums = np.abs(got.sum(axis=0) - np.asarray(want["colsum"])).max()
            log(f"  {name}'s {table} against the JAX fit's: its first rows within {rows:.3e}, its "
                f"column sums within {sums:.3e} (held to {FINGERPRINT_TOL['rows']:g} and "
                f"{FINGERPRINT_TOL['colsum']:g})")
            if not (rows <= FINGERPRINT_TOL["rows"] and sums <= FINGERPRINT_TOL["colsum"]):
                raise AssertionError(f"{name}'s {table} differs from the JAX fit's")
    acc_err, recorded = 0.0, 0
    attrs = {"SoRec": ("U", "V", "Z"), "MCF": ("U", "V", "Z"), "VMF": ("U", "V", "P", "E"),
             "PCRL": ("Gs", "Gr", "Ls", "Lr"),
             "CausalRec": ("beta_item", "gamma_user", "gamma_item", "theta_user", "theta_item"),
             "DMRL": ()}
    for name, model in fitted.items():
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = make_model(models, name, 123)
            again.verbose = True
            again.fit(split.train_set)
        names = attrs.get(name, ("beta_item", "gamma_user", "gamma_item", "theta_user",
                                 "emb_matrix", "beta_prime"))
        for attr in names:
            if not same_bits(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr}")
        if name in ("DMRL", "PCRL"):
            for key, p in model.params.items():
                if not torch.equal(p, again.params[key]):
                    raise AssertionError(f"{name}: two seeded fits differ in {key}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    for name in ("VBPR", "AMR"):
        steps, err, flips, worst = clock(f"{name}'s epoch on the CPU's draws",
                                         lambda: visual_witness(name, split.train_set, DEV))
        log(f"  {name}, one epoch ({steps} steps) on the CPU's draws, on the card and on the CPU: "
            f"max |card - CPU| {err:.3e} over the parameters (held to {SIDE_WITNESS_TOL:g})"
            + (f"; the CPU replayed the card's FGSM signs, {flips} of which differ from its own, "
               f"at inner gradients of at most {worst:.3e} of their step's largest (held to "
               f"{SIGN_FLIP_TOL:g})" if name == "AMR" else ""))
        if not err <= SIDE_WITNESS_TOL:
            raise AssertionError(f"{name}'s epoch on the card differs from the CPU's on the same "
                                 f"draws by {err:.3e}")
        if not worst <= SIGN_FLIP_TOL:
            raise AssertionError(f"{name}: an FGSM sign differs at an inner gradient of {worst:.3e} "
                                 f"of its step's largest")
    if outside:
        raise AssertionError(f"outside their quality bands: {', '.join(outside)}")
    log(f"  every model: two seeded fits identical, bit for bit; accumulate_rows on their own "
        f"inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit (max "
        f"|err| {acc_err:.3e}); accumulate_rows launches {launches}")
    log(f"the side-information models at the bench shape: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


# ---------------------------------------------------------------------------
# the text and review models (phases 19, 19b, 19c and process 12j). Cornac's
# published Amazon Digital Music counts (cornac/datasets/README.md) and
# citeulike-a's (Wang & Blei, KDD 2011); the data are seeded, not the files
MUSIC_USERS, MUSIC_ITEMS, MUSIC_RATINGS = 5_541, 3_568, 64_706
CITEULIKE_USERS, CITEULIKE_ITEMS, CITEULIKE_PAIRS = 5_551, 16_980, 204_986
# examples/narre_example.py's and hrdr_example.py's settings, 1 of their 10
# epochs
REVIEW_MUSIC = dict(embedding_size=100, id_embedding_size=32, n_factors=32, attention_size=16,
                    n_filters=64, max_text_length=50, max_num_review=32, batch_size=64,
                    seed=123, verbose=False)
REVIEW_EPOCHS = 1
# the timed fits run over the first 1 / REVIEW_FIT_SHARE of the train
# ratings, cut for the run's time (the whole train set before)
REVIEW_FIT_SHARE = 2
REVIEW_TIMED_FROM = 100  # the steps after the first 100 are timed
REVIEW_PROFILED_STEPS = 5  # as 16b profiles 5: the profiler takes about 1 ms an event
# the four CiteULike examples' settings (cdl_example.py, cdr_example.py,
# cvae_example.py, ctr_example_citeulike.py), each with its depth cut: name
# -> (class, settings, (the depth's argument, the depth, the example's))
CITEULIKE_MODELS = {
    "CDL": ("CDL", dict(k=50, autoencoder_structure=[200], batch_size=128, lambda_u=0.1,
                        lambda_v=1, lambda_w=1e-4, lambda_n=1000, seed=123, verbose=False),
            ("max_iter", 1, 30)),
    "CDR": ("CDR", dict(k=50, autoencoder_structure=[200], batch_size=128, lambda_u=0.01,
                        lambda_v=0.1, lambda_w=1e-4, lambda_n=5, seed=123, verbose=False),
            ("max_iter", 1, 30)),
    "CVAE": ("CVAE", dict(z_dim=50, vae_layers=(200, 100), seed=123, verbose=False),
             ("n_epochs", 1, 30)),
    "CTR": ("CTR", dict(k=50, lambda_v=1, seed=123, verbose=False), ("max_iter", 1, 50)),
}
# cut for the run's time: CDL, CVAE and CTR from 2 to 1 iteration
# or epoch, CDR's fit over the first half of the train pairs (its epoch's
# minibatches are the pairs; the others' are the items)
CITEULIKE_HALVED = ("CDR",)
CITEULIKE_EVAL_USERS, CITEULIKE_EVAL_BUDGET_S = 2_048, 15.0
# conv_mf_example.py's and hft_example.py's settings on make_ml100k_like(7)
# with seeded plots (HFT's 40 iterations cut to 8: some 0.5 s an iteration on
# the card's host, the pair 20 s or more at the full depth)
PLOT_MODELS = {
    "ConvMF": ("ConvMF", dict(k=50, cnn_epochs=5, seed=123, verbose=False), ("n_epochs", 5, 5),
               8000, 4.0),
    "HFT": ("HFT", dict(k=10, grad_iter=5, l2_reg=0.001, lambda_text=0.01, vocab_size=5000,
                        seed=123, verbose=False), ("max_iter", 8, 40), 5000, 1.0),
}
TEXT_WITNESS_TOL = 1e-5  # max |card - float64 epoch| at least, as generative_witness
# review_witness: a step's gradient of a tensor on the card within
# REVIEW_GRAD_TOL of its largest |gradient| on the CPU, or of GRAD_FLOOR of
# the step's largest |gradient| of all where that is more: float32 sums in
# another order (two CPU thread counts differ by at most 5e-6 of a tensor's
# largest at the bench shape), and the tensors whose exact gradients are 0
# (the attention biases, and the item side's attention where an item's
# reviews are one document) hold rounding alone, some 1e-9 of the largest
REVIEW_GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3


def letter_words(n):
    """``n`` distinct letter-only tokens (the tokenizers strip digits), none
    an English stop word."""
    return np.array(["".join(chr(97 + (w // 26 ** j) % 26) for j in range(4)) + "q"
                     for w in range(n)])


def zipf_docs(rng, lengths, n_words, offset=30):
    """One document of ``lengths[j]`` tokens for each j, drawn in one draw
    over ``letter_words(n_words)`` with probability proportional to
    1 / (rank + ``offset``): a Zipf-Mandelbrot law whose commonest word is
    in under half the documents, so ``max_doc_freq=0.5`` drops none, and of
    whose tokens some 11-12% fall past the half of the words that a
    ``max_vocab`` of ``n_words`` / 2 keeps (unknown, as in real text)."""
    words = letter_words(n_words)
    p = 1.0 / (np.arange(1, n_words + 1) + offset)
    tokens = words[rng.choice(n_words, size=int(lengths.sum()), p=p / p.sum())]
    ends = np.cumsum(lengths)
    return [" ".join(tokens[e - n: e]) for e, n in zip(ends.tolist(), lengths.tolist())]


def digital_music_like(seed):
    """Seeded star ratings at the Amazon Digital Music counts over Zipf-like
    users and items (every one in a rating at least), skewed toward 4 and 5
    stars as Amazon's are, and one letter-only review a rating, 30-79
    tokens long (most past the examples' 50), over twice the 4,000 words
    the examples keep."""
    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, MUSIC_USERS, MUSIC_ITEMS, MUSIC_RATINGS, 0.6, 0.6)
    stars = rng.choice(np.arange(1, 6), len(users), p=[0.04, 0.04, 0.09, 0.23, 0.60])
    docs = zipf_docs(rng, rng.randint(30, 80, len(users)), 8_000)
    ratings = [(f"u{u}", f"i{i}", float(r))
               for u, i, r in zip(users.tolist(), items.tolist(), stars.tolist())]
    return ratings, [(u, i, doc) for (u, i, _), doc in zip(ratings, docs)]


def citeulike_like(seed):
    """Seeded binary pairs at citeulike-a's counts over mildly skewed users
    and items (the largest degrees in the hundreds, every one in a pair at
    least), and one letter-only abstract an item, 60-159 tokens long, over
    twice the 8,000 words the examples keep."""
    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, CITEULIKE_USERS, CITEULIKE_ITEMS, CITEULIKE_PAIRS, 0.3, 0.3)
    pairs = [(f"u{u}", f"i{i}", 1.0) for u, i in zip(users.tolist(), items.tolist())]
    docs = zipf_docs(rng, rng.randint(60, 160, CITEULIKE_ITEMS), 16_000)
    return pairs, docs, [f"i{i}" for i in range(CITEULIKE_ITEMS)]


def review_step_bound(model, n_params):
    """(FLOPs, bytes) of one review-model step as the port computes it: the
    text CNN's windows times the kernels in both towers, forward and the
    two products of its backward (3 x 2 x B R W ks E F each), and the bytes
    of Adam's dense update (28 B a parameter) and of the word gathers of
    both towers (B R L E floats read, their gradient rows written)."""
    B, R, L, E = model.batch_size, model.max_num_review, model.max_text_length, \
        model.embedding_size
    flops = sum(2 * 3 * 2.0 * B * R * (L - ks + 1) * ks * E * model.n_filters
                for ks in model.kernel_sizes)
    return flops, 28.0 * n_params + 2 * 2 * 4.0 * B * R * L * E


def phase_review_music(seed, mesh):
    """Phase 19b, NARRE and HRDR at the Amazon Digital Music counts
    (``examples/narre_example.py``'s and ``hrdr_example.py``'s split and
    settings; seeded ratings and reviews): RatioSplit(0.2) with
    ``ReviewModality(max_vocab=4000, max_doc_freq=0.5)``, the split timed on
    the host; a fit of ``REVIEW_EPOCHS`` epoch of each, its steps after the
    first 100 timed with CUDA events beside the bound of a step, its first
    step's word-table gradient held bit for bit to the plain version on the
    CPU and timed with the empty review slots dropped (as the fit runs it)
    and, for NARRE, sent into the padding row, ``REVIEW_PROFILED_STEPS``
    steps profiled on the fit's review packs (device events a step, busy
    share), peak device memory; MAE and RMSE over the test ratings, NDCG@10 over the
    test users; recommend_batch of 1,024 users at k = 100 through
    fused_topk, held to the plain version; then one mesh/plain pair of each
    on the world-size-1 ``mesh`` (``full_width_pair``: one epoch over the
    first ``MESH_PAIR_STEPS`` minibatches of ratings). Returns
    (accumulate_rows launches, fused_topk launches, the stats)."""
    import torch

    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import ReviewModality
    from cornac_tpu_torch.data.text import BaseTokenizer
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval, rating_eval
    from cornac_tpu_torch.metrics import MAE, NDCG, RMSE
    from cornac_tpu_torch.models import narre as narre_mod
    from cornac_tpu_torch.models.mf import _epoch_permutation
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK
    from cornac_tpu_torch.ops.optim import adam
    from cornac_tpu_torch.utils.checkpoint import epoch_generator

    clock = Clock()
    ratings, reviews = clock("Digital-Music-like ratings and reviews (set-up)",
                             lambda: digital_music_like(seed + 21))
    split = clock("RatioSplit(0.2) with ReviewModality(max_vocab=4000, max_doc_freq=0.5)",
                  lambda: RatioSplit(ratings, test_size=0.2, exclude_unknowns=True, seed=123,
                                     review_text=ReviewModality(
                                         data=reviews, tokenizer=BaseTokenizer(
                                             stop_words="english"),
                                         max_vocab=4000, max_doc_freq=0.5), verbose=False))
    del ratings, reviews
    train = split.train_set
    n, bsz = train.num_ratings, REVIEW_MUSIC["batch_size"]
    fit_set = clock(f"the first 1/{REVIEW_FIT_SHARE} of the train ratings (set-up)",
                    lambda: rating_prefix(train, n // REVIEW_FIT_SHARE))
    n_batches = -(-fit_set.num_ratings // bsz)
    users = np.random.RandomState(seed + 21).choice(train.num_users, SERVED_USERS,
                                                    replace=False)
    log(f"  {train.num_users:,} train users x {train.num_items:,} items, {n:,} train ratings "
        f"({n / train.num_users:.1f} a user, {n / train.num_items:.1f} an item); the fits over "
        f"the first {fit_set.num_ratings:,}, {n_batches:,} steps an epoch; vocabulary "
        f"{train.review_text.vocab.size:,} tokens")

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    fitted, stats = {}, {}
    for name in ("NARRE", "HRDR"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        first, packs = [], []
        with timed_calls(narre_mod, "step", REVIEW_TIMED_FROM, REVIEW_EPOCHS * n_batches,
                         {}) as timed, \
                recording_first_calls(first, 10), kept_review_packs(narre_mod, packs):
            model = clock(f"{name}.fit, {REVIEW_EPOCHS} epoch", lambda: getattr(models, name)(
                max_iter=REVIEW_EPOCHS, **REVIEW_MUSIC).fit(fit_set))
        peak = torch.cuda.max_memory_allocated() - held
        if timed["count"] != REVIEW_EPOCHS * n_batches:
            raise AssertionError(f"{name} took {timed['count']} steps, not "
                                 f"{REVIEW_EPOCHS * n_batches}")
        events = timed["events"]
        step_ms = events[0].elapsed_time(events[1]) / (REVIEW_EPOCHS * n_batches
                                                       - REVIEW_TIMED_FROM)
        errors = clock(f"{name} rating_eval (MAE, RMSE)", lambda: rating_eval(
            model, [MAE(), RMSE()], split.test_set)[0])
        ndcg = clock(f"{name} ranking_eval (NDCG@10)", lambda: ranking_eval(
            model, [NDCG(k=10)], train, split.test_set)[0][0])
        relaxed = clock(f"{name} recommend_batch {SERVED_USERS} users k={TOPK}",
                        lambda: serve_check(model, train, users, f"{name} recommend_batch"))
        fitted[name] = model
        stats[name] = dict(step_ms=step_ms, peak=peak, errors=errors, ndcg=ndcg,
                           relaxed=relaxed, first=first, packs=packs[-1],
                           epoch_s=clock.seconds[f"{name}.fit, {REVIEW_EPOCHS} epoch"])
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"19b launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")

    # ---- check and measure ----
    dev = torch.device(DEV)
    acc_err = 0.0
    for name, model in fitted.items():
        st = stats[name]
        for table in (model.P, model.Q, model.W1):
            if not np.isfinite(table).all():
                raise AssertionError(f"{name} at Digital Music: a non-finite factor")
        if not all(np.isfinite(st["errors"])) or not np.isfinite(st["ndcg"]):
            raise AssertionError(f"{name} at Digital Music: non-finite metrics")
        # the first step's word-table gradient (the largest call), as the fit
        # ran it (the empty slots dropped) and with them sent into row 0
        word = max(st["first"], key=lambda c: c[1].numel())
        table, ids, upd = word
        padded = torch.where((ids >= 0) & (ids < table.shape[0]), ids, 0)
        rows = []
        ways = (("dropped", word), ("into row 0", (table, padded, upd)))
        for label, call in ways if name == "NARRE" else ways[:1]:
            err, timed = clock(f"{name}'s word-table gradient, the empty slots {label}, held and "
                               f"timed", lambda: hold_and_time_calls(
                                   f"{name}'s word-table gradient, the empty slots {label}",
                                   [call]))
            acc_err, rows = max(acc_err, err), rows + timed
        if not torch.equal(accumulate_rows_of(word), accumulate_rows_of((table, padded, upd))):
            raise AssertionError(f"{name}: the empty slots change the word-table gradient")
        st["word_rows"] = rows
        st["empty_share"] = float((padded != ids).float().mean())
        del st["first"]
        # steps profiled on the fit's review packs, the fit's way (the empty
        # slots dropped; the calls timed above show what they would cost)
        params = {k: p.detach().clone().requires_grad_(True) for k, p in model.params.items()}
        t = st.pop("packs")
        gen = epoch_generator(seed, 0, dev)
        order = _epoch_permutation(REVIEW_PROFILED_STEPS * bsz, gen) % n
        uid, iid, rat = train.uir_tuple
        data = (torch.as_tensor(uid.astype(np.int64), device=dev),
                torch.as_tensor(iid.astype(np.int64), device=dev),
                torch.as_tensor(rat.astype(np.float32), device=dev))
        draws = [model.draws(gen, bsz) for _ in range(REVIEW_PROFILED_STEPS)]
        opt = adam(model.learning_rate)

        def some_steps():
            steps = iter(draws)
            model.epoch(params, opt, opt.init(params), t, order, data, lambda B: next(steps),
                        bsz)

        wall_ms, busy_ms, events_n, top = clock(
            f"{name}, {REVIEW_PROFILED_STEPS} steps profiled", lambda: profile_call(some_steps))
        st["profile"] = dict(step_ms=wall_ms / REVIEW_PROFILED_STEPS,
                             share=busy_ms / wall_ms if top else None,
                             busy_ms=busy_ms / REVIEW_PROFILED_STEPS,
                             events=events_n / REVIEW_PROFILED_STEPS,
                             top=top_ops(top) if top else "none seen")
        del params, t
        n_params = sum(p.numel() for p in model.params.values())
        flops, nbytes = review_step_bound(model, n_params)
        st["bound_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        st["bound_by"] = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        st["n_params"] = n_params
        a = st["profile"]
        log(f"  {name} at Digital Music: {st['epoch_s']:.3f} s an epoch (host clock, the fit's "
            f"set-up included), {st['step_ms']:.3f} ms a step (CUDA events over steps "
            f"{REVIEW_TIMED_FROM + 1}-{REVIEW_EPOCHS * n_batches}) against a "
            f"{st['bound_ms']:.4f} ms bound ({st['bound_by']}: {flops / 1e9:.2f} GFLOP of the "
            f"text CNN, {nbytes / 1e6:.1f} MB of Adam's {n_params:,} parameters and the word "
            f"gathers), {100 * st['bound_ms'] / st['step_ms']:.3f}% of it; "
            f"{REVIEW_PROFILED_STEPS} steps profiled with the empty slots dropped: "
            f"{a['step_ms']:.3f} ms a step host clock, busy "
            + ("not measured" if a["share"] is None else f"{100 * a['share']:.2f}%")
            + f" ({a['busy_ms']:.3f} ms of device time a step), {a['events']:.1f} device events "
            f"a step, top device ops {a['top']}; the word-table gradient of the first step "
            f"({100 * st['empty_share']:.1f}% of its ids in empty slots) "
            f"{st['word_rows'][0][1]:.4f} ms dropped"
            + (f", {st['word_rows'][1][1]:.4f} ms into row 0" if len(st["word_rows"]) > 1
               else "")
            + f", the same bits either way; peak device memory of the fit "
            f"{st['peak'] / 2**30:.3f} GiB")
        log(f"  {name}: MAE {st['errors'][0]:.6f}, RMSE {st['errors'][1]:.6f}, NDCG@10 "
            f"{st['ndcg']:.6f} (no band at this size); recommend_batch ({SERVED_USERS} users, "
            f"k={TOPK}) equal to the plain version (positions relaxed as near-ties: "
            f"{st['relaxed']})")
    clock.report("NARRE and HRDR at Digital Music")
    log(f"  fused_topk launches {fused}, accumulate_rows launches {launches}")
    pairs = {}
    prefix = rating_prefix(train, MESH_PAIR_STEPS * bsz)
    for name in ("NARRE", "HRDR"):
        pair = full_width_pair(name, functools.partial(getattr(models, name), max_iter=1,
                                                       **REVIEW_MUSIC), prefix, mesh)
        launches += pair[0]
        pairs[name] = pair[1:]
    log(f"NARRE and HRDR at Digital Music: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, dict(stats=stats, max_abs_err=acc_err, seconds=dict(clock.seconds),
                                 mesh_pairs=pairs)


@contextlib.contextmanager
def kept_review_packs(module, store):
    """While open, the review packs a review model's fit builds
    (``ReviewRegressor._reviews``: the dict of review tensors on the card,
    which HRDR's fit then gives its rating rows) are appended to
    ``store``."""
    real = module.ReviewRegressor._reviews

    def keep(self, train_set, dev):
        store.append(real(self, train_set, dev))
        return store[-1]

    with swapped(module.ReviewRegressor, "_reviews", keep):
        yield store


def accumulate_rows_of(call):
    """The kernel's result of one recorded accumulate_rows call, on a copy
    of its table."""
    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    table, ids, upd = call
    return accumulate_rows(table.clone(), ids, upd)


def evaluate_in_budget(model, metrics, train, test, threshold, clock, what,
                       head=CITEULIKE_EVAL_USERS):
    """ranking_eval of ``metrics`` over the first ``head`` test users, and
    over the others too while all would take ``CITEULIKE_EVAL_BUDGET_S`` or
    less. Returns (the mean of each metric, the users evaluated, the test
    users)."""
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval

    test_users = np.unique(test.uir_tuple[0])
    head, rest = test_users[:head], test_users[head:]
    label = f"{what} ranking_eval, the first {len(head):,} test users"
    per_user = clock(label, lambda: ranking_eval(model, metrics, train, ratings_subset(
        test, head), rating_threshold=threshold)[1])
    if len(rest) and clock.seconds[label] * len(test_users) / len(head) \
            <= CITEULIKE_EVAL_BUDGET_S:
        more = clock(f"{what} ranking_eval, the other {len(rest):,} test users",
                     lambda: ranking_eval(model, metrics, train, ratings_subset(test, rest),
                                          rating_threshold=threshold)[1])
        per_user = [{**a, **b} for a, b in zip(per_user, more)]
    return [sum(d.values()) / len(d) for d in per_user], len(per_user[0]), len(test_users)


def phase_citeulike(seed, mesh):
    """Phase 19, CDL, CDR, CVAE and CTR at citeulike-a's counts (the four
    CiteULike examples' split and settings; seeded pairs and abstracts):
    RatioSplit(0.2, 0.5) with ``TextModality(max_vocab=8000,
    max_doc_freq=0.5)``, the split timed on the host; each model fitted at
    its cut depth (``CITEULIKE_MODELS``; ``CITEULIKE_HALVED``'s on the first
    half of the train pairs), timed, peak device memory; NDCG@100
    and Recall@300 over the test users (``evaluate_in_budget``); each
    serving 1,024 users at k = 100 through fused_topk, held to the plain
    version; then one mesh/plain pair of each on the world-size-1 ``mesh``
    (``full_width_pair``: one epoch or iteration over the first
    ``MESH_PAIR_STEPS`` minibatches of ratings and the whole catalog).
    Returns (accumulate_rows launches, fused_topk launches, the stats)."""
    import torch

    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import TextModality
    from cornac_tpu_torch.data.text import BaseTokenizer
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import NDCG, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    pairs, docs, ids = clock("citeulike-a-like pairs and abstracts (set-up)",
                             lambda: citeulike_like(seed + 20))
    split = clock("RatioSplit(0.2, 0.5) with TextModality(max_vocab=8000, max_doc_freq=0.5)",
                  lambda: RatioSplit(pairs, test_size=0.2, rating_threshold=0.5,
                                     exclude_unknowns=True, seed=123, verbose=False,
                                     item_text=TextModality(
                                         corpus=docs, ids=ids, tokenizer=BaseTokenizer(
                                             stop_words="english"),
                                         max_vocab=8000, max_doc_freq=0.5)))
    del pairs, docs
    train = split.train_set
    degrees = (np.diff(train.matrix.indptr).max(), np.diff(train.matrix.tocsc().indptr).max())
    log(f"  {train.num_users:,} train users x {train.num_items:,} items, {train.num_ratings:,} "
        f"train pairs, the largest degrees {degrees[0]} (a user) and {degrees[1]} (an item); "
        f"{train.item_text.count_matrix.shape[1]:,} terms")
    users = np.random.RandomState(seed + 20).choice(train.num_users, SERVED_USERS,
                                                    replace=False)
    metrics = [NDCG(k=100), Recall(k=300)]
    half = clock("the first half of the train pairs (set-up)",
                 lambda: rating_prefix(train, train.num_ratings // 2))

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    stats = {}
    for name, (cls, kw, (arg, depth, full)) in CITEULIKE_MODELS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        label = f"{name}.fit, {arg} {depth}"
        fit_set = half if name in CITEULIKE_HALVED else train
        model = clock(label, lambda: getattr(models, cls)(**{arg: depth}, **kw).fit(fit_set))
        peak = torch.cuda.max_memory_allocated() - held
        quality, evaluated, n_test = evaluate_in_budget(model, metrics, train, split.test_set,
                                                        0.5, clock, name)
        relaxed = clock(f"{name} recommend_batch {SERVED_USERS} users k={TOPK}",
                        lambda: serve_check(model, train, users, f"{name} recommend_batch"))
        if not (np.isfinite(model.U).all() and np.isfinite(model.V).all()
                and np.isfinite(quality).all()):
            raise AssertionError(f"{name} at CiteULike: non-finite factors or metrics")
        stats[name] = dict(fit_s=clock.seconds[label], peak=peak, quality=quality,
                           evaluated=evaluated, relaxed=relaxed)
        log(f"  {name} ({arg} {depth}, the example's {full}"
            + (", the first half of the train pairs" if name in CITEULIKE_HALVED else "")
            + f"): fit {clock.seconds[label]:.3f} s "
            f"(host clock), peak device memory {peak / 2**30:.3f} GiB; NDCG@100 {quality[0]:.6f}, "
            f"Recall@300 {quality[1]:.6f} over {evaluated:,} of {n_test:,} test users (no band "
            f"at this size); recommend_batch ({SERVED_USERS} users, k={TOPK}) equal to the plain "
            f"version (positions relaxed as near-ties: {relaxed})")
        del model
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the CiteULike models")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"19 launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")
    log(f"  fused_topk launches {fused}, accumulate_rows launches {launches}")
    pairs = {}
    prefix = rating_prefix(train, MESH_PAIR_STEPS * 128)
    for name, (cls, kw, (arg, _, _)) in CITEULIKE_MODELS.items():
        pair = full_width_pair(name, functools.partial(getattr(models, cls), **{**kw, arg: 1}),
                               prefix, mesh)
        launches += pair[0]
        pairs[name] = pair[1:]
    log(f"the CiteULike models: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, dict(stats=stats, seconds=dict(clock.seconds), mesh_pairs=pairs)


def phase_plots(bench_data, seed, mesh):
    """Phase 19c, ConvMF and HFT at ``conv_mf_example.py``'s and
    ``hft_example.py``'s settings on ``make_ml100k_like(7)`` (built already)
    with seeded plots for its 1,682 items (``PLOT_MODELS``; HFT's
    iterations cut): each through ``evaluate`` on its example's RatioSplit
    (RMSE, Precision@10, Recall@10, NDCG@10 for ConvMF; MAE, RMSE for HFT),
    fit seconds; the first CNN step's embedding gradient held bit for bit to
    the plain version on the CPU and timed; HFT serving every train user (at
    most 1,024) at k = 100 through fused_topk, held to the plain version;
    then one ConvMF mesh/plain pair on the world-size-1 ``mesh``
    (``full_width_pair``: one epoch of ALS and one of the CNN on its
    split's train set; HFT takes no mesh, as in the JAX package). Returns
    (accumulate_rows launches, fused_topk launches, the stats)."""
    import torch

    import cornac_tpu_torch.metrics as pmetrics
    from cornac_tpu_torch import models
    from cornac_tpu_torch.data import TextModality
    from cornac_tpu_torch.data.text import BaseTokenizer
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    triples = bench_data()
    rng = np.random.RandomState(seed + 22)
    plots = clock("seeded plots (set-up)", lambda: zipf_docs(rng, rng.randint(40, 200, 1_682),
                                                             12_000))
    ids = [f"i{i}" for i in range(1_682)]
    names = {"ConvMF": ("RMSE", "Precision@10", "Recall@10", "NDCG@10"), "HFT": ("MAE", "RMSE")}
    metric = {"RMSE": pmetrics.RMSE(), "MAE": pmetrics.MAE(),
              "Precision@10": pmetrics.Precision(k=10), "Recall@10": pmetrics.Recall(k=10),
              "NDCG@10": pmetrics.NDCG(k=10)}

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    results, fitted, first = {}, {}, []
    for name, (cls, kw, (arg, depth, full), vocab, threshold) in PLOT_MODELS.items():
        split = clock(f"{name}'s RatioSplit with TextModality(max_vocab={vocab})",
                      lambda: RatioSplit(triples, test_size=0.2, rating_threshold=threshold,
                                         exclude_unknowns=True, seed=123, verbose=False,
                                         item_text=TextModality(
                                             corpus=plots, ids=ids, tokenizer=BaseTokenizer(
                                                 stop_words="english"),
                                             max_vocab=vocab, max_doc_freq=0.5)))
        model = getattr(models, cls)(**{arg: depth}, **kw)
        with recording_first_calls(first if name == "ConvMF" else [], 1):
            results[name] = clock(f"{name} evaluate", lambda: split.evaluate(
                model, [metric[m] for m in names[name]], user_based=False)[0].metric_avg_results)
        fitted[name] = (model, split)
    model, split = fitted["HFT"]
    n_users = split.train_set.num_users
    users = np.random.RandomState(seed + 22).choice(n_users, min(SERVED_USERS, n_users),
                                                    replace=False)
    relaxed = clock(f"HFT recommend_batch {len(users)} users k={TOPK}", lambda: serve_check(
        model, split.train_set, users, "HFT recommend_batch"))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("ConvMF and HFT on ML-100K plots")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"19c launched accumulate_rows {launches} and fused_topk {fused} "
                             f"times")
    for name, (cls, kw, (arg, depth, full), _, _) in PLOT_MODELS.items():
        res = results[name]
        if not all(np.isfinite(res[m]) for m in names[name]):
            raise AssertionError(f"{name} on ML-100K plots: non-finite metrics {res}")
        log(f"  {name} ({arg} {depth}, the example's {full}): fit {res['Train (s)']:.3f} s, "
            f"evaluation {res['Test (s)']:.3f} s (host clock); "
            + ", ".join(f"{m} {res[m]:.6f}" for m in names[name]))
    err, rows = hold_and_time_calls("ConvMF's embedding gradient, the first CNN step", first)
    log(f"  HFT's recommend_batch ({len(users)} users, k={TOPK}) equal to the plain version "
        f"(positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}, "
        f"accumulate_rows launches {launches}")
    cls, kw = PLOT_MODELS["ConvMF"][:2]
    pair = full_width_pair("ConvMF", functools.partial(getattr(models, cls), **{
        **kw, "n_epochs": 1, "cnn_epochs": 1}), fitted["ConvMF"][1].train_set, mesh,
        "one epoch and one CNN epoch on the train set")
    launches += pair[0]
    log(f"ConvMF and HFT on ML-100K plots: ok in {sum(clock.seconds.values()):.1f} s")
    return launches, fused, dict(results=results, embedding_rows=rows, max_abs_err=err,
                                 seconds=dict(clock.seconds), mesh_pairs={"ConvMF": pair[1:]})


def review_witness(name, train, card=DEV):
    """One epoch of NARRE's or HRDR's bench configuration on the CPU, on
    draws made there (the order, the dropout masks), each step's loss and
    gradients computed again on ``card`` from the CPU's parameters of that
    step (the CPU's trajectory leads). A whole float32 epoch of these models
    is no witness: a discrete event (a ReLU or a max-pool position switching
    at a near-tie) carries one run of float32 rounding 1e-2 from the float64
    epoch where another stays within 1e-5 (PERF.md), on the card or on
    the CPU alike. Returns (steps, (the largest |card - CPU| over a step's
    gradient of a tensor, over the larger of that tensor's largest |gradient|
    and ``GRAD_FLOOR`` of the step's largest of all, the tensor's name), the
    largest |card - CPU| over the steps' losses)."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch import models
    from cornac_tpu_torch.models.mf import _epoch_permutation
    from cornac_tpu_torch.ops.optim import adam, apply_updates

    model = make_model(models, name, 123)
    model.trainable = False
    model.fit(train)  # the train statistics
    model._vocab = train.review_text.vocab
    gen = torch.Generator().manual_seed(123)
    rid, cid, rat = train.uir_tuple
    n, bsz = len(rid), min(model.batch_size, len(rid))
    order = _epoch_permutation(n + (-n) % bsz, gen) % n
    params = {k: torch.tensor(np.asarray(a), requires_grad=True)
              for k, a in model._init_all(np.random.RandomState(123), model._vocab.size).items()}
    data = {dev: (torch.as_tensor(rid.astype(np.int64), device=dev),
                  torch.as_tensor(cid.astype(np.int64), device=dev),
                  torch.as_tensor(rat.astype(np.float32), device=dev)) for dev in ("cpu", card)}
    packs = {"cpu": model._tensors(train, "cpu")}
    packs[card] = {k: v.to(card) for k, v in packs["cpu"].items()}
    opt = adam(model.learning_rate)
    state = opt.init(params)
    worst, loss_err = (0.0, None), 0.0
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside phase 16's host-bound steps
    try:
        for s in range(0, order.shape[0], bsz):
            masks = model.draws(gen, bsz)
            grads = {}
            for dev in ("cpu", card):
                p = params if dev == "cpu" else {k: v.detach().to(card).requires_grad_(True)
                                                 for k, v in params.items()}
                users, items, values = (a[order[s: s + bsz].to(dev)] for a in data[dev])
                loss = model.loss_on(p, packs[dev], users, items, values,
                                     tuple(m.to(dev) for m in masks))
                grads[dev] = (float(loss), dict(zip(p, (g.cpu() for g in torch.autograd.grad(
                    loss, list(p.values()), materialize_grads=True)))))
            (cpu_loss, g_cpu), (card_loss, g_card) = grads["cpu"], grads[card]
            loss_err = max(loss_err, abs(card_loss - cpu_loss))
            scale = max(g.abs().max().item() for g in g_cpu.values())
            for k, g in g_cpu.items():
                err = ((g_card[k] - g).abs().max().item()
                       / max(g.abs().max().item(), GRAD_FLOOR * scale))
                if err > worst[0]:
                    worst = (err, k)
            updates, state = opt.update(g_cpu, state, params)
            apply_updates(params, updates)
    finally:
        torch.set_num_threads(threads)
    return order.shape[0] // bsz, worst, loss_err


def text_witness(name, train, card=DEV):
    """One epoch of CDL's or CDR's bench configuration on ``card``, on the
    CPU and on the CPU in float64, from the same initial parameters and on
    the same draws, all made on the CPU (the order, the corruption masks;
    CDR's positives and negatives). The CPU's float32 epoch's distance from
    the float64 one is how far float32 rounding alone carries a parameter.
    Returns (steps, the card's parameters, the CPU's, the CPU's float64
    epoch's), each {name: float64 tensor on the CPU}."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch import models
    from cornac_tpu_torch.engine.nn import ACTIVATIONS
    from cornac_tpu_torch.models import cdl as cdl_mod, cvae as cvae_mod
    from cornac_tpu_torch.models.mf import _epoch_permutation
    from cornac_tpu_torch.ops.membership import build_membership
    from cornac_tpu_torch.ops.optim import adam

    model = make_model(models, name, 123)
    model.trainable = False
    model.fit(train)  # the train statistics (and CDL's and CDR's U and V)
    gen = torch.Generator().manual_seed(123)
    rid, cid, rat = train.uir_tuple
    n = len(rid)

    def out(params):
        return {k: p.detach().cpu().double() for k, p in params.items()}

    text = cdl_mod.minmax_text(train, model.num_items)
    rng = np.random.RandomState(123)
    init = {"U": model.U, "V": model.V, **model._initial(rng, text.shape[1])}
    act = ACTIVATIONS[model.act_fn]
    lambdas = (model.lambda_u, model.lambda_v, model.lambda_w, model.lambda_n)
    keep = 1.0 - model.corruption_rate
    if name == "CDL":
        bsz = min(model.batch_size, model.num_items)
        order = _epoch_permutation(model.num_items + (-model.num_items) % bsz,
                                   gen) % model.num_items
        R_t = np.asarray(train.csc_matrix.T.todense(), np.float32)
        C_t = np.where(R_t != 0, model.a, model.b).astype(np.float32)
    else:
        bsz = min(model.batch_size, n)
        draws = cvae_mod.cdr_draws(gen, n, -(-n // bsz) * bsz, model.num_items)
        order = draws[0]
    masks = [(torch.rand((bsz, text.shape[1]), generator=gen) < keep).to(torch.float32)
             for _ in range(len(order) // bsz)]

    def epoch(dev, dtype):
        params = {k: torch.tensor(np.asarray(a), dtype=dtype, device=dev, requires_grad=True)
                  for k, a in init.items()}
        text_d = torch.as_tensor(text, dtype=dtype, device=dev)
        steps = iter(masks)

        def step_draws(shape):
            return next(steps).to(dev, dtype)

        if name == "CDL":
            uv = {k: params.pop(k) for k in ("U", "V")}
            opts = (adam(model.learning_rate), adam(model.learning_rate))
            data = (text_d, torch.as_tensor(R_t, dtype=dtype, device=dev),
                    torch.as_tensor(C_t, dtype=dtype, device=dev))
            cdl_mod.cdl_epoch(uv, params, opts, (opts[0].init(uv), opts[1].init(params)),
                              order.to(dev), data, step_draws, bsz, act, lambdas)
            params.update(uv)
        else:
            opt = adam(model.learning_rate)
            data = (text_d, torch.as_tensor(np.stack([rid, cid], 1).astype(np.int64),
                                            device=dev),
                    build_membership(train.csr_matrix, device=dev))
            cvae_mod.cdr_epoch(params, opt, opt.init(params),
                               tuple(d.to(dev) for d in draws), data, step_draws, bsz, act,
                               lambdas)
        return out(params)

    steps = len(masks)
    on_card = epoch(card, torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside phase 16's host-bound steps
    try:
        return steps, on_card, epoch("cpu", torch.float32), epoch("cpu", torch.float64)
    finally:
        torch.set_num_threads(threads)


def phase_text_bench(bench_data):
    """Process 12j, spawned: the text and review models at the bench shape
    (``make_ml100k_like(7)`` with ``seq_bench_data.text_modalities``: a
    seeded document an item, a seeded review a rating), at
    ``tools/bpr_quality_band.py``'s ``TEXT_CONFIGS``: each model's AUC and
    NDCG@10 (NARRE's and HRDR's RMSE too) in the band of the JAX package's
    CPU fits over ten seeds (``tools/quality_bands.py::TEXT_BANDS``);
    ConvMF's, CTR's and HFT's tables held to the JAX fit's own (their first
    rows and column sums, ``TEXT_FINGERPRINTS``, within
    ``TEXT_FINGERPRINT_TOL``); a second seeded fit of each bit for bit,
    whose accumulate_rows inputs are held to the plain version on the CPU;
    one CDL and CDR epoch on the CPU's draws, on the card within twice the
    CPU float32 epoch's distance from the float64 epoch (``text_witness``);
    one NARRE and HRDR epoch on the CPU, each step's gradients computed again
    on the card from the CPU's parameters, within ``REVIEW_GRAD_TOL`` of
    each tensor's largest (``review_witness``). Returns (accumulate_rows
    launches, fit seconds, max |err|)."""
    import io

    import torch

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.metrics as pmetrics
    from bpr_quality_band import REVIEW_MODELS, TEXT_CONFIGS, make_model, text_split
    from cornac_tpu_torch import models
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from quality_bands import TEXT_FINGERPRINT_TOL, TEXT_FINGERPRINTS, text_band

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0) with the item texts and the reviews", lambda: text_split(
        pdata, peval, bench_data()))
    base = [pmetrics.AUC(), pmetrics.NDCG(k=10), pmetrics.Recall(k=10)]

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    results, fitted = {}, {}
    for name in TEXT_CONFIGS:
        model = make_model(models, name, 123)
        metrics = base + ([pmetrics.RMSE()] if name in REVIEW_MODELS else [])
        results[name] = clock(f"{name} evaluate", lambda: split.evaluate(
            model, metrics, user_based=False)[0].metric_avg_results)
        fitted[name] = model
    launches = ACCUMULATE_ROWS.launches
    clock.report("the text and review models at the bench shape")
    if launches <= 0:
        raise AssertionError("process 12j did not launch accumulate_rows")

    # ---- check what came out ----
    outside, fit_s = [], {}
    for name, res in results.items():
        fit_s[name] = res["Train (s)"]
        for metric in ("AUC", "NDCG@10") + (("RMSE",) if name in REVIEW_MODELS else ()):
            lo, hi, _, _ = text_band(name, metric)
            inside = lo <= res[metric] <= hi
            log(f"  {name}: {metric} {res[metric]:.6f}, band [{lo:.6f}, {hi:.6f}] (10 JAX seeds) "
                f"{'inside' if inside else 'OUTSIDE'}; fit {fit_s[name]:.3f} s (host clock)")
            if not inside:
                outside.append(f"{name} {metric}")
    for name, tables in TEXT_FINGERPRINTS.items():
        tol = TEXT_FINGERPRINT_TOL[name]
        for table, want in tables.items():
            got = np.asarray(getattr(fitted[name], table), np.float64)
            rows = np.abs(got[:len(want["rows"])] - np.asarray(want["rows"])).max()
            sums = np.abs(got.sum(axis=0) - np.asarray(want["colsum"])).max()
            log(f"  {name}'s {table} against the JAX fit's: its first rows within {rows:.3e}, its "
                f"column sums within {sums:.3e} (held to {tol['rows']:g} and {tol['colsum']:g})")
            if not (rows <= tol["rows"] and sums <= tol["colsum"]):
                raise AssertionError(f"{name}'s {table} differs from the JAX fit's")
    acc_err, recorded = 0.0, 0
    attrs = {"NARRE": ("P", "Q"), "HRDR": ("P", "Q"), "ConvMF": ("U", "V", "theta"),
             "HFT": ("gamma_u", "gamma_i", "beta_u", "beta_i")}
    for name, model in fitted.items():
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = make_model(models, name, 123)
            again.verbose = True
            again.fit(split.train_set)
        for attr in attrs.get(name, ("U", "V")):
            if not same_bits(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr}")
        for group in ("params", "sdae", "vae", "cnn"):
            for key, p in getattr(model, group, {}).items():
                if not torch.equal(p, getattr(again, group)[key]):
                    raise AssertionError(f"{name}: two seeded fits differ in {key}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    for name in ("NARRE", "HRDR"):
        steps, (err, where), loss_err = clock(
            f"{name}'s epoch on the CPU, each step's gradients on the card",
            lambda: review_witness(name, split.train_set, DEV))
        log(f"  {name}, one epoch ({steps} steps) on the CPU's draws, each step's loss and gradients "
            f"computed again on the card from the CPU's parameters: the largest |card - CPU| of a "
            f"tensor's gradient {err:.3e} of its largest |gradient| (or of {GRAD_FLOOR:g} of the "
            f"step's largest, where more; {where}; held to {REVIEW_GRAD_TOL:g}), of the losses "
            f"{loss_err:.3e}")
        if not err <= REVIEW_GRAD_TOL:
            raise AssertionError(f"{name}'s gradients on the card differ from the CPU's: {where} "
                                 f"by {err:.3e} of its largest")
    for name in ("CDL", "CDR"):
        steps, card, cpu, exact = clock(f"{name}'s epoch on the CPU's draws",
                                        lambda: text_witness(name, split.train_set, DEV))
        to_cpu = max((card[k] - cpu[k]).abs().max().item() for k in cpu)
        reach = max((cpu[k] - exact[k]).abs().max().item() for k in cpu)
        off = max((card[k] - exact[k]).abs().max().item() for k in card)
        tol = max(TEXT_WITNESS_TOL, 2 * reach)
        log(f"  {name}, one epoch ({steps} steps) on the CPU's draws: max |card - float64 epoch| "
            f"{off:.3e}, held to twice the CPU float32 epoch's own distance from it, {reach:.3e} "
            f"(at least {TEXT_WITNESS_TOL:g}); max |card - CPU| {to_cpu:.3e}")
        if not off <= tol:
            raise AssertionError(f"{name}'s epoch on the card lies {off:.3e} from the float64 "
                                 f"epoch, the CPU's float32 epoch {reach:.3e}")
    if outside:
        raise AssertionError(f"outside their quality bands: {', '.join(outside)}")
    log(f"  every model: two seeded fits identical, bit for bit; accumulate_rows on their own "
        f"inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit (max "
        f"|err| {acc_err:.3e}); accumulate_rows launches {launches}")
    log(f"the text and review models at the bench shape: ok in "
        f"{sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


# ---------------------------------------------------------------------------
# the sentiment and explainable models (phase 20 and process 12k): the six
# Amazon Toys & Games examples' settings (efm_example.py, comparer_example.py,
# mter_example.py, lrppm_example.py, companion_example.py,
# trirank_example.py) and HypAR's defaults: name -> (class, settings, (the
# depth's argument, the depth run, the example's) or None where the example
# runs whole)
# HypAR's steps: its defaults' epoch has about 1,113, some 280 ms each on
# an H100 (its hyperedge scatters' long runs into the aspect and opinion
# nodes: PERF.md section 5), so a run of the phase within its time takes 12
HYPAR_STEPS = 12
TOYS_MODELS = {
    "EFM": ("EFM", dict(num_explicit_factors=40, num_latent_factors=60, num_most_cared_aspects=15,
                        rating_scale=5.0, alpha=0.85, max_iter=100, seed=123), None),
    # at all users its comparative pair stream (tens of millions of
    # (pair, aspect) entries, summed in order into 200 aspect rows) takes
    # some 0.25-1.4 s an iteration: 5 of the example's 100
    "ComparERObj": ("ComparERObj", dict(num_explicit_factors=40, num_latent_factors=60,
                                        seed=123), ("max_iter", 5, 100)),
    "MTER": ("MTER", dict(n_user_factors=15, n_item_factors=15, n_aspect_factors=12,
                          n_opinion_factors=12, n_bpr_samples=1000, n_element_samples=50,
                          lambda_reg=0.1, lambda_bpr=10, lr=0.1, seed=123),
             ("max_iter", 150, 10_000)),
    "ComparERSub": ("ComparERSub", dict(n_user_factors=8, n_item_factors=8, n_aspect_factors=8,
                                        lr=0.1, seed=123), ("max_iter", 150, 200_000)),
    "LRPPM": ("LRPPM", dict(n_factors=8, ld=1.0, reg=0.01, alpha=1.0, n_samples=200,
                            n_ranking_samples=1000, lr=0.1, seed=123), ("max_iter", 150, 20_000)),
    "Companion": ("Companion", dict(n_user_factors=8, n_item_factors=8, n_aspect_factors=8,
                                    n_opinion_factors=8, n_element_samples=50, n_bpr_samples=1000,
                                    n_aspect_ranking_samples=1000,
                                    n_opinion_ranking_samples=1000, lr=0.5, seed=123),
                  ("max_iter", 150, 500_000)),
    "TriRank": ("TriRank", dict(max_iter=100, seed=123, verbose=False), None),
    "HypAR": ("HypAR", dict(num_epochs=1, seed=123, verbose=False),
              ("steps", HYPAR_STEPS, "10 epochs")),
}
TOYS_RATING = ("EFM", "ComparERObj", "MTER", "ComparERSub", "LRPPM", "Companion")  # and RMSE
# the iteration (or step) functions probed: name -> (module, function,
# probe at the call's start)
TOYS_PROBED = {"MTER": ("mter", "mter_iteration", False),
               "ComparERSub": ("mter", "mter_iteration", False),
               "LRPPM": ("lrppm", "lrppm_iteration", False),
               "Companion": ("companion", "companion_iteration", False)}
SAMPLED_TIMED = (50, 130)  # CUDA events after iterations 50 and 130
HYPAR_TIMED = (3, 9)  # before steps 3 and 9
TOYS_PROFILED = 3  # iterations profiled after the timed ones
HYPAR_PROFILED = 2  # HypAR's steps profiled (some 600 device events each)
TOYS_EVAL_USERS = 500  # the test users evaluated (13,341 in all)
# the main path's accumulate_rows inputs that phase 20 records, holds and
# hands to the times phase: (model, call from 0 in its recording) -> label
TOYS_RECORDED = {
    ("HypAR", 0): "HypAR, Amazon Toys, first step's hyperedge scatter into review rows",
    ("HypAR", 1): "HypAR, Amazon Toys, first step's hyperedge scatter into node rows",
    ("Companion", 0): "Companion, Amazon Toys, first item-table update (every stream)",
}
TOYS_HOST_BUILDS = (("EFM", "_build_matrices"), ("ComparERObj", "_build_matrices"),
                    ("ComparERObj", "_build_pairs"), ("MTER", "_build_data"),
                    ("ComparERSub", "_build_data"), ("ComparERSub", "_build_sub_pairs"),
                    ("LRPPM", "_build_data"), ("Companion", "_build_data"),
                    ("Companion", "_host_streams"), ("TriRank", "_create_matrices"),
                    ("HypAR", "_create_graphs"), ("HypAR", "_ao_content_embeddings"))


# the host builds of the sentiment models that take a mesh, which a pair's
# fits on one train set make once (``reused_builds``: phase 20's pairs take
# its fits', 12l's mesh fit's serve its plain fit)
SENTIMENT_BUILDS = tuple(b for b in TOYS_HOST_BUILDS if b[0] != "TriRank")
TOYS_PAIR_DEPTH = 2  # iterations (HypAR: steps) of each mesh/plain pair at Toys


@contextlib.contextmanager
def reused_builds(methods, kept):
    """While open, each (class name, method) of the port's models builds
    once: its first call's result, and the attributes the call set on its
    model, are kept in ``kept`` (a dict, which may outlive the context and
    open another), and every later call on that class hands them to the
    new model without building again. For fits of one train set (phase
    20's mesh pairs after its fits)."""
    from cornac_tpu_torch import models

    # each class's own method, taken before any is swapped: a subclass
    # (ComparERObj of EFM) must not find its parent's wrapper
    reals = {key: getattr(getattr(models, key[0]), key[1]) for key in methods}
    with contextlib.ExitStack() as stack:
        for (cls_name, name), real in reals.items():
            cls = getattr(models, cls_name)

            def reused(model, *args, _real=real, _key=(cls_name, name), **kwargs):
                if _key not in kept:
                    before = dict(vars(model))
                    out = _real(model, *args, **kwargs)
                    kept[_key] = (out, {k: v for k, v in vars(model).items()
                                        if k not in before or before[k] is not v})
                out, attrs = kept[_key]
                vars(model).update(attrs)
                return out

            stack.enter_context(swapped(cls, name, reused))
        yield kept


def toys_like(seed):
    """Seeded data at the Amazon Toys & Games 5-core counts: star ratings
    over Zipf-like users and items with seeded timestamps (UIRT), and one to
    four seeded (aspect, opinion, polarity) tuples a rating over the assumed
    lexicon (``seq_bench_data.sentiment_lexicon``)."""
    from seq_bench_data import sentiment_lexicon, timed

    rng = np.random.RandomState(seed)
    users, items = zipf_pairs(rng, TOYS_USERS, TOYS_ITEMS, TOYS_RATINGS, 0.4, 0.6)
    triples = star_triples(rng, users, items)
    lexicon = sentiment_lexicon(triples, TOYS_ASPECTS, TOYS_OPINIONS, seed=seed + 1)
    return timed(triples, seed=seed + 2), lexicon


def toys_splits(seed):
    """Phase 20's splits, made in a spawned process while the earlier
    phases run (about 12 s of host work): RatioSplit(0.15) and TriRank's
    RatioSplit(0.2) of ``toys_like(seed)``, each with its
    SentimentModality. Returns (the two splits, the seconds each took)."""
    sys.path.insert(0, str(ROOT))
    from cornac_tpu_torch.data import SentimentModality
    from cornac_tpu_torch.eval_methods import RatioSplit

    seconds = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    quads, lexicon = timed("Toys-like ratings, timestamps and sentiment", lambda: toys_like(seed))

    def split_of(data, lex, test_size):
        return RatioSplit(data=data, fmt="UIRT", test_size=test_size, exclude_unknowns=True,
                          seed=123, verbose=False, sentiment=SentimentModality(data=lex))

    splits = (timed("RatioSplit(0.15) with SentimentModality",
                    lambda: split_of(quads, lexicon, 0.15)),
              timed("RatioSplit(0.2) with SentimentModality (TriRank's)",
                    lambda: split_of(quads, lexicon, 0.2)))
    return splits, seconds


def probe_ms(out, timed):
    """ms a call between the two events of ``timed_calls``, or None."""
    import torch

    if None in out["events"]:
        return None
    torch.cuda.synchronize()
    return out["events"][0].elapsed_time(out["events"][1]) / (timed[1] - timed[0])


def limited_steps(module, steps):
    """While open, ``module.hypar_draws`` yields ``steps`` steps at most."""
    import itertools

    real = module.hypar_draws

    def draws(*args, **kwargs):
        return itertools.islice(real(*args, **kwargs), steps)

    return swapped(module, "hypar_draws", draws)


def evaluate_head(model, train, test, users, rating):
    """NDCG@50 over ``users``' test ratings and, for a rating model, RMSE
    over them: [NDCG@50] or [NDCG@50, RMSE]."""
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval, rating_eval
    from cornac_tpu_torch.metrics import NDCG, RMSE

    head = ratings_subset(test, users)
    out = list(ranking_eval(model, [NDCG(k=50)], train, head)[0])
    if rating:
        out += list(rating_eval(model, [RMSE()], head)[0])
    return out


def phase_sentiment_toys(toys_data, mesh):
    """Phase 20, the sentiment and explainable models at the Amazon Toys &
    Games 5-core counts (seeded ratings with timestamps and seeded
    sentiment over an assumed lexicon, ``toys_like``): the examples' split,
    RatioSplit(0.15, exclude_unknowns, seed 123; TriRank's 0.2), made by
    ``toys_splits`` in a spawned process (``toys_data()`` returns them and
    its seconds); each model
    of ``TOYS_MODELS`` fitted at its depth, its host builds timed (``TOYS_HOST_BUILDS``); MTER's, ComparERSub's,
    LRPPM's and Companion's ms an iteration by CUDA events over iterations
    51-130 and HypAR's a step over steps 3-8, each with its device
    events a call and busy share over the ``TOYS_PROFILED`` after;
    NDCG@50 (and RMSE for the rating models) over the first
    ``TOYS_EVAL_USERS`` test users; the accumulate_rows inputs of
    ``TOYS_RECORDED``, recorded from the fits, held bit for bit to the plain
    version on the CPU and returned (``acc_cases``) for the times phase;
    then one mesh/plain pair of each model but TriRank (which takes no
    mesh, as in the JAX package) on the world-size-1 ``mesh``
    (``full_width_pair``: ``TOYS_PAIR_DEPTH`` iterations or steps on the
    whole train set, its host builds the fits' own, ``reused_builds``).
    Returns (accumulate_rows launches, the stats)."""
    import torch

    import cornac_tpu_torch.models.companion as companion_mod
    import cornac_tpu_torch.models.hypar as hypar_mod
    import cornac_tpu_torch.models.lrppm as lrppm_mod
    import cornac_tpu_torch.models.mter as mter_mod
    from cornac_tpu_torch import models
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    mods = {"mter": mter_mod, "lrppm": lrppm_mod, "companion": companion_mod}
    clock = Clock()
    (split, split_tri), made = clock("the splits from their process (waited for)",
                                                toys_data)
    for name, sec in made.items():
        log(f"  {name} (set-up, in the spawned process, host clock): {sec:.3f} s")
    train = split.train_set
    sent = train.sentiment
    log(f"  {train.num_users:,} train users x {train.num_items:,} items, {train.num_ratings:,} "
        f"train ratings, {len(sent.sentiment):,} reviews' tuples over {sent.num_aspects} aspects "
        f"and {sent.num_opinions} opinions; HypAR's stemmer: "
        f"{hypar_mod.stemmer_name()}")

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    stats, host_s, recorded, builds = {}, {}, {}, {}
    with reused_builds(SENTIMENT_BUILDS, builds), timed_methods(TOYS_HOST_BUILDS, host_s):
        for name, (cls, kw, depth) in TOYS_MODELS.items():
            sp = split_tri if name == "TriRank" else split
            kwargs = dict(kw)
            if depth is not None and depth[0] != "steps":
                kwargs[depth[0]] = depth[1]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            probe = {}
            with contextlib.ExitStack() as stack:
                if name in TOYS_PROBED:
                    mod, fn, at_start = TOYS_PROBED[name]
                    stack.enter_context(timed_calls(mods[mod], fn, *SAMPLED_TIMED, probe,
                                                    TOYS_PROFILED, at_start))
                if name == "HypAR":
                    stack.enter_context(limited_steps(hypar_mod, HYPAR_STEPS))
                    stack.enter_context(timed_calls(hypar_mod.HypARNet, "loss_on", *HYPAR_TIMED,
                                                    probe, HYPAR_PROFILED, True))
                    stack.enter_context(hypar_mod.fixed_svds_start(0))
                    stack.enter_context(recording_first_calls(recorded.setdefault(name, []), 2))
                if name == "Companion":
                    stack.enter_context(recording_first_calls(recorded.setdefault(name, []), 0,
                                                              calls=(1,)))
                label = f"{name}.fit" + ("" if depth is None else f", {depth[0]} {depth[1]}")
                model = clock(label, lambda: getattr(models, cls)(**kwargs).fit(sp.train_set))
            peak = torch.cuda.max_memory_allocated() - held
            tr = sp.train_set
            test_users = np.unique(sp.test_set.uir_tuple[0])
            head = test_users[:TOYS_EVAL_USERS]
            quality = clock(f"{name} NDCG@50" + (" and RMSE" if name in TOYS_RATING else ""),
                            lambda: evaluate_head(model, tr, sp.test_set, head,
                                                  name in TOYS_RATING))
            if not np.isfinite(quality).all():
                raise AssertionError(f"{name} at Toys: non-finite metrics {quality}")
            st = dict(fit_s=clock.seconds[label], peak=peak, quality=quality,
                      evaluated=len(head), n_test=len(test_users))
            timed = HYPAR_TIMED if name == "HypAR" else SAMPLED_TIMED
            if probe:
                st.update(ms=probe_ms(probe, timed), events=probe["device_events"],
                          share=None if probe["busy_ms"] is None
                          else probe["busy_ms"] / probe["wall_ms"], top=probe["top"],
                          calls=probe["count"])
                if st["ms"] is None or st["events"] is None:
                    raise AssertionError(f"{name}: the probe saw {probe['count']} calls")
            if name == "TriRank":
                st["iterations"] = model.last_iterations
            stats[name] = st
            log(f"  {name}" + ("" if depth is None else
                               f" ({depth[0]} {depth[1]}, the example's {depth[2]})")
                + f": fit {st['fit_s']:.3f} s (host clock), peak device memory "
                f"{peak / 2**30:.3f} GiB; NDCG@50 {quality[0]:.6f}"
                + (f", RMSE {quality[1]:.6f}" if len(quality) > 1 else "")
                + f" over the first {len(head):,} of {len(test_users):,} test users"
                + ("" if "ms" not in st else
                   f"; {st['ms']:.3f} ms a{' step' if name == 'HypAR' else 'n iteration'} "
                   f"(CUDA events, calls {timed[0] + 1}-{timed[1]}), "
                   f"{st['events']:.1f} device events a call, busy "
                   + ("not measured" if st["share"] is None else f"{100 * st['share']:.2f}%")
                   + f" (profiled over "
                   f"{HYPAR_PROFILED if name == 'HypAR' else TOYS_PROFILED}); top device ops "
                   f"{st['top']}")
                + ("" if name != "TriRank" else
                   f"; the last batch's power iteration stopped after {st['iterations']} steps"))
            del model
    launches = ACCUMULATE_ROWS.launches
    clock.report("the sentiment models at Toys")
    for (cls_name, method), sec in host_s.items():
        log(f"  host build {cls_name}.{method}: {sec:.3f} s (host clock)")
    if launches <= 0:
        raise AssertionError("phase 20 did not launch accumulate_rows")
    acc_err, acc_cases = 0.0, {}
    for (name, n), label in TOYS_RECORDED.items():
        if len(recorded.get(name, ())) <= n:
            raise AssertionError(f"{name}: {len(recorded.get(name, ()))} calls recorded")
        table, ids, upd = recorded[name][n]
        err, card_err, per_call, device_ms, kept = check_accumulate(
            f"{label}: {ids.numel()} ids into {tuple(table.shape)}", table, ids, upd, calls=20)
        acc_err = max(acc_err, err)
        acc_cases[label] = (table, ids, upd, per_call, device_ms, kept, err, card_err)
    del recorded
    log(f"  accumulate_rows launches {launches}")
    pairs = {}
    for name, (cls, kw, _) in TOYS_MODELS.items():
        if name == "TriRank":
            continue
        with contextlib.ExitStack() as stack:
            stack.enter_context(reused_builds(SENTIMENT_BUILDS, builds))
            if name == "HypAR":
                stack.enter_context(limited_steps(hypar_mod, TOYS_PAIR_DEPTH))
                stack.enter_context(hypar_mod.fixed_svds_start(0))
                make = functools.partial(getattr(models, cls), **kw)
            else:
                make = functools.partial(getattr(models, cls),
                                         **{**kw, "max_iter": TOYS_PAIR_DEPTH})
            pair = full_width_pair(name, make, train, mesh,
                                   f"{TOYS_PAIR_DEPTH} iterations or steps on the train set")
        launches += pair[0]
        pairs[name] = pair[1:]
    del builds
    log(f"the sentiment models at Toys: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, dict(stats=stats, host_s={f"{c}.{m}": s for (c, m), s in host_s.items()},
                          seconds=dict(clock.seconds), max_abs_err=acc_err, acc_cases=acc_cases,
                          mesh_pairs=pairs)


SENTIMENT_WITNESS_TOL = 1e-5  # |card step - CPU step on the card's gradients|, of a table's largest
# the sampled fits' two seeded refits in 12k, at these depths (the bands'
# fits take 500-1,000 iterations, some 10-40 ms each on the card's host)
SENTIMENT_SHORT_REFITS = {"MTER": 100, "ComparERSub": 100, "LRPPM": 100, "Companion": 100}


def sentiment_witness(name, train, card=None, seed=5):
    """One iteration of ``name`` (MTER, ComparERSub, LRPPM, Companion) from
    its initial tables on the CPU's draws, on the card and on the CPU; or,
    for HypAR, one step's loss and gradients from its initial parameters.
    The step of the sampled fits divides a gradient by its own size
    (AdaGrad's first sum is eps + g^2, eps 1e-9), so a float32 rounding of
    a gradient near 3e-5 moves its entry some 3,000 times as far: the
    witness holds the gradients the card's iteration hands its step to the
    CPU's, and the card's step to the CPU's step on those same gradients.
    Returns (the largest |card - CPU| of a gradient over the tensor's
    largest |gradient|, or over ``GRAD_FLOOR`` of the iteration's largest
    where that is more; the tensor; the largest |card step - CPU step on
    the card's gradients| of a table over its largest |value|, None for
    HypAR)."""
    import torch

    from bpr_quality_band import make_model
    from cornac_tpu_torch import models
    from cornac_tpu_torch.models import companion as companion_mod, lrppm as lrppm_mod
    from cornac_tpu_torch.models import mter as mter_mod
    from cornac_tpu_torch.models.hypar import fixed_svds_start, hypar_draws
    from cornac_tpu_torch.ops.csr_lookup import CsrLookup

    card = DEV if card is None else card
    real_step = {"adagrad": mter_mod.adagrad_project, "lrppm": lrppm_mod._apply}
    out = {}
    cpu_gen = torch.Generator()
    for dev in ("cpu", card):
        dev = torch.device(dev)
        model = make_model(models, name, 123)
        model.device, model.trainable = dev, False
        with fixed_svds_start(0):
            model.fit(train)
        cpu_gen.manual_seed(seed)
        got = out[dev.type] = {}
        if name == "HypAR":
            n_edges = len(model.edge_u)
            bsz = min(model.batch_size, n_edges)
            draws_cpu = next(hypar_draws(cpu_gen, model, n_edges, bsz, -(-n_edges // bsz),
                                         torch.device("cpu")))
            draws = {k: ([m.to(dev) for m in v] if isinstance(v, list) else v.to(dev))
                     for k, v in draws_cpu.items()}
            params = model.net.params
            loss = model.net.loss_on(draws)
            grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
            got["grads"] = {n: g.detach().cpu() for n, g in zip(params, grads)}
            got["model"] = model
            continue

        def adagrad(params, sgrads, grads, lr, ld_reg, _got=got):
            _got["grads"] = {n: g.cpu() for n, g in grads.items()}
            _got["step"] = (lr, ld_reg)
            return real_step["adagrad"](params, sgrads, grads, lr, ld_reg)

        def lrppm_step(tables, grads, lr, reg, _got=got):
            _got["grads"] = {n: g.cpu() for n, g in zip(("U", "I", "UA", "IA"), grads)}
            _got["step"] = (lr, reg)
            return real_step["lrppm"](tables, grads, lr, reg)

        with torch.no_grad(), swapped(mter_mod, "adagrad_project", adagrad), \
                swapped(companion_mod, "adagrad_project", adagrad), \
                swapped(lrppm_mod, "_apply", lrppm_step):
            if name == "LRPPM":
                uia, _ = model._build_data(train)
                X_u, X_i, X_a, X_l = model._triples(uia)
                rid, cid, rvals = train.uir_tuple
                csr = train.csr_matrix.sorted_indices()
                as_t = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a)).to(dev, dt)  # noqa
                data = lrppm_mod.LrppmData(
                    as_t(rid), as_t(cid), as_t(rvals, torch.float32), as_t(X_u), as_t(X_i),
                    as_t(X_a), as_t(X_l, torch.float32), CsrLookup.build(csr, device=dev),
                    lrppm_mod.aspect_membership(csr, uia, model.num_aspects, dev),
                    model.num_aspects)
                draws = lrppm_mod.lrppm_draws(cpu_gen, 1, data, model.n_samples,
                                              model.n_ranking_samples, "cpu")
                params = tuple(torch.as_tensor(np.asarray(t, np.float32), device=dev).clone()
                               for t in (model.U, model.I, model.UA, model.IA))
                lrppm_mod.lrppm_iteration(params, data, {k: v[0].to(dev) for k, v in draws.items()},
                                          0.1, 0.01, 1.0)
                got["tables"] = dict(zip(("U", "I", "UA", "IA"), (t.cpu() for t in params)))
                continue
            params, sgrads = model._device_params(dev)
            if name == "Companion":
                streams, mats = model._host_streams(*model._build_data(train))
                data = model._device_data(train, streams, mats, dev)
                draws = companion_mod.companion_draws(
                    cpu_gen, 1, data, (model.num_items, model.num_aspects, model.num_opinions),
                    model._sizes(), "cpu")
                companion_mod.companion_iteration(
                    params, sgrads, data, {k: v[0].to(dev) for k, v in draws.items()},
                    model.n_user_factors, 0.5, 0.1, 10.0, 10.0, 10.0, 10.0, 10.0)
            else:
                rating_matrix, uia, uao, iao = model._build_data(train)
                pairs, n_pair = None, 0
                if name == "ComparERSub":
                    pairs = model._build_sub_pairs(train, uia)
                    n_pair = model.n_pair_samples
                data = model._device_data(train, rating_matrix, uia, uao, iao, pairs, dev)
                draws = mter_mod.mter_draws(cpu_gen, 1, data, model.n_element_samples,
                                            model.n_bpr_samples, n_pair, model.num_items, "cpu")
                mter_mod.mter_iteration(params, sgrads, data,
                                        {k: v[0].to(dev) for k, v in draws.items()},
                                        float(model.lr), float(model.lambda_reg),
                                        float(model.lambda_bpr), float(getattr(model, "lambda_d",
                                                                               0.0)))
            got["tables"] = {n: p.cpu() for n, p in params.items()}
            got["initial"] = model._device_params(torch.device("cpu"))
    cpu, on_card = out["cpu"], out[torch.device(card).type]
    if name == "HypAR":
        return hypar_grads_held(cpu["model"], cpu["grads"], on_card["grads"], draws_cpu)
    largest = max(g.abs().max().item() for g in cpu["grads"].values())
    worst, where = 0.0, ""
    for n, g in cpu["grads"].items():
        scale = max(g.abs().max().item(), GRAD_FLOOR * largest, 1e-30)
        err = (on_card["grads"][n] - g).abs().max().item() / scale
        if err > worst:
            worst, where = err, n
    # the CPU's step on the card's gradients, from the same initial tables
    step_err = 0.0
    with torch.no_grad():
        if name == "LRPPM":
            tables = tuple(cpu_table.clone() for cpu_table in (
                torch.as_tensor(np.asarray(t, np.float32))
                for t in (model.U, model.I, model.UA, model.IA)))
            real_step["lrppm"](tables, tuple(on_card["grads"][n] for n in ("U", "I", "UA", "IA")),
                               *on_card["step"])
            replay = dict(zip(("U", "I", "UA", "IA"), tables))
        else:
            replay, sgrads = cpu["initial"]
            real_step["adagrad"](replay, sgrads, on_card["grads"], *on_card["step"])
    for n, t in replay.items():
        scale = max(t.abs().max().item(), 1e-30)
        step_err = max(step_err, (on_card["tables"][n] - t).abs().max().item() / scale)
    return worst, where, step_err


def hypar_grads_held(model, cpu_grads, card_grads, draws):
    """HypAR's step gradients on the card held to a float64 step on the CPU
    from the same parameters and draws (``model``: the CPU's). A tensor
    whose gradient is small beside the step's largest holds float32
    rounding in either device (its ranking loss's ``pred_b`` has an exact
    gradient of 0), so each tensor is allowed ``REVIEW_GRAD_TOL`` of its
    largest |gradient| (or of ``GRAD_FLOOR`` of the step's largest, where
    more), or twice the CPU float32 gradient's own distance from float64,
    where more. Returns (the largest |card - float64| over its allowance,
    the tensor, None)."""
    import copy

    import torch

    from cornac_tpu_torch.models.hypar import HypARNet

    net = model.net
    graph = copy.copy(net.graph)
    graph.adj = copy.copy(graph.adj)
    if graph.adj.dense is not None:
        graph.adj.dense = graph.adj.dense.double()
    else:
        graph.adj.edge_norm = graph.adj.edge_norm.double()
    graph.stats = {c: (dv.double(), de.double()) for c, (dv, de) in graph.stats.items()}
    feats = None if net.ao_feats is None else net.ao_feats.double()
    net64 = HypARNet(model, {n: p.detach().double() for n, p in net.params.items()}, graph, feats)
    d64 = {k: ([m.double() for m in v] if isinstance(v, list) else
               v.double() if v.is_floating_point() else v) for k, v in draws.items()}
    params = net64.params
    exact = dict(zip(params, torch.autograd.grad(net64.loss_on(d64), list(params.values()),
                                                 materialize_grads=True)))
    largest = max(g.abs().max().item() for g in exact.values())
    worst, where = 0.0, ""
    for n, g in exact.items():
        scale = max(g.abs().max().item(), GRAD_FLOOR * largest)
        reach = (cpu_grads[n].double() - g).abs().max().item()
        off = (card_grads[n].double() - g).abs().max().item()
        allowed = max(REVIEW_GRAD_TOL * scale, 2 * reach, 1e-30)
        if off / allowed > worst:
            worst, where = off / allowed, n
        apart = (card_grads[n] - cpu_grads[n]).abs().max().item() / max(scale, 1e-30)
        if n == "node_emb" or apart > REVIEW_GRAD_TOL:
            # where float32 on the two devices parts, which of them float64
            # sides with, all of the tensor's largest |gradient|
            log(f"  HypAR's {n} gradient: |card - CPU float32| {apart:.3e}, |card - float64| "
                f"{off / scale:.3e}, |CPU float32 - float64| {reach / scale:.3e} of the "
                f"tensor's largest")
    return worst, where, None


def phase_sentiment_bench(bench_data):
    """Process 12k, spawned: the sentiment and explainable models at the
    bench shape (``make_ml100k_like(7)`` with seeded timestamps and
    sentiment, ``bpr_quality_band.sentiment_split``; the ComparER models on
    its first users), at ``tools/bpr_quality_band.py``'s
    ``SENTIMENT_CONFIGS``: each model's AUC and NDCG@10 (and RMSE for the
    rating models) in the band of the JAX package's CPU fits over ten seeds
    (``tools/quality_bands.py::SENTIMENT_BANDS``); a second seeded fit of
    each bit for bit (two of 100 iterations for the sampled fits,
    ``SENTIMENT_SHORT_REFITS``; HypAR's content vectors from one svds start), whose
    accumulate_rows inputs are held to the plain version on the CPU; one
    iteration of each sampled fit, and one HypAR step's gradients, on the
    card against the CPU from the same tables and draws
    (``sentiment_witness``). Two CPU threads. Returns (accumulate_rows
    launches, fit seconds, max |err|)."""
    import io

    import torch

    import cornac_tpu_torch.data as pdata
    import cornac_tpu_torch.eval_methods as peval
    import cornac_tpu_torch.metrics as pmetrics
    from bpr_quality_band import (SENTIMENT_CONFIGS, SENTIMENT_RATING, make_model,
                                  sentiment_split)
    from cornac_tpu_torch import models
    from cornac_tpu_torch.models.hypar import fixed_svds_start
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from quality_bands import sentiment_band

    torch.set_num_threads(2)
    clock = Clock()
    triples = bench_data()
    split = clock("RatioSplit(0.15, 4.0) with timestamps and sentiment",
                  lambda: sentiment_split(pdata, peval, triples))
    split_c = clock("the ComparER users' RatioSplit", lambda: sentiment_split(
        pdata, peval, triples, "ComparERObj"))

    def split_of(name):
        return split_c if name.startswith("ComparER") else split

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    results, fitted = {}, {}
    for name in SENTIMENT_CONFIGS:
        model = make_model(models, name, 123)
        metrics = [pmetrics.AUC(), pmetrics.NDCG(k=10), pmetrics.Recall(k=10)] + (
            [pmetrics.RMSE()] if name in SENTIMENT_RATING else [])
        with fixed_svds_start(0):
            results[name] = clock(f"{name} evaluate", lambda: split_of(name).evaluate(
                model, metrics, user_based=False)[0].metric_avg_results)
        fitted[name] = model
    launches = ACCUMULATE_ROWS.launches
    clock.report("the sentiment models at the bench shape")
    if launches <= 0:
        raise AssertionError("process 12k did not launch accumulate_rows")

    # ---- check what came out ----
    outside, fit_s = [], {}
    for name, res in results.items():
        fit_s[name] = res["Train (s)"]
        for metric in ("AUC", "NDCG@10") + (("RMSE",) if name in SENTIMENT_RATING else ()):
            lo, hi, _, _ = sentiment_band(name, metric)
            inside = lo <= res[metric] <= hi
            log(f"  {name}: {metric} {res[metric]:.6f}, band [{lo:.6f}, {hi:.6f}] (JAX seeds) "
                f"{'inside' if inside else 'OUTSIDE'}; fit {fit_s[name]:.3f} s (host clock)")
            if not inside:
                outside.append(f"{name} {metric}")
    acc_err, recorded = 0.0, 0
    tables = {"EFM": ("U1", "U2", "V", "H1", "H2"), "ComparERObj": ("U1", "U2", "V", "H1", "H2"),
              "LRPPM": ("U", "I", "UA", "IA"), "TriRank": ("p", "a", "u")}
    for name, model in fitted.items():
        if name in SENTIMENT_SHORT_REFITS:
            # the sampled fits' refit at a shorter depth, both fits at it
            model = make_model(models, name, 123)
            model.max_iter = SENTIMENT_SHORT_REFITS[name]
            model.fit(split_of(name).train_set)
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store, \
                fixed_svds_start(0):
            again = make_model(models, name, 123)
            if name in SENTIMENT_SHORT_REFITS:
                again.max_iter = SENTIMENT_SHORT_REFITS[name]
            again.fit(split_of(name).train_set)
        if name == "HypAR":
            for key, p in model.params.items():
                if not np.array_equal(p, again.params[key]):
                    raise AssertionError(f"HypAR: two seeded fits differ in {key}")
        for attr in tables.get(name, () if name == "HypAR" else
                               ("G1", "G2", "G3", "U", "I", "A", "O")):
            if not same_bits(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr}")
        users = np.arange(64)
        if not np.array_equal(model.score_batch(users), again.score_batch(users)):
            raise AssertionError(f"{name}: two seeded fits score differently")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    for name in ("MTER", "ComparERSub", "LRPPM", "Companion", "HypAR"):
        err, where, step_err = clock(f"{name}'s witness", lambda: sentiment_witness(
            name, split_of(name).train_set))
        if name == "HypAR":
            log(f"  HypAR, a step's gradients on the CPU's draws, on the card against float64 on "
                f"the CPU: the largest |card - float64| {err:.3e} of its allowance ({where}; "
                f"{REVIEW_GRAD_TOL:g} of the tensor's largest, or twice the CPU float32's reach; "
                f"held to 1)")
            tol = 1.0
        else:
            log(f"  {name}, one iteration's gradients from the initial tables on the CPU's draws, "
                f"on the card against the CPU: the largest |card - CPU| {err:.3e} of the "
                f"tensor's largest ({where}; held to {REVIEW_GRAD_TOL:g}); the card's step "
                f"against the CPU's step on the card's gradients {step_err:.3e} of a table's "
                f"largest (held to {SENTIMENT_WITNESS_TOL:g})")
            tol = REVIEW_GRAD_TOL
        if not err <= tol or not (step_err is None or step_err <= SENTIMENT_WITNESS_TOL):
            raise AssertionError(f"{name} on the card differs from the CPU: gradients {err:.3e} "
                                 f"({where}), step {step_err}")
    if outside:
        raise AssertionError(f"outside their quality bands: {', '.join(outside)}")
    log(f"  every model: two seeded fits identical, bit for bit; accumulate_rows on their own "
        f"inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit (max "
        f"|err| {acc_err:.3e}); accumulate_rows launches {launches}")
    log(f"the sentiment models at the bench shape: ok in {sum(clock.seconds.values()):.1f} s")
    return launches, fit_s, acc_err


# the families at the bench shape run in processes of their own, at once,
# after the timed phases: their eager steps are bound by the host, one core
# each
NEURAL_GROUPS = (("GMF", "MLP"), ("NeuMF", "LightGCN", "NGCF"), ("VAECF", "RecVAE", "BiVAECF"))
FAMILY_TIMEOUT = 900  # seconds a family's process may take
# the bench-shape processes at once: eight workers on the card host's eight
# cores beside phases 17, 16c and 16; the next-basket, modality and VAECF
# processes end first and free theirs for the last four. Beside eleven at
# once, phase 16 alone took 341-405 s on an H100's host; beside ten, 285 s.
BENCH_WORKERS = 8


def run_captured(phase, triples, *args):
    """In a spawned process: the phase function ``phase`` of this script
    on ``triples`` (``make_ml100k_like(7)``, made once by the parent) and
    ``args``, its log captured, at a lower CPU priority than the parent's
    phases beside it. Returns (log, result, the wall-clock time it ended);
    a failure raises with the log and the traceback."""
    import io
    import traceback

    os.nice(10)
    sys.path.insert(0, str(ROOT))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = globals()[phase](lambda: triples, *args)
    except Exception:
        raise RuntimeError(f"{phase}{args} failed:\n{out.getvalue()}{traceback.format_exc()}"
                           ) from None
    return out.getvalue(), result, time.time()


def build_all():
    """Build every kernel library at once: one nvcc per source, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.canary import CANARY
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    libs = [FUSED_TOPK.library, COSINE_TOPK.library, ACCUMULATE_ROWS.library, CANARY.library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.build) for lib in libs]:
            future.result()
    for lib in libs:
        log(f"build: ok, {lib.path().name} in {lib.build_seconds or 0.0:.1f} s")
        for line in lib.compiler_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas: {line.strip()}")
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="stop after the kernel-vs-plain phases")
    args = parser.parse_args()

    if not (ROOT / "cornac_tpu_torch").is_dir():
        sys.exit("chip_smoke: run it from a checkout that holds cornac_tpu_torch/")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    t_start, t_wall = time.perf_counter(), time.time()
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_all()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    max_err = phase_kernel(gen)
    cos_err = phase_cosine(gen)
    acc_err, acc_cases = phase_accumulate(gen)
    canary_err = phase_canary(gen)
    if args.quick:
        log(f"quick run done in {time.perf_counter() - t_start:.1f} s")
        return

    def lap(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what}: done")

    lap("device, build and kernel-vs-plain phases")
    probe_launches, _ = phase_probe()
    lap("on-silicon probe")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    # bench.py's generator is pure Python (about 15 s): a second process
    # makes the data while the serving slice runs. The thirteen bench-shape
    # processes run beside phases 17, 16c and 16, BENCH_WORKERS at a time,
    # and are collected (their logs printed) before 16b: the module's
    # docstring says why there
    pool = multiprocessing.get_context("spawn").Pool(BENCH_WORKERS)
    try:
        bench_data = pool.apply_async(make_ml100k_like)
        toys_data = pool.apply_async(toys_splits, (args.seed + 30,))
        mesh = start_mesh()  # after the pool: its processes never see the group
        lap("the world-size-1 NCCL mesh")
        launches, bpr, users = phase_slice(args.seed, work, mesh)
        lap("BPR serving slice")
        triples = bench_data.get()
        jobs = [("factor family", "phase_factor_bench", ())]
        jobs += [(f"neural family ({', '.join(names)})", "phase_neural_bench", (names,))
                 for names in NEURAL_GROUPS]
        jobs += [("factor family's rest and the protocols", "phase_factor_rest_bench", ()),
                 ("the mesh fits (A8 (b), A8 (c), the side-information models)",
                  "phase_mesh_bench", ()),
                 ("the modality layer's models and checkpointed Experiments",
                  "phase_modality_bench", ()),
                 ("the next-item models, CVAECF and GCMC", "phase_seq_bench", ()),
                 ("the next-basket models", "phase_basket_bench", ()),
                 # the four queued, the longest first
                 ("the text and review models", "phase_text_bench", ()),
                 ("the sentiment and explainable models", "phase_sentiment_bench", ()),
                 ("the generative next-item models", "phase_generative_bench", ()),
                 ("the side-information models", "phase_side_bench", ())]
        families = [(what, pool.apply_async(run_captured, (phase, triples, *extra)))
                    for what, phase, extra in jobs]
        basket_launches, basket = phase_basket_tafeng(args.seed, mesh)
        lap("the next-basket family at Ta Feng, beside the thirteen bench-shape processes")
        tiger_launches, tiger = phase_tiger_ml100k(bench_data.get, mesh)
        lap("TIGER at ML-100K, beside them")
        sasrec_launches, sasrec, digi_ev = phase_sasrec_diginetica(args.seed, work, mesh)
        lap("SASRec at Diginetica, beside them")
        done = []
        for what, job in families:
            text, result, ended = job.get(timeout=FAMILY_TIMEOUT)
            log(text.rstrip())
            lap(f"{what} at the bench shape, in its own process (ended at "
                f"{ended - t_wall:.1f} s)")
            done.append(result)
        tr_launches, transformer = phase_transformer_diginetica(digi_ev, mesh)
        del digi_ev
        lap("TransformerRec at Diginetica")
        knn_launches, W_items, W_users = phase_knn_ml1m(args.seed, work)
        lap("KNN slice")
        ml10m_launches, W10, train10m = phase_knn_ml10m(args.seed)
        lap("related items")
        lgcn_launches, lgcn = phase_lightgcn_ml10m(train10m, gen, mesh)
        lap("LightGCN edge form at ML-10M")
        hpf_launches, hpf_fused, hpf_model, hpf_users, hpf = phase_hpf_ml10m(train10m, args.seed)
        del train10m
        lap("HPF at ML-10M")
        sbpr_launches, sbpr_fused, sbpr_model, sbpr_users, sbpr = phase_sbpr_epinions(
            args.seed, work)
        lap("SBPR at Epinions")
        c2pf_launches, c2pf_fused, c2pf_model, c2pf_users, c2pf = phase_c2pf_office(args.seed)
        lap("C2PF at Amazon Office")
        side_launches, side_fused, side = phase_side_published(sbpr.pop("split"),
                                                               c2pf.pop("split"), mesh)
        lap("SoRec at Epinions, MCF and PCRL at Amazon Office")
        vbpr_launches, vbpr_fused, vbpr_model, vbpr_users, vbpr = phase_vbpr_tradesy(args.seed,
                                                                                     mesh)
        lap("VBPR at Tradesy")
        cloth_launches, cloth_fused, cloth = phase_clothing(args.seed, mesh)
        lap("the Clothing models")
        cite_launches, cite_fused, cite = phase_citeulike(args.seed, mesh)
        lap("the CiteULike models")
        music_launches, music_fused, music = phase_review_music(args.seed, mesh)
        lap("NARRE and HRDR at Digital Music")
        plot_launches, plot_fused, plots = phase_plots(bench_data.get, args.seed, mesh)
        lap("ConvMF and HFT on ML-100K plots")
        toys_launches, toys = phase_sentiment_toys(toys_data.get, mesh)
        acc_cases.update(toys.pop("acc_cases"))  # timed with the others in phase 21
        lap("the sentiment models at Amazon Toys & Games")
        bench_launches, bench = phase_trainer_bench(bench_data.get, mesh)
        lap("trainers at the bench shape")
        full_launches, full_fused, full = phase_trainer_full(args.seed, mesh)
        lap("trainer at full width")
        t = time.perf_counter()
        netflix = netflix_dataset()
        log(f"  {WMF_PAIRS:,} seeded pairs at the Netflix widths (set-up, host clock): "
            f"{time.perf_counter() - t:.3f} s")
        wmf_fused, wmf = phase_wmf_full(args.seed, netflix)
        lap("WMF at the Netflix widths")
        wmf_mesh = mesh_wmf_netflix(netflix, mesh)
        lap("WMF(mesh=...) at the Netflix widths")
        vaecf = phase_vaecf_full(netflix, args.seed)
        del netflix
        lap("VAECF at the Netflix widths")
    finally:
        pool.terminate()
        pool.join()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    rows = phase_times(bpr, users)
    hpf_rows = phase_times(hpf_model, hpf_users, (SERVE_BATCH,), "HPF at ML-10M")
    sbpr_rows = phase_times(sbpr_model, sbpr_users, (SERVE_BATCH,), "SBPR at Epinions")
    c2pf_rows = phase_times(c2pf_model, c2pf_users, (SERVE_BATCH,), "C2PF at Amazon Office")
    vbpr_rows = phase_times(vbpr_model, vbpr_users, (SERVE_BATCH,), "VBPR at Tradesy")
    del vbpr_model
    cos_rows = phase_cosine_times([
        ("ML-1M item side", W_items),
        ("ML-1M user side", W_users),
        ("half dense, ML-1M item widths", star_weights(3706, 6040, 0.5, "integer", gen)),
        ("ML-10M item side", W10),
    ])
    acc_rows = phase_accumulate_times(acc_cases)
    canary_row = phase_canary_times()
    lap("times")
    factor_launches, factor_fused, factor_fit, factor_acc_err = done[0]
    neural = done[1:1 + len(NEURAL_GROUPS)]
    neural_launches = sum(r[0] for r in neural)
    neural_fused = sum(r[1] for r in neural)
    neural_fit = {name: sec for r in neural for name, sec in r[2].items()}
    neural_acc_err = max(r[3] for r in neural)
    neural_prof = next(r[4] for r in neural if r[4] is not None)
    rest_launches, rest_fused, rest_fit, rest_acc_err, proto = done[1 + len(NEURAL_GROUPS)]
    # each process's result by its phase, whatever the jobs' order
    by_phase = {phase: res for (_, phase, _), res in zip(jobs, done)}
    modal_launches, modal_fit, modal_acc_err = by_phase["phase_modality_bench"]
    seqb_launches, seqb_fit, seqb_acc_err = by_phase["phase_seq_bench"]
    nbb_launches, nbb_fit, nbb_acc_err = by_phase["phase_basket_bench"]
    genb_launches, genb_fit, genb_acc_err = by_phase["phase_generative_bench"]
    sideb_launches, sideb_fit, sideb_acc_err = by_phase["phase_side_bench"]
    textb_launches, textb_fit, textb_acc_err = by_phase["phase_text_bench"]
    sentb_launches, sentb_fit, sentb_acc_err = by_phase["phase_sentiment_bench"]
    a8b_launches, a8b_fused, a8b = by_phase["phase_mesh_bench"]
    kernels = [{
        "name": "fused_topk",
        "batch": B,
        "slices": row["slices"],
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/fused_topk.cu",
        "replaces": "cornac_tpu/ops/pallas_ranking.py:38",
        "launches": (launches + full_fused + a8b_fused + factor_fused + neural_fused + wmf_fused
                     + hpf_fused + rest_fused + sbpr_fused + c2pf_fused + side_fused
                     + vbpr_fused + cloth_fused + cite_fused + music_fused + plot_fused
                     + probe_launches["fused_topk"]),
        "max_abs_err": max_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for B, row in sorted(rows.items(), reverse=True)]
    # B1 at HPF's d = 5 over the ML-10M catalog, SBPR's d = 11 over the
    # Epinions catalog, C2PF's d = 100 over Amazon Office's and VBPR's d = 31
    # over Tradesy's, on the trained vectors
    for extra in (hpf_rows, sbpr_rows, c2pf_rows, vbpr_rows):
        row = extra[SERVE_BATCH]
        kernels.append({**{k: v for k, v in kernels[0].items() if k not in ("batch", "slices")},
                        "batch": SERVE_BATCH, "d": row["d"], "items": row["items"],
                        "slices": row["slices"],
                        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}})
    cos = cos_rows["ML-10M item side"]
    kernels.append({
        "name": "cosine_topk",
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/cosine_topk.cu",
        "replaces": "cornac_tpu/ops/pallas_similarity.py:43",
        "launches": knn_launches + ml10m_launches + probe_launches["cosine_topk"],
        "max_abs_err": cos_err,
        "ms": cos["ms"],
        "plain_ms": cos["plain_ms"],
        "bound_ms": cos["bound_ms"],
        "bound_by": cos["bound_by"],
        "library_ms": cos["library_ms"],
        "dense_bound_ms": cos["dense_bound_ms"],
        "sparse_library_ms": cos["sparse_library_ms"],
    })
    # accumulate_rows at the BPR trainer's full-width V update (the row
    # earlier runs report) and at LightGCN's edge form at the ML-10M widths,
    # each with its own max |kernel - plain| (the plain version on the CPU,
    # whose bits the kernel must give, and on the card, atomic); the largest
    # |kernel - plain on the CPU| over every check of every path besides
    acc_all_err = max(acc_err, factor_acc_err, neural_acc_err, lgcn["max_abs_err"],
                      hpf["max_abs_err"], rest_acc_err, sbpr["max_abs_err"],
                      c2pf["max_abs_err"], modal_acc_err, sasrec["max_abs_err"], seqb_acc_err,
                      basket["max_abs_err"], nbb_acc_err, genb_acc_err, tiger["max_abs_err"],
                      sideb_acc_err, music["max_abs_err"], plots["max_abs_err"], textb_acc_err,
                      toys["max_abs_err"], sentb_acc_err,
                      *(st["max_abs_err"] for st in transformer.values()))
    for label in ("full width, V update (positives + negatives)",
                  "LightGCN edge form, ML-10M, into user rows",
                  "LightGCN edge form, ML-10M, into item rows",
                  "HPF, ML-10M, into user rows",
                  "HPF, ML-10M, into item rows",
                  "SBPR, Epinions, V update (i, j, k)",
                  "C2PF, Amazon Office, ratings into item rows",
                  "SASRec, Diginetica, embedding gradient (positions)",
                  "SASRec, Diginetica, embedding gradient (negatives)",
                  "FPMC, Diginetica, item-table scatter",
                  "BERT4Rec, Diginetica, embedding gradient (positions)",
                  "BERT4Rec, Diginetica, output-bias gradient (positions)",
                  "TIGER, ML-100K, token table (encoder tokens)",
                  "TIGER, ML-100K, RQ-VAE codebook",
                  "GCMC, bench shape, edges into item rows",
                  "GCMC, bench shape, edges into user rows",
                  "VBPR, Tradesy, item-factor gradient (positives + negatives)",
                  "SoRec, Epinions, U update (trust stream)",
                  "MCF, Amazon Office, V update (item-graph stream)",
                  "DMRL, Amazon Clothing, item-embedding gradient",
                  "NARRE, Digital Music, word-table gradient (empty slots dropped)",
                  "NARRE, Digital Music, word-table gradient (empty slots into row 0)",
                  "ConvMF, ML-100K plots, embedding gradient",
                  *TOYS_RECORDED.values()):
        acc = acc_rows[label]
        kernels.append({
            "name": "accumulate_rows",
            "shape": acc["shape"],
            "route": "cuda",
            "source": "cornac_tpu_torch/csrc/accumulate_rows.cu",
            "replaces": "cornac_tpu/ops/accumulate.py:26",
            "launches": (bench_launches + full_launches + a8b_launches + factor_launches
                         + neural_launches + lgcn_launches + hpf_launches + rest_launches
                         + sbpr_launches
                         + c2pf_launches + modal_launches + sasrec_launches + seqb_launches
                         + basket_launches + nbb_launches + tr_launches + tiger_launches
                         + genb_launches + side_launches + vbpr_launches + cloth_launches
                         + sideb_launches + cite_launches + music_launches + plot_launches
                         + textb_launches + toys_launches + sentb_launches),
            "max_abs_err": acc["max_abs_err"],
            "card_plain_max_abs_err": acc["card_plain_max_abs_err"],
            "max_abs_err_all_paths": acc_all_err,
            "ms": acc["ms"],
            "device_ms": acc["device_ms"],
            "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"],
            "library_ms": acc["library_ms"],
            "deterministic_library_ms": acc["deterministic_library_ms"],
            "launches_per_call": acc["launches_per_call"],
        })
    kernels.append({
        "name": "canary",
        "shape": [128, 128],
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/canary.cu",
        "replaces": "benchmarks/pallas_on_silicon.py:74",
        "launches": probe_launches["canary"],
        "max_abs_err": canary_err,
        **canary_row,
    })
    log("factor family, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in factor_fit.items()))
    log("factor family's rest, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in rest_fit.items()))
    log("the protocols, host clock: " + ", ".join(
        f"{name} {sec:.3f} s" for name, sec in proto["seconds"].items()))
    log(f"HPF at ML-10M: {hpf['sweep_s'] * 1e3:.3f} ms per sweep, "
        f"{100 * hpf['bound_s'] / hpf['sweep_s']:.3f}% of the byte bound, busy "
        + ("not measured" if hpf["share"] is None else f"{100 * hpf['share']:.2f}%")
        + f", peak {hpf['peak'] / 2**30:.3f} GiB")
    log(f"SBPR at Epinions: {sbpr['epoch_s']:.3f} s per epoch, "
        f"{100 * sbpr['bound_s'] / sbpr['epoch_s']:.4f}% of the byte bound, busy "
        f"{100 * sbpr['share']:.2f}%, {sbpr['launches_per_minibatch']:.1f} device events per "
        f"minibatch, peak {sbpr['peak'] / 2**30:.3f} GiB; AUC {sbpr['quality'][0]:.4f}, NDCG@10 "
        f"{sbpr['quality'][1]:.4f}, Recall@10 {sbpr['quality'][2]:.4f}")
    log(f"C2PF at Amazon Office: {c2pf['sweep_s'] * 1e3:.3f} ms per sweep, "
        f"{100 * c2pf['bound_s'] / c2pf['sweep_s']:.3f}% of the byte bound, peak "
        f"{c2pf['peak'] / 2**30:.3f} GiB; " + ", ".join(
            f"{k} {v:.4f}" for k, v in c2pf["experiment"].items()))
    log("the modality layer's models at the bench shape, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in modal_fit.items()))
    log("the next-item models, CVAECF and GCMC at the bench shapes, fit seconds (host clock): "
        + ", ".join(f"{name} {sec:.3f}" for name, sec in seqb_fit.items()))
    log("the next-basket models at the bench shape, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in nbb_fit.items()))
    for name, st in basket["stats"].items():
        log(f"{name} at Ta Feng: {st['epoch_s']:.3f} s per epoch, {st['seq_per_s']:,.0f} "
            f"training sequences/s, {st['step_ms']:.3f} ms a step against a "
            f"{st['step_bound_ms']:.4f} ms bound ({st['bound_by']}), busy "
            f"{100 * st['share']:.2f}%, {st['launches_per_minibatch']:.1f} device events a step, "
            f"peak {basket['peaks'][name] / 2**30:.3f} GiB; " + ", ".join(
                f"{k} {basket['metrics'][name][k]:.4f}" for k in BASKET_METRICS))
    log(f"SASRec at Diginetica: {sasrec['epoch_s']:.3f} s per epoch, {sasrec['seq_per_s']:,.0f} "
        f"training sequences/s, {sasrec['step_ms']:.3f} ms a step against a "
        f"{sasrec['step_bound_ms']:.4f} ms bound ({sasrec['bound_by']}), busy "
        f"{100 * sasrec['share']:.2f}%, {sasrec['launches_per_minibatch']:.1f} device events a "
        f"step, peak {sasrec['peak'] / 2**30:.3f} GiB; " + ", ".join(
            f"{k} {v:.4f}" for k, v in sasrec["metrics"].items())
        + f" in {sasrec['eval_s']:.3f} s")
    for name, st in transformer.items():
        log(f"{name} at Diginetica: {st['epoch_s']:.3f} s per epoch, {st['seq_per_s']:,.0f} "
            f"training sequences/s, {st['step_ms']:.3f} ms a step against a "
            f"{st['step_bound_ms']:.4f} ms bound ({st['bound_by']}), busy "
            f"{100 * st['share']:.2f}%, {st['launches_per_minibatch']:.1f} device events a step, "
            f"peak {st['peak'] / 2**30:.3f} GiB; " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["metrics"].items())
            + f" in {st['eval_s']:.3f} s")
    log(f"TIGER at ML-100K: the RQ-VAE {tiger['rq_s']:.3f} s ({tiger['restarts']} dead codes "
        f"restarted, collision level {tiger['collisions']}), {tiger['epoch_s']:.3f} s the first "
        f"seq2seq epoch, {tiger['step_ms']:.3f} ms a step after {TIGER_TIMED_FROM} against a {tiger['step_bound_ms']:.4f} ms bound "
        f"({tiger['bound_by']}), busy "
        + ("not measured" if tiger["share"] is None else f"{100 * tiger['share']:.2f}%")
        + f", {tiger['launches_per_minibatch']:.1f} device events a step, peak "
        f"{tiger['peak'] / 2**30:.3f} GiB; " + ", ".join(
            f"{k} {v:.4f}" for k, v in tiger["metrics"].items()) + f" in {tiger['eval_s']:.3f} s")
    log("the generative next-item models at the bench shape, fit seconds (host clock): "
        + ", ".join(f"{name} {sec:.3f}" for name, sec in genb_fit.items()))
    log(f"VBPR at Tradesy: {vbpr['epoch_s']:.3f} s an epoch, {vbpr['step_ms']:.3f} ms a step "
        f"against a {vbpr['bound_ms']:.4f} ms bound ({vbpr['bound_by']}), busy "
        + ("not measured" if vbpr["share"] is None else f"{100 * vbpr['share']:.2f}%")
        + f", {vbpr['launches_per_step']:.1f} device events a step, peak "
        f"{vbpr['peak'] / 2**30:.3f} GiB; AUC {vbpr['quality'][0]:.4f}, Recall@50 "
        f"{vbpr['quality'][1]:.4f} over {vbpr['evaluated']:,} test users")
    log("SoRec at Epinions: epochs " + ", ".join(f"{e:.3f}" for e in side["sorec_epoch_s"])
        + f" s, {side['sorec_step_ms']:.3f} ms a step (profiled), busy "
        + ("not measured" if side["sorec_share"] is None else f"{100 * side['sorec_share']:.2f}%")
        + f", {side['sorec_events']:.1f} device events a step; MAE {side['sorec_errors'][0]:.4f}, RMSE {side['sorec_errors'][1]:.4f}; MCF "
        f"{side['mcf_s']:.3f} s, PCRL {side['pcrl_s']:.3f} s at Amazon Office; " + "; ".join(
            f"{name} P@10 {q[0]:.4f} R@10 {q[1]:.4f} NDCG@10 {q[2]:.4f}"
            for name, q in side["quality"].items()))
    log("the Clothing models, fit seconds (host clock): " + ", ".join(
        f"{name} {res['Train (s)']:.3f}" for name, res in cloth["results"].items()))
    log("the side-information models at the bench shape, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in sideb_fit.items()))
    for name, st in music["stats"].items():
        log(f"{name} at Digital Music: {st['epoch_s']:.3f} s an epoch, {st['step_ms']:.3f} ms a "
            f"step against a {st['bound_ms']:.4f} ms bound ({st['bound_by']}), busy "
            + ("not measured" if st["profile"]["share"] is None
               else f"{100 * st['profile']['share']:.2f}%")
            + f", {st['profile']['events']:.1f} device events a step, peak "
            f"{st['peak'] / 2**30:.3f} GiB; MAE {st['errors'][0]:.4f}, RMSE {st['errors'][1]:.4f}, "
            f"NDCG@10 {st['ndcg']:.4f}")
    log("the CiteULike models: " + "; ".join(
        f"{name} fit {st['fit_s']:.3f} s, NDCG@100 {st['quality'][0]:.4f}, Recall@300 "
        f"{st['quality'][1]:.4f}" for name, st in cite["stats"].items()))
    log("ConvMF and HFT on ML-100K plots, fit seconds (host clock): " + ", ".join(
        f"{name} {res['Train (s)']:.3f}" for name, res in plots["results"].items()))
    log("the text and review models at the bench shape, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in textb_fit.items()))
    for name, st in toys["stats"].items():
        log(f"{name} at Amazon Toys & Games: fit {st['fit_s']:.3f} s, NDCG@50 "
            f"{st['quality'][0]:.4f}" + (f", RMSE {st['quality'][1]:.4f}" if len(st["quality"]) > 1
                                         else "")
            + ("" if "ms" not in st else
               f"; {st['ms']:.3f} ms a{' step' if name == 'HypAR' else 'n iteration'}, "
               f"{st['events']:.1f} device events a call, busy "
               + ("not measured" if st["share"] is None else f"{100 * st['share']:.2f}%"))
            + f", peak {st['peak'] / 2**30:.3f} GiB")
    log("the sentiment models' host builds at Amazon Toys & Games (host clock): " + ", ".join(
        f"{name} {sec:.3f} s" for name, sec in toys["host_s"].items()))
    log("the sentiment and explainable models at the bench shape, fit seconds (host clock): "
        + ", ".join(f"{name} {sec:.3f}" for name, sec in sentb_fit.items()))
    log(f"WMF at the Netflix widths: {wmf['sweep_s'][0]:.4f} / {wmf['sweep_s'][1]:.4f} s per "
        f"sweep, {100 * wmf['bound_s'] / min(wmf['sweep_s']):.2f}% of the FLOP bound, peak "
        f"{wmf['peak_fit'] / 2**30:.3f} GiB")
    log("neural family, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in neural_fit.items())
        + f"; NeuMF epoch busy {100 * neural_prof['share']:.2f}%")
    log(f"LightGCN edge form at ML-10M: one step forward and backward {lgcn['ms']:.3f} ms "
        f"(plain {lgcn['plain_ms']:.3f}, cuSPARSE {lgcn['library_ms']:.3f}, bound "
        f"{lgcn['bound_ms']:.4f} ms); 3 layers {lgcn['layers_ms']:.3f} ms")
    log(f"VAECF at the Netflix widths: {vaecf['epoch_s']:.3f} s per steady epoch, "
        f"{100 * vaecf['bound_s'] / vaecf['epoch_s']:.2f}% of the {vaecf['bound_s']:.4f} s FP32 "
        f"bound, peak {vaecf['peak'] / 2**30:.3f} GiB above what the run held")
    log(f"trainers: bench shape AUC {bench['quality']['AUC']:.4f} NDCG@10 "
        f"{bench['quality']['NDCG@10']:.4f}, train {bench['train_s']:.3f} s, test "
        f"{bench['test_s']:.3f} s, busy {100 * bench['share']:.2f}%; full width "
        f"{full['samples_per_s'] / 1e6:.3f} M samples/s, {100 * full['bound_s'] / full['epoch_s']:.3f}% "
        f"of the byte bound, busy {100 * full['share']:.2f}%")
    log(f"mesh, world size 1 (NCCL): BPR(mesh=...) 1-epoch fit {full['mesh_fit_s']:.3f} s, the "
        f"plain one {full['plain_fit_s']:.3f} s (host clock, set-up included); the mesh epoch "
        f"{full['mesh_epoch_s']:.3f} s, the plain one {full['epoch_s']:.3f} s; "
        f"RatioSplit(mesh=...).evaluate {bench['mesh_eval']:.3f} s")
    full_pairs = {**sasrec["mesh_pairs"], **basket["mesh_pairs"], "TIGER": tiger["mesh_pair"],
                  **{n: st["mesh_pair"] for n, st in transformer.items()},
                  "VBPR": vbpr["mesh_pair"],
                  **side["mesh_pairs"], **cloth["mesh_pairs"], **cite["mesh_pairs"],
                  **music["mesh_pairs"], **plots["mesh_pairs"], **toys["mesh_pairs"]}
    log("A8 (c) and (d) mesh fits at the full widths on a prefix of the rows (or a few "
        "iterations), world size 1, seconds mesh / plain (host clock, set-up included): "
        + ", ".join(f"{n} {m:.3f} / {p:.3f}" for n, (m, p) in full_pairs.items()))
    log("A8 (b), (c) and (d) mesh fits at the bench shape, world size 1, seconds "
        "mesh / plain (host clock): "
        + ", ".join(f"{n} {m:.3f} / {p:.3f}" for n, (m, p) in a8b.items())
        + f"; WMF(mesh=...) at the Netflix widths {wmf_mesh['mesh_s']:.3f} s against the plain "
        f"sweep's {wmf_mesh['plain_s']:.3f} s, peak {wmf_mesh['peak_mesh'] / 2**30:.3f} GiB against "
        f"{wmf_mesh['peak_plain'] / 2**30:.3f}; "
        f"NormAdjacency(mesh=...) at ML-10M, 3 layers {lgcn['mesh_ms']:.3f} ms against "
        f"{lgcn['layers_ms']:.3f}")
    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
