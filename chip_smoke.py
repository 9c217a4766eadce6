"""Drive the PyTorch/CUDA port (``gcnn_keras_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. Phases, in
order, each raising on a failed check:

1. device: card name and power limit, torch and CUDA versions; TF32 off.
2. build: every kernel in ``gcnn_keras_tpu_torch/csrc`` is compiled with
   nvcc (one process per source, all started together), and the C++
   neighbour list (``native/neighborlist.cpp``) with g++ by the port's
   loader; the phase fails if either does not build.
3. kernel: the sorted segment-sum against its plain PyTorch version at the
   shapes of the SchNet serving path and at edge cases, with times and
   bounds.
4. serving: ``MolDynamicsModelPredictor(EnergyForceModel(make_model()))`` at
   full SchNet width answers 3 requests of QM9-like molecules; energies and
   forces are checked (finite, translation invariant, equal to the same
   predictor on the CPU), the kernel launch count per evaluation is held to
   its derived value, and the time per evaluation is measured.
5. ACSF kernels: the four G2/G4 kernels (forward and force pass) against
   their plain versions at the HDNNP2nd serving shapes and at edge cases
   (``acsf_edge_batch``: the G4 fwd and jvp kernels' block layout, a
   molecule whose angles join nodes further apart than the G4 vjp
   kernel's shared window, a collinear triple, atoms without angles,
   unknown elements; all rows masked; no rows; for the G2 kernels also
   ``acsf_g2_edge_batch``: a receiver whose edges span three of the G2 fwd
   kernel's block ranges, receivers without edges inside a range and after
   the last edge, senders further apart than the G2 vjp kernel's shared
   window), with times and bounds.
6. HDNNP2nd serving: the Behler-mode HDNNP2nd of the JAX package's bench
   configuration, with ``set_angle`` as the graph preprocessor, answers the
   same 3 requests, checked as in phase 4, with every kernel's launch count
   per evaluation held to its derived value.
7. SPD solve kernels: the batched Gauss-Jordan solve against its plain
   version on the Qeq system that ``CENTCharge`` assembles from the first
   HDNNP4th request (the same values), with times and bounds, and at edge
   cases (G = 1, M = 1, M = 32 and 33 on either side of the warp and block
   kernels, M at the shared-memory gate, K = 1, the padding graph's
   identity system, an empty graph whose bordered corner is 1).
8. HDNNP4th serving: the flagship HDNNP4th of the JAX package's bench
   configuration with ESP coupling answers the same 3 requests, each
   molecule given an ESP, its gradient and a total charge of -1, 0 or +1;
   charges, energies and forces are checked (finite, charges summing to the
   total charge, forces summing to 0 where the ESP gradient is 0, equal to
   the same predictor on the CPU), with every kernel's launch count per
   evaluation held to its derived value.
9. ACSF JVP kernels: the G4 and G2 jvp kernels (the force loss's second
   reverse pass) against their plain versions at the HDNNP2nd serving shapes
   and at edge cases, with times and bounds; and the second-order pattern
   of ``tests/test_fused_g4.py`` (a derivative through the force pass), the
   kernel path against the plain path on the card.
10. training: for SchNet, HDNNP2nd, HDNNP4th and PAiNN, the JAX package's
   bench training step (``bench.py``: its batch, loss and ``adam(1e-3)``)
   through ``Trainer`` over ``EnergyForceModel.apply(create_graph=True)``;
   and GCN node classification at Cora scale (``sec_gcn_cora``: the
   synthetic 2708-node citation graph, the masked cross-entropy,
   ``adam(1e-2)``, full batch). The first step's loss and parameter
   gradients on a 64-molecule batch (GCN: the same full graph) equal the
   same step on the CPU; every kernel call of a step on the full-width
   batch is held against its plain version on the same inputs (the first
   call of each kernel timed, with its bound); then 5 steps on the
   full-width batch, each loss finite and the fifth below the first (PAiNN:
   finite; its bench recipe overshoots after the first update, as in the
   JAX package), with every kernel's launch count per step held to its
   derived value, the time per step and the peak memory.
11. SchNet MD kernels: the gather-multiply-segment-sum (``fused_aggregate``)
   and the fused cfconv (``accurate_cfconv``) against their plain versions
   at the SchNet serving shapes of the seed-0 request (the fused cfconv
   also against its plain version in float64), with times, bounds and the
   time of the unfused PyTorch chain, the fused cfconv also timed at the MD
   step's shape (phase 14's 21-atom molecule), and at edge cases (no edges,
   rows without edges, F or U 3 and 200, one edge, padding edges).
12. SchNet serving in the MD modes: ``make_model()`` with
   ``interaction_args={"fused_aggregate": True}``, then with
   ``{"accurate_cfconv": True}``, answers the 3 requests of phase 4,
   checked as there, against the same predictor on the CPU and against
   phase 4's unfused answers, with every kernel's launch count per
   evaluation held to its derived value and the time per evaluation.
13. The grad-of-grad pattern of ``tests/test_bilinear_family.py`` on the
   card: GMS against the plain chain.
14. MD: (a) ``bench.py`` ``sec_md_single`` (a 21-atom molecule, velocity
   Verlet) in each mode, each kernel call of an evaluation against its
   plain version, the time per MD step; (b) ``sec_md_ensemble`` (64
   replicas through ``ScannedMD``), the time per replica-step; (c) the NVE
   drift of ``tools/nve_drift_tpu.py``'s tethered 64-atom system in each
   mode, under ``tests/test_nve_conservation.py``'s bounds. Launches per
   step held in each; the modes' energies against the unfused ones.
15. Fused-chain kernels (run before phase 10, whose ``schnet_chain_train``
   path launches them): the fused interaction chain's forward, VJP and
   second-reverse kernels against their plain versions at the
   ``schnet_train`` shapes (its seed-0 batch and positions, the weights of
   the first interaction, random node features, cotangents and tangents),
   with times, bounds, the plain versions' times and the port's unfused
   chain for the same function, and at edge cases (no edges, all padding,
   one edge, rows without edges, coincident positions, senders 1000 rows
   away, N not a multiple of a block, U 3 and U at the shared-memory gate).
   The second-reverse kernel is held in both of its variants: as a force
   loss calls it (the weight tangents absent; its time is the ``kernels``
   line's) and with every tangent.
16. SchNet serving with ``fused_chain=True``: the 3 requests of phase 4,
   checked as there, against the CPU and phase 4's unfused answers.
   ``SCHNET_MODES``, which phase 14 runs, leaves this mode out.
17. PAiNN serving: ``MolDynamicsModelPredictor(EnergyForceModel(
   painn.make_model(...)))`` at the JAX package's bench configuration
   (``bench.py`` ``bench_painn_model``) answers the 3 requests of phase 4,
   checked as there; every segment-sum call of one evaluation of the
   first request is held against its plain version (the first call at 384
   columns, the equivariant messages, timed), the launch count per
   evaluation held to its derived value, and the time per evaluation and
   per request measured.
18. HDNNP4th at molecule scale: ``bench.py`` ``bench_large_mol_step``'s
   molecule (``large_mol_graph``, a curved chain) and model
   (``LARGE_MOL_KW``) at 200, 520 and 2080 atoms (``MOL_SIZES``: the
   bench's 520 and 2080, and 200, whose Qeq system takes the SPD block
   kernel). For each: every kernel call of one evaluation against its
   plain version, then one evaluation with its launches held to
   ``mol_launches`` against the CPU (energies, forces, charges summing to
   the total charge), timed; then the training path
   ``hdnnp4th_mol{n}_train`` as phase 10 runs one (its first step against
   the CPU on the same molecule, every kernel call of a step against its
   plain version, 5 timed steps with falling losses, peak memory). Then at
   520 and 2080 atoms the first step with ``solver="iterative"`` against
   the dense one on the same weights (loss and every gradient, to
   ``CG_LOSS_RTOL``/``CG_GRAD_TOL``; 4 CG solves, each stopping before its
   10 M rounds), and the steps that follow timed, dense and iterative in
   turns (``QEQ_AB_STEPS``). Last, the first HDNNP4th request of phase 8
   through ``MLMMEnergyForceModel``: its launches, its energy the inner
   one plus the QM/MM correction and its forces the inner ones plus
   ``-q dPhi/dr``, against the CPU.
19. The training entry point: each script of ``gcnn_keras_tpu_torch.scripts``
   (``SCRIPT_PATHS``) trains through ``run_force_training`` (``force_hdnnp4th``
   through its own ``train``) at its ``CONFIG`` widths, with the cuts of
   ``SCRIPT_CUTS``: 3 epochs (100), 512 synthetic frames (64) so that a fold
   takes enough steps to time, no PNGs. The first engine step is held
   against the same step on the CPU (the same weights and batch, to
   ``TRAIN_TOL``), each of its kernel calls against its plain version, and,
   for the scripts whose loss is a ``TRAIN_PATHS`` path's, its launches and
   every later step's against that path's; each fold's losses are finite
   and fall where phase 10 requires it; the fold artifacts exist, and fold
   0's checkpoint reloads into a fresh model that gives the energies of
   its ``energy_predictions.csv``. Prints the median ms per engine step
   after the first epoch (and the sync that ends it), the loader's host ms
   per batch and its waits an epoch, ms per epoch, ms of the validation
   pass and the rest of an epoch.
20. The fork's workflow, on phase 19's ensembles in its working directory
   (its cuts: 512 synthetic frames, 3 folds; no second training), for each
   script of ``SCRIPT_PATHS`` (``phase_workflow``): ``evaluate_models`` on
   the card, its launches ``members x (1 + ceil(frames / 32))`` evaluations
   of the model's (``script_eval_launches``), each member's artifacts, its
   outputs on the whole dataset and the report's MAEs against the same
   checkpoints on the CPU, every kernel call of member 0's evaluation
   against its plain version; ``calc_prediction_std`` against the CPU (each
   frame's force and energy std, the frames flagged at the CPU's median);
   ``load_model``'s energies of 16 frames against the CPU;
   ``transfer_learning`` from fold 0's checkpoint for ``TRANSFER_EPOCHS``
   epochs (the frozen parameters bit for bit, the trainable ones moved,
   finite losses, the first step against the CPU and its kernel calls
   against their plain versions). Then the five searches
   (``phase_searches``, ``SEARCHES``) on 512 frames, each cut to 3 trials
   of 1 epoch and the best one's 3 (``SEARCH_ARGS``; 9 trials, 5 and 30
   epochs by default): the trial files against the same
   ``HyperbandSearch`` on the CPU replaying their metrics, every objective
   finite, ``best_trial.json`` read back by ``retrieve_trial``, the first
   step of trial 0 against the CPU and its kernel calls against their plain
   versions. Prints ``<name> workflow: {...}`` (ms per member evaluation,
   of the ensemble's predictions, s of each script, ms per transfer epoch
   and step) and ``<search> search: {...}`` (ms per trial epoch and step, s
   per search).

21. Every option of the potentials (``phase_options``): HDNNP2nd's default
   (wACSF) model, ``make_model()``, answers the 3 requests with ``set_angle``
   (every segment-sum call of one evaluation against its plain version, the
   (E, 22) radial and (A, 10) angular sums timed; ``WACSF_LAUNCHES``);
   SchNet at the serving width in bfloat16, in the dense block and under
   remat (``SCHNET_OPTIONS``) answers them against the CPU and phase 4's
   float32 answers (bfloat16 within ``BF16_TOL``), every kernel call of one
   bfloat16 evaluation against its plain version, the bfloat16 (E, 128) sum
   timed; the training paths of phase 21 (``TRAIN_PATHS``: SchNet bfloat16,
   dense, remat and chain under remat, HDNNP2nd's wACSF model and HDNNP4th
   each with a ``GraphBatchNorm``) as phase 10 runs one; one
   ``apply_multistate`` evaluation of 3 states against the CPU; PAiNN MD at
   the bench width (phase 14's 21-atom molecule with its NVE drift, and 64
   replicas through ``ScannedMD``) against the CPU; ``force_inverse_distances``
   through phase 19's ``phase_script``. The device's busy share of each of
   phase 21's serving and training paths (``busy_share``,
   ``torch.profiler``) is taken at the end of the script, after every timed
   part.

22. The zoo's first group (``phase_zoo``): GIN, GraphSAGE, GAT, GATv2, RGCN,
   GNN-FiLM and INorp (``ZOO_MODELS``) at their ``model_default`` widths on
   phase 4's 512 molecules (``zoo_graphs``: integer edge attributes, edge
   relations and INorp's graph attributes drawn from a seed). For each: a
   graph-level forward against the same weights on the CPU (GIN also with
   ``train=True``, its batch statistics and running averages), every
   segment-sum call of one forward and of one training step against its
   plain version (each new shape timed with its bound and ``index_add_``),
   the first step (Adam 1e-3, a masked graph MAE on seeded labels; on the
   first 64 molecules) against the CPU's, then ``ZOO_STEPS`` steps with
   falling losses; launches per forward and per step held to
   ``ZOO_LAUNCHES``, host syncs of each (``host_syncs``), ms per forward and
   per step. Then the graph-learning
   drivers (``ZOO_DRIVERS``: ``train_tudataset`` with GIN,
   ``train_moleculenet`` with GIN and GAT) through their ``main``, cut to 3
   epochs of 2 folds: finite losses, the score file, the first step against
   the CPU and its kernel calls against their plain versions, every step's
   launches; ms per step and per epoch. The busy share of one training
   step of each model is taken at the end of the script, after phase 21's.

23. The zoo's second group (``phase_zoo`` again): DMPNN, CMPNN, NMPN,
   AttentiveFP, HamNet and MEGAN, the rows of ``ZOO_MODELS`` in phase 23,
   checked as phase 22's models (every output against the CPU: MEGAN's
   node and edge importances too), with the peak memory of a forward and
   of a step; their first steps take ``check_grads``' float64 rules. Then
   ``train_moleculenet`` with AttentiveFP, as phase 22's drivers.

24. The zoo's third group (``phase_zoo`` again): the energy and force
   potentials EGNN, Megnet, DimeNet++ and MXMNet on ``train_force``'s 512
   frames of ``SyntheticMDDataset`` at seed 0, with the driver's edges and
   scaled labels (``force_frames``; DimeNet++ with the
   ``set_angle_edge_pairs`` of the edges, MXMNet on the driver's multiplex
   graphs); CGCNN on phase 4's 512 molecules; and the
   ``make_crystal_model`` of CGCNN, Megnet and DimeNet++ on the goldens'
   periodic cells repeated to 512 graphs (``zoo_crystals``). DimeNet++'s
   and MXMNet's zero-initialised output heads are filled from a seed
   (``fill_zero_heads``). Each batch's shapes, pairs included, are held to
   ``ZOO_SHAPES``. Checked as phase 23's models, with a fresh set of timed
   shapes; the potentials train as ``EnergyForceModel`` with
   ``create_graph`` on ``train_force``'s loss (energy MAE + 50 x force MAE,
   under its warm-up), their energies and forces held against the CPU's by
   ``check_grads``' float64 rules; the rest train on the masked graph MAE. Then ``train_force`` with MXMNet and EGNN
   (``phase_zoo_driver``), as phase 22's drivers, and the force steps of
   DimeNet++ and MXMNet with the spherical basis's radial part in its one
   recursion and in the JAX package's recursion per order, in turns
   (``phase_bessel_forms``, after phase 25).

25. The padded-form models, the configuration library and the kgcnn
   compatibility layer (``phase_zoo`` again, a fresh set of timed shapes):
   MAT as the port's ``HyperParameter`` builds ``hyper_esol.py``'s entry,
   and the Graph U-Net at its ``model_default``, on phase 4's 512
   molecules, checked as phase 23's models; they launch no kernel
   (``ZOO_LAUNCHES`` (0, 0)). The U-Net's gPool selections are held equal
   to the CPU's first (``check_selection``: a difference only at a near
   tie is recorded, and the answers are then held with the CPU's
   selections imposed). Then ``train_force --hyper
   training/hyper/hyper_synthetic_md.py`` with SchNet and PAiNN at the
   config's widths on its 256 frames, cut to 3 epochs of one fold, as
   phase 22's drivers; then the compatibility layer on the seed-0 request
   at 128 columns (``phase_compat``): ``PoolingLocalEdges``,
   ``PoolingNodes``, ``PoolingGlobalEdges`` and a ``MessagePassing``
   subclass (their segment-sum calls against the plain version, 3
   launches a pass), ``PoolingLocalEdgesLSTM`` and ``PoolingTopK`` against
   the CPU; each layer's ms. Prints the phase's seconds.

26. The reverse-over-forward force step (``phase_fast_step``,
   ``FAST_PATHS``; ``training/fast_force_step.py``): for phase 10's
   ``schnet_train`` (also with ``fused_aggregate`` and with ``remat``),
   ``painn_train``, ``hdnnp2nd_train`` and ``hdnnp4th_train``, on the
   path's model, seed-0 weights and full batch, with the loss the fast step
   computes (energy MAE + the path's force weight x force MAE; HDNNP4th
   without its charge term and ESP force coupling, which the JAX fast step
   has neither of): its first step on the card against the CPU's on the
   first-step batch; one step of ``make_force_train_step`` against one
   ``Trainer`` step (reverse over reverse) on the same weights, the loss,
   both metrics and every gradient within the path's tolerance; then
   ``FAST_STEPS`` steps of each, every step's launches against the derived
   counts, the ms a step (the median after the first) and, with the other
   profiles at the end, each step's busy share. Then each kernel
   Function's ``jvp`` on the card against forward-mode AD of its plain
   version at a path's shapes (``phase_jvp_rules``: #1 and gms at
   ``schnet_train``'s, the G4 and G2 tangents at ``hdnnp2nd_train``'s, the
   SPD solve at ``hdnnp4th_train``'s Qeq system), and the three
   reverse-only SchNet modes raising in forward mode, each naming its mode
   (``phase_reverse_only``).

27. The last root drivers (``phase_zoo`` again, ``ZOO_DRIVERS``' phase-27
   rows): ``train_citation``, ``train_qm``, ``train_crystal`` (SchNet,
   CGCNN) and ``train_visual_graph_dataset`` (both datasets) through
   ``phase_zoo_driver``; periodic ``ScannedMD`` of the crystal SchNet
   against the CPU (``phase_periodic_md``); the fork's chain, extxyz,
   ``prepare_data``, ``force_schnet`` and both harnesses
   (``phase_fork_chain``).

28. The dataset layer (``phase_datasets``): Cora at graph2gauss's
   published shape, 2048 QM9 molecules, 1000 rMD17 aspirin frames and
   MUTAG at its published counts, written in their published layouts into
   a temporary dataset root (no fetch leaves the machine), each built as
   its driver builds it and timed on the host; then ``train_citation
   --hyper hyper_cora.py``, ``train_qm --hyper hyper_qm9_energies.py``,
   ``train_force --hyper hyper_md17_revised.py`` and ``train_tudataset
   --dataset MUTAG`` through ``phase_zoo_driver`` (first steps against the
   CPU, every #1 call against its plain version, every step's launches);
   a missing file raises ``FileNotFoundError`` and ESOL, without RDKit,
   its ``ImportError`` after reading its CSV.

29. Slice 19 (``phase_slice19``): (a) the C++ neighbour lists
   (``phase_native_lists``) at phase 18's 520 and 2080 atoms and on a
   216-atom periodic cell against the dense lists (equal indices and
   images, distances within ``NATIVE_DIST_RTOL``), the host ms of each
   backend in turns; SchNet at ``make_model()``'s widths in ``ScannedMD``
   over a 288-atom helix re-neighboured through ``"auto"``, and so the C++
   list, each segment (``phase_native_md``: launches, energies and
   positions against the CPU within ``MD_TOL``, ms per step); phases 18
   and 27 print which list they took. (b) ``GNNExplainer`` at its defaults
   on phase 10's GCN at Cora scale (``phase_explainer``): every kernel call
   of the target's forward and of one epoch against its plain version, the
   first epoch's loss and mask gradients against the CPU within
   ``TRAIN_TOL``, the launches of 100 epochs, the losses falling, ms an
   epoch, host syncs, the final masks against a CPU run; (c) the ASE
   bridge's ``calculator_results`` on a stand-in ``Atoms`` through the
   SchNet and HDNNP4th predictors (``phase_ase_bridge``: launches, energy,
   forces and charges against the CPU); (d) ``ThroughputMeter`` over (b)'s
   epochs, ``device_memory_stats``, and ``trace`` around one serving
   evaluation naming #1's kernel (``phase_trace``).

30. Slice 20, ``parallel/`` (``phase_parallel``), on 2 ranks that share
   the one card over gloo (NCCL refuses two ranks on one card; the
   collectives gloo takes on the CPU only stage through page-locked host
   memory). (a) ``Trainer(mesh=...)`` on ``schnet_train`` and
   ``hdnnp4th_train`` (each rank its own batch of the path's size, seeds
   ``seed`` and ``seed + 1``): the first step's loss and averaged
   gradients against the mean of the two single-rank steps on the card
   within ``TRAIN_TOL``, then ``TRAIN_STEPS`` steps (losses finite and
   falling, each step's launches the path's, the replicas' parameters equal
   bit for bit), ms a data-parallel step beside the single-rank step's.
   (b) SchNet at ``make_model()``'s widths on the ``PARTITION_NODES``-node
   chain of ``tests/test_partitioned_model.py`` (the port's C++ list),
   partitioned over the 2 ranks: energy per node and forces against the
   same model on one rank (``PARTITION_E_TOL``, ``PARTITION_F_TOL``, the
   JAX test's), one partitioned step's parameter gradients against the
   oracle's within ``TRAIN_TOL``, every #1 call of rank 0 against its plain
   version, one evaluation with ``fused_aggregate=True`` (the unfused route
   on a shard: no fused launch, the same energy and forces), the halo, ms an evaluation and a step beside the oracle's, the
   backend and what was staged. (c) ``ScannedMD.run_ensemble(n_devices=2)``
   of phase 14's 64-replica ensemble against ``n_devices=1`` within
   ``MD_TOL``. (d) ``train_force --distributed`` as 2 ranks that join from
   a launcher's variables (torchrun's ``WORLD_SIZE``, ``RANK`` and
   ``LOCAL_RANK``, a file store's address as ``JAX_COORDINATOR_ADDRESS``;
   ``run_zoo_driver`` in each): the first step's
   loss and averaged gradients against the mean of the CPU's steps on the
   two ranks' batches. Each rank's launches are a path of the ``kernels``
   line. Nothing is timed across two cards: there is one.
31. Slice 21, the partitioned HDNNP4th (``phase_partitioned_hdnnp``), on 2
   ranks sharing the card over gloo as in phase 30: the flagship HDNNP4th
   (``HDNNP4TH_KW``, ESP coupling, weights from seed 0) on
   ``bench_large_mol_step``'s ``PART_HDNNP_ATOMS``-atom helix
   (``large_mol_graph``: ``set_range`` at 3.5 with 12 neighbours, then
   ``set_angle``; total charge 0). (a) The single-rank oracle first, while
   the card is this process's alone: the same model with the dense Qeq
   (Cholesky) on the whole molecule. (b) The partitioned evaluation
   (``make_partitioned_energy_force``, the charges through the row-sharded
   CG to ``PART_HDNNP_CG_TOL``): energy, forces and charges against the
   oracle, the charges summing to the total charge across the shards, at
   ``tests/test_partitioned_model.py``'s tolerances (``PART_HDNNP_TOL``).
   (c) One partitioned step of the flagship loss (``PART_HDNNP_W``: 50 q
   + 1 E + 200 F against the molecule's labels): its loss and parameter
   gradients against the oracle's. Every #1 call of rank 0's warm-up
   against its plain version; each rank's launches over the timed
   evaluations and steps: #1 above 0, #3 and #8-#13 none (a shard's ACSF
   layers run plain, as in the JAX package, and its Qeq is the CG). The
   halo, the remote share, the CG rounds a solve, ms an evaluation and a
   step (wall; and rank 0's device ms under ``torch.profiler``) beside the
   oracle's. (d) ``python -m
   gcnn_keras_tpu_torch.scripts.partitioned_giant_graph`` with
   ``PART_EXAMPLE_ARGS`` (``--check``: its energy and forces against one
   device) exits 0.

Each kernel's ``ms`` and ``bound_ms`` in the ``kernels`` line are those of
its timed check at the shapes of the first path that launched it; the
segment-sum's bfloat16 instance has an entry of its own
(``sorted_segment_sum_bf16``).

Prints ``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` gives them, and last the line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and prints
no result.
"""
import contextlib
import functools
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# special-function results (exp2, log2, sin, cos, rsqrt, rcp): 16 per clock
# per SM (CUDA programming guide, compute capability 9.0) x 132 SMs x the
# 1.98 GHz boost clock of the H100 SXM
H100_SFU_PER_S = 16 * 132 * 1.98e9
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2, so each timed launch starts cold
# ~0.1 ms of device sleep before each timed launch: the host queues the
# launch meanwhile, so the timed interval holds no host-side gap
HEAD_START_CYCLES = 200_000
# segment-sum launches per energy+force evaluation at depth 4 (see
# schnet_launches): energy pass 4 pool_edges_to_nodes + 1
# pool_nodes_to_graph; force pass the transposes of pos_j and pos_i in
# edge_vectors and of gather_sender_nodes in interactions 1-3 (interaction
# 0's input does not depend on coordinates)
LAUNCHES_PER_EVAL = 10
KERNEL_TOL = 1e-5  # max|kernel - plain| <= KERNEL_TOL * (1 + max|plain|)
SERVE_TOL = 1e-4   # max|gpu - cpu| <= SERVE_TOL * max|cpu|, per output
# the segment-sum's bfloat16 instance against its plain version: each rounds
# a float32 sum to bfloat16 once, and two float32 sums in other orders
# (index_add_'s atomics on the card) may round to neighbouring bfloat16
# values, one bfloat16 ulp apart: at most 2^-7 of the value
BF16_KERNEL_TOL = 2.0 ** -7
# a bfloat16 model against the same model elsewhere (the card against the
# CPU, or bfloat16 against float32), per key: max|a - b| <= BF16_TOL[key] *
# max|b|. "atom" is the graph pool's input (last_mlp's output on the real
# atoms, before the molecules' energies cancel), "energy" and "force" the
# answers, "loss" a training step's first loss and "grad" each parameter's
# gradient (against that tensor's largest entry). Each is twice the JAX
# package's own gap for its key, the largest over the inputs below, rounded
# up: its SchNet with dtype="bfloat16" against the float32 one, on the CPU,
# on this script's SchNet weights (seed 0, the bench width). Two bfloat16
# runs that round in other places, each that far from float32, differ by
# up to twice it. The outputs, on the first 64 molecules of each request
# (seeds 0-2): atom 0.118-0.134, energy 0.116-0.184, force 0.039-0.068. The
# first step (force weight 100): the gradients on the two batches the
# first-step checks take, _mols(RandomState(2), 64) and (7, 16), 0.135 and
# 0.211 (on other batches the gap reaches 1.0: an energy MAE's sign flips
# where a prediction lies near its label); the loss, one number a batch
# that spreads from 6.6e-7 to 5.08e-4 over the batches of ten seeds at each
# of those two sizes (jitted), over those twenty.
# tests/test_torch_schnet_options.py measures each.
BF16_TOL = {"atom": 0.27, "energy": 0.37, "force": 0.14, "loss": 1.1e-3, "grad": 0.43}
# ACSF kernels: max|kernel - plain| <= tol * (1 + max|plain|), and in the
# forward pass also, for each set s, max|kernel - plain| over its columns
# <= tol * max|plain| over them. The forward sums each output in another
# order than index_add_ (G4 in a fixed order, G2 with shared-memory
# atomics); the force (vjp) and tangent (jvp) passes add terms of both signs
# (the force passes and the G2 tangent pass with atomics, in an order that
# varies from run to run) and share ACSF_VJP_TOL
ACSF_FWD_TOL = 1e-5
ACSF_VJP_TOL = 1e-4
# the second-order pattern: |kernel - plain| <= tol * max(|plain|, 1), the
# tolerance of tests/test_fused_g4.py
SECOND_ORDER_TOL = 1e-3
# the JAX package's HDNNP2nd bench configuration (bench.py
# bench_hdnnp2nd_model), written out: G2 4 sets x 5 elements, G4 8 sets x 15
# element pairs, a [64, 64, 1] network per atomic number
HDNNP_ELEMENTS = [1, 6, 7, 8, 9]
HDNNP2ND_KW = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 4.0, "elements": HDNNP_ELEMENTS},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 4.0,
               "zeta": [1.0, 8.0], "elements": HDNNP_ELEMENTS, "multiplicity": 2.0},
    mlp_kwargs={"units": [64, 64, 1], "num_relations": 10,
                "activation": ["swish", "swish", "linear"]})
HDNNP_SHAPES = (8192, 54784, 417024, 513)  # N, E, A, G of the seed-0 request
# every kernel of the port, by its name in the launch counts
KERNEL_NAMES = ("g2_fwd", "g4_fwd", "g4_vjp", "g2_vjp", "g4_jvp", "g2_jvp",
                "sorted_segment_sum", "sorted_segment_sum_bf16", "spd_solve",
                "gather_mul_segsum", "fused_cfconv", "cf_fwd", "cf_vjp", "cf_hesjvp")


def launch_counts(**nonzero):
    """A launch count for every kernel: ``nonzero``, the others 0."""
    unknown = set(nonzero) - set(KERNEL_NAMES)
    if unknown:
        raise KeyError(f"unknown kernels {sorted(unknown)}")
    return {**dict.fromkeys(KERNEL_NAMES, 0), **nonzero}


# SchNet's execution modes (interaction_args) on one parameter set: the MD
# modes, which phase 14 runs, and the fused-chain training mode
SCHNET_MODES = {"unfused": {}, "fused": {"fused_aggregate": True},
                "accurate": {"accurate_cfconv": True}}
MODE_ARGS = {**SCHNET_MODES, "chain": {"fused_chain": True}}


def schnet_launches(mode, depth=4, remat=False, dtype=None, train=False):
    """Kernel launches per SchNet energy+force evaluation (``train``: per
    training step) of ``depth`` interactions (see PERF.md). The energy pass
    sums onto the receivers in each interaction (unfused: a segment-sum;
    fused: the gms kernel; accurate: the fused cfconv kernel) and pools onto
    the graphs (a segment-sum). The force pass runs the transposes of pos_j
    and pos_i in ``edge_vectors`` (2 segment-sums) and, in interactions 1 to
    depth-1, the cotangent of the node features by sender (a segment-sum:
    the transpose of the sender gather, or GMS's ct_x); interaction 0's node
    features do not depend on the coordinates. GMS's ct_m and the fused
    cfconv's backward are gathers and matmuls, no kernel. The fused chain
    (``chain``) computes no edge vectors: each interaction runs cf_fwd in
    the energy pass and cf_vjp in the force pass, and the graph pool is the
    one segment-sum (its backward is a gather).

    A training step (unfused or chain) adds the loss's reverse pass along
    the parameters: unfused, the transposes of the sender gathers of
    interactions 0 to depth-1 (the energy term reaches the embedding), and,
    through the force pass, those of the gathers that are the backward of
    the depth edge pools and of the graph pool (the output MLP after the
    pool makes the pooled cotangent depend on the parameters); chain, CF's
    backward once with the summed cotangent (cf_vjp) and BWD's backward
    once (cf_hesjvp) in each interaction, and the transpose of the graph
    pool's backward gather.

    ``dtype="bfloat16"``: the messages, their sums and the transposes of
    the sender gathers are bfloat16 and take the segment-sum's bfloat16
    instance; the graph pool and ``edge_vectors`` stay float32. Such an
    interaction has no fused kernel (``fused`` takes the unfused chain).
    ``remat``: every reverse pass through the checkpointed forward reruns
    each interaction's forward, and with it its kernel (the edge pool's
    segment-sum, gms, cf_fwd): the force pass once, a training step's loss
    pass once more."""
    bf16 = dtype == "bfloat16"
    if mode == "chain":
        counts = launch_counts(cf_fwd=depth, cf_vjp=depth * (2 if train else 1),
                               cf_hesjvp=depth if train else 0,
                               sorted_segment_sum=2 if train else 1)
        rerun = "cf_fwd"
    else:
        msg = "sorted_segment_sum_bf16" if bf16 else "sorted_segment_sum"
        rerun = msg if bf16 else {"unfused": msg, "fused": "gather_mul_segsum",
                                  "accurate": "fused_cfconv"}[mode]
        if train and rerun != msg:
            raise ValueError(f"no derived training launches for mode {mode!r}")
        counts = launch_counts(sorted_segment_sum=1 + 2)
        counts[rerun] += depth
        counts[msg] += depth - 1
        if train:
            counts["sorted_segment_sum"] += 1
            counts[msg] += 2 * depth
    if remat:
        counts[rerun] += depth * (2 if train else 1)
    return counts


# MD (bench.py sec_md_single, sec_md_ensemble; tools/nve_drift_tpu.py), see
# PERF.md for the cuts: velocity Verlet at dt 5e-4 on 21-atom molecules,
# the time per step the smallest slope between MD_STEPS (bench: 50 and 400)
# over MD_PAIRS interleaved pairs; the ensemble of 64 replicas through
# ScannedMD, one segment to warm up, then ENSEMBLE_SEGMENTS timed (bench: 4
# of 500 steps); the NVE drift of the 64-atom tethered system at dt 0.01
# over NVE_STEPS (the tool: 5000), held to tests/test_nve_conservation.py's
# bounds
MD_DT = 5e-4
MD_STEPS = (50, 200)
MD_PAIRS = 4
ENSEMBLE_REPLICAS = 64
ENSEMBLE_SEGMENT_STEPS = 100
ENSEMBLE_SEGMENTS = 2
NVE_STEPS = 600
NVE_BOUNDS = {"rel_drift": 2e-4, "rel_drift_per_step": 1e-7}
# the energies of one trajectory in two modes (same weights, same start):
# max|e_mode - e_unfused| <= MD_TOL * max|e_unfused|
MD_TOL = 1e-4


# kernel launches per HDNNP2nd energy+force evaluation: the energy pass runs
# the G2 and G4 forward kernels and pools atoms to molecules (one
# segment-sum); the force pass runs the G4 and G2 vjp kernels, and the
# backward of the pool is a gather, which launches nothing
HDNNP_LAUNCHES = launch_counts(g2_fwd=1, g4_fwd=1, g4_vjp=1, g2_vjp=1, sorted_segment_sum=1)
# per evaluation of HDNNP2nd's default (wACSF) model: the radial sum by
# receiver (E, 22), the angular sum by angle centre (A, 10) and the pool
# onto the graphs, segment-sums all three; the force pass's backwards are
# gathers. A training step adds the transposes of the force pass's gathers
# of the two descriptor sums (2); the pool's backward gathers a constant
WACSF_LAUNCHES = launch_counts(sorted_segment_sum=3)
# the TPU kernel each ACSF kernel replaces (its pl.pallas_call line)
ACSF_REPLACES = {"g2_fwd": "gcnn_keras_tpu/ops/pallas/fused_g4.py:1088",
                 "g4_fwd": "gcnn_keras_tpu/ops/pallas/fused_g4.py:660",
                 "g4_vjp": "gcnn_keras_tpu/ops/pallas/fused_g4.py:729",
                 "g2_vjp": "gcnn_keras_tpu/ops/pallas/fused_g4.py:1147",
                 "g4_jvp": "gcnn_keras_tpu/ops/pallas/fused_g4.py:691",
                 "g2_jvp": "gcnn_keras_tpu/ops/pallas/fused_g4.py:1106"}
FORCE_SUM_TOL = 1e-5  # |sum_i F_i| <= FORCE_SUM_TOL * n_atoms * max_i |F_i|
# the JAX package's flagship HDNNP4th bench configuration (bench.py
# bench_hdnnp4th_model), written out: the ACSF tables of HDNNP2ND_KW, a
# [64, 64, 1] network per atomic number for chi and for the local energies,
# fixed physical Qeq tables, the default dense Cholesky (Schur) Qeq solve
HDNNP4TH_KW = dict(
    g2_kwargs=HDNNP2ND_KW["g2_kwargs"], g4_kwargs=HDNNP2ND_KW["g4_kwargs"],
    mlp_charge_kwargs=HDNNP2ND_KW["mlp_kwargs"], mlp_local_kwargs=HDNNP2ND_KW["mlp_kwargs"],
    electrostatic_kwargs={"param_trainable": False})
# kernel launches per HDNNP4th energy+force evaluation (see PERF.md): the
# energy pass runs the G2 and G4 forward kernels, the Qeq solve (one
# spd_solve with K = 2) and three sorted sums over graph_id (the self
# energy, the QM/MM energy and the short-range pool; the pair energy is an
# unsorted sum over edge_graph_id); the force pass runs the G4 and G2 vjp
# kernels, the adjoint Qeq solve (one spd_solve) and the transposes of the
# receiver and sender gathers of the [pos|sigma|q] table (two sorted sums)
HDNNP4TH_LAUNCHES = launch_counts(g2_fwd=1, g4_fwd=1, g4_vjp=1, g2_vjp=1,
                                  sorted_segment_sum=5, spd_solve=2)
HDNNP4TH_M = 20  # max_nodes of the three requests: the Qeq systems are 20 x 20
# the JAX package's PAiNN bench configuration (bench.py bench_painn_model),
# written out: depth 3, 128 units, the cosine cutoff at 5.0 on every filter,
# 20 Bessel radials to 5.0, a [128, 1] swish/linear output MLP
PAINN_KW = dict(depth=3, conv_args={"units": 128, "cutoff": 5.0},
                update_args={"units": 128}, input_embedding={"node": {"output_dim": 128}},
                bessel_basis={"num_radial": 20, "cutoff": 5.0},
                output_mlp={"units": [128, 1], "activation": ["swish", "linear"]})
# segment-sum launches per PAiNN energy+force evaluation (see PERF.md): the
# energy pass pools the scalar (E, 128) and equivariant (E, 3, 128) messages
# in each of the 3 convs and pools the nodes onto the graphs (7); the force
# pass runs the transposes of pos_j and pos_i in edge_vectors and of the
# sender gathers of phi and v in convs 1-2 (6). Conv 0's phi and v do not
# depend on the coordinates (v starts at 0); the pools' backwards are
# gathers.
def painn_launches(depth):
    """Kernel launches per PAiNN energy+force evaluation of ``depth``
    blocks."""
    return launch_counts(sorted_segment_sum=2 * depth + 1 + 2 + 2 * (depth - 1))


PAINN_LAUNCHES = painn_launches(3)
PAINN_WIDE = 3 * 128  # the equivariant messages' columns, (E, 3, U) flattened
# SPD solve: max|kernel - plain| <= SPD_TOL * (1 + max|plain|) and
# max|A x - b| <= SPD_RESIDUAL_TOL * (1 + max|b|)
SPD_TOL, SPD_RESIDUAL_TOL = 1e-5, 1e-4
# the block kernel's (M > 32) shapes timed in phase 7, at the serving G: a
# ligand or small peptide, and the largest M the kernel takes at K = 2
SPD_BLOCK_TIMED_M = (100, 239)
# charges of a molecule sum to its total charge within CHARGE_TOL * (1 + sum|q|)
CHARGE_TOL = 1e-4
# bench.py bench_large_mol_step's model (make_model_behler at bench.py:743-756),
# written out: HDNNP2ND_KW's tables at r_c 3.5, a [64, 64, 1] network per
# atomic number for chi and for the local energies, fixed physical Qeq
# tables, solver "auto" (dense below CENTCharge's iterative_threshold)
LARGE_MOL_KW = dict(
    g2_kwargs={**HDNNP2ND_KW["g2_kwargs"], "rc": 3.5},
    g4_kwargs={**HDNNP2ND_KW["g4_kwargs"], "rc": 3.5},
    mlp_charge_kwargs=HDNNP2ND_KW["mlp_kwargs"], mlp_local_kwargs=HDNNP2ND_KW["mlp_kwargs"],
    electrostatic_kwargs={"param_trainable": False, "solver": "auto"})
# phase 18's molecules: bench.py's 520 and 2080 atoms (sec_hdnnp_large_mol,
# sec_hdnnp_giant_mol), and 200, inside the SPD block kernel's range
MOL_SIZES = (200, 520, 2080)
# the largest M the SPD kernels take at K = 2 (ops/cuda/spd_solve.py
# max_kernel_m(2)); Cholesky beyond
SPD_MAX_M = 239


def mol_launches(n, train=False):
    """Kernel launches per HDNNP4th evaluation (``train``: training step) of
    one molecule of ``n`` atoms: those of ``HDNNP4TH_LAUNCHES`` (a step:
    ``TRAIN_PATHS["hdnnp4th_train"]``), with the SPD solves only where the
    ``(n, n)`` Qeq system fits the kernel (``SPD_MAX_M``); past that the
    solve is Cholesky, which launches none of the port's kernels."""
    counts = dict(HDNNP4TH_LAUNCHES)
    if train:
        counts.update(g4_jvp=1, g2_jvp=1, sorted_segment_sum=7, spd_solve=4)
    if n > SPD_MAX_M:
        counts["spd_solve"] = 0
    return counts


# CG calls of the iterative Qeq solve (each the 2 G systems of the batch) per
# evaluation and per training step, derived as the SPD solves are: the solve
# and its adjoint in the force pass; in training also the backward of each
CG_SOLVES = {"eval": 2, "train": 4}
# the iterative step against the dense one on the same weights, the
# tolerances of tests/test_qeq_solver.py::test_iterative_qeq_inside_full_force_train_step:
# |loss_cg - loss_dense| <= CG_LOSS_RTOL * |loss_dense|, and for each
# parameter max|grad_cg - grad_dense| <= CG_GRAD_TOL * max|grad_dense|
CG_LOSS_RTOL, CG_GRAD_TOL = 5e-5, 5e-4
# steps timed per solver in the dense-against-CG comparison, by atoms
QEQ_AB_STEPS = {520: 5, 2080: 5}
# kernel launches of one ML/MM evaluation (phase 18): HDNNP4th's, and the
# QM/MM energy correction's sum over graph_id (no backward: the wrapper
# adds it after the forces)
MLMM_LAUNCHES = {**HDNNP4TH_LAUNCHES, "sorted_segment_sum": 6}
# The training paths: the JAX package's bench training steps (bench.py
# bench_schnet_setup, sec_hdnnp2nd and sec_painn with _ef_train_step,
# _hdnnp_setup): the batch _mols(RandomState(seed), size, with_esp), the loss
# charge_weight * q_MAE + E_MAE + force_weight * F_MAE, adam(1e-3); and
# sec_gcn_cora: the citation graph of size nodes from seed, the masked
# cross-entropy of the node logits, adam(1e-2).
# Kernel launches per step (see PERF.md): the evaluation of serving with
# create_graph=True, then the loss's reverse pass along the parameters:
# - SchNet (10 + 9): the transposes of the sender gathers of interactions
#   0-3 (the energy term reaches the embedding), and, through the force
#   pass, the transposes of the gathers that are the backward of the four
#   edge pools and of the graph pool (the output MLP after the pool makes
#   the pooled cotangent depend on the parameters);
# - HDNNP2nd (5 + 2): the G4 and G2 jvp kernels, the backward of the vjp
#   Functions; the pool's backward gathers a constant cotangent, so its
#   transpose is not needed;
# - HDNNP4th (11 + 6): the jvp kernels; two solves (the backward of the Qeq
#   solve, and the backward of the adjoint solve that the force pass made);
#   the transposes of the receiver and sender gathers of the [pos|sigma|q]
#   table (the energy term along q);
# - SchNet with fused_chain=True (4 + 4 + 1, then 4 + 4 + 1): in each
#   interaction, the loss's reverse pass runs CF's backward once with the
#   summed cotangent (cf_vjp) and BWD's backward once (cf_hesjvp); the
#   transpose of the graph pool's backward gather is the second segment-sum.
#   Its kernels are timed in phase 15 on the same batch;
# - PAiNN (13 + 12): the transposes of the sender gathers of phi in convs
#   0-2 and of v in convs 1-2 (5), and, through the force pass, the
#   transposes of the gathers that are the backward of the six edge pools
#   and of the graph pool (7; the output MLP comes after the pool);
# - GCN (3 + 3): no force pass; the three weighted edge pools, then the
#   transposes of the three sender gathers (conv 0's input is
#   embed_to_units of the features, which depends on the parameters).
TRAIN_PATHS = {
    "schnet_train": dict(model="schnet", seed=0, size=512, with_esp=False,
                         global_keys=("energy",), force_weight=100.0, charge_weight=0.0,
                         launches=schnet_launches("unfused", train=True)),
    "schnet_chain_train": dict(model="schnet", mode="chain", seed=0, size=512,
                               with_esp=False, global_keys=("energy",), force_weight=100.0,
                               charge_weight=0.0, time_calls=False,
                               launches=schnet_launches("chain", train=True)),
    "hdnnp2nd_train": dict(model="hdnnp2nd", seed=5, size=1024, with_esp=True,
                           global_keys=("energy",), force_weight=100.0, charge_weight=0.0,
                           launches=launch_counts(g2_fwd=1, g4_fwd=1, g4_vjp=1, g2_vjp=1,
                                                  g4_jvp=1, g2_jvp=1, sorted_segment_sum=1)),
    "hdnnp4th_train": dict(model="hdnnp4th", seed=1, size=128, with_esp=True,
                           global_keys=("energy", "total_charge"), force_weight=200.0,
                           charge_weight=50.0,
                           launches=launch_counts(g2_fwd=1, g4_fwd=1, g4_vjp=1, g2_vjp=1,
                                                  g4_jvp=1, g2_jvp=1, sorted_segment_sum=7,
                                                  spd_solve=4)),
    # Two differences from the other paths, both the bench recipe's and not
    # the port's (PERF.md; tests/test_torch_painn.py): its loss jumps
    # after the first Adam step in both packages and need not be below the
    # first by the fifth (falls=False); and its force-loss gradients carry
    # float32 noise of a few 1e-5 of a tensor's largest entry in either
    # package (the second derivative of |v| on the init's small equivariant
    # features), so two float32 runs, the card's and the CPU's, are held to
    # grad_tol, 5 x TRAIN_TOL
    "painn_train": dict(model="painn", seed=4, size=256, with_esp=False,
                        global_keys=("energy",), force_weight=100.0, charge_weight=0.0,
                        falls=False, grad_tol=5e-4,
                        launches=launch_counts(sorted_segment_sum=13 + 5 + 7)),
    # the first step against the CPU on the same full graph
    "gcn_cora_train": dict(model="gcn", seed=1, size=2708, first_step=(1, 2708),
                           launches=launch_counts(sorted_segment_sum=3 + 3)),
    # phase 18: bench.py bench_large_mol_step, one molecule of size atoms
    # (large_mol_graph), and the same at 200 atoms, where the Qeq system
    # takes the SPD block kernel; each first step against the CPU on its
    # own batch
    **{f"hdnnp4th_mol{n}_train": dict(model="hdnnp4th_mol", seed=3, size=n, first_step=(3, n),
                                      global_keys=("energy", "total_charge"),
                                      force_weight=200.0, charge_weight=50.0,
                                      launches=mol_launches(n, train=True), phase=18)
       for n in MOL_SIZES},
    # phase 21: the potentials' options at the bench steps' batches and
    # losses. SchNet in bfloat16 (its first step against the CPU to
    # BF16_TOL's loss and grad), in the dense block (no kernel), and under
    # remat (the interactions' kernels run again in each reverse pass), unfused and
    # with the fused chain; HDNNP2nd's default wACSF model with a
    # GraphBatchNorm (normalize_kwargs) at hdnnp2nd_train's batch; HDNNP4th
    # with a GraphBatchNorm at hdnnp4th_train's
    "schnet_bf16_train": dict(model="schnet", model_kw={"dtype": "bfloat16"}, seed=0, size=512,
                              with_esp=False, global_keys=("energy",), force_weight=100.0,
                              charge_weight=0.0, loss_tol=BF16_TOL["loss"],
                              grad_tol=BF16_TOL["grad"],
                              phase=21, launches=schnet_launches("unfused", dtype="bfloat16",
                                                                 train=True)),
    "schnet_dense_train": dict(model="schnet", model_kw={"dense_block": True}, seed=0, size=512,
                               with_esp=False, global_keys=("energy",), force_weight=100.0,
                               charge_weight=0.0, phase=21, launches=launch_counts()),
    "schnet_remat_train": dict(model="schnet", model_kw={"remat": True}, seed=0, size=512,
                               with_esp=False, global_keys=("energy",), force_weight=100.0,
                               charge_weight=0.0, phase=21,
                               launches=schnet_launches("unfused", remat=True, train=True)),
    "schnet_chain_remat_train": dict(model="schnet", mode="chain", model_kw={"remat": True},
                                     seed=0, size=512, with_esp=False, global_keys=("energy",),
                                     force_weight=100.0, charge_weight=0.0, time_calls=False,
                                     phase=21, launches=schnet_launches("chain", remat=True,
                                                                        train=True)),
    # the wACSF descriptors go unnormalized into the network (the default
    # train=False normalizes by the initial running statistics, 0 and 1), so
    # the bench recipe's Adam steps overshoot: the same loss series in both
    # packages (tests/test_torch_wacsf.py), finite but not falling
    "hdnnp2nd_weighted_train": dict(model="hdnnp2nd_weighted",
                                    model_kw={"normalize_kwargs": {"epsilon": 1e-3}}, seed=5,
                                    size=1024, with_esp=True, global_keys=("energy",),
                                    force_weight=100.0, charge_weight=0.0, phase=21, falls=False,
                                    launches=launch_counts(sorted_segment_sum=3 + 2)),
    "hdnnp4th_norm_train": dict(model="hdnnp4th", model_kw={"normalize_kwargs": {"epsilon": 1e-3}},
                                seed=1, size=128, with_esp=True,
                                global_keys=("energy", "total_charge"), force_weight=200.0,
                                charge_weight=50.0, phase=21,
                                launches=launch_counts(g2_fwd=1, g4_fwd=1, g4_vjp=1, g2_vjp=1,
                                                       g4_jvp=1, g2_jvp=1, sorted_segment_sum=7,
                                                       spd_solve=4)),
}
# sec_gcn_cora's graph and model: SyntheticCitationDataset(num_nodes=2708,
# num_classes=70, feature_dim=1433, avg_degree=4, seed=1), a 3-deep GCN of
# 140 units with a linear 70-class output per node
CORA_CLASSES, CORA_FEATURES = 70, 1433
GCN_CORA_KW = dict(in_features=CORA_FEATURES, depth=3, gcn_args={"units": 140},
                   output_embedding="node",
                   output_mlp={"units": [CORA_CLASSES], "activation": ["linear"]})
TRAIN_STEPS = 5
# the first step on the card against the CPU, on _mols(RandomState(2), 64)
# (GCN: the full graph):
# |loss_gpu - loss_cpu| <= TRAIN_TOL * |loss_cpu|, and for each parameter
# max|grad_gpu - grad_cpu| <= TRAIN_TOL * max|grad_cpu| (a path's grad_tol
# where it sets one): float32 sums in other orders (atomics among them)
# through two reverse passes
TRAIN_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def labelled_mols(seed, n_mols, with_esp=False):
    """The JAX package's ``bench.py`` ``_mols(RandomState(seed), n_mols,
    with_esp)``, draw for draw: QM9-like molecules with an energy and force
    labels, and with ``with_esp`` their angles, an ESP, its gradient, a
    total charge of 0 and charge labels."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle, set_range
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_mols):
        n = rs.randint(12, 21)
        g = {"node_number": rs.choice([1, 6, 7, 8, 9], size=n),
             "node_coordinates": (rs.randn(n, 3) * 2.0).astype(np.float32),
             "energy": np.array([rs.randn()], dtype=np.float32)}
        g = set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        g["force"] = (rs.randn(n, 3) * 0.1).astype(np.float32)
        if with_esp:
            g = set_angle(g, range_indices="edge_indices")
            g["esp"] = (rs.randn(n) * 0.02).astype(np.float32)
            g["esp_grad"] = (rs.randn(n, 3) * 0.02).astype(np.float32)
            g["total_charge"] = np.zeros((1,), dtype=np.float32)
            g["charge"] = (rs.randn(n) * 0.1).astype(np.float32)
        graphs.append(g)
    return graphs


def large_mol_graph(n, seed=3):
    """``bench.py`` ``bench_large_mol_step``'s molecule, draw for draw: ``n``
    atoms of H, C, N, O, F on a gently curved chain 1.3 apart, neighbours
    within 3.5 (at most 12), its angles, an energy, force, ESP, ESP
    gradient and charge labels, and a total charge of 0."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle, set_range
    rs = np.random.RandomState(seed)
    t = np.arange(n) * 1.3
    pos = np.stack([t, 2.0 * np.sin(t * 0.05), 2.0 * np.cos(t * 0.03)],
                   axis=1).astype(np.float32)
    pos += rs.randn(n, 3).astype(np.float32) * 0.05
    g = {"node_number": rs.choice([1, 6, 7, 8, 9], size=n),
         "node_coordinates": pos,
         "energy": np.array([rs.randn()], dtype=np.float32)}
    g = set_range(g, max_distance=3.5, max_neighbours=12)
    g["edge_indices"] = g.pop("range_indices")
    g = set_angle(g, range_indices="edge_indices")
    g["force"] = (rs.randn(n, 3) * 0.1).astype(np.float32)
    g["esp"] = (rs.randn(n) * 0.02).astype(np.float32)
    g["esp_grad"] = (rs.randn(n, 3) * 0.02).astype(np.float32)
    g["total_charge"] = np.zeros((1,), dtype=np.float32)
    g["charge"] = (rs.randn(n) * 0.1).astype(np.float32)
    return g


def qm9_like_mols(seed, n_mols):
    """The molecules of :func:`labelled_mols`, request fields only."""
    return [{k: v for k, v in g.items() if k not in ("energy", "force")}
            for g in labelled_mols(seed, n_mols)]


def cuda_median_ms(fn, reps, flush=None, before=None):
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    its own CUDA events; ``flush`` is overwritten before each one (L2 cold),
    ``before`` runs before each start event."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if before is not None:
            before()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def busy_share(run, reps=5):
    """``run()`` under ``torch.profiler`` (after two warm calls): its device
    kernel ms and wall ms per call and the device's busy share, their
    ratio; ``None`` where the profiler saw no device time. It runs after
    every timed part of the script (``run_profiles``), which so measure
    nothing of the profiler's own seconds of tracing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return {"profiled_wall_ms": wall_ms, "device_ms": dev_ms or None,
            "device_kernels": sum(e.count for e in kernels) / reps,
            "busy_share": dev_ms / wall_ms if dev_ms else None}


def run_profiles(profiles, reps=5):
    """``busy_share`` of each ``(label, run)`` of ``profiles`` over ``reps``
    calls, in turn, logged as ``<label> busy share: {...}``."""
    for label, run in profiles:
        log(f"{label} busy share: " + json.dumps(busy_share(run, reps)))


def phase_device():
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build(names=None):
    """A fresh build of the named sources of ``csrc/`` (all by default),
    with each kernel's registers as ptxas reports them, and of the C++
    neighbour list (``native/neighborlist.cpp``, by the port's loader)."""
    from gcnn_keras_tpu_torch import native
    from gcnn_keras_tpu_torch.ops.cuda import build
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # always a fresh build
    t0 = time.perf_counter()
    logs = build.build(names)
    log(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            # "ptxas info" lines, and the stack and spill line of each kernel
            if "ptxas info" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("build: the C++ neighbour list did not build")
    log(f"build: {native.library_path().name} in {time.perf_counter() - t0:.2f} s, "
        f"openmp={native.has_openmp()}")


def check_segment_sum(values, ids, n, label, timed):
    """The segment-sum kernel (either instance, by the values' type) against
    its plain version; timed: with its bound, the plain version's time and
    ``index_add_``'s in the values' type."""
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    out = ss.segment_sum(values, ids, n)
    torch.cuda.synchronize()
    plain = ss.segment_sum_plain(values, ids, n)
    bf16 = values.dtype == torch.bfloat16
    tol = BF16_KERNEL_TOL if bf16 else KERNEL_TOL
    scale = 1.0 + (plain.abs().max().item() if plain.numel() else 0.0)
    err = (out.float() - plain.float()).abs().max().item() if out.numel() else 0.0
    if out.dtype != values.dtype or not err <= tol * scale:
        raise AssertionError(f"segment_sum {label}: {out.dtype}, max|k-p|={err} > {tol}*{scale}")
    rec = {"case": label, "E": values.shape[0], "F": values.shape[1], "N": n,
           "dtype": str(values.dtype).replace("torch.", ""), "max_abs_err": err}
    if timed:
        e, f = values.shape
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=values.device)
        lib_out = torch.zeros(n, f, dtype=values.dtype, device=values.device)
        size = values.element_size()
        nbytes = size * (e * f + n * f) + 4 * e
        rec.update(
            ms=cuda_median_ms(lambda: ss.segment_sum(values, ids, n), 50, flush),
            ms_warm=cuda_median_ms(lambda: ss.segment_sum(values, ids, n), 50),
            plain_ms=cuda_median_ms(lambda: ss.segment_sum_plain(values, ids, n), 50, flush),
            library_ms=cuda_median_ms(lambda: lib_out.index_add_(0, ids, values), 50,
                                      flush, before=lib_out.zero_),
            bytes=nbytes,
            bound_ms=1e3 * max(nbytes / H100_BYTES_PER_S, e * f / H100_F32_OPS_PER_S),
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= e * f / H100_F32_OPS_PER_S
            else "operations")
    log(f"kernel segment_sum {label}: " + json.dumps(rec))
    return rec


def phase_kernel(batch):
    dev = batch.senders.device
    gen = torch.Generator(device=dev).manual_seed(0)
    e, n, g = batch.n_edge, batch.n_node, batch.n_graphs
    senders_sorted = batch.senders[batch.edges["sender_perm"].long()].contiguous()
    shapes = [
        ("messages by receivers", torch.randn(e, 128, generator=gen, device=dev),
         batch.receivers, n),
        ("positions by sorted senders", torch.randn(e, 3, generator=gen, device=dev),
         senders_sorted, n),
        ("readout by graph_id", torch.randn(n, 64, generator=gen, device=dev),
         batch.graph_id, g),
    ]
    recs = [check_segment_sum(v, i, m, label, timed=True) for label, v, i, m in shapes]
    # edge cases: empty segments (every third row), all edges in one
    # segment, F = 1, 4, 5 and 130 (the kernel's layouts split at F <= 8 and
    # F a multiple of 4), ids from row 1000 of 2000 (empty rows at both
    # ends), one row of 5000 edges among short rows, no edges at all
    few = torch.sort(torch.randint(0, 300, (4000,), generator=gen, device=dev))[0]
    few = (few - few % 3).to(torch.int32)
    late = torch.sort(torch.randint(1000, 1900, (6000,), generator=gen, device=dev))[0]
    late = late.to(torch.int32)
    long_row = torch.sort(torch.cat([
        torch.randint(0, 300, (2000,), generator=gen, device=dev),
        torch.full((5000,), 150, device=dev, dtype=torch.int64)]))[0].to(torch.int32)
    edge_cases = [
        ("F=4", torch.randn(e, 4, generator=gen, device=dev), batch.receivers, n),
        ("F=130", torch.randn(4000, 130, generator=gen, device=dev), few, 301),
        *((f"ids from row 1000 of 2000, F={f}", torch.randn(6000, f, generator=gen, device=dev),
           late, 2000) for f in (3, 128)),
        *((f"one row of 5000 edges, F={f}", torch.randn(7000, f, generator=gen, device=dev),
           long_row, 300) for f in (3, 64)),
        ("empty segments", torch.randn(4000, 16, generator=gen, device=dev), few, 301),
        ("one segment", torch.randn(4000, 7, generator=gen, device=dev),
         torch.zeros(4000, dtype=torch.int32, device=dev), 5),
        ("F=1", torch.randn(e, 1, generator=gen, device=dev), batch.receivers, n),
        ("F=5", torch.randn(e, 5, generator=gen, device=dev), batch.receivers, n),
        ("no edges", torch.zeros(0, 4, device=dev),
         torch.zeros(0, dtype=torch.int32, device=dev), 9),
    ]
    recs += [check_segment_sum(v, i, m, label, timed=False) for label, v, i, m in edge_cases]
    return recs


def max_force_sum_violation(results):
    worst = 0.0
    for r in results:
        f = r["force"]
        # float32 rounding of n force vectors, each a sum of larger terms
        tol = FORCE_SUM_TOL * len(f) * np.abs(f).max()
        worst = max(worst, np.abs(f.sum(axis=0)).max() / max(tol, 1e-30))
    return worst


def check_request(results, graphs, label):
    if len(results) != len(graphs):
        raise AssertionError(f"{label}: {len(results)} results for {len(graphs)} graphs")
    for r, g in zip(results, graphs):
        if r["force"].shape != (len(g["node_number"]), 3) or r["energy"].shape != (1,):
            raise AssertionError(f"{label}: shapes {r['force'].shape} {r['energy'].shape}")
        if not (np.isfinite(r["force"]).all() and np.isfinite(r["energy"]).all()):
            raise AssertionError(f"{label}: non-finite output")
    worst = max_force_sum_violation(results)
    if worst > 1.0:
        raise AssertionError(f"{label}: forces do not sum to 0 ({worst:.3g} x tol)")


def compare_answers(got, ref, keys=("energy", "force"), tol=SERVE_TOL):
    """Two predictors' answers to one request, within ``tol`` (SERVE_TOL;
    or a tolerance per output, as ``BF16_TOL``) of the reference's largest
    value per output."""
    errs = {}
    for key in keys:
        a = np.concatenate([r[key] for r in got])
        b = np.concatenate([r[key] for r in ref])
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        key_tol = tol[key] if isinstance(tol, dict) else tol
        if not err <= key_tol * scale:
            raise AssertionError(f"{key}: max|d|={err} > {key_tol}*{scale}")
        errs[key] = {"max_abs_err": err, "max_abs_cpu": scale}
    return errs


def schnet_model(mode, device, **kwargs):
    """SchNet ``make_model()`` defaults updated by ``kwargs``, in ``mode``
    (``MODE_ARGS``), weights from seed 0: every mode has the same."""
    from gcnn_keras_tpu_torch.models import schnet
    inter = {**kwargs.pop("interaction_args", {}), **MODE_ARGS[mode]}
    return schnet.make_model(device=device, generator=torch.Generator().manual_seed(0),
                             interaction_args=inter, **kwargs)


def energy_force_model(kind, device, mode="unfused", solver=None, **model_kw):
    """The full-width ``EnergyForceModel`` of ``kind`` with weights from seed
    0: SchNet ``make_model()`` defaults in ``mode``, or the HDNNP2nd,
    HDNNP4th (with ESP coupling) or PAiNN bench configuration, or HDNNP2nd's
    default (wACSF) model (``hdnnp2nd_weighted``), or (``hdnnp4th_mol``)
    HDNNP4th at ``LARGE_MOL_KW``, with the Qeq ``solver`` given (default
    ``"auto"``); ``model_kw`` over the configuration."""
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models import hdnnp2nd, hdnnp4th, painn
    gen = torch.Generator().manual_seed(0)
    if kind == "schnet":
        return EnergyForceModel(schnet_model(mode, device, **model_kw), device=device)
    if kind == "painn":
        return EnergyForceModel(painn.make_model(device=device, generator=gen, **PAINN_KW),
                                device=device)
    if kind == "hdnnp2nd":
        return EnergyForceModel(hdnnp2nd.make_model_behler(
            device=device, generator=gen, **HDNNP2ND_KW), device=device)
    if kind == "hdnnp2nd_weighted":
        return EnergyForceModel(hdnnp2nd.make_model(device=device, generator=gen, **model_kw),
                                device=device)
    kw = {**HDNNP4TH_KW, **model_kw}
    if kind == "hdnnp4th_mol":
        kw = dict(LARGE_MOL_KW, electrostatic_kwargs={
            **LARGE_MOL_KW["electrostatic_kwargs"], **({"solver": solver} if solver else {})})
    return EnergyForceModel(hdnnp4th.make_model_behler(device=device, generator=gen, **kw),
                            use_esp_coupling=True, device=device)


def make_predictor(device, mode="unfused"):
    """The serving stack at full SchNet width in ``mode`` with weights from
    seed 0."""
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(energy_force_model("schnet", device, mode),
                                     device=device)


def make_painn_predictor(device):
    """The serving stack at the PAiNN bench width with weights from seed 0."""
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(energy_force_model("painn", device), device=device)


def phase_serving(gpu, requests, batch0, smi):
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss

    # the main path: every count set to 0 just before, read just after
    ss.launches = 0
    answers, per_request = [], []
    for label, graphs in requests:
        before = ss.launches
        answers.append(gpu(graphs))
        torch.cuda.synchronize()
        per_request.append(ss.launches - before)
    main_launches = ss.launches
    for (label, graphs), res, count in zip(requests, answers, per_request):
        check_request(res, graphs, label)
        if count != LAUNCHES_PER_EVAL:
            raise AssertionError(f"{label}: {count} segment_sum launches, "
                                 f"expected {LAUNCHES_PER_EVAL}")
        log(f"serving {label}: ok, {count} segment_sum launches")

    cpu = make_predictor("cpu")
    for (name, wg), (_, wc) in zip(gpu.model.energy_model.state_dict().items(),
                                   cpu.model.energy_model.state_dict().items()):
        if not torch.equal(wg.cpu(), wc):
            raise AssertionError(f"weights differ between devices: {name}")
    t0 = time.perf_counter()
    cpu_answer = cpu(requests[0][1])
    cpu_s = time.perf_counter() - t0
    check_request(cpu_answer, requests[0][1], "cpu " + requests[0][0])
    errs = compare_answers(answers[0], cpu_answer)
    log(f"serving gpu vs cpu ({requests[0][0]}, cpu {cpu_s:.2f} s): " + json.dumps(errs))

    # time one energy+force evaluation on the prepared full-width batch
    model = gpu.model
    for _ in range(3):
        model(batch0)
    torch.cuda.synchronize()
    reps = 30
    ss.launches = 0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(batch0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if ss.launches != reps * LAUNCHES_PER_EVAL:
        raise AssertionError(f"timed loop: {ss.launches} launches for {reps} evaluations")
    req_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu(requests[0][1])
        req_times.append(1e3 * (time.perf_counter() - t0))
    real_edges = int(batch0.edge_mask.sum().item())
    ms = float(np.median(times))
    cfg = gpu.model.energy_model.config
    serving = {"n_mols": len(requests[0][1]), "units": cfg["interaction_args"]["units"],
               "depth": cfg["depth"], "N_pad": batch0.n_node,
               "E_pad": batch0.n_edge, "G": batch0.n_graphs, "real_edges": real_edges,
               "ms_per_eval": ms,
               "edges_per_s": real_edges / (ms * 1e-3),
               "ms_per_request": float(np.median(req_times)),
               "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
               "launches_per_eval": LAUNCHES_PER_EVAL, "card": smi}
    log("serving timing: " + json.dumps(serving))
    return main_launches, answers


def acsf_work(name, st, n_node, n_rows, n_real):
    """What the function of kernel ``name`` needs on these inputs: the bytes
    of each input read once and each output written once, and for each of
    the ``n_real`` unmasked rows its float32 adds and multiplies (an FMA is
    2) and its special-function results. Those are, per row, one rsqrt per
    distance (it gives r and 1/r); per unique eta one exp; per unique
    (zeta, lambda) one log2 and one exp2 for the power, and in the force and
    tangent passes one more exp2 for its derivative (the log2 is shared);
    per unique r_c and distance one cos, and in the force and tangent passes
    one sin. Returns ``(bytes, bound_ms, bound_by)``."""
    g4, kind = name.startswith("g4"), name[3:]
    m = len(st.eta_inv) if g4 else len(st.sets)
    width = st.num_rel * m
    nbytes = (n_node * (3 * 4 + 4)                    # positions, atomic numbers
              + n_rows * ((3 if g4 else 2) * 4 + 1)   # index rows, mask
              + n_node * width * 4                    # G or dG written, or ct read
              + (0 if kind == "fwd" else n_node * 3 * 4))  # dpos written or read
    if g4:
        # geometry: 3 difference vectors (9), 3 squared norms and a dot (20),
        # r = r^2 rsqrt (3), cos (2), s^2 (2)
        ne, nz, nr = len(st.uniq_eta), len(st.uniq_zl), len(st.uniq_rc)
        if kind == "fwd":
            sfu = 3 + ne + 2 * nz + 3 * nr
            ops = 36 + ne + 4 * nz + 11 * nr + 3 * m
        elif kind == "vjp":
            # 5 geometry cotangents accumulated per set, then 3 vector
            # cotangents and their 3 scatters (about 72)
            sfu = 3 + ne + 3 * nz + 6 * nr
            ops = 108 + 2 * ne + 6 * nz + 19 * nr + 13 * m
        else:
            # the tangents of the geometry: 3 difference vectors, 3 dots and
            # 3 products (27), ds2 (6), dcos (18); 3 products and 6 FMAs a set
            sfu = 3 + ne + 3 * nz + 6 * nr
            ops = 87 + 2 * ne + 6 * nz + 19 * nr + 18 * m
    else:
        nr = len({s[2] for s in st.sets})
        if kind == "fwd":
            sfu = 1 + m + nr
            ops = 9 + 5 * m + 3 * nr
        elif kind == "vjp":
            sfu = 1 + m + 2 * nr
            ops = 19 + 10 * m + 4 * nr
        else:
            sfu = 1 + m + 2 * nr
            ops = 18 + 11 * m + 4 * nr
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(n_real * ops / H100_F32_OPS_PER_S, n_real * sfu / H100_SFU_PER_S)
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def acsf_args(name, batch):
    pos = batch.nodes["node_coordinates"]
    z = batch.nodes["node_number"].to(torch.int32)
    if name.startswith("g4"):
        return (pos, z, batch.angles, batch.angle_mask), batch.angle_mask
    return (pos, z, batch.senders, batch.receivers, batch.edge_mask), batch.edge_mask


def acsf_call_args(name, st, batch):
    """The wrapper arguments of ACSF kernel ``name`` on ``batch``, with a
    random cotangent (vjp) or position tangent (jvp) from seed 1."""
    args, mask = acsf_args(name, batch)
    gen = torch.Generator(device=mask.device).manual_seed(1)
    if name.endswith("vjp"):
        m = len(st.eta_inv) if name.startswith("g4") else len(st.sets)
        args = args + (torch.randn(batch.n_node, st.num_rel * m, generator=gen,
                                   device=mask.device),)
    elif name.endswith("jvp"):
        args = args + (torch.randn(batch.n_node, 3, generator=gen, device=mask.device),)
    return args + (st,)


def check_acsf(name, st, batch, label, timed):
    """ACSF kernel ``name`` against its plain version on ``batch``."""
    return check_acsf_call(name, acsf_call_args(name, st, batch), label, timed)


def check_acsf_call(name, args, label, timed):
    """ACSF kernel ``name`` against its plain version on the wrapper's
    arguments ``args`` (positions first, the static tables last)."""
    mod, attr, plain = kernel_wrappers()[name]
    kernel = getattr(mod, attr)
    *args, st = args
    mask = args[3 if name.startswith("g4") else 4]
    n_node = args[0].shape[0]
    out = kernel(*args, st)
    torch.cuda.synchronize()
    ref = plain(*args, st)
    tol = ACSF_FWD_TOL if name.endswith("fwd") else ACSF_VJP_TOL
    scale = 1.0 + (ref.abs().max().item() if ref.numel() else 0.0)
    err = (out - ref).abs().max().item() if ref.numel() else 0.0
    if out.shape != ref.shape or not torch.isfinite(out).all() or not err <= tol * scale:
        raise AssertionError(f"{name} {label}: max|k-p|={err} > {tol}*{scale}")
    n_rows, n_real = mask.shape[0], int(mask.sum().item())
    rec = {"case": label, "N": n_node, "rows": n_rows, "real_rows": n_real,
           "max_abs_err": err, "max_abs_plain": scale - 1.0}
    if name.endswith("fwd") and ref.numel():
        # each set's columns against their own largest value, so that small
        # sets are held as tightly as the largest: every term of a forward
        # sum is >= 0, so an output's error is relative to its value
        m = len(st.eta_inv) if name.startswith("g4") else len(st.sets)
        err_s = (out - ref).abs().reshape(-1, m).amax(0)
        scale_s = ref.abs().reshape(-1, m).amax(0)
        rel = (err_s / scale_s.clamp_min(1e-30)).max().item()
        if not bool((err_s <= tol * scale_s).all()):
            raise AssertionError(f"{name} {label}: per-set max|k-p| {err_s.tolist()} "
                                 f"> {tol} x per-set max|p| {scale_s.tolist()}")
        rec["max_rel_err_per_set"] = rel
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=mask.device)
        nbytes, bound_ms, bound_by = acsf_work(name, st, n_node, n_rows, n_real)
        rec.update(
            ms=cuda_median_ms(lambda: kernel(*args, st), 50, flush),
            ms_warm=cuda_median_ms(lambda: kernel(*args, st), 50),
            plain_ms=cuda_median_ms(lambda: plain(*args, st), 20, flush),
            library_ms=None, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel {name} {label}: " + json.dumps(rec))
    return rec


def star_degrees(n_angles):
    """Neighbour counts d of star molecules whose d (d - 1) angles add up
    to ``n_angles`` (even), the largest first."""
    degrees = []
    while n_angles > 0:
        d = int((1 + math.sqrt(1 + 4 * n_angles)) / 2)
        while d * (d - 1) > n_angles:
            d -= 1
        degrees.append(d)
        n_angles -= d * (d - 1)
    return degrees


def wide_graph(n, rs):
    """A molecule of ``n`` atoms whose angles join nodes ``n - 1`` apart in
    id: atoms 0, 1 and ``n - 1`` form a triangle within r_c; the atoms
    between, far apart, have no neighbours."""
    xyz = np.stack([6.0 * np.arange(n), np.full(n, 20.0), np.zeros(n)], 1)
    xyz[[0, 1, n - 1]] = [[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.2, 1.3, 0.0]]
    tri = [0, 1, n - 1]
    return {"node_number": rs.choice(HDNNP_ELEMENTS, size=n),
            "node_coordinates": xyz.astype(np.float32),
            "edge_indices": np.array([[i, j] for i in tri for j in tri if i != j])}


def star_graph(d, rs):
    """A star molecule: a centre and ``d`` leaves 1.2 from it on a Fibonacci
    sphere, joined to the centre both ways."""
    q = np.arange(d) + 0.5
    theta, phi = np.arccos(1 - 2 * q / d), np.pi * (1 + 5 ** 0.5) * q
    leaves = 1.2 * np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta),
                             np.cos(theta)], 1)
    return {"node_number": rs.choice(HDNNP_ELEMENTS, size=d + 1),
            "node_coordinates": np.concatenate([np.zeros((1, 3)), leaves]).astype(np.float32),
            "edge_indices": np.array([[0, j] for j in range(1, d + 1)]
                                     + [[j, 0] for j in range(1, d + 1)])}


def acsf_edge_batch(dev):
    """The G4 kernels' layout cases, then the ACSF edge cases. Stars whose
    centres' angles fill the G4 fwd and jvp kernels' first block range
    (``g4_range()`` angles, read from the built kernels), their leaves
    between them rows without angles; then a compact 40-atom cluster
    within r_c, whose first centre's first
    angle is the second block's first angle and each of whose centres has
    1482 angles, spanning three or more blocks; then a molecule whose
    angles join nodes further apart in id than the G4 vjp kernel's shared
    window (``vjp_window()`` nodes: its global-atomic branch), with
    that many rows without angles inside one block's range; then a
    collinear triple (1 + cos = 0: the clamped cosine derivative), an atom
    with one neighbour and one with none (no angles), and atomic numbers
    outside the table (S, Cl); padding rows and rows without angles after
    the last angle, in the last block."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.ops.cuda.acsf import g4_range, vjp_window
    rs = np.random.RandomState(11)
    graphs = []
    for d in star_degrees(g4_range()):
        graphs.append(star_graph(d, rs))
    # every distance below 2.2 sqrt(3) = 3.81 < r_c
    graphs.append({"node_number": rs.choice(HDNNP_ELEMENTS, size=40),
                   "node_coordinates": rs.uniform(0.0, 2.2, (40, 3)).astype(np.float32),
                   "edge_indices": np.array([[i, j] for i in range(40) for j in range(40)
                                             if i != j])})
    graphs.append(wide_graph(vjp_window() + 2, rs))
    graphs += [
        {"node_number": np.array([6, 6, 6]),
         "node_coordinates": np.array([[0, 0, 0], [1.0, 0, 0], [-2.0, 0, 0]], np.float32),
         "edge_indices": np.array([[0, 1], [0, 2], [1, 0], [2, 0]])},
        {"node_number": np.array([1, 8, 16]),
         "node_coordinates": np.array([[0, 0, 0], [0.9, 0, 0], [9.0, 9, 9]], np.float32),
         "edge_indices": np.array([[0, 1], [1, 0]])},
        {"node_number": np.array([17, 6, 1, 16]),
         "node_coordinates": np.array([[0, 0, 0], [1.5, 0, 0], [0, 1.2, 0],
                                       [0, 0, 1.8]], np.float32),
         "edge_indices": np.array([[i, j] for i in range(4) for j in range(4) if i != j])},
    ]
    graphs = [set_angle(g, range_indices="edge_indices") for g in graphs]
    n_angle = sum(len(g["angle_indices_nodes"]) for g in graphs)
    n_edge = sum(len(g["edge_indices"]) for g in graphs)
    return batch_graphs(graphs, device=dev, n_angle_pad=n_angle + 64, n_edge_pad=n_edge + 64)


def acsf_g2_edge_graphs(g2_range, window):
    """The G2 fwd and vjp kernels' layout cases, without angles: a 5-atom
    molecule, so that the next receiver's first edge lies inside a block's
    range; a star whose centre receives 3 x ``g2_range`` edges (the G2 fwd
    kernel's block range), across three or more of the fwd kernel's ranges
    and of the vjp kernel's blocks; a molecule whose edges join nodes
    further apart in id than the vjp kernel's shared window (``window``
    nodes: its global-atomic branch), with that many receivers without
    edges inside one block's range; atomic numbers outside the table (S,
    Cl); and a last molecule whose last atom has no edges."""
    rs = np.random.RandomState(12)
    return [{"node_number": rs.choice(HDNNP_ELEMENTS, size=5),
             "node_coordinates": rs.uniform(0.0, 2.0, (5, 3)).astype(np.float32),
             "edge_indices": np.array([[i, j] for i in range(5) for j in range(5) if i != j])},
            star_graph(3 * g2_range, rs), wide_graph(window + 2, rs),
            {"node_number": np.array([17, 6, 1, 16]),
             "node_coordinates": np.array([[0, 0, 0], [1.5, 0, 0], [0, 1.2, 0],
                                           [0, 0, 1.8]], np.float32),
             "edge_indices": np.array([[i, j] for i in range(4) for j in range(4) if i != j])},
            {"node_number": np.array([1, 8, 6]),
             "node_coordinates": np.array([[0, 0, 0], [0.9, 0, 0], [9.0, 9, 9]], np.float32),
             "edge_indices": np.array([[0, 1], [1, 0]])}]


def acsf_g2_edge_batch(dev):
    """``acsf_g2_edge_graphs`` at the built kernels' range and window, batched
    without padding edges: the last atom and the padding nodes are
    receivers without edges after the last edge, in the last block."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.ops.cuda.acsf import g2_range, vjp_window
    graphs = acsf_g2_edge_graphs(g2_range(), vjp_window())
    return batch_graphs(graphs, device=dev,
                        n_edge_pad=sum(len(g["edge_indices"]) for g in graphs))


def phase_acsf_kernel(batch, model, names=("g2_fwd", "g4_fwd", "g4_vjp", "g2_vjp")):
    """Each ACSF kernel of ``names`` against its plain version at the
    full-width shapes of ``batch`` (timed) and at edge cases; the G2 kernels
    also at ``acsf_g2_edge_batch``."""
    dev = batch.senders.device
    statics = {"g2": model.acsf_g2._static, "g4": model.acsf_g4._static}
    edge = acsf_edge_batch(dev)
    g2_edge = acsf_g2_edge_batch(dev) if any(n.startswith("g2") for n in names) else None
    masked = edge.replace(angle_mask=torch.zeros_like(edge.angle_mask),
                          edge_mask=torch.zeros_like(edge.edge_mask))
    none = edge.replace(angles=torch.zeros(0, 3, dtype=torch.int32, device=dev),
                        angle_mask=torch.zeros(0, dtype=torch.bool, device=dev),
                        senders=torch.zeros(0, dtype=torch.int32, device=dev),
                        receivers=torch.zeros(0, dtype=torch.int32, device=dev),
                        edge_mask=torch.zeros(0, dtype=torch.bool, device=dev))
    recs = {}
    for name in names:
        st = statics[name[:2]]
        recs[name] = [check_acsf(name, st, batch, "HDNNP2nd serving, 512 mols", True),
                      check_acsf(name, st, edge, "block layout, wide molecule, collinear, "
                                 "no angles, unknown element", False),
                      check_acsf(name, st, masked, "all rows masked", False),
                      check_acsf(name, st, none, "no rows", False)]
        if recs[name][2]["max_abs_err"] != 0.0 or recs[name][3]["max_abs_err"] != 0.0:
            raise AssertionError(f"{name}: masked or absent rows gave output")
        if name.startswith("g2"):
            recs[name].append(check_acsf(
                name, st, g2_edge, "G2 layout: a receiver across three ranges, edgeless "
                "receivers, senders past the window, unknown elements", False))
    return recs


def make_hdnnp_predictor(device):
    """HDNNP2nd serving at the bench width with weights from seed 0;
    angles come from ``set_angle`` as a graph preprocessor."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(
        energy_force_model("hdnnp2nd", device),
        graph_preprocessors=[functools.partial(set_angle, range_indices="edge_indices")],
        device=device)


def kernel_counts():
    """Every kernel's launch count, by the names of ``KERNEL_NAMES``."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    return dict(ka.launches, sorted_segment_sum=ss.launches,
                sorted_segment_sum_bf16=ss.launches_bf16, spd_solve=ks.launches,
                gather_mul_segsum=fa.launches, fused_cfconv=fc.launches, **fi.launches)


def kernel_wrappers():
    """Each kernel's wrapper, as ``(module, attribute)``, and its plain
    version, by the kernel's name in the launch counts."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    table = {"sorted_segment_sum": (ss, "segment_sum", ss.segment_sum_plain),
             "spd_solve": (ks, "spd_solve", ks.spd_solve_plain),
             "gather_mul_segsum": (fa, "fused_gather_mul_segsum_kernel",
                                   fa.fused_gather_mul_segsum_plain),
             "fused_cfconv": (fc, "fused_cfconv_kernel", fc.fused_cfconv_plain)}
    for name in fi.KERNELS:
        table[name] = (fi, name, getattr(fi, f"{name}_plain"))
    for kind in ("g2", "g4"):
        table[f"{kind}_fwd"] = (ka, f"{kind}_forward", getattr(ka, f"{kind}_forward_plain"))
        for d in ("vjp", "jvp"):
            table[f"{kind}_{d}"] = (ka, f"{kind}_{d}", getattr(ka, f"{kind}_{d}_plain"))
    return table


@contextlib.contextmanager
def captured_calls():
    """Inside the block each kernel wrapper keeps a copy of the arguments of
    every call before it runs; yields ``{name: [args, ...]}`` (a segment-sum
    of bfloat16 values under ``sorted_segment_sum_bf16``, its instance, a
    key made at its first call). The autograd Functions look their wrapper
    up by name at each call, so they call the recording one."""
    table = kernel_wrappers()
    calls = {name: [] for name in table}
    originals = {name: getattr(mod, attr) for name, (mod, attr, _) in table.items()}

    def recording(name):
        def wrapper(*args):
            key = name
            if name == "sorted_segment_sum" and args[0].dtype == torch.bfloat16:
                key = "sorted_segment_sum_bf16"
            calls.setdefault(key, []).append(
                tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return originals[name](*args)
        return wrapper
    for name, (mod, attr, _) in table.items():
        setattr(mod, attr, recording(name))
    try:
        yield calls
    finally:
        for name, (mod, attr, _) in table.items():
            setattr(mod, attr, originals[name])


def reset_counts():
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    for mod in (ss, ks, fa, fc):
        mod.launches = 0
    ss.launches_bf16 = 0
    for counts in (ka.launches, fi.launches):
        for k in counts:
            counts[k] = 0


def phase_model_serving(gpu, requests, batch0, smi, name="hdnnp2nd",
                        make_cpu=make_hdnnp_predictor, expected=HDNNP_LAUNCHES,
                        check=check_request, keys=("energy", "force"), reference=None,
                        tol=SERVE_TOL, profiles=None):
    """Serving phase of a model (HDNNP2nd; HDNNP4th with the arguments of
    phase 8; SchNet in the modes of phase 12): the requests with every
    kernel's launches per request held to ``expected``, the first request
    against the same predictor on the CPU and, given ``reference`` (another
    predictor's answers to the same requests), every request against it,
    each within ``tol``; then the time per evaluation; given ``profiles``,
    an evaluation queued on it for ``run_profiles``."""
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    answers, per_request = [], []
    for label, graphs in requests:
        before = kernel_counts()
        answers.append(gpu(graphs))
        torch.cuda.synchronize()
        per_request.append({k: v - before[k] for k, v in kernel_counts().items()})
    main_launches = kernel_counts()
    for (label, graphs), res, counts in zip(requests, answers, per_request):
        check(res, graphs, f"{name} {label}")
        if counts != expected:
            raise AssertionError(f"{name} {label}: launches {counts}, "
                                 f"expected {expected}")
        log(f"{name} serving {label}: ok, launches {json.dumps(counts)}")

    cpu = make_cpu("cpu")
    for (wname, wg), (_, wc) in zip(gpu.model.energy_model.state_dict().items(),
                                    cpu.model.energy_model.state_dict().items()):
        if not torch.equal(wg.cpu(), wc):
            raise AssertionError(f"weights differ between devices: {wname}")
    t0 = time.perf_counter()
    cpu_answer = cpu(requests[0][1])
    cpu_s = time.perf_counter() - t0
    check(cpu_answer, requests[0][1], f"{name} cpu {requests[0][0]}")
    errs = compare_answers(answers[0], cpu_answer, keys, tol)
    log(f"{name} serving gpu vs cpu ({requests[0][0]}, cpu {cpu_s:.2f} s): "
        + json.dumps(errs))
    for (label, _), res, ref in zip(requests, answers, reference or ()):
        log(f"{name} serving against unfused ({label}): "
            + json.dumps(compare_answers(res, ref, keys, tol)))

    # time one energy+force evaluation on the prepared full-width batch
    model = gpu.model
    for _ in range(3):
        model(batch0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 30
    reset_counts()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(batch0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if kernel_counts() != {k: reps * v for k, v in expected.items()}:
        raise AssertionError(f"{name} timed loop: launches {kernel_counts()} "
                             f"for {reps} evaluations")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    req_times, batch_times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu(requests[0][1])
        req_times.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        gpu.make_batch(requests[0][1])  # preprocessing and batching, on the host
        torch.cuda.synchronize()
        batch_times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times))
    real_edges = int(batch0.edge_mask.sum().item())
    serving = {"n_mols": len(requests[0][1]), "N_pad": batch0.n_node,
               "E_pad": batch0.n_edge, "G": batch0.n_graphs, "real_edges": real_edges,
               "ms_per_eval": ms, "ms_per_eval_min": float(np.min(times)),
               "ms_per_request": float(np.median(req_times)),
               "ms_make_batch": float(np.median(batch_times)),
               "max_nodes": batch0.max_nodes, "peak_mem_mb": peak_mb,
               "launches_per_eval": expected, "card": smi}
    if batch0.angles is None:
        serving["edges_per_s"] = real_edges / (ms * 1e-3)
    else:
        real_angles = int(batch0.angle_mask.sum().item())
        serving.update(A_pad=batch0.angles.shape[0], real_angles=real_angles,
                       angles_per_s=real_angles / (ms * 1e-3))
    log(f"{name} serving timing: " + json.dumps(serving))
    if profiles is not None:
        profiles.append((f"{name} serving", lambda: model(batch0)))
    return main_launches


def with_esp(graphs, seed, zero_esp_grad=False):
    """HDNNP4th request fields for the molecules of ``qm9_like_mols``: an
    ESP and its gradient drawn as ``bench.py`` ``_mols`` draws them, from
    their own ``RandomState(100 + seed)`` so that the geometry is the same,
    and total charges -1, 0, +1 in turn. ``zero_esp_grad``: no external
    field gradient, so that the forces of each molecule sum to 0."""
    rs = np.random.RandomState(100 + seed)
    out = []
    for i, g in enumerate(graphs):
        n = len(g["node_number"])
        esp = (rs.randn(n) * 0.02).astype(np.float32)
        esp_grad = (rs.randn(n, 3) * 0.02).astype(np.float32)
        out.append(dict(g, esp=esp,
                        esp_grad=np.zeros_like(esp_grad) if zero_esp_grad else esp_grad,
                        total_charge=np.array([float(i % 3 - 1)], np.float32)))
    return out


def make_hdnnp4th_predictor(device):
    """HDNNP4th serving at the bench width with ESP coupling and weights
    from seed 0; angles come from ``set_angle`` as a graph preprocessor."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(
        energy_force_model("hdnnp4th", device),
        graph_preprocessors=[functools.partial(set_angle, range_indices="edge_indices")],
        device=device)


def check_charged_request(results, graphs, label):
    """Shapes, finite values, the Qeq constraint on every molecule, and the
    force sum where no molecule has an ESP gradient (the ESP coupling force
    is external)."""
    if len(results) != len(graphs):
        raise AssertionError(f"{label}: {len(results)} results for {len(graphs)} graphs")
    worst_q = 0.0
    for r, g in zip(results, graphs):
        n = len(g["node_number"])
        if (r["force"].shape, r["energy"].shape, r["charge"].shape) != ((n, 3), (1,), (n,)):
            raise AssertionError(f"{label}: shapes {r['force'].shape} {r['energy'].shape} "
                                 f"{r['charge'].shape}")
        if not all(np.isfinite(r[k]).all() for k in ("force", "energy", "charge")):
            raise AssertionError(f"{label}: non-finite output")
        dq = abs(float(r["charge"].sum()) - float(g["total_charge"][0]))
        worst_q = max(worst_q, dq / (CHARGE_TOL * (1.0 + np.abs(r["charge"]).sum())))
    if worst_q > 1.0:
        raise AssertionError(f"{label}: charges miss the total charge ({worst_q:.3g} x tol)")
    if not any(np.asarray(g["esp_grad"]).any() for g in graphs):
        worst = max_force_sum_violation(results)
        if worst > 1.0:
            raise AssertionError(f"{label}: forces do not sum to 0 ({worst:.3g} x tol)")


def spd_work(g, m, k):
    """Bytes (a and b read once, x written once) and float32 operations of
    the elimination on the columns it updates; ``(bytes, bound_ms, bound_by)``."""
    nbytes = 4 * g * (m * m + 2 * m * k)
    ops = g * sum(1 + (2 * (m - 1) + 1) * (m + k - s - 1) for s in range(m))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_spd(a, b, label, timed):
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    x = ks.spd_solve(a, b)
    torch.cuda.synchronize()
    plain = ks.spd_solve_plain(a, b)
    scale = 1.0 + plain.abs().max().item()
    err = (x - plain).abs().max().item()
    resid = (a @ x - b).abs().max().item()
    rscale = 1.0 + b.abs().max().item()
    if not (torch.isfinite(x).all() and err <= SPD_TOL * scale
            and resid <= SPD_RESIDUAL_TOL * rscale):
        raise AssertionError(f"spd_solve {label}: max|k-p|={err} (tol {SPD_TOL}*{scale}), "
                             f"max|Ax-b|={resid} (tol {SPD_RESIDUAL_TOL}*{rscale})")
    g, m, _ = a.shape
    k = b.shape[2]
    rec = {"case": label, "G": g, "M": m, "K": k, "max_abs_err": err, "residual": resid}
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=a.device)
        nbytes, bound_ms, bound_by = spd_work(g, m, k)
        rec.update(
            ms=cuda_median_ms(lambda: ks.spd_solve(a, b), 50, flush),
            ms_warm=cuda_median_ms(lambda: ks.spd_solve(a, b), 50),
            plain_ms=cuda_median_ms(lambda: ks.spd_solve_plain(a, b), 20, flush),
            library_ms=cuda_median_ms(lambda: torch.linalg.solve(a, b), 50, flush),
            cholesky_ms=cuda_median_ms(
                lambda: torch.cholesky_solve(b, torch.linalg.cholesky(a)), 50, flush),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel spd_solve {label}: " + json.dumps(rec))
    return rec


def random_spd(g, m, k, seed, dev):
    """Well-conditioned SPD systems: B B^T + 2 I with B ~ N(0, 1/m)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = torch.randn(g, m, m, generator=gen, device=dev) / m ** 0.5
    a = half @ half.transpose(1, 2) + 2.0 * torch.eye(m, device=dev)
    return a.contiguous(), torch.randn(g, m, k, generator=gen, device=dev)


def qeq_system(model, batch):
    """The Qeq systems that ``CENTCharge`` assembles from ``batch`` with
    ``model``'s weights: ``(a, rhs, mask, b, qtot)``, ``rhs = [b | mask]``
    (K = 2)."""
    with torch.no_grad():
        rep, esp, z = model.representation(batch)
        chi = model.mlp_charge(rep, z)[:, 0] + esp
        a, mask, b, qtot, _ = model.cent_electrostatic.cent_charge.assemble(batch, chi)
    return a, torch.stack([b, mask], dim=-1).contiguous(), mask, b, qtot


def phase_spd_kernel(model, batch):
    """The SPD kernels against their plain version on the Qeq system that
    ``CENTCharge`` assembles from ``batch`` (timed; the same bits), and at
    edge cases: the warp kernel (M <= 32) and the block kernel (M > 32; the
    same bits at M = 33 and at ``SPD_BLOCK_TIMED_M``, timed there beside
    ``torch.linalg.solve`` and Cholesky + ``cholesky_solve``)."""
    from gcnn_keras_tpu_torch.layers.conv.qeq_solver import solve_qeq_dense_cholesky
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    dev = batch.senders.device
    a, rhs, mask, b, qtot = qeq_system(model, batch)
    if a.shape != (batch.n_graphs, HDNNP4TH_M, HDNNP4TH_M):
        raise AssertionError(f"unexpected Qeq shape {tuple(a.shape)}")
    eye = torch.eye(HDNNP4TH_M, device=dev)
    if not torch.equal(a[-1], eye):
        raise AssertionError("the padding graph's Qeq system is not the identity")
    m_gate = ks.max_kernel_m(2)
    recs = [check_spd(a, rhs, "Qeq of the HDNNP4th serving request, 512 mols", True),
            check_spd(a[:1].contiguous(), rhs[:1].contiguous(), "G=1", False),
            check_spd(*random_spd(7, 1, 2, 1, dev), "M=1", False),
            *(check_spd(*random_spd(7, m, 2, m, dev), f"M={m}", False) for m in (5, 12, 27)),
            check_spd(*random_spd(5, 32, 2, 3, dev), "M=32, the warp kernel's last", False),
            check_spd(*random_spd(5, 33, 2, 4, dev), "M=33, the block kernel's first", False),
            check_spd(*random_spd(4, m_gate, 2, 2, dev), f"M={m_gate} at the gate", False),
            check_spd(a, rhs[..., :1].contiguous(), "K=1", False),
            # the block kernel at the serving G, timed beside the library calls
            *(check_spd(*random_spd(batch.n_graphs, m, 2, m, dev),
                        f"block kernel, G={batch.n_graphs}, M={m}", True)
              for m in SPD_BLOCK_TIMED_M)]
    # both kernels give the plain version's bits: the Qeq solve (warp
    # kernel), the block kernel's first M and its timed shapes
    for r in recs:
        if (r is recs[0] or r["M"] == 33 or r["M"] in SPD_BLOCK_TIMED_M) and r["max_abs_err"]:
            raise AssertionError(f"spd_solve {r['case']}: differs from the plain version "
                                 f"by {r['max_abs_err']}")
    ident = check_spd(a[-1:].contiguous(), torch.randn(1, HDNNP4TH_M, 2, device=dev),
                      "the padding graph's identity system", False)
    if ident["max_abs_err"] != 0.0:
        raise AssertionError("the identity system changed its right-hand side")
    recs.append(ident)
    # an empty graph beside a real one: identity rows, zero right-hand side,
    # bordered corner 1, so its charges are 0 and lambda stays finite
    a2 = torch.stack([a[0], eye])
    mask2 = torch.stack([mask[0], torch.zeros_like(mask[0])])
    b2 = torch.stack([b[0], torch.zeros_like(b[0])])
    before = ks.launches
    q2 = solve_qeq_dense_cholesky(a2, mask2, b2, qtot[:2], torch.tensor([0.0, 1.0], device=dev))
    torch.cuda.synchronize()
    if ks.launches != before + 1 or not torch.isfinite(q2).all() or q2[1].any():
        raise AssertionError(f"empty graph: charges {q2[1].tolist()}")
    dq = abs(q2[0].sum().item() - qtot[0].item())
    if dq > CHARGE_TOL * (1.0 + q2[0].abs().sum().item()):
        raise AssertionError(f"empty graph case: charges sum off by {dq}")
    recs.append(check_spd(a2.contiguous(), torch.stack([b2, mask2], -1).contiguous(),
                          "an empty graph, bordered corner 1", False))
    return recs


def check_second_order(kind, st, batch):
    """The second-order pattern of ``tests/test_fused_g4.py``: the derivative
    along a scale c of sum(g * g), g = d/dpos (sum(G(pos) * ct) * c), through
    the kernel Functions (the fwd, vjp and jvp kernels, one launch each)
    against autograd through the plain forward, on the card."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    (pos0, *rest), _ = acsf_args(f"{kind}_fwd", batch)
    fn, plain = {"g4": (ka.G4Fn.apply, ka.g4_forward_plain),
                 "g2": (ka.G2Fn.apply, ka.g2_forward_plain)}[kind]
    width = st.num_rel * (len(st.eta_inv) if kind == "g4" else len(st.sets))
    gen = torch.Generator(device=pos0.device).manual_seed(2)
    ct = torch.randn(batch.n_node, width, generator=gen, device=pos0.device)

    def second_order(f):
        c = torch.tensor(1.2, device=pos0.device, requires_grad=True)
        p = pos0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((f(p, *rest, st) * ct).sum() * c, p, create_graph=True)
        (dc,) = torch.autograd.grad((g * g).sum(), c)
        return dc.item()

    before = kernel_counts()
    kernel_value = second_order(fn)
    launched = {k: v - before[k] for k, v in kernel_counts().items() if v != before[k]}
    expected = {f"{kind}_fwd": 1, f"{kind}_vjp": 1, f"{kind}_jvp": 1}
    if launched != expected:
        raise AssertionError(f"second-order pattern {kind}: launches {launched}, "
                             f"expected {expected}")
    plain_value = second_order(plain)
    err = abs(kernel_value - plain_value)
    if not err <= SECOND_ORDER_TOL * max(abs(plain_value), 1.0):
        raise AssertionError(f"second-order pattern {kind}: kernel {kernel_value}, "
                             f"plain {plain_value}")
    rec = {"case": f"second-order pattern, {kind}, HDNNP2nd serving batch",
           "kernel": kernel_value, "plain": plain_value, "abs_err": err}
    log("kernel pair: " + json.dumps(rec))
    return rec


def phase_jvp_kernels(batch, model):
    """Phase 9: the jvp kernels against their plain versions, and the pair's
    second-order pattern."""
    recs = phase_acsf_kernel(batch, model, names=("g4_jvp", "g2_jvp"))
    second = {f"{kind}_jvp": check_second_order(kind, getattr(model, f"acsf_{kind}")._static,
                                                batch)
              for kind in ("g4", "g2")}
    return recs, second


def ef_loss_fn(fmodel, force_weight, charge_weight=0.0):
    """``bench.py``'s training loss, ``charge_weight * q_MAE + E_MAE +
    force_weight * F_MAE``, with the forces taken with ``create_graph=True``."""
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae, masked_node_mae

    def loss_fn(b):
        out = fmodel.apply(b, create_graph=True)
        loss = (masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
                + force_weight * masked_node_mae(out["force"], b.nodes["force"], b.node_mask))
        if charge_weight:
            loss = charge_weight * masked_node_mae(out["charge"], b.nodes["charge"],
                                                   b.node_mask) + loss
        return loss, {}
    return loss_fn


def citation_batch(seed, n_nodes, device):
    """``bench.py`` ``sec_gcn_cora``'s batch: the synthetic citation graph of
    ``n_nodes`` nodes (70 classes, 1433 features, degree 4) from ``seed``,
    its edge weights set uniform and normalized symmetrically, alone in a
    batch, with its ``node_labels``."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticCitationDataset
    from gcnn_keras_tpu_torch.graph.preprocess import (normalize_edge_weights_symmetric,
                                                       set_edge_weights_uniform)
    g = SyntheticCitationDataset(num_nodes=n_nodes, num_classes=CORA_CLASSES,
                                 feature_dim=CORA_FEATURES, avg_degree=4, seed=seed)[0]
    return batch_graphs([normalize_edge_weights_symmetric(set_edge_weights_uniform(g))],
                        device=device)


def train_batch(path, seed, size, device):
    """A labelled batch of ``path``'s kind: ``bench.py`` ``_mols(RandomState(
    seed), size, with_esp)``, for GCN the citation graph of ``size`` nodes,
    for the molecule-scale paths ``large_mol_graph(size, seed)``."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    cfg = TRAIN_PATHS[path]
    if cfg["model"] == "gcn":
        return citation_batch(seed, size, device)
    if cfg["model"] == "hdnnp4th_mol":
        return batch_graphs([large_mol_graph(size, seed)], global_keys=cfg["global_keys"],
                            device=device)
    return batch_graphs(labelled_mols(seed, size, cfg["with_esp"]),
                        global_keys=cfg["global_keys"], device=device)


def full_batch(path, device):
    """``path``'s full-width batch: its bench seed and size."""
    cfg = TRAIN_PATHS[path]
    return train_batch(path, cfg["seed"], cfg["size"], device)


def node_class_loss_fn(model):
    """``sec_gcn_cora``'s loss: the masked categorical cross-entropy of the
    node logits against ``node_labels`` over the real nodes."""
    from gcnn_keras_tpu_torch.training.losses import masked_categorical_crossentropy

    def loss_fn(b):
        return masked_categorical_crossentropy(model(b)["output"], b.nodes["node_labels"],
                                               b.node_mask), {}
    return loss_fn


def make_trainer(path, device, solver=None, mesh=None):
    """``(model, Trainer, TrainState)`` of a training path, ``model`` the
    module whose parameters train: weights from seed 0, ``torch.optim.Adam``
    for ``optax.adam`` (lr 1e-3; GCN 1e-2); ``solver``, the Qeq solver of
    the molecule-scale paths; ``mesh``, the ranks of a data-parallel
    ``Trainer`` (phase 30)."""
    from gcnn_keras_tpu_torch.models import gcn
    from gcnn_keras_tpu_torch.training import Trainer
    cfg = TRAIN_PATHS[path]
    if cfg["model"] == "gcn":
        model = gcn.make_model(device=device, generator=torch.Generator().manual_seed(0),
                               **GCN_CORA_KW)
        trainer = Trainer(node_class_loss_fn(model), functools.partial(torch.optim.Adam, lr=1e-2),
                          mesh=mesh)
        return model, trainer, trainer.init_state(model.parameters())
    fm = energy_force_model(cfg["model"], device, cfg.get("mode", "unfused"), solver,
                            **cfg.get("model_kw", {}))
    trainer = Trainer(ef_loss_fn(fm, cfg["force_weight"], cfg["charge_weight"]),
                      functools.partial(torch.optim.Adam, lr=1e-3), mesh=mesh)
    return fm.energy_model, trainer, trainer.init_state(fm.energy_model.parameters())


def check_kernel_call(name, args, label, timed):
    """Kernel ``name`` against its plain version on one call's arguments."""
    if name in ("sorted_segment_sum", "sorted_segment_sum_bf16"):
        return check_segment_sum(*args, label, timed)
    if name == "spd_solve":
        return check_spd(*args, label, timed)
    if name == "gather_mul_segsum":
        return check_gms(*args, label, timed)
    if name == "fused_cfconv":
        return check_fused_cfconv(*args, label, timed)
    if name in CHAIN_REPLACES:
        return check_chain(name, args, label, timed)
    return check_acsf_call(name, args, label, timed)


def check_training_kernels(path, batch):
    """Every kernel call of one step of ``path`` on its full-width ``batch``
    (a trainer of its own, before the main path), each against its plain
    version on the same inputs; the first call of each kernel is timed,
    unless the path's kernels are timed in a phase of their own. Returns
    ``{name: [record, ...]}``."""
    cfg = TRAIN_PATHS[path]
    _, trainer, state = make_trainer(path, "cuda")
    with captured_calls() as calls:
        trainer.step_fn()(state, batch)
    del trainer, state
    counts = {name: len(c) for name, c in calls.items() if c}
    if counts != {k: v for k, v in cfg["launches"].items() if v}:
        raise AssertionError(f"{path}: kernel calls {counts}, expected {cfg['launches']}")
    recs = {}
    for name, arg_list in calls.items():
        recs[name] = [
            dict(check_kernel_call(name, args, f"{path}, call {i + 1} of {len(arg_list)}",
                                   timed=i == 0 and cfg.get("time_calls", True)), path=path)
            for i, args in enumerate(arg_list)]
    return recs


def phase_training(path, smi, profiles=None):
    """Phase 10 for one path: the first step against the CPU; each kernel
    call of a step on the full-width batch against its plain version; then
    the main path, ``TRAIN_STEPS`` steps on that batch; given ``profiles``,
    a step queued on it for ``run_profiles``. Returns the main path's
    launch counts and the kernel records."""
    cfg = TRAIN_PATHS[path]
    first_seed, first_size = cfg.get("first_step", (2, 64))
    first = {}
    for dev in ("cuda", "cpu"):
        model, trainer, state = make_trainer(path, dev)
        state, metrics = trainer.step_fn()(state, train_batch(path, first_seed, first_size, dev))
        first[dev] = (float(metrics["loss"]),
                      {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = first["cuda"], first["cpu"]
    if not abs(loss_gpu - loss_cpu) <= cfg.get("loss_tol", TRAIN_TOL) * abs(loss_cpu):
        raise AssertionError(f"{path}: first loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    grad_tol = cfg.get("grad_tol", TRAIN_TOL)
    worst_rel = 0.0
    for name, ref in grads_cpu.items():
        err, scale = (grads_gpu[name] - ref).abs().max().item(), ref.abs().max().item()
        if not err <= grad_tol * scale:
            raise AssertionError(f"{path}: gradient of {name}: max|gpu-cpu|={err} > "
                                 f"{grad_tol}*{scale}")
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
    log(f"{path} first step gpu vs cpu (size {first_size}, seed {first_seed}): " + json.dumps(
        {"loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "params": len(grads_cpu),
         "max_rel_grad_err": worst_rel}))

    batch = full_batch(path, "cuda")
    kernel_recs = check_training_kernels(path, batch)
    _, trainer, state = make_trainer(path, "cuda")
    step = trainer.step_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    losses, times, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = kernel_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
        per_step.append({k: v - before[k] for k, v in kernel_counts().items()})
    main_launches = kernel_counts()
    if not all(np.isfinite(losses)) or (cfg.get("falls", True) and not losses[-1] < losses[0]):
        raise AssertionError(f"{path}: losses {losses}")
    for i, counts in enumerate(per_step):
        if counts != cfg["launches"]:
            raise AssertionError(f"{path} step {i}: launches {counts}, "
                                 f"expected {cfg['launches']}")
    rec = {"path": path, "size": cfg["size"], "seed": cfg["seed"],
           "N_pad": batch.n_node, "E_pad": batch.n_edge,
           "A_pad": 0 if batch.angles is None else batch.angles.shape[0],
           "G": batch.n_graphs, "real_edges": int(batch.edge_mask.sum().item()),
           "real_angles": 0 if batch.angles is None else int(batch.angle_mask.sum().item()),
           "losses": losses, "ms_per_step": float(np.median(times[1:])),
           "ms_first_step": times[0], "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
           "launches_per_step": cfg["launches"], "card": smi}
    log(f"{path} timing: " + json.dumps(rec))
    if profiles is not None:
        profiles.append((path, lambda: step(state, batch)))
    return main_launches, kernel_recs


# ------------------------------------------------- phases 11-14: SchNet MD


def gms_work(n_x, e, f, n):
    """Bytes (x, filt, senders and receivers read once, out written once)
    and float32 operations (an FMA per edge and column) of the gather-
    multiply-segment-sum; ``(bytes, bound_ms, bound_by)``."""
    nbytes = 4 * (e * f + n_x * f + 2 * e + n * f)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2 * e * f / H100_F32_OPS_PER_S
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cfconv_work(e, b, u, n):
    """Bytes (basis, xj, receivers and the weights read once, out written
    once), float32 operations (the two filter matmuls, the two biases and
    the message FMA per edge: 2 E (B U + U U + 2 U)) and special functions
    (one exp and one log1p per hidden value) of the fused cfconv;
    ``(bytes, bound_ms, bound_by)``."""
    nbytes = 4 * (e * b + e * u + e + b * u + u * u + 2 * u + n * u)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(2 * e * (b * u + u * u + 2 * u) / H100_F32_OPS_PER_S,
                2 * e * u / H100_SFU_PER_S)
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chain_work(name, n, e, e_real, b, u, weight_tangents=True):
    """What the function of fused-chain kernel ``name`` needs on these
    inputs: the bytes of each input read once (the edge arrays of all ``e``
    edges) and each output written once, and for each of the ``e_real``
    real edges its float32 operations (an FMA is 2) and special-function
    results; for cf_hesjvp without ``weight_tangents`` (a force loss's
    call) the terms of u_W1, u_b1, u_W2 and u_b2 are not needed. Returns
    ``(bytes, bound_ms, bound_by)``."""
    weights = b * u + u * u + 2 * u
    # every kernel: |v|^2 and r (9), the basis (3 a bin, and an exp)
    ops, sfu = 9 + 3 * b, b
    if name == "cf_fwd":
        # the filter MLP 2 (B U + U U), its biases and the message 4 U,
        # ssp 4 U (an exp and a log1p)
        ops += 2 * (b * u + u * u) + 4 * u + 4 * u
        sfu += 2 * u
        floats = (n * u + 3 * n + weights) + n * u
    elif name == "cf_vjp":
        # the MLP again with ssp and its sigmoid (3 special functions a
        # unit) 2 (B U + U U) + 4 U + 7 U; ct_x, a and the b2 and b1 sums
        # 5 U; the W2 sum and W2 a 4 U U; dz U; the W1 sum and W1^T (b g)
        # 4 B U, b g 3 B; the r cotangent 2 U; dv and its two sides 10
        ops += 2 * (b * u + u * u) + 11 * u + 5 * u + 4 * u * u + u + 4 * b * u + 3 * b \
            + 2 * u + 10
        sfu += 3 * u
        floats = (2 * n * u + 3 * n + weights) + (n * u + 3 * n + weights)
    else:
        # z 2 B U and its tangent 4 B U, F 2 U U and dF 4 U U, the biases
        # 4 U; ssp, sigmoid and dh 8 U; Ju 4 U, w_x 2 U, a and q 2 U; the
        # W2 sum 4 U U, W2 a and uW2 a + W2 q 6 U U; dzbar and zbar 6 U, the
        # b1 and b2 sums 2 U; the W1 sum 4 B U and three sums over the bins
        # 6 B U, with b g, b g dr and b (g^2 + 2 gamma) 6 B; the two r
        # cotangents 6 U; du and dr 9; wv and its two sides 30
        ops += (6 * b * u + 6 * u * u + 4 * u + 8 * u + 8 * u + 10 * u * u + 8 * u
                + 10 * b * u + 6 * b + 6 * u + 9 + 30)
        sfu += 3 * u
        floats = (3 * n * u + 6 * n + 2 * weights) + (2 * n * u + 3 * n + weights)
        if not weight_tangents:
            # b u_W1 and u_W1^T (b g) 4 B U, h u_W2 and u_W2 a 4 U U, u_b1
            # and u_b2 2 U, the third r-cotangent term 2 U; the tangents unread
            ops -= 4 * b * u + 4 * u * u + 4 * u
            floats -= weights
    nbytes = 4 * floats + e * (4 + 4 + 1)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(e_real * ops / H100_F32_OPS_PER_S, e_real * sfu / H100_SFU_PER_S)
    return nbytes, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_gms(x, filt, senders, receivers, n, label, timed):
    """The gather-multiply-segment-sum kernel against its plain version;
    timed, also the unfused chain of the JAX package's default path
    (index_select, multiply, index_add_) and the port's own unfused chain
    (index_select, multiply, the sorted segment-sum kernel)."""
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    out = fa.fused_gather_mul_segsum_kernel(x, filt, senders, receivers, n)
    torch.cuda.synchronize()
    plain = fa.fused_gather_mul_segsum_plain(x, filt, senders, receivers, n)
    scale = 1.0 + (plain.abs().max().item() if plain.numel() else 0.0)
    err = (out - plain).abs().max().item() if out.numel() else 0.0
    if out.shape != plain.shape or not err <= KERNEL_TOL * scale:
        raise AssertionError(f"gather_mul_segsum {label}: max|k-p|={err} > {KERNEL_TOL}*{scale}")
    e, f = filt.shape
    rec = {"case": label, "N": n, "E": e, "F": f, "max_abs_err": err,
           "max_abs_plain": scale - 1.0}
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=x.device)
        lib_out = torch.zeros(n, f, device=x.device)
        nbytes, bound_ms, bound_by = gms_work(x.shape[0], e, f, n)
        rec.update(
            ms=cuda_median_ms(lambda: fa.fused_gather_mul_segsum_kernel(
                x, filt, senders, receivers, n), 50, flush),
            ms_warm=cuda_median_ms(lambda: fa.fused_gather_mul_segsum_kernel(
                x, filt, senders, receivers, n), 50),
            plain_ms=cuda_median_ms(lambda: fa.fused_gather_mul_segsum_plain(
                x, filt, senders, receivers, n), 50, flush),
            library_ms=None,
            unfused_chain_ms=cuda_median_ms(
                lambda: lib_out.index_add_(0, receivers, x.index_select(0, senders) * filt),
                50, flush, before=lib_out.zero_),
            unfused_port_ms=cuda_median_ms(
                lambda: ss.segment_sum(x.index_select(0, senders) * filt, receivers, n),
                50, flush),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel gather_mul_segsum {label}: " + json.dumps(rec))
    return rec


def check_fused_cfconv(basis, xj, receivers, n, w1, b1, w2, b2, label, timed):
    """The fused cfconv kernel against its plain version, and each against
    the plain version in float64 on the card (the accuracy of the mode);
    timed, also the unfused chain (two Linear, ssp, multiply, index_add_)."""
    import torch.nn.functional as F
    from gcnn_keras_tpu_torch.ops.activ import shifted_softplus
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    args = (basis, xj, receivers, n, w1, b1, w2, b2)
    out = fc.fused_cfconv_kernel(*args)
    torch.cuda.synchronize()
    plain = fc.fused_cfconv_plain(*args)
    plain64 = fc.fused_cfconv_plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point()
                                      else a for a in args))
    scale = 1.0 + (plain.abs().max().item() if plain.numel() else 0.0)

    def maxdiff(a, b):
        return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0

    err = maxdiff(out, plain)
    if (out.shape != plain.shape or not torch.isfinite(out).all()
            or not err <= KERNEL_TOL * scale):
        raise AssertionError(f"fused_cfconv {label}: max|k-p|={err} > {KERNEL_TOL}*{scale}")
    e, b = basis.shape
    u = xj.shape[1]
    rec = {"case": label, "N": n, "E": e, "B": b, "U": u, "max_abs_err": err,
           "max_abs_plain": scale - 1.0, "kernel_max_abs_err_vs_f64": maxdiff(out, plain64),
           "plain_max_abs_err_vs_f64": maxdiff(plain, plain64)}
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=basis.device)
        lib_out = torch.zeros(n, u, device=basis.device)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()

        def unfused():
            f = F.linear(shifted_softplus(F.linear(basis, w1t, b1)), w2t, b2)
            lib_out.index_add_(0, receivers, xj * f)
        nbytes, bound_ms, bound_by = cfconv_work(e, b, u, n)
        rec.update(
            ms=cuda_median_ms(lambda: fc.fused_cfconv_kernel(*args), 50, flush),
            ms_warm=cuda_median_ms(lambda: fc.fused_cfconv_kernel(*args), 50),
            plain_ms=cuda_median_ms(lambda: fc.fused_cfconv_plain(*args), 50, flush),
            library_ms=None,
            unfused_chain_ms=cuda_median_ms(unfused, 50, flush, before=lib_out.zero_),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel fused_cfconv {label}: " + json.dumps(rec))
    return rec


def edge_case_graphs(dev, seed=3):
    """``(label, E, N, F, receivers, senders)`` of the edge cases of phase
    11: no edges; rows without edges (every other row) at F 3; F 200 (not a
    multiple of 32); one edge; padding edges, which sum onto the dead last
    node."""
    rs = np.random.RandomState(seed)
    cases = []
    for label, e, n, f, pad in (("E=0", 0, 9, 16, 0),
                                ("rows without edges, F=3", 300, 64, 3, 0),
                                ("F=200", 500, 40, 200, 0),
                                ("one edge", 1, 6, 128, 0),
                                ("padding edges", 400, 50, 128, 37)):
        recv = np.sort(rs.choice(np.arange(0, n - 1, 2), size=e - pad))
        send = rs.randint(0, n - 1, size=e - pad)
        recv = np.concatenate([recv, np.full(pad, n - 1)]).astype(np.int32)
        send = np.concatenate([send, np.full(pad, n - 1)]).astype(np.int32)
        cases.append((label, e, n, f, torch.from_numpy(recv).to(dev),
                      torch.from_numpy(send).to(dev)))
    return cases


def gms_edge_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    return [check_gms(torch.randn(n, f, generator=gen, device=dev),
                      torch.randn(e, f, generator=gen, device=dev), send, recv, n, label, False)
            for label, e, n, f, recv, send in edge_case_graphs(dev)]


def cfconv_edge_cases(dev, b=20):
    gen = torch.Generator(device=dev).manual_seed(5)
    recs = []
    for label, e, n, u, recv, _ in edge_case_graphs(dev):
        recs.append(check_fused_cfconv(
            torch.rand(e, b, generator=gen, device=dev), torch.randn(e, u, generator=gen, device=dev),
            recv, n, torch.randn(b, u, generator=gen, device=dev) / b ** 0.5,
            torch.randn(u, generator=gen, device=dev) * 0.1,
            torch.randn(u, u, generator=gen, device=dev) / u ** 0.5,
            torch.randn(u, generator=gen, device=dev) * 0.1, label.replace("F=", "U="), False))
    return recs


def phase_schnet_kernels(batch, model, names=("gather_mul_segsum", "fused_cfconv")):
    """Phase 11: the gms and fused cfconv kernels (those of ``names``)
    against their plain versions at the SchNet serving shapes of ``batch``
    (its senders, receivers and Gaussian basis; random node features and
    filters; the filter weights of ``model``'s first interaction) and at
    the MD step's shape (``md_batch``, where an MD step launches each 4
    times), timed, and at the edge cases."""
    from gcnn_keras_tpu_torch.layers.geometry import edge_distances, gauss_basis
    dev = batch.senders.device
    gen = torch.Generator(device=dev).manual_seed(6)
    n, e = batch.n_node, batch.n_edge
    units = model.config["interaction_args"]["units"]
    with torch.no_grad():
        basis = gauss_basis(edge_distances(batch), **model.config["gauss_args"])
        basis = (basis * batch.edge_mask[:, None].to(basis.dtype)).contiguous()
        cf = model.interaction_0.cfconv
        weights = (cf.filter_1.weight.t().contiguous(), cf.filter_1.bias,
                   cf.filter_2.weight.t().contiguous(), cf.filter_2.bias)
    x = torch.randn(n, units, generator=gen, device=dev)
    filt = torch.randn(e, units, generator=gen, device=dev)
    xj = torch.randn(e, units, generator=gen, device=dev)
    label = "SchNet serving, 512 mols"
    md = md_batch(dev)  # the MD step's shape: few rows, few edges
    md_label = f"MD shape, 21 atoms (N {md.n_node}, E {md.n_edge})"
    out = {}
    if "gather_mul_segsum" in names:
        md_gen = torch.Generator(device=dev).manual_seed(7)
        gms = [check_gms(x, filt, batch.senders, batch.receivers, n, label, True),
               check_gms(torch.randn(md.n_node, units, generator=md_gen, device=dev),
                         torch.randn(md.n_edge, units, generator=md_gen, device=dev),
                         md.senders, md.receivers, md.n_node, md_label, True)]
        gms += gms_edge_cases(dev)
        gms[0]["path"] = "schnet_fused_serving"
        out["gather_mul_segsum"] = gms
    if "fused_cfconv" not in names:
        return out
    cfconv = [check_fused_cfconv(basis, xj, batch.receivers, n, *weights, label, True)]
    with torch.no_grad():
        md_basis = gauss_basis(edge_distances(md), **model.config["gauss_args"])
        md_basis = (md_basis * md.edge_mask[:, None].to(md_basis.dtype)).contiguous()
    cfconv.append(check_fused_cfconv(
        md_basis, torch.randn(md.n_edge, units, generator=gen, device=dev), md.receivers,
        md.n_node, *weights, md_label, True))
    cfconv += cfconv_edge_cases(dev)
    cfconv[0]["path"] = "schnet_accurate_serving"
    return dict(out, fused_cfconv=cfconv)


def bilinear_family_graph():
    """``tests/test_bilinear_family.py``'s ``_random_graph(RandomState(0))``:
    receiver-sorted edges of 5 graphs of up to 7 nodes, 3 padding edges at a
    dead last node; ``(n, send, recv, perm, f)``."""
    rs = np.random.RandomState(0)
    sizes = rs.randint(2, 8, 5)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offs[-1]) + 1
    send, recv = [], []
    for g in range(5):
        for i in range(sizes[g]):
            for j in range(sizes[g]):
                if i != j and rs.rand() < 0.7:
                    send.append(offs[g] + j)
                    recv.append(offs[g] + i)
    send, recv = np.asarray(send + [n - 1] * 3, np.int32), np.asarray(recv + [n - 1] * 3, np.int32)
    order = np.argsort(recv, kind="stable")
    send, recv = send[order], recv[order]
    return n, send, recv, np.argsort(send, kind="stable").astype(np.int32), 4


def gms_second_order(device, fused):
    """The grad-of-grad pattern of ``tests/test_bilinear_family.py``
    (``_force_training_setup``): a two-layer energy through the bilinear
    op, force = d energy / d r, loss = energy + sum(sin(force)^2); returns
    the loss's gradients along theta and r, through GMS (``fused``) or the
    plain chain."""
    from gcnn_keras_tpu_torch.ops.cuda.bilinear import bilinear_gather_mul_segsum
    n, send, recv, perm, f = bilinear_family_graph()
    rs = np.random.RandomState(3)
    x0, theta, r = (torch.from_numpy(a.astype(np.float32)).to(device)
                    for a in (rs.randn(n, f), rs.randn(f, f), rs.randn(len(send), f)))
    ts, tr, tp = (torch.from_numpy(a).to(device) for a in (send, recv, perm))

    def bil(x, m):
        if fused:
            return bilinear_gather_mul_segsum(x, m, ts, tr, tp)
        return torch.zeros(n, f, device=device).index_add_(0, tr, x.index_select(0, ts) * m)

    def energy(theta, r):
        m = torch.tanh(r @ theta)
        return (bil(torch.tanh(bil(x0 @ theta, m)), m * 2.0) ** 2).sum()

    theta.requires_grad_(True)
    r.requires_grad_(True)
    (force,) = torch.autograd.grad(energy(theta, r), r, create_graph=True)
    return torch.autograd.grad(energy(theta, r) + (torch.sin(force) ** 2).sum(), (theta, r))


def phase_gms_second_order(device="cuda"):
    """Phase 13: the grad-of-grad pattern on the card, GMS against the
    plain chain; the kernel launches on the 4 forward applications only."""
    before = kernel_counts()
    fused = gms_second_order(device, True)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernel_counts().items() if v != before[k]}
    plain = gms_second_order(device, False)
    recs = []
    for name, g, p in zip(("theta", "r"), fused, plain):
        err, scale = (g - p).abs().max().item(), p.abs().max().item()
        if not err <= SECOND_ORDER_TOL * max(scale, 1.0):
            raise AssertionError(f"gms second-order pattern d/d{name}: max|k-p|={err}, "
                                 f"max|p|={scale}")
        recs.append({"wrt": name, "max_abs_err": err, "max_abs_plain": scale})
    if launched.get("gather_mul_segsum") != 4:
        raise AssertionError(f"gms second-order pattern: launches {launched}")
    rec = {"case": "second-order pattern of tests/test_bilinear_family.py", "grads": recs,
           "launches": launched}
    log("kernel gms pair: " + json.dumps(rec))
    return rec


def md_system(rs, n, t):
    """``bench.py`` ``_md_system``: a helical chain of ``n`` atoms."""
    pos = np.stack([t, 1.5 * np.sin(t * 0.9), 1.5 * np.cos(t * 0.7)], axis=1)
    return {"node_number": rs.choice([1, 6, 7, 8], size=n),
            "node_coordinates": (pos + rs.randn(n, 3) * 0.1).astype(np.float32)}


def md_batch(device, cutoff=4.0):
    """``bench.py`` ``sec_md_single``'s 21-atom molecule, neighbours within
    ``cutoff`` (4 A; at most 25), as one batch."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_range
    n = 21
    g = md_system(np.random.RandomState(7), n, np.arange(n) * 1.2)
    g["energy"] = np.array([0.0], dtype=np.float32)
    g = set_range(g, max_distance=cutoff, max_neighbours=25)
    g["edge_indices"] = g.pop("range_indices")
    return batch_graphs([g], global_keys=("energy",), device=device)


def check_captured(calls, label):
    """Every kernel call recorded by ``captured_calls`` against its plain
    version."""
    return {name: [check_kernel_call(name, args, f"{label}, call {i + 1} of {len(arg_list)}",
                                     False) for i, args in enumerate(arg_list)]
            for name, arg_list in calls.items() if arg_list}


def phase_md_single(smi, device="cuda"):
    """Phase 14 (a): ``bench.py`` ``sec_md_single`` in each SchNet mode:
    velocity Verlet from rest, masses 12, dt 5e-4; each kernel call of one
    evaluation against its plain version; launches per step; the time per
    step as the smallest slope between the two trajectory lengths over
    interleaved pairs; the modes' energies against the unfused ones."""
    from gcnn_keras_tpu_torch.moldyn.integrate import make_energy_force_fn, velocity_verlet
    batch = md_batch(device)
    pos0 = batch.nodes["node_coordinates"]
    vel0 = torch.zeros_like(pos0)
    masses = torch.full((batch.n_node,), 12.0, device=pos0.device)
    fns = {mode: make_energy_force_fn(schnet_model(mode, device), batch)
           for mode in SCHNET_MODES}
    recs = {}
    for mode, fn in fns.items():
        with captured_calls() as calls:
            e0, f0 = fn(pos0)
        recs[mode] = check_captured(calls, f"MD 21 atoms, {mode}")
        if not (torch.isfinite(f0).all() and f0.sum(0).abs().max().item()
                <= FORCE_SUM_TOL * batch.n_node * f0.abs().max().item()):
            raise AssertionError(f"MD {mode}: forces not finite or not summing to 0")

    def run(mode, steps):
        return velocity_verlet(fns[mode], pos0, vel0, masses, MD_DT, steps,
                               node_mask=batch.node_mask)

    def wall(mode, steps):
        t0 = time.perf_counter()
        run(mode, steps)  # returns after the series reached the host
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    short, long = MD_STEPS
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    trajs = {}
    for mode in SCHNET_MODES:
        before = kernel_counts()
        trajs[mode] = run(mode, short)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in kernel_counts().items()}
        want = {k: (short + 1) * v for k, v in schnet_launches(mode).items()}
        if got != want:
            raise AssertionError(f"MD {mode}: launches {got} in {short} steps, expected {want}")
        run(mode, long)
    slopes = {mode: [] for mode in SCHNET_MODES}
    for _ in range(MD_PAIRS):
        for mode in SCHNET_MODES:
            slopes[mode].append((wall(mode, long) - wall(mode, short)) / (long - short))
    main_launches = kernel_counts()
    ref = trajs["unfused"]["e_pot"]
    out = {"atoms": int(batch.node_mask.sum().item()), "N_pad": batch.n_node,
           "E_pad": batch.n_edge, "real_edges": int(batch.edge_mask.sum().item()),
           "steps": MD_STEPS, "pairs": MD_PAIRS, "card": smi}
    for mode, traj in trajs.items():
        if not np.isfinite(traj["e_pot"]).all():
            raise AssertionError(f"MD {mode}: non-finite energies")
        err = float(np.abs(traj["e_pot"] - ref).max())
        if not err <= MD_TOL * float(np.abs(ref).max()):
            raise AssertionError(f"MD {mode}: e_pot off the unfused one by {err}")
        out[mode] = {"us_per_md_step": 1e6 * min(slopes[mode]),
                     "us_per_md_step_slopes": [1e6 * v for v in slopes[mode]],
                     "e_pot_max_abs_err_vs_unfused": err,
                     "launches_per_step": schnet_launches(mode)}
    log("md single: " + json.dumps(out))
    return main_launches, recs


def phase_md_ensemble(smi, device="cuda"):
    """Phase 14 (b): ``bench.py`` ``sec_md_ensemble`` in each SchNet mode:
    64 replicas of the 21-atom molecule through ``ScannedMD``, one segment
    to warm up, then ``ENSEMBLE_SEGMENTS`` timed; the time per replica-step;
    launches per step; the modes' energies against the unfused ones."""
    from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
    n = 21
    t = np.arange(n) * 1.2
    systems = [md_system(np.random.RandomState(100 + s), n, t) for s in range(ENSEMBLE_REPLICAS)]
    runs = {mode: ScannedMD(schnet_model(mode, device), dt=MD_DT,
                            segment_steps=ENSEMBLE_SEGMENT_STEPS, max_distance=4.0,
                            max_neighbours=25, device=device) for mode in SCHNET_MODES}
    for md in runs.values():
        md.run_ensemble(systems, 1)
    torch.cuda.synchronize()
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    outs, stats = {}, {}
    for mode, md in runs.items():
        before = kernel_counts()
        t0 = time.perf_counter()
        outs[mode] = md.run_ensemble(systems, ENSEMBLE_SEGMENTS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps = ENSEMBLE_SEGMENTS * ENSEMBLE_SEGMENT_STEPS
        got = {k: v - before[k] for k, v in kernel_counts().items()}
        evals = ENSEMBLE_SEGMENTS * (ENSEMBLE_SEGMENT_STEPS + 1)
        want = {k: evals * v for k, v in schnet_launches(mode).items()}
        if got != want:
            raise AssertionError(f"ensemble {mode}: launches {got}, expected {want}")
        stats[mode] = {"us_per_replica_step": 1e6 * seconds / steps / ENSEMBLE_REPLICAS,
                       "ms_per_step": 1e3 * seconds / steps}
    main_launches = kernel_counts()
    ref = outs["unfused"]["e_pot"]
    for mode, out in outs.items():
        if out["e_pot"].shape != (ENSEMBLE_SEGMENTS * ENSEMBLE_SEGMENT_STEPS, ENSEMBLE_REPLICAS) \
                or not np.isfinite(out["e_pot"]).all() or not np.isfinite(out["e_kin"]).all():
            raise AssertionError(f"ensemble {mode}: e_pot {out['e_pot'].shape}, or not finite")
        err = float(np.abs(out["e_pot"] - ref).max())
        if not err <= MD_TOL * float(np.abs(ref).max()):
            raise AssertionError(f"ensemble {mode}: e_pot off the unfused one by {err}")
        stats[mode].update(e_pot_max_abs_err_vs_unfused=err, edge_counts=out["edge_counts"])
    log("md ensemble: " + json.dumps({"replicas": ENSEMBLE_REPLICAS,
                                      "segment_steps": ENSEMBLE_SEGMENT_STEPS,
                                      "segments": ENSEMBLE_SEGMENTS, **stats, "card": smi}))
    return main_launches


def nve_system(device):
    """``tools/nve_drift_tpu.py``'s 64-atom cluster: a 4x4x4 grid at 1.6 A
    jittered by 0.05 A, elements H, C, O, neighbours within 6 A (at most
    25); its masses (padding atoms 1) and starting velocities, drawn as the
    tool draws them."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_range
    n = 64
    rs = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*[np.arange(4) * 1.6] * 3), -1).reshape(-1, 3)
    pos = (grid[:n] + rs.randn(n, 3) * 0.05).astype(np.float32)
    g = {"node_number": rs.choice([1, 6, 8], size=n), "node_coordinates": pos}
    g = set_range(g, max_distance=6.0, max_neighbours=25)
    g["edge_indices"] = g.pop("range_indices")
    batch = batch_graphs([g], device=device)
    mass_tab = np.array([0, 1.0, 0, 0, 0, 0, 12.0, 14.0, 16.0, 19.0])
    z = np.clip(batch.nodes["node_number"].cpu().numpy().astype(int), 0, 9)
    masses = np.where(batch.node_mask.cpu().numpy(), mass_tab[z], 1.0).astype(np.float32)
    vel0 = (rs.randn(batch.n_node, 3) * 0.02).astype(np.float32)
    return batch, torch.from_numpy(masses).to(device), torch.from_numpy(vel0).to(device)


def phase_nve(smi, device="cuda"):
    """Phase 14 (c): the NVE drift of ``tools/nve_drift_tpu.py``'s tethered
    64-atom system (SchNet depth 2, 32 units, 16 bins to 6 A) in each mode,
    under ``tests/test_nve_conservation.py``'s bounds."""
    from gcnn_keras_tpu_torch.moldyn.integrate import (
        make_energy_force_fn, nve_drift, velocity_verlet)
    batch, masses, vel0 = nve_system(device)
    pos0 = batch.nodes["node_coordinates"]
    kw = dict(depth=2, interaction_args={"units": 32},
              gauss_args={"bins": 16, "distance_max": 6.0, "sigma": 0.4},
              last_mlp={"units": [32, 16], "activation": ["shifted_softplus"] * 2},
              output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]})
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    out = {"atoms": int(batch.node_mask.sum().item()),
           "edges": int(batch.edge_mask.sum().item()), "steps": NVE_STEPS, "dt": 0.01,
           "card": smi}
    for mode in SCHNET_MODES:
        base = make_energy_force_fn(schnet_model(mode, device, **kw), batch)

        def tethered(p, base=base):
            e, f = base(p)
            d = p - pos0
            return e + 0.25 * (d * d).sum(), f - 0.5 * d
        before = kernel_counts()
        t0 = time.perf_counter()
        traj = velocity_verlet(tethered, pos0, vel0, masses, 0.01, NVE_STEPS,
                               node_mask=batch.node_mask)
        seconds = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in kernel_counts().items()}
        want = {k: (NVE_STEPS + 1) * v for k, v in schnet_launches(mode, depth=2).items()}
        if got != want:
            raise AssertionError(f"NVE {mode}: launches {got}, expected {want}")
        drift = nve_drift(traj)
        for key, bound in NVE_BOUNDS.items():
            if not drift[key] < bound:
                raise AssertionError(f"NVE {mode}: {key} {drift[key]} >= {bound}")
        out[mode] = {**drift, "ms_per_step": 1e3 * seconds / NVE_STEPS}
    log("md nve drift: " + json.dumps(out))
    return kernel_counts()


def phase_schnet_md(gpu, requests, batch0, smi, unfused_answers):
    """Phases 11-14; returns the kernel records and the launches of each
    main path."""
    records = phase_schnet_kernels(batch0, gpu.model.energy_model)
    by_path = {}
    for mode in ("fused", "accurate"):
        mgpu = make_predictor("cuda", mode)
        by_path[f"schnet_{mode}_serving"] = phase_model_serving(
            mgpu, requests, batch0, smi, name=f"schnet {mode}",
            make_cpu=functools.partial(make_predictor, mode=mode),
            expected=schnet_launches(mode), reference=unfused_answers)
    second_order = phase_gms_second_order()
    by_path["md_single"], md_calls = phase_md_single(smi)
    by_path["md_ensemble"] = phase_md_ensemble(smi)
    by_path["md_nve"] = phase_nve(smi)
    for calls in md_calls.values():
        for name, rs in calls.items():
            records.setdefault(name, []).extend(dict(r, path="md_single") for r in rs)
    return records, by_path, second_order


# ------------------------------------ phases 15-16: the fused interaction chain

# the TPU kernel each fused-chain kernel replaces (its pl.pallas_call line)
CHAIN_REPLACES = {"cf_fwd": "gcnn_keras_tpu/ops/pallas/fused_interaction.py:471",
                  "cf_vjp": "gcnn_keras_tpu/ops/pallas/fused_interaction.py:531",
                  "cf_hesjvp": "gcnn_keras_tpu/ops/pallas/fused_interaction.py:594"}
# each output of a fused-chain kernel: max|kernel - plain| <= tol * (1 +
# max|plain|), KERNEL_TOL for the forward (sums in edge order); the VJP and
# the second reverse pass add the sender sides and the weight sums with
# atomics, in an order that varies from run to run
CHAIN_VJP_TOL = 1e-4


def unfused_chain(x, pos, w1, b1, w2, b2, senders, receivers, edge_mask, st, perm):
    """The port's unfused path for the chain's function: the position and
    sender gathers (their transposes on the segment-sum kernel), the
    Gaussian basis, two ``Linear`` with ssp, the mask and the segment-sum
    kernel onto the receivers."""
    import torch.nn.functional as F
    from gcnn_keras_tpu_torch.layers.geometry import gauss_basis
    from gcnn_keras_tpu_torch.ops.activ import shifted_softplus
    from gcnn_keras_tpu_torch.ops.cuda.fused_aggregate import gather_with_sorted_transpose
    from gcnn_keras_tpu_torch.ops.segment import segment_sum
    vec = (gather_with_sorted_transpose(pos, receivers)
           - gather_with_sorted_transpose(pos, senders, perm))
    d2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    d = torch.where(d2 > 1e-12, torch.sqrt(d2.clamp_min(1e-12)), torch.full_like(d2, 1e-6))
    basis = gauss_basis(d, bins=st.bins, distance_max=st.distance_max, offset=st.offset,
                        sigma=st.sigma)
    f = F.linear(shifted_softplus(F.linear(basis, w1.t(), b1)), w2.t(), b2)
    m = gather_with_sorted_transpose(x, senders, perm) * f * edge_mask[:, None].to(f.dtype)
    return segment_sum(m, receivers, x.shape[0], indices_are_sorted=True)


def chain_unfused_run(name, args, perm):
    """A call of the port's unfused chain that computes what kernel ``name``
    computes from ``args``: the forward; the forward and its reverse pass
    pulled back from ct; those with the graph kept, then the reverse pass
    of that along u (which gives J u and the second-order terms)."""
    *args, st = args
    edges = args[-3:]
    res, rest = args[:6], args[6:-3]

    def run():
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in res]
            y = unfused_chain(*xs, *edges, st, perm)
            if name == "cf_fwd":
                return y
            ct = rest[0].detach().requires_grad_(name == "cf_hesjvp")
            grads = torch.autograd.grad(y, xs, ct, create_graph=name == "cf_hesjvp")
            if name == "cf_vjp":
                return grads
            given = [(g, t) for g, t in zip(grads, rest[1:]) if t is not None]
            return torch.autograd.grad([g for g, _ in given], xs + [ct],
                                       [t for _, t in given], allow_unused=True)
    return run


def check_chain(name, args, label, timed, perm=None):
    """Fused-chain kernel ``name`` against its plain version on the
    wrapper's arguments ``args`` (the static configuration last), each
    output; timed (given the batch's ``sender_perm``), also the port's
    unfused chain for the same function."""
    mod, attr, plain = kernel_wrappers()[name]
    kernel = getattr(mod, attr)
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    outs, refs = ((out,), (ref,)) if name == "cf_fwd" else (out, ref)
    tol = KERNEL_TOL if name == "cf_fwd" else CHAIN_VJP_TOL
    errs, worst = [], 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        scale = 1.0 + (r.abs().max().item() if r.numel() else 0.0)
        err = (o - r).abs().max().item() if r.numel() else 0.0
        if o.shape != r.shape or not torch.isfinite(o).all() or not err <= tol * scale:
            raise AssertionError(f"{name} {label}, output {i}: max|k-p|={err} > {tol}*{scale}")
        errs.append(err)
        worst = max(worst, err / scale)
    x, mask, st = args[0], args[-2], args[-1]
    n, e, e_real = x.shape[0], mask.shape[0], int(mask.sum().item())
    rec = {"case": label, "N": n, "E": e, "real_edges": e_real, "U": st.units, "B": st.bins,
           "max_abs_err": max(errs, default=0.0), "max_abs_err_by_output": errs,
           "max_err_over_tol_scale": worst}
    if name == "cf_hesjvp":
        rec["weight_tangents"] = any(t is not None for t in args[9:13])
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=x.device)
        nbytes, bound_ms, bound_by = chain_work(name, n, e, e_real, st.bins, st.units,
                                                rec.get("weight_tangents", True))
        rec.update(
            ms=cuda_median_ms(lambda: kernel(*args), 30, flush),
            ms_warm=cuda_median_ms(lambda: kernel(*args), 30),
            plain_ms=cuda_median_ms(lambda: plain(*args), 10, flush),
            library_ms=None,
            unfused_chain_ms=cuda_median_ms(chain_unfused_run(name, args, perm), 20, flush),
            bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    log(f"kernel {name} {label}: " + json.dumps(rec))
    return rec


def chain_args(name, x, pos, weights, ct, tangents, edges, st, training=False):
    """The wrapper arguments of fused-chain kernel ``name``; for cf_hesjvp
    with ``training``, those of a force loss's call: the weight tangents
    absent (``None``)."""
    if name == "cf_fwd":
        return (x, pos, *weights, *edges, st)
    if name == "cf_vjp":
        return (x, pos, *weights, ct, *edges, st)
    if training:
        tangents = (*tangents[:2], None, None, None, None)
    return (x, pos, *weights, ct, *tangents, *edges, st)


def chain_calls(name):
    """The calls of kernel ``name`` that phase 15 checks, as the
    ``training`` flag of :func:`chain_args` and a suffix of the case's
    label: cf_hesjvp is held both as a force loss calls it (its weight
    tangents absent; the call the training step makes) and with every
    tangent."""
    if name == "cf_hesjvp":
        return ((True, ", force-loss tangents"), (False, ", all tangents"))
    return ((False, ""),)


def chain_inputs(n, u, b, seed, dev, pos=None):
    """Random node features, positions (given, or N(0, 1.5^2)), filter
    weights, cotangent and tangents for the fused-chain kernels."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    x = rnd(n, u)
    pos = rnd(n, 3, scale=1.5) if pos is None else pos
    weights = (rnd(b, u, scale=b ** -0.5), rnd(u, scale=0.1), rnd(u, u, scale=u ** -0.5),
               rnd(u, scale=0.1))
    tangents = tuple(rnd(*t.shape) for t in (x, pos, *weights))
    return x, pos, weights, rnd(n, u), tangents


def chain_edge_cases(dev, seed=8):
    """``(label, n, u, b, receivers, senders, mask, pos)`` of the edge cases
    of phase 15; ``pos`` None draws random positions."""
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    rs = np.random.RandomState(seed)
    gate = max(u for u in range(1, 512) if fi.fits_shared_memory(20, u))
    cases = []

    def add(label, n, u, b, recv, send, mask, pos=None):
        cases.append((label, n, u, b, *(torch.from_numpy(np.asarray(a, t)).to(dev)
                                        for a, t in ((recv, np.int32), (send, np.int32),
                                                     (mask, bool))), pos))

    add("no edges", 9, 16, 8, [], [], [])
    add("all padding", 50, 32, 8, [49] * 40, [49] * 40, [False] * 40)
    add("one edge", 6, 128, 20, [2], [4], [True])
    recv = np.sort(rs.choice(np.arange(0, 63, 2), 300))
    add("rows without edges, 10% masked", 64, 32, 8, recv, rs.randint(0, 63, 300),
        rs.rand(300) > 0.1)
    # pairs of atoms at one position, edges within each pair and self-edges
    half = rs.randn(20, 3).astype(np.float32) * 1.5
    pos = torch.from_numpy(np.repeat(half, 2, axis=0)).to(dev)
    recv = np.sort(np.concatenate([np.arange(40), np.arange(40), rs.randint(0, 40, 120)]))
    send = np.where(np.arange(200) % 3 == 0, recv ^ 1, np.where(np.arange(200) % 3 == 1, recv,
                                                                 rs.randint(0, 40, 200)))
    add("coincident positions", 40, 16, 8, recv, send, np.ones(200, bool), pos)
    recv = np.sort(rs.randint(0, 3000, 2000))
    add("senders 1000-2000 rows away", 3000, 32, 8, recv,
        (recv + 1000 + rs.randint(0, 1000, 2000)) % 3000, np.ones(2000, bool))
    recv = np.concatenate([np.sort(rs.randint(0, 1000, 3800)), np.full(200, 1000)])
    send = np.concatenate([rs.randint(0, 1000, 3800), np.full(200, 1000)])
    add("N 1001, not a multiple of a block; padding edges", 1001, 64, 20, recv, send,
        np.arange(4000) < 3800)
    recv = np.sort(rs.randint(0, 100, 400))
    add("U=3", 100, 3, 20, recv, rs.randint(0, 100, 400), np.ones(400, bool))
    recv = np.sort(rs.randint(0, 300, 1500))
    add(f"U={gate}, the shared-memory gate", 300, gate, 20, recv, rs.randint(0, 300, 1500),
        np.ones(1500, bool))
    return cases


def chain_edge_case_checks(dev, names=None):
    """Each fused-chain kernel of ``names`` (all by default) against its
    plain version at each edge case; with no real edges every output is
    exactly 0."""
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    names = fi.KERNELS if names is None else names
    recs = {name: [] for name in names}
    for i, (label, n, u, b, recv, send, mask, pos) in enumerate(chain_edge_cases(dev)):
        st = fi.CFStatic(bins=b, distance_max=4.0, offset=0.0, sigma=0.4, units=u)
        x, pos, weights, ct, tangents = chain_inputs(n, u, b, 20 + i, dev, pos)
        for name in names:
            for training, suffix in chain_calls(name):
                rec = check_chain(name, chain_args(name, x, pos, weights, ct, tangents,
                                                   (send, recv, mask), st, training),
                                  label + suffix, False)
                if not mask.any() and rec["max_abs_err"] != 0.0:
                    raise AssertionError(f"{name} {label}: output without real edges")
                recs[name].append(rec)
    return recs


def chain_timed_check(name, batch, model):
    """Fused-chain kernel ``name`` against its plain version at the shapes
    of ``batch`` (its edges and positions, the filter weights of ``model``'s
    first interaction, random node features, cotangent and tangents), timed,
    for each call of :func:`chain_calls`: the first is the training step's,
    whose time the ``kernels`` line reports."""
    cf = model.interaction_0.cfconv
    st = cf.chain_static
    x, pos, _, ct, tangents = chain_inputs(batch.n_node, st.units, st.bins, 9,
                                           batch.senders.device,
                                           batch.nodes["node_coordinates"])
    with torch.no_grad():
        weights = tuple(t.contiguous() for t in cf.filter_weights())
    edges = (batch.senders, batch.receivers, batch.edge_mask)
    label = f"schnet_train batch, {batch.n_graphs - 1} mols"
    return [dict(check_chain(name, chain_args(name, x, pos, weights, ct, tangents, edges, st,
                                              training),
                             label + suffix, True, batch.edges["sender_perm"]),
                 path="schnet_chain_train")
            for training, suffix in chain_calls(name)]


def phase_chain_kernels(batch, model):
    """Phase 15: the three fused-chain kernels at the edge cases, then timed
    at the shapes of ``batch`` (:func:`chain_timed_check`)."""
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    recs = chain_edge_case_checks(batch.senders.device)
    for name in fi.KERNELS:
        recs[name][:0] = chain_timed_check(name, batch, model)
    return recs


# ------------------------------------------------------- phase 17: PAiNN serving


def phase_painn_serving(requests, smi):
    """Phase 17: every segment-sum call of one evaluation of the first
    request's batch against its plain version (the first call at
    ``PAINN_WIDE`` columns timed), then the 3 requests as phase 4 serves
    them. Returns the main path's launch counts and the records."""
    gpu = make_painn_predictor("cuda")
    _, batch = gpu.make_batch(requests[0][1])
    if (batch.n_node, batch.n_edge, batch.n_graphs) != (8192, 54784, 513):
        raise AssertionError(f"unexpected PAiNN full-width shapes {batch.n_node} "
                             f"{batch.n_edge} {batch.n_graphs}")
    with captured_calls() as calls:
        gpu.model(batch)
        torch.cuda.synchronize()
    counts = {name: len(c) for name, c in calls.items() if c}
    if counts != {k: v for k, v in PAINN_LAUNCHES.items() if v}:
        raise AssertionError(f"painn: kernel calls {counts}, expected {PAINN_LAUNCHES}")
    seg = calls["sorted_segment_sum"]
    wide = next(i for i, args in enumerate(seg) if args[0].shape[1] == PAINN_WIDE)
    recs = [dict(check_segment_sum(*args, f"painn_serving, call {i + 1} of {len(seg)}",
                                   timed=i == wide), path="painn_serving")
            for i, args in enumerate(seg)]
    launches = phase_model_serving(gpu, requests, batch, smi, name="painn",
                                   make_cpu=make_painn_predictor, expected=PAINN_LAUNCHES)
    return launches, recs


# ------------------------------------------- phase 18: HDNNP4th at molecule scale


def mol_answer(fm, batch):
    """One evaluation of a batch of one molecule: its energy, and the
    forces and charges of its atoms (the first nodes), on the host."""
    out = fm.apply(batch)
    n = int(batch.node_mask.sum().item())
    return {"energy": out["energy"][0].detach().cpu().numpy(),
            "force": out["force"][:n].detach().cpu().numpy(),
            "charge": out["charge"][:n].detach().cpu().numpy()}


def phase_mol_serving(n, smi, device="cuda"):
    """Phase 18, one molecule of ``n`` atoms (``large_mol_graph``): every
    kernel call of one evaluation against its plain version; then the main
    path, one evaluation with the launches held to ``mol_launches(n)``,
    against the CPU on the same weights (energies, forces and charges,
    charges summing to the total charge); then the time per evaluation.
    Returns the main path's launch counts and the kernel records."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver as qs
    path, expected = f"hdnnp4th_mol{n}_serving", mol_launches(n)
    with native_calls() as lists:
        g = large_mol_graph(n)
    fm = energy_force_model("hdnnp4th_mol", device)
    batch = batch_graphs([g], global_keys=("energy", "total_charge"), device=device)
    with captured_calls() as calls:
        fm.apply(batch)
        torch.cuda.synchronize()
    counts = {name: len(c) for name, c in calls.items() if c}
    if counts != {k: v for k, v in expected.items() if v}:
        raise AssertionError(f"{path}: kernel calls {counts}, expected {expected}")
    recs = {name: [dict(check_kernel_call(name, args, f"{path}, call {i + 1} of {len(c)}",
                                          False), path=path)
                   for i, args in enumerate(c)]
            for name, c in calls.items() if c}

    # the main path: every count set to 0 just before, read just after
    reset_counts()
    solves = qs.solves
    ans = mol_answer(fm, batch)
    launches = kernel_counts()
    if launches != expected or qs.solves != solves:
        raise AssertionError(f"{path}: launches {launches} and {qs.solves - solves} CG "
                             f"solves, expected {expected} and none")
    cpu = energy_force_model("hdnnp4th_mol", "cpu")
    for (wname, wg), (_, wc) in zip(fm.energy_model.state_dict().items(),
                                    cpu.energy_model.state_dict().items()):
        if not torch.equal(wg.cpu(), wc):
            raise AssertionError(f"weights differ between devices: {wname}")
    t0 = time.perf_counter()
    cpu_ans = mol_answer(cpu, batch_graphs([g], global_keys=("energy", "total_charge"),
                                           device="cpu"))
    cpu_s = time.perf_counter() - t0
    check_charged_request([ans], [g], path)
    check_charged_request([cpu_ans], [g], f"{path} cpu")
    errs = compare_answers([ans], [cpu_ans], ("energy", "force", "charge"))

    for _ in range(2):
        fm.apply(batch)
    torch.cuda.synchronize()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fm.apply(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    rec = {"path": path, "atoms": n, "N_pad": batch.n_node, "E_pad": batch.n_edge,
           "A_pad": batch.angles.shape[0], "real_edges": int(batch.edge_mask.sum().item()),
           "real_angles": int(batch.angle_mask.sum().item()), "max_nodes": batch.max_nodes,
           "gpu_vs_cpu": errs, "cpu_s": cpu_s, "ms_per_eval": float(np.median(times)),
           "ms_per_eval_min": float(np.min(times)),
           "peak_mem_mb": (torch.cuda.max_memory_allocated() / 2**20
                           if device == "cuda" else None),
           "launches_per_eval": expected,
           "neighbour_list": "native" if lists["neighbor_list"] else "numpy", "card": smi}
    log(f"{path}: " + json.dumps(rec))
    return launches, recs


@contextlib.contextmanager
def cg_rounds():
    """Inside the block, the rounds of each CG call of the iterative Qeq
    solve, in call order; yields the list."""
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver as qs
    rounds, original = [], qs._pcg

    def recording(*args):
        before = qs.rounds
        x = original(*args)
        rounds.append(qs.rounds - before)
        return x
    qs._pcg = recording
    try:
        yield rounds
    finally:
        qs._pcg = original


def phase_qeq_ab(smi, device="cuda"):
    """Phase 18, the iterative Qeq against the dense one: at each size of
    ``QEQ_AB_STEPS``, the first training step of ``hdnnp4th_mol{n}_train``
    with ``solver="iterative"`` (default ``cg_tol``) against the same step
    with the dense solve on the same weights (loss and every gradient, to
    ``CG_LOSS_RTOL``/``CG_GRAD_TOL``), its kernel launches and CG solves
    held to their derived counts; then the steps that follow, dense and
    iterative in turns, timed. Returns the launch counts of each size's
    first iterative step, by path."""
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver as qs
    by_path = {}
    for n, steps in QEQ_AB_STEPS.items():
        path = f"hdnnp4th_mol{n}_train"
        batch = train_batch(path, 3, n, device)
        runs, first = {}, {}
        for solver in ("dense", "iterative"):
            model, trainer, state = make_trainer(path, device, solver)
            step = trainer.step_fn()
            reset_counts()
            solves = qs.solves
            with cg_rounds() as rounds:
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
            first[solver] = dict(loss=float(metrics["loss"]), launches=kernel_counts(),
                                 solves=qs.solves - solves, rounds=rounds,
                                 grads={k: p.grad.detach().clone()
                                        for k, p in model.named_parameters()})
            runs[solver] = [step, state]
        dense, cg = first["dense"], first["iterative"]
        expected = mol_launches(n, train=True)
        if (dense["launches"], dense["solves"]) != (expected, 0) or (
                cg["launches"], cg["solves"]) != ({**expected, "spd_solve": 0},
                                                  CG_SOLVES["train"]):
            raise AssertionError(f"{path}: launches and CG solves, dense {dense['launches']} "
                                 f"{dense['solves']}, iterative {cg['launches']} "
                                 f"{cg['solves']}")
        if max(cg["rounds"]) >= 10 * n:
            raise AssertionError(f"{path}: a CG solve ran to maxiter: {cg['rounds']}")
        if not abs(cg["loss"] - dense["loss"]) <= CG_LOSS_RTOL * abs(dense["loss"]):
            raise AssertionError(f"{path}: loss {cg['loss']} iterative, {dense['loss']} dense")
        worst = 0.0
        for name, ref in dense["grads"].items():
            err, scale = (cg["grads"][name] - ref).abs().max().item(), ref.abs().max().item()
            if not err <= CG_GRAD_TOL * scale:
                raise AssertionError(f"{path}: gradient of {name}: max|cg-dense|={err} > "
                                     f"{CG_GRAD_TOL}*{scale}")
            worst = max(worst, err / max(scale, 1e-30))
        by_path[f"hdnnp4th_mol{n}_cg_train"] = cg["launches"]

        times = {"dense": [], "iterative": []}
        losses = {s: [first[s]["loss"]] for s in times}
        peak = dict.fromkeys(times, 0.0 if device == "cuda" else None)
        step_rounds = []
        for i in range(steps - 1):
            for solver in (("dense", "iterative") if i % 2 == 0 else ("iterative", "dense")):
                step, state = runs[solver]
                if device == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                with cg_rounds() as rounds:
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch)
                    torch.cuda.synchronize()
                    times[solver].append(1e3 * (time.perf_counter() - t0))
                runs[solver][1] = state
                losses[solver].append(float(metrics["loss"]))
                if rounds:
                    step_rounds.append(rounds)
                if device == "cuda":
                    peak[solver] = max(peak[solver], torch.cuda.max_memory_allocated() / 2**20)
        rec = {"path": path, "atoms": n, "first_step": {
                   "loss_dense": dense["loss"], "loss_iterative": cg["loss"],
                   "max_rel_grad_err": worst, "cg_rounds_per_solve": cg["rounds"]},
               "cg_rounds_per_solve": step_rounds, "losses": losses,
               "ms_per_step": {s: float(np.median(t)) for s, t in times.items()},
               "ms_per_step_all": times, "peak_mem_mb": peak, "steps_timed": steps - 1,
               "iterative_launches_per_step": cg["launches"], "cg_solves_per_step":
               cg["solves"], "card": smi}
        log(f"{path} dense against iterative Qeq: " + json.dumps(rec))
    return by_path


def make_mlmm_predictor(device):
    """Phase 8's HDNNP4th serving stack with ``MLMMEnergyForceModel``
    around its ``EnergyForceModel``, serving the QM/MM correction too."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.model.mlmm import MLMMEnergyForceModel
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(
        MLMMEnergyForceModel(energy_force_model("hdnnp4th", device)),
        graph_preprocessors=[functools.partial(set_angle, range_indices="edge_indices")],
        output_translation={k: k for k in ("energy", "force", "charge",
                                           "qmmm_energy_correction")},
        device=device)


def phase_mlmm(request, smi, device="cuda"):
    """Phase 18, ML/MM: one evaluation of ``request`` (phase 8's first,
    with ESP) through ``MLMMEnergyForceModel``, its launches held to
    ``MLMM_LAUNCHES``; its energy is the inner model's plus the correction
    ``sum_i q_i Phi_i`` and its forces the inner ones plus ``-q_i
    dPhi_i/dr_i``; the answers against the CPU. Returns the launch counts."""
    label, graphs = request
    gpu = make_mlmm_predictor(device)
    prepared, batch = gpu.make_batch(graphs)
    reset_counts()
    out = gpu.model(batch)
    torch.cuda.synchronize()
    launches = kernel_counts()
    if launches != MLMM_LAUNCHES:
        raise AssertionError(f"mlmm {label}: launches {launches}, expected {MLMM_LAUNCHES}")
    inner = gpu.model.inner.apply(batch)
    q, esp = out["charge"].detach(), batch.nodes["esp"]
    mask = batch.node_mask.to(q.dtype)
    corr = torch.zeros(batch.n_graphs, device=q.device).index_add_(
        0, batch.graph_id, q * esp * mask)[:, None]
    parts = {"correction": (out["qmmm_energy_correction"], corr),
             "energy": (out["energy"], inner["energy"] + out["qmmm_energy_correction"]),
             "force": (out["force"], inner["force"]
                       - q[:, None] * batch.nodes["esp_grad"] * mask[:, None])}
    errs = {}
    for key, (got, ref) in parts.items():
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        if not err <= SERVE_TOL * scale:
            raise AssertionError(f"mlmm {label}: {key} max|d|={err} > {SERVE_TOL}*{scale}")
        errs[key] = {"max_abs_err": err, "max_abs": scale}
    results = gpu.split(prepared, batch, out)
    check_charged_request(results, graphs, f"mlmm {label}")
    cpu_results = make_mlmm_predictor("cpu")(graphs)
    errs["gpu_vs_cpu"] = compare_answers(results, cpu_results, (
        "energy", "force", "charge", "qmmm_energy_correction"))
    log(f"mlmm serving {label}: " + json.dumps(
        {"errs": errs, "launches": launches, "card": smi}))
    return launches


def phase_molecule_scale(qrequest, smi):
    """Phase 18. Returns the launch counts of its main paths and the kernel
    records."""
    by_path, records = {}, {}
    for n in MOL_SIZES:
        by_path[f"hdnnp4th_mol{n}_serving"], recs = phase_mol_serving(n, smi)
        for name, rs in recs.items():
            records.setdefault(name, []).extend(rs)
    for n in MOL_SIZES:
        path = f"hdnnp4th_mol{n}_train"
        by_path[path], recs = phase_training(path, smi)
        for name, rs in recs.items():
            records.setdefault(name, []).extend(rs)
    by_path.update(phase_qeq_ab(smi))
    by_path["mlmm_serving"] = phase_mlmm(qrequest, smi)
    return by_path, records


# ------------------------------------------- phase 19: the training entry point


# the port's training scripts, each with the TRAIN_PATHS path whose loss is
# its loss (None: a loss of its own, no path)
SCRIPT_PATHS = {"force_schnet": "schnet_train", "force_painn": "painn_train",
                "force_hdnnp2nd": "hdnnp2nd_train", "force_hdnnp4th": "hdnnp4th_train",
                "energy_hdnnp4th": None, "charge_hdnnp4th": None}
# phase 19's cuts to each CONFIG, whose widths stay: 3 epochs (100), 512
# synthetic frames (64) so that a fold of 16-molecule batches takes 10 steps
# an epoch, no PNGs (no matplotlib on the card's machine)
SCRIPT_CUTS = dict(epochs=3, synthetic_frames=512, make_plots=False)


def check_script_artifacts(name, mod, cfg, global_keys, device):
    """Every fold's checkpoint, scaler, errors and test artifacts and the
    score file exist; fold 0's checkpoint, loaded into a model built from
    another seed, predicts its test split's energies as its
    ``energy_predictions.csv`` has them (in the scaled space, to
    ``SERVE_TOL`` of the largest)."""
    from gcnn_keras_tpu_torch.data.scalers import EnergyForceExtensiveLabelScaler
    from gcnn_keras_tpu_torch.training import force_script
    from gcnn_keras_tpu_torch.training.evaluation import _predict_stage
    from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint
    from gcnn_keras_tpu_torch.utils.data_splitter import kfold_swapped_val
    prefix = cfg["model_prefix"]
    score = "results/hdnnp4th_score" if name == "force_hdnnp4th" else f"results/{prefix}_score"
    missing = [] if os.path.exists(score + ".yaml") or os.path.exists(score + ".json") \
        else [score]
    for fold in range(cfg["ensemble_size"]):
        missing += [f for f in (f"step_{cfg['epochs']}/checkpoint.pt", "scaler.json",
                                "errors.json", "geoms.extxyz", "energy_predictions.csv")
                    if not os.path.exists(os.path.join(f"{prefix}_{fold}", f))]
    if missing:
        raise AssertionError(f"{name}: missing artifacts {missing}")
    fresh = mod.build_model(cfg, device=device, generator=torch.Generator().manual_seed(12345))
    fresh.energy_model.load_state_dict(load_checkpoint(f"{prefix}_0", map_location=device)["params"])
    ds = force_script.load_script_dataset(mod, cfg)
    _, _, te = next(kfold_swapped_val(len(ds), k=cfg["ensemble_size"], seed=cfg["seed"]))
    test = ds[te]
    scaler = EnergyForceExtensiveLabelScaler().load(os.path.join(f"{prefix}_0", "scaler.json"))
    scaler.transform_dataset(test)
    pred = _predict_stage(test, fresh, global_keys, 32)["pred_e"]
    raw = np.genfromtxt(os.path.join(f"{prefix}_0", "energy_predictions.csv"), delimiter=",",
                        names=True)["energy_prediction"]
    ref = scaler.transform(raw, [g["node_number"] for g in test])
    err, scale = float(np.abs(pred - ref).max()), float(np.abs(ref).max())
    if pred.shape != ref.shape or not err <= SERVE_TOL * scale:
        raise AssertionError(f"{name}: reloaded checkpoint's energies max|diff|={err} > "
                             f"{SERVE_TOL}*{scale}")
    return err


def check_close(label, got, ref, tol=SERVE_TOL):
    """max|got - ref| <= tol * max|ref|; returns that ratio."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err, scale = float(np.abs(got - ref).max(initial=0.0)), float(np.abs(ref).max(initial=0.0))
    if got.shape != ref.shape or not err <= tol * scale:
        raise AssertionError(f"{label}: max|diff|={err} > {tol}*{scale} (shapes {got.shape}, "
                             f"{ref.shape})")
    return err / max(scale, 1e-30)


def kernel_call_records(calls, label, path):
    """Every captured call against its kernel's plain version."""
    return {k: [dict(check_kernel_call(k, args, f"{label}, call {i + 1} of {len(arg_list)}",
                                       timed=False), path=path)
                for i, args in enumerate(arg_list)]
            for k, arg_list in calls.items() if arg_list}


def capture_first_step(first, step, state, batch, **extra):
    """``step(state, batch)`` recorded into ``first``: its batch on the
    CPU, the weights before, its kernel calls, its loss and gradients, and
    ``extra``."""
    first.update(batch=batch.to("cpu"), weights=[p.detach().cpu().clone() for p in state.params],
                 **extra)
    with captured_calls() as calls:
        state, metrics = step(state, batch)
    first.update(calls=calls, loss=float(metrics["loss"]),
                 grads=[p.grad.detach().cpu().clone() for p in state.params])
    return state, metrics


# the float64 rules of ``check_grads``. A tested gradient may lie up to
# ARBITER_FACTOR times as far from float64 as its reference: two float32
# implementations that are both right differ so, tensor by tensor. On the
# CPU, over the tensors of CMPNN at its default widths whose float32
# gradient in JAX lies past TRAIN_TOL / (ARBITER_FACTOR + 1) from float64,
# the port's lie up to 7.4 times as far as JAX's (16 molecules;
# ``tests/test_torch_zoo_b.py`` holds that spread under this factor)
ARBITER_FACTOR = 8.0
# a float64 gradient below this share of a float32 one (the reference's or
# the tested) is 0 in exact arithmetic (an attention logit's bias, by the
# softmax's shift invariance), the float32 ones rounding alone
NOUGHT = 1e-6


def float64_grads(model, loss_fn, batch):
    """``{name: gradient}`` of ``loss_fn(model, batch)`` with ``model`` (on the
    CPU, changed in place) and the batch's floats in float64."""
    model.double()
    batch = batch._map(lambda v: v.double() if v.is_floating_point() else v)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss_fn(model, batch), params, allow_unused=True)
    return {n: g for n, g in zip(names, grads) if g is not None}


def check_grads(label, grads, ref, tol, exact=None):
    """Each tested gradient ``grads[name]`` within ``tol`` of the largest
    entry of the reference's ``ref[name]`` (None: zeros). A tensor outside
    that passes only where ``exact()`` is given (the float64 gradients of
    the same loss, by name) and one of two rules on its float64 gradient
    ``x`` holds:
    - ``x`` is nought to rounding (its largest entry below ``NOUGHT`` of the
      reference's or the tested one's, of which the other may be exactly
      0): the gradient is 0 in exact arithmetic, and the tested one must
      lie within ``tol`` of the largest reference entry of all the tensors;
    - the reference's float32 gradient itself lies further than
      ``tol / (ARBITER_FACTOR + 1)`` of ``x``'s largest entry from ``x``
      (closer, a tested gradient up to ``ARBITER_FACTOR`` times as far
      meets ``tol`` against it, and the rule would pass nothing more): the
      tested one must lie no further from ``x`` than ``ARBITER_FACTOR``
      times the reference's.
    Returns the largest ratio to ``tol``'s scale, and each tensor passed by
    a rule on float64 with the tested and the reference's distances from
    ``x`` and ``x``'s largest entry."""
    worst, arbitrated, x = 0.0, {}, None
    top = max((r.detach().abs().max().item() for r in ref.values() if r is not None),
              default=0.0)
    for name, g in grads.items():
        r = ref.get(name)
        g = g.detach().double().cpu()
        r = torch.zeros_like(g) if r is None else r.detach().double().cpu()
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        if err <= tol * scale:
            worst = max(worst, err / scale if scale else 0.0)
            continue
        fail = f"{label}: gradient of {name}: max|diff|={err} > {tol}*{scale}"
        if exact is None:
            raise AssertionError(fail)
        if x is None:
            x = {n: v.detach().double().cpu() for n, v in exact().items()}
        xn = x.get(name, torch.zeros_like(g))
        x_scale = xn.abs().max().item()
        tested, own = (g - xn).abs().max().item(), (r - xn).abs().max().item()
        g_scale = g.abs().max().item()
        if x_scale <= NOUGHT * max(scale, g_scale):
            if not g_scale <= tol * top:
                raise AssertionError(f"{fail}; 0 in float64 ({x_scale}), and "
                                     f"{g_scale} > {tol}*{top}")
        elif not own > tol / (ARBITER_FACTOR + 1) * x_scale:
            raise AssertionError(f"{fail}; the reference lies {own} from float64 "
                                 f"(scale {x_scale}): float32 resolves it")
        elif not tested <= ARBITER_FACTOR * own:
            raise AssertionError(f"{fail}; {tested} from float64 against the "
                                 f"reference's {own}")
        arbitrated[name] = {"tested": tested, "reference": own, "scale": x_scale}
    return worst, arbitrated


def check_first_step_on_cpu(label, first, named_params, loss_fn, grad_tol, exact=None):
    """The recorded first step against the same step on the CPU:
    ``named_params`` (the CPU model's trained tensors, with their names)
    take the recorded weights, then the loss within ``TRAIN_TOL`` of the
    CPU's and each gradient within ``grad_tol`` of that tensor's largest
    entry on the CPU, or, with ``exact(batch)`` (the float64 gradients by
    name), by ``check_grads``' float64 rules."""
    names, params = zip(*named_params)
    with torch.no_grad():
        for p, w in zip(params, first["weights"]):
            p.copy_(w)
    loss, _ = loss_fn(first["batch"])
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    if not abs(first["loss"] - loss.item()) <= TRAIN_TOL * abs(loss.item()):
        raise AssertionError(f"{label}: first loss {first['loss']}, {loss.item()} on the CPU")
    worst, arbitrated = check_grads(
        label, dict(zip(names, first["grads"])), dict(zip(names, grads)), grad_tol,
        exact and (lambda: exact(first["batch"])))
    return {"loss_gpu": first["loss"], "loss_cpu": loss.item(), "params": len(params),
            "max_rel_grad_err": worst, **({"float64_arbiter": arbitrated} if arbitrated else {})}


def check_first_script_step(name, mod, cfg, first, grad_tol):
    """The engine's first step on the card against the same step on the
    CPU: the same weights and batch, the engine's loss
    (``check_first_step_on_cpu``)."""
    from gcnn_keras_tpu_torch.training import force_script
    fm = mod.build_model(cfg, device="cpu")
    return check_first_step_on_cpu(
        name, first, [(n, p) for n, p in fm.energy_model.named_parameters() if p.requires_grad],
        force_script.force_loss_fn(fm, force_script.normalized_loss_weights(cfg)), grad_tol)


def phase_script(name, smi, device="cuda", cuts=SCRIPT_CUTS, after=None):
    """Phase 19 for one script: the main path, its training run with every
    count set to 0 just before and read just after, instrumented through
    ``force_script.fit_model`` (each step timed after a sync, the first run
    inside ``captured_calls``, the validation pass timed) and
    ``loader.host_batch`` (the producer's host time); then the checks of
    the first step, its kernel calls, the launches, losses and artifacts;
    then ``after(cfg)``, if given, in the run's working directory before it
    is removed. Returns the run's launch counts and the kernel records."""
    from gcnn_keras_tpu_torch.data import loader as loader_mod
    from gcnn_keras_tpu_torch.training import force_script
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")
    cfg = {**mod.CONFIG, **cuts, "device": device}
    merged = cfg if name == "force_hdnnp4th" else {**force_script.DEFAULTS, **cfg}
    global_keys = ("energy", "total_charge") \
        if name == "force_hdnnp4th" or merged["need_esp"] else ("energy",)
    path = SCRIPT_PATHS.get(name)
    expected = TRAIN_PATHS[path]["launches"] if path else None
    first, steps, host_ms, val_ms, wait_ms, hists = {}, [], [], {}, [], []
    fit, host_batch = force_script.fit_model, loader_mod.host_batch

    def instrumented_fit(trainer, state, batches, eval_fn, epochs, **kw):
        step, fold, epoch = trainer.step, len(hists), [0]

        def timed_step(st, batch):
            if not first:
                return capture_first_step(first, step, st, batch)
            before = kernel_counts()
            t0 = time.perf_counter()
            st, metrics = step(st, batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()  # the wait fit_epoch's float(v) then skips
            t2 = time.perf_counter()
            steps.append((fold, epoch[0], 1e3 * (t2 - t0), 1e3 * (t2 - t1),
                          {k: v - before[k] for k, v in kernel_counts().items()}))
            return st, metrics

        def timed_eval(params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eval_fn(params)
            torch.cuda.synchronize()
            val_ms[fold, epoch[0]] = 1e3 * (time.perf_counter() - t0)
            epoch[0] += 1
            return out

        class TimedBatches:
            """The loader, each batch's wait on the caller's thread timed
            (the queue, then the copies to the device)."""
            def __iter__(self):
                it = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    if batch is None:
                        return
                    wait_ms.append((fold, epoch[0], 1e3 * (time.perf_counter() - t0)))
                    yield batch

        trainer.step = timed_step
        state, hist = fit(trainer, state, TimedBatches(), timed_eval, epochs, **kw)
        hists.append(hist)
        return state, hist

    def timed_host_batch(graphs, pin, **kw):
        t0 = time.perf_counter()
        out = host_batch(graphs, pin, **kw)
        host_ms.append((len(graphs), 1e3 * (time.perf_counter() - t0)))
        return out

    with tempfile.TemporaryDirectory(prefix="_phase19_", dir=os.getcwd()) as workdir, \
            contextlib.chdir(workdir):
        force_script.fit_model, loader_mod.host_batch = instrumented_fit, timed_host_batch
        try:
            # the main path: every count set to 0 just before, read just after
            reset_counts()
            t0 = time.perf_counter()
            score = mod.train(cfg) if hasattr(mod, "train") \
                else force_script.run_force_training(mod.build_model, cfg)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            main_launches = kernel_counts()
        finally:
            force_script.fit_model, loader_mod.host_batch = fit, host_batch
        reload_err = check_script_artifacts(name, mod, cfg, global_keys, device)
        if after is not None:
            after(cfg)

    label = f"{name}_script"
    grad_tol = TRAIN_PATHS[path].get("grad_tol", TRAIN_TOL) if path else TRAIN_TOL
    first_rec = check_first_script_step(name, mod, cfg, first, grad_tol)
    counts = {k: len(c) for k, c in first["calls"].items() if c}
    if expected is not None:
        bad = [i for i, (_, _, _, _, c) in enumerate(steps) if c != expected]
        if counts != {k: v for k, v in expected.items() if v} or bad:
            raise AssertionError(f"{name}: first step's kernel calls {counts}, steps {bad[:5]} "
                                 f"off; expected {expected} a step ({path})")
    recs = kernel_call_records(first["calls"], f"{label}, first step", label)
    losses = [h["loss"] for h in hists]
    falls = path is not None and TRAIN_PATHS[path].get("falls", True)
    if not all(np.isfinite(ls).all() for ls in losses) or \
            (falls and not all(ls[-1] < ls[0] for ls in losses)):
        raise AssertionError(f"{name}: fold losses {losses}")
    # after each fold's first epoch: its steps, validation passes, the
    # loader's waits, and the rest of each epoch (the loop's host work)
    batch_size = cfg["batch_size"]
    late = [(f, e) for f, h in enumerate(hists) for e in range(1, len(h["epoch_time"]))]
    step_ms = {fe: [ms for f, e, ms, _, _ in steps if (f, e) == fe] for fe in late}
    epoch_ms = {(f, e): 1e3 * hists[f]["epoch_time"][e] for f, e in late}
    waits = {fe: [ms for f, e, ms in wait_ms if (f, e) == fe] for fe in late}
    other_ms = [epoch_ms[fe] - sum(step_ms[fe]) - val_ms[fe] - sum(waits[fe]) for fe in late]
    rec = {"script": name, "path": path, "card": smi, "folds": len(hists), "epochs": cfg["epochs"],
           "steps_per_epoch": len(step_ms[late[0]]), "batch_size": batch_size,
           "ms_per_step": float(np.median([ms for fe in late for ms in step_ms[fe]])),
           # the device's tail after the host has queued a step: what the
           # host waits for in fit_epoch's float(v) of each metric
           "ms_sync_per_step": float(np.median([w for f, e, _, w, _ in steps if e >= 1])),
           "loader_host_ms_per_batch": float(np.median(
               [ms for n, ms in host_ms if n == batch_size])),
           "loader_wait_ms_per_epoch": float(np.median([sum(w) for w in waits.values()])),
           "ms_per_epoch": float(np.median(list(epoch_ms.values()))),
           "ms_validation": float(np.median([val_ms[fe] for fe in late])),
           "ms_epoch_other": float(np.median(other_ms)),
           "s_run": run_s, "cpu_s_per_fold": score.get("execute_time"),
           "losses": losses, "first_step": first_rec, "reload_max_err": reload_err,
           "launches_per_step": expected, "launches_run": main_launches}
    log(f"{name} script: " + json.dumps(rec))
    return main_launches, recs


# ------------------------------------------- phase 20: the fork's workflow


def script_eval_launches(name, cfg):
    """Kernel launches of one evaluation of script ``name``'s model at the
    widths of ``cfg``."""
    if name == "force_schnet":
        return schnet_launches("unfused", cfg["schnet"]["depth"])
    if name == "force_painn":
        return painn_launches(cfg["painn"]["depth"])
    return HDNNP_LAUNCHES if name == "force_hdnnp2nd" else HDNNP4TH_LAUNCHES


# transfer_learning's --trainable: the defaults ("mlp_local", "output")
# select SchNet's and PAiNN's output_mlp and HDNNP4th's mlp_local; they
# freeze all of HDNNP2nd, whose last layer is its head here
TRANSFER_TRAINABLE = {"force_hdnnp2nd": ["dense_2"]}
TRANSFER_EPOCHS = 2
EVAL_BATCH = 32  # evaluate_model's batches of graphs
# the five searches, each with its objective and the TRAIN_PATHS path of
# its model (for the gradient tolerance)
SEARCHES = {"force_schnet_hyp_param_search": ("val_force_mae", "schnet_train"),
            "force_painn_hyp_param_search": ("val_force_mae", "painn_train"),
            "force_hdnnp2nd_hyp_param_search": ("val_force_mae", "hdnnp2nd_train"),
            "force_hdnnp4th_hyp_param_search": ("val_force_mae", "hdnnp4th_train"),
            "charge_hyp_param_search": ("val_charge_mae", "hdnnp4th_train")}
# phase 20's cuts to each search: 3 trials (9), 1 epoch at rung 0 (5), 3 at
# most (30), so rung 0 trains 3 trials 1 epoch and rung 1 the best 3 epochs
SEARCH_ARGS = ["--trials", "3", "--min-epochs", "1", "--max-epochs", "3"]


def synced_ms(fn, reps=1):
    """Median wall ms of ``fn`` over ``reps`` runs, each ended by a sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


class RecordingTrainer:
    """A ``Trainer`` class that records its first step over all instances
    (its batch on the CPU, the weights before, the loss, the gradients and
    every kernel call) and, after it, each step's ms (sync included), its
    launches and the instance (trial) it ran in."""

    def __init__(self, base):
        rec = self
        self.first, self.steps, self.instances = {}, [], 0

        class Trainer(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                rec.instances += 1
                self.index = rec.instances - 1

            def step(self, state, batch):
                if not rec.first:
                    return capture_first_step(rec.first, super().step, state, batch,
                                              instance=self.index)
                before = kernel_counts()
                t0 = time.perf_counter()
                state, metrics = super().step(state, batch)
                torch.cuda.synchronize()
                rec.steps.append((self.index, 1e3 * (time.perf_counter() - t0),
                                  {k: v - before[k] for k, v in kernel_counts().items()}))
                return state, metrics
        self.cls = Trainer

    def check_steps(self, label):
        """Every step's launches equal those of the first step of its
        instance (the first step of instance 0 counted from its calls)."""
        first = {self.first["instance"]: {k: len(c) for k, c in self.first["calls"].items()}}
        for index, _, counts in self.steps:
            ref = first.setdefault(index, counts)
            if {k: v for k, v in counts.items() if v} != {k: v for k, v in ref.items() if v}:
                raise AssertionError(f"{label}: step launches {counts}, first {ref}")
        return {k: v for k, v in first[self.first["instance"]].items() if v}


@contextlib.contextmanager
def patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def phase_workflow(name, cfg, smi, device="cuda"):
    """Phase 20 for one script, in the working directory that holds the
    ensemble phase 19 trained from ``cfg`` (``<model_prefix>_<fold>``):

    - ``evaluate_models`` on ``device`` (the main path, counts set to 0
      just before and read just after): its launches are ``members x (1 +
      ceil(frames / 32))`` evaluations of ``script_eval_launches``; each
      member's artifacts exist; each member's outputs on the whole dataset
      and the report's MAEs against the same checkpoints on the CPU (to
      ``SERVE_TOL`` of the largest output); every kernel call of member
      0's evaluation against its plain version; the ms of a member's
      evaluation and of the ensemble's predictions;
    - ``calc_prediction_std`` on ``device`` against the CPU: each frame's
      largest force std and energy std to ``SERVE_TOL`` of the largest, the
      same frames flagged at the CPU's median (frames within that
      tolerance of it left out);
    - ``load_model``'s energies of 16 frames against the CPU;
    - ``transfer_learning`` from fold 0's checkpoint, ``TRANSFER_EPOCHS``
      epochs: the frozen parameters bit for bit, each trainable one moved,
      finite losses, the first step's loss and gradients against the CPU
      and its kernel calls against their plain versions, every step's
      launches equal to the first's; ms per epoch and per step.

    Returns the launches of the evaluation and of the transfer by path, and
    the kernel records."""
    from gcnn_keras_tpu_torch.scripts import calc_prediction_std as cps
    from gcnn_keras_tpu_torch.scripts import evaluate_models as em
    from gcnn_keras_tpu_torch.scripts import load_model as lm
    from gcnn_keras_tpu_torch.scripts import transfer_learning as tl
    from gcnn_keras_tpu_torch.training import force_script
    from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")
    prefix = cfg["model_prefix"]
    conf = "workflow_conf.json"
    with open(conf, "w") as f:
        json.dump({k: v for k, v in cfg.items() if k != "device"}, f)
    mcfg = force_script.load_config(mod, conf=conf)
    ds = force_script.load_script_dataset(mod, mcfg)
    n_members, n_frames = mcfg["ensemble_size"], len(ds)
    ensemble = ["--prefix", prefix, "--script", name, "--conf", conf]
    per_eval = script_eval_launches(name, mcfg)
    rec = {"script": name, "card": smi, "frames": n_frames, "members": n_members}

    # evaluate_models: the main path
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report = em.main(ensemble + ["--output-dir", "eval", "--device", device])
    torch.cuda.synchronize()
    rec["s_evaluate_models"] = time.perf_counter() - t0
    eval_launches = kernel_counts()
    evals = n_members * (1 + -(-n_frames // EVAL_BATCH))
    if eval_launches != {k: evals * v for k, v in per_eval.items()}:
        raise AssertionError(f"{name}: evaluate_models launches {eval_launches}, expected "
                             f"{evals} x {per_eval}")
    labels = ["energy", "force"] + (["charge"] if "hdnnp4th" in name else [])
    missing = [f for i in range(n_members) for f in
               [f"errors_{i}.json", f"geoms_{i}.extxyz"]
               + [f"{k}_predictions_{i}.csv" for k in labels]
               if not os.path.exists(os.path.join("eval", f))]
    if missing:
        raise AssertionError(f"{name}: evaluate_models artifacts missing: {missing}")

    members = {dev: em.load_ensemble(prefix, mod.build_model, mcfg, dev)
               for dev in (device, "cpu")}
    batches = {dev: ds.to_batch(global_keys=("energy", "total_charge"), device=dev)
               for dev in (device, "cpu")}
    preds = {"cpu": em.predict_ensemble(members["cpu"], batches["cpu"], graphs=list(ds))}
    rec["ms_ensemble_predict"] = synced_ms(lambda: preds.update(
        gpu=em.predict_ensemble(members[device], batches[device], graphs=list(ds))))
    rec["max_rel_err_member"] = max(
        check_close(f"{name}: member {m} {k}", preds["gpu"][k][m], preds["cpu"][k][m])
        for k in labels for m in range(n_members))
    report_cpu = em.ensemble_report(preds["cpu"], batches["cpu"])
    for k in ("energy_mae_per_model", "energy_mae_ensemble", "force_mae_per_model",
              "force_mae_ensemble"):
        # an MAE moves by at most the largest change of a prediction
        err = float(np.abs(np.subtract(report[k], report_cpu[k])).max())
        scale = float(np.abs(preds["cpu"][k.split("_")[0]]).max())
        if not err <= SERVE_TOL * scale:
            raise AssertionError(f"{name}: report {k}: max|diff|={err} > {SERVE_TOL}*{scale}")
    fm0, batch = members[device][0][0], batches[device]
    with captured_calls() as calls:
        fm0.apply(batch)
    counts = {k: len(c) for k, c in calls.items() if c}
    if counts != {k: v for k, v in per_eval.items() if v}:
        raise AssertionError(f"{name}: member 0's evaluation calls {counts}, expected {per_eval}")
    recs = kernel_call_records(calls, f"{name} evaluate_models, member 0", f"{name}_evaluate")
    fm0.apply(batch)
    rec["ms_member_eval"] = synced_ms(lambda: fm0.apply(batch), reps=3)
    rec["launches_per_eval"] = {k: v for k, v in per_eval.items() if v}
    rec["evaluations"] = evals
    rec["report"] = report

    # calc_prediction_std at the CPU's median
    std_cpu = cps.prediction_std(preds["cpu"], batches["cpu"], n_frames)
    per_frame = np.asarray(std_cpu["force_std_max_per_frame"])
    threshold = float(np.median(per_frame))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        std_gpu = cps.main(ensemble + ["--threshold", repr(threshold), "--device", device])
    rec["s_calc_prediction_std"] = time.perf_counter() - t0
    rec["max_rel_err_std"] = max(check_close(f"{name}: {k}", std_gpu[k], std_cpu[k])
                                 for k in ("force_std_max_per_frame", "energy_std_per_frame"))
    near = set(np.flatnonzero(np.abs(per_frame - threshold) <= SERVE_TOL * per_frame.max()))
    flagged = set(np.flatnonzero(per_frame > threshold))
    if set(std_gpu["flagged_frames"]) - near != flagged - near:
        raise AssertionError(f"{name}: flagged frames differ from the CPU's")
    rec["flagged"] = len(std_gpu["flagged_frames"])

    # load_model
    loaded = {dev: lm.load_and_predict(f"{prefix}_0", name, n_frames=16, device=dev, conf=conf)
              for dev in (device, "cpu")}
    rec["max_rel_err_load_model"] = check_close(f"{name}: load_model energies",
                                                loaded[device]["energies"],
                                                loaded["cpu"]["energies"])

    # transfer_learning
    trainable = TRANSFER_TRAINABLE.get(name, ["mlp_local", "output"])
    recorder = RecordingTrainer(tl.Trainer)
    reset_counts()
    with patched(tl, "Trainer", recorder.cls), contextlib.redirect_stdout(io.StringIO()):
        res = tl.transfer(f"{prefix}_0", name, epochs=TRANSFER_EPOCHS, trainable=trainable,
                          out="transfer", device=device, conf=conf)
    torch.cuda.synchronize()
    transfer_launches = kernel_counts()
    step_counts = recorder.check_steps(f"{name} transfer_learning")
    before = load_checkpoint(f"{prefix}_0", map_location="cpu")["params"]
    after = load_checkpoint("transfer", map_location="cpu")["params"]
    moved = [n for n, lab in res["labels"].items() if not torch.equal(before[n], after[n])]
    trained = [n for n, lab in res["labels"].items() if lab == "trainable"]
    if not trained or sorted(moved) != sorted(trained):
        raise AssertionError(f"{name}: transfer moved {moved}, trainable {trained}")
    if not np.isfinite(res["epoch_losses"]).all():
        raise AssertionError(f"{name}: transfer losses {res['epoch_losses']}")
    fm = mod.build_model(mcfg, device="cpu")
    fm.energy_model.load_state_dict(before)
    params = [(n, p) for n, p in fm.energy_model.named_parameters() if n in trained]
    path = SCRIPT_PATHS[name] or "hdnnp4th_train"
    rec["transfer"] = {
        "trainable": trainable, "params": len(trained), "epochs": TRANSFER_EPOCHS,
        "steps_per_epoch": (len(recorder.steps) + 1) // TRANSFER_EPOCHS,
        "ms_per_epoch": float(np.median(1e3 * np.asarray(res["epoch_s"]))),
        "ms_per_step": float(np.median([ms for _, ms, _ in recorder.steps])),
        "losses": res["epoch_losses"], "launches_per_step": step_counts,
        "first_step": check_first_step_on_cpu(f"{name} transfer_learning", recorder.first,
                                              params,
                                              force_script.force_loss_fn(fm, tl.LOSS_WEIGHTS),
                                              TRAIN_PATHS[path].get("grad_tol", TRAIN_TOL))}
    for k, rs in kernel_call_records(recorder.first["calls"], f"{name} transfer_learning, "
                                     "first step", f"{name}_transfer").items():
        recs.setdefault(k, []).extend(rs)
    log(f"{name} workflow: " + json.dumps(rec))
    return {f"{name}_evaluate": eval_launches, f"{name}_transfer": transfer_launches}, recs


def phase_searches(smi, device="cuda", frames=SCRIPT_CUTS["synthetic_frames"],
                   searches=tuple(SEARCHES)):
    """Phase 20's searches: each of ``searches`` with ``SEARCH_ARGS`` on
    ``frames`` synthetic frames (the main path, counts set to 0 just
    before and read just after); the trial files against the same
    ``HyperbandSearch`` on the CPU replaying the same metrics (the same
    sampled configurations, rungs and best trial), every objective finite,
    ``best_trial.json`` read back by ``retrieve_trial``; the first step of
    trial 0 against the CPU and its kernel calls against their plain
    versions, every step's launches equal to its trial's first step's;
    ms per trial epoch, per step and per search. Returns the launches by
    path and the kernel records."""
    from gcnn_keras_tpu_torch.scripts import retrieve_trial
    from gcnn_keras_tpu_torch.training import force_script, force_search, hyper_search
    by_path, recs = {}, {}
    with tempfile.TemporaryDirectory(prefix="_phase20_", dir=os.getcwd()) as workdir, \
            contextlib.chdir(workdir):
        with open("search_conf.json", "w") as f:
            json.dump({"synthetic_frames": frames}, f)
        for search in searches:
            objective, path = SEARCHES[search]
            mod = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{search}")
            cfg0 = dict(mod.CONFIG, synthetic_frames=frames)
            records = []
            save = hyper_search.HyperbandSearch._save_trial
            recorder = RecordingTrainer(force_search.Trainer)
            reset_counts()
            t0 = time.perf_counter()
            with patched(hyper_search.HyperbandSearch, "_save_trial",
                         lambda self, t: records.append(dict(t)) or save(self, t)), \
                    patched(force_search, "Trainer", recorder.cls), \
                    contextlib.redirect_stdout(io.StringIO()):
                best = mod.main(SEARCH_ARGS + ["--directory", search, "--conf",
                                               "search_conf.json", "--device", device])
            torch.cuda.synchronize()
            s_search = time.perf_counter() - t0
            by_path[f"{search}_search"] = kernel_counts()
            step_counts = recorder.check_steps(search)
            if [r["epochs"] for r in records] != [1, 1, 1, 3] or not all(
                    np.isfinite(r["score"]) for r in records):
                raise AssertionError(f"{search}: trials {records}")
            tids = {json.dumps(r["hparams"], sort_keys=True): r["trial_id"] for r in records}
            metrics = {(r["trial_id"], r["epochs"]): r["metrics"] for r in records}
            ref_dir = os.path.join("replay", search)
            hyper_search.HyperbandSearch(
                hyper_search.SearchSpace(mod.SPACE), objective=objective, num_trials=3,
                min_epochs=1, max_epochs=3, eta=3, directory=ref_dir).run(
                lambda hp, epochs: metrics[tids[json.dumps(hp, sort_keys=True)], epochs])

            def trial_files(d):
                out = {}
                for fname in sorted(os.listdir(d)):
                    with open(os.path.join(d, fname)) as f:
                        out[fname] = {k: v for k, v in json.load(f).items() if k != "time_s"}
                return out
            if trial_files(search) != trial_files(ref_dir):
                raise AssertionError(f"{search}: trial files differ from the CPU replay's")
            with contextlib.redirect_stdout(io.StringIO()):
                back = retrieve_trial.main(["--directory", search])
            if back != json.loads(json.dumps(best, default=str)):
                raise AssertionError(f"{search}: retrieve_trial gave {back}, best {best}")
            hp0 = records[0]["hparams"]
            fm = mod.build_model(hp0, cfg0, device="cpu")
            weights = getattr(mod, "loss_weights", force_search.search_loss_weights)(cfg0, hp0)
            first = check_first_step_on_cpu(
                search, recorder.first, list(fm.energy_model.named_parameters()),
                force_script.force_loss_fn(fm, weights),
                TRAIN_PATHS[path].get("grad_tol", TRAIN_TOL))
            for k, rs in kernel_call_records(recorder.first["calls"], f"{search}, trial 0, "
                                             "first step", f"{search}_search").items():
                recs.setdefault(k, []).extend(rs)
            log(f"{search} search: " + json.dumps({
                "search": search, "card": smi, "frames": frames, "s_search": s_search,
                "ms_per_trial_epoch": float(np.median(
                    [1e3 * r["time_s"] / r["epochs"] for r in records])),
                "ms_per_step": float(np.median([ms for _, ms, _ in recorder.steps])),
                "steps": len(recorder.steps) + 1,
                "trials": [(r["trial_id"], r["epochs"], r["score"], r["hparams"])
                           for r in records],
                "launches_per_step_trial_0": step_counts, "first_step": first,
                "launches_run": by_path[f"{search}_search"]}))
    return by_path, recs


# ------------------------------------------ phase 21: every option of the potentials

# SchNet's options at the serving width, each on phase 4's weights (seed 0)
SCHNET_OPTIONS = {"bf16": {"dtype": "bfloat16"}, "dense": {"dense_block": True},
                  "remat": {"remat": True}}
SCHNET_OPTION_LAUNCHES = {"bf16": schnet_launches("unfused", dtype="bfloat16"),
                          "dense": launch_counts(),  # the dense block runs no kernel
                          "remat": schnet_launches("unfused", remat=True)}
# apply_multistate's states: SchNet's output MLP [64, 3]; launches per
# evaluation: the energy pass's (4 edge pools and the graph pool), then one
# force pass per state (edge_vectors' two transposes and those of
# interactions 1-3's sender gathers)
MULTISTATE_STATES = 3
MULTISTATE_LAUNCHES = launch_counts(sorted_segment_sum=5 + MULTISTATE_STATES * 5)
# PAiNN MD at PAINN_KW: its neighbour lists to its 5 A cutoff; the NVE bound
# of tests/test_scanned_md.py::test_scanned_md_painn, |E_tot(t) - E_tot(0)|
# under 1e-3 (the molecule starts at rest, so NVE_BOUNDS' drift relative to
# the mean kinetic energy is not the measure here; it is printed)
PAINN_CUTOFF = PAINN_KW["conv_args"]["cutoff"]
PAINN_MAX_DRIFT = 1e-3


def option_tol(option):
    return BF16_TOL if option == "bf16" else SERVE_TOL


def make_option_predictor(option, device):
    """The serving stack at full SchNet width with ``option``'s settings
    (``SCHNET_OPTIONS``) and the weights of seed 0."""
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(EnergyForceModel(
        schnet_model("unfused", device, **SCHNET_OPTIONS[option]), device=device), device=device)


def make_wacsf_predictor(device):
    """HDNNP2nd's default (wACSF) model, ``make_model()``, behind the
    predictor with ``set_angle``, weights from seed 0."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    return MolDynamicsModelPredictor(
        energy_force_model("hdnnp2nd_weighted", device),
        graph_preprocessors=[functools.partial(set_angle, range_indices="edge_indices")],
        device=device)


def evaluation_calls(model, batch, label, path, timed=()):
    """Every kernel call of one evaluation of ``model`` on ``batch`` against
    its plain version; the calls whose (kernel, column count) is in
    ``timed`` are timed, each the first time. Returns ``({name: calls},
    {name: [record, ...]})``."""
    with captured_calls() as calls:
        model(batch)
        torch.cuda.synchronize()
    recs, seen = {}, set()
    for name, arg_list in calls.items():
        for i, args in enumerate(arg_list):
            key = (name, args[0].shape[1] if args[0].dim() == 2 else None)
            rec = check_kernel_call(name, args, f"{label}, call {i + 1} of {len(arg_list)}",
                                    timed=key in timed and key not in seen)
            seen.add(key)
            recs.setdefault(name, []).append(dict(rec, path=path))
    return {k: len(v) for k, v in calls.items() if v}, recs


def phase_wacsf_serving(requests, smi, profiles):
    """Phase 21 (a): HDNNP2nd's default model answers the 3 requests as
    phase 6 serves them; every segment-sum call of one evaluation of the
    first against its plain version, the (E, 22) radial and (A, 10)
    angular sums timed."""
    gpu = make_wacsf_predictor("cuda")
    _, batch = gpu.make_batch(requests[0][1])
    shapes = (batch.n_node, batch.n_edge, batch.angles.shape[0], batch.n_graphs)
    if shapes != HDNNP_SHAPES:
        raise AssertionError(f"unexpected wACSF full-width shapes {shapes}")
    counts, recs = evaluation_calls(gpu.model, batch, "hdnnp2nd_wacsf_serving",
                                    "hdnnp2nd_wacsf_serving",
                                    timed={("sorted_segment_sum", 22), ("sorted_segment_sum", 10)})
    if counts != {k: v for k, v in WACSF_LAUNCHES.items() if v}:
        raise AssertionError(f"wACSF: kernel calls {counts}, expected {WACSF_LAUNCHES}")
    launches = phase_model_serving(gpu, requests, batch, smi, name="hdnnp2nd wacsf",
                                   make_cpu=make_wacsf_predictor, expected=WACSF_LAUNCHES,
                                   profiles=profiles)
    return launches, recs


def pool_input(model, batch):
    """SchNet's graph-pool input on ``batch``'s real atoms (``last_mlp``'s
    output), float32 on the CPU."""
    seen = []
    hook = model.last_mlp.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    try:
        with torch.no_grad():
            model(batch)
    finally:
        hook.remove()
    return seen[0][batch.node_mask].float().cpu()


def compare_bf16_atoms(batch0):
    """The bfloat16 SchNet's graph-pool input on ``batch0`` on the card
    against the CPU's and the float32 model's on the card, each within
    ``BF16_TOL["atom"]``: per atom, before the molecules' energies cancel."""
    kw = SCHNET_OPTIONS["bf16"]
    got = pool_input(schnet_model("unfused", "cuda", **kw), batch0)
    refs = {"gpu_vs_cpu": pool_input(schnet_model("unfused", "cpu", **kw), batch0.to("cpu")),
            "against_float32": pool_input(schnet_model("unfused", "cuda"), batch0)}
    return {label: check_close(f"schnet bf16 graph-pool input, {label}", got, ref,
                               BF16_TOL["atom"]) for label, ref in refs.items()}


def phase_schnet_options(requests, batch0, smi, unfused_answers, profiles):
    """Phase 21 (b): SchNet at the serving width in bfloat16, in the dense
    block and under remat answers the 3 requests of phase 4, against the
    same predictor on the CPU and phase 4's float32 unfused answers
    (bfloat16 within BF16_TOL per output, the others SERVE_TOL), launches
    held to ``SCHNET_OPTION_LAUNCHES``; the bfloat16 model's graph-pool
    input against the CPU's and float32's (``compare_bf16_atoms``); every
    kernel call of one bfloat16 evaluation against its plain version, the
    (E, 128) bfloat16 sum timed."""
    by_path, records = {}, {}
    for option in SCHNET_OPTIONS:
        gpu = make_option_predictor(option, "cuda")
        path = f"schnet_{option}_serving"
        if option == "bf16":
            counts, recs = evaluation_calls(gpu.model, batch0, path, path,
                                            timed={("sorted_segment_sum_bf16", 128)})
            if counts != {k: v for k, v in SCHNET_OPTION_LAUNCHES[option].items() if v}:
                raise AssertionError(f"schnet bf16: kernel calls {counts}")
            records = recs
            log("schnet bf16 graph-pool input (max rel err): "
                + json.dumps(compare_bf16_atoms(batch0)))
        by_path[path] = phase_model_serving(
            gpu, requests, batch0, smi, name=f"schnet {option}",
            make_cpu=functools.partial(make_option_predictor, option),
            expected=SCHNET_OPTION_LAUNCHES[option], reference=unfused_answers,
            tol=option_tol(option), profiles=profiles)
    return by_path, records


def phase_multistate(batch0, smi, device="cuda"):
    """Phase 21 (c): one ``apply_multistate`` evaluation of SchNet at the
    serving width with ``MULTISTATE_STATES`` energy states on the first
    request's batch: its launches, the (S, N, 3) forces and (G, S) energies
    against the CPU, the states' forces summed against ``apply`` of the
    states' summed energy, the time."""
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    kw = dict(output_mlp={"units": [64, MULTISTATE_STATES]})
    fm = EnergyForceModel(schnet_model("unfused", device, **kw), device=device)
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    out = fm.apply_multistate(batch0, MULTISTATE_STATES)
    torch.cuda.synchronize()
    launches = kernel_counts()
    if launches != MULTISTATE_LAUNCHES:
        raise AssertionError(f"multistate: launches {launches}, expected {MULTISTATE_LAUNCHES}")
    n, g = batch0.n_node, batch0.n_graphs
    if out["force"].shape != (MULTISTATE_STATES, n, 3) or out["energy"].shape != (
            g, MULTISTATE_STATES) or not torch.isfinite(out["force"]).all():
        raise AssertionError(f"multistate: shapes {tuple(out['force'].shape)}, "
                             f"{tuple(out['energy'].shape)}, or not finite")
    cpu = EnergyForceModel(schnet_model("unfused", "cpu", **kw), device="cpu")
    ref = cpu.apply_multistate(batch0.to("cpu"), MULTISTATE_STATES)
    rec = {"states": MULTISTATE_STATES, "N_pad": n, "G": g, "card": smi,
           "energy_rel_err": check_close("multistate energy", out["energy"].detach().cpu(),
                                         ref["energy"].detach()),
           "force_rel_err": check_close("multistate force", out["force"].cpu(), ref["force"])}
    # the states' forces sum to the forces of the summed energy
    summed = EnergyForceModel(SummedStates(fm.energy_model), device=device).apply(batch0)
    rec["summed_force_rel_err"] = check_close("multistate forces summed over the states",
                                              out["force"].sum(0).cpu(), summed["force"].cpu())
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fm.apply_multistate(batch0, MULTISTATE_STATES)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    rec.update(ms_per_eval=float(np.median(times)), launches_per_eval=MULTISTATE_LAUNCHES)
    log("multistate: " + json.dumps(rec))
    return launches


class SummedStates(torch.nn.Module):
    """An energy model's output summed over its states, as one state."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return {"output": self.model(batch)["output"].sum(-1, keepdim=True)}


def painn_md_model(device):
    from gcnn_keras_tpu_torch.models import painn
    return painn.make_model(device=device, generator=torch.Generator().manual_seed(0),
                            **PAINN_KW)


def phase_painn_md(smi, device="cuda", steps=MD_STEPS, pairs=MD_PAIRS,
                   replicas=ENSEMBLE_REPLICAS, segment_steps=ENSEMBLE_SEGMENT_STEPS,
                   segments=ENSEMBLE_SEGMENTS):
    """Phase 21 (d): PAiNN MD at ``PAINN_KW``. (1) Phase 14's 21-atom
    molecule, its neighbours to the 5 A cutoff: each kernel call of one
    evaluation against its plain version; velocity Verlet from rest (masses
    12, dt 5e-4), the short trajectory's energies against the CPU's
    (MD_TOL), launches per step, the time per step (the smallest slope
    between the two lengths over interleaved pairs) and the long
    trajectory's NVE drift, its largest under ``PAINN_MAX_DRIFT``. (2) ``replicas`` of the
    molecule through ``ScannedMD``: one segment to warm up, then
    ``segments`` timed, launches per step, the first timed segment's
    energies against the same segment on the CPU. Returns the launch counts
    of the two main paths and the kernel records."""
    from gcnn_keras_tpu_torch.moldyn.integrate import (
        make_energy_force_fn, nve_drift, velocity_verlet)
    from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
    short, long = steps
    model = painn_md_model(device)
    batch = md_batch(device, PAINN_CUTOFF)
    pos0 = batch.nodes["node_coordinates"]
    vel0 = torch.zeros_like(pos0)
    masses = torch.full((batch.n_node,), 12.0, device=pos0.device)
    fn = make_energy_force_fn(model, batch)
    with captured_calls() as calls:
        _, f0 = fn(pos0)
    recs = {name: [dict(r, path="painn_md_single") for r in rs]
            for name, rs in check_captured(calls, "PAiNN MD 21 atoms").items()}
    if not (torch.isfinite(f0).all() and f0.sum(0).abs().max().item()
            <= FORCE_SUM_TOL * batch.n_node * f0.abs().max().item()):
        raise AssertionError("PAiNN MD: forces not finite or not summing to 0")

    def run(n):
        return velocity_verlet(fn, pos0, vel0, masses, MD_DT, n, node_mask=batch.node_mask)

    def wall(n):
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the main path: every count set to 0 just before, read just after
    reset_counts()
    traj = run(short)
    torch.cuda.synchronize()
    single_launches = kernel_counts()
    want = {k: (short + 1) * v for k, v in PAINN_LAUNCHES.items()}
    if single_launches != want:
        raise AssertionError(f"PAiNN MD: launches {single_launches} in {short} steps, "
                             f"expected {want}")
    long_traj = run(long)
    slopes = [(wall(long) - wall(short)) / (long - short) for _ in range(pairs)]
    cpu_batch = batch.to("cpu")
    cpu_traj = velocity_verlet(make_energy_force_fn(painn_md_model("cpu"), cpu_batch),
                               cpu_batch.nodes["node_coordinates"], vel0.cpu(), masses.cpu(),
                               MD_DT, short, node_mask=cpu_batch.node_mask)
    drift = nve_drift(long_traj)
    if not drift["max_abs_drift"] < PAINN_MAX_DRIFT:
        raise AssertionError(f"PAiNN MD: drift {drift['max_abs_drift']} >= {PAINN_MAX_DRIFT}")
    out = {"atoms": int(batch.node_mask.sum().item()), "N_pad": batch.n_node,
           "E_pad": batch.n_edge, "real_edges": int(batch.edge_mask.sum().item()),
           "steps": list(steps), "pairs": pairs, "card": smi,
           "us_per_md_step": 1e6 * min(slopes), "us_per_md_step_slopes": [1e6 * v for v in slopes],
           "e_pot_rel_err_vs_cpu": check_close("PAiNN MD e_pot against the CPU", traj["e_pot"],
                                               cpu_traj["e_pot"], MD_TOL),
           "nve_drift": drift, "launches_per_step": PAINN_LAUNCHES}

    n, t = 21, np.arange(21) * 1.2
    systems = [md_system(np.random.RandomState(100 + s), n, t) for s in range(replicas)]
    kw = dict(dt=MD_DT, segment_steps=segment_steps, max_distance=PAINN_CUTOFF,
              max_neighbours=25)
    md = ScannedMD(model, device=device, **kw)
    md.run_ensemble(systems, 1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ens = md.run_ensemble(systems, segments)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ensemble_launches = kernel_counts()
    want = {k: segments * (segment_steps + 1) * v for k, v in PAINN_LAUNCHES.items()}
    if ensemble_launches != want:
        raise AssertionError(f"PAiNN ensemble: launches {ensemble_launches}, expected {want}")
    if ens["e_pot"].shape != (segments * segment_steps, replicas) or not (
            np.isfinite(ens["e_pot"]).all() and np.isfinite(ens["e_kin"]).all()):
        raise AssertionError(f"PAiNN ensemble: e_pot {ens['e_pot'].shape}, or not finite")
    cpu_ens = ScannedMD(painn_md_model("cpu"), device="cpu", **kw).run_ensemble(systems, 1)
    out["ensemble"] = {
        "replicas": replicas, "segment_steps": segment_steps, "segments": segments,
        "us_per_replica_step": 1e6 * seconds / (segments * segment_steps) / replicas,
        "ms_per_step": 1e3 * seconds / (segments * segment_steps),
        "edge_counts": ens["edge_counts"],
        "e_pot_rel_err_vs_cpu": check_close("PAiNN ensemble e_pot against the CPU",
                                            ens["e_pot"][:segment_steps], cpu_ens["e_pot"],
                                            MD_TOL)}
    log("painn md: " + json.dumps(out))
    return {"painn_md_single": single_launches, "painn_md_ensemble": ensemble_launches}, recs


def phase_options(requests, batch0, smi, unfused_answers, profiles):
    """Phase 21: every option of the potentials (see the module
    docstring), an evaluation or a step of each serving and training path
    queued on ``profiles`` for ``run_profiles``. Returns the launch counts
    of each main path and the kernel records."""
    by_path, records = {}, {}

    def add(recs):
        for name, rs in recs.items():
            records.setdefault(name, []).extend(rs)
    by_path["hdnnp2nd_wacsf_serving"], recs = phase_wacsf_serving(requests, smi, profiles)
    add(recs)
    paths, recs = phase_schnet_options(requests, batch0, smi, unfused_answers, profiles)
    by_path.update(paths)
    add(recs)
    for path, cfg in TRAIN_PATHS.items():
        if cfg.get("phase") == 21:
            by_path[path], recs = phase_training(path, smi, profiles)
            add(recs)
    by_path["multistate"] = phase_multistate(batch0, smi)
    paths, recs = phase_painn_md(smi)
    by_path.update(paths)
    add(recs)
    by_path["force_inverse_distances_script"], recs = phase_script("force_inverse_distances", smi)
    add(recs)
    return by_path, records


# ------------------------------------------- phases 22 and 23: the zoo

# the model modules of the zoo, registry name: (module, inputs, phase), at
# their model_default widths, each with the inputs it reads besides the node
# numbers, drawn per molecule. Phase 22, the first group: integer edge
# attributes below 5 (GAT, GATv2, GraphSAGE: their input_embedding["edge"])
# or 15 (INorp), INorp's integer graph attribute below 32, edge relations
# below 20 (RGCN, GNN-FiLM). Phase 23, the second group, with inputs of the
# kind their golden recipes give them: integer edge classes below 5 where the
# model embeds its edges, float edge features of the goldens' width 5 where
# they enter a Dense (CMPNN) or a concatenation (MEGAN) as they are, and
# reverse edges for DMPNN and CMPNN; HamNet reads the molecules'
# node_coordinates, which every zoo batch carries. Phase 24, the third
# group: the force potentials (``force``: EGNN, Megnet, DimeNet++, MXMNet)
# train on ``train_force``'s frames (``force_frames``), DimeNet++ with the
# ``angle_pairs`` of ``set_angle_edge_pairs``, MXMNet on the driver's
# ``multiplex`` graphs; the ``crystal`` models on a golden's cells. Phase 25,
# the padded-form models: MAT as ``hyper_esol.py``'s entry builds it
# (``hyper``: the library file and its key; depth 5, 8 heads of 8, 64 units),
# on the node numbers and coordinates, its adjacency of ones; the Graph U-Net
# at its ``model_default`` on integer edge attributes below 5 (its edge
# ``input_embedding``), since ``hyper_mutag.py``'s entry fails in JAX too
ZOO_MODELS = {"GIN": ("gin", {}, 22), "GraphSAGE": ("sage", {"edge_classes": 5}, 22),
              "GAT": ("gat", {"edge_classes": 5}, 22),
              "GATv2": ("gatv2", {"edge_classes": 5}, 22),
              "RGCN": ("rgcn", {"relations": 20}, 22),
              "GNNFilm": ("gnnfilm", {"relations": 20}, 22),
              "INorp": ("inorp", {"edge_classes": 15, "graph_classes": 32}, 22),
              "DMPNN": ("dmpnn", {"edge_classes": 5, "reverse_edges": True}, 23),
              "CMPNN": ("cmpnn", {"edge_features": 5, "reverse_edges": True}, 23),
              "NMPN": ("nmpn", {"edge_classes": 5}, 23),
              "AttentiveFP": ("attentivefp", {"edge_classes": 5}, 23),
              "HamNet": ("hamnet", {"edge_classes": 5}, 23),
              "MEGAN": ("megan", {"edge_features": 5}, 23),
              "EGNN": ("egnn", {"force": True}, 24),
              "Megnet": ("megnet", {"force": True}, 24),
              "CGCNN": ("cgcnn", {}, 24),
              "DimeNetPP": ("dimenet_pp", {"force": True, "angle_pairs": True}, 24),
              "MXMNet": ("mxmnet", {"force": True, "multiplex": True}, 24),
              "CGCNN-crystal": ("cgcnn", {"crystal": "cgcnn"}, 24),
              "Megnet-crystal": ("megnet", {"crystal": "megnet_crystal"}, 24),
              "DimeNetPP-crystal": ("dimenet_pp", {"crystal": "cgcnn", "angle_pairs": True},
                                    24),
              "MAT": ("mat", {"hyper": ("hyper_esol.py", "MAT")}, 25),
              "Unet": ("unet", {"edge_classes": 5}, 25)}
# segment-sum launches (forward, training step) of each at those widths. The
# step's loss is a masked graph MAE (no force pass): its reverse pass adds
# the transpose of each sender gather whose input depends on the parameters
# (a sum's backward is a gather, no launch; a plain gather, ``index_select``,
# has ``index_add_`` for its backward):
# - GIN (depth 3): 3 edge sums and 4 graph mean pools (the input's and each
#   layer's embedding); + 3 transposes;
# - GAT (5 heads, depth 1): 5 attention sums and the graph pool; + 5 (W n_j);
# - GATv2: 5 + 1; + 10 (n_j and W n_j of each head);
# - GraphSAGE (depth 3): 3 mean pools and the graph pool; its gathers are
#   plain, + 0;
# - RGCN (depth 5): 5 sums and the graph pool; + 5;
# - GNN-FiLM (depth 5): 5 + 1; plain gathers, + 0;
# - INorp (depth 3): 3 sum pools and the graph pool; plain gathers, + 0;
# and the second group, whose gathers are all plain, so that a step launches
# what its forward does:
# - DMPNN (depth 5): 6 edge sums (5 rounds and the readout's) and the graph sum;
# - CMPNN (depth 5): the booster's sum in each of 4 rounds and in the last;
#   its maxima are ``scatter_reduce``, its GRU readout launches none;
# - NMPN (depth 3): 3 message sums; Set2Set's sums are unsorted;
# - AttentiveFP: 2 heads' attention sums, the readout's sum pool and its 2
#   attention rounds;
# - HamNet (depth 1): 1 attention sum, the fingerprint's mean pool and its 2
#   attention rounds;
# - MEGAN (3 layers of 2 heads): 6 attention sums, the mean onto the receivers
#   (onto the senders it is unsorted) and the 2 channels' graph sums.
# Every softmax's denominator is an ``index_add_``. The third group: a
# forward's sums onto the receivers and the graphs; the crystal models' and
# CGCNN's steps (a masked graph MAE) add none, as the second group's. A
# force step (``zoo_force_loss``) takes the forces by a first reverse pass
# and differentiates it: each sum's reverse is a gather (no launch), whose
# own reverse, in the second pass, launches the sum again wherever its
# cotangent depends on the parameters; a position gather with a sorted
# transpose (``edge_vectors``) launches its transpose in the first pass:
# - EGNN (depth 4): 4 coordinate means, 4 message sums and the graph sum;
#   + 8 (the last coordinate mean is read by nothing);
# - Megnet (3 blocks): 3 means onto the nodes, 3 onto the graphs (the edges'
#   mean per graph is unsorted); + 2 (``edge_vectors``' transposes) + 6;
# - CGCNN (depth 4): 4 message sums and the graph mean;
# - DimeNet++ (4 blocks): 5 output blocks' sums and the graph sum (its
#   position gathers are plain); + 5 (the graph sum's cotangent is the
#   constant mask: the readout is linear);
# - MXMNet: the graph sum (every other sum is unsorted); + 1.
# Phase 25's MAT and Graph U-Net run on padded per-graph tensors: their
# sums over a graph's nodes or its adjacency are dense reductions and
# matmuls, their adjacency a scatter (JAX takes XLA's scatter and dot for
# them, no Pallas kernel), so they launch no kernel of the port.
ZOO_LAUNCHES = {"GIN": (7, 10), "GraphSAGE": (4, 4), "GAT": (6, 11), "GATv2": (6, 16),
                "RGCN": (6, 11), "GNNFilm": (6, 6), "INorp": (4, 4),
                "DMPNN": (7, 7), "CMPNN": (5, 5), "NMPN": (3, 3), "AttentiveFP": (5, 5),
                "HamNet": (4, 4), "MEGAN": (9, 9),
                "EGNN": (9, 17), "Megnet": (6, 14), "CGCNN": (5, 5), "DimeNetPP": (6, 11),
                "MXMNet": (1, 2), "CGCNN-crystal": (5, 5), "Megnet-crystal": (6, 6),
                "DimeNetPP-crystal": (6, 6), "MAT": (0, 0), "Unet": (0, 0)}
ZOO_STEPS = 5
# the first step is held against the CPU's on the first ZOO_FIRST_STEP_MOLS
# molecules, as phase 10 takes a 64-molecule batch for it, which keeps the
# CPU's share of the phase small
ZOO_FIRST_STEP_MOLS = 64
# the drivers, (phase, script, --model): the graph-learning ones each cut to
# 3 epochs (60) of 2 folds (3), no PNGs (no matplotlib on the card's
# machine); the JAX moleculenet driver runs NMPN, AttentiveFP, HamNet and
# MEGAN of the second group on its data (DMPNN and CMPNN stop at its
# assert): phase 23 runs AttentiveFP there; phase 24 runs ``train_force``;
# phase 25 ``train_force --hyper`` (``train_force_hyper``) of the library's
# ``hyper_synthetic_md.py`` with its two models; phase 28 the dataset
# layer's runs (``phase_datasets``)
ZOO_DRIVERS = ((22, "train_tudataset", "GIN"), (22, "train_moleculenet", "GIN"),
               (22, "train_moleculenet", "GAT"), (23, "train_moleculenet", "AttentiveFP"),
               (24, "train_force", "MXMNet"), (24, "train_force", "EGNN"),
               (25, "train_force_hyper", "Schnet"), (25, "train_force_hyper", "PAiNN"),
               (27, "train_citation", "GCN"), (27, "train_qm", "Schnet"),
               (27, "train_crystal", "Schnet"), (27, "train_crystal", "CGCNN"),
               (27, "train_vgd_mock", "MEGAN"), (27, "train_vgd_rb_motifs", "MEGAN"),
               (28, "train_citation_cora", "GCN"), (28, "train_qm_qm9", "Schnet"),
               (28, "train_force_rmd17", "Schnet.EnergyForceModel"),
               (28, "train_tudataset_mutag", "GIN"))
ZOO_DRIVER_ARGS = ["--epochs", "3", "--folds", "2", "--no-plots"]
# train_force at its default 128 frames, cut to 3 epochs (50) of one fold
FORCE_DRIVER_ARGS = ["--epochs", "3", "--folds", "1", "--no-plots"]
# phase 27's drivers at their widths on data of a real size: GCN on a graph
# of Cora's 2708 nodes, 20 epochs (100) of 2 folds (5); SchNet on 512
# molecules, 2 epochs (60) of 2 folds (3); the crystal SchNet and CGCNN on
# 512 structures, 2 epochs (40) of the one fold; MEGAN on 512 graphs of
# each visual-graph dataset, 20 epochs (100): each run records a loss
CITATION_ARGS = ["--nodes", "2708", "--epochs", "20", "--folds", "2", "--no-plots"]
QM_ARGS = ["--molecules", "512", "--epochs", "2", "--folds", "2", "--no-plots"]
CRYSTAL_ARGS = ["--structures", "512", "--epochs", "2", "--no-plots"]
VGD_ARGS = ["--graphs", "512", "--epochs", "20", "--no-plots"]
# the configuration library, and the one config whose dataset is ported:
# SchNet (depth 4, 128 units, 25 bins, 5 A) and PAiNN (depth 3, 128 units,
# 20 Bessel radials, cutoff 5) on 256 frames of ``SyntheticMDDataset``
HYPER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "training", "hyper")
HYPER_MD = os.path.join(HYPER_DIR, "hyper_synthetic_md.py")
# each phase 24 batch at 512 frames, molecules or graphs: nodes, edges,
# graphs, the pairs of angle_edges and angle_edges_2 and the second edge
# set's edges (None where the batch has none), with their padding
ZOO_SHAPES = {"EGNN": (4736, 34560, 513, None, None, None),
              "Megnet": (4736, 34560, 513, None, None, None),
              "CGCNN": (8192, 54784, 513, None, None, None),
              "DimeNetPP": (4736, 34560, 513, 225920, None, None),
              "MXMNet": (4736, 13056, 513, 28160, 41216, 34560),
              "CGCNN-crystal": (1408, 8704, 513, None, None, None),
              "Megnet-crystal": (9856, 176640, 513, None, None, None),
              "DimeNetPP-crystal": (1408, 8704, 513, 38400, None, None)}


def zoo_crystals(golden, n_graphs, rs):
    """The periodic cells of ``tests/assets/ref_golden_<golden>.npz`` (node
    numbers, positions, edges, lattice images, lattice; Megnet's cells
    their state), repeated to ``n_graphs``, each with a graph label drawn
    from ``rs``."""
    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "assets",
                             f"ref_golden_{golden}.npz"))
    cells = []
    for i in range(int(d["n_graphs"])):
        lattice = d[f"g{i}_lattice"].astype(np.float32)
        pos = d[f"g{i}_frac"] @ d[f"g{i}_lattice"] if f"g{i}_frac" in d.files \
            else d[f"g{i}_xyz"]
        image = d[f"g{i}_cell_translations"] if f"g{i}_cell_translations" in d.files \
            else d[f"g{i}_edge_image"]
        cell = {"node_number": d[f"g{i}_z"].astype(np.int64),
                "node_coordinates": np.asarray(pos, np.float32),
                "edge_indices": d[f"g{i}_edge_indices"].astype(np.int64),
                "range_image": image.astype(np.int64), "graph_lattice": lattice}
        if f"g{i}_graph_attributes" in d.files:
            cell["graph_attributes"] = d[f"g{i}_graph_attributes"].astype(np.float32)
        cells.append(cell)
    graphs = [dict(cells[i % len(cells)]) for i in range(n_graphs)]
    for g in graphs:
        g["graph_labels"] = rs.randn(1).astype(np.float32)
    return graphs


def force_frames(name, n_frames):
    """``train_force``'s frames for ``--model name --frames n_frames --seed
    0``: ``SyntheticMDDataset``'s geometries of one molecule with the
    driver's edges (MXMNet's multiplex graphs), their energies and forces
    scaled by an ``EnergyForceExtensiveLabelScaler`` fit on them, as the
    driver scales a fold's."""
    from gcnn_keras_tpu_torch.data.scalers import EnergyForceExtensiveLabelScaler
    from gcnn_keras_tpu_torch.scripts import train_force
    ds, _ = train_force.load_dataset(train_force.parser().parse_args(
        ["--model", name, "--frames", str(n_frames), "--seed", "0"]))
    scaler = EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(ds)
    scaler.transform_dataset(ds)
    return list(ds)


def zoo_graphs(name, n_mols=512):
    """The molecules of ``labelled_mols(0, n_mols)`` (phase 4's) with a
    graph label and the inputs of ``ZOO_MODELS[name]``, drawn from
    ``RandomState(1000)``; a ``force`` potential's graphs are
    ``train_force``'s frames (``force_frames``), a ``crystal`` model's its
    golden's cells (``zoo_crystals``)."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle_edge_pairs
    rs = np.random.RandomState(1000)
    inputs = ZOO_MODELS[name][1]
    if "crystal" in inputs:
        graphs = zoo_crystals(inputs["crystal"], n_mols, rs)
    elif inputs.get("force"):
        graphs = force_frames(name, n_mols)
    else:
        graphs = labelled_mols(0, n_mols)
    for g in graphs:
        m = len(g["edge_indices"])
        g.setdefault("graph_labels", rs.randn(1).astype(np.float32))
        if "edge_classes" in inputs:
            g["edge_attributes"] = rs.randint(0, inputs["edge_classes"], size=m)
        if "edge_features" in inputs:
            g["edge_attributes"] = rs.randn(m, inputs["edge_features"]).astype(np.float32)
        if "relations" in inputs:
            g["edge_relations"] = rs.randint(0, inputs["relations"], size=m)
        if "graph_classes" in inputs:
            g["graph_attributes"] = rs.randint(0, inputs["graph_classes"], size=1)
    if inputs.get("angle_pairs"):
        # a repeated cell's pairs are its first copy's
        pairs = {}
        for g in graphs:
            key = id(g["edge_indices"])
            if key not in pairs:
                pairs[key] = set_angle_edge_pairs(
                    g, range_indices="edge_indices")["angle_indices"]
            g["angle_indices"] = pairs[key]
    return graphs


def zoo_batch_kw(name):
    """``batch_graphs``' keywords for ``ZOO_MODELS[name]``: its global keys,
    reverse edges, pair lists and second edge set."""
    inputs = ZOO_MODELS[name][1]
    keys = ("graph_labels",) + (("graph_attributes",) if name in ("INorp", "Megnet-crystal")
                                else ()) \
        + (("energy",) if inputs.get("force") else ()) \
        + (("graph_lattice",) if "crystal" in inputs else ())
    kw = dict(global_keys=keys, compute_reverse_edges=inputs.get("reverse_edges", False))
    if inputs.get("angle_pairs"):
        kw["angle_edge_index_key"] = "angle_indices"
    if inputs.get("multiplex"):
        from gcnn_keras_tpu_torch.scripts.train_force import MXMNET_BATCH_KW
        kw.update(MXMNET_BATCH_KW)
    return kw


def zoo_batch(name, device, n_mols=512):
    from gcnn_keras_tpu_torch.batch import batch_graphs
    return batch_graphs(zoo_graphs(name, n_mols), device=device, **zoo_batch_kw(name))


def zoo_shapes(batch):
    """``(nodes, edges, graphs, pairs, second pairs, second edges)`` of a
    batch, padding included (None where it has none)."""
    return (batch.n_node, batch.n_edge, batch.n_graphs,
            None if batch.angle_edges is None else int(batch.angle_edges.shape[0]),
            None if batch.angle_edges_2 is None else int(batch.angle_edges_2.shape[0]),
            None if batch.senders2 is None else int(batch.senders2.shape[0]))


def fill_zero_heads(model, generator):
    """DimeNet++'s and MXMNet's output heads start at zeros (the JAX
    package's defaults), so a fresh model's output is a constant: fill them
    as JAX's alternatives draw them, DimeNet++'s ``out`` by
    ``glorot_orthogonal`` and MXMNet's ``y_W`` by glorot-uniform, from
    ``generator`` on the CPU."""
    from gcnn_keras_tpu_torch.layers.mlp import glorot_uniform_
    from gcnn_keras_tpu_torch.models.dimenet_pp import DimNetOutputBlock
    from gcnn_keras_tpu_torch.models.mxmnet import MXMLocalMP
    from gcnn_keras_tpu_torch.ops.initializers import glorot_orthogonal_
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, DimNetOutputBlock):
                w = module.out.weight
                w.copy_(glorot_orthogonal_(torch.empty(w.shape), generator))
            elif isinstance(module, MXMLocalMP):
                w = module.y_W.weight
                w.copy_(glorot_uniform_(torch.empty(w.shape), generator))
    return model


def zoo_model(name, device, **kw):
    """``ZOO_MODELS[name]``'s model at its ``model_default`` widths, weights
    from seed 0 (INorp told its graph attributes' width, 1; CMPNN and MEGAN
    their float edge features'; Megnet's crystal model its cells' state's,
    1); a ``crystal`` model by ``make_crystal_model``; DimeNet++'s and
    MXMNet's zero heads filled from seed 1 (``fill_zero_heads``); a
    ``hyper`` model as the port's ``HyperParameter`` builds the library
    file's entry."""
    module, inputs, _ = ZOO_MODELS[name]
    if "hyper" in inputs:
        from gcnn_keras_tpu_torch.training.hyper import HyperParameter
        path, key = inputs["hyper"]
        return HyperParameter(os.path.join(HYPER_DIR, path), model_name=key).make_model(
            device="cpu", generator=torch.Generator().manual_seed(0), **kw).to(device)
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.models.{module}")
    if name in ("INorp", "Megnet-crystal"):
        kw.setdefault("graph_in_features", 1)
    if "edge_features" in inputs:
        kw.setdefault("edge_in_features", inputs["edge_features"])
    make = mod.make_crystal_model if "crystal" in inputs else mod.make_model
    model = make(device="cpu", generator=torch.Generator().manual_seed(0), **kw)
    if module in ("dimenet_pp", "mxmnet"):
        fill_zero_heads(model, torch.Generator().manual_seed(1))
    return model.to(device)


def zoo_loss(model, b):
    """The masked graph MAE of ``model`` on ``b`` against its ``graph_labels``."""
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae
    return masked_graph_mae(model(b)["output"], b.globals["graph_labels"],
                            b.globals["graph_mask"])


def zoo_force_loss(model, b):
    """``train_force``'s loss of ``model`` as an energy and force potential
    at the driver's default weights (the energies' MAE + 50 x the forces'
    MAE; ``EnergyForceModel``, the forces with their graph)."""
    from gcnn_keras_tpu_torch.scripts import train_force
    args = train_force.parser().parse_args([])
    fmodel = train_force.EnergyForceModel(model, device=b.node_mask.device)
    return train_force.loss_fn(fmodel, args.energy_weight, args.force_weight)(b)[0]


def zoo_loss_of(name):
    """The training loss of ``ZOO_MODELS[name]``: ``zoo_force_loss`` for a
    force potential, else ``zoo_loss``."""
    return zoo_force_loss if ZOO_MODELS[name][1].get("force") else zoo_loss


def zoo_trainer(name, device):
    """``(model, Trainer, TrainState)``: ``zoo_loss_of(name)``,
    ``torch.optim.Adam`` at 1e-3; a force potential under ``train_force``'s
    schedule at its defaults (50 epochs of 128 frames: a warm-up from 0 to
    1e-3 over 40 steps), without which Adam's first steps at 1e-3 overshoot
    a force loss (DimeNet++'s rose 20-fold)."""
    from gcnn_keras_tpu_torch.scripts import train_force
    from gcnn_keras_tpu_torch.training import Trainer
    model, loss = zoo_model(name, device), zoo_loss_of(name)
    schedule = train_force.schedule_for(train_force.parser().parse_args([])) \
        if ZOO_MODELS[name][1].get("force") else None
    trainer = Trainer(lambda b: (loss(model, b), {}),
                      functools.partial(torch.optim.Adam, lr=1e-3), schedule=schedule)
    return model, trainer, trainer.init_state(model.parameters())


def host_syncs(fn):
    """``fn()``'s synchronizing operations, as ``torch.cuda``'s sync debug
    mode warns of them (``.tolist()``, ``nonzero``, ``bincount``, ...)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def zoo_kernel_calls(calls, label, path, timed_shapes):
    """Each captured segment-sum call against its plain version; the first
    call of each (rows, columns, segments) shape not in ``timed_shapes``
    is timed, and its shape added."""
    recs = []
    for name, arg_list in calls.items():
        for i, args in enumerate(arg_list):
            shape = (args[0].shape[0], args[0].shape[1], args[2])
            recs.append(dict(check_kernel_call(name, args, f"{label}, call {i + 1} of "
                                               f"{len(arg_list)}",
                                               timed=shape not in timed_shapes), path=path))
            timed_shapes.add(shape)
    return recs


def peak_mb(device):
    """The card's peak allocation since the last reset, in MiB (None on the
    CPU)."""
    return torch.cuda.max_memory_allocated() / 2**20 if device == "cuda" else None


def reset_peak(device):
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def check_selection(name, gpu, batch, outs, refs):
    """The card's gPool selections (``keep``, one mask a level) against the
    CPU's ``refs``: equal, or differing only at a near tie of the
    selection, which is discontinuous. At the first level that differs, each
    node that changes side must lie on the CPU within twice the card's
    largest score difference from the CPU's at that level (float32
    rounding) of the nearest score on the other side of its graph's cut;
    the card's answers with the CPU's selections imposed then take the
    place of its own for the checks that follow. Returns ``(outs,
    record)``."""
    keep, ref_keep = outs["keep"].cpu(), refs["keep"]
    rec = {"levels": int(ref_keep.shape[0]), "nodes_differing": 0}
    if torch.equal(keep, ref_keep):
        return outs, rec
    level = int((keep != ref_keep).flatten(1).any(1).nonzero()[0, 0])
    current = ref_keep[level - 1] if level else flat_to_padded_mask(batch).cpu()
    score, ref_score = outs["score"][level].cpu(), refs["score"][level]
    spread = float((score - ref_score).abs()[current > 0].max())
    gaps = []
    for g, i in (keep[level] != ref_keep[level]).nonzero().tolist():
        kept = ref_keep[level, g] > 0
        other = ref_score[g][(current[g] > 0) & (kept if not kept[i] else ~kept)]
        gaps.append(float((other - ref_score[g, i]).abs().min()))
    rec.update(nodes_differing=len(gaps), level=level, max_gap=max(gaps), score_spread=spread,
               graphs=int((keep[level] != ref_keep[level]).any(1).sum()))
    if not max(gaps) <= 2 * spread:
        raise AssertionError(f"{name}: gPool selections differ at level {level} beyond a near "
                             f"tie: {rec}")
    log(f"{name}: gPool selection differs at a near tie: " + json.dumps(rec))
    with torch.no_grad():
        outs = gpu(batch, selection=[k.to(batch.node_mask.device) for k in ref_keep])
    return outs, rec


def flat_to_padded_mask(batch):
    """The ``(G, M)`` mask of a batch's real nodes in padded form."""
    from gcnn_keras_tpu_torch.batch import flat_to_padded
    return flat_to_padded(batch.node_mask[:, None].to(torch.float32), batch)[..., 0]


def phase_zoo_model(name, smi, timed_shapes, profiles, device="cuda", n_mols=512):
    """Phases 22 to 24 for one model: a graph-level forward against the
    CPU's on the same weights (every output: MEGAN's importances too; GIN
    also with ``train=True``, its batch statistics and running averages; a
    force potential's energies and forces by ``check_grads``' float64
    rules),
    every kernel call of one forward against its plain version (new shapes
    timed), the forward's launches, host syncs, time and peak memory; the
    first training step against the CPU's (on ``ZOO_FIRST_STEP_MOLS``
    molecules), every kernel call of a step against its plain version, then
    ``ZOO_STEPS`` steps with their launches, losses, times, host syncs and
    peak memory. Returns the launch counts of the forward and the steps,
    and the kernel records. ``device`` and ``n_mols`` (phase 4's 512 on the
    card) let it run on the CPU at a small size."""
    t_start = time.perf_counter()
    batch = zoo_batch(name, device, n_mols=n_mols)
    host_ms_batch = 1e3 * (time.perf_counter() - t_start)
    shapes = zoo_shapes(batch)
    if n_mols == 512 and shapes != ZOO_SHAPES.get(name, (8192, 54784, 513, None, None, None)):
        raise AssertionError(f"{name}: shapes {shapes}")
    cpu_batch, (fwd_want, step_want) = batch.to("cpu"), ZOO_LAUNCHES[name]
    gpu = zoo_model(name, device)
    reset_peak(device)
    with torch.no_grad():
        outs = gpu(batch)
        peak_forward = peak_mb(device)
        refs = zoo_model(name, "cpu")(cpu_batch)
    selection = None
    if "keep" in refs:
        outs, selection = check_selection(name, gpu, batch, outs, refs)
    out = outs["output"]
    if out.shape != (batch.n_graphs, 1) or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: output {tuple(out.shape)} or not finite")
    rec = {"model": name, "card": smi, "N_pad": batch.n_node, "E_pad": batch.n_edge,
           "G": batch.n_graphs, "max_nodes": batch.max_nodes,
           **({"selection": selection} if selection else {}),
           **({"pairs_pad": shapes[3], "pairs_2_pad": shapes[4], "E2_pad": shapes[5],
               "pairs_real": None if batch.angle_edge_mask is None
               else int(batch.angle_edge_mask.sum()),
               "host_ms_batch": host_ms_batch} if ZOO_MODELS[name][2] == 24 else {})}
    force = ZOO_MODELS[name][1].get("force")
    if not force:
        rec["forward_rel_err"] = check_close(f"{name} forward", out.cpu(), refs["output"])
    for key in sorted(set(refs) - {"output"}):
        if not torch.isfinite(outs[key]).all():
            raise AssertionError(f"{name}: {key} not finite")
        rec[f"{key}_rel_err"] = check_close(f"{name} {key}", outs[key].cpu(), refs[key])
    if force:
        # a potential's answers, its energies and forces, by ``check_grads``'
        # float64 rules: MXMNet's forces, some 1e7 from its filled heads, lie
        # 6.4e-4 of the largest from float64 in the CPU's float32 (an H100's
        # 4.3e-4); an H100's Megnet energies lie 6.9e-5 from the CPU's
        from gcnn_keras_tpu_torch.model.force import EnergyForceModel

        def answers(model, b, dev):
            got = EnergyForceModel(model, device=dev).apply(b)
            return {k: got[k].detach().cpu() for k in ("energy", "force")}
        got = answers(gpu, batch, device)
        if not all(torch.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"{name}: energies or forces not finite")
        rec["answers_rel_err"], arbitrated = check_grads(
            name, got, answers(zoo_model(name, "cpu"), cpu_batch, "cpu"), SERVE_TOL,
            lambda: answers(zoo_model(name, "cpu").double(), cpu_batch._map(
                lambda v: v.double() if v.is_floating_point() else v), "cpu"))
        if arbitrated:
            rec["answers_float64_arbiter"] = arbitrated
    if name == "GIN":
        models = {dev: zoo_model(name, dev) for dev in (device, "cpu")}
        got = models[device](batch, train=True)["output"].detach().cpu()
        rec["train_forward_rel_err"] = check_close(
            "GIN train=True forward", got, models["cpu"](cpu_batch, train=True)["output"].detach())
        cpu_stats = dict(models["cpu"].named_buffers())
        rec["running_stats_rel_err"] = max(
            check_close(f"GIN {n}", b.cpu(), cpu_stats[n])
            for n, b in models[device].named_buffers())
    with captured_calls() as calls, torch.no_grad():
        gpu(batch)
        torch.cuda.synchronize()
    counts = {k: len(v) for k, v in calls.items() if v}
    if counts != ({"sorted_segment_sum": fwd_want} if fwd_want else {}):
        raise AssertionError(f"{name} forward: kernel calls {counts}, expected {fwd_want}")
    recs = zoo_kernel_calls(calls, f"{name}_zoo_forward", f"{name}_zoo_forward", timed_shapes)
    del calls

    def forward():
        with torch.no_grad():
            return gpu(batch)
    # the forward's main path: every count set to 0 just before, read just after
    reset_counts()
    forward()
    torch.cuda.synchronize()
    fwd_launches = kernel_counts()
    rec.update(ms_per_forward=synced_ms(forward, 5), syncs_per_forward=host_syncs(forward),
               peak_mem_mb_forward=peak_forward)

    first, small = [], zoo_batch(name, "cpu", n_mols=min(n_mols, ZOO_FIRST_STEP_MOLS))
    for dev, b in ((device, small.to(device)), ("cpu", small)):
        model, trainer, state = zoo_trainer(name, dev)
        _, metrics = trainer.step(state, b)
        first.append((float(metrics["loss"]),
                      {n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = first
    if not abs(loss_gpu - loss_cpu) <= TRAIN_TOL * abs(loss_cpu):
        raise AssertionError(f"{name}: first loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    # the second and third groups' first steps take ``check_grads``' float64
    # rules (CMPNN's float32 gradients at its default widths, HamNet's
    # attention-logit biases); the first group's never needed them
    worst, arbitrated = check_grads(
        name, grads_gpu, grads_cpu, TRAIN_TOL,
        (lambda: float64_grads(zoo_model(name, "cpu"), zoo_loss_of(name), small))
        if ZOO_MODELS[name][2] >= 23 else None)
    rec["first_step"] = {"loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "max_rel_grad_err": worst,
                         **({"float64_arbiter": arbitrated} if arbitrated else {})}
    _, trainer, state = zoo_trainer(name, device)
    with captured_calls() as calls:
        trainer.step(state, batch)
        torch.cuda.synchronize()
    counts = {k: len(v) for k, v in calls.items() if v}
    if counts != ({"sorted_segment_sum": step_want} if step_want else {}):
        raise AssertionError(f"{name} step: kernel calls {counts}, expected {step_want}")
    recs += zoo_kernel_calls(calls, f"{name}_zoo_train", f"{name}_zoo_train", timed_shapes)
    del calls

    _, trainer, state = zoo_trainer(name, device)
    torch.cuda.synchronize()
    reset_peak(device)
    # the steps' main path: every count set to 0 just before, read just after
    reset_counts()
    losses, times, per_step = [], [], []
    for _ in range(ZOO_STEPS):
        before = kernel_counts()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
        per_step.append({k: v - before[k] for k, v in kernel_counts().items()})
    step_launches = kernel_counts()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}")
    if any(c != launch_counts(sorted_segment_sum=step_want) for c in per_step):
        raise AssertionError(f"{name}: step launches {per_step}, expected {step_want}")
    rec.update(losses=losses, ms_per_step=float(np.median(times[1:])),
               ms_first_step=times[0], peak_mem_mb_step=peak_mb(device),
               launches_per_forward=fwd_want, launches_per_step=step_want,
               syncs_per_step=host_syncs(lambda: trainer.step(state, batch)),
               s_phase=time.perf_counter() - t_start)
    log(f"{name} zoo: " + json.dumps(rec))
    profiles.append((f"{name} zoo step", lambda: trainer.step(state, batch)))
    return {f"{name}_zoo_forward": fwd_launches, f"{name}_zoo_train": step_launches}, recs


def graph_driver_cpu_step(script, model, argv=()):
    """A graph-learning driver's model on the CPU (its default seed 42, the
    widths of its data: ``argv``'s ``--dataset``, else the synthetic ones)
    with its loss; its first step takes ``TRAIN_TOL`` alone."""
    from gcnn_keras_tpu_torch.training import graph_driver
    name = ZOO_DRIVER_RUNS[script][3]
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")
    dataset = graph_driver.driver_parser("", "").parse_args(list(argv)).dataset
    # the drivers' default --seed
    ds = DATASET_CACHE[dataset] if dataset in DATASET_CACHE else mod.load_dataset(dataset, 42)
    n_out = mod.n_classes(ds) if name == "train_tudataset" else 1
    cpu_model = graph_driver.build_model(model, n_out, graph_driver.input_widths(ds),
                                         device="cpu")
    return list(cpu_model.named_parameters()), mod.loss_fn(cpu_model), None


def force_driver_cpu_step(script, model, argv=()):
    """``train_force``'s model on the CPU (its default seed 42; the
    ``--hyper`` config's model where ``argv`` has one) with its loss, and
    the float64 gradients of that loss for ``check_grads``' rules."""
    from gcnn_keras_tpu_torch.scripts import train_force
    args = train_force.parser().parse_args(list(argv) + ["--model", model])
    fmodel = train_force.build_model(model, "cpu", torch.Generator().manual_seed(args.seed),
                                     train_force.load_hyper(args))
    loss_fn = train_force.loss_fn(fmodel, args.energy_weight, args.force_weight)
    return (list(fmodel.energy_model.named_parameters()), loss_fn,
            lambda batch: float64_grads(fmodel.energy_model, lambda m, b: loss_fn(b)[0], batch))


def citation_cpu_step(script, model, argv=()):
    """``train_citation``'s model and first fold's loss on the CPU (its
    default seed 42, ``argv``'s node count)."""
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticCitationDataset
    from gcnn_keras_tpu_torch.scripts import train_citation as tc
    from gcnn_keras_tpu_torch.training import graph_driver
    args = tc.parser().parse_args(list(argv) + ["--model", model])
    ds = SyntheticCitationDataset(num_nodes=args.nodes, seed=args.seed)
    batch, y, n_classes = tc.graph_inputs(ds, "cpu")
    train_mask, test_mask = tc.fold_masks(int(batch.node_mask.sum()), batch.n_node,
                                          args.folds, args.seed, "cpu")[0]
    cpu_model = tc.build_model(model, n_classes, graph_driver.input_widths(ds), "cpu")
    return (list(cpu_model.named_parameters()),
            tc.loss_fn(cpu_model, y, train_mask, test_mask), None)


def qm_cpu_step(script, model, argv=()):
    """``train_qm``'s model on the CPU with its loss (the recorded batch
    carries the fold's scaled labels)."""
    from gcnn_keras_tpu_torch.scripts import train_qm
    from gcnn_keras_tpu_torch.training import graph_driver
    widths = graph_driver.input_widths(train_qm.synthetic_dataset(1, 42))
    cpu_model = train_qm.build_model(model, widths, "cpu")
    return list(cpu_model.named_parameters()), train_qm.loss_fn(cpu_model), None


def crystal_cpu_step(script, model, argv=()):
    """``train_crystal``'s crystal model on the CPU with its loss."""
    from gcnn_keras_tpu_torch.scripts import train_crystal
    from gcnn_keras_tpu_torch.training import graph_driver
    widths = graph_driver.input_widths(train_crystal.synthetic_crystals(1, 42))
    cpu_model = train_crystal.build_model(model, widths, "cpu")
    return list(cpu_model.named_parameters()), train_crystal.loss_fn(cpu_model), None


def vgd_cpu_step(script, model, argv=()):
    """``train_visual_graph_dataset``'s MEGAN on the CPU with its loss, at
    the widths of ``argv``'s dataset."""
    from gcnn_keras_tpu_torch.scripts import train_visual_graph_dataset as tv
    from gcnn_keras_tpu_torch.training import graph_driver
    args = tv.parser().parse_args(list(argv) + ["--model", model])
    widths = graph_driver.input_widths(tv.load_dataset(args.dataset, 1, args.seed))
    cpu_model = tv.build_model(widths, "cpu")
    return list(cpu_model.named_parameters()), tv.loss_fn(cpu_model), None


# phase 28: the dataset layer. Each archive in its published layout,
# written by the writers below into a temporary dataset root (the port's
# ``data.download.DATASET_ROOT`` patched), where each class finds it
# without a fetch; a fetch of anything but a ``file://`` URL raises
# (``local_fetches_only``). Sizes: Cora at graph2gauss's published shape
# (19793 nodes, 8710 binary features about 18 a row, 65311 directed links,
# 70 classes); QM9 cut to 2048 molecules (133885) of 9-29 atoms over H, C,
# N, O, F; rMD17 aspirin cut to 1000 frames (100000) of its 21 atoms;
# MUTAG at its published counts (188 graphs, about 17.9 nodes and 19.8
# edges a graph, 7 node and 4 edge labels, graph labels 1 and -1).
CORA_SIZE = dict(nodes=19793, features=8710, links=65311, classes=70, per_row=18)
QM9_MOLECULES = 2048
RMD17_FRAMES = 1000
MUTAG_GRAPHS = 188
HYPER_CORA = os.path.join(HYPER_DIR, "hyper_cora.py")
HYPER_QM9 = os.path.join(HYPER_DIR, "hyper_qm9_energies.py")
HYPER_RMD17 = os.path.join(HYPER_DIR, "hyper_md17_revised.py")
# the runs' epochs: GCN 20 (the driver's 100) of 2 folds (5); SchNet on
# QM9 1 epoch (60) of 2 folds (3), on rMD17 2 epochs (50) of one fold (the
# driver's 3 at 5 folds' split); GIN on MUTAG 3 epochs (60) of 2 folds (3)
CORA_ARGS = ["--epochs", "20", "--folds", "2", "--no-plots", "--hyper", HYPER_CORA]
QM9_ARGS = ["--epochs", "1", "--folds", "2", "--no-plots", "--hyper", HYPER_QM9]
RMD17_ARGS = ["--epochs", "2", "--folds", "1", "--no-plots", "--hyper", HYPER_RMD17]
MUTAG_ARGS = ZOO_DRIVER_ARGS + ["--dataset", "MUTAG"]
# each dataset of the phase, built as the driver builds it, by the driver
# run whose first step on the CPU reads it (``DATASET_CACHE``)
DATASET_CACHE = {}


def dataset_folder(root, name):
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    return path


def write_cora_npz(root, nodes, features, links, classes, per_row, seed=0):
    """graph2gauss's ``Cora/cora.npz``: the adjacency and the binary
    attributes as scipy CSR triplets, and the labels. Three links in four
    join nodes of one class; half of each node's features come from a band
    of its class."""
    import scipy.sparse as sp
    rs = np.random.RandomState(seed)
    labels = rs.randint(classes, size=nodes)
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=classes)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src = rs.randint(nodes, size=2 * links)
    c = labels[src]
    same = order[starts[c] + (rs.rand(2 * links) * counts[c]).astype(np.int64)]
    dst = np.where(rs.rand(2 * links) < 0.75, same, rs.randint(nodes, size=2 * links))
    pairs = np.stack([src, dst], axis=1)[src != dst]
    _, first = np.unique(pairs, axis=0, return_index=True)
    pairs = pairs[np.sort(first)][:links]
    adj = sp.csr_matrix((np.ones(len(pairs), np.float32), (pairs[:, 0], pairs[:, 1])),
                        shape=(nodes, nodes))
    band = features // classes
    cols = rs.randint(features, size=(nodes, per_row))
    cols[:, :per_row // 2] = labels[:, None] * band + rs.randint(band, size=(nodes, per_row // 2))
    attr = sp.csr_matrix((np.ones(cols.size, np.float32),
                          (np.repeat(np.arange(nodes), per_row), cols.reshape(-1))),
                         shape=(nodes, features))
    attr.data[:] = 1.0
    np.savez(os.path.join(dataset_folder(root, "Cora"), "cora.npz"),
             adj_data=adj.data, adj_indices=adj.indices, adj_indptr=adj.indptr,
             adj_shape=np.array(adj.shape), attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=np.array(attr.shape), labels=labels)


def qm9_like_molecule(rs):
    """9 to 29 atoms: up to 9 of C, N, O, F on a random walk of 1.45 A
    bonds, the rest hydrogens 1.09 A from a random one of them."""
    n = rs.randint(9, 30)
    heavy = rs.choice([6, 7, 8, 9], size=min(9, max(1, int(round(0.45 * n)))),
                      p=[0.72, 0.12, 0.15, 0.01])
    steps = rs.randn(len(heavy), 3)
    pos = np.cumsum(1.45 * steps / np.linalg.norm(steps, axis=1, keepdims=True), axis=0)
    h_dirs = rs.randn(n - len(heavy), 3)
    h_pos = pos[rs.randint(len(heavy), size=n - len(heavy))] + \
        1.09 * h_dirs / np.linalg.norm(h_dirs, axis=1, keepdims=True)
    return np.concatenate([heavy, np.ones(n - len(heavy), np.int64)]), \
        np.concatenate([pos, h_pos])


QM9_COLUMNS = ["mol_id", "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
               "u0", "u298", "h298", "g298", "cv"]


def write_qm9_zip(root, n_mols, seed=0):
    """The deepchem ``QM9/qm9.zip``: ``gdb9.sdf`` (MDL V2000 records) and
    ``gdb9.sdf.csv`` with the release's header; ``u0`` in Hartree is the
    atoms' energies plus noise."""
    rs = np.random.RandomState(seed)
    atom_e = {1: -0.5, 6: -37.85, 7: -54.6, 8: -75.1, 9: -99.75}
    symbols = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}
    sdf, rows = [], [",".join(QM9_COLUMNS)]
    for i in range(n_mols):
        z, pos = qm9_like_molecule(rs)
        lines = [f"gdb_{i + 1}", "  synthetic 3D", "",
                 f"{len(z):3d}  0  0  0  0  0  0  0  0  0999 V2000"]
        lines += [f"{x:10.4f}{y:10.4f}{w:10.4f} {symbols[int(a)]:<3s} 0  0  0  0  0  0  0  0"
                  "  0  0  0  0" for a, (x, y, w) in zip(z, pos)]
        sdf.append("\n".join(lines + ["M  END", "$$$$"]) + "\n")
        u0 = sum(atom_e[int(a)] for a in z) + 0.05 * rs.randn()
        vals = list(np.round(rs.randn(10), 6)) + [u0, u0 + 0.01, u0 + 0.011, u0 - 0.03,
                                                    abs(rs.randn()) * 30]
        rows.append(f"gdb_{i + 1}," + ",".join(repr(float(v)) for v in vals))
    with zipfile.ZipFile(os.path.join(dataset_folder(root, "QM9"), "qm9.zip"), "w") as zf:
        zf.writestr("gdb9.sdf", "".join(sdf))
        zf.writestr("gdb9.sdf.csv", "\n".join(rows) + "\n")


def write_rmd17_npz(root, n_frames, seed=0):
    """Materials Cloud's ``MD17Revised.aspirin/rmd17_aspirin.npz``: aspirin's
    21 atoms (C9H8O4) in frames about one geometry, energies (kcal/mol) and
    forces, and the release's ``old_*`` keys."""
    rs = np.random.RandomState(seed)
    z = np.array([6] * 9 + [8] * 4 + [1] * 8, dtype=np.int64)
    rs.shuffle(z)
    base = np.cumsum(rs.randn(21, 3), axis=0) * 0.8
    coords = base + 0.05 * rs.randn(n_frames, 21, 3)
    energies = -406757.0 + 2.0 * rs.randn(n_frames)
    forces = 30.0 * rs.randn(n_frames, 21, 3)
    np.savez(os.path.join(dataset_folder(root, "MD17Revised.aspirin"), "rmd17_aspirin.npz"),
             nuclear_charges=z, coords=coords, energies=energies, forces=forces,
             old_indices=np.arange(n_frames), old_energies=energies + rs.randn(n_frames),
             old_forces=forces + rs.randn(n_frames, 21, 3))


def write_tu_zip(root, name, n_graphs, seed=0):
    """The TUDataset ``<name>/<name>.zip`` of ``n_graphs`` graphs at MUTAG's
    statistics: about 17.9 nodes and 19.8 undirected edges a graph (each
    both ways in ``_A.txt``, 1-based), 7 node labels, 4 edge labels, graph
    labels 1 (two in three) and -1."""
    rs = np.random.RandomState(seed)
    files = {k: [] for k in ("A", "graph_indicator", "graph_labels", "node_labels",
                             "edge_labels")}
    first = 1
    for g in range(n_graphs):
        n = int(np.clip(round(rs.normal(17.93, 4.6)), 10, 28))
        pairs = {(i, int(rs.randint(i))) for i in range(1, n)}
        while len(pairs) < n - 1 + int(round(rs.normal(0.104 * n, 1.0))):
            a, b = sorted(rs.randint(n, size=2))
            if a != b:
                pairs.add((int(b), int(a)))
        for a, b in sorted(pairs):
            label = str(rs.choice(4, p=[0.6, 0.05, 0.05, 0.3]))
            for s, t in ((a, b), (b, a)):
                files["A"].append(f"{first + s}, {first + t}")
                files["edge_labels"].append(label)
        files["graph_indicator"] += [str(g + 1)] * n
        files["node_labels"] += [str(v) for v in rs.choice(
            7, size=n, p=[0.72, 0.07, 0.15, 0.02, 0.02, 0.01, 0.01])]
        files["graph_labels"].append("1" if rs.rand() < 0.665 else "-1")
        first += n
    with zipfile.ZipFile(os.path.join(dataset_folder(root, name), f"{name}.zip"), "w") as z:
        for stem, lines in files.items():
            z.writestr(f"{name}/{name}_{stem}.txt", "\n".join(lines) + "\n")


def write_esol_csv(root):
    """MoleculeNet's ``ESOL/delaney-processed.csv`` with its published
    header, three molecules."""
    rows = ["Compound ID,ESOL predicted log solubility in mols per litre,Minimum Degree,"
            "Molecular Weight,Number of H-Bond Donors,Number of Rings,"
            "Number of Rotatable Bonds,Polar Surface Area,"
            "measured log solubility in mols per litre,smiles",
            "Ethanol,-0.7,1,46.069,1,0,0,20.23,-0.24,CCO",
            "Benzene,-2.0,2,78.114,0,1,0,0.0,-1.64,c1ccccc1",
            "Acetic acid,0.02,1,60.052,1,0,0,37.3,1.22,CC(=O)O"]
    with open(os.path.join(dataset_folder(root, "ESOL"), "delaney-processed.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


@contextlib.contextmanager
def local_fetches_only():
    """``urllib.request.urlretrieve`` refusing any URL but ``file://``: a
    dataset fetch that would leave the machine fails (``DownloadDataset``
    logs it) instead."""
    import urllib.request
    fetch = urllib.request.urlretrieve

    def local(url, *a, **kw):
        if not url.startswith("file://"):
            raise OSError(f"no fetch of {url}: the datasets are written locally")
        return fetch(url, *a, **kw)
    with patched(urllib.request, "urlretrieve", local):
        yield


def build_phase_dataset(key):
    """Dataset ``key`` of phase 28 as its driver builds it: a ``--hyper``
    config's dataset through ``deserialize`` (its methods run), or a
    ``--dataset`` TUDataset read in memory; cached in ``DATASET_CACHE``."""
    from gcnn_keras_tpu_torch.data.serial import deserialize
    from gcnn_keras_tpu_torch.scripts import train_tudataset
    from gcnn_keras_tpu_torch.training.hyper import HyperParameter
    model = {HYPER_CORA: "GCN", HYPER_QM9: "Schnet",
             HYPER_RMD17: "Schnet.EnergyForceModel"}.get(key)
    ds = deserialize(HyperParameter(key, model_name=model)["data"]["dataset"]) if model \
        else train_tudataset.load_dataset(key, 42)
    DATASET_CACHE[key] = ds
    return ds


def citation_hyper_cpu_step(script, model, argv=()):
    """``train_citation --hyper``'s model and first fold's loss on the CPU,
    on the dataset the phase built."""
    from gcnn_keras_tpu_torch.scripts import train_citation as tc
    from gcnn_keras_tpu_torch.training import graph_driver
    from gcnn_keras_tpu_torch.training.hyper import HyperParameter
    args = tc.parser().parse_args(list(argv) + ["--model", model])
    ds = DATASET_CACHE[args.hyper]
    batch, y, _ = tc.graph_inputs(ds, "cpu")
    train_mask, test_mask = tc.fold_masks(int(batch.node_mask.sum()), batch.n_node,
                                          args.folds, args.seed, "cpu")[0]
    cpu_model = graph_driver.build_hyper_model(HyperParameter(args.hyper, model_name=model),
                                               graph_driver.input_widths(ds), "cpu")
    return (list(cpu_model.named_parameters()),
            tc.loss_fn(cpu_model, y, train_mask, test_mask), None)


def qm_hyper_cpu_step(script, model, argv=()):
    """``train_qm --hyper``'s model on the CPU with its loss, at the widths
    of the dataset the phase built."""
    from gcnn_keras_tpu_torch.scripts import train_qm
    from gcnn_keras_tpu_torch.training import graph_driver
    from gcnn_keras_tpu_torch.training.hyper import HyperParameter
    path = argv[list(argv).index("--hyper") + 1]
    cpu_model = train_qm.build_model(model, graph_driver.input_widths(DATASET_CACHE[path]),
                                     "cpu", hyper=HyperParameter(path, model_name=model))
    return list(cpu_model.named_parameters()), train_qm.loss_fn(cpu_model), None


# each driver run: the module whose ``Trainer`` the phase records, its
# arguments, its CPU model and loss for the first step, and its script
ZOO_DRIVER_RUNS = {
    "train_tudataset": ("training.graph_driver", ZOO_DRIVER_ARGS, graph_driver_cpu_step,
                        "train_tudataset"),
    "train_moleculenet": ("training.graph_driver", ZOO_DRIVER_ARGS, graph_driver_cpu_step,
                          "train_moleculenet"),
    "train_force": ("scripts.train_force", FORCE_DRIVER_ARGS, force_driver_cpu_step,
                    "train_force"),
    "train_force_hyper": ("scripts.train_force", FORCE_DRIVER_ARGS + ["--hyper", HYPER_MD],
                          force_driver_cpu_step, "train_force"),
    "train_citation": ("scripts.train_citation", CITATION_ARGS, citation_cpu_step,
                       "train_citation"),
    "train_qm": ("training.graph_driver", QM_ARGS, qm_cpu_step, "train_qm"),
    "train_crystal": ("training.graph_driver", CRYSTAL_ARGS, crystal_cpu_step, "train_crystal"),
    "train_vgd_mock": ("scripts.train_visual_graph_dataset",
                       VGD_ARGS + ["--dataset", "VgdMockDataset"], vgd_cpu_step,
                       "train_visual_graph_dataset"),
    "train_vgd_rb_motifs": ("scripts.train_visual_graph_dataset",
                            VGD_ARGS + ["--dataset", "VgdRbMotifsDataset"], vgd_cpu_step,
                            "train_visual_graph_dataset"),
    "train_citation_cora": ("scripts.train_citation", CORA_ARGS, citation_hyper_cpu_step,
                            "train_citation"),
    "train_qm_qm9": ("training.graph_driver", QM9_ARGS, qm_hyper_cpu_step, "train_qm"),
    "train_force_rmd17": ("scripts.train_force", RMD17_ARGS, force_driver_cpu_step,
                          "train_force"),
    "train_tudataset_mutag": ("training.graph_driver", MUTAG_ARGS, graph_driver_cpu_step,
                              "train_tudataset"),
    # phase 30 (d): each rank of a launcher's group (phase_distributed_driver)
    "train_force_distributed": ("scripts.train_force", FORCE_DRIVER_ARGS + ["--distributed"],
                                force_driver_cpu_step, "train_force")}
# each script's folder under results/ where it is not the second word of its name
RESULTS_DIRS = {"train_visual_graph_dataset": "vgd"}


def driver_epochs(argv):
    """The ``--epochs`` of a driver's arguments."""
    return int(argv[list(argv).index("--epochs") + 1])


def run_zoo_driver(script, model, device="cuda"):
    """A driver's ``main`` with its arguments (``ZOO_DRIVER_RUNS``) on
    ``device`` in a scratch directory, every count set to 0 just before and
    read just after, its ``Trainer`` recording (``RecordingTrainer``).
    Returns the recorder, the score (None on a rank but 0 of a
    data-parallel run), the launch counts and the run's seconds."""
    module, argv, _, script_name = ZOO_DRIVER_RUNS[script]
    mod = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{script_name}")
    trained = importlib.import_module(f"gcnn_keras_tpu_torch.{module}")
    rec = RecordingTrainer(trained.Trainer)
    label = f"{script}_{model}"
    with tempfile.TemporaryDirectory(prefix="_zoo_driver_", dir=os.getcwd()) as workdir, \
            contextlib.chdir(workdir), patched(trained, "Trainer", rec.cls):
        # the main path: every count set to 0 just before, read just after
        reset_counts()
        t0 = time.perf_counter()
        score = mod.main(argv + ["--model", model, "--device", device])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernel_counts()
        path = f"results/{RESULTS_DIRS.get(script_name, script_name.split('_')[1])}/{model}_score"
        if score is not None and not (os.path.exists(path + ".yaml")
                                      or os.path.exists(path + ".json")):
            raise AssertionError(f"{label}: no score file {path}.yaml")
    return rec, score, launches, run_s


def phase_zoo_driver(script, model, smi, device="cuda"):
    """Phase 22 for one driver: ``run_zoo_driver``; then the score file,
    finite losses, the first step against the same step on the CPU (the
    driver's model, weights and batch; ``check_first_step_on_cpu``), its
    kernel calls against their plain versions and every later step's
    launches. Prints ms per step and per epoch. Returns the run's launch
    counts and the kernel records. ``device`` lets it run on the CPU."""
    _, argv, cpu_step, _ = ZOO_DRIVER_RUNS[script]
    label = f"{script}_{model}"
    rec, score, launches, run_s = run_zoo_driver(script, model, device)
    if not np.isfinite(score["loss"]).all():
        raise AssertionError(f"{label}: losses {score['loss']}")
    named_params, loss_fn, exact = cpu_step(script, model, argv)
    first = check_first_step_on_cpu(label, rec.first, named_params, loss_fn, TRAIN_TOL, exact)
    recs = kernel_call_records(rec.first["calls"], f"{label}, first step", label)
    out = {"script": script, "model": model, "card": smi, "args": argv,
           "steps": len(rec.steps) + 1, "launches_per_step": rec.check_steps(label),
           "ms_per_step": float(np.median([ms for _, ms, _ in rec.steps])),
           "ms_per_epoch": 1e3 * (score["epoch_time_mean"] if "epoch_time_mean" in score
                                  else np.mean(score["execute_time"]) / driver_epochs(argv)),
           "s_run": run_s,
           "losses": score["loss"], "first_step": first, "launches_run": launches}
    log(f"{label} driver: " + json.dumps(out))
    return {label: launches}, recs


# phase 25's kgcnn compatibility layer on the seed-0 request: its edge and
# node values COMPAT_WIDTH wide, the LSTM pool's units, its neighbour slots
COMPAT_WIDTH = 128
COMPAT_LSTM = dict(units=128, max_neighbors=32)
COMPAT_TOP_K = 0.3
# the segment-sums of one pass: PoolingLocalEdges' sum onto the receivers,
# PoolingNodes' onto the graphs, the MessagePassing subclass's; the sum of
# PoolingGlobalEdges onto the graphs is unsorted (``index_add_``)
COMPAT_LAUNCHES = 3


def compat_layers(generator):
    """The kgcnn names phase 25 runs, built from ``generator``: the pools
    of ``layers/pooling.py``, a ``MessagePassing`` subclass (a Dense of
    both ends and the edge values, relu, summed; a residual update),
    ``PoolingLocalEdgesLSTM`` and ``PoolingTopK``."""
    from gcnn_keras_tpu_torch.layers.message import MessagePassing
    from gcnn_keras_tpu_torch.layers.mlp import Dense
    from gcnn_keras_tpu_torch.layers.pool import PoolingLocalEdgesLSTM, PoolingTopK
    from gcnn_keras_tpu_torch.layers.pooling import (PoolingGlobalEdges, PoolingLocalEdges,
                                                     PoolingNodes)

    class Messages(MessagePassing):
        def __init__(self, units):
            super().__init__("sum")
            self.dense = Dense(3 * units, units, activation="relu", generator=generator)

        def message_function(self, x_i, x_j, edge_attr):
            return self.dense(torch.cat([x_i, x_j, edge_attr], dim=-1))

        def update_nodes(self, nodes, aggregated):
            return nodes + aggregated
    return {"PoolingLocalEdges": PoolingLocalEdges("segment_sum"),
            "PoolingNodes": PoolingNodes("sum"), "PoolingGlobalEdges": PoolingGlobalEdges("sum"),
            "MessagePassing": Messages(COMPAT_WIDTH),
            "PoolingLocalEdgesLSTM": PoolingLocalEdgesLSTM(COMPAT_WIDTH, **COMPAT_LSTM,
                                                           generator=generator),
            "PoolingTopK": PoolingTopK(COMPAT_WIDTH, k=COMPAT_TOP_K, generator=generator)}


# each compat layer's inputs after the batch, of the edge and node values
COMPAT_INPUTS = {"PoolingLocalEdges": lambda ev, nv: (ev,), "PoolingNodes": lambda ev, nv: (nv,),
                 "PoolingGlobalEdges": lambda ev, nv: (ev,),
                 "MessagePassing": lambda ev, nv: (nv, ev),
                 "PoolingLocalEdgesLSTM": lambda ev, nv: (ev,),
                 "PoolingTopK": lambda ev, nv: (nv,)}


def compat_calls(layers, batch, ev, nv):
    """Each layer of ``layers`` (``compat_layers``) on ``batch``'s edge
    values ``ev`` and node values ``nv``: ``{name: output}``
    (``PoolingTopK``'s its gated nodes, keep mask and scores)."""
    return {name: layer(batch, *COMPAT_INPUTS[name](ev, nv)) for name, layer in layers.items()}


def check_top_k(got, ref, graph_id):
    """``PoolingTopK`` on the card against the CPU: the same keep mask, or
    one that differs only at near ties (a node that changes side lies on
    the CPU within twice the largest score difference of the nearest score
    on the other side of its graph's cut); the gated nodes where the masks
    agree. Returns the record."""
    (gated, keep, score), (ref_gated, ref_keep, ref_score) = [
        [t.detach().cpu() for t in out] for out in (got, ref)]
    rec = {"nodes_differing": int((keep != ref_keep).sum())}
    if rec["nodes_differing"]:
        spread = float((score - ref_score).abs().max())
        gaps = []
        for i in (keep != ref_keep).nonzero()[:, 0].tolist():
            side = (graph_id == graph_id[i]) & (ref_score != 0) & (ref_keep != ref_keep[i])
            gaps.append(float((ref_score[side] - ref_score[i]).abs().min()))
        rec.update(max_gap=max(gaps), score_spread=spread)
        if not max(gaps) <= 2 * spread:
            raise AssertionError(f"PoolingTopK: keep masks differ beyond a near tie: {rec}")
    agree = keep == ref_keep
    rec["gated_rel_err"] = check_close("PoolingTopK gated", gated[agree], ref_gated[agree])
    rec["score_rel_err"] = check_close("PoolingTopK score", score, ref_score)
    return rec


def phase_compat(smi, timed_shapes, device="cuda", n_mols=512):
    """Phase 25's compatibility layer (``compat_layers``) on the seed-0
    request at ``COMPAT_WIDTH`` columns: each output against the CPU's on
    the same weights and values (``PoolingTopK`` by ``check_top_k``), every
    segment-sum call of one pass against its plain version (shapes not in
    ``timed_shapes`` timed), the pass's launches with every count set to 0
    just before and read just after, and each layer's ms. Returns the launch
    counts and the kernel records."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    t_start = time.perf_counter()
    cpu_batch = batch_graphs(labelled_mols(0, n_mols), device="cpu")
    batch = cpu_batch.to(device)
    rs = np.random.RandomState(25)
    ev_cpu = torch.from_numpy(rs.randn(batch.n_edge, COMPAT_WIDTH).astype(np.float32))
    nv_cpu = torch.from_numpy(rs.randn(batch.n_node, COMPAT_WIDTH).astype(np.float32))
    ev, nv = ev_cpu.to(device), nv_cpu.to(device)
    layers = {k: v.to(device) if isinstance(v, torch.nn.Module) else v
              for k, v in compat_layers(torch.Generator().manual_seed(0)).items()}
    with torch.no_grad():
        refs = compat_calls(compat_layers(torch.Generator().manual_seed(0)), cpu_batch,
                            ev_cpu, nv_cpu)
        with captured_calls() as calls:
            outs = compat_calls(layers, batch, ev, nv)
            torch.cuda.synchronize()
    counts = {k: len(v) for k, v in calls.items() if v}
    if counts != {"sorted_segment_sum": COMPAT_LAUNCHES}:
        raise AssertionError(f"compat layer: kernel calls {counts}, expected {COMPAT_LAUNCHES}")
    recs = zoo_kernel_calls(calls, "compat_pools", "compat_pools", timed_shapes)
    del calls
    rec = {"card": smi, "N_pad": batch.n_node, "E_pad": batch.n_edge, "G": batch.n_graphs,
           "width": COMPAT_WIDTH, **COMPAT_LSTM, "k": COMPAT_TOP_K}
    for name, out in outs.items():
        if name == "PoolingTopK":
            rec[name] = check_top_k(out, refs[name], cpu_batch.graph_id)
        else:
            rec[name] = {"rel_err": check_close(f"compat {name}", out.cpu(), refs[name])}
    with torch.no_grad():
        # the main path: every count set to 0 just before, read just after
        reset_counts()
        compat_calls(layers, batch, ev, nv)
        torch.cuda.synchronize()
        launches = kernel_counts()
        for name in outs:
            rec[name]["ms"] = synced_ms(lambda name=name: compat_calls(
                {name: layers[name]}, batch, ev, nv), 5)
    rec.update(launches=launches["sorted_segment_sum"], s_phase=time.perf_counter() - t_start)
    log("compat layer: " + json.dumps(rec))
    return {"compat_pools": launches}, recs


def phase_zoo(smi, profiles, timed_shapes, phase):
    """Phase 22, 23, 24, 25 or 27: each model of ``ZOO_MODELS`` in ``phase``
    (``phase_zoo_model``; a training step of each queued on ``profiles``
    for ``run_profiles``), then its drivers of ``ZOO_DRIVERS``
    (``phase_zoo_driver``), in phase 25 the compatibility layer
    (``phase_compat``), in phase 27 periodic MD (``phase_periodic_md``) and
    the fork's workflow chain (``phase_fork_chain``); the segment-sum
    shapes in ``timed_shapes`` are not timed again. Returns the launch
    counts of each main path and the kernel records by kernel."""
    by_path, recs = {}, []
    seconds = [time.perf_counter()]
    for name in [n for n, entry in ZOO_MODELS.items() if entry[2] == phase]:
        paths, rs = phase_zoo_model(name, smi, timed_shapes, profiles)
        by_path.update(paths)
        recs += rs
    seconds.append(time.perf_counter())
    for _, script, model in [d for d in ZOO_DRIVERS if d[0] == phase]:
        paths, rs = phase_zoo_driver(script, model, smi)
        by_path.update(paths)
        for name_rs in rs.values():
            recs += name_rs
    seconds.append(time.perf_counter())
    parts = ["models", "drivers"]
    if phase == 25:
        paths, rs = phase_compat(smi, timed_shapes)
        by_path.update(paths)
        recs += rs
        seconds.append(time.perf_counter())
        parts.append("compat")
    other = {}
    if phase == 27:
        for part, run in (("periodic_md", phase_periodic_md), ("workflow", phase_fork_chain)):
            paths, rs = run(smi)
            by_path.update(paths)
            for kname, krs in rs.items():
                other.setdefault(kname, []).extend(krs)
            seconds.append(time.perf_counter())
            parts.append(part)
    times = dict(zip(parts, np.diff(seconds).tolist()), total=seconds[-1] - seconds[0])
    log(f"phase {phase} seconds: " + json.dumps(times))
    other.setdefault("sorted_segment_sum", []).extend(recs)
    return by_path, other


# phase 27's periodic MD: SchNet's crystal model at its defaults (depth 4,
# 128 units) over train_crystal's first structures, each atom started at a
# seeded velocity of about 1 A per unit time (from rest its untrained forces
# would move no coordinate by a float32 ulp in these steps); the card's
# energies and positions against the CPU's, within MD_TOL of their scale
PERIODIC_MD_STRUCTURES = 64
PERIODIC_MD_SEGMENTS = 3
PERIODIC_MD_STEPS = 10
PERIODIC_MD_DT = 1e-3


def periodic_md_run(device, n_segments=PERIODIC_MD_SEGMENTS, segment_steps=PERIODIC_MD_STEPS):
    """``ScannedMD.run_ensemble`` of the crystal SchNet (seed-0 weights) over
    ``PERIODIC_MD_STRUCTURES`` periodic structures of ``train_crystal``,
    re-neighboured with ``set_range_periodic`` (4 A, 12) each segment;
    returns its output and the systems."""
    from gcnn_keras_tpu_torch.models.schnet import make_crystal_model
    from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
    from gcnn_keras_tpu_torch.scripts.train_crystal import synthetic_crystals
    rs = np.random.RandomState(0)
    systems = [{"node_number": g["node_number"], "node_coordinates": g["node_coordinates"],
                "graph_lattice": g["graph_lattice"],
                "velocities": rs.randn(len(g["node_number"]), 3).astype(np.float32)}
               for g in synthetic_crystals(PERIODIC_MD_STRUCTURES, seed=0)]
    md = ScannedMD(make_crystal_model(device=device, generator=torch.Generator().manual_seed(0)),
                   dt=PERIODIC_MD_DT, segment_steps=segment_steps, max_distance=4.0,
                   max_neighbours=12, device=device)
    return md.run_ensemble(systems, n_segments), systems


def image_distance(a, b, lattice):
    """The largest distance between ``a`` and ``b`` (n, 3) up to a lattice
    vector, so that an atom wrapped on the other side of the cell on one
    device counts by its true offset."""
    frac = (np.asarray(a, np.float64) - b) @ np.linalg.inv(np.asarray(lattice, np.float64))
    return float(np.abs((frac - np.round(frac)) @ lattice).max())


def phase_periodic_md(smi, device="cuda"):
    """Phase 27 (b): periodic ``ScannedMD`` (``periodic_md_run``) on the card,
    every count set to 0 just before and read just after: the launches of
    every evaluation (``segments * (steps + 1)`` SchNet evaluations), the
    energies and final positions against the CPU's, every kernel call of a
    one-step segment against its plain version, and the time per MD step.
    Returns the run's launch counts and the kernel records."""
    with captured_calls() as calls:
        periodic_md_run(device, n_segments=1, segment_steps=1)
    recs = {k: [dict(r, path="periodic_md") for r in rs]
            for k, rs in check_captured(calls, "periodic MD, one step").items()}
    torch.cuda.synchronize()
    # the main path: every count set to 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    with native_calls() as lists:
        out, systems = periodic_md_run(device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    evals = PERIODIC_MD_SEGMENTS * (PERIODIC_MD_STEPS + 1)
    want = {k: evals * v for k, v in schnet_launches("unfused").items()}
    if launches != want:
        raise AssertionError(f"periodic MD: launches {launches}, expected {want}")
    ref, _ = periodic_md_run("cpu")
    if not (np.isfinite(out["e_pot"]).all() and np.isfinite(out["e_kin"]).all()):
        raise AssertionError("periodic MD: energies not finite")
    e_err = float(np.abs(out["e_pot"] - ref["e_pot"]).max())
    e_scale = float(np.abs(ref["e_pot"]).max())
    pos_err = max(image_distance(p, r, s["graph_lattice"])
                  for p, r, s in zip(out["pos"], ref["pos"], systems))
    pos_scale = max(float(np.abs(s["graph_lattice"]).max()) for s in systems)
    if not (e_err <= MD_TOL * e_scale and pos_err <= MD_TOL * pos_scale):
        raise AssertionError(f"periodic MD: e_pot off the CPU's by {e_err} (scale {e_scale}), "
                             f"positions by {pos_err}")
    steps = PERIODIC_MD_SEGMENTS * PERIODIC_MD_STEPS
    log("periodic md: " + json.dumps({
        "structures": PERIODIC_MD_STRUCTURES, "segments": PERIODIC_MD_SEGMENTS,
        "segment_steps": PERIODIC_MD_STEPS, "edge_counts": out["edge_counts"],
        "e_pot_max_abs_err_vs_cpu": e_err, "e_pot_scale": e_scale,
        "pos_max_abs_err_vs_cpu": pos_err, "ms_per_step": 1e3 * seconds / steps,
        "launches_per_evaluation": schnet_launches("unfused"),
        "native_lists": lists["neighbor_list_periodic"], "card": smi}))
    return {"periodic_md": launches}, recs


# phase 27's fork workflow chain: SyntheticMDDataset frames as an extxyz
# file, prepare_data, one epoch of force_schnet (its three members) on the
# pickle, then each golden-IO harness recorded on the CPU and checked on the
# card on HARNESS_INPUTS molecules
WORKFLOW_FRAMES = 512
HARNESS_INPUTS = 16
HARNESS_ATOL = 1e-4  # the harnesses' default --atol


def write_extxyz(path, graphs):
    """Frames with their energies and forces as an extended-xyz file."""
    from gcnn_keras_tpu_torch.mol.io import PERIODIC_TABLE
    with open(path, "w") as f:
        for g in graphs:
            f.write(f"{len(g['node_number'])}\n")
            f.write(f"energy={float(g['energy'][0])!r} "
                    "Properties=species:S:1:pos:R:3:forces:R:3\n")
            for z, x, force in zip(g["node_number"], g["node_coordinates"], g["force"]):
                f.write(" ".join([PERIODIC_TABLE[int(z)]]
                                 + [repr(float(v)) for v in (*x, *force)]) + "\n")


def write_harness_inputs(prefix, graphs, esp=None):
    """``<prefix>NN.txt`` input files: ``z x y z`` rows, with an ESP column
    where ``esp`` gives one a graph."""
    for i, g in enumerate(graphs):
        with open(f"{prefix}{i:02d}.txt", "w") as f:
            f.write(f"{len(g['node_number'])}\n")
            for a, (z, x) in enumerate(zip(g["node_number"], g["node_coordinates"])):
                cols = [str(int(z))] + [repr(float(v)) for v in x]
                if esp is not None:
                    cols.append(repr(float(esp[i][a])))
                f.write(" ".join(cols) + "\n")


def harness_float64_gap(harness, script, argv):
    """The largest gap between a harness's float32 predictions on the CPU
    and the same predictions in float64 (``script``'s model and the batch),
    over energies, forces and charges."""
    import gcnn_keras_tpu_torch.batch as tb
    from gcnn_keras_tpu_torch.training import force_script
    f32 = harness.main(argv + ["--record", "--golden", "_f32.json", "--device", "cpu"])
    mod = force_script.script_module(script)
    build_batch, build_model = tb.batch_graphs, mod.build_model

    def double_batch(*a, **kw):
        return build_batch(*a, **kw)._map(lambda v: v.double() if v.is_floating_point() else v)

    def double_model(cfg, device=None):
        fm = build_model(cfg, device=device)
        fm.energy_model.double()
        return fm
    with patched(tb, "batch_graphs", double_batch), patched(mod, "build_model", double_model):
        f64 = harness.main(argv + ["--record", "--golden", "_f64.json", "--device", "cpu"])
    gap = 0.0
    for a, b in zip(f32["results"], f64["results"]):
        for key in ("energy", "force", "charge"):
            if key in a:
                gap = max(gap, float(np.abs(np.array(a[key]) - np.array(b[key])).max()))
    return gap


def harness_check(name, script, argv, smi, device):
    """A harness recorded on the CPU, then checked on the card inside
    ``captured_calls``, every count set to 0 just before and read just
    after, at ``HARNESS_ATOL`` or, where float32 cannot hold that at these
    values, ``ARBITER_FACTOR`` times the CPU's float32-to-float64 gap.
    Returns the record, the run's launch counts and the kernel records."""
    harness = importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")
    argv = argv + ["--script", script]
    gap = harness_float64_gap(harness, script, argv)
    atol = max(HARNESS_ATOL, ARBITER_FACTOR * gap)
    harness.main(argv + ["--record", "--device", "cpu"])
    torch.cuda.synchronize()
    with captured_calls() as calls:
        # the main path: every count set to 0 just before, read just after
        reset_counts()
        t0 = time.perf_counter()
        res = harness.main(argv + ["--device", device, "--atol", repr(atol)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel_counts()
    if not res["ok"]:
        raise AssertionError(f"{name}: the card's predictions miss the CPU's golden "
                             f"at --atol {atol}")
    recs = {k: [dict(r, path=name) for r in rs]
            for k, rs in check_captured(calls, f"{name} on the card").items()}
    rec = {"float64_gap_cpu": gap, "atol": atol, "s_check": seconds,
           "launches": {k: v for k, v in launches.items() if v}, "card": smi}
    return rec, launches, recs


def phase_fork_chain(smi, device="cuda"):
    """Phase 27 (c): the fork's workflow on the port, in a scratch
    directory: ``WORKFLOW_FRAMES`` frames of ``SyntheticMDDataset`` (seed 0)
    written as extxyz, ``prepare_data`` on it (the pickle's energies,
    forces and positions against the frames), one epoch of
    ``force_schnet`` (its three members, its widths) on that pickle through
    ``data_path`` (every count set to 0 just before, read just after), then
    ``test_model_force_schnet_painn`` on its checkpoint and
    ``test_model_force_hdnnp`` on a seed-0 ``force_hdnnp4th`` checkpoint,
    each recorded on the CPU and checked on the card (``harness_check``).
    Returns the launch counts of each run and the kernel records."""
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
    from gcnn_keras_tpu_torch.scripts import prepare_data
    from gcnn_keras_tpu_torch.training import force_script
    from gcnn_keras_tpu_torch.utils.checkpoint import save_checkpoint
    out, by_path, recs = {"card": smi}, {}, {}
    with tempfile.TemporaryDirectory(prefix="_fork_chain_", dir=os.getcwd()) as workdir, \
            contextlib.chdir(workdir):
        frames = SyntheticMDDataset(num_frames=WORKFLOW_FRAMES, seed=0)
        write_extxyz("frames.extxyz", frames)
        ds = prepare_data.main(["--extxyz", "frames.extxyz", "--out", "prepared"])
        for g, fr in zip(ds, frames):
            for key in ("energy", "force", "node_coordinates", "node_number"):
                if not np.array_equal(np.asarray(g[key]), np.asarray(fr[key])):
                    raise AssertionError(f"prepare_data: {key} differs from the frame's")
        mod = force_script.script_module("force_schnet")
        cfg = dict(force_script.load_config(mod, data_path="prepared/dataset.pickle"),
                   epochs=1, make_plots=False, device=device)
        reset_counts()
        t0 = time.perf_counter()
        force_script.run_force_training(mod.build_model, cfg)
        torch.cuda.synchronize()
        out["force_schnet_s"] = time.perf_counter() - t0
        by_path["fork_force_schnet"] = kernel_counts()
        write_harness_inputs("input_", frames[:HARNESS_INPUTS])
        out["schnet_harness"], by_path["fork_schnet_harness"], rs = harness_check(
            "test_model_force_schnet_painn", "force_schnet",
            ["--checkpoint", "model_schnet_force_0"], smi, device)
        for k, v in rs.items():
            recs.setdefault(k, []).extend(v)
        hmod = force_script.script_module("force_hdnnp4th")
        hcfg = force_script.load_config(hmod)
        save_checkpoint("hdnnp4th_seed0", hmod.build_model(
            hcfg, device="cpu", generator=torch.Generator().manual_seed(0)).energy_model)
        # the script's elements, and ESPs, drawn for the HDNNP4th inputs
        draw = np.random.RandomState(0)
        graphs = [dict(g, node_number=draw.choice(hcfg["elements"], size=len(g["node_number"])))
                  for g in frames[:HARNESS_INPUTS]]
        write_harness_inputs("hdnnp_input_", graphs,
                             esp=[draw.randn(len(g["node_number"])) * 0.01 for g in graphs])
        out["hdnnp_harness"], by_path["fork_hdnnp_harness"], rs = harness_check(
            "test_model_force_hdnnp", "force_hdnnp4th",
            ["--checkpoint", "hdnnp4th_seed0", "--inputs", "hdnnp_input_*.txt",
             "--golden", "hdnnp_output.json"], smi, device)
        for k, v in rs.items():
            recs.setdefault(k, []).extend(v)
    out["force_schnet_launches"] = {k: v for k, v in by_path["fork_force_schnet"].items() if v}
    log("fork chain: " + json.dumps(out))
    return by_path, recs


def phase_datasets(smi, device="cuda", sizes=None):
    """Phase 28: the dataset layer, in a temporary dataset root (the port's
    ``DATASET_ROOT`` patched; no fetch leaves the machine). Writes the
    archives (``write_cora_npz``, ``write_qm9_zip``, ``write_rmd17_npz``,
    ``write_tu_zip``, ``write_esol_csv``; ``sizes`` overrides their sizes),
    builds each dataset as its driver does and times it apart from
    training (unpack, parse, the config's methods; the archive is in
    place, so nothing is fetched), times the full Cora graph's batch onto
    ``device`` (``train_citation.graph_inputs``), then runs the drivers of
    ``ZOO_DRIVERS``' phase-28 rows (``phase_zoo_driver``: the first step
    against the CPU within ``TRAIN_TOL``, every #1 call against its plain
    version, every step's launches). Then no fallback: a dataset whose
    file is missing (``CoraLuDataset``) raises ``FileNotFoundError``, and
    ``ESOLDataset`` reads its CSV and, without RDKit, raises its
    ``ImportError``. Returns the launch counts of each run and the kernel
    records."""
    import importlib.util
    from gcnn_keras_tpu_torch.data import download
    from gcnn_keras_tpu_torch.data.datasets.citation import CoraLuDataset
    from gcnn_keras_tpu_torch.data.datasets.moleculenet import ESOLDataset
    from gcnn_keras_tpu_torch.scripts import train_citation
    sizes = dict(dict(cora=CORA_SIZE, qm9=QM9_MOLECULES, rmd17=RMD17_FRAMES,
                      mutag=MUTAG_GRAPHS), **(sizes or {}))
    out, by_path, recs = {"card": smi, "sizes": sizes}, {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="_datasets_", dir=os.getcwd()) as root, \
            patched(download, "DATASET_ROOT", root), local_fetches_only():
        t0 = time.perf_counter()
        write_cora_npz(root, **sizes["cora"])
        write_qm9_zip(root, sizes["qm9"])
        write_rmd17_npz(root, sizes["rmd17"])
        write_tu_zip(root, "MUTAG", sizes["mutag"])
        write_esol_csv(root)
        out["write_s"] = time.perf_counter() - t0
        build = {}
        for label, key in (("Cora", HYPER_CORA), ("QM9", HYPER_QM9),
                           ("MD17Revised.aspirin", HYPER_RMD17), ("MUTAG", "MUTAG")):
            t0 = time.perf_counter()
            ds = build_phase_dataset(key)
            build[label] = {"host_s": time.perf_counter() - t0, "graphs": len(ds),
                            "nodes": int(sum(len(g["node_number"]) if "node_number" in g
                                             else len(g["node_attributes"]) for g in ds))}
        cora = DATASET_CACHE[HYPER_CORA][0]
        build["Cora"].update(features=int(cora["node_attributes"].shape[1]),
                             edges=int(len(cora["edge_indices"])))
        t0 = time.perf_counter()
        batch, _, _ = train_citation.graph_inputs(DATASET_CACHE[HYPER_CORA], device)
        torch.cuda.synchronize()
        build["Cora"]["graph_inputs_s"] = time.perf_counter() - t0
        del batch
        out["build"] = build
        log("datasets: " + json.dumps(out))
        for _, script, model in [d for d in ZOO_DRIVERS if d[0] == 28]:
            paths, rs = phase_zoo_driver(script, model, smi, device)
            by_path.update(paths)
            for kname, krs in rs.items():
                recs.setdefault(kname, []).extend(krs)
        try:
            CoraLuDataset().read_in_memory()
        except FileNotFoundError:
            pass
        else:
            raise AssertionError("CoraLuDataset built without its file")
        esol = ESOLDataset()
        if importlib.util.find_spec("rdkit") is None:  # as on the card's machine
            try:
                esol.read_in_memory()
            except ImportError as e:
                if "rdkit is required" not in str(e):
                    raise
            else:
                raise AssertionError("ESOLDataset built its graphs without RDKit")
            if len(esol.table) != 3 or len(esol):
                raise AssertionError(f"ESOL: {len(esol.table)} rows read, {len(esol)} graphs")
        else:
            esol.read_in_memory()
            if len(esol) != 3:
                raise AssertionError(f"ESOL: {len(esol)} graphs of 3 SMILES")
    DATASET_CACHE.clear()
    log(f"phase 28 seconds: {time.perf_counter() - t_phase:.1f}")
    return by_path, recs

def bessel_per_order(x):
    """The spherical basis's radial part as the JAX package computes it
    (``models/dimenet_pp.py``): ``spherical_bessel_jn_all`` of each order's
    arguments ``x[..., l, :]``, order ``l`` taken."""
    from gcnn_keras_tpu_torch.ops.polynom import spherical_bessel_jn_all
    n = x.shape[-2]
    return torch.stack([spherical_bessel_jn_all(x[..., l, :], n)[..., l] for l in range(n)],
                       dim=-2)


def phase_bessel_forms(smi, device="cuda", n_mols=512, reps=3):
    """What the radial part's one recursion over all orders
    (``spherical_bessel_jn_diagonal``) saves against ``bessel_per_order``:
    the force steps of DimeNet++ and MXMNet on phase 24's batches with each,
    in turns (one, the other, the other, the one), each a fresh trainer, one
    step untimed, then the median ms of ``reps`` and the peak MB; the first
    losses agree within ``TRAIN_TOL``. Returns the records."""
    from gcnn_keras_tpu_torch.models import dimenet_pp
    out = {}
    for name in ("DimeNetPP", "MXMNet"):
        batch, rec = zoo_batch(name, device, n_mols=n_mols), {}
        for form in ("diagonal", "per_order", "per_order", "diagonal"):
            fn = bessel_per_order if form == "per_order" \
                else dimenet_pp.spherical_bessel_jn_diagonal
            with patched(dimenet_pp, "spherical_bessel_jn_diagonal", fn):
                _, trainer, state = zoo_trainer(name, device)
                loss = float(trainer.step(state, batch)[1]["loss"])
                reset_peak(device)
                ms = synced_ms(lambda: trainer.step(state, batch), reps)
            rec.setdefault(form, []).append({"ms": ms, "loss": loss,
                                             "peak_mb": peak_mb(device)})
        losses = [r["loss"] for rs in rec.values() for r in rs]
        if not max(losses) - min(losses) <= TRAIN_TOL * abs(losses[0]):
            raise AssertionError(f"{name} Bessel forms: first losses {losses}")
        out[name] = rec
    log("Bessel forms: " + json.dumps({"card": smi, "n_mols": n_mols, **out}))
    return out


# ------------------------------------------- phase 26: the fast force step

# The fast step's paths: phase 10's paths and seed-0 weights, each also
# timed as a Trainer step of the same loss (reverse over reverse). Launches
# a step, derived: pass 1 (the forces) is one evaluation; the surrogate's
# forward runs each kernel of the energy pass on the primal and once more on
# its tangent where its input carries one (the Function's jvp); the reverse
# pass over the surrogate runs the backward of both.
# - SchNet: evaluation 10; forward 4 edge pools and the graph pool, each
#   again on its tangent (10); reverse the transposes of the sender gathers
#   of interactions 0-3 (the energy term, as the Trainer step's) and of the
#   tangents' sender gathers in interactions 1-3 (7). Trainer step 19.
# - fused: evaluation 4 gms + 6; forward 4 gms and the graph pool on the
#   primals, 7 gms on tangents (the filter's in each interaction, the node
#   features' in 1-3) and the pool's tangent; reverse ct_x of the 11 gms
#   applications (11 segment-sums; ct_m is gathers). Trainer step 4 gms +
#   19 (the fused mode's evaluation and its ct_x in the loss pass).
# - remat: the SchNet step and pass 1's reverse rerunning the 4
#   checkpointed edge pools; the surrogate runs unchecked
#   (models/schnet.py). Trainer step schnet_launches' remat step.
# - PAiNN: evaluation 13; forward 7 pools, each again on its tangent (14);
#   reverse the Trainer step's 5 sender-gather transposes of the energy
#   term and 4 of the tangents' (dphi and dv in convs 1-2). Trainer step 25.
# - HDNNP2nd: evaluation the G2 and G4 fwd and vjp kernels and 1
#   segment-sum; forward the fwd kernels on the positions, the jvp kernels on
#   their tangent, the graph pool and its tangent; the reverse pass reaches
#   no kernel (the descriptors' tangent depends on no parameter).
# - HDNNP4th: evaluation as HDNNP2nd's with 2 SPD solves and 5 segment-
#   sums; forward 3 segment-sums and 1 solve, each again on its tangent
#   (SPDSolve.jvp: one more solve), and the ACSF kernels as HDNNP2nd's;
#   reverse 4 segment-sums and 2 solves (the backward of the primal and of
#   the tangent solve). Trainer step that path's (7 and 4), which the
#   charge term and the ESP coupling leave as they are.
_ACSF_FAST = dict(g2_fwd=2, g4_fwd=2, g2_vjp=1, g4_vjp=1, g2_jvp=1, g4_jvp=1)
FAST_PATHS = {
    "schnet_fast": dict(path="schnet_train", fast=launch_counts(sorted_segment_sum=27),
                        trainer=schnet_launches("unfused", train=True)),
    "schnet_fused_fast": dict(path="schnet_train", mode="fused",
                              fast=launch_counts(gather_mul_segsum=15, sorted_segment_sum=19),
                              trainer=launch_counts(gather_mul_segsum=4,
                                                    sorted_segment_sum=19)),
    "schnet_remat_fast": dict(path="schnet_train", model_kw={"remat": True},
                              fast=launch_counts(sorted_segment_sum=31),
                              trainer=schnet_launches("unfused", remat=True, train=True)),
    "painn_fast": dict(path="painn_train", fast=launch_counts(sorted_segment_sum=36),
                       trainer=launch_counts(sorted_segment_sum=25)),
    "hdnnp2nd_fast": dict(path="hdnnp2nd_train",
                          fast=launch_counts(sorted_segment_sum=3, **_ACSF_FAST),
                          trainer=TRAIN_PATHS["hdnnp2nd_train"]["launches"]),
    "hdnnp4th_fast": dict(path="hdnnp4th_train",
                          fast=launch_counts(sorted_segment_sum=15, spd_solve=6, **_ACSF_FAST),
                          trainer=TRAIN_PATHS["hdnnp4th_train"]["launches"]),
}
FAST_STEPS = 6  # each step kind: a warm-up, then the median of 5
# the SchNet modes whose kernels are reverse mode only (a custom_vjp in the
# JAX package), with the name each error must give
REVERSE_ONLY_MODES = {"fused_aggregate": {"fused_aggregate": "vjp"},
                      "accurate_cfconv": {"accurate_cfconv": True},
                      "fused_chain": {"fused_chain": True}}


def fast_model(name, device):
    """The ``EnergyForceModel`` of fast path ``name``: its training path's
    model and seed-0 weights, forces without ESP coupling."""
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    cfg = FAST_PATHS[name]
    fm = energy_force_model(TRAIN_PATHS[cfg["path"]]["model"], device,
                            cfg.get("mode", "unfused"), **cfg.get("model_kw", {}))
    return EnergyForceModel(fm.energy_model, device=device)


def fast_loss_fn(fmodel, force_weight):
    """The fast step's loss, ``E_MAE + force_weight * F_MAE``, reverse over
    reverse (the forces with ``create_graph``), with its metrics."""
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae, masked_node_mae

    def loss_fn(b):
        out = fmodel.apply(b, create_graph=True)
        e = masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
        f = force_weight * masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
        return e + f, {"energy_loss": e.detach(), "force_loss": f.detach()}
    return loss_fn


def fast_step(name, device, kind):
    """``(model, step, state)`` of fast path ``name`` on the seed-0 weights,
    ``step(state, batch) -> (state, loss, metrics)``: the fast step
    (``make_force_train_step``, ``kind="fast"``) or the ``Trainer`` step of
    the same loss (``kind="trainer"``), each with ``torch.optim.Adam`` (lr
    1e-3)."""
    from gcnn_keras_tpu_torch.training import Trainer
    from gcnn_keras_tpu_torch.training.fast_force_step import make_force_train_step
    force_weight = TRAIN_PATHS[FAST_PATHS[name]["path"]]["force_weight"]
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    fm = fast_model(name, device)
    if kind == "fast":
        step = make_force_train_step(fm.energy_model, adam, force_weight=force_weight)
        return fm.energy_model, step, step.init_state()
    trainer = Trainer(fast_loss_fn(fm, force_weight), adam)

    def trainer_step(state, batch):
        state, metrics = trainer.step(state, batch)
        return state, metrics["loss"], metrics
    return fm.energy_model, trainer_step, trainer.init_state(fm.energy_model.parameters())


def step_record(model, loss, metrics):
    """A step's loss, metrics and each parameter's gradient, on the CPU."""
    return (float(loss), {k: float(metrics[k]) for k in ("energy_loss", "force_loss")},
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
             if p.requires_grad})


def compare_steps(label, got, ref, loss_tol, grad_tol):
    """Two ``step_record``s: the loss and each metric within ``loss_tol``
    of the reference's, each gradient within ``grad_tol`` of that tensor's
    largest reference entry (``check_grads``)."""
    for key, a, b in (("loss", got[0], ref[0]), *((k, got[1][k], ref[1][k]) for k in ref[1])):
        if not abs(a - b) <= loss_tol * abs(b):
            raise AssertionError(f"{label}: {key} {a} against {b}")
    worst, _ = check_grads(label, got[2], ref[2], grad_tol)
    return {"loss": got[0], "loss_ref": ref[0], **{k: got[1][k] for k in got[1]},
            "params": len(ref[2]), "max_rel_grad_err": worst}


def phase_fast_step(name, smi, profiles=None, device="cuda", size=None, first=(2, 64),
                    steps=FAST_STEPS):
    """Phase 26 for one fast path: the first fast step against the CPU's on
    the first-step batch; one fast step against one ``Trainer`` step on the
    path's full batch (``size`` molecules of its seed instead, where given)
    from the same weights; then ``steps`` steps of each, every step's
    launches against the derived counts, the ms a step; given
    ``profiles``, a step of each queued for ``run_profiles``. Returns the
    launches of each main path, ``{"<name>_step": ..., "<name>_trainer":
    ...}``."""
    cfg = FAST_PATHS[name]
    path = cfg["path"]
    base = TRAIN_PATHS[path]
    loss_tol, grad_tol = base.get("loss_tol", TRAIN_TOL), base.get("grad_tol", TRAIN_TOL)
    firsts = {}
    for dev in dict.fromkeys((device, "cpu")):  # once where device is the CPU
        model, step, state = fast_step(name, dev, "fast")
        _, loss, metrics = step(state, train_batch(path, *first, dev))
        firsts[dev] = step_record(model, loss, metrics)
    rec = {"path": name, "card": smi, "first_step_against_cpu": compare_steps(
        f"{name} first fast step, {device} against the CPU", firsts[device], firsts["cpu"],
        loss_tol, grad_tol)}
    batch = full_batch(path, device) if size is None \
        else train_batch(path, base["seed"], size, device)
    rec.update(size=size or base["size"], N_pad=batch.n_node, E_pad=batch.n_edge,
               G=batch.n_graphs)
    firsts, by_path = {}, {}
    for kind in ("fast", "trainer"):
        model, step, state = fast_step(name, device, kind)
        reset_counts()
        times, per_step = [], []
        for i in range(steps):
            before = kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            per_step.append({k: v - before[k] for k, v in kernel_counts().items()})
            if i == 0:
                firsts[kind] = step_record(model, loss, metrics)
        for i, counts in enumerate(per_step):
            if counts != cfg[kind]:
                raise AssertionError(f"{name} {kind} step {i}: launches {counts}, "
                                     f"expected {cfg[kind]}")
        by_path[f"{name}_{'step' if kind == 'fast' else 'trainer'}"] = kernel_counts()
        rec[f"{kind}_ms_per_step"] = float(np.median(times[1:]))
        rec[f"{kind}_ms_first_step"] = times[0]
        rec[f"{kind}_launches_per_step"] = {k: v for k, v in cfg[kind].items() if v}
        if profiles is not None:
            profiles.append((f"{name} {kind} step",
                             lambda step=step, state=state: step(state, batch)))
    rec["fast_against_trainer"] = compare_steps(
        f"{name} fast step against the Trainer step", firsts["fast"], firsts["trainer"],
        loss_tol, grad_tol)
    rec["speedup"] = rec["trainer_ms_per_step"] / rec["fast_ms_per_step"]
    log(f"{name} fast step: " + json.dumps(rec))
    return by_path


def check_jvp_rule(label, fn, plain, primals, tangents, tol, expected):
    """The tangent of ``fn(*primals)`` along ``tangents`` (None: none) through
    the kernel Functions' ``jvp`` against forward-mode AD of ``plain`` on
    the same inputs: ``max|kernel - plain| <= tol * (1 + max|plain|)``; the
    kernel calls of the dual evaluation must be ``expected`` (the primal's
    and the tangent's)."""
    import torch.autograd.forward_ad as fwAD

    def tangent(f):
        with fwAD.dual_level():
            duals = [p if t is None else fwAD.make_dual(p, t) for p, t in zip(primals, tangents)]
            return fwAD.unpack_dual(f(*duals)).tangent

    with captured_calls() as calls:
        got = tangent(fn)
    counts = {k: len(c) for k, c in calls.items() if c}
    if counts != expected:
        raise AssertionError(f"jvp {label}: kernel calls {counts}, expected {expected}")
    ref = tangent(plain)
    err, scale = (got - ref).abs().max().item(), 1.0 + ref.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol * scale):
        raise AssertionError(f"jvp {label}: max|kernel-plain|={err} > {tol}*{scale}")
    rec = {"case": label, "shape": list(got.shape), "max_abs_err": err, "tol": tol * scale,
           "kernel_calls": counts}
    log("jvp rule: " + json.dumps(rec))
    return rec


def phase_jvp_rules(device="cuda", sizes=None):
    """Each kernel Function's ``jvp`` against forward-mode AD of its plain
    version at a training path's shapes (``sizes``: molecules per path
    instead of the full batches): the segment-sum (#1) and gms (#2b) at
    ``schnet_train``'s edge pool, the G4 (#9 as the tangent of #8) and G2
    (#12 of #11) descriptors at ``hdnnp2nd_train``'s, and the SPD solve
    (#3a) at ``hdnnp4th_train``'s Qeq system."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import bilinear as kb
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    sizes = sizes or {}

    def batch_of(path):
        cfg = TRAIN_PATHS[path]
        return train_batch(path, cfg["seed"], sizes.get(path, cfg["size"]), device)

    gen = torch.Generator(device=device).manual_seed(26)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    recs = []
    b = batch_of("schnet_train")
    e, n, f = b.n_edge, b.n_node, 128
    recv, send = b.receivers.to(torch.int32), b.senders.to(torch.int32)
    perm = b.edges["sender_perm"].to(torch.int32)
    recs.append(check_jvp_rule(
        f"sorted_segment_sum, schnet_train edge pool ({e}, {f}) -> {n}",
        lambda v: ss.SortedSegmentSum.apply(v, recv, n),
        lambda v: ss.segment_sum_plain(v, recv, n), [rand(e, f)], [rand(e, f)], KERNEL_TOL,
        {"sorted_segment_sum": 2}))
    recs.append(check_jvp_rule(
        f"gather_mul_segsum (GMS), schnet_train ({n}, {f}) x ({e}, {f})",
        lambda x, m: kb.gms(x, m, send, recv, perm),
        lambda x, m: fa.fused_gather_mul_segsum_plain(x, m, send, recv, n),
        [rand(n, f), rand(e, f)], [rand(n, f), rand(e, f)], KERNEL_TOL,
        {"gather_mul_segsum": 3}))
    b = batch_of("hdnnp2nd_train")
    model = energy_force_model("hdnnp2nd", device).energy_model
    for kind in ("g4", "g2"):
        (pos, *rest), _ = acsf_args(f"{kind}_fwd", b)
        st = getattr(model, f"acsf_{kind}")._static
        fn = ka.G4Fn.apply if kind == "g4" else ka.G2Fn.apply
        plain = getattr(ka, f"{kind}_forward_plain")
        recs.append(check_jvp_rule(
            f"acsf {kind}_jvp as the tangent of {kind}_fwd, hdnnp2nd_train ({b.n_node} atoms)",
            lambda p, fn=fn: fn(p, *rest, st), lambda p, plain=plain: plain(p, *rest, st),
            [pos], [rand(*pos.shape)], ACSF_VJP_TOL, {f"{kind}_fwd": 1, f"{kind}_jvp": 1}))
    b = batch_of("hdnnp4th_train")
    model = energy_force_model("hdnnp4th", device).energy_model
    a, rhs, *_ = qeq_system(model, b)
    half = rand(*a.shape)
    recs.append(check_jvp_rule(
        f"spd_solve, hdnnp4th_train Qeq system {list(a.shape)} x {rhs.shape[2]}",
        ks.SPDSolve.apply, ks.spd_solve_plain, [a, rhs],
        [0.1 * (half + half.transpose(1, 2)), rand(*rhs.shape)], SPD_TOL, {"spd_solve": 2}))
    return recs


def phase_reverse_only(device="cuda", n_mols=16):
    """Forward mode through SchNet's reverse-only modes raises
    ``NotImplementedError`` naming the mode: the fast step of each on
    ``n_mols`` molecules of ``schnet_train``'s kind."""
    from gcnn_keras_tpu_torch.training.fast_force_step import energy_force_value_and_grad
    batch = train_batch("schnet_train", 2, n_mols, device)
    for mode, inter in REVERSE_ONLY_MODES.items():
        model = schnet_model("unfused", device, interaction_args=inter)
        try:
            energy_force_value_and_grad(model)(batch)
        except NotImplementedError as err:
            if mode not in str(err):
                raise AssertionError(f"forward mode through {mode}: {err}") from err
            log(f"reverse-only {mode}: raises NotImplementedError naming it")
            continue
        raise AssertionError(f"forward mode through {mode} did not raise")


# ------------------------------------------- phase 29: slice 19


# (a) the C++ neighbour lists at phase 18's 520 and 2080 atoms (its
# set_range cutoff, 3.5 A and 12 neighbours) and on a periodic cell above
# the 192-atom switch (a 6 x 6 x 6 simple-cubic cell 2 A apart, jittered so
# that no cap cuts a tie; phase 27's 4 A and 12 neighbours), each against
# the dense numpy lists on the same coordinates, timed in turns; then
# SchNet at make_model()'s widths in ScannedMD over a 288-atom helix
# (md_system) whose re-neighbouring takes "auto", and so the C++ list,
# every segment, started at seeded velocities as phase 27's crystals
NATIVE_MOL_SIZES = MOL_SIZES[1:]
NATIVE_MOL_KW = dict(max_distance=3.5, max_neighbours=12)
NATIVE_CELL, NATIVE_SPACING = 6, 2.0
NATIVE_PERIODIC_KW = dict(max_distance=4.0, max_neighbours=12)
NATIVE_REPS = 5
NATIVE_DIST_RTOL = 1e-6
NATIVE_MD_ATOMS = 288
NATIVE_MD_SEGMENTS = 3
NATIVE_MD_STEPS = 10
# (b) GNNExplainer at its defaults (100 epochs, Adam 1e-2, a feature mask
# over the 1433 features) on phase 10's GCN at Cora scale (GCN_CORA_KW,
# seed-0 weights, gcn_cora_train's citation graph); (c) the ASE bridge
# through the SchNet and HDNNP4th serving models, on a stand-in Atoms of the
# seed-0 request's first molecule
ASE_PREDICTORS = ("schnet", "hdnnp4th")


def native_cell(n=NATIVE_CELL, spacing=NATIVE_SPACING, seed=0):
    """A periodic cell of ``n**3`` atoms on a jittered simple-cubic grid."""
    rs = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n) * spacing] * 3, indexing="ij"), -1)
    return {"node_coordinates": grid.reshape(-1, 3) + rs.randn(n ** 3, 3) * 0.1,
            "graph_lattice": np.eye(3) * n * spacing}


@contextlib.contextmanager
def native_calls():
    """Inside the block, the calls of the C++ neighbour lists; yields
    ``{"neighbor_list": n, "neighbor_list_periodic": n}``."""
    from gcnn_keras_tpu_torch import native
    counts = {"neighbor_list": 0, "neighbor_list_periodic": 0}
    originals = {name: getattr(native, name) for name in counts}

    def counted(name):
        def fn(*args, **kwargs):
            counts[name] += 1
            return originals[name](*args, **kwargs)
        return fn
    for name in counts:
        setattr(native, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(native, name, fn)


def phase_native_lists(smi, sizes=NATIVE_MOL_SIZES, cell=NATIVE_CELL):
    """Phase 29 (a): the C++ lists, built by the port's loader (the phase
    fails without them), against the dense lists: equal indices and images,
    distances within ``NATIVE_DIST_RTOL``; the host ms of each backend,
    measured in turns."""
    from gcnn_keras_tpu_torch import native
    from gcnn_keras_tpu_torch.graph.preprocess import set_range, set_range_periodic
    if not native.available():
        raise AssertionError("phase 29: the C++ neighbour list did not build")
    systems = [(f"molecule_{n}", set_range, {"node_coordinates": large_mol_graph(n)[
        "node_coordinates"]}, NATIVE_MOL_KW, ("range_indices",)) for n in sizes]
    systems.append((f"periodic_{cell ** 3}", set_range_periodic, native_cell(cell),
                    NATIVE_PERIODIC_KW, ("range_indices", "range_image")))
    rec = {"openmp": native.has_openmp(), "card": smi}
    for label, fn, g, kw, keys in systems:
        times, out = {"native": [], "numpy": []}, {}
        for _ in range(NATIVE_REPS):
            for backend in times:
                t0 = time.perf_counter()
                with native_calls() as calls:
                    out[backend] = fn(dict(g), backend=backend, **kw)
                times[backend].append(1e3 * (time.perf_counter() - t0))
                if any(calls.values()) != (backend == "native"):
                    raise AssertionError(f"{label}: backend {backend} took {calls}")
        for key in keys:
            if not np.array_equal(out["native"][key], out["numpy"][key]):
                raise AssertionError(f"{label}: native {key} differs from the dense list's")
        d_nat, d_ref = out["native"]["range_attributes"], out["numpy"]["range_attributes"]
        err = float(np.abs(d_nat / d_ref - 1).max()) if len(d_ref) else 0.0
        if not (d_nat.dtype == d_ref.dtype == np.float32 and err <= NATIVE_DIST_RTOL):
            raise AssertionError(f"{label}: distances {err} > {NATIVE_DIST_RTOL} relative")
        ms = {k: float(np.median(v)) for k, v in times.items()}
        rec[label] = {"atoms": len(g["node_coordinates"]), "pairs": len(d_ref),
                      "native_host_ms": ms["native"], "numpy_host_ms": ms["numpy"],
                      "numpy_over_native": ms["numpy"] / ms["native"],
                      "dist_max_rel_err": err}
    log("native lists: " + json.dumps(rec))


def native_md_run(device, n_segments=NATIVE_MD_SEGMENTS, segment_steps=NATIVE_MD_STEPS,
                  n_atoms=NATIVE_MD_ATOMS):
    """``ScannedMD.run_ensemble`` of SchNet at ``make_model()``'s widths
    (seed-0 weights) over a helix of ``n_atoms`` atoms from seeded
    velocities, re-neighboured by ``set_range`` (4 A, 25; ``"auto"``) each
    segment; returns its output and the system."""
    from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
    rs = np.random.RandomState(7)
    system = md_system(rs, n_atoms, np.arange(n_atoms) * 1.2)
    system["velocities"] = rs.randn(n_atoms, 3).astype(np.float32)
    md = ScannedMD(schnet_model("unfused", device), dt=MD_DT, segment_steps=segment_steps,
                   max_distance=4.0, max_neighbours=25, device=device)
    return md.run_ensemble([system], n_segments), system


def phase_native_md(smi, device="cuda", n_atoms=NATIVE_MD_ATOMS):
    """Phase 29 (a): ``native_md_run`` on the card, every count set to 0 just
    before and read just after: a C++ list each segment, the launches of
    every evaluation (``segments * (steps + 1)``), the energies and final
    positions against the CPU's within ``MD_TOL`` of their scale (the
    positions' their displacement), every kernel call of a one-step segment
    against its plain version, the time per MD step. Returns the run's
    launch counts and the kernel records."""
    with captured_calls() as calls:
        native_md_run(device, n_segments=1, segment_steps=1, n_atoms=n_atoms)
    recs = {k: [dict(r, path="native_md") for r in rs]
            for k, rs in check_captured(calls, "native-list MD, one step").items()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with native_calls() as lists:
        out, system = native_md_run(device, n_atoms=n_atoms)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    evals = NATIVE_MD_SEGMENTS * (NATIVE_MD_STEPS + 1)
    want = {k: evals * v for k, v in schnet_launches("unfused").items()}
    if launches != want or lists["neighbor_list"] != NATIVE_MD_SEGMENTS:
        raise AssertionError(f"native-list MD: launches {launches} and lists {lists}, "
                             f"expected {want} and {NATIVE_MD_SEGMENTS}")
    ref, _ = native_md_run("cpu", n_atoms=n_atoms)
    if not (np.isfinite(out["e_pot"]).all() and np.isfinite(out["e_kin"]).all()):
        raise AssertionError("native-list MD: energies not finite")
    e_err = float(np.abs(out["e_pot"] - ref["e_pot"]).max())
    e_scale = float(np.abs(ref["e_pot"]).max())
    # the positions by their displacement from the start (the helix spans
    # some 350 A)
    pos_err = float(np.abs(out["pos"][0] - ref["pos"][0]).max())
    pos_scale = float(np.abs(ref["pos"][0] - system["node_coordinates"]).max())
    if out["edge_counts"] != ref["edge_counts"] or not (
            e_err <= MD_TOL * e_scale and pos_err <= MD_TOL * pos_scale):
        raise AssertionError(f"native-list MD: edges {out['edge_counts']} against "
                             f"{ref['edge_counts']}, e_pot off the CPU's by {e_err} (scale "
                             f"{e_scale}), positions by {pos_err}")
    steps = NATIVE_MD_SEGMENTS * NATIVE_MD_STEPS
    log("native md: " + json.dumps({
        "atoms": n_atoms, "segments": NATIVE_MD_SEGMENTS, "segment_steps": NATIVE_MD_STEPS,
        "native_lists": lists, "edge_counts": out["edge_counts"],
        "e_pot_max_abs_err_vs_cpu": e_err, "e_pot_scale": e_scale,
        "pos_max_abs_err_vs_cpu": pos_err, "ms_per_step": 1e3 * seconds / steps,
        "launches_per_evaluation": schnet_launches("unfused"), "card": smi}))
    return {"native_md": launches}, recs


def explainer_setup(device, n_nodes=None):
    """Phase 10's GCN at Cora scale (seed-0 weights) and ``gcn_cora_train``'s
    citation graph (``n_nodes`` of it, all by default)."""
    from gcnn_keras_tpu_torch.models import gcn
    cfg = TRAIN_PATHS["gcn_cora_train"]
    model = gcn.make_model(device=device, generator=torch.Generator().manual_seed(0),
                           **GCN_CORA_KW)
    return model, citation_batch(cfg["seed"], n_nodes or cfg["size"], device)


def explainer_first_epoch(explainer, model, batch):
    """The first epoch's loss and mask gradients (a mask the loss does not
    reach: zeros)."""
    with torch.no_grad():
        target = model(batch)[explainer.output_key]
    masks = explainer.initial_masks(batch)
    loss = explainer.loss(model, batch, masks, target)
    grads = torch.autograd.grad(loss, list(masks.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(m) if g is None else g
                           for (k, m), g in zip(masks.items(), grads)}


def phase_explainer(smi, device="cuda", n_nodes=None, epochs=None):
    """Phase 29 (b) and (d): ``GNNExplainer`` (``models/gnnexplain.py``'s
    ``make_model``) at its defaults on phase 10's GCN at Cora scale. Every
    kernel call of the target's forward and of one epoch against its plain
    version; the first epoch's loss and mask gradients against the CPU's
    within ``TRAIN_TOL``; then the whole explanation with every count set to
    0 just before and read just after, held to the target's launches plus
    ``epochs`` times an epoch's; the losses falling from the first epoch to
    the last; the ms an epoch, the host syncs of a 2- and a 4-epoch
    explanation, the final masks' largest distance from the CPU's;
    ``ThroughputMeter`` over the epochs (the graph's real counts) and
    ``device_memory_stats``. Returns the explanation's launch counts and the
    kernel records."""
    from gcnn_keras_tpu_torch.models.gnnexplain import make_model as make_explainer
    from gcnn_keras_tpu_torch.utils.profiling import ThroughputMeter, device_memory_stats
    model, batch = explainer_setup(device, n_nodes)
    explainer = make_explainer(device=device, **({"epochs": epochs} if epochs else {}))
    with captured_calls() as target_calls:
        model(batch)
    with captured_calls() as calls:
        make_explainer(device=device, epochs=1).explain(model, batch)
    torch.cuda.synchronize()
    recs = {k: [dict(r, path="gnn_explainer") for r in rs] for k, rs in check_captured(
        calls, "explainer, the target and one epoch").items()}
    per_epoch = {k: len(calls[k]) - len(target_calls.get(k, ())) for k in calls}
    want = {k: 0 for k in kernel_counts()}
    for k, c in target_calls.items():
        want[k] += len(c) + explainer.epochs * per_epoch[k]

    loss, grads = explainer_first_epoch(explainer, model, batch)
    cpu_model, cpu_batch = explainer_setup("cpu", n_nodes)
    cpu_loss, cpu_grads = explainer_first_epoch(explainer, cpu_model, cpu_batch)
    first = {"loss": abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())}
    for k, g in cpu_grads.items():
        scale = g.abs().max().item()
        first[f"{k}_grad"] = (grads[k].cpu() - g).abs().max().item() / (scale or 1.0)
    if not all(v <= TRAIN_TOL for v in first.values()):
        raise AssertionError(f"explainer: first epoch against the CPU {first} > {TRAIN_TOL}")

    meter = ThroughputMeter()
    reset_counts()
    meter.start()
    t0 = time.perf_counter()
    ex = explainer.explain(model, batch)
    for _ in range(explainer.epochs):
        meter.step(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    if launches != want:
        raise AssertionError(f"explainer: launches {launches}, expected {want}")
    counts = meter.counts()
    real = {"steps": 1, "edges": int(batch.edge_mask.sum().item()),
            "nodes": int(batch.node_mask.sum().item()), "graphs": 1}
    if counts != {k: explainer.epochs * v for k, v in real.items()}:
        raise AssertionError(f"ThroughputMeter: {counts} for {explainer.epochs} x {real}")
    losses = ex["losses"].cpu().numpy()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"explainer: losses {losses[0]} -> {losses[-1]}")
    stats = device_memory_stats(device)
    if device != "cpu" and not stats:
        raise AssertionError("device_memory_stats: empty on the card")
    # the host syncs of a 2- and a 4-epoch explanation: equal where no epoch syncs
    syncs = [host_syncs(lambda n=n: make_explainer(device=device, epochs=n).explain(model, batch))
             for n in (2, 4)]
    cpu_ex = make_explainer(device="cpu", epochs=explainer.epochs).explain(cpu_model, cpu_batch)
    mask_err = max((ex[k].cpu() - cpu_ex[k]).abs().max().item()
                   for k in ("edge_mask", "feature_mask", "node_mask"))
    log("gnn explainer: " + json.dumps({
        "N_pad": batch.n_node, "E_pad": batch.n_edge, "features": CORA_FEATURES,
        "epochs": explainer.epochs, "ms_per_epoch": 1e3 * seconds / explainer.epochs,
        "launches_per_epoch": {k: v for k, v in per_epoch.items() if v},
        "target_launches": {k: len(c) for k, c in target_calls.items() if c},
        "first_epoch_vs_cpu": first, "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]), "host_syncs_2_and_4_epochs": syncs,
        "final_masks_max_abs_diff_vs_cpu": mask_err,
        "losses_max_rel_diff_vs_cpu": float(np.abs(
            losses / cpu_ex["losses"].numpy() - 1).max()),
        "throughput": meter.report(),
        "peak_allocated_mb": stats.get("allocated_bytes.all.peak", 0) / 2 ** 20,
        "card": smi}))
    return {"gnn_explainer": launches}, recs


class AtomsStandIn:
    """The part of ``ase.Atoms`` the ASE bridge reads (ASE is not installed
    on the card's machine): float64 positions, as ASE gives them."""

    def __init__(self, numbers, positions, cell=None, pbc=False):
        self.numbers = np.asarray(numbers)
        self.positions = np.asarray(positions, dtype=np.float64)
        self.cell = np.zeros((3, 3)) if cell is None else np.asarray(cell, dtype=np.float64)
        self.pbc = np.array([pbc] * 3)

    def get_atomic_numbers(self):
        return self.numbers

    def get_positions(self):
        return self.positions

    def get_cell(self):
        return self.cell


def ase_predictor(kind, device):
    """The serving model of ``kind`` (phase 4's SchNet, phase 8's HDNNP4th)
    behind a predictor that makes its own neighbour list (4 A, 25) and, for
    HDNNP4th, its angles: what the calculator gets is numbers and
    positions."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle, set_range
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    pre = [functools.partial(set_range, max_distance=4.0, max_neighbours=25)]
    if kind == "hdnnp4th":
        pre.append(functools.partial(set_angle, range_indices="range_indices"))
    return MolDynamicsModelPredictor(energy_force_model(kind, device),
                                     graph_preprocessors=pre, device=device)


def phase_ase_bridge(smi, device="cuda"):
    """Phase 29 (c): ``moldyn/ase_calc.py``'s ``calculator_results`` for a
    stand-in ``Atoms`` (the seed-0 request's first molecule) through the
    SchNet and HDNNP4th predictors (no ESP, the total charge the predictor
    takes for a graph without one: 0): every kernel call of the evaluation
    against its plain version, then the evaluation with every count set to
    0 just before and read just after (``schnet_launches("unfused")``,
    ``HDNNP4TH_LAUNCHES``), energy, forces and charges against the CPU
    within ``SERVE_TOL`` of their scale, the charges summing to 0. Returns
    the launch counts and the kernel records."""
    from gcnn_keras_tpu_torch.moldyn.ase_calc import AtomsToGraphConverter, calculator_results
    g = qm9_like_mols(0, 1)[0]
    atoms = AtomsStandIn(g["node_number"], g["node_coordinates"])
    conv = AtomsToGraphConverter()
    by_path, recs, rec = {}, {}, {"atoms": len(atoms.numbers), "card": smi}
    for kind in ASE_PREDICTORS:
        path = f"ase_{kind}"
        expected = schnet_launches("unfused") if kind == "schnet" else HDNNP4TH_LAUNCHES
        gpu = ase_predictor(kind, device)
        with captured_calls() as calls:
            calculator_results(gpu, conv, atoms)
        torch.cuda.synchronize()
        for k, rs in check_captured(calls, f"{path}, one evaluation").items():
            recs.setdefault(k, []).extend(dict(r, path=path) for r in rs)
        reset_counts()
        t0 = time.perf_counter()
        res = calculator_results(gpu, conv, atoms)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        by_path[path] = kernel_counts()
        if by_path[path] != expected:
            raise AssertionError(f"{path}: launches {by_path[path]}, expected {expected}")
        ref = calculator_results(ase_predictor(kind, "cpu"), conv, atoms)
        keys = ["energy", "forces"] + (["charges"] if kind == "hdnnp4th" else [])
        if sorted(res) != sorted(keys) or not isinstance(res["energy"], float):
            raise AssertionError(f"{path}: results {sorted(res)}")
        errs = {}
        for k in keys:
            a, b = np.asarray(res[k], np.float64), np.asarray(ref[k], np.float64)
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{path}: {k} of shape {a.shape}, the CPU's {b.shape}")
            errs[k] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            if errs[k] > SERVE_TOL:
                raise AssertionError(f"{path}: {k} off the CPU's by {errs[k]} of its scale")
        if kind == "hdnnp4th" and abs(float(res["charges"].sum())) > CHARGE_TOL * (
                1.0 + np.abs(res["charges"]).sum()):
            raise AssertionError(f"{path}: charges sum to {res['charges'].sum()}")
        rec[kind] = {"vs_cpu": errs, "ms_per_call": ms, "energy": res["energy"]}
    log("ase bridge: " + json.dumps(rec))
    return by_path, recs


def phase_trace(smi, requests, device="cuda"):
    """Phase 29 (d): ``utils/profiling.py``'s ``trace`` around one serving
    evaluation of phase 4's SchNet (the seed-2 request) writes a Chrome
    trace that names the segment-sum kernel (#1)."""
    from gcnn_keras_tpu_torch.utils.profiling import TRACE_FILE, trace
    gpu = make_predictor(device)
    gpu(requests[2][1])  # warm
    with tempfile.TemporaryDirectory(prefix="_phase29_", dir=os.getcwd()) as workdir:
        with trace(os.path.join(workdir, "trace")) as logdir:
            gpu(requests[2][1])
        path = os.path.join(logdir, TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    kernels = sorted({e["name"] for e in events if "sorted_segment_sum" in e.get("name", "")})
    if device != "cpu" and not kernels:
        raise AssertionError("trace: no event names the segment-sum kernel")
    log("trace: " + json.dumps({"events": len(events), "bytes": size,
                                "segment_sum_events": kernels, "card": smi}))


def phase_slice19(smi, requests):
    """Phase 29: slice 19 on the card. Returns the launch counts of its main
    paths and the kernel records."""
    t0 = time.perf_counter()
    by_path, records = {}, {}
    phase_native_lists(smi)
    for run in (phase_native_md, phase_explainer, phase_ase_bridge):
        paths, recs = run(smi)
        by_path.update(paths)
        for k, rs in recs.items():
            records.setdefault(k, []).extend(rs)
    phase_trace(smi, requests)
    log(f"phase 29 seconds: {time.perf_counter() - t0:.1f}")
    return by_path, records


# ------------------------------------------------- phase 30: parallel/

PARALLEL_RANKS = 2
PARALLEL_DP_PATHS = ("schnet_train", "hdnnp4th_train")
PARTITION_NODES = 100_000
# tests/test_partitioned_model.py test_partitioned_schnet_100k_nodes: E / n
# within rtol 1e-5 / atol 1e-6, forces within rtol 1e-3 / atol 5e-5
PARTITION_E_TOL = (1e-5, 1e-6)
PARTITION_F_TOL = (1e-3, 5e-5)
# the partitioned step's loss: w_e (E - E_ref)^2 + w_f mean (F - F_ref)^2,
# E_ref 0 and w_e small beside E^2 over 1e5 nodes
PARTITION_W = {"w_energy": 1e-6, "w_force": 10.0}
PARALLEL_TIMEOUT_S = 600.0
# the sizes of phase 30 on the card: molecules a rank of each path, chain
# nodes, and the ensemble's replicas, steps a segment and segments
PARALLEL_SIZES = {"dp": {p: TRAIN_PATHS[p]["size"] for p in PARALLEL_DP_PATHS},
                  "nodes": PARTITION_NODES,
                  "md": (ENSEMBLE_REPLICAS, ENSEMBLE_SEGMENT_STEPS, ENSEMBLE_SEGMENTS)}


def count_kernels_on_cpu():
    """A CPU rehearsal's rank: each kernel wrapper call counted as the card
    counts its launches, ``torch.cuda.synchronize`` a no-op (as the tests'
    ``counted_kernels`` fixture does in their process)."""
    torch.cuda.synchronize = lambda *a, **k: None
    for kname, (mod, attr, _) in kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=kname):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        setattr(mod, attr, counted)


def chain_system(n, k=6, seed=3, box_aspect=50.0):
    """``tests/test_partitioned_model.py`` ``_chain_system``: points in a
    long box with their ``k`` nearest neighbours within 0.35 (the port's C++
    list); ``(z, pos, senders, receivers)``."""
    from gcnn_keras_tpu_torch import native
    rs = np.random.RandomState(seed)
    pos = rs.rand(n, 3).astype(np.float32)
    pos[:, 0] *= box_aspect
    res = native.neighbor_list(pos, cutoff=0.35, max_neighbors=k)
    if res is None:
        raise RuntimeError("the C++ neighbour list did not build")
    pairs, _ = res
    z = rs.choice([1, 6, 8], size=n).astype(np.int32)
    return z, pos, pairs[:, 1].astype(np.int64), pairs[:, 0].astype(np.int64)


def rank_threads():
    """Torch's CPU threads for each of phase 30's ranks: the host's cores
    shared among them."""
    return max((os.cpu_count() or 1) // PARALLEL_RANKS, 1)


def ensemble_systems(replicas=ENSEMBLE_REPLICAS):
    """Phase 14's replicas of the 21-atom molecule."""
    n = 21
    t = np.arange(n) * 1.2
    return [md_system(np.random.RandomState(100 + s), n, t) for s in range(replicas)]


def ensemble_md(device, segment_steps=ENSEMBLE_SEGMENT_STEPS):
    from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
    return ScannedMD(schnet_model("unfused", device), dt=MD_DT,
                     segment_steps=segment_steps, max_distance=4.0,
                     max_neighbours=25, device=device)


def dp_steps(path, mesh, size):
    """(a) on one rank: ``TRAIN_STEPS`` data-parallel steps of ``path`` on
    this rank's batch of ``size``, every count set to 0 just before and read
    just after."""
    cfg = TRAIN_PATHS[path]
    batch = train_batch(path, cfg["seed"] + mesh.rank, size, mesh.device)
    model, trainer, state = make_trainer(path, mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    reset_counts()
    losses, times, per_step, first = [], [], [], None
    for i in range(TRAIN_STEPS):
        before = kernel_counts()
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
        per_step.append({k: v - before[k] for k, v in kernel_counts().items()})
        if i == 0:
            first = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return {"losses": losses, "ms_per_step": float(np.median(times[1:])), "first_grads": first,
            "params": [p.detach().cpu() for p in model.parameters()],
            "launches": kernel_counts(), "per_step": per_step}


def partitioned_steps(mesh, pin, f_target):
    """(b) on one rank: a warm-up evaluation and step with rank 0's kernel
    calls captured and checked, then the main path, three evaluations and
    three steps' gradients, timed."""
    from gcnn_keras_tpu_torch.parallel import partitioned as part
    from gcnn_keras_tpu_torch.parallel.collectives import all_gather_tiled
    model = schnet_model("unfused", mesh.device)
    shard = part.rank_shard(pin, mesh)
    efn = part.make_partitioned_energy_force(model, mesh)
    step = part.make_partitioned_train_step(model, mesh, functools.partial(torch.optim.SGD,
                                                                            lr=1.0),
                                            **PARTITION_W)
    state = step.init_state()
    f_ref = torch.as_tensor(part.shard_node_array(pin, f_target)[mesh.rank]).to(mesh.device)
    with captured_calls() if mesh.rank == 0 else contextlib.nullcontext({}) as calls:
        efn(shard)
        step.grads(state, shard, 0.0, f_ref)
    torch.cuda.synchronize()
    recs = check_captured({k: v for k, v in calls.items() if k == "sorted_segment_sum"},
                          "partitioned SchNet, rank 0") if calls else {}
    del calls
    torch.cuda.synchronize()
    reset_counts()
    ev_ms, st_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        e, f = efn(shard)
        torch.cuda.synchronize()
        ev_ms.append(1e3 * (time.perf_counter() - t0))
    for _ in range(3):
        t0 = time.perf_counter()
        grads, metrics, _ = step.grads(state, shard, 0.0, f_ref)
        torch.cuda.synchronize()
        st_ms.append(1e3 * (time.perf_counter() - t0))
    launches = kernel_counts()
    forces = all_gather_tiled(f, mesh).cpu().numpy()
    # JAX's MD default, fused_aggregate=True, on the same shard: the unfused
    # route (no fused launch), the same energy and forces
    reset_counts()
    e_fu, f_fu = part.make_partitioned_energy_force(schnet_model("fused", mesh.device),
                                                    mesh)(shard)
    torch.cuda.synchronize()
    rtol, atol = PARTITION_F_TOL
    fused = {"energy": float(e_fu), "launches": kernel_counts(),
             "max_force_diff": float((f_fu - f).abs().max()),
             "forces_agree": bool(((f_fu - f).abs() <= atol + rtol * f.abs()).all())}
    out = {"launches": launches, "ms_eval": float(np.median(ev_ms)),
           "ms_step": float(np.median(st_ms)), "loss": float(metrics["loss"]),
           "energy": float(e), "records": recs, "evals": 3, "steps": 3, "fused": fused}
    if mesh.rank == 0:
        out.update(forces=forces, grads={n: g.detach().cpu() for (n, _), g in
                                         zip(model.named_parameters(), grads)})
    return out


def replica_md(mesh, systems, segment_steps, segments):
    """(c) on one rank: a warm-up run, then the main path."""
    md = ensemble_md(mesh.device, segment_steps)
    md.run_ensemble(systems, 1, n_devices=mesh.size)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = md.run_ensemble(systems, segments, n_devices=mesh.size)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "launches": kernel_counts(),
            "e_pot": out["e_pot"], "e_kin": out["e_kin"], "pos": out["pos"]}


def parallel_rank(mesh, sizes, pin, f_target, systems):
    """Phase 30 (a)-(c) on one rank; returns its results and the
    collectives' transport counts."""
    if mesh.device.type == "cpu":
        count_kernels_on_cpu()
    out = {path: dp_steps(path, mesh, sizes["dp"][path]) for path in PARALLEL_DP_PATHS}
    torch.cuda.empty_cache()
    out["partitioned"] = partitioned_steps(mesh, pin, f_target)
    torch.cuda.empty_cache()
    out["md"] = replica_md(mesh, systems, *sizes["md"][1:])
    out["transport"] = {k: dict(v) for k, v in mesh.transport.items()}
    out["backend"] = mesh.backend
    return out


def single_rank_steps(path, size, device="cuda"):
    """(a)'s reference: one single-rank ``Trainer`` step on each rank's
    batch (the loss and gradients of each), and the median ms of
    ``TRAIN_STEPS`` steps on the first."""
    cfg = TRAIN_PATHS[path]
    firsts, times = [], []
    for r in range(PARALLEL_RANKS):
        batch = train_batch(path, cfg["seed"] + r, size, device)
        model, trainer, state = make_trainer(path, device)
        for i in range(TRAIN_STEPS if r == 0 else 1):
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                firsts.append((float(metrics["loss"]), {n: p.grad.detach().cpu()
                                                        for n, p in model.named_parameters()}))
    loss = float(np.mean([f[0] for f in firsts]))
    grads = {n: sum(f[1][n] for f in firsts) / len(firsts) for n in firsts[0][1]}
    return loss, grads, float(np.median(times[1:TRAIN_STEPS]))


def partition_oracle(z, pos, send, recv, f_target, device="cuda"):
    """(b)'s reference: the same SchNet on the whole graph on one rank:
    energy, forces, the partitioned loss's parameter gradients, and the ms
    of an evaluation and of the gradients."""
    from gcnn_keras_tpu_torch.parallel.partitioned import single_graph_batch
    model = schnet_model("unfused", device)
    ob = single_graph_batch(z, pos, send, recv, device=device)
    n = len(z)
    f_pad = torch.zeros(ob.n_node, 3, device=device)
    f_pad[:n] = torch.as_tensor(f_target, device=device)
    mask = ob.node_mask.float()[:, None]
    params = list(model.parameters())

    def run(grad):
        p = ob.nodes["node_coordinates"].detach().requires_grad_(True)
        e = model(ob.replace_nodes(node_coordinates=p))["output"][0, 0]
        (g,) = torch.autograd.grad(e, p, create_graph=grad)
        if not grad:
            return e.detach(), -g
        df = (-g - f_pad) * mask
        loss = PARTITION_W["w_energy"] * e ** 2 + PARTITION_W["w_force"] * (df * df).sum() / (
            3.0 * n)
        return loss.detach(), torch.autograd.grad(loss, params)

    ms = {}
    for grad in (False, True):
        run(grad)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(grad)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms["step" if grad else "eval"] = float(np.median(times))
        if grad:
            loss, grads = out
        else:
            e, f = out
    return (float(e), f.detach().cpu().numpy()[:n], float(loss),
            {name: g.cpu() for (name, _), g in zip(model.named_parameters(), grads)}, ms)


def distributed_driver_rank(out_path, device="cuda"):
    """(d) on one rank that joined from a launcher's variables: ``train_force
    --distributed`` through ``run_zoo_driver``; writes its first step (batch
    on the CPU, weights, loss, gradients), its kernel records, every later
    step's launches, the run's launches and score to ``out_path``."""
    import pickle
    if device == "cpu":
        count_kernels_on_cpu()
    script, model = "train_force_distributed", "Schnet"
    rec, score, launches, run_s = run_zoo_driver(script, model, device)
    label = f"{script}_{model}"
    first = {k: rec.first[k] for k in ("batch", "weights", "loss", "grads")}
    out = {"first": first, "launches": launches, "run_s": run_s, "score": score,
           "records": kernel_call_records(rec.first["calls"], f"{label}, first step", label),
           "launches_per_step": rec.check_steps(label),
           "ms_per_step": float(np.median([ms for _, ms, _ in rec.steps])),
           "steps": len(rec.steps) + 1}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def phase_distributed_driver(smi, n_ranks=PARALLEL_RANKS, device="cuda"):
    """Phase 30 (d): ``n_ranks`` processes with a launcher's variables, each
    ``distributed_driver_rank``; their first step against the mean of the
    CPU's steps on their batches."""
    import pickle
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_phase30_", dir=os.getcwd()) as workdir:
        procs = []
        # the group meets at a file store of this phase's own, so no TCP
        # port can be taken between its choice and its use
        store = os.path.join(workdir, "store")
        for r in range(n_ranks):
            env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
            env.update(JAX_COORDINATOR_ADDRESS=f"file://{store}",
                       WORLD_SIZE=str(n_ranks), RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS=str(rank_threads()))
            out = os.path.join(workdir, f"rank_{r}.pkl")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.distributed_driver_rank(*sys.argv[1:])", out, device],
                cwd=here, env=env), out))
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        try:
            for p, _ in procs:
                p.wait(max(deadline - time.monotonic(), 1.0))
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r, (p, out) in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"train_force --distributed: rank {r} exit {p.returncode}")
            with open(out, "rb") as f:
                ranks.append(pickle.load(f))
    label = "train_force_distributed_Schnet"
    if ranks[0]["score"] is None or not np.isfinite(ranks[0]["score"]["loss"]).all():
        raise AssertionError(f"{label}: score {ranks[0]['score']}")
    firsts = [r["first"] for r in ranks]
    for f in firsts[1:]:
        if f["loss"] != firsts[0]["loss"] or not all(
                torch.equal(a, b) for a, b in zip(f["weights"], firsts[0]["weights"])):
            raise AssertionError(f"{label}: the ranks' first steps differ")
    named_params, loss_fn, exact = force_driver_cpu_step(
        "train_force_distributed", "Schnet", ZOO_DRIVER_RUNS["train_force_distributed"][1])
    names, params = zip(*named_params)
    losses, grads, exacts = [], [], []
    for f in firsts:
        with torch.no_grad():
            for p, w in zip(params, f["weights"]):
                p.copy_(w)
        loss, _ = loss_fn(f["batch"])
        losses.append(loss.item())
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    mean_loss = float(np.mean(losses))
    if not abs(firsts[0]["loss"] - mean_loss) <= TRAIN_TOL * abs(mean_loss):
        raise AssertionError(f"{label}: first loss {firsts[0]['loss']}, the CPU's mean "
                             f"{mean_loss}")
    ref = {n: None if gs[0] is None else sum(gs) / len(gs)
           for n, gs in zip(names, zip(*grads))}

    def mean_exact():
        xs = []
        for f in firsts:
            with torch.no_grad():
                for p, w in zip(params, f["weights"]):
                    p.copy_(w)
            xs.append(exact(f["batch"]))
        return {n: sum(x[n] for x in xs) / len(xs) for n in xs[0]}
    worst, arbitrated = check_grads(label, dict(zip(names, firsts[0]["grads"])), ref,
                                    TRAIN_TOL, mean_exact)
    by_path = {f"{label}_rank{r}": rk["launches"] for r, rk in enumerate(ranks)}
    log(f"{label} driver: " + json.dumps({
        "ranks": n_ranks, "card": smi, "loss_gpu": firsts[0]["loss"], "loss_cpu_mean": mean_loss,
        "max_rel_grad_err": worst, **({"float64_arbiter": arbitrated} if arbitrated else {}),
        "steps": ranks[0]["steps"], "ms_per_step": [rk["ms_per_step"] for rk in ranks],
        "launches_per_step": ranks[0]["launches_per_step"], "losses": ranks[0]["score"]["loss"],
        "launches_run": by_path}))
    return by_path, ranks[0]["records"]


def phase_parallel(smi, device="cuda", sizes=None):
    """Phase 30 (the module docstring) at ``sizes`` (``PARALLEL_SIZES``'
    keys; a CPU rehearsal takes small ones). Returns the launch counts of
    its paths, by rank, and the kernel records."""
    from gcnn_keras_tpu_torch.parallel import launch
    from gcnn_keras_tpu_torch.parallel.partitioned import prepare_partitioned, unshard_node_array
    sizes = sizes or PARALLEL_SIZES
    replicas, segment_steps, segments = sizes["md"]
    t0 = time.perf_counter()
    # the references on one rank first, while the card is the parent's alone
    dp_ref = {path: single_rank_steps(path, sizes["dp"][path], device)
              for path in PARALLEL_DP_PATHS}
    z, pos, send, recv = chain_system(sizes["nodes"])
    f_target = (np.random.RandomState(5).randn(len(z), 3) * 0.1).astype(np.float32)
    oracle = partition_oracle(z, pos, send, recv, f_target, device)
    torch.cuda.empty_cache()
    pin = prepare_partitioned(z, pos, send, recv, PARALLEL_RANKS)
    systems = ensemble_systems(replicas)
    md_ref = ensemble_md(device, segment_steps).run_ensemble(systems, segments)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the host's cores shared among the ranks (each rank's own default takes
    # them all, and spinning thread pools oversubscribe them)
    ranks = launch.spawn(parallel_rank, PARALLEL_RANKS, sizes, pin, f_target, systems,
                         device=device, share_device=device != "cpu",
                         timeout_s=PARALLEL_TIMEOUT_S, threads=rank_threads())
    by_path, records = {}, {"sorted_segment_sum": []}
    # (a)
    for path in PARALLEL_DP_PATHS:
        cfg = TRAIN_PATHS[path]
        loss_ref, grads_ref, ms_ref = dp_ref[path]
        res = [rk[path] for rk in ranks]
        label = f"parallel_{path}"
        if not abs(res[0]["losses"][0] - loss_ref) <= TRAIN_TOL * abs(loss_ref):
            raise AssertionError(f"{label}: first loss {res[0]['losses'][0]}, the single-rank "
                                 f"steps' mean {loss_ref}")
        worst, _ = check_grads(label, res[0]["first_grads"], grads_ref, TRAIN_TOL)
        for r, rr in enumerate(res):
            if not all(np.isfinite(rr["losses"])) or not rr["losses"][-1] < rr["losses"][0]:
                raise AssertionError(f"{label} rank {r}: losses {rr['losses']}")
            for i, counts in enumerate(rr["per_step"]):
                if counts != cfg["launches"]:
                    raise AssertionError(f"{label} rank {r} step {i}: launches {counts}, "
                                         f"expected {cfg['launches']}")
            if rr["losses"] != res[0]["losses"] or not all(
                    torch.equal(a, b) for a, b in zip(rr["params"], res[0]["params"])):
                raise AssertionError(f"{label}: rank {r}'s replica differs from rank 0's")
            by_path[f"{label}_rank{r}"] = rr["launches"]
        log(f"{label}: " + json.dumps({
            "ranks": PARALLEL_RANKS, "size_per_rank": sizes["dp"][path], "card": smi,
            "loss_first": res[0]["losses"][0], "loss_single_rank_mean": loss_ref,
            "max_rel_grad_err": worst, "losses": res[0]["losses"],
            "ms_per_dp_step": [rr["ms_per_step"] for rr in res], "ms_single_rank_step": ms_ref,
            "launches_per_step_per_rank": {k: v for k, v in cfg["launches"].items() if v},
            "params_equal_across_ranks": True}))
    # (b)
    e_ref, f_ref, loss_ref, grads_ref, ms_ref = oracle
    part = [rk["partitioned"] for rk in ranks]
    n = len(z)
    f = unshard_node_array(pin, part[0]["forces"].reshape(pin.z.shape + (3,)))
    rtol, atol = PARTITION_E_TOL
    if not all(abs(p_["energy"] / n - e_ref / n) <= atol + rtol * abs(e_ref / n) for p_ in part):
        raise AssertionError(f"partitioned SchNet: energies {[p_['energy'] for p_ in part]}, "
                             f"the oracle's {e_ref}")
    rtol, atol = PARTITION_F_TOL
    ferr = np.abs(f - f_ref)
    if not np.all(ferr <= atol + rtol * np.abs(f_ref)) or not np.isfinite(f).all():
        raise AssertionError(f"partitioned SchNet: forces off the oracle's by {ferr.max()}")
    if not abs(part[0]["loss"] - loss_ref) <= TRAIN_TOL * abs(loss_ref):
        raise AssertionError(f"partitioned SchNet: loss {part[0]['loss']}, oracle {loss_ref}")
    worst, _ = check_grads("partitioned SchNet step", part[0]["grads"], grads_ref, TRAIN_TOL)
    rtol, atol = PARTITION_E_TOL
    for r, p_ in enumerate(part):
        if not p_["launches"]["sorted_segment_sum"]:
            raise AssertionError(f"partitioned SchNet rank {r}: #1 not launched")
        fu = p_["fused"]
        if (fu["launches"]["gather_mul_segsum"] or not fu["launches"]["sorted_segment_sum"]
                or not fu["forces_agree"] or not abs(fu["energy"] - p_["energy"]) / n
                <= atol + rtol * abs(p_["energy"] / n)):
            raise AssertionError(f"partitioned SchNet rank {r}: fused_aggregate=True gives "
                                 f"{fu}, the unfused energy {p_['energy']}")
        by_path[f"partitioned_schnet_rank{r}"] = p_["launches"]
    records["sorted_segment_sum"].extend(
        dict(rec, path="partitioned_schnet_rank0") for rec in
        part[0]["records"].get("sorted_segment_sum", []))
    if not records["sorted_segment_sum"]:
        raise AssertionError("partitioned SchNet: rank 0 captured no #1 call")
    log("partitioned schnet: " + json.dumps({
        "nodes": n, "edges": int(len(send)), "ranks": PARALLEL_RANKS, "card": smi,
        "halo_size": pin.halo_size, "remote_fraction": pin.remote_fraction,
        "n_local": int(pin.z.shape[1]), "energy": part[0]["energy"], "energy_oracle": e_ref,
        "max_force_err": float(ferr.max()), "loss": part[0]["loss"], "loss_oracle": loss_ref,
        "max_rel_grad_err": worst,
        "fused_aggregate_max_force_diff": max(p_["fused"]["max_force_diff"] for p_ in part),
        "ms_eval": [p_["ms_eval"] for p_ in part],
        "ms_step": [p_["ms_step"] for p_ in part], "ms_eval_oracle": ms_ref["eval"],
        "ms_step_oracle": ms_ref["step"], "checked_calls": len(records["sorted_segment_sum"]),
        "launches_per_rank": {k: v for k, v in part[0]["launches"].items() if v},
        "backend": ranks[0]["backend"], "transport": ranks[0]["transport"]}))
    # (c)
    scale = float(np.abs(md_ref["e_pot"]).max())
    for r, rk in enumerate(ranks):
        md = rk["md"]
        if md["e_pot"].shape != md_ref["e_pot"].shape:
            raise AssertionError(f"replica MD rank {r}: e_pot {md['e_pot'].shape}")
        err = float(np.abs(md["e_pot"] - md_ref["e_pot"]).max())
        perr = max(float(np.abs(a - b).max()) for a, b in zip(md["pos"], md_ref["pos"]))
        if not err <= MD_TOL * scale or not perr <= MD_TOL * 10:
            raise AssertionError(f"replica MD rank {r}: e_pot off n_devices=1 by {err}, "
                                 f"positions by {perr}")
        evals = segments * (segment_steps + 1)
        want = {k: evals * v for k, v in schnet_launches("unfused").items()}
        got = {k: v for k, v in md["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"replica MD rank {r}: launches {got}, expected {want}")
        by_path[f"replica_md_rank{r}"] = md["launches"]
    steps = segments * segment_steps
    log("replica md: " + json.dumps({
        "replicas": replicas, "ranks": PARALLEL_RANKS, "card": smi,
        "e_pot_max_abs_err_vs_one_device": err, "pos_max_abs_err": perr,
        "ms_per_step": [1e3 * rk["md"]["seconds"] / steps for rk in ranks]}))
    # (d)
    paths, driver_recs = phase_distributed_driver(smi, device=device)
    by_path.update(paths)
    for name, rs in driver_recs.items():
        records.setdefault(name, []).extend(rs)
    log(f"phase 30 seconds: {time.perf_counter() - t0:.1f}")
    return by_path, records


# ------------------------------------- phase 31: the partitioned HDNNP4th

PART_HDNNP_ATOMS = 2080
# tests/test_partitioned_model.py's HDNNP cases: energy rtol 1e-5, forces
# rtol 1e-3 / atol 1e-5, charges atol 5e-6 with |sum q - q_tot| < 1e-5,
# the flagship step's gradients within 3e-4 of each tensor's largest entry
# and its loss within rtol 1e-4
PART_HDNNP_TOL = {"energy_rtol": 1e-5, "force": (1e-3, 1e-5), "charge_atol": 5e-6,
                  "charge_sum": 1e-5, "grad": 3e-4, "loss_rtol": 1e-4}
# the flagship loss (bench.py _hdnnp_setup; force_hdnnp4th.py's 1/200/50)
PART_HDNNP_W = {"w_energy": 1.0, "w_force": 200.0, "w_charge": 50.0}
# the row-sharded CG's relative residual: the JAX tests' (_hdnnp_model)
PART_HDNNP_CG_TOL = 1e-10
PART_HDNNP_REPS = 3
# the kernels a shard must not launch: the SPD solve (#3) and the ACSF ones
PART_HDNNP_NONE = ("spd_solve", "g2_fwd", "g4_fwd", "g4_vjp", "g2_vjp", "g4_jvp", "g2_jvp")
# (d): the JAX example's default 20 000-node chain and SchNet at depth 4,
# 64 units, over the 2 ranks, two Adam steps, checked against one device
PART_EXAMPLE_ARGS = ["--nodes", "20000", "--devices", "2", "--train-steps", "2", "--check"]
PART_HDNNP_SIZES = {"atoms": PART_HDNNP_ATOMS, "reps": PART_HDNNP_REPS,
                    "example": PART_EXAMPLE_ARGS}


def part_hdnnp_model(device, solver):
    """The flagship HDNNP4th (weights from seed 0) with the Qeq ``solver``
    (a shard takes the row-sharded CG whatever it says)."""
    from gcnn_keras_tpu_torch.models import hdnnp4th
    kw = dict(HDNNP4TH_KW, electrostatic_kwargs={"param_trainable": False, "solver": solver,
                                                 "cg_tol": PART_HDNNP_CG_TOL})
    return hdnnp4th.make_model_behler(device=device, generator=torch.Generator().manual_seed(0),
                                      **kw)


def part_hdnnp_loss(out, e_ref, f, f_ref, q_ref, mask):
    """The flagship loss of one molecule: ``w_e (E - E_ref)^2 + w_f mean
    (F - F_ref)^2 + w_q mean (q - q_ref)^2`` over its real atoms."""
    w = PART_HDNNP_W
    q = out["charge"].reshape(-1)
    df, dq = (f - f_ref) * mask[:, None], (q - q_ref) * mask
    n = mask.sum()
    return (w["w_energy"] * (out["output"][0, 0] - e_ref) ** 2
            + w["w_force"] * (df * df).sum() / (3.0 * n) + w["w_charge"] * (dq * dq).sum() / n)


def part_hdnnp_oracle(g, device="cuda", reps=PART_HDNNP_REPS):
    """(a): the flagship HDNNP4th with the dense Qeq on the whole molecule
    on one rank: energy, forces, charges, the flagship loss and its
    parameter gradients, and the ms of an evaluation and of the
    gradients."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    model = part_hdnnp_model(device, "dense")
    ob = batch_graphs([g], global_keys=("energy", "total_charge"), device=device)
    mask = ob.node_mask.float()
    params = list(model.parameters())

    def run(grad):
        p = ob.nodes["node_coordinates"].detach().requires_grad_(True)
        out = model(ob.replace_nodes(node_coordinates=p))
        (gp,) = torch.autograd.grad(out["output"][0, 0], p, create_graph=grad)
        if not grad:
            return out["output"][0, 0].detach(), -gp, out["charge"].reshape(-1).detach()
        loss = part_hdnnp_loss(out, ob.globals["energy"][0, 0], -gp, ob.nodes["force"],
                               ob.nodes["charge"], mask)
        return loss.detach(), torch.autograd.grad(loss, params)

    ms = {}
    for grad in (False, True):
        run(grad)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run(grad)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms["step" if grad else "eval"] = float(np.median(times))
        if grad:
            loss, grads = out
        else:
            e, f, q = out
    n = len(g["node_number"])
    return {"energy": float(e), "force": f.detach().cpu().numpy()[:n],
            "charge": q.cpu().numpy()[:n], "loss": float(loss), "ms": ms,
            "grads": {name: gr.cpu() for (name, _), gr in zip(model.named_parameters(), grads)}}


def part_hdnnp_rank(mesh, pin, g, reps):
    """(b) and (c) on one rank: a warm-up evaluation and step with rank 0's
    kernel calls captured and checked, then the main path, ``reps``
    evaluations and ``reps`` steps' gradients, timed, every count set to
    0 just before and read just after; rank 0's device ms of one of each
    under ``torch.profiler``; the forces and charges gathered."""
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver
    from gcnn_keras_tpu_torch.parallel import partitioned as part
    from gcnn_keras_tpu_torch.parallel.collectives import all_gather_tiled
    if mesh.device.type == "cpu":
        count_kernels_on_cpu()
    model = part_hdnnp_model(mesh.device, "auto")
    shard = part.rank_shard(pin, mesh, node_props={"esp": g["esp"]},
                            global_props={"total_charge": g["total_charge"]})
    efn = part.make_partitioned_energy_force(model, mesh)
    step = part.make_partitioned_train_step(
        model, mesh, functools.partial(torch.optim.SGD, lr=1.0), **PART_HDNNP_W)
    state = step.init_state()
    f_ref, q_ref = (torch.as_tensor(part.shard_node_array(pin, g[k])[mesh.rank]).to(mesh.device)
                    for k in ("force", "charge"))
    e_ref = float(g["energy"][0])

    def evaluate():
        return efn(shard)

    def grads():
        return step.grads(state, shard, e_ref, f_ref, q_ref)

    with captured_calls() if mesh.rank == 0 else contextlib.nullcontext({}) as calls:
        evaluate()
        grads()
    torch.cuda.synchronize()
    recs = check_captured({k: v for k, v in calls.items() if k == "sorted_segment_sum"},
                          "partitioned HDNNP4th, rank 0") if calls else {}
    del calls
    torch.cuda.synchronize()
    reset_counts()
    solves0, rounds0 = qeq_solver.solves, qeq_solver.rounds
    ev_ms, st_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        e, f = evaluate()
        torch.cuda.synchronize()
        ev_ms.append(1e3 * (time.perf_counter() - t0))
    for _ in range(reps):
        t0 = time.perf_counter()
        gr, metrics, _ = grads()
        torch.cuda.synchronize()
        st_ms.append(1e3 * (time.perf_counter() - t0))
    launches = kernel_counts()
    cg = {"solves": qeq_solver.solves - solves0, "rounds": qeq_solver.rounds - rounds0}
    with torch.no_grad():
        q = model(shard)["charge"]
    out = {"launches": launches, "ms_eval": float(np.median(ev_ms)),
           "ms_step": float(np.median(st_ms)), "metrics": {k: float(v) for k, v in
                                                           metrics.items()},
           "energy": float(e), "records": recs, "cg": cg,
           "force": all_gather_tiled(f, mesh).cpu().numpy(),
           "charge": all_gather_tiled(q, mesh).cpu().numpy()}
    # rank 0's device time of one evaluation and one step; every rank runs
    # them alike, since each call meets the other ranks in its collectives
    if mesh.device.type == "cuda":
        for key, fn in (("eval", evaluate), ("step", grads)):
            if mesh.rank == 0:
                out[f"profile_{key}"] = busy_share(fn, reps=1)
            else:
                for _ in range(3):  # busy_share's two warm calls and one traced
                    fn()
    out["transport"] = {k: dict(v) for k, v in mesh.transport.items()}
    if mesh.rank == 0:
        out["grads"] = {n: t.detach().cpu() for (n, _), t in zip(model.named_parameters(), gr)}
    return out


def run_example(device, args):
    """(d): the example's counterpart in a process of its own (its ranks
    sharing the card); its output lines and seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gcnn_keras_tpu_torch.scripts."
                           "partitioned_giant_graph", *args, "--device", device],
                          cwd=here, capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"partitioned_giant_graph {' '.join(args)}: exit "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines(), seconds


def phase_partitioned_hdnnp(smi, device="cuda", sizes=None):
    """Phase 31 (the module docstring) at ``sizes`` (``PART_HDNNP_SIZES``'
    keys; a CPU rehearsal takes small ones). Returns the launch counts of
    its paths, by rank, and the kernel records."""
    from gcnn_keras_tpu_torch.parallel import launch
    from gcnn_keras_tpu_torch.parallel.partitioned import prepare_partitioned, unshard_node_array
    sizes = sizes or PART_HDNNP_SIZES
    t0 = time.perf_counter()
    g = large_mol_graph(sizes["atoms"])
    n = len(g["node_number"])
    oracle = part_hdnnp_oracle(g, device, sizes["reps"])
    torch.cuda.empty_cache()
    send, recv = g["edge_indices"][:, 1], g["edge_indices"][:, 0]
    pin = prepare_partitioned(g["node_number"], g["node_coordinates"], send, recv,
                              PARALLEL_RANKS, angles=g["angle_indices_nodes"])
    ranks = launch.spawn(part_hdnnp_rank, PARALLEL_RANKS, pin, g, sizes["reps"], device=device,
                         share_device=device != "cpu", timeout_s=PARALLEL_TIMEOUT_S,
                         threads=rank_threads())
    tol = PART_HDNNP_TOL
    label = "partitioned HDNNP4th"
    # (b)
    for r, rk in enumerate(ranks):
        if not abs(rk["energy"] - oracle["energy"]) <= tol["energy_rtol"] * abs(oracle["energy"]):
            raise AssertionError(f"{label} rank {r}: energy {rk['energy']}, the oracle's "
                                 f"{oracle['energy']}")
    f = unshard_node_array(pin, ranks[0]["force"].reshape(pin.z.shape + (3,)))
    q = unshard_node_array(pin, ranks[0]["charge"].reshape(pin.z.shape))
    rtol, atol = tol["force"]
    ferr = np.abs(f - oracle["force"])
    if not np.isfinite(f).all() or not np.all(ferr <= atol + rtol * np.abs(oracle["force"])):
        raise AssertionError(f"{label}: forces off the oracle's by {ferr.max()}")
    qerr = np.abs(q - oracle["charge"])
    qsum = abs(float(q.sum()) - float(g["total_charge"][0]))
    if not qerr.max() <= tol["charge_atol"] or not qsum < tol["charge_sum"]:
        raise AssertionError(f"{label}: charges off the oracle's by {qerr.max()}, their sum "
                             f"off the total charge by {qsum}")
    # (c)
    loss = ranks[0]["metrics"]["loss"]
    if not abs(loss - oracle["loss"]) <= tol["loss_rtol"] * abs(oracle["loss"]):
        raise AssertionError(f"{label}: loss {loss}, the oracle's {oracle['loss']}")
    worst, _ = check_grads(f"{label} step", ranks[0]["grads"], oracle["grads"], tol["grad"])
    by_path, records = {}, {"sorted_segment_sum": []}
    for r, rk in enumerate(ranks):
        if not rk["launches"]["sorted_segment_sum"] or any(rk["launches"][k]
                                                           for k in PART_HDNNP_NONE):
            raise AssertionError(f"{label} rank {r}: launches {rk['launches']}")
        by_path[f"partitioned_hdnnp4th_rank{r}"] = rk["launches"]
    records["sorted_segment_sum"].extend(
        dict(rec, path="partitioned_hdnnp4th_rank0") for rec in
        ranks[0]["records"].get("sorted_segment_sum", []))
    if not records["sorted_segment_sum"]:
        raise AssertionError(f"{label}: rank 0 captured no #1 call")
    cg = ranks[0]["cg"]
    log("partitioned hdnnp4th: " + json.dumps({
        "atoms": n, "edges": int(len(send)), "angles": int(len(g["angle_indices_nodes"])),
        "ranks": PARALLEL_RANKS, "card": smi, "halo_size": pin.halo_size,
        "remote_fraction": pin.remote_fraction, "n_local": int(pin.z.shape[1]),
        "energy": ranks[0]["energy"], "energy_oracle": oracle["energy"],
        "max_force_err": float(ferr.max()), "max_charge_err": float(qerr.max()),
        "charge_sum_err": qsum, "loss": loss, "loss_oracle": oracle["loss"],
        "metrics": ranks[0]["metrics"], "max_rel_grad_err": worst,
        "cg_solves": cg["solves"], "cg_rounds": cg["rounds"],
        "cg_rounds_per_solve": cg["rounds"] / max(cg["solves"], 1),
        "ms_eval": [rk["ms_eval"] for rk in ranks], "ms_step": [rk["ms_step"] for rk in ranks],
        "ms_eval_oracle": oracle["ms"]["eval"], "ms_step_oracle": oracle["ms"]["step"],
        "profile_eval_rank0": ranks[0].get("profile_eval"),
        "profile_step_rank0": ranks[0].get("profile_step"),
        "evals": sizes["reps"], "steps": sizes["reps"],
        "checked_calls": len(records["sorted_segment_sum"]),
        "launches_per_rank": [{k: v for k, v in rk["launches"].items() if v} for rk in ranks],
        "backend": "gloo", "transport": ranks[0]["transport"]}))
    # (d)
    lines, seconds = run_example(device, sizes["example"])
    log("partitioned_giant_graph: " + json.dumps({"args": sizes["example"], "card": smi,
                                                  "seconds": seconds, "output": lines}))
    log(f"phase 31 seconds: {time.perf_counter() - t0:.1f}")
    return by_path, records


def kernels_line(records, by_path, second_order):
    """The ``kernels`` entries of the result line: each kernel's source, the
    TPU kernel it replaces, its launches on each main path, its largest
    error, and the time, bound and plain time of its timed check at the
    shapes of the first path (in the order of ``by_path``) that launched
    it; ``records`` holds each kernel's checks, ``second_order`` the
    pattern checks by kernel."""
    def main_record(name):
        """The timed check of kernel ``name`` at the shapes of the first path
        (in the order of ``by_path``) that launched it."""
        for path, counts in by_path.items():
            if counts.get(name, 0):
                return next(r for r in records[name] if r.get("path") == path and "ms" in r)
        raise AssertionError(f"{name} was not launched on the main path")

    sources = {
        "sorted_segment_sum": ("sorted_segment_sum", "segment_sum.cu",
                               "gcnn_keras_tpu/ops/pallas/segment_sum.py:182"),
        "sorted_segment_sum_bf16": ("sorted_segment_sum_bf16", "segment_sum.cu",
                                    "gcnn_keras_tpu/ops/pallas/segment_sum.py:182"),
        **{name: (f"acsf_{name}", "acsf.cu", replaces)
           for name, replaces in ACSF_REPLACES.items()},
        "spd_solve": ("spd_solve", "spd_solve.cu", "gcnn_keras_tpu/ops/pallas/spd_solve.py:95"),
        "gather_mul_segsum": ("gather_mul_segsum", "fused_aggregate.cu",
                              "gcnn_keras_tpu/ops/pallas/fused_aggregate.py:188"),
        "fused_cfconv": ("fused_cfconv", "fused_cfconv.cu",
                         "gcnn_keras_tpu/ops/pallas/fused_cfconv.py:157"),
        **{name: (name, "fused_interaction.cu", replaces)
           for name, replaces in CHAIN_REPLACES.items()}}

    def captured(rs):
        """The checks of recorded main-path calls (phases 10 and 14), by path:
        their number and largest error."""
        out = {}
        for r in rs:
            if "path" in r and "ms" not in r:
                n, err = out.get(r["path"], (0, 0.0))
                out[r["path"]] = (n + 1, max(err, r["max_abs_err"]))
        return {p: {"calls": n, "max_abs_err": err} for p, (n, err) in out.items()}

    kernels = []
    for name, rs in records.items():
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        label, source, replaces = sources[name]
        main_rec = main_record(name)
        kernels.append({
            "name": label, "route": "cuda", "source": f"gcnn_keras_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": sum(counts.values()), "launches_by_path": counts,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": main_rec["ms"], "ms_warm": main_rec["ms_warm"],
            "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
            **{k: main_rec[k] for k in ("unfused_chain_ms", "unfused_port_ms") if k in main_rec},
            "timed_at": main_rec["case"],
            "shapes": [r for r in rs if "ms" in r or "path" not in r],
            "captured_calls": captured(rs),
            **({"second_order": second_order[name]} if name in second_order else {})})
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    gpu = make_predictor("cuda")
    requests = [("seed 0, 512 mols", qm9_like_mols(0, 512)),
                ("seed 1, 512 mols", qm9_like_mols(1, 512)),
                ("seed 2, 64 mols", qm9_like_mols(2, 64))]
    _, batch0 = gpu.make_batch(requests[0][1])
    if (batch0.n_node, batch0.n_edge, batch0.n_graphs) != (8192, 54784, 513):
        raise AssertionError(f"unexpected full-width shapes {batch0.n_node} "
                             f"{batch0.n_edge} {batch0.n_graphs}")
    recs = phase_kernel(batch0)
    launches, unfused_answers = phase_serving(gpu, requests, batch0, smi)

    hgpu = make_hdnnp_predictor("cuda")
    _, hbatch0 = hgpu.make_batch(requests[0][1])
    shapes = (hbatch0.n_node, hbatch0.n_edge, hbatch0.angles.shape[0], hbatch0.n_graphs)
    if shapes != HDNNP_SHAPES:
        raise AssertionError(f"unexpected HDNNP2nd full-width shapes {shapes}")
    acsf_recs = phase_acsf_kernel(hbatch0, hgpu.model.energy_model)
    hlaunches = phase_model_serving(hgpu, requests, hbatch0, smi)

    qgpu = make_hdnnp4th_predictor("cuda")
    qrequests = [("seed 0, 512 mols", with_esp(requests[0][1], 0)),
                 ("seed 1, 512 mols", with_esp(requests[1][1], 1)),
                 ("seed 2, 64 mols, no ESP gradient", with_esp(requests[2][1], 2, True))]
    _, qbatch0 = qgpu.make_batch(qrequests[0][1])
    shapes = (qbatch0.n_node, qbatch0.n_edge, qbatch0.angles.shape[0], qbatch0.n_graphs)
    if shapes != HDNNP_SHAPES or qbatch0.max_nodes != HDNNP4TH_M:
        raise AssertionError(f"unexpected HDNNP4th full-width shapes {shapes}, "
                             f"M={qbatch0.max_nodes}")
    spd_recs = phase_spd_kernel(qgpu.model.energy_model, qbatch0)
    qlaunches = phase_model_serving(
        qgpu, qrequests, qbatch0, smi, name="hdnnp4th", make_cpu=make_hdnnp4th_predictor,
        expected=HDNNP4TH_LAUNCHES, check=check_charged_request,
        keys=("energy", "force", "charge"))

    jvp_recs, second_order = phase_jvp_kernels(hbatch0, hgpu.model.energy_model)
    # the timed checks at serving shapes, by the path whose batch they used
    for r in recs[:3]:
        r["path"] = "schnet_serving"
    for rs in (*acsf_recs.values(), *jvp_recs.values()):
        rs[0]["path"] = "hdnnp2nd_serving"
    spd_recs[0]["path"] = "hdnnp4th_serving"
    records = {"sorted_segment_sum": recs, **acsf_recs, **jvp_recs, "spd_solve": spd_recs}
    by_path = {"schnet_serving": {"sorted_segment_sum": launches},
               "hdnnp2nd_serving": hlaunches, "hdnnp4th_serving": qlaunches}
    # phase 15 before the training path that launches its kernels
    records.update(phase_chain_kernels(
        full_batch("schnet_chain_train", "cuda"), schnet_model("chain", "cuda")))
    for path in TRAIN_PATHS:
        if TRAIN_PATHS[path].get("phase", 10) != 10:
            continue  # phases 18 and 21
        by_path[path], train_recs = phase_training(path, smi)
        for name, rs in train_recs.items():
            records.setdefault(name, []).extend(rs)
    md_recs, md_paths, gms_pair = phase_schnet_md(gpu, requests, batch0, smi, unfused_answers)
    for name, rs in md_recs.items():
        records.setdefault(name, []).extend(rs)
    by_path.update(md_paths)
    second_order["gather_mul_segsum"] = gms_pair
    by_path["schnet_chain_serving"] = phase_model_serving(
        make_predictor("cuda", "chain"), requests, batch0, smi, name="schnet chain",
        make_cpu=functools.partial(make_predictor, mode="chain"),
        expected=schnet_launches("chain"), reference=unfused_answers)
    by_path["painn_serving"], painn_recs = phase_painn_serving(requests, smi)
    records["sorted_segment_sum"].extend(painn_recs)
    mol_paths, mol_recs = phase_molecule_scale(qrequests[0], smi)
    by_path.update(mol_paths)
    for name, rs in mol_recs.items():
        records[name].extend(rs)
    workflow = {}
    for name in SCRIPT_PATHS:
        by_path[f"{name}_script"], script_recs = phase_script(
            name, smi, after=lambda cfg, name=name: workflow.update(
                {name: phase_workflow(name, cfg, smi)}))
        for kname, rs in script_recs.items():
            records[kname].extend(rs)
        paths, workflow_recs = workflow[name]
        by_path.update(paths)
        for kname, rs in workflow_recs.items():
            records[kname].extend(rs)
    paths, search_recs = phase_searches(smi)
    by_path.update(paths)
    for kname, rs in search_recs.items():
        records[kname].extend(rs)
    option_profiles, zoo_profiles = [], []
    paths, option_recs = phase_options(requests, batch0, smi, unfused_answers, option_profiles)
    by_path.update(paths)
    for kname, rs in option_recs.items():
        records.setdefault(kname, []).extend(rs)
    timed_shapes = set()
    for phase in (22, 23, 24, 25):
        if phase >= 24:  # the third group's and phase 25's shapes timed on their own paths
            timed_shapes = set()
        paths, zoo_recs = phase_zoo(smi, zoo_profiles, timed_shapes, phase)
        by_path.update(paths)
        for kname, rs in zoo_recs.items():
            records[kname].extend(rs)
    phase_bessel_forms(smi)
    t0 = time.perf_counter()
    fast_profiles = []
    for name in FAST_PATHS:
        by_path.update(phase_fast_step(name, smi, fast_profiles))
    phase_jvp_rules()
    phase_reverse_only()
    log(f"phase 26 seconds: {time.perf_counter() - t0:.1f}")
    paths, root_recs = phase_zoo(smi, zoo_profiles, set(), 27)
    by_path.update(paths)
    for kname, rs in root_recs.items():
        records[kname].extend(rs)
    paths, dataset_recs = phase_datasets(smi)
    by_path.update(paths)
    for kname, rs in dataset_recs.items():
        records[kname].extend(rs)
    paths, slice19_recs = phase_slice19(smi, requests)
    by_path.update(paths)
    for kname, rs in slice19_recs.items():
        records[kname].extend(rs)
    paths, parallel_recs = phase_parallel(smi)
    by_path.update(paths)
    for kname, rs in parallel_recs.items():
        records[kname].extend(rs)
    paths, part_recs = phase_partitioned_hdnnp(smi)
    by_path.update(paths)
    for kname, rs in part_recs.items():
        records[kname].extend(rs)
    # the busy shares last, after every timed part of the script; one
    # profiled step of each zoo model: RGCN's and GNN-FiLM's 4300 and 12600
    # kernels a step take the profiler about 10 s a step to collect
    t0 = time.perf_counter()
    run_profiles(option_profiles)
    run_profiles(zoo_profiles, reps=1)
    run_profiles(fast_profiles, reps=1)  # some 1300-1850 kernels a step
    log(f"busy shares: {time.perf_counter() - t0:.1f} s")

    kernels = kernels_line(records, by_path, second_order)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
