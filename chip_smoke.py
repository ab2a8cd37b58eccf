"""Drive ptwt_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each raising (non-zero exit) on failure:

1. the card: CUDA must be available; prints ``nvidia-smi`` name and power
   limit;
2. build: compiles the CUDA kernels of ``src/ptwt_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together; ``pyramid2d.cu``, the
   longest, finishes behind phases 3-8, which launch none of its kernels)
   and prints the seconds;
3. kernels against their plain torch versions at the main path's shapes
   (db4; K1/K2 on ``[16, 1024, 1024]``, K3/K4 along both axes on the odd
   level-2 size ``[16, 515, 515]``), every boundary mode, float32 within
   2e-5 and float64 within 1e-10; K3/K4 also at the default mode's level
   1 (``reflect``: K3 along H on ``[16, 1024, 1024]`` and along W on the
   packed ``[2, 16, 515, 1024]``, K4 back with two pairs along W and one
   along H) and with coif17 on 37 samples in every mode (float64); plus
   the repo's frozen 2d goldens (run after phase 8: periodization runs K5);
3b. the VJP kernels against their plain versions (autograd through the
   plain versions) at the main path's shapes: K1's VJP (K2 with the fold)
   and K2's VJP (K1, zero-bounded for periodic) on ``[16, 1024, 1024]``
   <-> ``4 x 515^2`` in periodic and periodization; K3's VJP (one launch
   of K4's fold instance) and K4's VJP (one launch of K3, zero-bounded)
   along both axes of ``[16, 515, 515]`` in every mode with phase 3's odd
   crop, at the reflect level 1, and with coif17 on 37 samples in every
   mode (float64), each backward's launches asserted; then K1, K2 and both VJPs
   at the headline's level 4 (``[16, 134, 134]`` <-> ``4 x 70^2``) in both
   dtypes, haar and coif17 in float64 on ``[2, 134, 134]``, and the odd
   periodization image ``[4, 133, 135]`` (K1 and its clamped VJP).
   Unit-normal cotangents; float32 within 2e-5, float64 within 1e-10, and
   in float64 the adjoint identity ``<K x, y> = <x, K^T y>`` within 1e-12
   of ``|K x| |y|``;
4. the 2d main path: ``wavedec2`` -> ``waverec2`` on ``[16, 1024, 1024]``,
   db4, 4 levels, float32, in ``periodic`` (the headline) and ``reflect``
   (the default): coefficients against the plain path on the card within
   2e-5, round trip within 1e-4, launch counts read around each run, and
   no padding gather on the kernel path;
5. times with CUDA events (3 warm-ups, median of 20): each kernel and
   each VJP, its plain version and one library call computing the same
   level (``F.conv2d`` / ``F.conv_transpose2d``, never called by the
   package), the round trip in Mpix/s, and each kernel's bound; K1, K2
   and their VJPs at level 1 and at level 4, and their sum per round trip
   or step; each K3/K4 launch and VJP, one axis pass each, at the reflect
   level 1 (bound per launch; the plain version; ``F.conv2d`` /
   ``F.conv_transpose2d`` on an input padded beforehand) and at the
   periodic level 2, beside the padding gather and its backward that an
   older tree runs before K3 (``fwt_pad``), and the device busy time of
   one reflect round trip and step, which must hold no gather or scatter
   kernel; after
   phase 8 the same for the 1d kernels at phase 8's shapes (library:
   ``F.conv1d`` / ``F.conv_transpose1d`` with stride 2 for the one-level
   K7 pair, none for the multi-level kernels), the K6 pyramid beside the
   per-level K3/K4 route, the 1d round trips in Msamples/s and a profile
   of the d1 periodic round trip;
6. training at full width: a module holding the image ``[16, 1024,
   1024]`` and per-level, per-orientation detail gains, its loss through
   ``wavedec2`` and ``waverec2`` (db4, 4 levels, float32, periodic and
   reflect), 3 SGD steps on the kernel path against the same steps on the
   plain path on the card (losses within 1e-5 relative, first gradients
   within 1e-4 of their largest entry, the loss falls), the launches of
   one backward (each launch of the round trip's VJP once: K1 <-> K2, K3
   <-> K4) and of one step, the step's and the forward's wall times, and
   a profile of one step (in reflect without gather or scatter kernels);
7. the 1d kernels against their plain versions: K8a/K8b (4 fused levels)
   and K7a/K7b (one level) on ``[32, 1_000_000]``, db5, every padded mode,
   K8b/K7b with waverec's crops; K6a/K6b on ``[32, 2**19]``, 10
   periodization levels.  Float32 at full width, float64 at batch 4; the
   limit is max-abs error over ``max(1, the band's largest magnitude)``,
   2e-5 (float32) and 1e-10 (float64).  Then the VJP instances at the same
   widths, every padded mode: K8a's and K7a's VJP (one synthesis pyramid
   launch with the padding fold, counted as K8b/K7b) and K8b's and K7b's
   (one analysis pyramid launch, counted as K8a/K7a) against autograd
   through the plain versions, each backward's launches asserted, and in
   float64 the adjoint identity; then a user's odd-length bank (7 taps) on
   ``[1, 64]`` periodization and ``[2, 70000]`` reflect, periodic and zero:
   ``wavedec``/``waverec`` on the card against the CPU plain path
   (float64, 1e-10), launching no K6-K8 (their gates decline odd banks);
8. the 1d main path: ``wavedec`` -> ``waverec``, db5, float32, on
   ``[32, 1_000_000]`` with 10 levels in ``periodic`` (the reference's 1d
   speed test) and ``reflect``, on ``[32, 2**19]`` with 10 levels in
   ``periodization`` (K6) and on ``[32, 1_000_000]`` with one level in
   ``reflect`` (K7): coefficients against the plain path on the card under
   phase 7's limits, round trip within 1e-4, and the launches of each run
   (d1: K8a, K8b, K3, K4; K6: K6a, K6b and no K3/K4; K7: K7a, K7b);
9. K5a/K5b (the 2d periodization pyramid) and their VJPs against their
   plain versions, at the two 2d periodization configurations
   (``[16, 1024, 1024]`` db4 4 levels, ``[256, 128, 128]`` db4 3 levels):
   float32 at full width, float64 at batch 2, db4 and coif17 (102 taps;
   where the plan declines a shape it says so, and the per-level route
   runs it); then K5's ragged tiles (``[2, 96, 160]``, 5 levels, db4) and
   coif17 on ``[1, 24, 20]`` (2 levels), float32 and float64; the limit
   is phase 7's, and in float64 the adjoint identity; then the odd bank
   on ``[1, 64, 64]`` (2 levels) and ``[2, 64, 48]`` (1 level)
   periodization against the CPU plain path, launching no K5 and no
   K1/K2;
10. the 2d periodization main path: ``wavedec2`` -> ``waverec2`` in
   ``periodization`` at both configurations, float32: coefficients
   against the plain path within 2e-5, round trip within 1e-4, and the
   launches (K5a/K5b at least once, no K1/K2 where the plan holds the
   chain);
11. training through every configuration of the 2d periodization and 1d
   slices: phase 6's model in ``periodization`` at both 2d
   configurations, and a 1d counterpart (a signal and per-level detail
   gains) at d1 periodic and reflect, K6 and K7: 3 SGD steps on the
   kernel path against the plain path (phase 6's limits), the launches of
   one backward (which must be VJP launches only: K5a/K5b, K6a/K6b, and
   for 1d one pyramid launch per fused run's VJP with six K3 and six K4
   launches for d1's per-level levels 5-10), and the step's wall time;
12. the tensor-core level K9a/K9b, with the opt-in ``PTWT_TPU_MXU2D=1``
   set inside this phase only (phases 3-11 run with it unset): K9a, K9b
   and their VJPs against their plain versions (the GEMM form, autograd
   through it for the VJPs) at ``[16, 1024, 1024]`` db4 level 1, periodic
   and periodization, relative limit 2e-5 and the launch of each call;
   each of the four instances through its wrapper at ``[64, 256, 256]``
   (periodic, periodization), the ragged ``[4, 384, 768]`` (db4 periodic,
   sym6 periodization) and the odd bank (periodic), against its plain
   version at 2e-5, one launch each;
   the opt-in periodic headline round trip (phase 4's limits; K9a and K9b
   once, one K1 and one K2 fewer than phase 4); phase 6's 3 SGD steps with
   the opt-in (the backward launches K9a and K9b as VJPs); phase 5's times
   for K9 and its VJPs (bound: the bytes against the band-only 3xTF32
   products at the TF32 tensor-core peak); a one-pass TF32 debug build's
   error; and the round trip with the opt-in beside the default;
13. launches past 2^31 outputs: one level of ``[32, 8192, 8192]`` float32
   and back in ``periodic`` (K1 writes 2,149,581,312 outputs, K2 2^31) and
   ``reflect`` (K3 and the two-pair K4 2,149,056,512), and K1's VJP on the
   periodic level; the first and the last image against the plain version
   run on that image alone (2e-5); 43 GB of device memory at peak on an
   H100, freed before the phase ends;
14. the 3d and fully separable main paths: ``wavedec3`` -> ``waverec3`` on
   ``[32, 100, 100, 100]`` (db5, 3 levels) and ``fswavedec2`` ->
   ``fswaverec2`` on ``[32, 1000, 1000]`` (db5, 5 levels), float32,
   ``reflect`` (``bench.py``'s d3 and fs2 rows), then every other mode,
   float64, axes not last and ``fswavedec3``/``fswaverec3`` on smaller
   shapes at odd levels: bands and reconstruction against the plain path
   on the card (relative to ``max(1, |band|)``, 2e-5 float32, 1e-10
   float64), round trip within 1e-4, and the launches of each direction
   (K3 once per axis and level; K4 four times per 3d or fs3 level, twice
   per fs2 level; no other kernel); at full width one backward against
   autograd through the plain path (1e-4 of the largest entry, the K3 <->
   K4 twins), each K3/K4 launch of d3's level 1 and its VJP beside its
   bound, with the synthesis level by the JAX package's stacking route
   beside the package's, and the round trip's and the backward's device
   and wall ms and device-busy share (``chip_smoke.py --nd-times``, a
   process of its own: late in a long one the profiler's windows lose
   launches);
15. the stationary and boundary-wavelet matrix transforms
   (``bench.py``'s mat1d, mat2d and swt rows), float32 at full width:
   ``MatrixWavedec("db5", 10)`` -> ``MatrixWaverec`` on ``[32, 10**6]``
   (levels 1-4 one launch of K8a's sameshift instance, then five K3
   launches and a dense product; back five K4 launches and one of K8b's
   sameshift instance: asserted), ``MatrixWavedec2("db4", 4)`` ->
   ``MatrixWaverec2`` on ``[16, 256, 256]`` (dense products only: no
   launch) and ``swt`` -> ``iswt`` (db2, 4 levels) on ``[32, 2**17]`` (no
   launch); then float64, Gram-Schmidt, ``kron`` and ``reference``, 3d, a
   long H with a short W under a lowered cutoff, odd lengths and the swt
   default level at smaller shapes: bands and reconstruction against the
   plain kernel versions on the card (2e-5 float32, 1e-10 float64,
   relative to ``max(1, |band|)``), round trip within 1e-4 (float32);
   one backward through mat1d's round trip against autograd through the
   plain path (1e-4 of the largest entry, its launches asserted); mat2d in
   float32 under a TF32-allowing global matmul precision against float64
   (1e-5); the sameshift K8a and K8b launches alone against their plain
   versions (float32 and float64); and each full-width row's forward,
   round trip (and mat1d's backward) device and wall ms and busy share,
   with the sameshift launches beside their byte bound
   (``chip_smoke.py --mat-times``, a process of its own);
16. the wavelet packet trees and the continuous transform (``bench.py``'s
   wp2d and cwt rows): ``WaveletPacket2D`` on ``[16, 512, 512]`` (db3,
   ``reflect``, maxlevel 3, float32): the full expansion (21 splits, K3
   x42) and ``reconstruct()`` (21 merges, K4 x42), every node against the
   same tree on the plain path on the card (relative to ``max(1,
   |node|)``, 2e-5), the root of the round trip within 1e-4 of the input,
   then with the 64 leaves scaled, and one backward (K3 x42, K4 x42)
   against autograd through the plain path (1e-4 of the largest entry);
   ``WaveletPacket`` on ``[32, 10**6]`` (db5, ``reflect``, maxlevel 3: K7a
   x7, K7b x7); then ``periodic`` (K1 on the even nodes, K3 on the odd),
   ``periodization`` (K5a/K5b), the separable backend and ``boundary``
   (dense products) at full width, float64 at batch 2, and 1d
   ``periodization`` (K6), ``zero`` and ``boundary`` on ``[4, 2**15]`` in
   both dtypes, each direction's launches asserted; ``cwt`` on ``[32,
   10**4]`` (``shan0.1-0.4``, scales 1-30, one FFT size group: three FFT
   calls, no kernel launch) within 1e-5 of the same call in float64 on the
   card, its frequencies the CPU's; seven other wavelets on ``[4, 2048]``
   over two or more FFT sizes, float32 against float64 and float64
   against the CPU (1e-10); three SGD steps on a ``ShannonWavelet``'s
   parameters on the card at the cwt row's width against the same steps
   on the CPU (losses 1e-5 relative, gradients 1e-4 of the largest); and
   each row's device ms (CUDA events), wall ms, busy share and top device
   operations (``chip_smoke.py --pkt-times``, a process of its own);
17. learnable filter banks (``wavelets_learnable.SoftOrthogonalWavelet``
   from db4 or db5, float32): (a) ``examples/learnable_wavelet_compression.py``'s
   step on ``[16, 256]`` (its ``make_batch`` signals, numpy seeded at 0;
   ``wavedec`` ``periodic`` level 4 and ``waverec``; ``0.1 sparsity + 100
   fidelity + 10 quality``), 20 Adam steps (rate 1e-3) on the card and on
   the CPU from the same start; (b) the headline ``[16, 1024, 1024]``,
   ``wavedec2``/``waverec2`` level 4, ``periodic`` and ``reflect``, and (c)
   d1 ``[32, 10**6]`` db5 level 10 ``reflect``, each 3 SGD steps with the
   input requiring grad too, against the plain path on the card: every
   step's launches exact (K3 and K4 once per axis and level, their VJP
   twins, one KT per launch; no other kernel), the first step's gradients
   equal bit for bit in two runs; then KT through its wrapper against its
   plain versions (autograd through the plain levels) at (b)'s level 1
   along -2 and -1 and d1's level 1, and in every mode along axes -1, -2
   and -3 on odd and even lengths, db4, a 7-tap bank and banks of 40 and
   128 taps, K4's one- and two-pair launches, float32 and float64; an
   empty batch (no launch);
   two launches of one gradient (equal bit for bit); K3 against its plain
   version on d1's 10^6-sample level-1 axis; ``wavedec3``, ``fswavedec2``,
   a ``WaveletPacket2D`` split and a ``periodization`` ``wavedec2`` with
   the bank in float64 against the CPU.  Limits: losses 1e-5 relative,
   filter and data gradients 1e-4 of their largest entry (float64: 1e-10).
   Then (``chip_smoke.py --learn-times``, a process of its own) KT at (b)'s
   level 1 along -2 and -1 and at d1's level 1 beside its bound (bytes, or
   float64 multiply-adds at 34 TFLOP/s), its plain version and
   ``torch.nn.grad.conv2d_weight`` / ``conv1d_weight``, and the step of
   (a), (b) and (c): device ms, wall ms and busy share.
18. the tiled multi-device transforms (``ptwt_tpu_torch.parallel``) at
   full width, float32: t2d (``[16, 1024, 1024]``, db4, 4 levels,
   ``periodization`` and ``reflect``, rows over ``spatial``), the t2d grid
   (``periodization``, rows over ``spatial`` and columns over
   ``spatial_w``), td1 (``[32, 10**6]``, db5, 10 levels, ``reflect``) and
   td3 (``[32, 100, 100, 100]``, db5, 3 levels, ``reflect``): (a) on one
   NCCL rank, mesh ``(1, 1)``, every axis local and no P2P call: bands and
   reconstruction against the serial port on the card (relative to
   ``max(1, |band|)``, 2e-5), round trip within 1e-4, the launches of each
   direction (K3/K4 per axis and level, K7a/K7b on d1's levels 1-4), one
   backward through t2d ``reflect`` against autograd through the plain
   path (1e-4 of the largest entry; K4 fold and zero-bounded K3 launches),
   float64 at smaller shapes (1e-10); (b) four processes sharing the card
   (``chip_smoke.py --tiled-rank R --world 4 --store FILE --out DIR``), a
   gloo group whose halo slabs go through host memory: every row on
   ``(1, 4)`` (the grid on ``(1, 2)`` with ``n_spatial_w=2``), rank 0
   holding the gathered bands against the serial port with (a)'s limits
   and every rank's launches against the prediction (the overlapped ring:
   three K3 and three K4 launches a sharded axis and level; td1's level
   1-2 windows on K7a/K7b), the overlapped and ``PTWT_TPU_NO_OVERLAP=1``
   schedules equal bit for bit on t2d ``periodization``, one backward of
   t2d ``periodization`` and ``reflect`` across the ranks (the gradient
   summed over them against the serial one, 1e-4 of the largest entry),
   and each rank's round-trip wall ms with the host ms of its ring steps
   (four processes on one card: not a scaling figure); a rank that fails
   fails the phase;
   (c) (``chip_smoke.py --tiled-times``, a process of its own) the t2d and
   td1 round trips on one rank beside the serial ones: device ms, wall ms,
   busy share.
19. the reduced-precision mode (``chip_smoke.py --prec-times ROW``, a
   process for each row, and ``--prec-times conv``): under ``ops.set_precision("high")`` (TF32 products) and
   ``("default")`` (bfloat16 operands, float32 accumulation and result) in
   turn, with the caller's global settings at a float32 matmul precision of
   ``"medium"`` and cuDNN's TF32 off: the headline ``wavedec2`` ->
   ``waverec2`` in ``periodic``, ``reflect`` and ``periodization``, d3
   (``[32, 100, 100, 100]``, db5, 3 levels, ``reflect``) and d1 (``[32,
   10**6]``, db5, 10 levels, ``periodic``), float32 at full width: bands and
   reconstruction against the float64 transform (max-abs over ``max(1,
   |leaf|)``: 1e-2 for ``"high"``, 2e-1 for ``"default"``), against
   ``"highest"`` (nonzero on every leaf a dense level reached; zero, bit
   for bit, on every leaf of
   ``periodization``, whose levels stay on K5, and on d1's detail bands of
   levels 1-9, which stay on K8 and K3), the launches of each direction
   (none where every axis is at most 2048 samples; K5 as at ``"highest"``;
   d1 one K3 and one K4 fewer, level 10 going dense; never K1, K2 or K9),
   one backward of the round trip against float64 (over the gradient's
   largest entry, ten times the level's limit), the caller's settings
   unchanged, and each row's device ms (CUDA events and the profiler's busy
   time), wall ms, busy share and GEMM kernels beside ``"highest"``'s; then
   ``analysis_conv``/``synthesis_conv`` at the headline's level 1 against
   float64 at each level, ``"highest"`` within 2e-5 with cuDNN's TF32 flag
   left on by the caller.
20. ``torch.compile``, ``torch.func.grad`` and ``torch.func.vmap``
   (``chip_smoke.py --compile-times``, a process of its own): every kernel
   launch is a custom op of ``torch.ops.ptwt_tpu_torch``; each
   ``COMPILE_ROWS`` row at full width (the headline in ``periodic``,
   ``reflect`` and ``periodization``, d1, d3, fs2, swt, cwt, mat1d, mat2d)
   compiled (``fullgraph=True``, static shapes; inductor for the periodic
   headline, ``aot_eager`` for the others: the same graph of ops) against
   eager within 1e-5 of ``max(1, |leaf|)`` with eager's launches per
   kernel; ``torch.func.grad`` of the squared coefficients plus the
   weighted round trip against autograd, and ``torch.func.vmap`` over the
   batch split in two against the batched call, within 1e-5 of the
   largest entry, with equal launches; the learnable headline step (K3,
   K4, KT) compiled, under ``torch.func.grad`` with respect to the filters
   and its forward vmapped; then the headline eager, compiled and under
   ``mode="reduce-overhead"`` (no cudagraph skip, asserted): compile
   seconds, the profiler's device busy ms (the window holding every launch,
   asserted but for the CUDA graph's replay), CUDA-event ms and wall ms.
21. second derivatives (``chip_smoke.py --second-order-times``, a process
   of its own): with ``L`` the sum of the cubed coefficients, the step
   ``x.grad`` of ``|dL/dx|^2`` under eager autograd (``create_graph=True``)
   and under ``torch.func.grad`` of ``torch.func.grad`` at the headline in
   ``periodic``, ``reflect`` and ``periodization`` and d1, float32 against
   the same step on the plain path in float64 (1e-4 of the largest entry;
   the periodic headline also in float64, 1e-10), autograd against
   ``torch.func``, each direction's launches asserted (the second backward
   runs one VJP launch per launch of the forward and of the first); the
   learnable headline's hypergradient ``d|dL/dx|^2 / dfilters`` (K4's fold
   instance's filter gradient on KT) and ``d|dL/dfilters|^2 / dfilters``
   (KT's VJP on K3/K4, its launches read by hooks on KT's nodes); each
   step's profiler busy ms, CUDA-event ms and wall ms; then KT's VJP alone
   against autograd through KT's plain version, its time and bound.
22. the tiled transforms under ``torch.compile`` (``chip_smoke.py
   --tiled-compile-times``, a process of its own): each of phase 18's rows
   at full width, its round trip plus the loss (the sum of the rank's
   squared bands), eager and compiled (``fullgraph=True``, static shapes,
   ``aot_eager``; t2d ``periodization`` also with inductor and, its round
   trip alone, ``mode="reduce-overhead"`` with no cudagraph skip), (a) on
   one NCCL rank with no collective call and (b) on four gloo ranks
   sharing the card (``--tiled-compile-rank R``; the ring steps and edge
   sums functional collectives in the graph): graph breaks 0 and one graph
   (dynamo's counters), launches compiled = eager = ``TILED_LAUNCHES``
   per rank, compiled against eager within 1e-5 of ``max(1, |leaf|)``,
   the round trip within 1e-4, the compiled loss's gradient within 1e-4
   of eager's largest entry, each rank's profiler busy ms, CUDA-event ms,
   wall ms, busy share, host ms inside the collectives and top device
   work, compile seconds; then one float64 row per kind on one rank at
   ``TILED_F64``'s shapes against the serial plain path (1e-10).
23. ``torch.compile`` over ``torch.func`` (``chip_smoke.py
   --compiled-func-times``, a process of its own): float32 at full width, (a) ``torch.func.grad`` of
   ``L`` (the cubed coefficients of the periodic headline), (d)
   ``torch.func.vmap`` of it over the batch of 16 split into samples, (b)
   grad of grad (phase 21's step ``x.grad`` of ``|dL/dx|^2``) at every
   phase 21 row, and (c) the learnable headline's mixed and pure
   hypergradients, each compiled (``fullgraph=True``, static shapes,
   ``aot_eager``; the periodic (b) also inductor): one graph, no break,
   eager ``torch.func``'s launches per kernel, within 1e-5 of its largest
   entry, and within 1e-4 of the float64 plain path; compile seconds and
   the profiler's busy ms, CUDA-event ms, wall ms and busy share, beside
   phase 21's eager autograd step of the same row, or, for (a), (d) and
   the pure term, eager ``torch.func``'s.

Phase 5 also times K5a/K5b beside the per-level K1/K2 route at both 2d
configurations (bound: the bytes of the plan's runs, each run's input read
once and its bands written once; one whole pyramid's bound and the cone
re-reads go to the log), the VJP of every pyramid kernel (K5a-K8b) as the
autograd backward runs it beside autograd through the plain version (and
the K7/K8 VJP launches called directly), and the 2d periodization round
trips in Mpix/s.

``python3 chip_smoke.py --parent DIR`` (``DIR`` a checkout of another
commit, e.g. a ``git archive`` of the parent) also times every
``fwt1d.cu`` instance and the 1d VJPs of both trees in turns (``DIR``,
this tree, this tree, ``DIR``; each run a process of its own, started as
``chip_smoke.py --fwt1d-times --src DIR/src``), then this tree's at other
tile sizes; and in the same way (``--axis-times``) every K3/K4 launch and
VJP at the reflect level 1 and the periodic level 2, the gathers, and the
reflect round trip's and step's device time; and (``--k5-times``) K5a,
K5b, both VJP instances and the per-level K1/K2 route at both 2d
periodization configurations and at ``K5_SMALL_BATCHES``, with the
periodization round trip's and step's launches (counted by the wrappers),
device busy time and wall time; and (``--k9-times``) K9a, K9b and both
VJP instances with the opt-in beside K1, K2 and their VJPs without it at
the periodic level 1 of ``[16, 1024, 1024]`` and ``[64, 256, 256]``, and
the periodic headline round trip with and without the opt-in; and adds
them to the kernels line as ``in_turns``.

Phase 14's ``--nd-times`` also times the plain version and one library
call beside each K3/K4 launch and VJP of d3's level 1.

``python3 chip_smoke.py --kt-turns DIR`` (not part of the smoke test)
times KT at every ``KT_MAIN`` row for ``DIR`` and this tree in turns
(``--kt-times``, four processes) and prints each tree's ptxas registers
and spills and the SASS counts of its KT instances (``--kt-sass``:
``DFMA``, ``F2F.F64.F32``, ``LDS`` and all instructions, over the kernel
and over each innermost loop that holds a ``DFMA``, the tap loop).

``python3 chip_smoke.py --tiled-nccl 4`` (not part of the smoke test; four
cards) runs phases 18 (b) and 22 (b) on NCCL, rank R on card R, with no
host staging.

``python3 chip_smoke.py --dist-probe`` (not part of the smoke test) runs,
each in a world of its own on the one card, an all-reduce on two NCCL
ranks and, on four gloo ranks with CUDA tensors, a send/receive ring, the
collectives and ``DTensor.full_tensor()`` of even and uneven shards, and
prints what each rank got: ok, the error's text, or its exit code.

The last lines are phase 16's ``{"packets_cwt": ...}`` line, phase 17's
``{"learnable": ...}`` line, phase 18's ``{"tiled": ...}`` line, phase 19's
``{"precision": ...}`` line, phase 20's ``{"compile": ...}`` line, phase
21's ``{"second_order": ...}`` line, phase 22's ``{"tiled_compile": ...}``
line, phase 23's ``{"compiled_func": ...}`` line, a
``{"kernels": [...]}`` JSON line (fifteen kernels: KT, the taps'
gradient, last; K3, K4, K7a and K7b with phase 18's ``tiled_launches``,
each with ``vjp_*`` keys; K1 and K2 carry their level-4 times and the
sums per round trip and per step, K3 and K4 their per-launch rows and
phase 14's launches, times and d3 level-1 rows, and phase 16's wp2d
launches; K7a and K7b wp1d's; K8a and K8b a ``sameshift`` row from phase
15), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent


def _arg(name: str):
    """The value after ``name`` on the command line, or None."""
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


# ``--src DIR`` imports the package from another checkout (phase 5 times
# the parent tree that way, in turns with this one)
sys.path.insert(0, _arg("--src") or str(ROOT / "src"))

import ptwt_tpu_torch as ptwt  # noqa: E402
from ptwt_tpu_torch.ops import (  # noqa: E402
    _kernels,
    _pallas,
    _pallas1d,
    _pallas1d_multi,
    _pallas2,
    _mxu2d,
    _pallas2d,
    synthesis_nd,
)
from ptwt_tpu_torch.utils import fwt_pad, get_filter_arrays  # noqa: E402
from ptwt_tpu_torch.wavelets_learnable import SoftOrthogonalWavelet  # noqa: E402

DEVICE = torch.device("cuda")
SEED = 0
SHAPE = (16, 1024, 1024)
ODD = (16, 515, 515)  # level-2 input of the db4 periodic headline
LEVEL4 = (16, 134, 134)  # level-4 input of the db4 periodic headline (-> 4 x 70^2)
WAVELET = "db4"
LEVEL = 4
TOL = {torch.float32: 2e-5, torch.float64: 1e-10}
ROUND_TRIP_TOL = 1e-4
MODES = ("reflect", "zero", "constant", "symmetric", "periodic", "periodization")

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W):
# HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s,
# float64 outside them at 34 TFLOP/s (KT sums in float64).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_F64_FLOP_PER_S = 34e12

REPLACES = {
    "K1": ("src/ptwt_tpu_torch/csrc/dwt2.cu", "src/ptwt_tpu/ops/_pallas2d.py:224"),
    "K2": ("src/ptwt_tpu_torch/csrc/dwt2.cu", "src/ptwt_tpu/ops/_pallas2d.py:253"),
    "K3": ("src/ptwt_tpu_torch/csrc/axis.cu", "src/ptwt_tpu/ops/_pallas2.py:215"),
    "K4": ("src/ptwt_tpu_torch/csrc/axis.cu", "src/ptwt_tpu/ops/_pallas2.py:266"),
    "K5a": ("src/ptwt_tpu_torch/csrc/pyramid2d.cu", "src/ptwt_tpu/ops/_pallas.py:249"),
    "K5b": ("src/ptwt_tpu_torch/csrc/pyramid2d.cu", "src/ptwt_tpu/ops/_pallas.py:321"),
    "K6a": ("src/ptwt_tpu_torch/csrc/fwt1d.cu", "src/ptwt_tpu/ops/_pallas.py:132"),
    "K6b": ("src/ptwt_tpu_torch/csrc/fwt1d.cu", "src/ptwt_tpu/ops/_pallas.py:394"),
    "K7a": ("src/ptwt_tpu_torch/csrc/fwt1d.cu", "src/ptwt_tpu/ops/_pallas1d.py:117"),
    "K7b": ("src/ptwt_tpu_torch/csrc/fwt1d.cu", "src/ptwt_tpu/ops/_pallas1d.py:321"),
    "K8a": ("src/ptwt_tpu_torch/csrc/fwt1d.cu", "src/ptwt_tpu/ops/_pallas1d_multi.py:141"),
    "K8b": ("src/ptwt_tpu_torch/csrc/fwt1d.cu", "src/ptwt_tpu/ops/_pallas1d_multi.py:529"),
    "K9a": ("src/ptwt_tpu_torch/csrc/mxu2d.cu", "src/ptwt_tpu/ops/_mxu2d.py:175"),
    "K9b": ("src/ptwt_tpu_torch/csrc/mxu2d.cu", "src/ptwt_tpu/ops/_mxu2d.py:202"),
}
KERNELS_1D = ("K6a", "K6b", "K7a", "K7b", "K8a", "K8b")
# K1 and K2 are each other's VJP, and so are K3 and K4 (K3's VJP is K4's
# fold instance, K4's a zero-bounded K3): their VJP launches get rows of
# their own; the TPU kernels whose contracts the VJP instances carry
VJP_ROWS = ("K1 VJP", "K2 VJP", "K3 VJP", "K4 VJP")
VJP_OF = {"K1": "K2", "K2": "K1", "K3": "K4", "K4": "K3"}
VJP_REPLACES = {"K3": "src/ptwt_tpu/ops/_pallas2.py:238", "K4": "src/ptwt_tpu/ops/_pallas2.py:293"}
ADJOINT_TOL = 1e-12
COIF_SHAPE = (4, 37, 37)  # coif17's 102 taps wrap this axis several times
# the default mode's level 1 at the headline (K3 along H on SHAPE, along W
# on the packed [2, 16, 515, 1024]; K4 with two pairs along W and one
# along H, the (6, 6) crop)
REFLECT_1 = "reflect"
# K1/K2's tiles: float64 banks at both ends of the registry at a small
# batch, and an odd periodization image (K1's VJP takes the clamp)
TILE_F64 = (2, 134, 134)
ODD_PER = (4, 133, 135)
# phase 13: one level of this float32 batch writes more than 2^31 outputs
BIG = (32, 8192, 8192)
TRAIN_STEPS = 3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# the 1d slice: bench.py's d1 row (db5, 10 levels, [32, 1e6]) and the K6
# pyramid at the JAX package's longest fused length
D1_SHAPE = (32, 1_000_000)
K6_SHAPE = (32, 2**19)
WAVELET_1D = "db5"
LEVEL_1D = 10
BATCH_F64_1D = 4
PADDED_MODES = ("zero", "reflect", "periodic", "symmetric", "constant")
# the 2d periodization slice: the headline's width, and small images
# inside the JAX package's own K5 domain (tests/test_pallas.py:59)
SMALL_SHAPE = (256, 128, 128)
SMALL_LEVEL = 3
PER_2D = (("headline", SHAPE, LEVEL), ("small", SMALL_SHAPE, SMALL_LEVEL))
LONG_WAVELET = "coif17"
BATCH_F64_2D = 2
KERNELS_K5 = ("K5a", "K5b")
# K5's ragged tiles (not a power of two) and a long bank on a small image
K5_EXTRA = (((2, 96, 160), 5, WAVELET), ((1, 24, 20), 2, LONG_WAVELET))
#: Small batches of images that fit one K5 block, timed in turns beside
#: ``PER_2D``: the model of ``examples/network_compression.py`` (one
#: ``[64, 128]`` image, db3, 3 levels) and 16 crops.
K5_SMALL_BATCHES = (("example", (1, 64, 128), 3, "db3"), ("batch 16", (16, 128, 128), 3, WAVELET))
# the tensor-core level (opt-in): TF32 tensor-core peak (NVIDIA data sheet,
# dense, at 700 W), three products per multiply-add for the 3xTF32 split
KERNELS_K9 = ("K9a", "K9b")
MXU2D_ENV = "PTWT_TPU_MXU2D"
PEAK_TF32_FLOP_PER_S = 495e12
TF32_SPLIT = 3
#: K9's periodic level 1 at the headline and at the smallest image its gate
#: takes, where a block's fixed cost shows; ``--k9-times`` times both
K9_SHAPES = (("headline", SHAPE), ("small", (64, 256, 256)))
#: Phase 12's other launches, each K9 instance against its plain version:
#: (shape, bank, mode); a ragged image (m = 195 x 387 in periodic) and an
#: odd bank beside the headline
K9_EXTRA = (
    ((64, 256, 256), "db4", "periodic"),
    ((64, 256, 256), "db4", "periodization"),
    ((4, 384, 768), "db4", "periodic"),
    ((4, 384, 768), "sym6", "periodization"),
    ((4, 384, 768), "odd7", "periodic"),
)
#: An odd-length bank (a user's 7 taps; no registry wavelet has one) on the
#: inputs whose pyramid and long-lane gates decline it: (shape, mode,
#: level), float64 on the card against the CPU plain path
ODD_BANK_1D = (((1, 64), "periodization", 2), ((2, 70000), "reflect", 2),
               ((2, 70000), "periodic", 1), ((2, 70000), "zero", 3))
ODD_BANK_2D = (((1, 64, 64), "periodization", 2), ((2, 64, 48), "periodization", 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite output")
    return float((a - b).abs().max())


def check(name: str, err: float, tol: float) -> float:
    log(f"  {name}: max_abs={err!r} (tol {tol!r})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs {err!r} exceeds {tol!r}")
    return err


WRAPPER_MODULES = (_pallas, _pallas1d, _pallas1d_multi, _pallas2, _pallas2d)


@contextlib.contextmanager
def plain_versions():
    """Route the kernel wrappers to their plain versions, on any device."""
    saved = [module._on_cpu for module in WRAPPER_MODULES]
    for module in WRAPPER_MODULES:
        module._on_cpu = lambda t: True
    try:
        yield
    finally:
        for module, fn in zip(WRAPPER_MODULES, saved):
            module._on_cpu = fn


def std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


def randn(shape, dtype, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=DEVICE, dtype=dtype)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(errors: dict) -> None:
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=dtype)
        _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=dtype)
        p = std_pad(len(dl))
        x = randn(SHAPE, dtype, SEED + 1)
        for mode in ("periodic", "periodization"):
            got = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
            ref = _pallas2d.dwt2_level_plain(x, dl, dh, mode)
            err = check(f"K1 {mode} {dtype}", max_abs(got, ref), tol)
            errors["K1"][dtype] = max(errors["K1"].get(dtype, 0.0), err)
            pp = 0 if mode == "periodization" else p
            got = _pallas2d.fused2_idwt_level(ref, rl, rh, mode)
            back = _pallas2d.idwt2_level_plain(ref, rl, rh, mode, [(pp, pp)] * 2)
            err = check(f"K2 {mode} {dtype}", max_abs(got, back), tol)
            errors["K2"][dtype] = max(errors["K2"].get(dtype, 0.0), err)
            check(f"K2(K1) {mode} round trip {dtype}", max_abs(got, x), 10 * tol)
        del x
        # K3/K4 along both axes of the level-2 size, with the main path's
        # odd crop: 261 -> 515 keeps one sample less
        xo = randn(ODD, dtype, SEED + 2)
        for mode in MODES:
            for axis in (-2, -1):
                axis_case(errors, xo, dl, dh, rl, rh, mode, axis, f"{mode} axis {axis}")
        del xo
        torch.cuda.synchronize()
    # coif17 (102 taps) on 37 samples in every padded mode and
    # periodization, float64: reads that wrap the axis several times
    f64 = torch.float64
    cl, ch, _, _ = get_filter_arrays(LONG_WAVELET, flip=True, dtype=f64)
    _, _, crl, crh = get_filter_arrays(LONG_WAVELET, flip=False, dtype=f64)
    xc = randn(COIF_SHAPE, f64, SEED + 3)
    for mode in MODES:
        for axis in (-2, -1):
            axis_case(errors, xc, cl, ch, crl, crh, mode, axis, f"coif17/37 {mode} axis {axis}")
    del xc
    # the default mode's level 1 at the headline, float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=torch.float32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=torch.float32)
    x = randn(SHAPE, torch.float32, SEED + 1)
    rows = axis_case(errors, x, dl, dh, rl, rh, REFLECT_1, -2, f"{REFLECT_1} level 1 axis -2")
    axis_case(errors, rows, dl, dh, rl, rh, REFLECT_1, -1, f"{REFLECT_1} level 1 axis -1")
    del x, rows
    torch.cuda.synchronize()


def crop_of(mode: str, filt_len: int, n: int, m: int) -> tuple[int, int]:
    """The synthesis crop that rebuilds ``n`` samples from a band of ``m``."""
    if mode == "periodization":
        return 0, 2 * m - n
    p = std_pad(filt_len)
    return p, 2 * (m - 1) + filt_len - p - n


def axis_case(errors: dict, x, dl, dh, rl, rh, mode: str, axis: int, tag: str) -> torch.Tensor:
    """K3 along ``axis`` and K4 back (two pairs along the last axis, one
    along another) against their plain versions, and the round trip;
    returns K3's packed output."""
    dtype = x.dtype
    tol = TOL[dtype]
    got = _pallas2.pallas_dwt_axis(x, axis, dl, dh, mode)
    lo, hi = _pallas2.dwt_axis_plain(x, axis, dl, dh, mode)
    record(errors, "K3", dtype, check(f"K3 {tag} {dtype}", max_abs(got, torch.stack((lo, hi))), tol))
    crop = crop_of(mode, len(dl), x.shape[axis], lo.shape[axis])
    pairs = ((lo, hi), (hi, lo)) if axis == -1 else ((lo, hi),)
    rec = _pallas2.pallas_idwt_axis([a for a, _ in pairs], [b for _, b in pairs], axis, rl, rh, *crop, mode)
    ref = torch.stack([_pallas2.idwt_axis_plain(a, b, axis, rl, rh, *crop, mode) for a, b in pairs])
    record(errors, "K4", dtype, check(f"K4 {tag} {dtype}", max_abs(rec, ref), tol))
    check(f"K4(K3) {tag} round trip {dtype}", max_abs(rec[0], x), 10 * tol)
    return got


def check_goldens() -> None:
    """Replay the repo's frozen pywt 2d goldens on the card (float64)."""
    data = np.load(ROOT / "tests" / "data" / "transform_goldens.npz")

    def signal(n):
        t = np.arange(n, dtype=np.float64)
        return np.sin(0.37 * t) + 0.05 * t + np.cos(1.7 * t + 0.5)

    image = np.outer(signal(24), signal(20)) + signal(24 * 20).reshape(24, 20)
    img = torch.as_tensor(image, device=DEVICE)
    keys = sorted({k.rsplit("/", 1)[0] for k in data.files if k.startswith("wavedec2/")})
    worst = 0.0
    for key in keys:
        _, name, mode = key.split("/")
        got = ptwt.wavedec2(img, name, mode=mode, level=2)
        flat = [got[0]] + [b for t in got[1:] for b in t]
        for i, g in enumerate(flat):
            want = torch.as_tensor(data[f"{key}/{i}"], device=DEVICE)
            worst = max(worst, max_abs(g, want))
    check(f"{len(keys)} frozen wavedec2 goldens (float64)", worst, 1e-9)


# ---------------------------------------------------------------------------
# phase 3b: the VJP kernels against their plain versions
# ---------------------------------------------------------------------------


def record(errors: dict, name: str, dtype, err: float) -> None:
    errors[name][dtype] = max(errors[name].get(dtype, 0.0), err)


def adjoint(name: str, outs, cts, ins, grads) -> None:
    """``<K x, y> = <x, K^T y>`` relative to ``|K x| |y|`` (float64)."""
    lhs = sum(float((o * c).sum()) for o, c in zip(outs, cts))
    rhs = sum(float((i * g).sum()) for i, g in zip(ins, grads))
    scale = (
        sum(float((o**2).sum()) for o in outs) * sum(float((c**2).sum()) for c in cts)
    ) ** 0.5
    check(f"{name} adjoint identity (relative)", abs(lhs - rhs) / scale, ADJOINT_TOL)


def leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


def axis_vjps(errors: dict, x, dl, dh, rl, rh, mode: str, axis: int, tag: str) -> torch.Tensor:
    """K3's VJP (one K4 launch, the fold instance) and K4's (one K3 launch,
    zero-bounded; two pairs along the last axis) through autograd against
    the plain VJPs, one mode and axis, each backward's launches asserted;
    returns K3's packed output."""
    dtype = x.dtype
    tol = TOL[dtype]
    out = _pallas2.pallas_dwt_axis(x, axis, dl, dh, mode)
    ct = randn(out.shape, dtype, SEED + 20)
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(out, x, ct)
    only(dict(_kernels.LAUNCHES), {"K4": 1}, f"K3's VJP {tag}")
    ref = _pallas2.dwt_axis_vjp_plain(x, axis, dl, dh, mode, ct)
    record(errors, "K3 VJP", dtype, check(f"K3 VJP (K4) {tag} {dtype}", max_abs(got, ref), tol))
    if dtype == torch.float64:
        adjoint(f"K3 VJP {tag}", [out], [ct], [x], [got])
    lo, hi = leaf(out[0]), leaf(out[1])
    crop = crop_of(mode, len(dl), x.shape[axis], lo.shape[axis])
    pairs = ((lo, hi), (hi, lo)) if axis == -1 else ((lo, hi),)
    rec = _pallas2.pallas_idwt_axis(
        [a for a, _ in pairs], [b for _, b in pairs], axis, rl, rh, *crop, mode
    )
    ct = randn(rec.shape, dtype, SEED + 21)
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, (lo, hi), ct)
    only(dict(_kernels.LAUNCHES), {"K3": 1}, f"K4's VJP {tag}")
    ref = [torch.zeros_like(lo), torch.zeros_like(hi)]
    for (a, b), c in zip(pairs, ct):
        ga, gb = _pallas2.idwt_axis_vjp_plain(a, b, axis, rl, rh, *crop, mode, c)
        ref[0 if a is lo else 1] += ga
        ref[0 if b is lo else 1] += gb
    record(errors, "K4 VJP", dtype, check(f"K4 VJP (K3) {tag} {dtype}", max_abs(got, ref), tol))
    if dtype == torch.float64:
        adjoint(f"K4 VJP {tag}", [rec], [ct], [lo, hi], got)
    return out.detach()


def check_vjps(errors: dict) -> None:
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=dtype)
        _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=dtype)
        p = std_pad(len(dl))
        x = leaf(randn(SHAPE, dtype, SEED + 5))
        for mode in ("periodic", "periodization"):
            bands = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
            cts = [randn(b.shape, dtype, SEED + 10 + i) for i, b in enumerate(bands)]
            (got,) = torch.autograd.grad(bands, x, cts)
            ref = _pallas2d.dwt2_level_vjp_plain(x, dl, dh, mode, cts)
            err = check(f"K1 VJP (K2) {mode} {dtype}", max_abs(got, ref), tol)
            record(errors, "K1 VJP", dtype, err)
            if dtype == torch.float64:
                adjoint(f"K1 {mode}", bands, cts, [x], [got])
            pp = 0 if mode == "periodization" else p
            subbands = [leaf(b) for b in bands]
            rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, mode)
            ct = randn(rec.shape, dtype, SEED + 14)
            got = torch.autograd.grad(rec, subbands, ct)
            ref = _pallas2d.idwt2_level_vjp_plain(subbands, rl, rh, mode, [(pp, pp)] * 2, ct)
            err = check(f"K2 VJP (K1) {mode} {dtype}", max_abs(got, ref), tol)
            record(errors, "K2 VJP", dtype, err)
            if dtype == torch.float64:
                adjoint(f"K2 {mode}", [rec], [ct], subbands, got)
            del bands, cts, subbands, rec, ct, got, ref
        del x
        xo = leaf(randn(ODD, dtype, SEED + 6))
        for mode in MODES:
            for axis in (-2, -1):
                axis_vjps(errors, xo, dl, dh, rl, rh, mode, axis, f"{mode} axis {axis}")
        del xo
        torch.cuda.synchronize()
    # coif17 (102 taps) on 37 samples in every mode, float64 (reads that
    # wrap the axis several times; the fold collects every wrap)
    f64 = torch.float64
    cl, ch, _, _ = get_filter_arrays(LONG_WAVELET, flip=True, dtype=f64)
    _, _, crl, crh = get_filter_arrays(LONG_WAVELET, flip=False, dtype=f64)
    xc = leaf(randn(COIF_SHAPE, f64, SEED + 7))
    for mode in MODES:
        for axis in (-2, -1):
            axis_vjps(errors, xc, cl, ch, crl, crh, mode, axis, f"coif17/37 {mode} axis {axis}")
    del xc
    # the default mode's level 1 at the headline, float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=torch.float32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=torch.float32)
    x = leaf(randn(SHAPE, torch.float32, SEED + 5))
    rows = axis_vjps(errors, x, dl, dh, rl, rh, REFLECT_1, -2, f"{REFLECT_1} level 1 axis -2")
    axis_vjps(errors, leaf(rows), dl, dh, rl, rh, REFLECT_1, -1, f"{REFLECT_1} level 1 axis -1")
    del x, rows
    torch.cuda.synchronize()


def k1_k2_case(errors: dict, shape, dtype, wavelet: str, mode: str, seed: int) -> None:
    """K1, K1's VJP, and (even images) K2 and K2's VJP against their plain
    versions on one level of ``shape``; the adjoint identity in float64."""
    tol = TOL[dtype]
    tag = f"{wavelet} {mode} {list(shape)} {dtype}"
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=dtype)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=dtype)
    x = leaf(randn(shape, dtype, seed))
    bands = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
    ref = _pallas2d.dwt2_level_plain(x, dl, dh, mode)
    record(errors, "K1", dtype, check(f"K1 {tag}", max_abs(bands, ref), tol))
    cts = [randn(b.shape, dtype, seed + 1 + i) for i, b in enumerate(bands)]
    (got,) = torch.autograd.grad(bands, x, cts)
    want = _pallas2d.dwt2_level_vjp_plain(x, dl, dh, mode, cts)
    record(errors, "K1 VJP", dtype, check(f"K1 VJP (K2) {tag}", max_abs(got, want), tol))
    if dtype == torch.float64:
        adjoint(f"K1 {tag}", bands, cts, [x], [got])
    if shape[-1] % 2 or shape[-2] % 2:
        return  # K2 reconstructs even images only
    pp = 0 if mode == "periodization" else std_pad(len(dl))
    subbands = [leaf(r) for r in ref]
    rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, mode)
    back = _pallas2d.idwt2_level_plain(subbands, rl, rh, mode, [(pp, pp)] * 2)
    record(errors, "K2", dtype, check(f"K2 {tag}", max_abs(rec, back), tol))
    ct = randn(rec.shape, dtype, seed + 5)
    grads = torch.autograd.grad(rec, subbands, ct)
    want = _pallas2d.idwt2_level_vjp_plain(subbands, rl, rh, mode, [(pp, pp)] * 2, ct)
    record(errors, "K2 VJP", dtype, check(f"K2 VJP (K1) {tag}", max_abs(grads, want), tol))
    if dtype == torch.float64:
        adjoint(f"K2 {tag}", [rec], [ct], subbands, grads)


def check_tiles(errors: dict) -> None:
    """K1/K2 and both VJPs beyond the headline's level 1: level 4 in both
    dtypes, haar and coif17 in float64 at a small batch, an odd
    periodization image."""
    cases = [(LEVEL4, d, WAVELET) for d in (torch.float32, torch.float64)]
    cases += [(TILE_F64, torch.float64, w) for w in ("haar", "coif17")]
    seed = SEED + 100
    for shape, dtype, wavelet in cases:
        for mode in ("periodic", "periodization"):
            k1_k2_case(errors, shape, dtype, wavelet, mode, seed)
            seed += 10
    for dtype in (torch.float32, torch.float64):
        k1_k2_case(errors, ODD_PER, dtype, WAVELET, "periodization", seed)
        seed += 10
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def flat_coeffs(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


@contextlib.contextmanager
def counting_pads(calls: list):
    """Count the padding gathers ``ops/_pallas2`` runs (its plain version's
    ``fwt_pad``) while the block runs."""
    saved = _pallas2.fwt_pad

    def counted(*args, **kwargs):
        calls.append(args[0].device)
        return saved(*args, **kwargs)

    _pallas2.fwt_pad = counted
    try:
        yield
    finally:
        _pallas2.fwt_pad = saved


def main_path(x: torch.Tensor, mode: str) -> dict:
    _kernels.reset_launch_counts()
    pads = []
    with counting_pads(pads):
        coeffs = ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL)
        rec = ptwt.waverec2(coeffs, WAVELET, mode=mode)
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    log(f"  {mode}: launches per round trip {counts}")
    if pads:
        raise AssertionError(f"the {mode} round trip ran {len(pads)} padding gathers on the kernel path")
    with plain_versions():
        ref = ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL)
        ref_rec = ptwt.waverec2(ref, WAVELET, mode=mode)
    shapes = [tuple(c.shape) for c in flat_coeffs(coeffs)[:2]]
    log(f"  {mode}: cA/H shapes {shapes}")
    coeff_err = check(f"{mode} coefficients vs plain path", max_abs(flat_coeffs(coeffs), flat_coeffs(ref)), 2e-5)
    check(f"{mode} reconstruction vs plain path", max_abs(rec, ref_rec), 2e-5)
    rt_err = check(f"{mode} round trip vs input", max_abs(rec, x), ROUND_TRIP_TOL)
    return {"counts": counts, "coeff_err": coeff_err, "round_trip_err": rt_err}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events.

    A sleep kernel ahead of each timed call keeps the device busy while
    the host prepares the call, so the events bracket device work only;
    it lasts some 10 ms, longer than a loaded host takes to enqueue a
    backward of several launches through the autograd engine.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median host time of one call ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def outer_filters(a, b, dtype):
    """The four outer-product filters ``[4, 1, L, L]`` in (ll, lh, hl, hh)
    order, ``lh`` = hi on H."""
    a = torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)
    b = torch.as_tensor(np.asarray(b), dtype=dtype, device=DEVICE)
    return torch.stack(
        [torch.outer(a, a), torch.outer(b, a), torch.outer(a, b), torch.outer(b, b)]
    )[:, None]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def analysis_flops(b: int, h: int, w: int, m_h: int, m_w: int, L: int) -> float:
    # separable minimum: W pass (lo+hi per output, h rows) then H pass on
    # both W bands; one multiply-add = 2 operations
    return 2.0 * b * (h * m_w * 2 * L + 2 * m_h * m_w * 2 * L)


def synthesis_flops(b: int, m_h: int, m_w: int, out_h: int, out_w: int, L: int) -> float:
    # each output sample of a stride-2 transposed pass takes L/2 taps from
    # each of two bands: W pass on 2 H-bands, then the H pass
    return 2.0 * b * (2 * m_h * out_w * L + out_h * out_w * L)


def time_k1_k2(shape) -> dict:
    """K1, K2 and their VJPs on one periodic level of ``shape`` (float32):
    ``shape`` -> 4 bands and back, each VJP called as the autograd
    Functions' backward calls it; the bytes of a VJP are its forward
    twin's."""
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    p = std_pad(L)
    size = 4
    rows = {}
    dfilt = outer_filters(dl, dh, f32)
    rfilt = outer_filters(rl, rh, f32)
    b, h, w = shape
    tag = f"[{b}, {h}, {w}]"

    # K1: shape -> 4 x m^2
    x = randn(shape, f32, SEED + 3)
    bands = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
    m = bands[0].shape[-1]
    xpad = F.pad(x[:, None], (p, p, p, p), mode="circular")
    lib = F.conv2d(xpad, dfilt, stride=2)
    log(f"  K1 {tag} library yardstick vs kernel max_abs={max_abs(lib.transpose(0, 1).contiguous(), torch.stack(bands))!r}")
    rows["K1"] = {
        "ms": time_ms(lambda: _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")),
        "plain_ms": time_ms(lambda: _pallas2d.dwt2_level_plain(x, dl, dh, "periodic")),
        "library_ms": time_ms(lambda: F.conv2d(xpad, dfilt, stride=2)),
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del xpad, lib

    # K2: the inverse level, 4 x m^2 -> shape (standard crop)
    stacked = torch.stack(bands, dim=1).contiguous()
    lib = F.conv_transpose2d(stacked, rfilt, stride=2)[:, 0, p:-p, p:-p]
    rec = _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic")
    log(f"  K2 {tag} library yardstick vs kernel max_abs={max_abs(lib, rec)!r}")
    rows["K2"] = {
        "ms": time_ms(lambda: _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic")),
        "plain_ms": time_ms(
            lambda: _pallas2d.idwt2_level_plain(bands, rl, rh, "periodic", [(p, p)] * 2)
        ),
        "library_ms": time_ms(lambda: F.conv_transpose2d(stacked, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    del x, bands, stacked, lib, rec

    # K1's VJP: K2 with the fold, 4 x m^2 -> shape (periodic)
    x = leaf(randn(shape, f32, SEED + 8))
    bands = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
    cts = torch.stack([randn(bands[0].shape, f32, SEED + 30 + i) for i in range(4)])
    fold = (h // 2, w // 2, h, w)

    def k1_vjp():
        return _pallas2d._idwt2_kernel(cts.unbind(0), dl, dh, h, w, p, True, fold)

    (auto,) = torch.autograd.grad(bands, x, tuple(cts))
    log(f"  K1 VJP {tag} timed call vs autograd max_abs={max_abs(k1_vjp(), auto)!r}")
    cts_nchw = cts.transpose(0, 1).contiguous()
    rows["K1 VJP"] = {
        "ms": time_ms(k1_vjp),
        "plain_ms": time_ms(
            lambda: _pallas2d.dwt2_level_vjp_plain(x, dl, dh, "periodic", cts.unbind(0))
        ),
        # the strided transposed convolution before its circular fold
        "library_ms": time_ms(lambda: F.conv_transpose2d(cts_nchw, dfilt, stride=2)),
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del bands, auto, cts_nchw

    # K2's VJP: K1 zero-bounded, shape -> 4 x m^2 (periodic)
    subbands = [leaf(c) for c in cts.unbind(0)]
    rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, "periodic")
    ct = randn(rec.shape, f32, SEED + 34)

    def k2_vjp():
        return _pallas2d._dwt2_kernel(ct, rl, rh, h, w, m, m, p, False)

    auto = torch.autograd.grad(rec, subbands, ct)
    log(f"  K2 VJP {tag} timed call vs autograd max_abs={max_abs(tuple(k2_vjp()), auto)!r}")
    ct_pad = F.pad(ct[:, None], (p, p, p, p))
    lib = F.conv2d(ct_pad, rfilt, stride=2)
    log(f"  K2 VJP {tag} library yardstick vs kernel max_abs={max_abs(lib.transpose(0, 1).contiguous(), k2_vjp())!r}")
    rows["K2 VJP"] = {
        "ms": time_ms(k2_vjp),
        "plain_ms": time_ms(
            lambda: _pallas2d.idwt2_level_vjp_plain(subbands, rl, rh, "periodic", [(p, p)] * 2, ct)
        ),
        "library_ms": time_ms(lambda: F.conv2d(ct_pad, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    del x, cts, subbands, rec, ct, auto, ct_pad
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
    return rows


def time_kernels(copy_gbps: float) -> tuple[dict, dict]:
    """Phase 5's rows of K1-K4 and their VJPs at the headline's levels; K1,
    K2 and their VJPs also at level 4 (the second rows)."""
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    p = std_pad(L)
    size = 4
    dfilt = outer_filters(dl, dh, f32)
    rfilt = outer_filters(rl, rh, f32)
    rows = time_k1_k2(SHAPE)
    rows4 = time_k1_k2(LEVEL4)

    # K3: level 2 of the headline, one 2d level as two K3 passes,
    # [16, 515, 515] -> 4 x 261^2 (odd periodic)
    xo = randn(ODD, f32, SEED + 4)
    b, h, w = ODD

    def k3_level():
        rows_ = _pallas2.pallas_dwt_axis(xo, -2, dl, dh, "periodic")
        return _pallas2.pallas_dwt_axis(rows_, -1, dl, dh, "periodic")

    both = k3_level()
    m = both.shape[-1]
    xpad = F.pad(xo[:, None], (p, p + 1, p, p + 1), mode="circular")
    lib = F.conv2d(xpad, dfilt, stride=2)
    mine = torch.stack([both[0, 0], both[0, 1], both[1, 0], both[1, 1]], dim=1)
    log(f"  K3 library yardstick vs kernel max_abs={max_abs(lib, mine)!r}")
    rows["K3"] = {
        "ms": time_ms(k3_level),
        "plain_ms": time_ms(lambda: _pallas2d.dwt2_level_plain(xo, dl, dh, "periodic")),
        "library_ms": time_ms(lambda: F.conv2d(xpad, dfilt, stride=2)),
        # the level: the image read once, four bands written once
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del xpad, lib

    # K4: the inverse level, 4 x 261^2 -> [16, 515, 515] (odd crop p, p+1)
    ll, lh, hl, hh = both[0, 0], both[0, 1], both[1, 0], both[1, 1]

    def k4_level():
        cols = _pallas2.pallas_idwt_axis((ll, lh), (hl, hh), -1, rl, rh, p, p + 1, "periodic")
        return _pallas2.pallas_idwt_axis((cols[0],), (cols[1],), -2, rl, rh, p, p + 1, "periodic")[0]

    stacked = mine.contiguous()
    lib = F.conv_transpose2d(stacked, rfilt, stride=2)[:, 0, p : -(p + 1), p : -(p + 1)]
    log(f"  K4 library yardstick vs kernel max_abs={max_abs(lib, k4_level())!r}")
    rows["K4"] = {
        "ms": time_ms(k4_level),
        "plain_ms": time_ms(
            lambda: _pallas2d.idwt2_level_plain(
                (ll, lh, hl, hh), rl, rh, "periodic", [(p, p + 1)] * 2
            )
        ),
        "library_ms": time_ms(lambda: F.conv_transpose2d(stacked, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    rows.update(time_vjps())
    for level, table in ((1, rows), (4, rows4)):
        for name, row in table.items():
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
            row["copy_bound_ms"] = row["bytes"] / (copy_gbps * 1e9) * 1e3
            log(
                f"  {name}{' level 4' if level == 4 else ''}: ms={row['ms']!r} "
                f"plain_ms={row['plain_ms']!r} library_ms={row['library_ms']!r} "
                f"bound_ms={row['bound_ms']!r} ({row['bound_by']}) copy_bound_ms={row['copy_bound_ms']!r}"
            )
    for name in rows4:
        log(f"  {name}: per round trip or step (levels 1 + 4) {rows[name]['ms'] + rows4[name]['ms']!r} ms")
    return rows, rows4


def time_vjps() -> dict:
    """K3's and K4's VJPs at phase 5's K3/K4 level (periodic, [16, 515,
    515] <-> 4 x 261^2, two launches each way), as the autograd backward
    runs them (K3's VJP is K4's fold instance, K4's a zero-bounded K3),
    against autograd through the plain versions and one library call;
    the bytes are the forward twin's."""
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    p = std_pad(L)
    size = 4
    rows = {}
    dfilt = outer_filters(dl, dh, f32)
    rfilt = outer_filters(rl, rh, f32)
    b, h, w = ODD

    # K3's VJP: the backward of the level [16, 515, 515] -> 4 x 261^2
    xo = leaf(randn(ODD, f32, SEED + 9))
    both = _pallas2.pallas_dwt_axis(_pallas2.pallas_dwt_axis(xo, -2, dl, dh, "periodic"), -1, dl, dh, "periodic")
    m = both.shape[-1]
    ct = randn(both.shape, f32, SEED + 35)
    ct_nchw = torch.stack([ct[0, 0], ct[0, 1], ct[1, 0], ct[1, 1]], dim=1).contiguous()

    def k3_plain_vjp():
        with torch.enable_grad():
            z = leaf(xo)
            out = _pallas2d.dwt2_level_plain(z, dl, dh, "periodic")
            return torch.autograd.grad(out, z, (ct[0, 0], ct[0, 1], ct[1, 0], ct[1, 1]))

    rows["K3 VJP"] = {
        "ms": time_ms(lambda: torch.autograd.grad(both, xo, ct, retain_graph=True)),
        "plain_ms": time_ms(k3_plain_vjp),
        # the strided transposed convolution before its circular fold
        "library_ms": time_ms(lambda: F.conv_transpose2d(ct_nchw, dfilt, stride=2)),
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del both, ct_nchw

    # K4's VJP: the backward of the level 4 x 261^2 -> [16, 515, 515]
    # (odd crop p, p + 1)
    subbands = [leaf(c) for c in (ct[0, 0], ct[0, 1], ct[1, 0], ct[1, 1])]
    ll, lh, hl, hh = subbands
    cols = _pallas2.pallas_idwt_axis((ll, lh), (hl, hh), -1, rl, rh, p, p + 1, "periodic")
    rec = _pallas2.pallas_idwt_axis((cols[0],), (cols[1],), -2, rl, rh, p, p + 1, "periodic")
    g = randn(rec.shape, f32, SEED + 36)
    # the adjoint of the transposed convolution cropped by (p, p + 1) is
    # the strided convolution of the cotangent zero-padded by (p, p + 1)
    g_pad = F.pad(g[0][:, None], (p, p + 1, p, p + 1))
    lib = F.conv2d(g_pad, rfilt, stride=2)
    auto = torch.autograd.grad(rec, subbands, g, retain_graph=True)
    log(f"  K4 VJP library yardstick vs kernel max_abs={max_abs(lib, torch.stack(auto, dim=1))!r}")

    def k4_plain_vjp():
        return _pallas2d.idwt2_level_vjp_plain(
            subbands, rl, rh, "periodic", [(p, p + 1)] * 2, g[0]
        )

    rows["K4 VJP"] = {
        "ms": time_ms(lambda: torch.autograd.grad(rec, subbands, g, retain_graph=True)),
        "plain_ms": time_ms(k4_plain_vjp),
        "library_ms": time_ms(lambda: F.conv2d(g_pad, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    return rows


def axis_filters(taps_a, taps_b, along: int, dtype):
    """``[2, 1, L, 1]`` (``along`` -2) or ``[2, 1, 1, L]`` filters of one
    axis pass, for the library yardsticks."""
    f = torch.stack([torch.as_tensor(np.asarray(t), dtype=dtype, device=DEVICE) for t in (taps_a, taps_b)])
    return f[:, None, :, None] if along == -2 else f[:, None, None, :]


def axis_times(full: bool = False) -> dict:
    """Device ms of every K3/K4 launch and of their VJPs (as the autograd
    backward runs them), one axis pass each, at the default mode's level
    1 of the headline (``reflect``, ``[16, 1024, 1024]``: K3 along -2, K3
    along -1 on the packed ``[2, 16, 515, 1024]``, the two-pair K4 along
    -1 and the one-pair K4 along -2 with the (6, 6) crop) and at the
    periodic level 2 (``[16, 515, 515]``, the odd crop), float32 db4;
    for ``reflect`` also the padding gather a tree may run before K3 and
    its backward (``fwt_pad``).  Only public entry points, so either
    tree's package runs it: the rows phase 5 compares with the parent in
    turns.  ``full`` adds each row's plain ms, bytes (each input read
    once, each output written once) and, for ``reflect``, one library
    call on an input padded beforehand (``F.conv2d`` /
    ``F.conv_transpose2d``, before any crop or fold)."""
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    rows = {}

    def row(name, run, ins, outs, plain=None, library=None):
        entry = {"ms": time_ms(run)}
        if full:
            entry["bytes"] = 4 * (sum(t.numel() for t in ins) + sum(t.numel() for t in outs))
            entry["bound_ms"] = entry["bytes"] / PEAK_BYTES_PER_S * 1e3
            entry["plain_ms"] = time_ms(plain) if plain else None
            entry["library_ms"] = time_ms(library) if library else None
        rows[name] = entry

    for mode, shape in ((REFLECT_1, SHAPE), ("periodic", ODD)):
        yard = full and mode == REFLECT_1
        x = leaf(randn(shape, f32, SEED + 500))
        y = _pallas2.pallas_dwt_axis(x, -2, dl, dh, mode)  # [2, B, m_h, w]
        yd = leaf(y)
        z = _pallas2.pallas_dwt_axis(yd, -1, dl, dh, mode)  # [2, 2, B, m_h, m_w]
        xd, ydd = x.detach(), yd.detach()
        crop_h = crop_of(mode, L, shape[-2], y.shape[-2])
        crop_w = crop_of(mode, L, shape[-1], z.shape[-1])
        bands = [leaf(t) for t in (z[0, 0], z[0, 1], z[1, 0], z[1, 1])]  # ll, lh, hl, hh
        c = _pallas2.pallas_idwt_axis(bands[:2], bands[2:], -1, rl, rh, *crop_w, mode)
        cd = [leaf(t) for t in c.unbind(0)]
        r = _pallas2.pallas_idwt_axis(cd[:1], cd[1:], -2, rl, rh, *crop_h, mode)
        bd = [t.detach() for t in bands]
        cdd = [t.detach() for t in cd]
        cy, cz, cc, cr = (randn(t.shape, f32, SEED + 501 + i) for i, t in enumerate((y, z, c, r)))
        lib = {}
        if yard:
            wa, wb = axis_filters(dl, dh, -2, f32), axis_filters(dl, dh, -1, f32)
            ra, rb = axis_filters(rl, rh, -2, f32), axis_filters(rl, rh, -1, f32)
            xpad = fwt_pad(xd, L, mode=mode, axes=(1,))[:, None]
            ypad = fwt_pad(ydd, L, mode=mode, axes=(3,)).reshape(-1, 1, 1, shape[-1] + 2 * std_pad(L))
            # the two pairs (ll, hl) and (lh, hh) as [2 B, 2 (lo, hi), m_h, m_w]
            k4w_in = torch.stack([torch.stack(bd[0::2], 1), torch.stack(bd[1::2], 1)]).reshape(-1, 2, *bd[0].shape[-2:])
            k4h_in = torch.stack(cdd, dim=1)  # [B, 2, h, w]
            cy_in = cy.transpose(0, 1).contiguous()  # [B, 2, m_h, w]
            cz_in = cz.permute(1, 2, 3, 0, 4).reshape(-1, 2, 1, z.shape[-1])
            cc_in = F.pad(cc, (crop_w[0], crop_w[1])).reshape(-1, 1, 1, shape[-1] + sum(crop_w))
            cr_in = F.pad(cr[0][:, None], (0, 0, crop_h[0], crop_h[1]))
            lib = {
                "K3 -2": lambda: F.conv2d(xpad, wa, stride=(2, 1)),
                "K3 -1": lambda: F.conv2d(ypad, wb, stride=(1, 2)),
                "K4 -1": lambda: F.conv_transpose2d(k4w_in, rb, stride=(1, 2)),
                "K4 -2": lambda: F.conv_transpose2d(k4h_in, ra, stride=(2, 1)),
                "K3 VJP -2": lambda: F.conv_transpose2d(cy_in, wa, stride=(2, 1)),
                "K3 VJP -1": lambda: F.conv_transpose2d(cz_in, wb, stride=(1, 2)),
                "K4 VJP -1": lambda: F.conv2d(cc_in, rb, stride=(1, 2)),
                "K4 VJP -2": lambda: F.conv2d(cr_in, ra, stride=(2, 1)),
            }
            mine = lib["K3 -2"]().transpose(0, 1)
            log(f"  K3 {mode} -2 library yardstick vs kernel max_abs={max_abs(mine.contiguous(), y.detach())!r}")
        plain = {
            "K3 -2": lambda: _pallas2.dwt_axis_plain(xd, -2, dl, dh, mode),
            "K3 -1": lambda: _pallas2.dwt_axis_plain(ydd, -1, dl, dh, mode),
            "K4 -1": lambda: [_pallas2.idwt_axis_plain(a, b, -1, rl, rh, *crop_w, mode) for a, b in ((bd[0], bd[2]), (bd[1], bd[3]))],
            "K4 -2": lambda: _pallas2.idwt_axis_plain(cdd[0], cdd[1], -2, rl, rh, *crop_h, mode),
            "K3 VJP -2": lambda: _pallas2.dwt_axis_vjp_plain(xd, -2, dl, dh, mode, cy),
            "K3 VJP -1": lambda: _pallas2.dwt_axis_vjp_plain(ydd, -1, dl, dh, mode, cz),
            "K4 VJP -1": lambda: [_pallas2.idwt_axis_vjp_plain(a, b, -1, rl, rh, *crop_w, mode, g)
                                  for (a, b), g in zip(((bd[0], bd[2]), (bd[1], bd[3])), cc)],
            "K4 VJP -2": lambda: _pallas2.idwt_axis_vjp_plain(cdd[0], cdd[1], -2, rl, rh, *crop_h, mode, cr[0]),
        }
        cases = {
            "K3 -2": (lambda: _pallas2.pallas_dwt_axis(xd, -2, dl, dh, mode), [xd], [y]),
            "K3 -1": (lambda: _pallas2.pallas_dwt_axis(ydd, -1, dl, dh, mode), [ydd], [z]),
            "K4 -1": (lambda: _pallas2.pallas_idwt_axis(bd[:2], bd[2:], -1, rl, rh, *crop_w, mode), bd, [c]),
            "K4 -2": (lambda: _pallas2.pallas_idwt_axis(cdd[:1], cdd[1:], -2, rl, rh, *crop_h, mode), cdd, [r]),
            "K3 VJP -2": (lambda: torch.autograd.grad(y, x, cy, retain_graph=True), [cy], [x]),
            "K3 VJP -1": (lambda: torch.autograd.grad(z, yd, cz, retain_graph=True), [cz], [yd]),
            "K4 VJP -1": (lambda: torch.autograd.grad(c, bands, cc, retain_graph=True), [cc], bands),
            "K4 VJP -2": (lambda: torch.autograd.grad(r, cd, cr, retain_graph=True), [cr], cd),
        }
        for name, (run, ins, outs) in cases.items():
            row(f"{name} {mode}", run, ins, outs, plain.get(name) if full else None, lib.get(name))
        if mode == REFLECT_1:
            # the padding gather (and its backward) K3 no longer needs
            for ax, src in ((-2, x), (-1, yd)):
                pad = fwt_pad(src, L, mode=mode, axes=(src.ndim + ax,))
                ct = randn(pad.shape, f32, SEED + 510)
                sd = src.detach()
                row(f"gather {mode} {ax}", lambda: fwt_pad(sd, L, mode=mode, axes=(sd.ndim + ax,)), [sd], [pad])
                row(f"gather VJP {mode} {ax}", lambda: torch.autograd.grad(pad, src, ct, retain_graph=True), [ct], [sd])
                del pad, ct
        del x, y, yd, z, bands, c, cd, r, cy, cz, cc, cr, lib
    return rows


def reflect_device_ms() -> dict:
    """Device busy ms (``torch.profiler``) of one ``reflect`` headline round
    trip and one phase 6 training step in ``reflect``, and the gather and
    scatter kernels among them (``index_select`` / ``index_add``)."""
    x = randn(SHAPE, torch.float32, SEED)
    y = randn(SHAPE, torch.float32, SEED + 41)
    model = GainModel(REFLECT_1)
    opt = optimizer(model)

    def step():
        opt.zero_grad(set_to_none=True)
        train_loss(model, y).backward()
        opt.step()

    out = {}
    for label, run in (
        ("round_trip", lambda: ptwt.waverec2(ptwt.wavedec2(x, WAVELET, mode=REFLECT_1, level=LEVEL), WAVELET, mode=REFLECT_1)),
        ("step", step),
    ):
        prof = profile(run, f"{REFLECT_1} {label}", top=8)
        out[f"{label}_busy_ms"] = sum(ms for ms, _, _ in prof)
        out[f"{label}_index_kernels"] = sum(n for _, n, key in prof if index_kernel(key))
    return out


def index_kernel(key: str) -> bool:
    """Is this device entry a gather or scatter kernel (``index_select``,
    ``index_add`` and their kin, by the names torch gives them)?"""
    return any(s in key.lower() for s in ("index", "gather", "scatter"))


def profile(run, label: str, top: int = 14) -> list:
    """Device time by kernel and the device's busy share over one call of
    ``run``, from ``torch.profiler``; returns ``(ms, count, name)`` rows."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    # a warm-up call is traced and its records dropped: a window's first
    # records went missing on an H100 (a compiled program's first K1/K3
    # launches, an eager round trip's first three)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = []
    for evt in prof.key_averages():
        # ProfilerStep*: the schedule's annotation of the step's span, not a kernel
        if not str(evt.device_type).endswith("CUDA") or evt.key.startswith("ProfilerStep"):
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = evt.self_cuda_time_total
        rows.append((dev / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(
        f"  profiled {label}: wall {wall!r} ms (profiler on), "
        f"device busy {busy!r} ms ({100 * busy / wall:.1f}%)"
    )
    for ms, count, key in rows[:top]:
        log(f"    {ms!r} ms x{count} {key[:100]}")
    return rows


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------


class GainModel(torch.nn.Module):
    """An image and per-level, per-orientation gains on its details:
    ``waverec2((cA, g[l] * details_l))`` of ``wavedec2(u)``."""

    def __init__(self, mode: str, shape=None, level=None, wavelet: str = WAVELET):
        super().__init__()
        self.mode, self.level, self.wavelet = mode, level or LEVEL, wavelet
        self.u = torch.nn.Parameter(randn(shape or SHAPE, torch.float32, SEED + 40))
        self.g = torch.nn.Parameter(torch.ones(self.level, 3, device=DEVICE))

    def forward(self):
        coeffs = ptwt.wavedec2(self.u, self.wavelet, mode=self.mode, level=self.level)
        details = coeffs[1:]
        scaled = [
            tuple(self.g[lev, o] * d for o, d in enumerate(t)) for lev, t in enumerate(details)
        ]
        return ptwt.waverec2((coeffs[0], *scaled), self.wavelet, mode=self.mode), details


class GainModel1d(torch.nn.Module):
    """The 1d counterpart: a batch of signals and per-level gains on their
    details, ``waverec((cA, g[l] * cD_l))`` of ``wavedec(u)``."""

    def __init__(self, mode: str, shape, level: int):
        super().__init__()
        self.mode, self.level, self.n = mode, level, shape[-1]
        self.u = torch.nn.Parameter(randn(shape, torch.float32, SEED + 42))
        self.g = torch.nn.Parameter(torch.ones(level, 1, device=DEVICE))

    def forward(self):
        coeffs = ptwt.wavedec(self.u, WAVELET_1D, mode=self.mode, level=self.level)
        details = coeffs[1:]
        scaled = [self.g[lev, 0] * d for lev, d in enumerate(details)]
        rec_mode = self.mode if self.mode == "periodization" else None
        rec = ptwt.waverec([coeffs[0], *scaled], WAVELET_1D, mode=rec_mode)
        return rec[..., : self.n], [(d,) for d in details]


def train_loss(model: GainModel, y: torch.Tensor) -> torch.Tensor:
    rec, details = model()
    energy = sum((d**2).sum() for t in details for d in t)
    count = sum(d.numel() for t in details for d in t)
    return ((rec - y) ** 2).mean() + 1e-3 * energy / count


def optimizer(model: GainModel) -> torch.optim.SGD:
    # the image's gradient is a mean over its pixels: scale its step back up
    return torch.optim.SGD(
        [{"params": [model.u], "lr": 0.25 * model.u.numel()}, {"params": [model.g], "lr": 0.5}]
    )


def train_steps(make, y: torch.Tensor) -> tuple[list, list]:
    model = make()
    opt = optimizer(model)
    losses, first = [], None
    for _ in range(TRAIN_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = train_loss(model, y)
        loss.backward()
        if first is None:
            first = [model.u.grad.clone(), model.g.grad.clone()]
        opt.step()
        losses.append(loss.item())
    return losses, first


def check_training(mode: str, y: torch.Tensor, make=None, with_profile: bool = True) -> dict:
    """3 steps on the kernel path against the plain path; launches of one
    backward and of one step; wall times and a profile of a step.
    ``make`` builds the model (phase 6's at the headline width by
    default); ``mode`` labels the run."""
    make = make or (lambda: GainModel(mode))
    losses, grads = train_steps(make, y)
    with plain_versions():
        ref_losses, ref_grads = train_steps(make, y)
    log(f"  {mode}: losses {losses} (plain {ref_losses})")
    for got, want in zip(losses, ref_losses):
        check(f"{mode} step loss vs plain (relative)", abs(got - want) / abs(want), TRAIN_LOSS_RTOL)
    for name, got, want in zip(("u", "g"), grads, ref_grads):
        scale = float(want.abs().max())
        check(f"{mode} first-step grad {name} vs plain (/ max|grad|)", max_abs(got, want) / scale, TRAIN_GRAD_TOL)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{mode}: the loss did not fall: {losses}")

    model = make()
    opt = optimizer(model)
    loss = train_loss(model, y)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    backward = dict(_kernels.LAUNCHES)
    log(f"  {mode}: launches of one backward { {k: v for k, v in backward.items() if v} }")

    def step():
        opt.zero_grad(set_to_none=True)
        train_loss(model, y).backward()
        opt.step()

    _kernels.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    per_step = dict(_kernels.LAUNCHES)
    log(f"  {mode}: launches of one training step { {k: v for k, v in per_step.items() if v} }")
    step_ms = wall_ms(step)
    forward_ms = wall_ms(lambda: train_loss(model, y))
    log(
        f"  {mode}: training step {step_ms!r} ms wall, forward {forward_ms!r} ms, "
        f"(step - forward) / forward {(step_ms - forward_ms) / forward_ms!r}"
    )
    rows = profile(step, f"{mode} training step") if with_profile else []
    return {"backward": backward, "step": per_step, "step_ms": step_ms, "forward_ms": forward_ms,
            "profile": rows}


# ---------------------------------------------------------------------------
# phases 7 and 8, and phase 5's 1d times: the 1d kernels and main path
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    """Max-abs error over ``max(1, the band's largest magnitude)``."""
    if isinstance(got, (tuple, list)):
        return max(rel_err(g, w) for g, w in zip(got, want))
    return max_abs(got, want) / max(1.0, float(want.abs().max()))


def check_1d(errors: dict, name: str, tag: str, got, want, dtype) -> None:
    err = check(f"{name} {tag} {dtype} (relative)", rel_err(got, want), TOL[dtype])
    slot = errors[name].setdefault(dtype, {"abs": 0.0, "rel": 0.0})
    slot["rel"] = max(slot["rel"], err)
    slot["abs"] = max(slot["abs"], max_abs(got, want))


def banks_1d(dtype):
    dl, dh, _, _ = get_filter_arrays(WAVELET_1D, flip=True, dtype=dtype)
    _, _, rl, rh = get_filter_arrays(WAVELET_1D, flip=False, dtype=dtype)
    return dl, dh, rl, rh


def chain_crops(x, his, filt_len: int):
    """waverec's crops for a fused run: each step as long as the finer band."""
    pads = [std_pad(filt_len)] * len(his)
    lens = [x.shape[-1]] + [h.shape[-1] for h in his[:-1]]
    return pads, lens


def check_kernels_1d(errors: dict) -> None:
    for dtype in (torch.float32, torch.float64):
        dl, dh, rl, rh = banks_1d(dtype)
        batch = D1_SHAPE[0] if dtype == torch.float32 else BATCH_F64_1D
        x = randn((batch, D1_SHAPE[1]), dtype, SEED + 50)
        for mode in PADDED_MODES:
            for depth, (ka, kb) in ((4, ("K8a", "K8b")), (1, ("K7a", "K7b"))):
                lo, his = _pallas1d_multi.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
                ref_lo, ref_his = _pallas1d_multi.multi_analysis_plain(x, dl, dh, mode, depth)
                check_1d(errors, ka, mode, [lo, *his], [ref_lo, *ref_his], dtype)
                coeffs = [ref_lo, *ref_his[::-1]]
                pads, lens = chain_crops(x, ref_his, len(dl))
                rec = _pallas1d_multi.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
                ref = _pallas1d_multi.multi_synthesis_plain(coeffs, rl, rh, pads, lens)
                check_1d(errors, kb, mode, rec, ref, dtype)
                check(f"{kb}({ka}) {mode} round trip {dtype}", max_abs(rec, x), 10 * TOL[dtype])
                del lo, his, ref_lo, ref_his, coeffs, rec, ref
        del x
        x = randn((batch, K6_SHAPE[1]), dtype, SEED + 51)
        got = _pallas.fused_wavedec1d_per(x, dl, dh, LEVEL_1D)
        want = _pallas.wavedec1d_per_plain(x, dl, dh, LEVEL_1D)
        check_1d(errors, "K6a", "periodization", got, want, dtype)
        rec = _pallas.fused_waverec1d_per(want, rl, rh)
        check_1d(errors, "K6b", "periodization", rec, _pallas.waverec1d_per_plain(want, rl, rh), dtype)
        check(f"K6b(K6a) round trip {dtype}", max_abs(rec, x), 10 * TOL[dtype])
        del x, got, want, rec
        torch.cuda.synchronize()


def check_vjps_1d(errors: dict) -> None:
    """Phase 7's VJP instances: K8a's and K7a's VJP (one synthesis pyramid
    launch with the fold, counted as K8b/K7b) and K8b's and K7b's (one
    analysis pyramid launch, counted as K8a/K7a) against autograd through
    the plain versions, every padded mode, with waverec's crops; in
    float64 also the adjoint identity."""
    for dtype in (torch.float32, torch.float64):
        dl, dh, rl, rh = banks_1d(dtype)
        batch = D1_SHAPE[0] if dtype == torch.float32 else BATCH_F64_1D
        x = leaf(randn((batch, D1_SHAPE[1]), dtype, SEED + 52))
        for mode in PADDED_MODES:
            for depth, (ka, kb) in ((4, ("K8a", "K8b")), (1, ("K7a", "K7b"))):
                lo, his = _pallas1d_multi.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
                outs = [lo, *his]
                cts = [randn(t.shape, dtype, SEED + 53 + j) for j, t in enumerate(outs)]
                _kernels.reset_launch_counts()
                (got,) = torch.autograd.grad(outs, x, cts)
                torch.cuda.synchronize()
                only(_kernels.LAUNCHES, {kb: 1}, f"{ka} VJP {mode}")
                z = leaf(x)
                ref_lo, ref_his = _pallas1d_multi.multi_analysis_plain(z, dl, dh, mode, depth)
                (want,) = torch.autograd.grad((ref_lo, *ref_his), z, cts)
                check_1d(errors, f"{ka} VJP", mode, got, want, dtype)
                if dtype == torch.float64:
                    adjoint(f"{ka} VJP {mode}", [t.detach() for t in outs], cts, [x.detach()], [got])
                del lo, his, outs, want
                coeffs = [leaf(t) for t in (ref_lo, *ref_his[::-1])]
                pads, lens = chain_crops(x, ref_his, len(dl))
                rec = _pallas1d_multi.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
                ct = randn(rec.shape, dtype, SEED + 58)
                _kernels.reset_launch_counts()
                got = torch.autograd.grad(rec, coeffs, ct)
                torch.cuda.synchronize()
                only(_kernels.LAUNCHES, {ka: 1}, f"{kb} VJP {mode}")
                plain = [leaf(t) for t in coeffs]
                want = torch.autograd.grad(
                    _pallas1d_multi.multi_synthesis_plain(plain, rl, rh, pads, lens), plain, ct
                )
                check_1d(errors, f"{kb} VJP", mode, list(got), list(want), dtype)
                if dtype == torch.float64:
                    adjoint(f"{kb} VJP {mode}", [rec.detach()], [ct], [c.detach() for c in coeffs], got)
                del ref_lo, ref_his, coeffs, rec, ct, got, want, plain, z
        del x
        torch.cuda.synchronize()


#: phase 8's configurations: (name, shape, mode, level, kernels it must launch)
MAIN_1D = (
    ("d1 periodic", D1_SHAPE, "periodic", LEVEL_1D, ("K8a", "K8b", "K3", "K4")),
    ("d1 reflect", D1_SHAPE, "reflect", LEVEL_1D, ("K8a", "K8b", "K3", "K4")),
    ("K6 periodization", K6_SHAPE, "periodization", LEVEL_1D, ("K6a", "K6b")),
    ("K7 reflect level 1", D1_SHAPE, "reflect", 1, ("K7a", "K7b")),
)


def round_trip_1d(x, mode: str, level: int):
    coeffs = ptwt.wavedec(x, WAVELET_1D, mode=mode, level=level)
    return coeffs, ptwt.waverec(coeffs, WAVELET_1D, mode=mode)


def main_path_1d(name: str, shape, mode: str, level: int, must: tuple, seed: int) -> dict:
    x = randn(shape, torch.float32, seed)
    _kernels.reset_launch_counts()
    coeffs, rec = round_trip_1d(x, mode, level)
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    log(f"  {name}: launches per round trip { {k: v for k, v in counts.items() if v} }")
    with plain_versions():
        ref, ref_rec = round_trip_1d(x, mode, level)
    log(f"  {name}: band lengths {[c.shape[-1] for c in coeffs]}")
    tol = TOL[torch.float32]
    coeff_err = check(f"{name} coefficients vs plain path (relative)", rel_err(coeffs, ref), tol)
    check(f"{name} reconstruction vs plain path (relative)", rel_err(rec, ref_rec), tol)
    rt_err = check(f"{name} round trip vs input", max_abs(rec[..., : shape[-1]], x), ROUND_TRIP_TOL)
    for kernel in must:
        if counts[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched by the {name} round trip")
    if mode == "periodization" and (counts["K3"] or counts["K4"]):
        raise AssertionError(f"the {name} round trip launched K3/K4: {counts}")
    return {"counts": counts, "coeff_err": coeff_err, "round_trip_err": rt_err}


def pyramid_cost(lengths_in, lengths_out, rows: int, taps: int, size: int, bands_out: int):
    """Bytes (each input read once, each output written once) and
    operations (one multiply-add = 2) of one launch."""
    nbytes = size * rows * (sum(lengths_in) + sum(lengths_out))
    return nbytes, 2.0 * rows * taps * bands_out


def time_kernels_1d() -> dict:
    """Phase 5's 1d times at phase 8's shapes, float32."""
    f32 = torch.float32
    dl, dh, rl, rh = banks_1d(f32)
    L = len(dl)
    p = std_pad(L)
    size = 4
    rows = {}
    b, n = D1_SHAPE
    x = randn(D1_SHAPE, f32, SEED + 60)

    # K8a: the d1 periodic run's first 4 levels
    lo, his = _pallas1d_multi.flat_wavedec_lane_multi(x, dl, dh, "periodic", 4)
    ms = [h.shape[-1] for h in his]
    # each level: lo and hi, L multiply-adds per output
    flops = 2.0 * b * sum(2 * L * m for m in ms)
    rows["K8a"] = {
        "ms": time_ms(lambda: _pallas1d_multi.flat_wavedec_lane_multi(x, dl, dh, "periodic", 4)),
        "plain_ms": time_ms(lambda: _pallas1d_multi.multi_analysis_plain(x, dl, dh, "periodic", 4)),
        "library_ms": None,
        "library_note": "none: multi-level (no one library call fuses 4 levels)",
        "bytes": size * b * (n + sum(ms) + ms[-1]),
        "flops": flops,
    }

    # K8b: the d1 run's fused suffix (the last 4 steps)
    coeffs = [lo, *his[::-1]]
    pads, lens = chain_crops(x, his, L)
    # each output: L/2 taps from each of two bands
    flops = 2.0 * b * L * sum(lens)
    rows["K8b"] = {
        "ms": time_ms(lambda: _pallas1d_multi.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)),
        "plain_ms": time_ms(lambda: _pallas1d_multi.multi_synthesis_plain(coeffs, rl, rh, pads, lens)),
        "library_ms": None,
        "library_note": "none: multi-level (no one library call fuses 4 steps)",
        "bytes": size * b * (ms[-1] + sum(ms) + n),
        "flops": flops,
    }
    del lo, his, coeffs

    # K7a: the single long level of the K7 configuration (reflect)
    lo, hi = _pallas1d.flat_dwt_lane(x, dl, dh, "reflect")
    m = lo.shape[-1]
    xpad = fwt_pad(x, L, mode="reflect")[:, None]
    wdec = torch.stack([torch.as_tensor(np.asarray(f), dtype=f32, device=DEVICE) for f in (dl, dh)])[:, None]
    lib = F.conv1d(xpad, wdec, stride=2)
    log(f"  K7a library yardstick vs kernel max_abs={max_abs(lib, torch.stack([lo, hi], dim=1))!r}")
    rows["K7a"] = {
        "ms": time_ms(lambda: _pallas1d.flat_dwt_lane(x, dl, dh, "reflect")),
        "plain_ms": time_ms(lambda: _pallas2.dwt_axis_plain(x, -1, dl, dh, "reflect")),
        "library_ms": time_ms(lambda: F.conv1d(xpad, wdec, stride=2)),
        "library_note": "F.conv1d(stride=2) on the input padded beforehand",
        "bytes": size * b * (n + 2 * m),
        "flops": 2.0 * b * 2 * L * m,
    }
    del xpad, lib

    # K7b: its inverse, cropped by (p, p) to n samples
    stacked = torch.stack([lo, hi], dim=1)
    wrec = torch.stack([torch.as_tensor(np.asarray(f), dtype=f32, device=DEVICE) for f in (rl, rh)])[:, None]
    rec = _pallas1d.flat_idwt_lane(lo, hi, rl, rh, p, p)
    lib = F.conv_transpose1d(stacked, wrec, stride=2)[:, 0, p : p + rec.shape[-1]]
    log(f"  K7b library yardstick vs kernel max_abs={max_abs(lib, rec)!r}")
    rows["K7b"] = {
        "ms": time_ms(lambda: _pallas1d.flat_idwt_lane(lo, hi, rl, rh, p, p)),
        "plain_ms": time_ms(lambda: _pallas2.idwt_axis_plain(lo, hi, -1, rl, rh, p, p, "reflect")),
        "library_ms": time_ms(lambda: F.conv_transpose1d(stacked, wrec, stride=2)),
        "library_note": "F.conv_transpose1d(stride=2), before the crop",
        "bytes": size * b * (2 * m + rec.shape[-1]),
        "flops": 2.0 * b * L * rec.shape[-1],
    }
    del x, lo, hi, stacked, lib, rec

    # K6a / K6b: the whole periodization pyramid of the K6 configuration,
    # beside the per-level K3/K4 route the port would take otherwise
    b, n = K6_SHAPE
    x = randn(K6_SHAPE, f32, SEED + 61)
    coeffs = _pallas.fused_wavedec1d_per(x, dl, dh, LEVEL_1D)
    ms = [n >> lvl for lvl in range(1, LEVEL_1D + 1)]

    def per_level_k3():
        cur = x
        for _ in range(LEVEL_1D):
            cur = _pallas2.pallas_dwt_axis(cur, -1, dl, dh, "periodization")[0]
        return cur

    def per_level_k4():
        cur = coeffs[0]
        for hi in coeffs[1:]:
            cur = _pallas2.pallas_idwt_axis((cur,), (hi,), -1, rl, rh, 0, 0, "periodization")[0]
        return cur

    check("K6b vs the per-level K4 route", max_abs(_pallas.fused_waverec1d_per(coeffs, rl, rh), per_level_k4()), 1e-4)
    rows["K6a"] = {
        "ms": time_ms(lambda: _pallas.fused_wavedec1d_per(x, dl, dh, LEVEL_1D)),
        "plain_ms": time_ms(lambda: _pallas.wavedec1d_per_plain(x, dl, dh, LEVEL_1D)),
        "per_level_ms": time_ms(per_level_k3),
        "library_ms": None,
        "library_note": "none: multi-level (no one library call runs the pyramid)",
        "bytes": size * b * 2 * n,
        "flops": 2.0 * b * sum(2 * L * m for m in ms),
    }
    rows["K6b"] = {
        "ms": time_ms(lambda: _pallas.fused_waverec1d_per(coeffs, rl, rh)),
        "plain_ms": time_ms(lambda: _pallas.waverec1d_per_plain(coeffs, rl, rh)),
        "per_level_ms": time_ms(per_level_k4),
        "library_ms": None,
        "library_note": "none: multi-level (no one library call runs the pyramid)",
        "bytes": size * b * 2 * n,
        "flops": 2.0 * b * L * sum(2 * m for m in ms),
    }
    del x, coeffs
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
        extra = f" per_level_ms={row['per_level_ms']!r}" if "per_level_ms" in row else ""
        log(
            f"  {name}: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
            f"library_ms={row['library_ms']!r} bound_ms={row['bound_ms']!r} ({row['bound_by']}){extra}"
        )
    return rows


def fwt1d_times(tile_samples=None) -> dict:
    """Device ms of every ``fwt1d.cu`` instance and of the K6-K8 VJPs as
    the autograd backward runs them, at phase 8's shapes, float32: the
    rows phase 5 compares with the parent tree in turns (only public
    entry points, so either tree's package runs it).  ``tile_samples``
    sets the 1d tile plans' ``_TILE_SAMPLES``."""
    if tile_samples:
        _pallas1d_multi._TILE_SAMPLES = tile_samples
    f32 = torch.float32
    dl, dh, rl, rh = banks_1d(f32)
    out = {}
    x = leaf(randn(D1_SHAPE, f32, SEED + 60))
    for mode, depth, (ka, kb), tag in (
        ("periodic", 4, ("K8a", "K8b"), ""),
        ("reflect", 4, ("K8a", "K8b"), " reflect"),
        ("reflect", 1, ("K7a", "K7b"), ""),
    ):
        lo, his = _pallas1d_multi.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
        outs = [lo, *his]
        cts = [randn(t.shape, f32, SEED + 61 + j) for j, t in enumerate(outs)]
        coeffs = [leaf(t) for t in (lo, *his[::-1])]
        pads, lens = chain_crops(x, his, len(dl))
        rec = _pallas1d_multi.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
        ct = randn(rec.shape, f32, SEED + 66)
        xd, cd = x.detach(), [c.detach() for c in coeffs]
        out[ka + tag] = time_ms(lambda: _pallas1d_multi.flat_wavedec_lane_multi(xd, dl, dh, mode, depth))
        out[kb + tag] = time_ms(lambda: _pallas1d_multi.flat_waverec_lane_multi(cd, rl, rh, pads, lens))
        out[f"{ka} VJP{tag}"] = time_ms(lambda: torch.autograd.grad(outs, x, cts, retain_graph=True))
        out[f"{kb} VJP{tag}"] = time_ms(lambda: torch.autograd.grad(rec, coeffs, ct, retain_graph=True))
        del lo, his, outs, cts, coeffs, rec, ct, cd
    del x
    x = leaf(randn(K6_SHAPE, f32, SEED + 67))
    bands = _pallas.fused_wavedec1d_per(x, dl, dh, LEVEL_1D)
    cts = [randn(t.shape, f32, SEED + 68 + j) for j, t in enumerate(bands)]
    leaves = [leaf(t) for t in bands]
    rec = _pallas.fused_waverec1d_per(leaves, rl, rh)
    ct = randn(rec.shape, f32, SEED + 80)
    xd, bd = x.detach(), [b.detach() for b in bands]
    out["K6a"] = time_ms(lambda: _pallas.fused_wavedec1d_per(xd, dl, dh, LEVEL_1D))
    out["K6b"] = time_ms(lambda: _pallas.fused_waverec1d_per(bd, rl, rh))
    out["K6a VJP"] = time_ms(lambda: torch.autograd.grad(bands, x, cts, retain_graph=True))
    out["K6b VJP"] = time_ms(lambda: torch.autograd.grad(rec, leaves, ct, retain_graph=True))
    return out


def times_process(*args: str, timeout: int = 600) -> dict:
    """Run ``chip_smoke.py ARGS`` in a process of its own (late in a long
    process ``torch.profiler``'s windows lose launches), log its lines and
    return its last line's JSON; raise if it fails."""
    flag = " ".join(args)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), *args],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{flag} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    *lines, last = proc.stdout.strip().splitlines()
    log("\n".join(lines))
    return json.loads(last)


def turns(parent: Path, flag: str) -> dict:
    """``chip_smoke.py flag`` on the parent tree and on this one in turns
    (parent, this, this, parent), each a process of its own started with
    ``--src``; returns ``{row: {"parent": [..], "change": [..]}}`` of the
    JSON line each printed last."""
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), flag, "--src", str(tree / "src")]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{flag} of {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
    rows = {}
    for tree, times in runs:
        for name, value in times.items():
            rows.setdefault(name, {"parent": [], "change": []})
            rows[name]["parent" if tree == parent else "change"].append(value)
    for name, row in rows.items():
        ratio = min(row["change"]) / min(row["parent"]) if min(row["parent"]) else None
        log(f"  {name}: parent {row['parent']!r}, change {row['change']!r} (change / parent {ratio!r})")
    return rows


def fwt1d_turns(parent: Path) -> dict:
    """:func:`fwt1d_times` of the parent tree and of this one in turns, then
    this tree's rows at other tile sizes (``"tiles"``)."""
    rows = turns(parent, "--fwt1d-times")
    default_tile = _pallas1d_multi._TILE_SAMPLES
    for tile in (2048, 8192):
        for name, ms in fwt1d_times(tile).items():
            rows[name].setdefault("tiles", {})[tile] = ms
    _pallas1d_multi._TILE_SAMPLES = default_tile
    for name, row in rows.items():
        log(f"  {name}: tiles {row.get('tiles')!r}")
    return rows


def round_trips_1d() -> None:
    """The 1d round trips' wall times and one profile (phase 5, 1d)."""
    x = randn(D1_SHAPE, torch.float32, SEED + 62)
    msamples = D1_SHAPE[0] * D1_SHAPE[1] / 1e6
    for mode in ("periodic", "reflect"):
        ms = wall_ms(lambda: round_trip_1d(x, mode, LEVEL_1D))
        log(f"  d1 round trip {mode}: {ms!r} ms, {msamples / (ms * 1e-3)!r} Msamples/s")
    rows = profile(lambda: round_trip_1d(x, "periodic", LEVEL_1D), "d1 periodic round trip", top=20)
    # the plain versions run as elementwise products and sums, gathers and
    # concatenations; none of them may reach the card on the main path
    plain = [key for _, _, key in rows if any(s in key for s in ("elementwise", "index", "CatArray", "reduce"))]
    if plain:
        raise AssertionError(f"plain-version ops in the d1 round trip's profile: {plain}")
    log(f"  d1 periodic round trip: no plain-version ops among {len(rows)} device entries")


# ---------------------------------------------------------------------------
# phases 9 and 10, and phase 5's K5 times: the 2d periodization pyramid
# ---------------------------------------------------------------------------


def nest(flat: list, level: int) -> list:
    """``[cA, lh, hl, hh, ...]`` -> ``[cA, (lh, hl, hh), ...]``."""
    return [flat[0]] + [tuple(flat[1 + 3 * i : 4 + 3 * i]) for i in range(level)]


def k5_runs(shape, level: int, filt_len: int, dtype):
    """The K5 plan's runs for ``[b, h, w]``, or None where it declines."""
    if not _pallas.fused_wavedec2d_applicable(shape[-2], shape[-1], filt_len, level, dtype):
        return None
    return _pallas._plan_runs(shape[-2], shape[-1], filt_len, level, dtype)


def check_k5_case(errors: dict, shape, level: int, wavelet: str, dtype, seed: int) -> None:
    """K5a/K5b and their VJPs against their plain versions on one shape."""
    tag = f"{wavelet} {list(shape)} level {level}"
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=dtype)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=dtype)
    runs = k5_runs(shape, level, len(dl), dtype)
    if runs is None:
        log(f"  K5 {tag} {dtype}: the plan declines it; the per-level route (K1/K2, K3/K4) runs it")
        return
    x = leaf(randn(shape, dtype, seed))
    _kernels.reset_launch_counts()
    got = flat_coeffs(_pallas.fused_wavedec2d_per(x, dl, dh, level))
    want = flat_coeffs(_pallas.wavedec2d_per_plain(x.detach(), dl, dh, level))
    check_1d(errors, "K5a", tag, [g.detach() for g in got], want, dtype)
    rec = _pallas.fused_waverec2d_per(nest(want, level), rl, rh)
    check_1d(errors, "K5b", tag, rec, _pallas.waverec2d_per_plain(nest(want, level), rl, rh), dtype)
    check(f"K5b(K5a) {tag} round trip {dtype}", max_abs(rec, x.detach()), 10 * TOL[dtype])
    torch.cuda.synchronize()
    if (_kernels.LAUNCHES["K5a"], _kernels.LAUNCHES["K5b"]) != (len(runs), len(runs)):
        raise AssertionError(f"K5 {tag}: launches {dict(_kernels.LAUNCHES)}, runs {runs}")
    log(f"  K5 {tag} {dtype}: runs {runs}")
    # K5a's VJP (K5b with the dec taps) against autograd through the plain version
    cts = [randn(t.shape, dtype, seed + 10 + i) for i, t in enumerate(got)]
    (grad,) = torch.autograd.grad(got, x, cts)
    z = leaf(x)
    (ref,) = torch.autograd.grad(flat_coeffs(_pallas.wavedec2d_per_plain(z, dl, dh, level)), z, cts)
    check_1d(errors, "K5a VJP", tag, grad, ref, dtype)
    if dtype == torch.float64:
        adjoint(f"K5a {tag}", [g.detach() for g in got], cts, [x.detach()], [grad])
    # K5b's VJP (K5a with the rec taps)
    leaves = [leaf(t) for t in want]
    rec = _pallas.fused_waverec2d_per(nest(leaves, level), rl, rh)
    ct = randn(rec.shape, dtype, seed + 30)
    grads = torch.autograd.grad(rec, leaves, ct)
    plain = [leaf(t) for t in want]
    refs = torch.autograd.grad(_pallas.waverec2d_per_plain(nest(plain, level), rl, rh), plain, ct)
    check_1d(errors, "K5b VJP", tag, list(grads), list(refs), dtype)
    if dtype == torch.float64:
        adjoint(f"K5b {tag}", [rec.detach()], [ct], leaves, grads)
    torch.cuda.synchronize()


def check_k5(errors: dict) -> None:
    for i, (_, shape, level) in enumerate(PER_2D):
        for dtype in (torch.float32, torch.float64):
            sized = shape if dtype == torch.float32 else (BATCH_F64_2D, *shape[1:])
            for wavelet in (WAVELET, LONG_WAVELET):
                check_k5_case(errors, sized, level, wavelet, dtype, SEED + 80 + 10 * i)
    for i, (shape, level, wavelet) in enumerate(K5_EXTRA):
        for dtype in (torch.float32, torch.float64):
            check_k5_case(errors, shape, level, wavelet, dtype, SEED + 300 + 10 * i)


def main_path_per(name: str, shape, level: int, seed: int) -> dict:
    """Phase 10: the 2d periodization round trip at one configuration."""
    x = randn(shape, torch.float32, seed)
    _kernels.reset_launch_counts()
    coeffs = ptwt.wavedec2(x, WAVELET, mode="periodization", level=level)
    rec = ptwt.waverec2(coeffs, WAVELET, mode="periodization")
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    log(f"  {name} periodization: launches per round trip { {k: v for k, v in counts.items() if v} }")
    with plain_versions():
        ref = ptwt.wavedec2(x, WAVELET, mode="periodization", level=level)
        ref_rec = ptwt.waverec2(ref, WAVELET, mode="periodization")
    coeff_err = check(f"{name} periodization coefficients vs plain path", max_abs(flat_coeffs(coeffs), flat_coeffs(ref)), 2e-5)
    check(f"{name} periodization reconstruction vs plain path", max_abs(rec, ref_rec), 2e-5)
    rt_err = check(f"{name} periodization round trip vs input", max_abs(rec, x), ROUND_TRIP_TOL)
    runs = k5_runs(shape, level, 8, torch.float32)
    if runs is None:
        log(f"  {name}: the K5 plan declines this chain; K1/K2 carry it")
        if counts["K1"] < 1:
            raise AssertionError(f"{name}: neither K5 nor K1 ran: {counts}")
    else:
        if counts["K5a"] < 1 or counts["K5b"] < 1:
            raise AssertionError(f"K5a/K5b were not launched by the {name} periodization round trip")
        if counts["K1"] or counts["K2"]:
            raise AssertionError(f"the {name} periodization round trip launched K1/K2: {counts}")
    return {"counts": counts, "coeff_err": coeff_err, "round_trip_err": rt_err, "runs": runs}


def pyramid2d_cost(b: int, h: int, w: int, level: int, L: int, size: int):
    """Bytes (the image read once, every band written once) and operations
    of a ``level``-level 2d periodization pyramid; the synthesis moves the
    same bytes."""
    bands = (h >> level) * (w >> level) + 3 * sum((h >> lv) * (w >> lv) for lv in range(1, level + 1))
    flops = sum(
        analysis_flops(b, h >> (lv - 1), w >> (lv - 1), h >> lv, w >> lv, L) for lv in range(1, level + 1)
    )
    syn_flops = sum(
        synthesis_flops(b, h >> lv, w >> lv, h >> (lv - 1), w >> (lv - 1), L) for lv in range(1, level + 1)
    )
    return size * b * (h * w + bands), flops, syn_flops


def vjp_timing(outs, ins, cts, plain_outs, plain_ins, label: str, tol: float) -> dict:
    """The backward of ``outs`` (device time of its VJP launches) beside
    autograd through the plain version, and their agreement."""
    got = torch.autograd.grad(outs, ins, cts, retain_graph=True)
    ref = torch.autograd.grad(plain_outs, plain_ins, cts, retain_graph=True)
    err = check(f"{label} VJP vs autograd through the plain version (relative)", rel_err(list(got), list(ref)), tol)
    return {
        "vjp_ms": time_ms(lambda: torch.autograd.grad(outs, ins, cts, retain_graph=True)),
        "vjp_plain_ms": time_ms(lambda: torch.autograd.grad(plain_outs, plain_ins, cts, retain_graph=True)),
        "vjp_max_abs_err": max_abs(list(got), list(ref)),
        "vjp_rel_err": err,
    }


def time_k5() -> dict:
    """Phase 5's K5 rows at both 2d periodization configurations (float32):
    the kernels, the per-level K1/K2 route they replace, their VJPs."""
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    rows = {"K5a": {}, "K5b": {}}
    for i, (name, shape, level) in enumerate(PER_2D):
        b, h, w = shape
        x = leaf(randn(shape, f32, SEED + 90 + i))
        coeffs = _pallas.fused_wavedec2d_per(x.detach(), dl, dh, level)

        def per_level_k1():
            cur = x.detach()
            for _ in range(level):
                cur = _pallas2d.fused2_dwt_level(cur, dl, dh, "periodization")[0]
            return cur

        def per_level_k2():
            cur = coeffs[0]
            for trip in coeffs[1:]:
                cur = _pallas2d.fused2_idwt_level((cur, *trip), rl, rh, "periodization")
            return cur

        check(f"K5b vs the per-level K2 route ({name})", max_abs(_pallas.fused_waverec2d_per(coeffs, rl, rh), per_level_k2()), 1e-4)
        nbytes, flops, syn_flops = pyramid2d_cost(b, h, w, level, L, 4)
        ana = {
            "ms": time_ms(lambda: _pallas.fused_wavedec2d_per(x.detach(), dl, dh, level)),
            "plain_ms": time_ms(lambda: _pallas.wavedec2d_per_plain(x.detach(), dl, dh, level)),
            "per_level_ms": time_ms(per_level_k1),
            "bytes": nbytes,
            "flops": flops,
        }
        syn = {
            "ms": time_ms(lambda: _pallas.fused_waverec2d_per(coeffs, rl, rh)),
            "plain_ms": time_ms(lambda: _pallas.waverec2d_per_plain(coeffs, rl, rh)),
            "per_level_ms": time_ms(per_level_k2),
            "bytes": nbytes,
            "flops": syn_flops,
        }
        # the VJPs as the autograd backward runs them
        outs = flat_coeffs(_pallas.fused_wavedec2d_per(x, dl, dh, level))
        cts = [randn(t.shape, f32, SEED + 100 + j) for j, t in enumerate(outs)]
        z = leaf(x)
        ana.update(vjp_timing(outs, [x], cts, flat_coeffs(_pallas.wavedec2d_per_plain(z, dl, dh, level)), [z], f"K5a {name}", TOL[f32]))
        leaves = [leaf(t) for t in flat_coeffs(coeffs)]
        plain = [leaf(t) for t in leaves]
        ct = [randn(x.shape, f32, SEED + 120)]
        rec = _pallas.fused_waverec2d_per(nest(leaves, level), rl, rh)
        syn.update(vjp_timing([rec], leaves, ct, [_pallas.waverec2d_per_plain(nest(plain, level), rl, rh)], plain, f"K5b {name}", TOL[f32]))
        plan = k5_plan_cost(shape, level, L, 4)
        ana["reread_bytes"], syn["reread_bytes"] = plan["K5a_reread_bytes"], plan["K5b_reread_bytes"]
        for row in (ana, syn):
            # the bound of the plan run (each run's input read once, its
            # bands written once); that of one whole pyramid and the cone
            # re-reads go to the log only
            row["pyramid_bound_ms"] = bound(row["bytes"], row["flops"])[0]
            row["bytes"] = plan["bytes"]
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
            row["library_ms"] = None
            row["library_note"] = "none: multi-level (no one library call runs the pyramid)"
            row["runs"] = list(k5_runs(shape, level, L, f32))
        rows["K5a"][name], rows["K5b"][name] = ana, syn
        for kernel in KERNELS_K5:
            row = rows[kernel][name]
            log(
                f"  {kernel} {name}: ms={row['ms']!r} per_level_ms={row['per_level_ms']!r} "
                f"plain_ms={row['plain_ms']!r} bound_ms={row['bound_ms']!r} ({row['bound_by']}) "
                f"vjp_ms={row['vjp_ms']!r} vjp_plain_ms={row['vjp_plain_ms']!r} runs={row['runs']} "
                f"reread_bytes={row['reread_bytes']!r} pyramid_bound_ms={row['pyramid_bound_ms']!r}"
            )
        del x, coeffs, outs, cts, leaves, plain, rec
    return rows


def k5_plan_cost(shape, level: int, filt_len: int, size: int) -> dict:
    """Bytes of the K5 plan this tree runs on ``shape`` (each run reads its
    input once and writes its bands once) and the cone re-reads on top
    (staged elements past each launch's input), for K5a and K5b."""
    b, h, w = shape
    out = {"bytes": 0, "K5a_reread_bytes": 0, "K5b_reread_bytes": 0}
    for depth in _pallas._pyramid2d_runs(h, w, filt_len, level, size):
        bands = (h >> depth) * (w >> depth) + 3 * sum((h >> lv) * (w >> lv) for lv in range(1, depth + 1))
        out["bytes"] += size * b * (h * w + bands)
        whole, th, tw = _pallas._run_mode(h, w, filt_len, depth, size)
        if not whole:
            le = filt_len + (filt_len & 1)
            cone = _pallas._cone_at(th, h, le, False, depth, 0) * _pallas._cone_at(tw, w, le, False, depth, 0)
            tiles = -(-(h >> depth) // th) * -(-(w >> depth) // tw)
            out["K5a_reread_bytes"] += size * b * (tiles * cone - h * w)
            sth, stw = _pallas._synthesis_tile(h, w, filt_len, size)
            pad = filt_len // 2 - 1

            def spans(t, n, lv):
                total = 0
                for first in range(0, n, t):
                    c, e = first, first + t - 1
                    for _ in range(lv):
                        c, e = (c + pad - (filt_len - 1)) // 2, (e + pad) // 2
                    total += e - c + 1
                return total

            staged = sum((4 if lv == depth else 3) * spans(sth, h, lv) * spans(stw, w, lv) for lv in range(1, depth + 1))
            out["K5b_reread_bytes"] += size * b * (staged - bands)
        h, w = h >> depth, w >> depth
    return out


def k5_times() -> dict:
    """Device ms of K5a, K5b and both VJP instances (as the autograd
    backward runs them), the per-level K1/K2 route on the same pyramid, and
    the launches (counted by the wrappers), device busy ms (profiler) and
    wall ms of one periodization round trip and one training step, at both
    2d periodization configurations and at :data:`K5_SMALL_BATCHES`,
    float32: the rows phase 5 compares with the parent tree in turns
    (entry points both trees have)."""
    f32 = torch.float32
    out = {}
    configs = [(name, shape, level, WAVELET) for name, shape, level in PER_2D] + list(K5_SMALL_BATCHES)
    for i, (name, shape, level, wavelet) in enumerate(configs):
        dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=f32)
        _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=f32)
        x = leaf(randn(shape, f32, SEED + 90 + i))
        xd = x.detach()
        coeffs = _pallas.fused_wavedec2d_per(xd, dl, dh, level)
        out[f"K5a {name}"] = time_ms(lambda: _pallas.fused_wavedec2d_per(xd, dl, dh, level))
        out[f"K5b {name}"] = time_ms(lambda: _pallas.fused_waverec2d_per(coeffs, rl, rh))
        outs = flat_coeffs(_pallas.fused_wavedec2d_per(x, dl, dh, level))
        cts = [randn(t.shape, f32, SEED + 100 + j) for j, t in enumerate(outs)]
        out[f"K5a VJP {name}"] = time_ms(lambda: torch.autograd.grad(outs, x, cts, retain_graph=True))
        leaves = [leaf(t) for t in flat_coeffs(coeffs)]
        rec = _pallas.fused_waverec2d_per(nest(leaves, level), rl, rh)
        ct = randn(x.shape, f32, SEED + 120)
        out[f"K5b VJP {name}"] = time_ms(lambda: torch.autograd.grad(rec, leaves, ct, retain_graph=True))

        def per_level_k1():
            cur = xd
            for _ in range(level):
                cur = _pallas2d.fused2_dwt_level(cur, dl, dh, "periodization")[0]
            return cur

        def per_level_k2():
            cur = coeffs[0]
            for trip in coeffs[1:]:
                cur = _pallas2d.fused2_idwt_level((cur, *trip), rl, rh, "periodization")
            return cur

        out[f"K1 x{level} {name}"] = time_ms(per_level_k1)
        out[f"K2 x{level} {name}"] = time_ms(per_level_k2)
        del outs, cts, leaves, rec, ct
        model = GainModel("periodization", shape, level, wavelet)
        opt = optimizer(model)
        y = randn(shape, f32, SEED + 43 + i)

        def round_trip():
            return ptwt.waverec2(ptwt.wavedec2(xd, wavelet, mode="periodization", level=level), wavelet, mode="periodization")

        def step():
            opt.zero_grad(set_to_none=True)
            train_loss(model, y).backward()
            opt.step()

        for label, run in (("round trip", round_trip), ("step", step)):
            run()
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            run()
            torch.cuda.synchronize()
            out[f"launches per {label} {name}"] = sum(_kernels.LAUNCHES.values())
            out[f"{label} wall ms {name}"] = wall_ms(run)
            prof = profile(run, f"periodization {name} {label}", top=6)
            out[f"{label} busy ms {name}"] = sum(ms for ms, _, _ in prof)
            out[f"{label} K5 ms {name}"] = sum(ms for ms, _, key in prof if "pyramid2d" in key)
        del x, xd, coeffs, model, opt, y
    return out


def round_trips_per() -> None:
    """The 2d periodization round trips in Mpix/s (phase 5)."""
    for i, (name, shape, level) in enumerate(PER_2D):
        x = randn(shape, torch.float32, SEED + 130 + i)
        mpix = shape[0] * shape[1] * shape[2] / 1e6
        ms = wall_ms(
            lambda: ptwt.waverec2(ptwt.wavedec2(x, WAVELET, mode="periodization", level=level), WAVELET, mode="periodization")
        )
        log(f"  round trip periodization {name}: {ms!r} ms, {mpix / (ms * 1e-3)!r} Mpix/s")


def time_vjps_1d() -> dict:
    """Phase 5's VJP rows of the 1d pyramid kernels, as the autograd
    backward runs them, at phase 8's shapes (float32)."""
    f32 = torch.float32
    dl, dh, rl, rh = banks_1d(f32)
    L = len(dl)
    tol = TOL[f32]
    rows = {}
    x = leaf(randn(D1_SHAPE, f32, SEED + 140))

    def run_rows(kernel_a, kernel_b, mode, depth, label):
        """The VJP rows of one analysis run and its synthesis run."""
        lo, his = _pallas1d_multi.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
        cts = [randn(t.shape, f32, SEED + 150 + j) for j, t in enumerate((lo, *his))]
        z = leaf(x)
        ref_lo, ref_his = _pallas1d_multi.multi_analysis_plain(z, dl, dh, mode, depth)
        row_a = vjp_timing([lo, *his], [x], cts, [ref_lo, *ref_his], [z], f"{kernel_a} {label}", tol)
        coeffs = [leaf(t) for t in (ref_lo, *ref_his[::-1])]
        plain = [leaf(t) for t in coeffs]
        pads, lens = chain_crops(x, ref_his, L)
        rec = _pallas1d_multi.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
        ref = _pallas1d_multi.multi_synthesis_plain(plain, rl, rh, pads, lens)
        ct = [randn(rec.shape, f32, SEED + 160)]
        row_b = vjp_timing([rec], coeffs, ct, [ref], plain, f"{kernel_b} {label}", tol)
        # the same VJP launches called directly, without the autograd engine
        taps = [_kernels.static_taps(f) for f in (dl, dh, rl, rh)]
        bands = [cts[0], *cts[1:][::-1]]
        fold = mode if mode in PADDED_MODES else None
        row_a["vjp_direct_ms"] = time_ms(lambda: _pallas1d_multi.synthesis_pyramid(
            kernel_b, bands, taps[0], taps[1], [std_pad(L)] * depth, x.shape[-1], False, fold))
        ints, smem = _pallas1d_multi._adjoint_plan(L, x.shape[-1], [h.shape[-1] for h in ref_his], pads, 4)
        row_b["vjp_direct_ms"] = time_ms(lambda: _pallas1d_multi._launch_analysis(
            kernel_a, ct[0], taps[2], taps[3], ints, smem, False, None))
        return row_a, row_b

    rows["K8a"], rows["K8b"] = run_rows("K8a", "K8b", "periodic", 4, "d1 periodic run")
    # reflect: the same launch with the fold in its edge blocks
    rows["K8a reflect"], _ = run_rows("K8a", "K8b", "reflect", 4, "d1 reflect run")
    log(
        f"  K8a VJP: periodic {rows['K8a']['vjp_ms']!r} ms, reflect (the fold in the edge blocks) "
        f"{rows['K8a reflect']['vjp_ms']!r} ms"
    )
    rows["K7a"], rows["K7b"] = run_rows("K7a", "K7b", "reflect", 1, "K7 reflect level")
    # one library call each: K7a's VJP is one stride-2 transposed
    # convolution (before the reflect fold), K7b's one stride-2 correlation
    # of the cotangent zero-padded by the crop
    p = std_pad(L)
    lo, hi = _pallas1d.flat_dwt_lane(x.detach(), dl, dh, "reflect")
    m = lo.shape[-1]
    wdec = torch.stack([torch.as_tensor(np.asarray(f), dtype=f32, device=DEVICE) for f in (dl, dh)])[:, None]
    wrec = torch.stack([torch.as_tensor(np.asarray(f), dtype=f32, device=DEVICE) for f in (rl, rh)])[:, None]
    ct_bands = torch.stack([randn(lo.shape, f32, SEED + 165), randn(hi.shape, f32, SEED + 166)], dim=1)
    rows["K7a"]["vjp_library_ms"] = time_ms(lambda: F.conv_transpose1d(ct_bands, wdec, stride=2))
    rows["K7a"]["vjp_library_note"] = "F.conv_transpose1d(stride=2), before the reflect fold"
    n = x.shape[-1]
    ct = F.pad(randn((D1_SHAPE[0], 1, n), f32, SEED + 167), (p, 2 * (m - 1) + L - n - p))
    lib = F.conv1d(ct, wrec, stride=2)
    log(f"  K7b VJP library yardstick: {tuple(lib.shape)} from the cotangent padded to {tuple(ct.shape)}")
    rows["K7b"]["vjp_library_ms"] = time_ms(lambda: F.conv1d(ct, wrec, stride=2))
    rows["K7b"]["vjp_library_note"] = "F.conv1d(stride=2) on the cotangent zero-padded by the crop"
    del x, lo, hi, ct_bands, ct, lib
    x = leaf(randn(K6_SHAPE, f32, SEED + 170))
    bands = _pallas.fused_wavedec1d_per(x, dl, dh, LEVEL_1D)
    cts = [randn(t.shape, f32, SEED + 180 + j) for j, t in enumerate(bands)]
    z = leaf(x)
    rows["K6a"] = vjp_timing(bands, [x], cts, _pallas.wavedec1d_per_plain(z, dl, dh, LEVEL_1D), [z], "K6a", tol)
    leaves = [leaf(t) for t in bands]
    plain = [leaf(t) for t in leaves]
    ct = [randn(x.shape, f32, SEED + 190)]
    rec = _pallas.fused_waverec1d_per(leaves, rl, rh)
    rows["K6b"] = vjp_timing([rec], leaves, ct, [_pallas.waverec1d_per_plain(plain, rl, rh)], plain, "K6b", tol)
    for name, row in rows.items():
        log(
            f"  {name} VJP: vjp_ms={row['vjp_ms']!r} vjp_plain_ms={row['vjp_plain_ms']!r} "
            f"vjp_max_abs_err={row['vjp_max_abs_err']!r} vjp_library_ms={row.get('vjp_library_ms')!r} "
            f"vjp_direct_ms={row.get('vjp_direct_ms')!r}"
        )
    return rows


#: phase 11's 1d configurations: (name, shape, mode, level, the launches
#: of its backward): levels 5-10 of d1 run on K3/K4, whose VJPs are each
#: other (six K4 launches for the six K3 levels and six K3 for the six K4
#: steps); each fused run's VJP is one launch of the other pyramid kernel
TRAIN_1D = (
    ("d1 periodic", D1_SHAPE, "periodic", LEVEL_1D, {"K3": 6, "K4": 6, "K8a": 1, "K8b": 1}),
    ("d1 reflect", D1_SHAPE, "reflect", LEVEL_1D, {"K3": 6, "K4": 6, "K8a": 1, "K8b": 1}),
    ("K6 periodization", K6_SHAPE, "periodization", LEVEL_1D, {"K6a": 3, "K6b": 3}),
    ("K7 reflect level 1", D1_SHAPE, "reflect", 1, {"K7a": 1, "K7b": 1}),
)


def check_backward(name: str, backward: dict, allowed) -> None:
    """One backward launched exactly the kernels of ``allowed``: a dict of
    launch counts, or the names of every kernel it may and must launch."""
    if isinstance(allowed, dict):
        only(backward, allowed, f"the {name} backward")
        return
    used = {k for k, v in backward.items() if v}
    if used != set(allowed):
        raise AssertionError(f"the {name} backward launched {sorted(used)}, expected {sorted(allowed)}")



# ---------------------------------------------------------------------------
# phase 12: the tensor-core level K9a/K9b (opt-in PTWT_TPU_MXU2D=1)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def mxu2d_opt_in():
    """Set the K9 opt-in for the block, and restore what was there."""
    saved = os.environ.get(MXU2D_ENV)
    os.environ[MXU2D_ENV] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(MXU2D_ENV, None)
        else:
            os.environ[MXU2D_ENV] = saved


def banks_2d(dtype=torch.float32):
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=dtype)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=dtype)
    return dl, dh, rl, rh


def only(counts: dict, want: dict, label: str) -> None:
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def check_k9(errors: dict) -> None:
    """K9a, K9b and their VJPs against their plain versions (autograd
    through them for the VJPs) at the headline's level 1, both modes."""
    f32 = torch.float32
    dl, dh, rl, rh = banks_2d()
    for mode in ("periodic", "periodization"):
        tag = f"{mode} {list(SHAPE)}"
        x = leaf(randn(SHAPE, f32, SEED + 300))
        _kernels.reset_launch_counts()
        bands = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
        torch.cuda.synchronize()
        only(_kernels.LAUNCHES, {"K9a": 1}, f"K9a {tag}")
        with plain_versions():
            ref = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
        check_1d(errors, "K9a", tag, [b.detach() for b in bands], [r.detach() for r in ref], f32)
        _kernels.reset_launch_counts()
        rec = _pallas2d.fused2_idwt_level([r.detach() for r in ref], rl, rh, mode)
        torch.cuda.synchronize()
        only(_kernels.LAUNCHES, {"K9b": 1}, f"K9b {tag}")
        with plain_versions():
            want = _pallas2d.fused2_idwt_level([r.detach() for r in ref], rl, rh, mode)
        check_1d(errors, "K9b", tag, rec, want, f32)
        check(f"K9b(K9a) {tag} round trip", max_abs(rec, x.detach()), 10 * TOL[f32])
        # K9a's VJP is a K9b launch, K9b's a K9a launch
        cts = [randn(b.shape, f32, SEED + 310 + i) for i, b in enumerate(bands)]
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(bands, x, cts)
        torch.cuda.synchronize()
        only(_kernels.LAUNCHES, {"K9b": 1}, f"K9a VJP {tag}")
        (want,) = torch.autograd.grad(ref, x, cts)
        check_1d(errors, "K9a VJP", tag, grad, want, f32)
        subbands = [leaf(r) for r in ref]
        rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, mode)
        ct = randn(rec.shape, f32, SEED + 320)
        _kernels.reset_launch_counts()
        grads = torch.autograd.grad(rec, subbands, ct)
        torch.cuda.synchronize()
        only(_kernels.LAUNCHES, {"K9a": 1}, f"K9b VJP {tag}")
        with plain_versions():
            plain_rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, mode)
        want = torch.autograd.grad(plain_rec, subbands, ct)
        check_1d(errors, "K9b VJP", tag, list(grads), list(want), f32)
        del x, bands, ref, rec, want, cts, grad, subbands, ct, grads, plain_rec
        torch.cuda.synchronize()


def odd_bank() -> tuple:
    """A user's 7-tap bank ``(dec_lo, dec_hi, rec_lo, rec_hi)`` (numpy,
    unit norm on average): no registry wavelet has an odd length."""
    rs = np.random.RandomState(SEED + 73)
    return tuple(rs.randn(7) / math.sqrt(7) for _ in range(4))


def check_odd_bank(cases, forbidden, label: str) -> None:
    """Phases 7 and 9: ``wavedec``/``wavedec2`` and back with an odd bank
    on the card against the CPU plain path (float64, 1e-10), launching none
    of ``forbidden`` (the gates decline odd banks); where ``ptwt_tpu``'s
    rules refuse the reconstruction (a multi-level chain of odd-bank
    bands), the card must refuse it too."""
    bank = odd_bank()
    f64 = torch.float64
    for i, (shape, mode, level) in enumerate(cases):
        one_d = len(shape) == 2
        fwd, inv = (ptwt.wavedec, ptwt.waverec) if one_d else (ptwt.wavedec2, ptwt.waverec2)
        flat = list if one_d else flat_coeffs
        rec_mode = "periodization" if mode == "periodization" else None
        tag = f"{label} odd bank {list(shape)} {mode} level {level}"
        x = randn(shape, f64, SEED + 380 + i)
        _kernels.reset_launch_counts()
        got = fwd(x, bank, mode=mode, level=level)
        torch.cuda.synchronize()
        want = fwd(x.cpu(), bank, mode=mode, level=level)
        check(f"{tag} vs the CPU plain path (relative)",
              rel_err([t.cpu() for t in flat(got)], flat(want)), TOL[f64])
        try:
            rec_want = inv(want, bank, mode=rec_mode)
        except AssertionError:
            rec_want = None
        if rec_want is None:
            try:
                inv(got, bank, mode=rec_mode)
            except AssertionError as exc:
                if "padding error" not in str(exc):
                    raise
                log(f"  {tag}: the reconstruction is refused on both devices")
            else:
                raise AssertionError(f"{tag}: the card reconstructs a chain the reference refuses")
        else:
            rec = inv(got, bank, mode=rec_mode)
            torch.cuda.synchronize()
            check(f"{tag} round trip vs the CPU plain path (relative)", rel_err(rec.cpu(), rec_want), TOL[f64])
        launched = {k for k, v in _kernels.LAUNCHES.items() if v}
        log(f"  {tag}: launches {dict((k, v) for k, v in _kernels.LAUNCHES.items() if v)}")
        if launched & set(forbidden) or not launched:
            raise AssertionError(f"{tag}: launched {sorted(launched)}, none of {forbidden} allowed")


def k9_bank(name: str) -> tuple:
    """K9's taps ``(lo, hi, rec_lo, rec_hi)`` as floats, the analysis pair
    in correlation order."""
    if name == "odd7":
        lo, hi, rl, rh = odd_bank()
        return list(lo[::-1]), list(hi[::-1]), list(rl), list(rh)
    dl, dh, _, _ = get_filter_arrays(name, flip=True, dtype=torch.float64)
    _, _, rl, rh = get_filter_arrays(name, flip=False, dtype=torch.float64)
    return tuple([float(v) for v in f] for f in (dl, dh, rl, rh))


def k9_geometry(h: int, w: int, L: int, mode: str) -> tuple:
    """``(pad, m_h, m_w)`` of a K1 launch of one level, which K9 takes."""
    if mode == "periodization":
        return L // 2 - 1, h // 2, w // 2
    p = std_pad(L)
    return p, (h + 2 * p - L) // 2 + 1, (w + 2 * p - L) // 2 + 1


def check_k9_launches(errors: dict) -> None:
    """Phase 12: each K9 instance launched through its wrapper at
    :data:`K9_EXTRA`, against its plain version (float32, relative 2e-5),
    one launch each: K9a, K9b, K9a's VJP (K9b folding the band rows past
    half the period) and K9b's VJP (K9a, zero-bounded in periodic)."""
    f32 = torch.float32
    for i, (shape, name, mode) in enumerate(K9_EXTRA):
        lo, hi, rl, rh = k9_bank(name)
        b, h, w = shape
        p, m_h, m_w = k9_geometry(h, w, len(lo), mode)
        circ = mode == "periodization"
        fold = (h // 2, w // 2, h, w)
        x = randn(shape, f32, SEED + 400 + i)
        bands = [randn((b, m_h, m_w), f32, SEED + 410 + 10 * i + j) for j in range(4)]
        tag = f"{list(shape)} {name} {mode}"
        for label, kernel, fn, args in (
            ("K9a", "K9a", "dwt", (x, lo, hi, h, w, m_h, m_w, p)),
            ("K9b", "K9b", "idwt", (bands, rl, rh, h, w, p, circ)),
            ("K9a VJP", "K9b", "idwt", (bands, lo, hi, h, w, p, True, fold)),
            ("K9b VJP", "K9a", "dwt", (x, rl, rh, h, w, m_h, m_w, p, circ)),
        ):
            _kernels.reset_launch_counts()
            got = getattr(_mxu2d, f"mxu2_{fn}_call")(*args)
            torch.cuda.synchronize()
            only(_kernels.LAUNCHES, {kernel: 1}, f"{label} {tag}")
            want = getattr(_mxu2d, f"mxu2_{fn}_plain")(*args)
            check_1d(errors, label, tag, got, want, f32)
        del x, bands, got, want


def one_pass_tf32() -> dict:
    """What one TF32 pass gives: ``csrc/mxu2d.cu`` built once more with
    ``-DPTWT_MXU2D_ONE_PASS`` (big x big products only; a debug build the
    package never loads), called directly (no launch count) on the
    periodic headline level, against K9's plain versions."""
    lib_path = _kernels.BUILD_DIR / "libmxu2d_one_pass_debug.so"
    cmd = [_kernels._nvcc(), *_kernels._FLAGS, "-DPTWT_MXU2D_ONE_PASS", "-o", str(lib_path),
           str(_kernels._CSRC / "mxu2d.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("ptwt_mxu2d_analysis", "ptwt_mxu2d_synthesis"):
        getattr(lib, name).argtypes = _kernels._ENTRY_POINTS[name][1]
        getattr(lib, name).restype = ctypes.c_int
    dl, dh, rl, rh = (_kernels.static_taps(f) for f in banks_2d())
    b, h, w = SHAPE
    L, p = len(dl), std_pad(len(dl))
    m = (h + 2 * p - L) // 2 + 1
    x = randn(SHAPE, torch.float32, SEED + 330)
    stream = torch.cuda.current_stream().cuda_stream
    bands = torch.empty((4, b, m, m), device=DEVICE)
    plan_a = _mxu2d.analysis_plan(L, p, m, m)
    plan_s = _mxu2d.synthesis_plan(L, p, p, m, m, h, w)
    code = lib.ptwt_mxu2d_analysis(0, x.data_ptr(), bands.data_ptr(), _kernels.taps_array(dl),
                                   _kernels.taps_array(dh), L, b, h, w, h, w, m, m, p, 1,
                                   _kernels.int_array(plan_a), len(plan_a), stream)
    want = _mxu2d.mxu2_dwt_plain(x, dl, dh, h, w, m, m, p)
    rec = torch.empty(SHAPE, device=DEVICE)
    ptrs = [t.data_ptr() for t in want]
    code2 = lib.ptwt_mxu2d_synthesis(0, *ptrs, rec.data_ptr(), _kernels.taps_array(rl),
                                     _kernels.taps_array(rh), L, b, m, m, h, w, p, p, 0, m, m, h, w,
                                     _kernels.int_array(plan_s), len(plan_s), stream)
    torch.cuda.synchronize()
    if code or code2:
        raise AssertionError(f"the one-pass debug build failed: {code}, {code2}")
    rec_want = _mxu2d.mxu2_idwt_plain(list(want), rl, rh, h, w, p, False)
    res = {
        "analysis_max_abs_err": max_abs(bands, want),
        "analysis_rel_err": rel_err(bands, want),
        "synthesis_max_abs_err": max_abs(rec, rec_want),
        "synthesis_rel_err": rel_err(rec, rec_want),
    }
    log(f"  one-pass TF32 (debug build, not the package's): {res} (limit {TOL[torch.float32]!r})")
    return res


def band_flops(b: int, m_h: int, m_w: int, out_h: int, out_w: int, L: int) -> tuple[float, float]:
    """Tensor-core operations of K9a and K9b over the k-steps inside the
    band (one multiply-add = 2), before the 3x of the split: every K-wide
    product a fragment runs, 16 x 8 outputs per fragment, k-steps of 8."""
    kw_a, kh_a = math.ceil((L + 14) / 8), math.ceil((L + 30) / 8)
    ks, kw_s = math.ceil(((L + 15) // 2 + 1) / 8), math.ceil(((L + 7) // 2 + 1) / 8)
    # K9a: W pass over the 2 m_h + L - 2 image rows it reads (lo and hi),
    # H pass for the four bands
    ana = 2.0 * b * ((2 * m_h + L - 2) * 2 * m_w * 8 * kw_a + 4 * m_h * m_w * 8 * kh_a)
    # K9b: H pass over the four bands, W pass with two products per output
    syn = 2.0 * b * (4 * out_h * m_w * 8 * ks + 2 * out_h * out_w * 8 * kw_s)
    return ana, syn


def k9_bound(nbytes: float, tc_flops: float) -> tuple[float, str, float]:
    """K9's bound: the bytes over the memory rate against the band-only
    3xTF32 products over the TF32 tensor-core peak; and that product time."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tc = TF32_SPLIT * tc_flops / PEAK_TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes", t_tc) if t_bytes >= t_tc else (t_tc, "operations", t_tc)


def time_k9() -> dict:
    """Phase 5's rows of K9a, K9b and their VJPs at the periodic headline's
    level 1, beside their plain versions and the library calls of K1/K2's
    rows (TF32 off); the opt-in must be set."""
    f32 = torch.float32
    dl, dh, rl, rh = banks_2d()
    L = len(dl)
    p = std_pad(L)
    b, h, w = SHAPE
    x = leaf(randn(SHAPE, f32, SEED + 3))
    bands = _pallas2d.fused2_dwt_level(x.detach(), dl, dh, "periodic")
    m = bands[0].shape[-1]
    nbytes = 4 * (b * h * w + 4 * b * m * m)
    ana_flops, syn_flops = band_flops(b, m, m, h, w, L)
    dfilt, rfilt = outer_filters(dl, dh, f32), outer_filters(rl, rh, f32)
    xpad = F.pad(x.detach()[:, None], (p, p, p, p), mode="circular")
    rows = {}
    with plain_versions():
        plain_ms = time_ms(lambda: _pallas2d.fused2_dwt_level(x.detach(), dl, dh, "periodic"))
    rows["K9a"] = {
        "ms": time_ms(lambda: _pallas2d.fused2_dwt_level(x.detach(), dl, dh, "periodic")),
        "plain_ms": plain_ms,
        "library_ms": time_ms(lambda: F.conv2d(xpad, dfilt, stride=2)),
        "tc_flops": ana_flops,
    }
    del xpad
    stacked = torch.stack(bands, dim=1).contiguous()
    with plain_versions():
        plain_ms = time_ms(lambda: _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic"))
    rows["K9b"] = {
        "ms": time_ms(lambda: _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic")),
        "plain_ms": plain_ms,
        "library_ms": time_ms(lambda: F.conv_transpose2d(stacked, rfilt, stride=2)),
        "tc_flops": syn_flops,
    }
    del stacked
    # the VJPs as the autograd backward runs them, and their library calls
    outs = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
    cts = [randn(t.shape, f32, SEED + 340 + j) for j, t in enumerate(outs)]
    z = leaf(x)
    with plain_versions():
        plain_outs = _pallas2d.fused2_dwt_level(z, dl, dh, "periodic")
    rows["K9a"].update(vjp_timing(list(outs), [x], cts, list(plain_outs), [z], "K9a", TOL[f32]))
    cts_nchw = torch.stack(cts, dim=1)
    rows["K9a"]["vjp_library_ms"] = time_ms(lambda: F.conv_transpose2d(cts_nchw, dfilt, stride=2))
    del outs, plain_outs, cts_nchw
    leaves = [leaf(t) for t in bands]
    plain = [leaf(t) for t in bands]
    rec = _pallas2d.fused2_idwt_level(leaves, rl, rh, "periodic")
    with plain_versions():
        plain_rec = _pallas2d.fused2_idwt_level(plain, rl, rh, "periodic")
    ct = randn(rec.shape, f32, SEED + 350)
    rows["K9b"].update(vjp_timing([rec], leaves, [ct], [plain_rec], plain, "K9b", TOL[f32]))
    ct_pad = F.pad(ct[:, None], (p, p, p, p))
    rows["K9b"]["vjp_library_ms"] = time_ms(lambda: F.conv2d(ct_pad, rfilt, stride=2))
    sb, sh, sw = K9_SHAPES[1][1]
    sm = (sh + 2 * p - L) // 2 + 1
    small_flops = dict(zip(("K9a", "K9b"), band_flops(sb, sm, sm, sh, sw, L)))
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"], row["band_tc_ms"] = k9_bound(nbytes, row["tc_flops"])
        row["bound_ms_small"] = k9_bound(4 * (sb * sh * sw + 4 * sb * sm * sm), small_flops[name])[0]
        log(
            f"  {name}: ms={row['ms']!r} plain_ms={row['plain_ms']!r} library_ms={row['library_ms']!r} "
            f"bound_ms={row['bound_ms']!r} ({row['bound_by']}) band_tc_ms={row['band_tc_ms']!r} "
            f"vjp_ms={row['vjp_ms']!r} vjp_plain_ms={row['vjp_plain_ms']!r} "
            f"vjp_library_ms={row['vjp_library_ms']!r}"
        )
    return rows


def round_trips_k9() -> dict:
    """The periodic headline round trip with the opt-in beside the default,
    in turns (default, opt-in, opt-in, default), Mpix/s."""
    x = randn(SHAPE, torch.float32, SEED + 360)
    mpix = SHAPE[0] * SHAPE[1] * SHAPE[2] / 1e6

    def run():
        return ptwt.waverec2(ptwt.wavedec2(x, WAVELET, mode="periodic", level=LEVEL), WAVELET, mode="periodic")

    res = {"default": [], "opt_in": []}
    for key in ("default", "opt_in", "opt_in", "default"):
        ctx = mxu2d_opt_in() if key == "opt_in" else contextlib.nullcontext()
        with ctx:
            ms = wall_ms(run)
        res[key].append(mpix / (ms * 1e-3))
        log(f"  round trip periodic {key}: {ms!r} ms, {mpix / (ms * 1e-3)!r} Mpix/s")
    return res


def k9_times() -> dict:
    """Device ms of K9a, K9b and both VJP instances (as the autograd
    backward runs them, and launched alone) with the opt-in, and of K1,
    K2 and their VJPs without it, on the periodic level 1 of
    :data:`K9_SHAPES` (db4,
    float32), each call's launches asserted; then the periodic headline
    round trip with and without the opt-in (:func:`round_trips_k9`, median
    Mpix/s): the rows ``--parent`` compares in turns (entry points both
    trees have)."""
    f32 = torch.float32
    dl, dh, rl, rh = banks_2d()
    out = {}
    for i, (name, shape) in enumerate(K9_SHAPES):
        x = leaf(randn(shape, f32, SEED + 370 + i))
        xd = x.detach()
        for opted, (ka, kb) in ((True, ("K9a", "K9b")), (False, ("K1", "K2"))):
            with mxu2d_opt_in() if opted else contextlib.nullcontext():
                _kernels.reset_launch_counts()
                bands = _pallas2d.fused2_dwt_level(xd, dl, dh, "periodic")
                _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic")
                torch.cuda.synchronize()
                only(_kernels.LAUNCHES, {ka: 1, kb: 1}, f"{ka}, {kb} {name}")
                out[f"{ka} {name}"] = time_ms(lambda: _pallas2d.fused2_dwt_level(xd, dl, dh, "periodic"))
                out[f"{kb} {name}"] = time_ms(lambda: _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic"))
                outs = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
                cts = [randn(t.shape, f32, SEED + 380 + j) for j, t in enumerate(outs)]
                out[f"{ka} VJP {name}"] = time_ms(lambda: torch.autograd.grad(outs, x, cts, retain_graph=True))
                leaves = [leaf(t) for t in bands]
                rec = _pallas2d.fused2_idwt_level(leaves, rl, rh, "periodic")
                ct = randn(rec.shape, f32, SEED + 390)
                out[f"{kb} VJP {name}"] = time_ms(lambda: torch.autograd.grad(rec, leaves, ct, retain_graph=True))
                # the VJP launches alone, as the autograd Functions make them
                # (without the engine and the stack of the four cotangents)
                _, h, w = shape
                p = std_pad(len(dl))
                m = bands[0].shape[-1]
                fold = (h // 2, w // 2, h, w)
                dec = [_kernels.static_taps(f) for f in (dl, dh)]
                rec_taps = [_kernels.static_taps(f) for f in (rl, rh)]
                out[f"{ka} VJP direct {name}"] = time_ms(lambda: _pallas2d._idwt2_kernel(cts, *dec, h, w, p, True, fold))
                out[f"{kb} VJP direct {name}"] = time_ms(
                    lambda: _pallas2d._dwt2_kernel(ct, *rec_taps, h, w, m, m, p, False))
                del bands, outs, cts, leaves, rec, ct
        del x, xd
    trips = round_trips_k9()
    out["round trip default Mpix/s"] = statistics.median(trips["default"])
    out["round trip opt-in Mpix/s"] = statistics.median(trips["opt_in"])
    return out


# ---------------------------------------------------------------------------
# phase 13: launches of 2^31 outputs and more
# ---------------------------------------------------------------------------


def ends(t: torch.Tensor):
    """The first and the last image of a batch, as batches of one."""
    return t[:1], t[-1:]


def check_past_2_31() -> None:
    """One level of ``BIG`` and back in periodic (K1 writes 4 * 32 * 4098^2
    = 2,149,581,312 outputs, K2 32 * 8192^2 = 2^31) and reflect (K3 and
    the two-pair K4 write 2 * 32 * 4099 * 8192 = 2,149,056,512), and K1's
    VJP on the periodic level: the first and the last image against the
    plain version run on that image alone.  Frees its tensors."""
    f32 = torch.float32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    x = randn(BIG, f32, SEED + 400)
    for mode, must in (("periodic", ("K1", "K2")), ("reflect", ("K3", "K4"))):
        _kernels.reset_launch_counts()
        coeffs = ptwt.wavedec2(x, WAVELET, mode=mode, level=1)
        rec = ptwt.waverec2(coeffs, WAVELET, mode=mode)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        log(f"  {mode} {list(BIG)} level 1: launches {counts}")
        for name in must:
            if not counts.get(name):
                raise AssertionError(f"{name} was not launched by the {mode} level of {list(BIG)}")
        flat = flat_coeffs(coeffs)
        for i, xi in zip((0, BIG[0] - 1), ends(x)):
            got = [ends(c)[0 if i == 0 else 1] for c in flat]
            with plain_versions():
                ref = flat_coeffs(ptwt.wavedec2(xi, WAVELET, mode=mode, level=1))
                back = ptwt.waverec2((got[0], tuple(got[1:])), WAVELET, mode=mode)
            check(f"{mode} image {i} coefficients vs plain", max_abs(got, ref), 2e-5)
            mine = ends(rec)[0 if i == 0 else 1]
            check(f"{mode} image {i} reconstruction vs plain", max_abs(mine, back), 2e-5)
            check(f"{mode} image {i} round trip", max_abs(mine, xi), ROUND_TRIP_TOL)
        del coeffs, rec, flat, got, ref, back, mine
    x = leaf(x)
    bands = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
    cts = randn((4, *bands[0].shape), f32, SEED + 401)
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(bands, x, tuple(cts.unbind(0)))
    torch.cuda.synchronize()
    if _kernels.LAUNCHES["K2"] != 1:
        raise AssertionError("K1's VJP on the periodic level did not launch K2 once")
    del bands
    for j, (xi, gi) in enumerate(zip(ends(x.detach()), ends(grad))):
        ci = [ends(c)[j] for c in cts.unbind(0)]
        want = _pallas2d.dwt2_level_vjp_plain(xi, dl, dh, "periodic", ci)
        check(f"K1 VJP (K2) image {(0, BIG[0] - 1)[j]} vs plain", max_abs(gi, want), 2e-5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del x, cts, grad, xi, gi, ci, want
    torch.cuda.empty_cache()
    log(f"  phase 13 peak device memory {peak!r} GB")


# ---------------------------------------------------------------------------
# phase 14: the 3d and fully separable main paths
# ---------------------------------------------------------------------------

#: the public entry points of each N-d transform, and its (K3, K4)
#: launches per level: 3d synthesis runs axis -1's four (lo, hi) pairs as
#: two two-pair launches, then one launch each along -2 and -3
ND_FUNCS = {
    "3d": ("wavedec3", "waverec3"),
    "fs2": ("fswavedec2", "fswaverec2"),
    "fs3": ("fswavedec3", "fswaverec3"),
}
ND_LAUNCHES = {"3d": (3, 4), "fs2": (2, 2), "fs3": (3, 4)}
#: bench.py's d3 and fs2 rows at full width (float32): (name, kind, shape,
#: wavelet, mode, level)
ND_FULL = (
    ("d3", "3d", (32, 100, 100, 100), "db5", "reflect", 3),
    ("fs2", "fs2", (32, 1000, 1000), "db5", "reflect", 5),
)
ND_SMALL_3D = (4, 34, 40, 46)
ND_SMALL_2D = (4, 340, 460)
#: the smaller runs: (name, kind, shape, wavelet, mode, level, dtype, axes):
#: every other mode, float64, axes not last and fswavedec3, at odd levels.
#: A periodization chain of the separable transforms does not round-trip:
#: one level comes back shorter and three raise ValueError, as in ptwt_tpu.
ND_SMALL = (
    *((f"{kind} {mode}", kind, ND_SMALL_2D if kind == "fs2" else ND_SMALL_3D, "db5", mode, 3, torch.float32, None)
      for kind in ND_FUNCS for mode in ("zero", "symmetric", "periodic", "periodization")),
    ("fs2 periodization level 1", "fs2", ND_SMALL_2D, "db5", "periodization", 1, torch.float32, None),
    ("3d reflect float64", "3d", (2, 34, 40, 46), "db5", "reflect", 3, torch.float64, None),
    ("fs2 reflect float64", "fs2", (2, 340, 460), "db5", "reflect", 3, torch.float64, None),
    ("fs3 periodic float64", "fs3", (2, 34, 40, 46), "sym4", "periodic", 1, torch.float64, None),
    ("3d axes (0, 2, 3)", "3d", (34, 4, 40, 46), "sym4", "zero", 3, torch.float32, (0, 2, 3)),
    ("fs2 axes (0, 2)", "fs2", (340, 4, 460), "db5", "symmetric", 3, torch.float32, (0, 2)),
)


def nd_leaves(coeffs) -> list:
    """The approximation, then each level's bands by sorted key."""
    return [coeffs[0]] + [d[k] for d in coeffs[1:] for k in sorted(d)]


def nd_forward(kind: str, x, wavelet: str, mode: str, level: int, axes):
    kwargs = {} if axes is None else {"axes": axes}
    return getattr(ptwt, ND_FUNCS[kind][0])(x, wavelet, mode=mode, level=level, **kwargs)


def nd_inverse(kind: str, coeffs, wavelet: str, mode: str, axes):
    """The inverse as a user calls it: ``waverec3`` told of periodization,
    ``fswaverec*`` (no mode argument) the padded synthesis."""
    kwargs = {} if axes is None else {"axes": axes}
    if kind == "3d":
        kwargs["mode"] = mode if mode == "periodization" else None
    return getattr(ptwt, ND_FUNCS[kind][1])(coeffs, wavelet, **kwargs)


def nd_only(counts: dict, want: dict, label: str) -> None:
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} and no other kernel")


def nd_crop(rec: torch.Tensor, x: torch.Tensor, kind: str, axes) -> torch.Tensor:
    """The reconstruction cropped to the input on the transformed axes."""
    index = [slice(None)] * x.ndim
    for ax in axes if axes is not None else range(-(2 if kind == "fs2" else 3), 0):
        index[ax] = slice(0, x.shape[ax])
    return rec[tuple(index)]


def nd_run(name: str, kind: str, x: torch.Tensor, wavelet: str, mode: str, level: int, axes=None) -> dict:
    """Phase 14's check of one configuration: the forward and the inverse on
    the kernel path, each with the counts set to 0 just before it and read
    just after, against the plain path on the card (bands relative to
    ``max(1, |band|)``: 2e-5 float32, 1e-10 float64), the round trip against
    the input (1e-4), and the launches of each direction."""
    k3, k4 = ND_LAUNCHES[kind]
    _kernels.reset_launch_counts()
    coeffs = nd_forward(kind, x, wavelet, mode, level, axes)
    torch.cuda.synchronize()
    fwd_counts = dict(_kernels.LAUNCHES)
    _kernels.reset_launch_counts()
    try:
        rec = nd_inverse(kind, coeffs, wavelet, mode, axes)
    except ValueError as err:
        rec = err
    torch.cuda.synchronize()
    inv_counts = dict(_kernels.LAUNCHES)
    nd_only(fwd_counts, {"K3": k3 * level}, f"{name} forward")
    with plain_versions():
        ref = nd_forward(kind, x, wavelet, mode, level, axes)
        try:
            ref_rec = nd_inverse(kind, ref, wavelet, mode, axes)
        except ValueError as err:
            ref_rec = err
    tol = TOL[x.dtype]
    out = {"forward": fwd_counts["K3"]}
    out["coeff_rel_err"] = check(
        f"{name} coefficients vs plain path (relative)", rel_err(nd_leaves(coeffs), nd_leaves(ref)), tol
    )
    if isinstance(ref_rec, ValueError):
        if not (isinstance(rec, ValueError) and kind != "3d" and mode == "periodization"):
            raise AssertionError(f"{name}: the plain path raised {ref_rec!r}, the kernel path gave {rec!r}")
        log(f"  {name}: both paths raise ValueError ({rec})")
        return out
    if isinstance(rec, ValueError):
        raise rec
    nd_only(inv_counts, {"K4": k4 * level}, f"{name} inverse")
    out["inverse"] = inv_counts["K4"]
    out["rec_rel_err"] = check(f"{name} reconstruction vs plain path (relative)", rel_err(rec, ref_rec), tol)
    if kind != "3d" and mode == "periodization":
        log(f"  {name}: {list(rec.shape)} from {list(x.shape)}, one padded synthesis level (as ptwt_tpu)")
        return out
    out["round_trip_err"] = check(f"{name} round trip vs input", max_abs(nd_crop(rec, x, kind, axes), x), ROUND_TRIP_TOL)
    return out


def nd_gradient(name: str, kind: str, x: torch.Tensor, wavelet: str, mode: str, level: int) -> dict:
    """One backward through the forward and the inverse, cotangents on every
    band and on the reconstruction, against autograd through the plain path
    on the card: within 1e-4 of the largest entry; the backward launches
    each forward launch's twin (K3 <-> K4)."""
    k3, k4 = ND_LAUNCHES[kind]

    def grad_of(xd):
        xd = leaf(xd)
        coeffs = nd_forward(kind, xd, wavelet, mode, level, None)
        outs = [*nd_leaves(coeffs), nd_inverse(kind, coeffs, wavelet, mode, None)]
        cts = [randn(o.shape, o.dtype, SEED + 600 + i) for i, o in enumerate(outs)]
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(outs, xd, cts)
        torch.cuda.synchronize()
        return grad, dict(_kernels.LAUNCHES)

    grad, back = grad_of(x)
    nd_only(back, {"K3": k4 * level, "K4": k3 * level}, f"{name} backward")
    with plain_versions():
        want, _ = grad_of(x)
    scale = float(want.abs().max())
    err = check(f"{name} gradient vs plain path (over its largest entry {scale!r})", max_abs(grad, want) / scale,
                TRAIN_GRAD_TOL)
    return {"backward": {k: v for k, v in back.items() if v}, "grad_rel_err": err}


def nd_times(kind: str, x: torch.Tensor, wavelet: str, mode: str, level: int, label: str) -> dict:
    """CUDA-event device ms and wall ms (3 warm-ups, median of 20) of one
    round trip and of one backward through it, and the device-busy share
    of each (``torch.profiler``'s device time over the wall ms)."""
    def round_trip():
        return nd_inverse(kind, nd_forward(kind, x, wavelet, mode, level, None), wavelet, mode, None)

    xd = leaf(x)
    coeffs = nd_forward(kind, xd, wavelet, mode, level, None)
    outs = [*nd_leaves(coeffs), nd_inverse(kind, coeffs, wavelet, mode, None)]
    cts = [randn(o.shape, o.dtype, SEED + 620 + i) for i, o in enumerate(outs)]

    def backward():
        return torch.autograd.grad(outs, xd, cts, retain_graph=True)

    out = {}
    launches = level * sum(ND_LAUNCHES[kind])  # the backward launches each one's twin
    for what, run in (("round_trip", round_trip), ("backward", backward)):
        out[f"{what}_ms"] = time_ms(run)
        out[f"{what}_wall_ms"] = wall_ms(run)
        busy, complete = nd_busy_ms(run, f"{label} {what}", launches)
        out[f"{what}_busy_ms"] = busy
        out[f"{what}_busy_share"] = busy / out[f"{what}_wall_ms"]
        out[f"{what}_profile_complete"] = complete
    return out


def nd_busy_ms(run, label: str, launches: int) -> tuple[float, bool]:
    """Device busy ms of one call of ``run`` from ``torch.profiler`` (the
    device time of every kernel and copy it ran), and whether the window
    holds all ``launches`` K3/K4 launches (late in a long process the
    profiler's windows lose some: :func:`nd_times_all` runs in a process
    of its own)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        dev = getattr(evt, "self_device_time_total", None)
        rows.append(((dev if dev is not None else evt.self_cuda_time_total) / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    seen = sum(count for _, count, key in rows if "_axis_kernel" in key)
    log(f"  profiled {label}: device busy {busy!r} ms, {seen} of {launches} K3/K4 launches in the window")
    for ms, count, key in rows[:6]:
        log(f"    {ms!r} ms x{count} {key[:100]}")
    return busy, seen == launches


def nd_times_all() -> dict:
    """``--nd-times``: :func:`nd_times` of every ``ND_FULL`` row, and d3's
    level-1 plain and library rows (:func:`d3_plain_library`)."""
    out = {}
    for i, (name, kind, shape, wavelet, mode, level) in enumerate(ND_FULL):
        x = randn(shape, torch.float32, SEED + 700 + i)
        out[name] = nd_times(kind, x, wavelet, mode, level, name)
        if kind == "3d":
            out[name]["level1"] = d3_plain_library(x, wavelet, mode)
        del x
        torch.cuda.empty_cache()
    return out


def d3_launch_rows(x: torch.Tensor, wavelet: str, mode: str) -> dict:
    """Device ms of each K3/K4 launch of d3's level 1 (float32), beside its
    bound (each input read once, each output written once over the HBM
    rate, against the taps' multiply-adds over the float32 peak): K3 along
    -3 (``inner`` a whole ``h w`` plane), -2 and -1 (the packed siblings in
    ``outer``), and back K4 along -1 (two two-pair launches), -2 (two
    pairs) and -3 (one pair, plane-sized ``inner``), and each one's VJP
    launch through autograd (one launch: K3's is K4's fold instance, K4's a
    zero-bounded K3; along -1 one of the two K4 launches).  Also the synthesis
    level as route (a) would run it, the JAX package's: the pairs of each
    axis stacked into one pair of batch 4 and 2, three launches and the
    stacking copies, against the package's route (b)."""
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=x.dtype)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=x.dtype)
    L = len(dl)
    item = x.element_size()
    pad = std_pad(L)
    a = _pallas2.pallas_dwt_axis(x, -3, dl, dh, mode)
    b = _pallas2.pallas_dwt_axis(a, -2, dl, dh, mode)
    c = _pallas2.pallas_dwt_axis(b, -1, dl, dh, mode)
    bands = list(c.flatten(0, 2).unbind(0))  # index 4w + 2h + d
    sub = [bands[4 * w + 2 * h + d] for d, h, w in ((i >> 2, (i >> 1) & 1, i & 1) for i in range(8))]
    crops = [(pad, pad)] * 3  # the finest level's crop, as waverec3 takes it

    def idwt(los, his, axis):
        return _pallas2.pallas_idwt_axis(los, his, axis, rl, rh, *crops[3 + axis], mode)

    lo_h = idwt(sub[0::4], sub[1::4], -1)
    hi_h = idwt(sub[2::4], sub[3::4], -1)
    d_pair = idwt(lo_h.unbind(0), hi_h.unbind(0), -2)
    rec = idwt(d_pair[:1].unbind(0), d_pair[1:].unbind(0), -3)
    rows = {}

    def row(name, run, ins, outs, flops):
        nbytes = item * (sum(t.numel() for t in ins) + sum(t.numel() for t in outs))
        ms, by = bound(nbytes, flops)
        rows[name] = {"ms": time_ms(run), "bound_ms": ms, "bound_by": by, "bytes": nbytes}
        rows[name]["ms_over_bound"] = rows[name]["ms"] / ms

    row("K3 -3 (plane inner)", lambda: _pallas2.pallas_dwt_axis(x, -3, dl, dh, mode), [x], [a], 4.0 * L * a[0].numel())
    row("K3 -2 (siblings in outer)", lambda: _pallas2.pallas_dwt_axis(a, -2, dl, dh, mode), [a], [b], 4.0 * L * b[0].numel())
    row("K3 -1 (siblings in outer)", lambda: _pallas2.pallas_dwt_axis(b, -1, dl, dh, mode), [b], [c], 4.0 * L * c[0].numel())
    row("K4 -1 (two pairs) x2", lambda: (idwt(sub[0::4], sub[1::4], -1), idwt(sub[2::4], sub[3::4], -1)),
        sub, [lo_h, hi_h], 2.0 * L * (lo_h.numel() + hi_h.numel()))
    row("K4 -2 (two pairs)", lambda: idwt(lo_h.unbind(0), hi_h.unbind(0), -2), [lo_h, hi_h], [d_pair],
        2.0 * L * d_pair.numel())
    row("K4 -3 (plane inner)", lambda: idwt(d_pair[:1].unbind(0), d_pair[1:].unbind(0), -3), [d_pair], [rec],
        2.0 * L * rec.numel())
    # the VJPs as the autograd backward runs them: K3's is one launch of
    # K4's fold instance, K4's one zero-bounded K3 launch
    for i, (axis, src, out) in enumerate(((-3, x, a), (-2, a, b), (-1, b, c))):
        sl = leaf(src)
        y = _pallas2.pallas_dwt_axis(sl, axis, dl, dh, mode)
        ct = randn(y.shape, y.dtype, SEED + 640 + i)
        row(f"K3 VJP {axis}", lambda y=y, sl=sl, ct=ct: torch.autograd.grad(y, sl, ct, retain_graph=True),
            [ct], [src], 4.0 * L * out[0].numel())
    for i, (axis, los, his) in enumerate((
        (-1, sub[0::4], sub[1::4]),
        (-2, lo_h.unbind(0), hi_h.unbind(0)),
        (-3, d_pair[:1].unbind(0), d_pair[1:].unbind(0)),
    )):
        ins = [leaf(t) for t in (*los, *his)]
        y = idwt(ins[: len(los)], ins[len(los):], axis)
        ct = randn(y.shape, y.dtype, SEED + 650 + i)
        row(f"K4 VJP {axis} ({len(los)} pair{'s' if len(los) > 1 else ''})",
            lambda y=y, ins=ins, ct=ct: torch.autograd.grad(y, ins, ct, retain_graph=True),
            [ct], ins, 2.0 * L * y.numel())

    def route_a():
        # the JAX package's synthesis: stack each axis's lo and hi
        # selections into one pair of batch G, one launch per axis
        los = torch.stack(sub[0::2])  # (d, h, w=0) for (d, h) in order
        his = torch.stack(sub[1::2])
        hw = idwt([los], [his], -1)[0]  # [4, B, d, h, W]
        dh_ = idwt([hw[0::2]], [hw[1::2]], -2)[0]  # [2, B, d, H, W]
        return idwt([dh_[0]], [dh_[1]], -3)[0]

    def route_b():
        return synthesis_nd(sub, rl, rh, pads=crops, mode=mode, ndim=3)

    got_a, got_b = route_a(), route_b()
    check("d3 level 1 synthesis: route (a) vs route (b)", max_abs(got_a, got_b), 2e-5)
    check("d3 level 1 synthesis: route (b) vs the launches above", max_abs(got_b, rec[0]), 0.0)
    rows["synthesis route (b), 4 launches"] = {"ms": time_ms(route_b)}
    rows["synthesis route (a), 3 launches and stacks"] = {"ms": time_ms(route_a)}
    return rows


def lanes(t: torch.Tensor, axis: int) -> torch.Tensor:
    """``t`` as ``[pre, 1, n, post]``: ``axis`` the conv's spatial H."""
    ax = t.ndim + axis
    return t.reshape(math.prod(t.shape[:ax]), 1, t.shape[ax], math.prod(t.shape[ax + 1:]))


def d3_plain_library(x: torch.Tensor, wavelet: str, mode: str) -> dict:
    """The plain version's and one library call's device ms beside each row
    of :func:`d3_launch_rows` (float32).  The library calls compute one
    launch's level with the transformed axis as the conv's H, on inputs
    made beforehand: ``F.conv2d`` (stride 2 along H) on the input padded
    by ``fwt_pad`` for K3 and on the cotangent padded by the crop for K4's
    VJP; ``F.conv_transpose2d`` on the stacked (lo, hi) pairs for K4 and
    on the packed cotangent for K3's VJP, before the crop or the fold."""
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=x.dtype)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=x.dtype)
    L, pad = len(dl), std_pad(len(dl))
    wa, wr = axis_filters(dl, dh, -2, x.dtype), axis_filters(rl, rh, -2, x.dtype)
    a = _pallas2.pallas_dwt_axis(x, -3, dl, dh, mode)
    b = _pallas2.pallas_dwt_axis(a, -2, dl, dh, mode)
    c = _pallas2.pallas_dwt_axis(b, -1, dl, dh, mode)
    bands = list(c.flatten(0, 2).unbind(0))
    sub = [bands[4 * w + 2 * h + d] for d, h, w in ((i >> 2, (i >> 1) & 1, i & 1) for i in range(8))]
    lo_h = _pallas2.pallas_idwt_axis(sub[0::4], sub[1::4], -1, rl, rh, pad, pad, mode)
    hi_h = _pallas2.pallas_idwt_axis(sub[2::4], sub[3::4], -1, rl, rh, pad, pad, mode)
    d_pair = _pallas2.pallas_idwt_axis(lo_h.unbind(0), hi_h.unbind(0), -2, rl, rh, pad, pad, mode)
    rows = {}

    def row(name, plain, library, note):
        rows[name] = {"plain_ms": time_ms(plain), "library_ms": time_ms(library), "library": note}

    for i, (name, axis, src, out) in enumerate((
        ("-3 (plane inner)", -3, x, a), ("-2 (siblings in outer)", -2, a, b), ("-1 (siblings in outer)", -1, b, c),
    )):
        padded = lanes(fwt_pad(src, L, mode=mode, axes=(src.ndim + axis,)), axis)
        ct = randn(out.shape, out.dtype, SEED + 640 + i)
        ct_in = lanes(ct, axis).reshape(2, -1, out.shape[axis], lanes(src, axis).shape[-1]).transpose(0, 1).contiguous()
        row(f"K3 {name}", lambda src=src, axis=axis: _pallas2.dwt_axis_plain(src, axis, dl, dh, mode),
            lambda padded=padded: F.conv2d(padded, wa, stride=(2, 1)), "F.conv2d, input padded beforehand")
        row(f"K3 VJP {axis}", lambda src=src, axis=axis, ct=ct: _pallas2.dwt_axis_vjp_plain(src, axis, dl, dh, mode, ct),
            lambda ct_in=ct_in: F.conv_transpose2d(ct_in, wa, stride=(2, 1)), "F.conv_transpose2d, before the fold")
    for i, (name, axis, pairs, vjp_pairs) in enumerate((
        ("K4 -1 (two pairs) x2", -1, list(zip(sub[0::2], sub[1::2])), list(zip(sub[0::4], sub[1::4]))),
        ("K4 -2 (two pairs)", -2, list(zip(lo_h.unbind(0), hi_h.unbind(0))), None),
        ("K4 -3 (plane inner)", -3, [(d_pair[0], d_pair[1])], None),
    )):
        vjp_pairs = vjp_pairs or pairs
        stacked = torch.cat([torch.cat([lanes(lo, axis), lanes(hi, axis)], 1) for lo, hi in pairs])
        outs = [_pallas2.idwt_axis_plain(lo, hi, axis, rl, rh, pad, pad, mode) for lo, hi in vjp_pairs]
        cts = [randn(o.shape, o.dtype, SEED + 650 + i + 10 * j) for j, o in enumerate(outs)]
        ct_pad = torch.cat([F.pad(lanes(g, axis), (0, 0, pad, pad)) for g in cts])
        row(name, lambda pairs=pairs, axis=axis: [_pallas2.idwt_axis_plain(lo, hi, axis, rl, rh, pad, pad, mode)
                                                  for lo, hi in pairs],
            lambda stacked=stacked: F.conv_transpose2d(stacked, wr, stride=(2, 1)), "F.conv_transpose2d, before the crop")
        n = len(vjp_pairs)
        row(f"K4 VJP {axis} ({n} pair{'s' if n > 1 else ''})",
            lambda vjp_pairs=vjp_pairs, axis=axis, cts=cts: [
                _pallas2.idwt_axis_vjp_plain(lo, hi, axis, rl, rh, pad, pad, mode, g) for (lo, hi), g in zip(vjp_pairs, cts)],
            lambda ct_pad=ct_pad: F.conv2d(ct_pad, wr, stride=(2, 1)), "F.conv2d, cotangent padded beforehand")
    for name, r in rows.items():
        log(f"  d3 level 1 {name}: " + " ".join(f"{k}={v!r}" for k, v in r.items()))
    return rows


def check_nd() -> dict:
    """Phase 14: ``ND_FULL`` (checks, gradient, d3's level-1 launches, and
    the times in a process of its own, ``--nd-times``) and then
    ``ND_SMALL``; returns the full-width rows."""
    nd = {}
    for i, (name, kind, shape, wavelet, mode, level) in enumerate(ND_FULL):
        log(f"  {name}: {ND_FUNCS[kind][0]} -> {ND_FUNCS[kind][1]} on {list(shape)}, {wavelet}, {mode}, level {level}")
        x = randn(shape, torch.float32, SEED + 700 + i)
        res = nd_run(name, kind, x, wavelet, mode, level)
        res.update(nd_gradient(name, kind, x, wavelet, mode, level))
        if kind == "3d":
            res["level1"] = d3_launch_rows(x, wavelet, mode)
            for row_name, row in res["level1"].items():
                log(f"  {name} level 1 {row_name}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
        nd[name] = res
        del x
        torch.cuda.empty_cache()
    # the times in a process of their own, whose profiler windows hold
    # every launch (late in this one they lose some)
    for name, times in times_process("--nd-times").items():
        for row_name, extra in times.pop("level1", {}).items():
            nd[name]["level1"][row_name].update(extra)
        nd[name]["times"] = times
        log(f"  {name}: " + " ".join(f"{k}={v!r}" for k, v in times.items()))
    for i, (name, kind, shape, wavelet, mode, level, dtype, axes) in enumerate(ND_SMALL):
        nd_run(name, kind, randn(shape, dtype, SEED + 720 + i), wavelet, mode, level, axes)
    return nd

# ---------------------------------------------------------------------------
# phase 15: the stationary and boundary-wavelet matrix transforms
# ---------------------------------------------------------------------------

#: bench.py's mat1d, mat2d and swt rows at full width (float32): (name,
#: shape, wavelet, level)
MAT_FULL = (
    ("mat1d", (32, 1_000_000), "db5", 10),
    ("mat2d", (16, 256, 256), "db4", 4),
    ("swt", (32, 2**17), "db2", 4),
)
#: the launches of mat1d's analysis and synthesis: the first four levels
#: (10**6 -> 62 500) in one K8a launch of its sameshift instance, the long
#: levels 62 500, 31 250, 15 626, 7 814 and 3 908 on K3 (``valid``), the
#: last (1 954) a dense product; back the mirror, K4 and one K8b launch
MAT1D_LAUNCHES = ({"K8a": 1, "K3": 5}, {"K4": 5, "K8b": 1})
#: one backward through mat1d's round trip: each fused run's backward is
#: the VJP of its per-level chain, whose levels past 2**16 samples run on
#: K7 (the chain K7a x4, its VJP K7b x4, and the synthesis run's
#: mirror), the per-level K3/K4 launches each their twin
MAT1D_BACKWARD = {"K3": 5, "K4": 5, "K7a": 8, "K7b": 8}
#: the smaller runs: (name, kind, shape, wavelet, level, dtype, keywords,
#: the long-axis cutoff or None)
MAT_SMALL = (
    ("mat1d float64", "1d", (4, 1_000_000), "db5", 10, torch.float64, {}, None),
    ("mat1d gramschmidt", "1d", (4, 2**17), "sym6", 8, torch.float32, {"orthogonalization": "gramschmidt"}, None),
    ("mat1d odd length", "1d", (4, 100_001), "db5", 5, torch.float32, {}, None),
    ("mat2d kron", "2d", (4, 64, 80), "db3", 3, torch.float32, {"separable": False}, None),
    ("mat2d reference", "2d", (2, 32, 30), "db2", 2, torch.float64,
     {"separable": False, "nonseparable": "reference"}, None),
    ("mat2d long H short W", "2d", (4, 3000, 40), "db3", 2, torch.float32, {}, 1024),
    ("mat3d", "3d", (4, 34, 40, 46), "db3", 2, torch.float32, {}, None),
    ("mat3d float64 odd", "3d", (2, 17, 20, 23), "sym4", 2, torch.float64, {}, None),
    ("swt default level", "swt", (4, 2**10), "db3", None, torch.float32, {}, None),
    ("swt float64 odd", "swt", (3, 999), "sym4", 1, torch.float64, {}, None),
)
MAT_KIND = {"1d": ("MatrixWavedec", "MatrixWaverec"), "2d": ("MatrixWavedec2", "MatrixWaverec2"),
            "3d": ("MatrixWavedec3", "MatrixWaverec3")}
MAT_ROUND_TRIP_TOL = {torch.float32: ROUND_TRIP_TOL, torch.float64: 1e-8}


def mat_leaves(coeffs) -> list:
    out = []
    for c in coeffs:
        out += [c[k] for k in sorted(c)] if isinstance(c, dict) else list(c) if isinstance(c, tuple) else [c]
    return out


def mat_transform(kind: str, wavelet: str, level, kwargs: dict):
    """The forward and the inverse as a user calls them."""
    if kind == "swt":
        return (lambda x: ptwt.swt(x, wavelet, level)), (lambda c: ptwt.iswt(c, wavelet))
    dec_name, rec_name = MAT_KIND[kind]
    rec_kwargs = {k: v for k, v in kwargs.items() if k != "odd_coeff_padding_mode"}
    dec = getattr(ptwt, dec_name)(wavelet, level, **kwargs)
    rec = getattr(ptwt, rec_name)(wavelet, **rec_kwargs)
    return dec, rec


def mat_run(name: str, kind: str, x: torch.Tensor, wavelet: str, level, kwargs: dict, want=None) -> dict:
    """Phase 15's check of one configuration: the forward and the inverse
    with the counts set to 0 just before each and read just after, against
    the same transform through the plain kernel versions on the card (bands
    relative to ``max(1, |band|)``: 2e-5 float32, 1e-10 float64), and the
    round trip against the input (1e-4 float32)."""
    fwd, inv = mat_transform(kind, wavelet, level, kwargs)
    _kernels.reset_launch_counts()
    coeffs = fwd(x)
    torch.cuda.synchronize()
    fwd_counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    _kernels.reset_launch_counts()
    rec = inv(coeffs)
    torch.cuda.synchronize()
    inv_counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    log(f"  {name}: launches forward {fwd_counts}, inverse {inv_counts}")
    if want is not None and (fwd_counts, inv_counts) != want:
        raise AssertionError(f"{name}: launches {fwd_counts} / {inv_counts}, expected {want[0]} / {want[1]}")
    with plain_versions():
        pfwd, pinv = mat_transform(kind, wavelet, level, kwargs)
        ref = pfwd(x)
        ref_rec = pinv(ref)
    tol = TOL[x.dtype]
    out = {"forward": fwd_counts, "inverse": inv_counts}
    out["coeff_rel_err"] = check(f"{name} bands vs plain path (relative)", rel_err(mat_leaves(coeffs), mat_leaves(ref)), tol)
    out["rec_rel_err"] = check(f"{name} reconstruction vs plain path (relative)", rel_err(rec, ref_rec), tol)
    crop = rec[(Ellipsis, *(slice(0, n) for n in x.shape[1:]))] if kind != "swt" else rec
    out["round_trip_err"] = check(f"{name} round trip vs input", max_abs(crop, x), MAT_ROUND_TRIP_TOL[x.dtype])
    return out


def sameshift_cases(dtype) -> list:
    """K8a's and K8b's sameshift instances at mat1d's shapes: the signal
    (batch 32 float32, 4 float64) and the bands of its fused run."""
    from ptwt_tpu_torch.ops._boundary_long import _conv_offset

    rows = 32 if dtype == torch.float32 else 4
    shape, wavelet, _ = MAT_FULL[0][1], MAT_FULL[0][2], MAT_FULL[0][3]
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=dtype)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=dtype)
    a = _conv_offset(len(dl))
    n = shape[1]
    x = randn((rows, n), dtype, SEED + 800)
    bands = [randn((rows, n >> 4), dtype, SEED + 801)] + [randn((rows, n >> lvl), dtype, SEED + 802 + lvl)
                                                          for lvl in (4, 3, 2, 1)]
    lens = [n >> lvl for lvl in range(4)]
    return [
        ("K8a", lambda: _pallas1d_multi.sameshift_analysis(x, dl, dh, a, 4),
         lambda: _pallas1d_multi.sameshift_analysis_plain(x, dl, dh, a, 4), [x]),
        ("K8b", lambda: _pallas1d_multi.flat_waverec_lane_multi(bands, rl, rh, (a,) * 4, lens),
         lambda: _pallas1d_multi.multi_synthesis_plain(bands, rl, rh, (a,) * 4, lens), bands),
    ]


def ss_leaves(out) -> list:
    """``(lo_D, [hi_1, ..., hi_D])`` as one list."""
    return [out[0], *out[1]]


def check_sameshift(errors: dict) -> None:
    """The sameshift K8a and K8b launches alone against their plain versions
    (every band position: the kernels compute the zero-extended chain
    everywhere), float32 and float64, one launch each."""
    for dtype in (torch.float32, torch.float64):
        for name, kernel, plain, _ in sameshift_cases(dtype):
            _kernels.reset_launch_counts()
            got = kernel()
            torch.cuda.synchronize()
            if dict(_kernels.LAUNCHES)[name] != 1 or sum(_kernels.LAUNCHES.values()) != 1:
                raise AssertionError(f"sameshift {name}: launches {dict(_kernels.LAUNCHES)}")
            want = plain()
            got, want = (ss_leaves(got), ss_leaves(want)) if name == "K8a" else (got, want)
            err = check(f"sameshift {name} {dtype} vs plain (relative)", rel_err(got, want), TOL[dtype])
            slot = errors.setdefault(name, {})
            slot[dtype] = {"abs": max_abs(got, want), "rel": err}
            del got, want
    torch.cuda.empty_cache()


def mat1d_gradient(x: torch.Tensor) -> dict:
    """One backward through mat1d's round trip, cotangents on every band
    and on the reconstruction, against autograd through the plain path on
    the card (1e-4 of the largest entry), and its launches."""
    _, wavelet, level = MAT_FULL[0][1:]

    def grad_of(xd):
        xd = leaf(xd)
        fwd, inv = mat_transform("1d", wavelet, level, {})
        coeffs = fwd(xd)
        outs = [*coeffs, inv(coeffs)]
        cts = [randn(o.shape, o.dtype, SEED + 820 + i) for i, o in enumerate(outs)]
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(outs, xd, cts)
        torch.cuda.synchronize()
        return grad, {k: v for k, v in _kernels.LAUNCHES.items() if v}

    grad, back = grad_of(x)
    log(f"  mat1d backward launches {back}")
    if back != MAT1D_BACKWARD:
        raise AssertionError(f"mat1d backward: launches {back}, expected {MAT1D_BACKWARD}")
    with plain_versions():
        want, _ = grad_of(x)
    scale = float(want.abs().max())
    err = check(f"mat1d gradient vs plain path (over its largest entry {scale!r})", max_abs(grad, want) / scale,
                TRAIN_GRAD_TOL)
    return {"backward": back, "grad_rel_err": err}


def check_tf32_ignored() -> float:
    """mat2d's forward in float32 with the global matmul precision at
    ``"high"`` (TF32) against its float64 forward: within 1e-5 relative,
    and the caller's setting is back afterwards."""
    shape, wavelet, level = MAT_FULL[1][1:]
    x = randn(shape, torch.float64, SEED + 830)
    dec = ptwt.MatrixWavedec2(wavelet, level)
    want = mat_leaves(dec(x))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = [c.double() for c in mat_leaves(dec(x.float()))]
        if torch.get_float32_matmul_precision() != "high":
            raise AssertionError("the matrix transforms did not restore the caller's matmul precision")
    finally:
        torch.set_float32_matmul_precision(prev)
    return check("mat2d float32 under TF32-allowing global precision vs float64 (relative)", rel_err(got, want), 1e-5)


def mat_busy_ms(run, label: str) -> float:
    """Device busy ms of one call of ``run`` from ``torch.profiler``."""
    return sum(ms for ms, _, _ in profile(run, label, top=6))


def mat_times() -> dict:
    """``--mat-times``: each full-width row's forward, round trip (and
    mat1d's backward): CUDA-event device ms and wall ms (3 warm-ups, median
    of 20) and the device-busy share from ``torch.profiler``; then the
    sameshift K8a and K8b launches, their plain versions and their bound
    (float32)."""
    out = {}
    for i, (name, shape, wavelet, level) in enumerate(MAT_FULL):
        kind = {"mat1d": "1d", "mat2d": "2d", "swt": "swt"}[name]
        x = randn(shape, torch.float32, SEED + 840 + i)
        fwd, inv = mat_transform(kind, wavelet, level, {})
        runs = {"forward": lambda: fwd(x), "round_trip": lambda: inv(fwd(x))}
        if name == "mat1d":
            xd = leaf(x)
            coeffs = fwd(xd)
            outs = [*coeffs, inv(coeffs)]
            cts = [randn(o.shape, o.dtype, SEED + 850 + j) for j, o in enumerate(outs)]
            runs["backward"] = lambda: torch.autograd.grad(outs, xd, cts, retain_graph=True)
        for what, run in runs.items():
            row = {"ms": time_ms(run), "wall_ms": wall_ms(run)}
            row["busy_ms"] = mat_busy_ms(run, f"{name} {what}")
            row["busy_share"] = row["busy_ms"] / row["wall_ms"]
            out[f"{name} {what}"] = row
            log(f"  {name} {what}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
        del x, runs
        if name == "mat1d":
            del xd, coeffs, outs, cts
        torch.cuda.empty_cache()
    L = len(get_filter_arrays(MAT_FULL[0][2], flip=True)[0])
    for name, kernel, plain, ins in sameshift_cases(torch.float32):
        outs = ss_leaves(kernel()) if name == "K8a" else [kernel()]
        nbytes = 4 * (sum(t.numel() for t in ins) + sum(t.numel() for t in outs))
        # one multiply-add (2 operations) per tap for each lo and hi position
        # of every level (K8a), or per tap pair for each output of every
        # step (K8b): 4 L operations per hi position either way
        his = outs[1:] if name == "K8a" else ins[1:]
        ms, by = bound(nbytes, 4.0 * L * sum(t.numel() for t in his))
        out[f"sameshift {name}"] = {"ms": time_ms(kernel), "plain_ms": time_ms(plain), "bound_ms": ms,
                                    "bound_by": by, "bytes": nbytes}
        out[f"sameshift {name}"]["ms_over_bound"] = out[f"sameshift {name}"]["ms"] / ms
        log(f"  sameshift {name}: " + " ".join(f"{k}={v!r}" for k, v in out[f"sameshift {name}"].items()))
    return out


def check_mat(errors: dict) -> dict:
    """Phase 15: ``MAT_FULL`` (checks with the launch counts, mat1d's
    gradient, the TF32 check, the sameshift launches alone, and the times
    in a process of their own, ``--mat-times``), then ``MAT_SMALL``;
    returns the full-width rows."""
    mat = {}
    want = {"mat1d": MAT1D_LAUNCHES, "mat2d": ({}, {}), "swt": ({}, {})}
    for i, (name, shape, wavelet, level) in enumerate(MAT_FULL):
        kind = {"mat1d": "1d", "mat2d": "2d", "swt": "swt"}[name]
        log(f"  {name}: {list(shape)}, {wavelet}, level {level}, float32")
        x = randn(shape, torch.float32, SEED + 840 + i)
        mat[name] = mat_run(name, kind, x, wavelet, level, {}, want[name])
        if name == "mat1d":
            mat[name].update(mat1d_gradient(x))
        del x
        torch.cuda.empty_cache()
    mat["tf32_check_rel_err"] = check_tf32_ignored()
    check_sameshift(errors)
    mat["times"] = times_process("--mat-times")
    for i, (name, kind, shape, wavelet, level, dtype, kwargs, cutoff) in enumerate(MAT_SMALL):
        from ptwt_tpu_torch.ops import long_boundary_cutoff, set_long_boundary_cutoff

        old = long_boundary_cutoff()
        if cutoff is not None:
            set_long_boundary_cutoff(cutoff)
        try:
            mat[name] = mat_run(name, kind, randn(shape, dtype, SEED + 860 + i), wavelet, level, kwargs)
        finally:
            set_long_boundary_cutoff(old)
    # H (3000, then 1500) runs the banded apply along -2, W (40) a product
    if mat["mat2d long H short W"]["forward"] != {"K3": 2} or mat["mat2d long H short W"]["inverse"] != {"K4": 2}:
        raise AssertionError(f"mat2d long H short W: {mat['mat2d long H short W']}")
    torch.cuda.empty_cache()
    return mat


# ---------------------------------------------------------------------------
# phase 16: the wavelet packet trees and the continuous transform
# ---------------------------------------------------------------------------

#: bench.py's wp2d row and the reference's 1d speed-test width at full
#: width, float32: (name, dim, shape, wavelet, mode, maxlevel)
PKT_FULL = (
    ("wp2d", 2, (16, 512, 512), "db3", "reflect", 3),
    ("wp1d", 1, (32, 1_000_000), "db5", "reflect", 3),
)
#: the launches of the full expansion and of ``reconstruct()``: wp2d's 21
#: splits two K3 launches each and its 21 merges two K4 launches each;
#: wp1d's 7 nodes (10**6, 500 004 and 250 006 samples) one K7 launch each
#: way; wp2d's backward each launch's twin
PKT_LAUNCHES = {"wp2d": ({"K3": 42}, {"K4": 42}), "wp1d": ({"K7a": 7}, {"K7b": 7})}
PKT_BACKWARD = {"K3": 42, "K4": 42}
#: the other backends and dtypes: (name, dim, shape, wavelet, mode,
#: maxlevel, dtype, tree keywords, the (forward, reconstruct) launches).
#: The 2d boundary tree's 512-sample axes are under the long-axis cutoff
#: (dense products, no launch); the 1d one's 32 768-sample nodes over it
#: (one K3 or K4 launch a level, `valid`); 1d periodization splits on K6.
PKT_MORE = (
    # K1 splits the even nodes (512, 258), K3 the odd 131s; the merges take
    # no mode (as in ptwt_tpu, only periodization passes one), so waverec2
    # runs the padded synthesis on K4
    ("wp2d periodic", 2, (16, 512, 512), "db3", "periodic", 3, torch.float32, {}, ({"K1": 5, "K3": 32}, {"K4": 42})),
    ("wp2d periodization", 2, (16, 512, 512), "db3", "periodization", 3, torch.float32, {},
     ({"K5a": 21}, {"K5b": 21})),
    ("wp2d separable", 2, (16, 512, 512), "db3", "reflect", 3, torch.float32, {"separable": True},
     ({"K3": 42}, {"K4": 42})),
    ("wp2d boundary", 2, (16, 512, 512), "db3", "boundary", 3, torch.float32, {}, ({}, {})),
    ("wp2d reflect float64", 2, (2, 512, 512), "db3", "reflect", 3, torch.float64, {}, ({"K3": 42}, {"K4": 42})),
    ("wp1d periodization", 1, (4, 2**15), "db5", "periodization", 3, torch.float32, {},
     ({"K6a": 7}, {"K6b": 7})),
    ("wp1d zero", 1, (4, 2**15), "db5", "zero", 3, torch.float32, {}, ({"K3": 7}, {"K4": 7})),
    ("wp1d boundary", 1, (4, 2**15), "db5", "boundary", 3, torch.float32, {}, ({"K3": 7}, {"K4": 7})),
    ("wp1d periodization float64", 1, (4, 2**15), "db5", "periodization", 3, torch.float64, {},
     ({"K6a": 7}, {"K6b": 7})),
    ("wp1d zero float64", 1, (4, 2**15), "db5", "zero", 3, torch.float64, {}, ({"K3": 7}, {"K4": 7})),
    ("wp1d boundary gramschmidt float64", 1, (4, 2**15), "db5", "boundary", 3, torch.float64,
     {"orthogonalization": "gramschmidt"}, ({"K3": 7}, {"K4": 7})),
)
#: bench.py's cwt row: (name, shape, wavelet, scales, sampling period); its
#: 30 scales share one FFT size, 16 384 (the wavelet spans 41-1201 samples)
PKT_CWT = ("cwt", (32, 10**4), "shan0.1-0.4", tuple(range(1, 31)), (4 / 800) * np.pi)
PKT_CWT_MORE = ("mexh", "morl", "gaus3", "cgau2", "cmor1.5-1.0", "fbsp1-1.5-1.0", "db4")
PKT_CWT_SMALL = (4, 2048)
#: spans two or more FFT sizes for every wavelet of PKT_CWT_MORE
PKT_CWT_SCALES = (1.0, 3.0, 10.0, 40.0, 300.0)
#: the cwt row's limits (float32 against float64 on the card, float64
#: against the CPU); the smaller runs take the port's float32 limit, 2e-5.
#: Past the row's largest scale, 30, a float32 limit grows with the scale,
#: as float32's error does (about linearly; each run logs it scale by
#: scale): each coefficient is a difference of neighbours of a cumulative
#: sum over some 16 s samples
CWT_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
CWT_TOL_SCALE = 30.0
CWT_LR = 1e-3


def pkt_cls(dim: int):
    return ptwt.WaveletPacket if dim == 1 else ptwt.WaveletPacket2D


def pkt_tree(dim: int, x, wavelet: str, mode: str, level: int, kwargs: dict):
    return pkt_cls(dim)(x, wavelet, mode=mode, maxlevel=level, **kwargs)


def pkt_scale(tree, order: list) -> None:
    """Scale every leaf by its own gain, 0.5 to 1.5."""
    for i, key in enumerate(order):
        tree[key] = tree[key] * (0.5 + i / len(order))


def pkt_counts() -> dict:
    torch.cuda.synchronize()
    return {k: v for k, v in _kernels.LAUNCHES.items() if v}


def pkt_run(name: str, dim: int, x: torch.Tensor, wavelet: str, mode: str, level: int, kwargs: dict, want) -> dict:
    """Phase 16's check of one tree: the full expansion and
    ``reconstruct()`` with the counts set to 0 just before each and read
    just after, every node against the same tree on the plain path on the
    card (relative to ``max(1, |node|)``: 2e-5 float32, 1e-10 float64),
    the root of the unscaled round trip against the input (1e-4 float32,
    1e-8 float64), then the tree with scaled leaves, reconstructed again,
    node by node against the plain path."""
    order = pkt_cls(dim).get_level(level, "natural")
    axes = (-1,) if dim == 1 else (-2, -1)
    _kernels.reset_launch_counts()
    tree = pkt_tree(dim, x, wavelet, mode, level, kwargs)
    tree.initialize(order)
    fwd = pkt_counts()
    nodes = dict(tree.data)
    _kernels.reset_launch_counts()
    tree.reconstruct()
    inv = pkt_counts()
    log(f"  {name}: {len(nodes)} nodes, launches forward {fwd}, reconstruct {inv}")
    if (fwd, inv) != tuple(want):
        raise AssertionError(f"{name}: launches {fwd} / {inv}, expected {want[0]} / {want[1]}")
    with plain_versions():
        ref = pkt_tree(dim, x, wavelet, mode, level, kwargs)
        ref.initialize(order)
        ref_nodes = dict(ref.data)
        ref.reconstruct()
    tol = TOL[x.dtype]
    keys = sorted(nodes)
    out = {"nodes": len(keys), "forward": fwd, "inverse": inv}
    out["node_rel_err"] = check(f"{name} nodes vs plain path (relative)",
                                rel_err([nodes[k] for k in keys], [ref_nodes[k] for k in keys]), tol)
    root = tree[""][tuple([Ellipsis] + [slice(0, n) for n in x.shape[len(x.shape) - len(axes):]])]
    out["round_trip_err"] = check(f"{name} round trip vs input", max_abs(root, x), MAT_ROUND_TRIP_TOL[x.dtype])
    pkt_scale(tree, order)
    tree.reconstruct()
    with plain_versions():
        pkt_scale(ref, order)
        ref.reconstruct()
    out["scaled_rel_err"] = check(f"{name} scaled reconstruction vs plain path, every node (relative)",
                                  rel_err([tree.data[k] for k in keys], [ref.data[k] for k in keys]), tol)
    return out


def pkt_gradient(x: torch.Tensor) -> dict:
    """One backward through wp2d's scaled round trip against autograd
    through the plain path on the card (1e-4 of the largest entry): the
    backward launches each launch's twin, K3 <-> K4, and no other kernel."""
    _, dim, _, wavelet, mode, level = PKT_FULL[0]
    order = pkt_cls(dim).get_level(level, "natural")

    def grad_of(xd):
        xd = leaf(xd)
        tree = pkt_tree(dim, xd, wavelet, mode, level, {})
        tree.initialize(order)
        pkt_scale(tree, order)
        tree.reconstruct()
        ct = randn(tree[""].shape, x.dtype, SEED + 910)
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(tree[""], xd, ct)
        return grad, pkt_counts()

    grad, back = grad_of(x)
    log(f"  wp2d backward launches {back}")
    if back != PKT_BACKWARD:
        raise AssertionError(f"wp2d backward: launches {back}, expected {PKT_BACKWARD}")
    with plain_versions():
        want, _ = grad_of(x)
    scale = float(want.abs().max())
    err = check(f"wp2d gradient vs plain path (over its largest entry {scale!r})", max_abs(grad, want) / scale,
                TRAIN_GRAD_TOL)
    return {"backward": back, "grad_rel_err": err}


@contextlib.contextmanager
def fft_calls():
    """Count the calls of ``torch.fft.fft`` and ``torch.fft.ifft``."""
    calls = {"fft": 0, "ifft": 0}
    saved = {name: getattr(torch.fft, name) for name in calls}

    def counted(name):
        def run(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)

        return run

    for name in calls:
        setattr(torch.fft, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(torch.fft, name, fn)


def cwt_run(name: str, x: torch.Tensor, wavelet: str, scales, period: float, tol: dict, groups=None) -> dict:
    """Phase 16's check of one ``cwt`` call on the card: no kernel launch
    (cuFFT through ``torch.fft``), the FFT calls of its size groups (one
    data FFT, one stacked wavelet FFT and one inverse FFT each), float32
    against the same call in float64 on the card and float64 against the
    CPU (relative to ``max(1, |coef|)``, within ``tol``; float32 scale by
    scale, its limit times ``max(1, scale / 30)``), the frequencies equal
    to the CPU's."""
    _kernels.reset_launch_counts()
    with fft_calls() as calls:
        coef, freqs = ptwt.cwt(x, scales, wavelet, sampling_period=period)
        launched = pkt_counts()
    n_groups = calls["ifft"]
    log(f"  {name}: {list(coef.shape)} {coef.dtype}, FFT calls {calls}, launches {launched}")
    if launched or calls["fft"] != 2 * n_groups or (groups is not None and n_groups != groups):
        raise AssertionError(f"{name}: launches {launched}, FFT calls {calls}, expected {groups} size groups")
    if not torch.isfinite(torch.view_as_real(coef) if coef.is_complex() else coef).all():
        raise AssertionError(f"{name}: non-finite coefficients")
    out = {"fft_calls": dict(calls), "size_groups": n_groups}
    if x.dtype == torch.float32:
        ref, _ = ptwt.cwt(x.double(), scales, wavelet, sampling_period=period)
        raw = [rel_err(c.to(r.dtype), r) for c, r in zip(coef, ref)]
        log(f"  {name} float32 vs float64 by scale: " + ", ".join(f"{s!r}: {e!r}" for s, e in zip(scales, raw)))
        out["rel_err_by_scale"] = raw
        errs = [e / max(1.0, s / CWT_TOL_SCALE) for e, s in zip(raw, scales)]
        out["rel_err_vs_float64"] = check(f"{name} float32 vs float64 on the card (relative, per scale over "
                                          f"max(1, scale / {CWT_TOL_SCALE}))", max(errs), tol[x.dtype])
    else:
        ref, _ = ptwt.cwt(x.cpu(), scales, wavelet, sampling_period=period)
        out["rel_err_vs_cpu"] = check(f"{name} vs the CPU (relative)", rel_err(coef.cpu(), ref), tol[x.dtype])
    _, cpu_freqs = ptwt.cwt(x[..., :64].cpu(), scales, wavelet, sampling_period=period)
    if not np.array_equal(freqs, cpu_freqs):
        raise AssertionError(f"{name}: frequencies differ from the CPU's")
    return out


def cwt_target(x: torch.Tensor) -> torch.Tensor:
    """The power of a fixed Shannon wavelet's transform of ``x``."""
    _, _, _, scales, period = PKT_CWT
    with torch.no_grad():
        fixed = ptwt.ShannonWavelet.from_frequencies(0.12, 0.35).to(x.device)
        return ptwt.cwt(x, scales, fixed, sampling_period=period)[0].abs() ** 2


def cwt_loss(x: torch.Tensor, wav, target: torch.Tensor) -> torch.Tensor:
    """``mean((|cwt|^2 - target)^2) / mean(target^2)`` at the cwt row."""
    _, _, _, scales, period = PKT_CWT
    coef, _ = ptwt.cwt(x, scales, wav, sampling_period=period)
    return ((coef.abs() ** 2 - target) ** 2).mean() / (target**2).mean()


def cwt_steps(x: torch.Tensor, device) -> tuple[list, list]:
    """Three SGD steps on a ``ShannonWavelet``'s two parameters (on
    ``device``) against :func:`cwt_target`."""
    target = cwt_target(x)
    wav = ptwt.ShannonWavelet.from_frequencies(0.1, 0.4).to(device)
    opt = torch.optim.SGD(wav.parameters(), lr=CWT_LR)
    losses, grads = [], []
    for _ in range(TRAIN_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = cwt_loss(x, wav, target)
        loss.backward()
        grads.append(torch.stack([wav.bandwidth_par.grad, wav.center_par.grad]).cpu())
        opt.step()
        losses.append(loss.item())
    return losses, grads


def cwt_learnable(x: torch.Tensor) -> dict:
    """The learnable step at the cwt row's full width, parameters and data
    on the card, against the same steps on the CPU: losses within 1e-5
    relative, gradients within 1e-4 of the largest."""
    losses, grads = cwt_steps(x, DEVICE)
    want_losses, want_grads = cwt_steps(x.cpu(), "cpu")
    log(f"  learnable cwt losses {losses} (CPU {want_losses})")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    check("learnable cwt losses vs CPU (relative)", loss_err, TRAIN_LOSS_RTOL)
    scale = float(max(g.abs().max() for g in want_grads))
    grad_err = max(float((g - w).abs().max()) for g, w in zip(grads, want_grads)) / scale
    check(f"learnable cwt gradients vs CPU (over the largest {scale!r})", grad_err, TRAIN_GRAD_TOL)
    return {"losses": losses, "loss_rel_err": loss_err, "grad_rel_err": grad_err}


def pkt_bytes(tree) -> int:
    """Bytes one full expansion must move: each parent read once, each
    child written once (``reconstruct()`` the same, reversed)."""
    item = tree[""].element_size()
    return item * sum(t.numel() * (2 if k and len(k) < tree.maxlevel else 1) for k, t in tree.data.items())


def pkt_row(label: str, run, nbytes=None) -> dict:
    row = {"ms": time_ms(run), "wall_ms": wall_ms(run)}
    rows = profile(run, label, top=6)
    row["busy_ms"] = sum(ms for ms, _, _ in rows)
    row["busy_share"] = row["busy_ms"] / row["wall_ms"]
    row["top"] = [[key[:80], ms, count] for ms, count, key in rows[:5]]
    if nbytes is not None:
        row["bytes"] = nbytes
        row["bound_ms"], row["bound_by"] = bound(nbytes, 0.0)
    log(f"  {label}: " + " ".join(f"{k}={v!r}" for k, v in row.items() if k != "top"))
    return row


def pkt_times() -> dict:
    """``--pkt-times``: wp2d's and wp1d's full expansion and round trip (and
    wp2d's backward), the cwt row and the learnable cwt step: CUDA-event
    ms and wall ms (3 warm-ups, median of 20), the device-busy ms and share
    from ``torch.profiler`` and its top device operations; bound: the bytes
    each input read once and each output written once over the HBM rate
    (the rows' operations take less).  The events
    span host gaps where the host enqueues a row for longer than
    :func:`time_ms`'s leading sleep lasts (wp2d), or where a pageable
    host-to-device copy waits for the sleep (cwt's per-scale index
    copies): there the busy ms is the device time."""
    out = {}
    for i, (name, dim, shape, wavelet, mode, level) in enumerate(PKT_FULL):
        x = randn(shape, torch.float32, SEED + 900 + i)
        order = pkt_cls(dim).get_level(level, "natural")

        def forward():
            tree = pkt_tree(dim, x, wavelet, mode, level, {})
            tree.initialize(order)
            return tree

        nbytes = pkt_bytes(forward())
        out[f"{name} forward"] = pkt_row(f"{name} forward", forward, nbytes)
        out[f"{name} round trip"] = pkt_row(f"{name} round trip", lambda: forward().reconstruct(), 2 * nbytes)
        if name == "wp2d":
            xd = leaf(x)
            tree = pkt_tree(dim, xd, wavelet, mode, level, {})
            tree.initialize(order)
            pkt_scale(tree, order)
            tree.reconstruct()
            root, ct = tree[""], randn(tree[""].shape, torch.float32, SEED + 910)
            out["wp2d backward"] = pkt_row("wp2d backward", lambda: torch.autograd.grad(root, xd, ct, retain_graph=True),
                                           2 * nbytes)
            del xd, tree, root, ct
        del x
        torch.cuda.empty_cache()
    name, shape, wavelet, scales, period = PKT_CWT
    x = randn(shape, torch.float32, SEED + 920)
    coef, _ = ptwt.cwt(x, scales, wavelet, sampling_period=period)
    out["cwt forward"] = pkt_row("cwt forward", lambda: ptwt.cwt(x, scales, wavelet, sampling_period=period),
                                 x.numel() * x.element_size() + coef.numel() * coef.element_size())
    target = cwt_target(x)
    wav = ptwt.ShannonWavelet.from_frequencies(0.1, 0.4).to(DEVICE)
    opt = torch.optim.SGD(wav.parameters(), lr=CWT_LR)

    def step():
        opt.zero_grad(set_to_none=True)
        cwt_loss(x, wav, target).backward()
        opt.step()

    out["cwt learnable step"] = pkt_row("cwt learnable step", step)
    return out


def check_pkt() -> dict:
    """Phase 16: ``PKT_FULL`` (checks with the launch counts, wp2d's
    gradient), ``PKT_MORE``, the cwt row and ``PKT_CWT_MORE``, the
    learnable step, and the times in a process of their own
    (``--pkt-times``); returns the full-width rows."""
    pkt = {}
    for i, (name, dim, shape, wavelet, mode, level) in enumerate(PKT_FULL):
        log(f"  {name}: {list(shape)}, {wavelet}, {mode}, maxlevel {level}, float32, full expansion")
        x = randn(shape, torch.float32, SEED + 900 + i)
        pkt[name] = pkt_run(name, dim, x, wavelet, mode, level, {}, PKT_LAUNCHES[name])
        if name == "wp2d":
            pkt[name].update(pkt_gradient(x))
        del x
        torch.cuda.empty_cache()
    for i, (name, dim, shape, wavelet, mode, level, dtype, kwargs, want) in enumerate(PKT_MORE):
        log(f"  {name}: {list(shape)}, {wavelet}, {mode} {kwargs or ''}, maxlevel {level}, {dtype}")
        pkt[name] = pkt_run(name, dim, randn(shape, dtype, SEED + 930 + i), wavelet, mode, level, kwargs, want)
        torch.cuda.empty_cache()
    name, shape, wavelet, scales, period = PKT_CWT
    log(f"  {name}: {list(shape)}, {wavelet}, scales 1-30, float32")
    x = randn(shape, torch.float32, SEED + 920)
    pkt[name] = cwt_run(name, x, wavelet, scales, period, CWT_TOL, groups=1)
    pkt[name]["learnable"] = cwt_learnable(x)
    del x
    torch.cuda.empty_cache()
    for i, wav in enumerate(PKT_CWT_MORE):
        for dtype in (torch.float32, torch.float64):
            row = cwt_run(f"cwt {wav} {dtype}", randn(PKT_CWT_SMALL, dtype, SEED + 940 + i), wav, PKT_CWT_SCALES, 0.1,
                          TOL)
            if row["size_groups"] < 2:
                raise AssertionError(f"cwt {wav}: scales {PKT_CWT_SCALES} took one FFT size")
    pkt["times"] = times_process("--pkt-times")
    return pkt


# ---------------------------------------------------------------------------
# phase 17: learnable filter banks (K3/K4 per axis, the taps' gradient KT)
# ---------------------------------------------------------------------------

#: KT's source; it replaces no Pallas kernel: for a traced bank the JAX
#: package takes its slices route, which XLA differentiates
KT_SOURCE = ("src/ptwt_tpu_torch/csrc/axis.cu",
             "none (XLA's derivative of src/ptwt_tpu/ops/_dispatch.py:135 _dwt_axis_slices)")
#: examples/learnable_wavelet_compression.py's workload: (batch, samples),
#: wavelet, level, mode, Adam steps and rate
LEARN_EXAMPLE = ((16, 256), "db4", 4, "periodic", 20, 1e-3)
#: the headline (bench.py:3) and d1 (bench.py:14) with a learnable bank:
#: (name, kind, shape, wavelet, level, mode), float32, SGD steps
LEARN_FULL = (
    ("2d periodic", "2d", SHAPE, WAVELET, LEVEL, "periodic"),
    ("2d reflect", "2d", SHAPE, WAVELET, LEVEL, "reflect"),
    ("d1 reflect", "1d", D1_SHAPE, WAVELET_1D, LEVEL_1D, "reflect"),
)
LEARN_LR = 1e-3
#: KT against its plain versions: (name, shape, axis, mode, taps, dtype,
#: K4's pair counts): (b)'s level 1 along -2 and -1 (periodic), d1's level
#: 1 (reflect, K3's taps), then every mode on odd and even axes -1/-2/-3
#: with db4, a 7-tap bank and banks of 40 and 128 taps (three and eight
#: tap chunks) in both dtypes (``valid`` only where the bank fits the axis,
#: and K4's taps there only for the short banks, whose crop leaves samples)
KT_MAIN = (
    ("headline level 1, axis -2", SHAPE, -2, "periodic", 8, torch.float32, (1,)),
    ("headline level 1, axis -1", (2, SHAPE[0], 515, SHAPE[2]), -1, "periodic", 8, torch.float32, (2,)),
    ("d1 level 1, axis -1", D1_SHAPE, -1, "reflect", 10, torch.float32, ()),
)
KT_SMALL = tuple(
    (f"{mode} axis {axis} {taps} taps {str(dtype)[6:]}", shape, axis, mode, taps, dtype,
     (1, 2) if mode != "valid" or taps <= 8 else ())
    for mode in (*MODES, "valid")
    for axis, shape in ((-1, (3, 5, 1001)), (-2, (4, 130, 70)), (-3, (33, 4, 64)))
    for taps in (8, 7, 40, 128)
    for dtype in (torch.float32, torch.float64)
    if mode != "valid" or taps <= shape[axis]
)
#: the other entry points with a learnable bank, float64, against the CPU:
#: (name, kind, shape, mode, level)
LEARN_MORE = (
    ("wavedec3", "3d", (2, 20, 22, 24), "reflect", 2),
    ("fswavedec2", "fs2", (2, 60, 70), "zero", 2),
    ("WaveletPacket2D split", "packet", (2, 64, 66), "reflect", 1),
    ("wavedec2 periodization", "2d", (2, 64, 64), "periodization", 2),
)
LEARN_TOL = {torch.float32: TRAIN_GRAD_TOL, torch.float64: 1e-10}


def learn_bank(wavelet: str, dtype, device):
    return SoftOrthogonalWavelet.from_wavelet(wavelet, dtype=dtype).to(device)


def learn_launches(kind: str, level: int, data_grad: bool) -> dict:
    """One step's launches: each level's K3 and K4 launches (one per axis),
    their VJP twins (but the first analysis launch's where the data needs
    no gradient) and one KT per launch."""
    per = {"1d": 1, "2d": 2}[kind] * level
    return {"K3": 2 * per, "K4": 2 * per - (not data_grad), "KT": 2 * per}


def make_batch(rng: np.random.RandomState, batch: int, n: int) -> np.ndarray:
    """``examples/learnable_wavelet_compression.py``'s signals: random cubic
    trends plus a few jumps."""
    t = np.linspace(0.0, 1.0, n)
    coefs = rng.randn(batch, 4)
    smooth = sum(coefs[:, k : k + 1] * t**k for k in range(4))
    jumps = np.zeros((batch, n))
    for b in range(batch):
        for pos in rng.randint(0, n, size=3):
            jumps[b, pos:] += rng.randn()
    return (smooth + jumps).astype(np.float32)


def learn_run(kind: str, x, filt, mode: str, level: int) -> tuple[list, torch.Tensor]:
    """The details and the reconstruction (cropped to ``x``) of one
    transform round trip with the filter bank ``filt``."""
    if kind == "1d":
        coeffs = ptwt.wavedec(x, filt, mode=mode, level=level)
        details, rec = list(coeffs[1:]), ptwt.waverec(coeffs, filt)
    elif kind == "2d":
        coeffs = ptwt.wavedec2(x, filt, mode=mode, level=level)
        details, rec = [d for t in coeffs[1:] for d in t], ptwt.waverec2(coeffs, filt, mode=mode)
    elif kind == "3d":
        coeffs = ptwt.wavedec3(x, filt, mode=mode, level=level)
        details, rec = [coeffs[l][k] for l in range(1, level + 1) for k in sorted(coeffs[l])], \
            ptwt.waverec3(coeffs, filt)
    elif kind == "fs2":
        coeffs = ptwt.fswavedec2(x, filt, mode=mode, level=level)
        details, rec = [coeffs[l][k] for l in range(1, level + 1) for k in sorted(coeffs[l])], \
            ptwt.fswaverec2(coeffs, filt)
    else:  # one packet split, then the merge
        tree = ptwt.WaveletPacket2D(x, filt, mode=mode, maxlevel=level)
        keys = ptwt.WaveletPacket2D.get_level(level, "natural")
        details = [tree[k] for k in keys]
        tree.reconstruct()
        rec = tree[""]
    return details, rec[tuple([Ellipsis] + [slice(0, s) for s in x.shape[1:]])]


def learn_loss(bank, x, kind: str, mode: str, level: int) -> torch.Tensor:
    """The example's loss: ``0.1 sparsity + 100 fidelity + 10 quality``."""
    details, rec = learn_run(kind, x, bank.filter_bank, mode, level)
    sparsity = sum(d.abs().mean() for d in details)
    fidelity = ((rec - x) ** 2).mean()
    return 0.1 * sparsity + 100.0 * fidelity + 10.0 * bank.wavelet_loss()


def learn_step(bank, x, kind: str, mode: str, level: int, out: dict) -> None:
    """One loss and backward: appends the loss, the filter gradients (and
    the data's, where it requires grad) and the launches (the counts set
    to 0 just before the forward, read after the backward) to ``out``."""
    for p in bank.parameters():
        p.grad = None
    _kernels.reset_launch_counts()
    loss = learn_loss(bank, x, kind, mode, level)
    loss.backward()
    out.setdefault("launches", []).append(pkt_counts())
    out.setdefault("losses", []).append(loss.item())
    out.setdefault("grads", []).append(torch.cat([p.grad.reshape(-1) for p in bank.parameters()]).cpu())
    out.setdefault("data_grads", [])
    if x.requires_grad:
        out["data_grads"].append(x.grad.cpu())
        x.grad = None


def learn_steps(bank, xs, kind: str, mode: str, level: int, opt, follow=None) -> tuple[dict, dict]:
    """One optimizer step per input of ``xs`` (:func:`learn_step`).  With
    ``follow`` (a bank on another device), each step is also evaluated
    there at this bank's parameters (copied over first) on the same input:
    the second dict."""
    out, followed = {}, {}
    for x in xs:
        if follow is not None:
            with torch.no_grad():
                for p, q in zip(follow.parameters(), bank.parameters()):
                    p.copy_(q)
            y = x.detach().to(follow.dec_lo.device).requires_grad_(x.requires_grad)
            learn_step(follow, y, kind, mode, level, followed)
        learn_step(bank, x, kind, mode, level, out)
        opt.step()
    return out, followed


def learn_compare(name: str, got: dict, want: dict, dtype, grads: bool = True) -> dict:
    """Losses within 1e-5 relative, gradients within 1e-4 of their largest
    entry (float64: both 1e-10)."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    check(f"{name} losses (relative)", loss_err, TRAIN_LOSS_RTOL if dtype == torch.float32 else 1e-10)
    out = {"losses": got["losses"], "loss_rel_err": loss_err}
    for key in ("grads", "data_grads") if grads else ():
        if not want[key]:
            continue
        scale = max(float(g.abs().max()) for g in want[key])
        err = max(max_abs(g, w) for g, w in zip(got[key], want[key])) / scale
        out[f"{key[:-1]}_rel_err"] = check(f"{name} {key.replace('_', ' ')} (over the largest {scale!r})", err,
                                           LEARN_TOL[dtype])
    return out


def check_learn_example() -> dict:
    """(a) the example's 20 Adam steps on the card, every step's launches
    exact (K3, K4 and KT only), each step also evaluated on the CPU at the
    card's parameters and batch.  Float32, the example's type: losses
    within 1e-5 relative.  Its filter gradients are not comparable between
    two float32 implementations: db4 annihilates the batches' cubic
    trends, so most detail coefficients are rounding noise and the
    sparsity term's ``sign(c)`` with them (the differences are logged).
    Float64, the same steps: losses and gradients within 1e-10.  Then the
    float32 steps run free on the CPU from the same start: Adam scales
    noise-level gradients up to full steps, so the two runs part (logged,
    not held to a limit)."""
    (batch, n), wavelet, level, mode, steps, lr = LEARN_EXAMPLE
    rng = np.random.RandomState(0)
    make_batch(rng, batch, n)  # the example's evaluation batch
    batches = [torch.from_numpy(make_batch(rng, batch, n)) for _ in range(steps)]
    want = learn_launches("1d", level, False)
    out = {"launches_per_step": want}
    for dtype in (torch.float32, torch.float64):
        bank = learn_bank(wavelet, dtype, DEVICE)
        opt = torch.optim.Adam(bank.parameters(), lr=lr)
        card, cpu = learn_steps(bank, [b.to(DEVICE, dtype) for b in batches], "1d", mode, level, opt,
                                follow=learn_bank(wavelet, dtype, "cpu"))
        if any(c != want for c in card["launches"]):
            raise AssertionError(f"example steps: launches {card['launches']}, expected {want} each step")
        tag = str(dtype)[6:]
        log(f"  example {tag}: {steps} Adam steps, losses {card['losses'][0]!r} -> {card['losses'][-1]!r}, "
            f"launches per step {want}")
        row = learn_compare(f"example {tag} card vs CPU at the card's parameters", card, cpu, dtype,
                            grads=dtype == torch.float64)
        if dtype == torch.float32:
            scale = max(float(g.abs().max()) for g in cpu["grads"])
            row["grad_rel_diff_not_held"] = max(max_abs(g, w) for g, w in zip(card["grads"], cpu["grads"])) / scale
            log(f"  example float32 filter gradients, card vs CPU (not held, sign noise): "
                f"{row['grad_rel_diff_not_held']!r} of the largest {scale!r}")
            alone = learn_bank(wavelet, dtype, "cpu")
            free, _ = learn_steps(alone, batches, "1d", mode, level, torch.optim.Adam(alone.parameters(), lr=lr))
            row["free_run_loss_rel_diff_not_held"] = max(
                abs(a - b) / abs(b) for a, b in zip(card["losses"], free["losses"]))
            log(f"  example float32, the CPU's own 20 steps against the card's: losses part by "
                f"{row['free_run_loss_rel_diff_not_held']!r} (not held)")
        out[tag] = row
    return out


def check_learn_full(i: int, name: str, kind: str, shape, wavelet: str, level: int, mode: str) -> dict:
    """(b)/(c): 3 SGD steps with a learnable bank and an input that requires
    grad, on the kernel path against the plain path on the card; the
    launches of every step exact, and two runs of the first step's
    gradients equal bit for bit."""
    x = randn(shape, torch.float32, SEED + 1700 + i)

    def run(steps: int):
        bank = learn_bank(wavelet, torch.float32, DEVICE)
        opt = torch.optim.SGD(bank.parameters(), lr=LEARN_LR)
        return learn_steps(bank, [leaf(x) for _ in range(steps)], kind, mode, level, opt)[0]

    got = run(TRAIN_STEPS)
    want = learn_launches(kind, level, True)
    if any(c != want for c in got["launches"]):
        raise AssertionError(f"{name}: launches {got['launches']}, expected {want} each step")
    log(f"  {name}: launches per step {want}")
    again = run(1)
    if not (torch.equal(again["grads"][0], got["grads"][0]) and torch.equal(again["data_grads"][0],
                                                                          got["data_grads"][0])):
        raise AssertionError(f"{name}: two runs of the same step gave different gradients")
    log(f"  {name}: two runs of the first step's gradients agree bit for bit")
    with plain_versions():
        plain = run(TRAIN_STEPS)
    out = learn_compare(f"{name} kernel vs plain path", got, plain, torch.float32)
    out["launches_per_step"] = want
    del x
    torch.cuda.empty_cache()
    return out


def kt_case(name: str, shape, axis: int, mode: str, taps: int, dtype, groups, seed: int) -> dict:
    """KT through its wrapper against its plain versions (autograd through
    the plain levels, on the card): K3's taps on ``shape`` along ``axis``,
    K4's with one or two (lo, hi) pairs and the standard crop.  Each
    error is over the gradient's largest entry."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dl, dh, rl, rh = (torch.randn(taps, dtype=torch.float64, generator=gen).numpy() for _ in range(4))
    x = randn(shape, dtype, seed)
    ax = axis % x.ndim
    m, period, pad, code = _pallas2._analysis_plan(x.shape[ax], taps, mode)
    band_shape = [m if i == ax else s for i, s in enumerate(shape)]
    ct = randn([2, *band_shape], dtype, seed + 1)
    errs, abs_errs = {}, {}
    _kernels.reset_launch_counts()
    got = _pallas2._tap_grad_kernel(x, ax, [ct[0]], [ct[1]], taps, period, pad, code)
    want = torch.stack(_pallas2.dwt_axis_tap_grad_plain(x, axis, dl, dh, mode, ct)).double()
    abs_errs["K3 taps"] = max_abs(got, want)
    errs["K3 taps"] = abs_errs["K3 taps"] / float(want.abs().max())
    del x, ct
    p = 0 if mode == "periodization" else std_pad(taps)
    circular = mode == "periodization"
    for g in groups:
        los = [randn(band_shape, dtype, seed + 2 + j) for j in range(g)]
        his = [randn(band_shape, dtype, seed + 4 + j) for j in range(g)]
        out_len = 2 * m - 2 * p if circular else 2 * (m - 1) + taps - 2 * p
        cot = randn([g, *[out_len if i == ax else s for i, s in enumerate(shape)]], dtype, seed + 6)
        per, c = (2 * m, _pallas2._WRAP_ZERO) if circular else (out_len, _pallas2._ZERO)
        off = p + taps // 2 - 1 if circular else p
        got = _pallas2._tap_grad_kernel(cot, ax + 1, los, his, taps, per, off, c)
        want = torch.stack(_pallas2.idwt_axis_tap_grad_plain(los, his, axis, rl, rh, p, p, mode, cot)).double()
        key = f"K4 taps, {g} pair{'s' * (g > 1)}"
        abs_errs[key] = max_abs(got, want)
        errs[key] = abs_errs[key] / float(want.abs().max())
    launched = pkt_counts()
    if launched != {"KT": 1 + len(groups)}:
        raise AssertionError(f"KT {name}: launches {launched}, expected {1 + len(groups)} KT")
    if not max(errs.values()) <= LEARN_TOL[dtype]:
        raise AssertionError(f"KT {name}: {errs} exceed {LEARN_TOL[dtype]!r}")
    return {"rel": errs, "abs": abs_errs}


def kt_worst(errors: dict, dtype, kind: str) -> float:
    return max(max(e[kind].values()) for e in errors[dtype].values())


def check_kt(errors: dict) -> None:
    """KT at the main path's shapes and at ``KT_SMALL``, an empty batch (no
    launch, zero gradients) and two launches of one gradient (equal bit
    for bit); K3 against its plain version on the d1 level-1 axis of 10^6
    samples."""
    for i, (name, shape, axis, mode, taps, dtype, groups) in enumerate(KT_MAIN + KT_SMALL):
        errs = kt_case(name, shape, axis, mode, taps, dtype, groups, SEED + 1800 + i)
        errors.setdefault(dtype, {})[name] = errs
        if i < len(KT_MAIN):
            log(f"  KT {name}, {mode}, {list(shape)}, over the largest entry: "
                + ", ".join(f"{k} {v!r}" for k, v in errs["rel"].items()))
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.float64):
        log(f"  KT every mode, axis and bank, {dtype}: worst {kt_worst(errors, dtype, 'rel')!r} of the largest "
            f"entry (limit {LEARN_TOL[dtype]!r}), {kt_worst(errors, dtype, 'abs')!r} absolute")
    x = randn((0, 64), torch.float32, SEED + 1890)
    m, period, pad, code = _pallas2._analysis_plan(64, 8, "reflect")
    _kernels.reset_launch_counts()
    empty = _pallas2._tap_grad_kernel(x, 1, [x.new_zeros(0, m)], [x.new_zeros(0, m)], 8, period, pad, code)
    if pkt_counts() or empty.abs().max() != 0:
        raise AssertionError("KT on an empty batch launched or gave a nonzero gradient")
    log("  KT on an empty batch: no launch, zero gradient")
    x = randn(SHAPE, torch.float32, SEED + 1891)
    m, period, pad, code = _pallas2._analysis_plan(SHAPE[1], 8, "periodic")
    ct = randn((2, SHAPE[0], m, SHAPE[2]), torch.float32, SEED + 1892)
    first = _pallas2._tap_grad_kernel(x, 1, [ct[0]], [ct[1]], 8, period, pad, code)
    if not torch.equal(first, _pallas2._tap_grad_kernel(x, 1, [ct[0]], [ct[1]], 8, period, pad, code)):
        raise AssertionError("two KT launches of one gradient differ")
    log("  KT: two launches of one gradient agree bit for bit")
    del x, ct
    x = randn(D1_SHAPE, torch.float32, SEED + 1893)
    dl, dh, _, _ = banks_1d(torch.float32)
    got = _pallas2.pallas_dwt_axis(x, -1, dl, dh, REFLECT_1)
    want = torch.stack(_pallas2.dwt_axis_plain(x, -1, dl, dh, REFLECT_1))
    errors["K3 d1"] = check(f"K3 on {list(D1_SHAPE)} (the d1 level-1 axis), {REFLECT_1}, vs plain",
                            max_abs(got, want), TOL[torch.float32])
    del x, got, want
    torch.cuda.empty_cache()


def check_learn_more() -> dict:
    """``LEARN_MORE``: the learnable bank (float64) through the other
    entry points on the card against the CPU, filter and data gradients
    within 1e-10 of their largest entry, K3/K4/KT only."""
    out = {}
    for i, (name, kind, shape, mode, level) in enumerate(LEARN_MORE):
        x = randn(shape, torch.float64, SEED + 1900 + i)
        bank = learn_bank(WAVELET, torch.float64, DEVICE)
        card, cpu = learn_steps(bank, [leaf(x)], kind, mode, level, torch.optim.SGD(bank.parameters(), lr=LEARN_LR),
                                follow=learn_bank(WAVELET, torch.float64, "cpu"))
        launched = card["launches"][0]
        if set(launched) != {"K3", "K4", "KT"}:
            raise AssertionError(f"{name}: launches {launched}, expected K3, K4 and KT only")
        log(f"  {name} {list(shape)} {mode}: launches {launched}")
        out[name] = learn_compare(f"{name} card vs CPU", card, cpu, torch.float64)
        out[name]["launches"] = launched
    return out


def kt_library(x: torch.Tensor, ct: torch.Tensor, axis: int, taps: int, mode: str):
    """``torch.nn.grad.conv{2,1}d_weight`` computing KT's K3 gradient on an
    input padded beforehand (the yardstick; the port never calls it), and
    its arguments."""
    padded = fwt_pad(x, taps, mode=mode, axes=(axis,))
    if axis == -2:
        inp = padded.unsqueeze(1)
        grad_out = ct.transpose(0, 1).contiguous()
        return lambda: torch.nn.grad.conv2d_weight(inp, (2, 1, taps, 1), grad_out, stride=(2, 1))
    inp = padded.reshape(-1, 1, padded.shape[-1])
    grad_out = ct.reshape(2, -1, ct.shape[-1]).transpose(0, 1).contiguous()
    return lambda: torch.nn.grad.conv1d_weight(inp, (2, 1, taps), grad_out, stride=2)


def kt_inputs(shape, axis: int, mode: str, taps: int, dtype):
    """K3's taps' gradient at a ``KT_MAIN`` row: the input, the packed
    cotangent and a call of KT through its wrapper."""
    x = randn(shape, dtype, SEED + 1950)
    ax = axis % x.ndim
    m, period, pad, code = _pallas2._analysis_plan(x.shape[ax], taps, mode)
    ct = randn([2, *[m if i == ax else s for i, s in enumerate(shape)]], dtype, SEED + 1951)
    return x, ct, lambda: _pallas2._tap_grad_kernel(x, ax, [ct[0]], [ct[1]], taps, period, pad, code)


def kt_bound(x: torch.Tensor, ct: torch.Tensor, taps: int) -> dict:
    """KT's least time, the larger of x and the bands read once over the
    memory rate and ``taps`` float64 multiply-adds per band element over
    the float64 peak (KT sums in float64), with both times and the
    bytes."""
    nbytes = (x.numel() + ct.numel()) * x.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * taps * ct.numel() / PEAK_F64_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "f64_ops_bound_ms": t_ops, "bytes": nbytes}


def kt_times() -> dict:
    """``--kt-times``: KT's median device ms at every ``KT_MAIN`` row
    (CUDA events, 20 after 3 warm-ups), through the wrapper only, so that
    another tree's package (``--src``) runs it too: the rows ``--kt-turns``
    compares in turns."""
    out = {}
    for name, shape, axis, mode, taps, dtype, _ in KT_MAIN:
        x, ct, call = kt_inputs(shape, axis, mode, taps, dtype)
        out[f"KT {name}"] = time_ms(call)
        del x, ct, call
        torch.cuda.empty_cache()
    return out


def sass_loops(fn: str) -> list:
    """The innermost loops of one function's SASS (``cuobjdump -sass``)
    that hold a ``DFMA``: for each, its counts of ``DFMA``,
    ``F2F.F64.F32``, ``LDS`` and all instructions.  A loop is the range
    from a backward branch's target to the branch."""
    labels = {m.group(1): int(m.group(2), 16)
              for m in re.finditer(r"(\.L_x_\d+):\s*\n\s*/\*([0-9a-f]+)\*/", fn)}
    ops = [(int(a, 16), op, rest) for a, op, rest in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", fn)]
    loops = []
    for addr, op, rest in ops:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)|\((\.L_x_\d+)\)", rest)
        target = int(m.group(1), 16) if m and m.group(1) else labels.get(m.group(2)) if m else None
        if target is not None and target <= addr:
            loops.append((target, addr))
    counts = []
    for lo, hi in loops:
        body = [op for a, op, _ in ops if lo <= a <= hi]
        if not any(op.startswith("DFMA") for op in body):
            continue
        inner = [l2 for l2 in loops if (l2 != (lo, hi) and lo <= l2[0] and l2[1] <= hi
                 and any(op.startswith("DFMA") for a, op, _ in ops if l2[0] <= a <= l2[1]))]
        if inner:
            continue
        counts.append({"DFMA": sum(o.startswith("DFMA") for o in body),
                       "F2F.F64.F32": sum(o.startswith("F2F.F64.F32") for o in body),
                       "LDS": sum(o.startswith("LDS") for o in body), "all": len(body)})
    return counts


def kt_sass() -> dict:
    """``--kt-sass``: for each KT instance of the built ``axis`` library
    (``--src`` picks the tree), ptxas' registers and spills (the build's
    ``-Xptxas -v`` log) and its SASS (``cuobjdump -sass``): the counts of
    ``DFMA``, ``F2F.F64.F32``, ``LDS`` and all instructions over the
    kernel and over each innermost loop that holds a ``DFMA`` (the tap
    loop)."""
    _kernels.build(("axis",))
    lib = _kernels._library_path("axis")
    text = lib.with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(r"Compiling entry function '(\w*tap_grad_kernel\w*)'.*?Used (\d+) registers", text, re.S):
        block = m.group(0)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out[m.group(1)] = {"registers": int(m.group(2)),
                           "spill_stores": int(spills.group(1)) if spills else None,
                           "spill_loads": int(spills.group(2)) if spills else None}
    cuobjdump = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split()[0]
        if "tap_grad_kernel" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)
        whole = {"DFMA": sum(o.startswith("DFMA") for o in ops),
                 "F2F.F64.F32": sum(o.startswith("F2F.F64.F32") for o in ops),
                 "LDS": sum(o.startswith("LDS") for o in ops), "all": len(ops)}
        out.setdefault(name, {}).update({"whole": whole, "tap_loops": sass_loops(fn)})
    return out


def kt_turns(parent: Path) -> dict:
    """``--kt-turns DIR``: KT's times (``--kt-times``) of the tree at DIR
    and of this one in turns (parent, this, this, parent), then each
    tree's registers, spills and SASS counts (``--kt-sass``)."""
    out = {"times": turns(parent, "--kt-times"), "sass": {}}
    for tree in (parent, ROOT):
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--kt-sass", "--src", str(tree / "src")],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"--kt-sass of {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        out["sass"]["parent" if tree == parent else "change"] = json.loads(proc.stdout.strip().splitlines()[-1])
    for tree, fns in out["sass"].items():
        for name, row in fns.items():
            log(f"  {tree} {name}: {row}")
    return out


def learn_times() -> dict:
    """``--learn-times``: KT at every ``KT_MAIN`` row ((b)'s level 1 along
    -2 and -1, d1's level 1; CUDA events, median of 20 after 3 warm-ups;
    its plain version; the library yardstick; :func:`kt_bound`), then one
    SGD step of every ``LEARN_FULL`` row and the example's Adam step:
    device ms (events), wall ms and the profiler's busy share."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, shape, axis, mode, taps, dtype, _ in KT_MAIN:
        dl, dh, _, _ = banks_1d(dtype) if shape == D1_SHAPE else banks_2d(dtype)
        x, ct, call = kt_inputs(shape, axis, mode, taps, dtype)
        row = {"ms": time_ms(call),
               "plain_ms": time_ms(lambda: _pallas2.dwt_axis_tap_grad_plain(x, axis, dl, dh, mode, ct)),
               "library_ms": time_ms(kt_library(x, ct, axis, taps, mode)),
               "library_note": "torch.nn.grad.conv2d_weight / conv1d_weight, input padded beforehand"}
        row.update(kt_bound(x, ct, taps))
        log(f"  KT {name}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
        out[f"KT {name}"] = row
        del x, ct, call
        torch.cuda.empty_cache()
    for i, (name, kind, shape, wavelet, level, mode) in enumerate(LEARN_FULL):
        x = leaf(randn(shape, torch.float32, SEED + 1700 + i))
        bank = learn_bank(wavelet, torch.float32, DEVICE)
        opt = torch.optim.SGD(bank.parameters(), lr=LEARN_LR)

        def step():
            opt.zero_grad(set_to_none=True)
            x.grad = None
            learn_loss(bank, x, kind, mode, level).backward()
            opt.step()

        out[f"{name} step"] = pkt_row(f"{name} step", step)
        del x, bank, opt
        torch.cuda.empty_cache()
    (batch, n), wavelet, level, mode, _, lr = LEARN_EXAMPLE
    x = torch.from_numpy(make_batch(np.random.RandomState(0), batch, n)).to(DEVICE)
    bank = learn_bank(wavelet, torch.float32, DEVICE)
    opt = torch.optim.Adam(bank.parameters(), lr=lr)

    def example_step():
        opt.zero_grad(set_to_none=True)
        learn_loss(bank, x, "1d", mode, level).backward()
        opt.step()

    out["example step"] = pkt_row("example step", example_step)
    return out


def check_learn() -> dict:
    """Phase 17: (a) the example's steps, (b) and (c) the learnable steps at
    full width, KT against its plain versions, the other entry points, and
    the times in a process of their own (``--learn-times``)."""
    learn = {"errors": {}}
    log("  (a) examples/learnable_wavelet_compression.py's step, [16, 256] float32")
    learn["example"] = check_learn_example()
    for i, (name, kind, shape, wavelet, level, mode) in enumerate(LEARN_FULL):
        log(f"  ({'b' if kind == '2d' else 'c'}) {name}: {list(shape)}, {wavelet}, level {level}, float32, "
            f"{TRAIN_STEPS} SGD steps")
        learn[name] = check_learn_full(i, name, kind, shape, wavelet, level, mode)
    check_kt(learn["errors"])
    learn["more"] = check_learn_more()
    learn["times"] = times_process("--learn-times")
    return learn


# ---------------------------------------------------------------------------
# phase 18: the tiled multi-device transforms (ptwt_tpu_torch.parallel)
# ---------------------------------------------------------------------------

#: The tiled rows at full width, float32: (name, kind, shape, wavelet,
#: level, mode, the mesh of four ranks); one rank runs each row on (1, 1)
#: (the grid on (1, 1) with ``n_spatial_w=1``).
TILED_FULL = (
    ("t2d periodization", "2d", SHAPE, WAVELET, LEVEL, "periodization", {"n_data": 1, "n_spatial": 4}),
    ("t2d reflect", "2d", SHAPE, WAVELET, LEVEL, "reflect", {"n_data": 1, "n_spatial": 4}),
    ("t2d grid", "2d", SHAPE, WAVELET, LEVEL, "periodization", {"n_data": 1, "n_spatial": 2, "n_spatial_w": 2}),
    ("td1", "1d", D1_SHAPE, WAVELET_1D, LEVEL_1D, "reflect", {"n_data": 1, "n_spatial": 4}),
    ("td3", "3d", (32, 100, 100, 100), "db5", 3, "reflect", {"n_data": 1, "n_spatial": 4}),
)
#: Launches of each row's forward and inverse: on one rank (every axis
#: local: K3 once per axis and level, K4 as the serial 2d and 3d routes; d1's
#: levels 1-4 and their syntheses on K7a/K7b, their lanes being longer than
#: 2^16 samples), and per rank of four (a ``periodization`` ring axis: the
#: interior and both edge strips, three K3 launches, and three K4 launches,
#: the full synthesis and both neighbours' strips; a padded sharded axis one
#: launch on the window; d1's windows of 250 010 and 125 012 samples on K7a)
TILED_LAUNCHES = {
    "t2d periodization": {1: ({"K3": 8}, {"K4": 8}), 4: ({"K3": 16}, {"K4": 16})},
    "t2d reflect": {1: ({"K3": 8}, {"K4": 8}), 4: ({"K3": 8}, {"K4": 8})},
    "t2d grid": {1: ({"K3": 8}, {"K4": 8}), 4: ({"K3": 24}, {"K4": 24})},
    "td1": {1: ({"K7a": 4, "K3": 6}, {"K7b": 4, "K4": 6}), 4: ({"K7a": 2, "K3": 8}, {"K7b": 2, "K4": 8})},
    "td3": {1: ({"K3": 9}, {"K4": 12}), 4: ({"K3": 9}, {"K4": 12})},
}
#: float64 on one rank at smaller shapes (odd lengths in the padded modes)
TILED_F64 = (
    ("t2d periodization", "2d", (2, 128, 128), "db4", 3, "periodization"),
    ("t2d reflect", "2d", (2, 131, 126), "db4", 3, "reflect"),
    ("td1", "1d", (2, 140_001), "db5", 3, "reflect"),
    ("td3", "3d", (2, 40, 34, 31), "db5", 2, "reflect"),
)
#: The process groups' timeout, and the seconds the four ranks get in all.
TILED_TIMEOUT_S = 120
TILED_RANKS_S = 600
TILED_REPS = 10


def tiled_funcs(kind: str) -> tuple:
    """The tiled forward and inverse of a kind, and the serial pair."""
    from ptwt_tpu_torch import parallel

    suffix = {"1d": "", "2d": "2", "3d": "3"}[kind]
    return (getattr(parallel, f"tiled_wavedec{suffix}"), getattr(parallel, f"tiled_waverec{suffix}"),
            getattr(ptwt, f"wavedec{suffix}"), getattr(ptwt, f"waverec{suffix}"))


def tiled_leaves(coeffs) -> list:
    """The approximation, then each level's band, tuple in order or dict by
    key."""
    out = [coeffs[0]]
    for entry in coeffs[1:]:
        if isinstance(entry, dict):
            out.extend(entry[k] for k in sorted(entry))
        elif isinstance(entry, torch.Tensor):  # a 1d detail band
            out.append(entry)
        else:
            out.extend(entry)
    return out


def tiled_mesh(ranks: int, kw: dict):
    import datetime

    from ptwt_tpu_torch.parallel import make_wavelet_mesh

    sizes = kw if ranks > 1 else {k: 1 for k in kw}
    return make_wavelet_mesh(**sizes, device_type="cuda", timeout=datetime.timedelta(seconds=TILED_TIMEOUT_S))


@contextlib.contextmanager
def tiled_world(backend: str, rank: int, world: int, store: Path):
    """A process group of ``world`` ranks (``file://`` rendezvous), destroyed
    on the way out."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TILED_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def tiled_store(tag: str) -> Path:
    """A fresh rendezvous file under the checkout's git-ignored ``build/``."""
    path = ROOT / "build" / "tiled" / f"{tag}-{os.getpid()}-{time.time_ns()}"
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


@contextlib.contextmanager
def no_p2p():
    """Any ring step or edge sum raises (a mesh of one rank must make none)."""
    from ptwt_tpu_torch.parallel import _ring

    def refuse(*args, **kwargs):
        raise AssertionError("a ring of one rank made a collective call")

    real = _ring._all_to_all, _ring._all_reduce
    _ring._all_to_all = _ring._all_reduce = refuse
    try:
        yield
    finally:
        _ring._all_to_all, _ring._all_reduce = real


def tiled_run(kind: str, x, wavelet: str, level: int, mode: str, mesh) -> tuple:
    """The tiled forward and inverse, each with the launch counts set to 0
    just before it and read just after."""
    fwd, inv, _, _ = tiled_funcs(kind)
    _kernels.reset_launch_counts()
    coeffs = fwd(x, wavelet, level=level, mesh=mesh, mode=mode)
    torch.cuda.synchronize()
    fwd_counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    _kernels.reset_launch_counts()
    rec = inv(coeffs, wavelet, mesh=mesh, mode=mode)
    torch.cuda.synchronize()
    inv_counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    return coeffs, rec, fwd_counts, inv_counts


def tiled_serial(kind: str, x, wavelet: str, level: int, mode: str) -> tuple:
    _, _, fwd, inv = tiled_funcs(kind)
    coeffs = fwd(x, wavelet, mode=mode, level=level)
    return tiled_leaves(coeffs), inv(coeffs, wavelet, mode=mode)


def tiled_compare(name: str, bands, rec, x, want, want_rec) -> dict:
    """Bands and reconstruction against the serial port on the card
    (relative to ``max(1, |band|)``), the round trip against the input."""
    tol = TOL[x.dtype]
    return {
        "band_rel_err": check(f"{name} bands vs the serial port (relative)", rel_err(bands, want), tol),
        "rec_rel_err": check(f"{name} reconstruction vs the serial port (relative)", rel_err(rec, want_rec), tol),
        # an odd padded axis comes back one longer, as in pywt
        "round_trip_err": check(f"{name} round trip vs input", max_abs(rec[tuple(map(slice, x.shape))], x),
                                ROUND_TRIP_TOL if x.dtype == torch.float32 else TOL[x.dtype]),
    }


def tiled_one_rank() -> dict:
    """Phase 18 (a): every row on one NCCL rank, no P2P call; one backward;
    float64 at smaller shapes."""
    from ptwt_tpu_torch.parallel import _ring

    out = {}
    with tiled_world("nccl", 0, 1, tiled_store("nccl")), no_p2p():
        for i, (name, kind, shape, wavelet, level, mode, kw) in enumerate(TILED_FULL):
            log(f"  (a) {name}: {list(shape)}, {wavelet}, level {level}, {mode}, one rank")
            mesh = tiled_mesh(1, kw)
            x = randn(shape, torch.float32, SEED + 1800 + i)
            _ring.EXCHANGE_LOG = []
            coeffs, rec, fwd_counts, inv_counts = tiled_run(kind, x, wavelet, level, mode, mesh)
            exchanges, _ring.EXCHANGE_LOG = _ring.EXCHANGE_LOG, None
            want_fwd, want_inv = TILED_LAUNCHES[name][1]
            only(fwd_counts, want_fwd, f"{name} one rank forward")
            only(inv_counts, want_inv, f"{name} one rank inverse")
            bands = [c.full_tensor() for c in tiled_leaves(coeffs)]
            rec = rec.full_tensor()
            if exchanges:
                raise AssertionError(f"{name}: one rank exchanged {exchanges}")
            want, want_rec = tiled_serial(kind, x, wavelet, level, mode)
            out[name] = {**tiled_compare(f"{name} one rank", bands, rec, x, want, want_rec),
                         "forward": fwd_counts, "inverse": inv_counts}
            del x, coeffs, rec, bands, want, want_rec
            torch.cuda.empty_cache()
        out["backward"] = tiled_backward()
        for i, (name, kind, shape, wavelet, level, mode) in enumerate(TILED_F64):
            mesh = tiled_mesh(1, {"n_data": 1, "n_spatial": 1})
            x = randn(shape, torch.float64, SEED + 1830 + i)
            coeffs, rec, _, _ = tiled_run(kind, x, wavelet, level, mode, mesh)
            want, want_rec = tiled_serial(kind, x, wavelet, level, mode)
            out[f"{name} float64"] = tiled_compare(
                f"{name} float64 {list(shape)} one rank", [c.full_tensor() for c in tiled_leaves(coeffs)],
                rec.full_tensor(), x, want, want_rec,
            )
    return out


def tiled_backward() -> dict:
    """One backward of the sum of the squared bands and reconstruction of
    t2d reflect on one rank against autograd through the plain path on the
    card: K3's VJPs are K4 fold launches, K4's zero-bounded K3 launches."""
    name, kind, shape, wavelet, level, mode, kw = TILED_FULL[1]
    fwd, inv, sfwd, sinv = tiled_funcs(kind)
    x = leaf(randn(shape, torch.float32, SEED + 1810))
    mesh = tiled_mesh(1, kw)
    coeffs = fwd(x, wavelet, level=level, mesh=mesh, mode=mode)
    rec = inv(coeffs, wavelet, mesh=mesh, mode=mode)
    loss = sum((c.to_local() ** 2).sum() for c in tiled_leaves(coeffs)) + (rec.to_local() ** 2).sum()
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    back = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    fwd_counts, inv_counts = TILED_LAUNCHES[name][1]
    only(back, {"K4": fwd_counts["K3"], "K3": inv_counts["K4"]}, f"{name} backward")
    with plain_versions():
        xs = leaf(x.detach())
        ref = sfwd(xs, wavelet, mode=mode, level=level)
        ref_loss = sum((c**2).sum() for c in tiled_leaves(ref)) + (sinv(ref, wavelet, mode=mode) ** 2).sum()
        (want,) = torch.autograd.grad(ref_loss, xs)
    err = max_abs(grad, want) / float(want.abs().max())
    check(f"{name} one rank backward vs autograd through the plain path (of the largest entry)", err,
          TRAIN_GRAD_TOL)
    return {"grad_rel_err": err, "launches": back}


def host_full(t, cpu_mesh) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` on a gloo mesh of CUDA tensors,
    gathered through the host: each rank's shard as a ``DTensor`` of the
    same layout on a CPU mesh over the same groups (``full_tensor()`` of
    CUDA shards on a gloo mesh crashes the process, torch 2.11)."""
    from torch.distributed.tensor import DTensor

    local = t.to_local().detach().cpu()
    return DTensor.from_local(local, cpu_mesh, t.placements, run_check=False, shape=t.shape,
                              stride=t.stride()).full_tensor()


def tiled_rank(rank: int, world: int, store: Path, outdir: Path, backend: str = "gloo") -> None:
    """``--tiled-rank R``: one of phase 18 (b)'s ranks.  With gloo every
    rank shares card 0 (the halo slabs go through host memory);
    with NCCL (``--tiled-nccl``) rank R runs on card R.  Rank 0 holds the
    gathered bands against the serial port on its card and the ranks'
    launch counts against ``TILED_LAUNCHES``; every rank runs one backward
    (the gradient summed over the ranks, held against the serial one on
    rank 0), compares the overlapped and the pad-then-compute schedules
    bit for bit and times the t2d round trip."""
    global DEVICE
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ptwt_tpu_torch.parallel import _ring

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    if backend == "nccl":
        DEVICE = torch.device("cuda", rank)
    out = {}
    with tiled_world(backend, rank, world, store):
        meshes = {}
        for i, (name, kind, shape, wavelet, level, mode, kw) in enumerate(TILED_FULL):
            key = json.dumps(kw, sort_keys=True)
            if key not in meshes:
                mesh = tiled_mesh(world, kw)
                groups = [mesh.get_group(n) for n in mesh.mesh_dim_names]
                # gloo gathers CUDA shards through a CPU mesh over the same groups
                meshes[key] = (mesh, DeviceMesh.from_group(groups, "cpu", mesh=mesh.mesh,
                                                           mesh_dim_names=mesh.mesh_dim_names)
                               if backend == "gloo" else None)
            mesh, cpu_mesh = meshes[key]
            x = randn(shape, torch.float32, SEED + 1800 + i)  # the whole tensor, on every rank
            _ring.EXCHANGE_LOG = []
            coeffs, rec, fwd_counts, inv_counts = tiled_run(kind, x, wavelet, level, mode, mesh)
            exchanges, _ring.EXCHANGE_LOG = _ring.EXCHANGE_LOG, None
            traffic = {key: sum(n for _, steps in exchanges for d, n in steps if d == step)
                       for key, step in (("fwd", 1), ("bwd", -1), ("sum", 0))}
            bands = [full_of(c, cpu_mesh) for c in tiled_leaves(coeffs)]
            rec = full_of(rec, cpu_mesh)
            counts = [None] * world
            dist.all_gather_object(counts, (fwd_counts, inv_counts))
            if rank == 0:
                want_fwd, want_inv = TILED_LAUNCHES[name][world]
                for r, (f, b) in enumerate(counts):
                    only(f, want_fwd, f"{name} rank {r} forward")
                    only(b, want_inv, f"{name} rank {r} inverse")
                total = {"forward": {k: sum(c[0].get(k, 0) for c in counts) for k in want_fwd},
                         "inverse": {k: sum(c[1].get(k, 0) for c in counts) for k in want_inv}}
                log(f"  (b) {name}: launches per rank {counts[0]}, summed over {world} ranks {total}")
                want, want_rec = tiled_serial(kind, x, wavelet, level, mode)
                out[name] = {
                    **tiled_compare(f"{name} {world} {backend} ranks", [b.to(DEVICE) for b in bands],
                                    rec.to(DEVICE), x, want, want_rec),
                    "launches_per_rank": {"forward": fwd_counts, "inverse": inv_counts},
                    "launches_summed": total,
                    "bytes_sent_rank0": traffic,
                    "exchanges_rank0": exchanges,
                }
                del want, want_rec
            del x, coeffs, rec, bands
            torch.cuda.empty_cache()
        out["backward"] = tiled_rank_backward(meshes, world, rank)
        out["schedules"] = tiled_schedules(meshes, world, rank)
        out["times"] = tiled_rank_times(meshes, world, rank, backend)
    (outdir / f"rank{rank}.json").write_text(json.dumps(out))


def full_of(t, cpu_mesh) -> torch.Tensor:
    """The whole tensor of a ``DTensor``: ``full_tensor()``, or through the
    host on a gloo mesh of CUDA shards (:func:`host_full`)."""
    return t.full_tensor() if cpu_mesh is None else host_full(t, cpu_mesh)


def tiled_rank_backward(meshes: dict, world: int, rank: int) -> dict:
    """One backward of the sum of the squared bands and reconstruction of
    t2d ``periodization`` (the ring) and ``reflect`` (the padded levels and
    their edge sums) across the ranks: each rank's gradient of the whole
    input holds its own chunk, summed over the ranks, against autograd
    through the serial port on rank 0's card (1e-4 of the largest entry)."""
    import torch.distributed as dist

    out = {}
    for i, (name, kind, shape, wavelet, level, mode, kw) in enumerate(TILED_FULL[:2]):
        mesh, _ = meshes[json.dumps(kw, sort_keys=True)]
        fwd, inv, sfwd, sinv = tiled_funcs(kind)
        x = leaf(randn(shape, torch.float32, SEED + 1800 + i))
        coeffs = fwd(x, wavelet, level=level, mesh=mesh, mode=mode)
        rec = inv(coeffs, wavelet, mesh=mesh, mode=mode)
        loss = sum((c.to_local() ** 2).sum() for c in tiled_leaves(coeffs)) + (rec.to_local() ** 2).sum()
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        back = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        dist.all_reduce(grad)  # the chunks are disjoint: the sum is the whole gradient
        if rank == 0:
            xs = leaf(x.detach())
            ref = sfwd(xs, wavelet, mode=mode, level=level)
            ref_loss = sum((c**2).sum() for c in tiled_leaves(ref)) + (sinv(ref, wavelet, mode=mode) ** 2).sum()
            (want,) = torch.autograd.grad(ref_loss, xs)
            err = max_abs(grad, want) / float(want.abs().max())
            check(f"{name} {world} ranks backward vs the serial port's (of the largest entry)", err, TRAIN_GRAD_TOL)
            out[name] = {"grad_rel_err": err, "launches_rank0": back}
        del x, coeffs, rec, loss, grad
        torch.cuda.empty_cache()
    return out


def tiled_schedules(meshes: dict, world: int, rank: int) -> dict:
    """t2d periodization overlapped and with ``PTWT_TPU_NO_OVERLAP=1``: every
    rank's bands and reconstruction equal bit for bit."""
    import torch.distributed as dist

    name, kind, shape, wavelet, level, mode, kw = TILED_FULL[0]
    mesh, _ = meshes[json.dumps(kw, sort_keys=True)]
    x = randn(shape, torch.float32, SEED + 1800)
    runs = {}
    for flag in ("", "1"):
        os.environ["PTWT_TPU_NO_OVERLAP"] = flag
        coeffs, rec, fwd_counts, inv_counts = tiled_run(kind, x, wavelet, level, mode, mesh)
        runs[flag] = ([c.to_local() for c in tiled_leaves(coeffs)] + [rec.to_local()], fwd_counts, inv_counts)
    os.environ.pop("PTWT_TPU_NO_OVERLAP")
    same = all(torch.equal(a, b) for a, b in zip(runs[""][0], runs["1"][0]))
    verdicts = [None] * world
    dist.all_gather_object(verdicts, same)
    if rank == 0:
        log(f"  (b) {name}: overlapped and PTWT_TPU_NO_OVERLAP=1 equal bit for bit on ranks {verdicts}; "
            f"launches per rank {runs[''][1:]} and {runs['1'][1:]}")
        if not all(verdicts):
            raise AssertionError(f"{name}: the two ring schedules differ on ranks {verdicts}")
    return {"bitwise_equal": verdicts, "overlap_launches": runs[""][1:], "no_overlap_launches": runs["1"][1:]}


def tiled_rank_times(meshes: dict, world: int, rank: int, backend: str) -> dict:
    """t2d periodization's round trip on this rank: wall ms (median of
    ``TILED_REPS`` after 3 warm-ups, every rank starting together), and the
    host ms spent posting and waiting for the ring steps (the copies
    through host memory and gloo's transfer) in one round trip."""
    import torch.distributed as dist

    from ptwt_tpu_torch.parallel import _ring

    name, kind, shape, wavelet, level, mode, kw = TILED_FULL[0]
    mesh, _ = meshes[json.dumps(kw, sort_keys=True)]
    fwd, inv, _, _ = tiled_funcs(kind)
    x = randn(shape, torch.float32, SEED + 1800)
    spent = [0.0]
    post, finish = _ring._start, _ring.Pending.wait

    def timed(fn):
        def wrapper(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[0] += time.perf_counter() - t0
        return wrapper

    def round_trip():
        return inv(fwd(x, wavelet, level=level, mesh=mesh, mode=mode), wavelet, mesh=mesh, mode=mode)

    walls, ring = [], []
    _ring._start, _ring.Pending.wait = timed(post), timed(finish)
    try:
        for rep in range(3 + TILED_REPS):
            dist.barrier()
            torch.cuda.synchronize()
            spent[0] = 0.0
            t0 = time.perf_counter()
            round_trip()
            torch.cuda.synchronize()
            if rep >= 3:
                walls.append((time.perf_counter() - t0) * 1e3)
                ring.append(spent[0] * 1e3)
    finally:
        _ring._start, _ring.Pending.wait = post, finish
    row = {"wall_ms": statistics.median(walls), "ring_host_ms": statistics.median(ring)}
    row["ring_host_share"] = row["ring_host_ms"] / row["wall_ms"]
    rows = [None] * world
    dist.all_gather_object(rows, row)
    note = (f"{world} processes sharing one card, halo slabs staged through the host; not a scaling figure"
            if backend == "gloo" else f"{world} NCCL ranks, one card each")
    if rank == 0:
        for r, each in enumerate(rows):
            log(f"  (b) {name} round trip, rank {r} ({note}): " + " ".join(f"{k}={v!r}" for k, v in each.items()))
    return {"per_rank": rows, "note": note}


def tiled_ranks(world: int = 4, backend: str = "gloo", flag: str = "--tiled-rank") -> dict:
    """Phase 18 (b) (phase 22 (b) with ``--tiled-compile-rank``): ``world``
    rank processes (gloo: all on card 0; NCCL: one card each), each with a
    deadline; any rank that fails fails the phase."""
    return tiled_collect(*tiled_spawn(world, backend, flag))


def tiled_spawn(world: int, backend: str, flag: str, *extra: str) -> tuple:
    """Start ``world`` rank processes of ``chip_smoke.py flag R``; returns
    what :func:`tiled_collect` takes."""
    store = tiled_store(backend)
    outdir = store.with_name(store.name + "-out")
    outdir.mkdir()
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--world", str(world), "--store", str(store),
           "--out", str(outdir), "--backend", backend, *extra]
    procs = [subprocess.Popen([*cmd, flag, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    return procs, outdir, time.monotonic() + TILED_RANKS_S


def tiled_collect(procs: list, outdir: Path, deadline: float) -> dict:
    """Wait for the rank processes, log rank 0's lines and return its
    JSON; any rank that fails or outlasts ``deadline`` fails the phase."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log("\n".join(line for line in logs[0].splitlines() if line.strip()))
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"tiled rank {r} of {len(procs)} failed (exit {p.returncode}):\n{text[-4000:]}")
    return json.loads((outdir / "rank0.json").read_text())


def tiled_times() -> dict:
    """``--tiled-times``: the one-rank tiled round trip of t2d (both modes)
    and td1 beside the serial round trip of the same row, in one process:
    device ms (CUDA events), wall ms, the profiler's busy ms and share."""
    out = {}
    with tiled_world("nccl", 0, 1, tiled_store("times")):
        for i, (name, kind, shape, wavelet, level, mode, kw) in enumerate(TILED_FULL):
            if name not in ("t2d periodization", "t2d reflect", "td1"):
                continue
            fwd, inv, sfwd, sinv = tiled_funcs(kind)
            mesh = tiled_mesh(1, kw)
            x = randn(shape, torch.float32, SEED + 1800 + i)
            out[f"{name} tiled"] = pkt_row(
                f"{name} tiled round trip, one rank",
                lambda: inv(fwd(x, wavelet, level=level, mesh=mesh, mode=mode), wavelet, mesh=mesh, mode=mode))
            out[f"{name} serial"] = pkt_row(
                f"{name} serial round trip", lambda: sinv(sfwd(x, wavelet, mode=mode, level=level), wavelet, mode=mode))
            del x
            torch.cuda.empty_cache()
    return out


#: ``--dist-probe``'s operations, each in a world of its own on the one
#: card: NCCL with two ranks, then gloo with four and CUDA tensors
DIST_PROBE = (("nccl", 2, "all_reduce"), *(("gloo", 4, op) for op in (
    "send_recv", "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
    "full_tensor_even", "full_tensor_uneven")))


def dist_probe_rank(backend: str, op: str, rank: int, world: int, store: Path) -> None:
    """``--dist-probe-rank``: one rank of one ``DIST_PROBE`` world; prints
    ``ok`` or the error's text (a crash shows in the exit code)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    t = torch.full((4,), float(rank + 1), device=DEVICE)
    with tiled_world(backend, rank, world, store):
        try:
            if op == "send_recv":
                got = torch.empty_like(t)
                works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, (rank + 1) % world),
                                                dist.P2POp(dist.irecv, got, (rank - 1) % world)])
                for work in works:
                    work.wait()
            elif op == "all_reduce":
                dist.all_reduce(t)
            elif op == "all_gather":
                dist.all_gather([torch.empty_like(t) for _ in range(world)], t)
            elif op == "all_gather_into_tensor":
                dist.all_gather_into_tensor(torch.empty(4 * world, device=DEVICE), t)
            elif op == "broadcast":
                dist.broadcast(t, 0)
            else:
                from torch.distributed.tensor import DTensor, Shard

                mesh = tiled_mesh(world, {"n_data": 1, "n_spatial": world})
                cols = 3 if op.endswith("even") or rank < world - 1 else 1
                total = 3 * world if op.endswith("even") else 3 * (world - 1) + 1
                local = torch.full((2, cols), float(rank), device=DEVICE)
                DTensor.from_local(local, mesh, [Shard(0), Shard(1)], run_check=False,
                                   shape=torch.Size((2, total)), stride=(total, 1)).full_tensor()
            torch.cuda.synchronize()
            print(json.dumps({"rank": rank, "result": "ok"}), flush=True)
        except Exception as err:  # the probe reports what the operation raised
            print(json.dumps({"rank": rank, "result": repr(err)[:600]}), flush=True)


def dist_probe() -> dict:
    """``--dist-probe``: which ``torch.distributed`` operations work with
    several ranks on one card (not run by the smoke test itself)."""
    out = {}
    for backend, world, op in DIST_PROBE:
        store = tiled_store(f"probe-{backend}-{op}")
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-probe-rank", backend, op,
                                   str(r), str(world), str(store)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(world)]
        ranks = []
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            lines = [line for line in stdout.splitlines() if line.startswith("{")]
            ranks.append({"exit": p.returncode, "result": json.loads(lines[-1])["result"] if lines else None,
                          "stderr": stderr.strip().splitlines()[-1][:300] if stderr.strip() else ""})
        out[f"{backend} x{world} {op}"] = ranks
        log(f"  {backend} x{world} {op}: {ranks}")
    return out


def tiled_kernel_launches(tiled: dict, name: str) -> dict:
    """Phase 18's launches of one kernel in each row's forward (K3, K7a) or
    inverse (K4, K7b): on one rank, per rank of four and summed over them."""
    direction = "forward" if name in ("K3", "K7a") else "inverse"
    out = {}
    for row, *_ in TILED_FULL:
        four = tiled["four_ranks"][row]
        counts = {"one_rank": tiled["one_rank"][row][direction].get(name, 0),
                  "four_ranks_per_rank": four["launches_per_rank"][direction].get(name, 0),
                  "four_ranks_summed": four["launches_summed"][direction].get(name, 0)}
        if any(counts.values()):
            out[row] = counts
    return out


def check_tiled() -> dict:
    """Phase 18: (a) one NCCL rank, (b) four gloo ranks on the one card,
    (c) the one-rank times in a process of their own (``--tiled-times``)."""
    tiled = {"one_rank": tiled_one_rank()}
    log("  (b) four ranks sharing the card, gloo, halo slabs through host memory")
    tiled["four_ranks"] = tiled_ranks()
    tiled["times"] = times_process("--tiled-times")
    return tiled


# ---------------------------------------------------------------------------
# phase 19: the reduced-precision mode (the dense-operator route)
# ---------------------------------------------------------------------------

#: Phase 19's rows, float32 at full width: (name, dim, shape, wavelet,
#: mode, level): the headline in three modes, d3 and d1.
PREC_ROWS = (
    ("2d periodic", 2, SHAPE, WAVELET, "periodic", LEVEL),
    ("2d reflect", 2, SHAPE, WAVELET, "reflect", LEVEL),
    ("2d periodization", 2, SHAPE, WAVELET, "periodization", LEVEL),
    ("d3", 3, (32, 100, 100, 100), "db5", "reflect", 3),
    ("d1", 1, D1_SHAPE, WAVELET_1D, "periodic", LEVEL_1D),
)
PREC_FUNCS = {1: ("wavedec", "waverec"), 2: ("wavedec2", "waverec2"), 3: ("wavedec3", "waverec3")}
#: Max-abs error of each band and the reconstruction against the float64
#: transform, over ``max(1, that leaf's largest magnitude)`` (PERF.md §2):
#: TF32 products (unit roundoff 2^-11) and bfloat16 operands (2^-8), about
#: twice the largest reading on the H100; a backward's gradient, over
#: ``max(1, its largest entry)``, to the same limit.  Each limit must also
#: fail ``prec_control``.
PREC_LIMITS = {"high": 3e-3, "default": 3e-2}
#: ``prec_control``'s boundary error: the first sample along the last axis
#: of every leaf scaled by this
PREC_CONTROL = 1.1
#: The caller's global float32 settings during phase 19, which no product
#: of the port may leave changed (neither is torch's default).
PREC_CALLER = ("medium", False)


def prec_leaves(coeffs) -> list:
    """The approximation, then each level's bands (3d: by sorted key)."""
    out = [coeffs[0]]
    for item in coeffs[1:]:
        out += [item[k] for k in sorted(item)] if isinstance(item, dict) else list(item) if isinstance(item, tuple) else [item]
    return out


def prec_forward(dim: int, x, wavelet: str, mode: str, level: int):
    return getattr(ptwt, PREC_FUNCS[dim][0])(x, wavelet, mode=mode, level=level)


def prec_inverse(dim: int, coeffs, wavelet: str, mode: str):
    rec_mode = mode if dim < 3 or mode == "periodization" else None
    return getattr(ptwt, PREC_FUNCS[dim][1])(coeffs, wavelet, mode=rec_mode)


def prec_counted(fn):
    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _kernels.LAUNCHES.items() if v}


def prec_expected(name: str, highest: dict, direction: str) -> dict:
    """The launches of a reduced-precision run: none where every axis of
    every level is at most 2048 samples (the 2d headline, d3); the K5
    pyramids of 2d periodization as at ``"highest"``; d1's launches but one
    K3 (K4) for level 10, whose 1962 samples go dense."""
    if name == "2d periodization":
        return dict(highest)
    if name == "d1":
        out = dict(highest)
        drop = "K3" if direction == "forward" else "K4"
        out[drop] -= 1
        return {k: v for k, v in out.items() if v}
    return {}


def prec_same(name: str) -> list:
    """Which leaves of a reduced-precision forward must equal ``"highest"``'s
    bit for bit (no dense level reached them): all of 2d periodization
    (K5), d1's detail bands of levels 1-9 (K8 and K3)."""
    if name == "2d periodization":
        return "all"
    if name == "d1":
        return "from 2"
    return "none"


def prec_gemms(rows: list) -> list:
    """The profiler rows of the GEMM kernels (cuBLAS names them ``*gemm*``,
    ``nvjet*``, ``*xmma*`` or ``cutlass*``)."""
    return [(ms, count, key[:90]) for ms, count, key in rows
            if any(s in key.lower() for s in ("gemm", "nvjet", "xmma", "cutlass"))]


#: Substrings of the hand-written kernels' names in a profile (KT: its sums' kernel)
PREC_HAND = ("axis_kernel", "tile_kernel", "pyramid", "mxu2d", "tap_grad_kernel")


def prec_timing(run, label: str, launches: int) -> dict:
    """Device ms (CUDA events; the profiler's busy ms), wall ms, busy share
    and the GEMM kernels of one round trip, from a profiler window that
    must hold every one of its ``launches`` hand-written kernel launches."""
    rows = profile(run, label, top=6)
    busy = sum(r[0] for r in rows)
    wall = wall_ms(run)
    gemms = prec_gemms(rows)
    seen = sum(count for _, count, key in rows if any(s in key for s in PREC_HAND))
    if seen != launches:
        raise AssertionError(f"{label}: the profile holds {seen} of {launches} kernel launches")
    return {
        "events_ms": time_ms(run),
        "device_ms": busy,
        "wall_ms": wall,
        "busy_share": busy / wall,
        "gemm_ms": sum(r[0] for r in gemms),
        "gemms": [[ms, count, key] for ms, count, key in gemms],
        "top": [[ms, count, key[:90]] for ms, count, key in rows[:4]],
    }


def prec_error(got: list, want: list) -> float:
    """The largest max-abs error of a leaf over ``max(1, its largest
    magnitude)``."""
    return max(max_abs(g.double(), w) / max(1.0, float(w.abs().max())) for g, w in zip(got, want))


def prec_control(got: list) -> list:
    """``got`` with a boundary row off by ``PREC_CONTROL - 1`` (what a wrong
    boundary fold gives): a result each level's limit must reject."""
    out = []
    for g in got:
        g = g.clone()
        g[..., :1] *= PREC_CONTROL
        out.append(g)
    return out


def prec_grad(dim: int, x, wavelet: str, mode: str, level: int, w) -> torch.Tensor:
    """The gradient of one round trip's ``sum(rec * w) + sum(bands)``."""
    xd = leaf(x)
    coeffs = prec_forward(dim, xd, wavelet, mode, level)
    rec = prec_inverse(dim, coeffs, wavelet, mode)
    loss = (rec * w).sum() + sum(b.sum() for b in prec_leaves(coeffs))
    (grad,) = torch.autograd.grad(loss, xd)
    return grad


def prec_times() -> dict:
    """``--prec-times ROW`` (phase 19, one process a row, whose profiler
    windows then hold every launch): the ``PREC_ROWS`` row named ROW under
    ``"high"`` and ``"default"`` against the float64 transform and against
    ``"highest"``, its launches, times, GEMMs and one backward; or, for
    ``conv``, :func:`prec_conv`.  The caller's global float32 settings
    (``PREC_CALLER``) must be unchanged after each level."""
    from ptwt_tpu_torch import ops

    name = _arg("--prec-times")
    torch.set_float32_matmul_precision(PREC_CALLER[0])
    torch.backends.cudnn.allow_tf32 = PREC_CALLER[1]
    try:
        out = prec_conv() if name == "conv" else prec_row(name)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = True
    if ops.get_precision() != "highest":
        raise AssertionError("phase 19 left the port's precision changed")
    return out


def prec_row(name: str) -> dict:
    from ptwt_tpu_torch import ops

    i, (_, dim, shape, wavelet, mode, level) = next((i, r) for i, r in enumerate(PREC_ROWS) if r[0] == name)
    log(f"  {name}: {PREC_FUNCS[dim][0]} -> {PREC_FUNCS[dim][1]} on {list(shape)}, {wavelet}, {mode}, level {level}")
    x = randn(shape, torch.float32, SEED + 1900 + i)
    w = randn(shape, torch.float32, SEED + 1950 + i)
    x64 = x.double()
    coeffs64 = prec_forward(dim, x64, wavelet, mode, level)
    want = prec_leaves(coeffs64) + [prec_inverse(dim, coeffs64, wavelet, mode)]
    grad64 = prec_grad(dim, x64, wavelet, mode, level, w.double())
    del x64, coeffs64
    coeffs_h, fwd_h = prec_counted(lambda: prec_forward(dim, x, wavelet, mode, level))
    rec_h, inv_h = prec_counted(lambda: prec_inverse(dim, coeffs_h, wavelet, mode))
    highest = prec_leaves(coeffs_h) + [rec_h]

    def round_trip():
        return prec_inverse(dim, prec_forward(dim, x, wavelet, mode, level), wavelet, mode)

    def launches(counts: dict) -> int:
        return sum(counts["forward"].values()) + sum(counts["inverse"].values())

    row = {"highest": {"error": max_abs([a.double() for a in highest], want),
                       "launches": {"forward": fwd_h, "inverse": inv_h}}}
    row["highest"].update(prec_timing(round_trip, f"{name} highest round trip", launches(row["highest"]["launches"])))
    log(f"  {name} highest: error {row['highest']['error']!r}, events {row['highest']['events_ms']!r} ms")
    for level_name, limit in PREC_LIMITS.items():
        ops.set_precision(level_name)
        try:
            coeffs, fwd = prec_counted(lambda: prec_forward(dim, x, wavelet, mode, level))
            rec, inv = prec_counted(lambda: prec_inverse(dim, coeffs, wavelet, mode))
            got = prec_leaves(coeffs) + [rec]
            err = check(f"{name} {level_name} vs float64 (relative)", prec_error(got, want), limit)
            control = prec_error(prec_control(got), want)
            log(f"  {name} {level_name} control (a boundary row {PREC_CONTROL - 1:.0%} off): {control!r}")
            if not control > limit:
                raise AssertionError(f"{name} {level_name}: the limit {limit!r} passes the control ({control!r})")
            diffs = [float((g - h).abs().max()) if g.numel() else 0.0 for g, h in zip(got, highest)]
            same = prec_same(name)
            for j, d in enumerate(diffs):
                must_equal = same == "all" or (same == "from 2" and 2 <= j < len(diffs) - 1)
                if must_equal and d != 0.0:
                    raise AssertionError(f"{name} {level_name}: leaf {j} differs from highest by {d!r} "
                                         "where no dense level ran")
                if not must_equal and not d > 0.0:
                    raise AssertionError(f"{name} {level_name}: leaf {j} equals highest bit for bit: "
                                         "the reduced mode did not engage")
            for direction, counts, ref in (("forward", fwd, fwd_h), ("inverse", inv, inv_h)):
                if any(counts.get(k) for k in ("K1", "K2", "K9a", "K9b")):
                    raise AssertionError(f"{name} {level_name} {direction}: K1/K2/K9 launched: {counts}")
                expected = prec_expected(name, ref, direction)
                if counts != expected:
                    raise AssertionError(f"{name} {level_name} {direction}: launches {counts}, expected {expected}")
            grad = prec_grad(dim, x, wavelet, mode, level, w)
            grad_err = check(f"{name} {level_name} backward vs float64 (relative)",
                             max_abs(grad.double(), grad64) / max(1.0, float(grad64.abs().max())), limit)
            entry = {"error": err, "limit": limit, "control_error": control, "max_diff_vs_highest": max(diffs),
                     "diff_per_leaf": diffs, "launches": {"forward": fwd, "inverse": inv},
                     "backward_error": grad_err}
            entry.update(prec_timing(round_trip, f"{name} {level_name} round trip", launches(entry["launches"])))
        finally:
            ops.set_precision("highest")
        if (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) != PREC_CALLER:
            raise AssertionError(f"{name} {level_name}: the caller's float32 settings changed")
        log(f"  {name} {level_name}: error {err!r}, diff vs highest {max(diffs)!r}, events {entry['events_ms']!r} ms, "
            f"wall {entry['wall_ms']!r} ms, gemms {entry['gemm_ms']!r} ms")
        row[level_name] = entry
    return row


def prec_conv() -> dict:
    """``analysis_conv``/``synthesis_conv`` at the headline's level 1 (db4,
    no padding) at each level against float64, with cuDNN's TF32 flag left
    on by the caller: ``"highest"`` must hold the float32 limit."""
    from ptwt_tpu_torch import ops
    from ptwt_tpu_torch.utils import construct_nd_filter

    dl, dh, rl, rh = banks_2d(torch.float64)
    dec = construct_nd_filter(dl, dh, 2).to(DEVICE)
    rec = construct_nd_filter(rl, rh, 2).to(DEVICE)
    x = randn(SHAPE, torch.float32, SEED + 1990)
    want = ops.analysis_conv(x.double(), dec)
    want_rec = ops.synthesis_conv(want, rec)
    out = {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        for level_name in ("highest", *PREC_LIMITS):
            ops.set_precision(level_name)
            try:
                got = ops.analysis_conv(x, dec.float())
                got_rec = ops.synthesis_conv(want.float(), rec.float())
            finally:
                ops.set_precision("highest")
            out[level_name] = {"analysis": max_abs(got.double(), want), "synthesis": max_abs(got_rec.double(), want_rec)}
            log(f"  conv {level_name}: {out[level_name]}")
            if torch.backends.cudnn.allow_tf32 is not True:
                raise AssertionError("the convolutions left cuDNN's TF32 flag changed")
    finally:
        torch.backends.cudnn.allow_tf32 = PREC_CALLER[1]
    check("conv highest vs float64 (analysis)", out["highest"]["analysis"], TOL[torch.float32])
    check("conv highest vs float64 (synthesis)", out["highest"]["synthesis"], TOL[torch.float32])
    return out


# ---------------------------------------------------------------------------
# phase 20: torch.compile, torch.func.grad and torch.func.vmap
# ---------------------------------------------------------------------------

#: Phase 20's rows at full width, the main path first: (name, shape,
#: seed); :func:`compile_funcs` gives each row's transform and inverse.
COMPILE_ROWS = (
    ("2d periodic", SHAPE, SEED),
    ("2d reflect", SHAPE, SEED + 1),
    ("2d periodization", SHAPE, SEED + 2),
    ("d1", D1_SHAPE, SEED + 3),
    ("d3", ND_FULL[0][2], SEED + 4),
    ("fs2", ND_FULL[1][2], SEED + 5),
    ("swt", MAT_FULL[2][1], SEED + 6),
    ("cwt", PKT_CWT[1], SEED + 7),
    ("mat1d", MAT_FULL[0][1], SEED + 8),
    ("mat2d", MAT_FULL[1][1], SEED + 9),
)
#: The rows that launch no hand-written kernel (plain torch ops, cuFFT and
#: cuBLAS): the ops' composition shows in the others.
COMPILE_NO_KERNEL = ("swt", "cwt", "mat2d")
#: The learnable headline step (phase 17 (b), periodic): KT's path.
COMPILE_LEARN = ("learnable 2d periodic", SHAPE, SEED + 10)
#: The row compiled with inductor (and timed, :func:`compile_headline`); the
#: others compile with ``aot_eager``, which traces the same graph of ops
#: with no code generation: inductor's cold compiles of every row took
#: some 200 s of the script's limit (the card tests compile each row with
#: inductor at small sizes).
COMPILE_INDUCTOR = ("2d periodic",)
#: Compiled against eager over ``max(1, |leaf|)``; ``torch.func`` against
#: autograd and the batched call over the largest entry.
COMPILE_TOL = 1e-5
#: The ops of the kernels (``torch.ops.ptwt_tpu_torch``), by kernel: a
#: kernel's VJP launch goes through its twin's op.
KERNEL_OPS = {
    "K1": "dwt2_level", "K2": "idwt2_level", "K3": "analysis_axis", "K4": "synthesis_axis",
    "K5a": "wavedec2d_run", "K5b": "waverec2d_run", "K6a": "wavedec1d_run", "K6b": "waverec1d_run",
    "K7a": "lane_analysis", "K7b": "lane_synthesis", "K8a": "lane_analysis, long_analysis_run",
    "K8b": "lane_synthesis, long_synthesis_run", "K9a": "dwt2_level", "K9b": "idwt2_level", "KT": "tap_grad",
}


def compile_funcs(name: str):
    """Row ``name``'s transform and inverse (``None`` for ``cwt``), at
    the shapes and banks of phases 4-16."""
    if name.startswith("2d"):
        mode = name.split()[1]
        return (lambda x: ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL),
                lambda c: ptwt.waverec2(c, WAVELET, mode=mode))
    if name == "d1":
        return (lambda x: ptwt.wavedec(x, WAVELET_1D, mode="reflect", level=LEVEL_1D),
                lambda c: ptwt.waverec(c, WAVELET_1D))
    if name in ("d3", "fs2"):
        _, kind, _, wavelet, mode, level = next(r for r in ND_FULL if r[0] == name)
        fwd, inv = (getattr(ptwt, f) for f in ND_FUNCS[kind])
        return (lambda x: fwd(x, wavelet, mode=mode, level=level)), (lambda c: inv(c, wavelet))
    if name == "cwt":
        _, _, wavelet, scales, period = PKT_CWT
        return (lambda x: ptwt.cwt(x, scales, wavelet, sampling_period=period)[0]), None
    _, _, wavelet, level = next(r for r in MAT_FULL if r[0] == name)
    if name == "swt":
        return (lambda x: ptwt.swt(x, wavelet, level)), (lambda c: ptwt.iswt(c, wavelet))
    fwd, inv = (ptwt.MatrixWavedec, ptwt.MatrixWaverec) if name == "mat1d" else (
        ptwt.MatrixWavedec2, ptwt.MatrixWaverec2)
    return fwd(wavelet, level), inv(wavelet)


def compile_leaves(out) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]


def compile_err(got, want) -> float:
    """The largest of ``|got - want| / max(1, |want|)`` over the leaves."""
    return max(
        float((g - w).abs().max()) / max(1.0, float(w.abs().max())) if w.numel() else 0.0
        for g, w in zip(compile_leaves(got), compile_leaves(want))
    )


def compile_rel(got, want) -> float:
    """``|got - want|`` over ``want``'s largest entry, the largest over the leaves."""
    return max(
        float((g - w).abs().max()) / float(w.abs().max()) if w.numel() and float(w.abs().max()) else 0.0
        for g, w in zip(compile_leaves(got), compile_leaves(want))
    )


def compile_loss(fwd, inv, weight):
    """The squares of every coefficient, plus the round trip weighted by
    ``weight``: a backward through both directions."""

    def loss(x):
        coeffs = fwd(x)
        out = sum((c.abs() ** 2).sum() for c in compile_leaves(coeffs))
        if inv is not None:
            out = out + (inv(coeffs) * weight).sum()
        return out

    return loss


def counted(run, *args):
    """``run(*args)`` with the launch counts set to 0 just before it and
    read just after: ``(out, launches)``."""
    _kernels.reset_launch_counts()
    out = run(*args)
    return out, pkt_counts()


def compile_check(name: str, fwd, inv, x: torch.Tensor, grads_of=None) -> dict:
    """Eager, compiled (``torch.compile(fullgraph=True)``, static shapes,
    the backend of :data:`COMPILE_INDUCTOR`), ``torch.func.grad`` and
    ``torch.func.vmap`` of one row at full width: values within
    :data:`COMPILE_TOL`, launches equal."""
    fn = fwd if inv is None else (lambda t: inv(fwd(t)))
    if name.startswith("mat"):
        fn(x)  # the operators, built eagerly as tests/test_jit.py builds them
    want, eager = counted(fn, x)
    backend = "inductor" if name in COMPILE_INDUCTOR else "aot_eager"
    compiled = torch.compile(fn, fullgraph=True, dynamic=False, backend=backend)
    t0 = time.perf_counter()
    compiled(x)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    got, launches = counted(compiled, x)
    err = compile_err(got, want)
    log(f"  {name}: {backend} compile {compile_s!r} s, launches {launches} (eager {eager}), err {err!r}")
    if launches != eager or not eager and name not in COMPILE_NO_KERNEL:
        raise AssertionError(f"{name}: compiled launches {launches}, eager {eager}")
    if err > COMPILE_TOL:
        raise AssertionError(f"{name}: compiled against eager {err!r} > {COMPILE_TOL}")
    del got, want
    weight = randn(fn(x).shape, torch.float32, SEED + 50) if inv is not None else None
    loss = compile_loss(fwd, inv, weight)
    g_func, func_launches = counted(torch.func.grad(loss), x)
    xr = x.detach().requires_grad_()
    (g_auto,), auto_launches = counted(lambda t: torch.autograd.grad(loss(t), t), xr)
    grad_err = compile_rel(g_func, g_auto)
    log(f"  {name}: torch.func.grad launches {func_launches} (autograd {auto_launches}), err {grad_err!r}")
    if func_launches != auto_launches or grad_err > COMPILE_TOL:
        raise AssertionError(f"{name}: torch.func.grad against autograd: {grad_err!r}, {func_launches}")
    del g_func, g_auto, xr
    xs = x.reshape(2, x.shape[0] // 2, *x.shape[1:])
    v, vmap_launches = counted(torch.func.vmap(fn), xs)
    b, batched_launches = counted(fn, x)
    if name == "cwt":  # [scales, batch, time]
        b = b.reshape(b.shape[0], 2, -1, b.shape[-1]).movedim(1, 0)
    vmap_err = compile_rel(v, b.reshape(v.shape))
    log(f"  {name}: torch.func.vmap launches {vmap_launches} (batched {batched_launches}), err {vmap_err!r}")
    if vmap_launches != batched_launches or vmap_err > COMPILE_TOL:
        raise AssertionError(f"{name}: torch.func.vmap against the batched call: {vmap_err!r}, {vmap_launches}")
    torch._dynamo.reset()
    torch.cuda.empty_cache()
    return {"backend": backend, "compile_s": compile_s, "launches": launches, "err": err, "grad_err": grad_err,
            "grad_launches": func_launches, "vmap_err": vmap_err, "vmap_launches": vmap_launches}


def compile_learnable() -> dict:
    """The learnable headline step (K3/K4 per axis, KT backward): compiled
    loss and backward against eager, ``torch.func.grad`` with respect to
    the filters against autograd, the forward vmapped over the data."""
    name, shape, seed = COMPILE_LEARN
    x = randn(shape, torch.float32, seed)
    filters = [f.detach() for f in learn_bank(WAVELET, torch.float32, DEVICE).filter_bank]

    def loss(filt, t):
        details, rec = learn_run("2d", t, tuple(filt), "periodic", LEVEL)
        return 0.1 * sum(d.abs().mean() for d in details) + 100.0 * ((rec - t) ** 2).mean()

    def step(run, filt):
        params = [f.clone().requires_grad_() for f in filt]
        return torch.autograd.grad(run(params, x), params)

    want, eager = counted(step, loss, filters)
    compiled = torch.compile(loss, fullgraph=True, dynamic=False, backend="aot_eager")
    t0 = time.perf_counter()
    step(compiled, filters)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    got, launches = counted(step, compiled, filters)
    err = compile_rel(got, want)
    g_func, func_launches = counted(torch.func.grad(loss), filters, x)
    grad_err = compile_rel(g_func, want)
    xs = x.reshape(2, shape[0] // 2, *shape[1:])
    fwd = lambda t: learn_run("2d", t, tuple(filters), "periodic", LEVEL)[1]  # noqa: E731
    v, vmap_launches = counted(torch.func.vmap(fwd), xs)
    b, batched_launches = counted(fwd, x)
    vmap_err = compile_rel(v, b.reshape(v.shape))
    log(f"  {name}: compile {compile_s!r} s, launches {launches} (eager {eager}), err {err!r}; "
        f"torch.func.grad {func_launches}, err {grad_err!r}; vmap {vmap_launches} (batched {batched_launches}), "
        f"err {vmap_err!r}")
    if launches != eager or eager.get("KT", 0) < 1 or err > COMPILE_TOL:
        raise AssertionError(f"{name}: compiled step {launches} against eager {eager}, {err!r}")
    if func_launches != eager or grad_err > COMPILE_TOL:
        raise AssertionError(f"{name}: torch.func.grad {func_launches}, {grad_err!r}")
    if vmap_launches != batched_launches or vmap_err > COMPILE_TOL:
        raise AssertionError(f"{name}: torch.func.vmap {vmap_launches}, {vmap_err!r}")
    torch._dynamo.reset()
    return {"backend": "aot_eager", "compile_s": compile_s, "launches": launches, "err": err,
            "grad_err": grad_err, "grad_launches": func_launches, "vmap_err": vmap_err,
            "vmap_launches": vmap_launches}


def compile_timing(run, label: str, launches: int, complete: bool = True) -> dict:
    """Device ms (the profiler's busy ms; CUDA events), wall ms and busy
    share of one call, from a profiler window that must hold every one of
    its ``launches`` hand-written kernel launches where ``complete``."""
    rows = profile(run, label, top=6)
    busy = sum(r[0] for r in rows)
    seen = sum(count for _, count, key in rows if any(s in key for s in PREC_HAND))
    log(f"  {label}: the profile holds {seen} of {launches} kernel launches")
    if complete and seen != launches:
        raise AssertionError(f"{label}: the profile holds {seen} of {launches} kernel launches")
    wall = wall_ms(run)
    return {"device_ms": busy, "events_ms": time_ms(run), "wall_ms": wall, "busy_share": busy / wall,
            "profiled_launches": seen, "top": [[ms, count, key[:90]] for ms, count, key in rows[:4]]}


def compile_headline() -> dict:
    """The headline round trip eager, compiled (inductor's default mode)
    and compiled with ``mode="reduce-overhead"`` (a CUDA graph): output,
    launches, cudagraph skips (none), compile seconds and times."""
    from torch._dynamo.utils import counters

    name, shape, seed = COMPILE_ROWS[0]
    x = randn(shape, torch.float32, seed)
    fwd, inv = compile_funcs(name)

    def fn(t):
        return inv(fwd(t))

    want, eager = counted(fn, x)
    total = sum(eager.values())
    out = {"eager": compile_timing(lambda: fn(x), "eager", total)}
    for mode in ("default", "reduce-overhead"):
        torch._dynamo.reset()
        counters.clear()
        compiled = torch.compile(fn, fullgraph=True, dynamic=False, mode=None if mode == "default" else mode)
        t0 = time.perf_counter()
        compiled(x)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        for _ in range(2):  # cudagraph trees record on a later call
            got = compiled(x)
        torch.cuda.synchronize()
        err = compile_err(got, want)
        skips = dict(counters["inductor"]).get("cudagraph_skips", 0)
        log(f"  headline {mode}: compile {compile_s!r} s, err {err!r}, cudagraph_skips {skips}")
        if err > COMPILE_TOL:
            raise AssertionError(f"headline {mode}: {err!r} against eager")
        if mode == "reduce-overhead" and skips:
            raise AssertionError(f"headline reduce-overhead: {skips} cudagraph skips: {dict(counters['inductor'])}")
        del got
        # a CUDA graph's replay runs no python: the counts stay with the
        # recording, and the profile may show the graph's kernels or not
        timing = compile_timing(lambda: compiled(x), mode, total, complete=mode == "default")
        out[mode] = {"compile_s": compile_s, "err": err, "cudagraph_skips": skips, **timing}
    torch._dynamo.reset()
    return {"launches": eager, **out}


def compile_times() -> dict:
    """``--compile-times`` (phase 20, a process of its own): every row of
    :data:`COMPILE_ROWS` and the learnable headline step compiled, under
    ``torch.func.grad`` and under ``torch.func.vmap`` at full width, then
    the headline's times eager, compiled and under reduce-overhead."""
    rows = {}
    for name, shape, seed in COMPILE_ROWS:
        fwd, inv = compile_funcs(name)
        rows[name] = compile_check(name, fwd, inv, randn(shape, torch.float32, seed))
    rows[COMPILE_LEARN[0]] = compile_learnable()
    return {"rows": rows, "headline": compile_headline()}


# ---------------------------------------------------------------------------
# phase 21: second derivatives
# ---------------------------------------------------------------------------

#: Phase 21's rows at full width: (name, kind, shape, wavelet, level, mode,
#: seed).  The loss is the sum of every cubed coefficient, so that its
#: Hessian depends on x; the step is x.grad of the squared input gradient.
SECOND_ROWS = (
    ("2d periodic", "2d", SHAPE, WAVELET, LEVEL, "periodic", SEED + 2100),
    ("2d reflect", "2d", SHAPE, WAVELET, LEVEL, "reflect", SEED + 2101),
    ("2d periodization", "2d", SHAPE, WAVELET, LEVEL, "periodization", SEED + 2102),
    ("d1", "1d", D1_SHAPE, WAVELET_1D, LEVEL_1D, "reflect", SEED + 2103),
)
#: The row also run in float64, against float64 at 1e-10.
SECOND_F64 = "2d periodic"
#: (e): phase 17's "2d periodic" learnable bank on the headline.
SECOND_LEARN = ("learnable 2d periodic", SHAPE, WAVELET, LEVEL, "periodic", SEED + 2104)
#: Against the plain path in float64 (and autograd against ``torch.func``),
#: over the result's largest entry: ``PERF.md`` §2's gradient limit.
SECOND_TOL = {torch.float32: TRAIN_GRAD_TOL, torch.float64: 1e-10}
#: Each row's kernels by direction: forward, first backward, second backward.
SECOND_KERNELS = {
    "2d periodic": ({"K1", "K3"}, {"K2", "K4"}, {"K1", "K2", "K3", "K4"}),
    "2d reflect": ({"K3"}, {"K4"}, {"K3", "K4"}),
    "2d periodization": ({"K5a"}, {"K5b"}, {"K5a", "K5b"}),
    "d1": ({"K8a", "K3"}, {"K8b", "K4"}, {"K8a", "K8b", "K3", "K4"}),
    "learnable": ({"K3"}, {"K4", "KT"}, {"K3", "K4", "KT"}),
}


def cubed(coeffs) -> torch.Tensor:
    return sum((c**3).sum() for c in compile_leaves(coeffs))


def second_loss(kind: str, wavelet: str, level: int, mode: str):
    """``L(x)``: the sum of the cubed coefficients of the row's transform."""
    fwd = ptwt.wavedec2 if kind == "2d" else ptwt.wavedec
    return lambda t: cubed(fwd(t, wavelet, mode=mode, level=level))


def directions(run_forward, run_first, run_second) -> tuple:
    """The three results and each direction's launches (the counts set to 0
    just before it and read just after)."""
    out, launches = [], []
    for run in (run_forward, run_first, run_second):
        _kernels.reset_launch_counts()
        out.append(run(*out[-1:]))
        launches.append(pkt_counts())
    return out, launches


def penalty_eager(loss, x: torch.Tensor) -> tuple:
    """``x.grad`` of ``P = |dL/dx|^2`` under eager autograd: the first
    backward with ``create_graph=True``, then the second; ``(result,
    [forward, first, second launches])``."""
    xr = leaf(x)
    (_, _, (h,)), launches = directions(
        lambda: loss(xr),
        lambda value: torch.autograd.grad(value, xr, create_graph=True)[0],
        lambda g: torch.autograd.grad((g**2).sum(), xr),
    )
    return h, launches


def penalty_func(loss, x: torch.Tensor) -> tuple:
    """The same under ``torch.func.grad`` of ``torch.func.grad``;
    ``(result, launches)``."""
    return counted(torch.func.grad(lambda t: (torch.func.grad(loss)(t) ** 2).sum()), x)


def second_check(name: str, what: str, err: float, dtype) -> float:
    log(f"  {name}: {what} {err!r} (limit {SECOND_TOL[dtype]!r})")
    if not err <= SECOND_TOL[dtype]:
        raise AssertionError(f"{name}: {what} {err!r} > {SECOND_TOL[dtype]!r}")
    return err


def second_launches(name: str, launches: list, kernels: tuple, exact: bool) -> None:
    """Each direction launches exactly the hand-written kernels of the row
    (every one at least once); with ``exact`` the second backward runs one
    VJP launch per launch of the forward and of the first backward."""
    for direction, got, want in zip(("forward", "first backward", "second backward"), launches, kernels):
        if set(got) != want:
            raise AssertionError(f"{name}: {direction} launched {got}, expected the kernels {sorted(want)}")
    if exact:
        twice = {k: launches[0].get(k, 0) + launches[1].get(k, 0) for k in launches[2]}
        if launches[2] != twice:
            raise AssertionError(f"{name}: second backward {launches[2]}, expected {twice}")


def second_row(name: str, kind: str, shape, wavelet: str, level: int, mode: str, seed: int, dtype) -> dict:
    """One row: the penalty step under autograd and under ``torch.func``
    on the kernel path, against each other and against the same step on
    the plain path in float64, the launches of each direction, and the
    step's times."""
    x = randn(shape, dtype, seed)
    loss = second_loss(kind, wavelet, level, mode)
    got, launches = penalty_eager(loss, x)
    second_launches(name, launches, SECOND_KERNELS[name], exact=True)
    func, func_launches = penalty_func(loss, x)
    total = {k: sum(c.get(k, 0) for c in launches) for k in launches[2]}
    if func_launches != total:
        raise AssertionError(f"{name}: torch.func launched {func_launches}, autograd {total}")
    out = {"dtype": str(dtype)[6:], "launches": dict(zip(("forward", "first_backward", "second_backward"),
                                                          launches)),
           "func_launches": func_launches,
           "func_vs_autograd": second_check(name, "torch.func vs autograd", compile_rel(func, got), dtype)}
    del func
    with plain_versions():
        want, _ = penalty_eager(loss, x.double())
    out["err"] = second_check(name, f"{out['dtype']} kernels vs the float64 plain path", compile_rel(got, want), dtype)
    del got, want
    torch.cuda.empty_cache()
    out.update(compile_timing(lambda: penalty_eager(loss, x), f"{name} {out['dtype']} penalty step",
                              sum(total.values())))
    log(f"  {name}: launches {out['launches']}, device {out['device_ms']!r} ms, events {out['events_ms']!r} ms, "
        f"wall {out['wall_ms']!r} ms")
    del x
    torch.cuda.empty_cache()
    return out


def node_launches(outputs, key: str) -> dict:
    """Hooks on every node of ``outputs``' autograd graph whose name holds
    ``key``: the returned dict collects the launches made inside those
    nodes' backwards (the counts read before and after each one)."""
    seen, stack, nodes = set(), [t.grad_fn for t in outputs if t.grad_fn is not None], []
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        if key in type(node).__name__:
            nodes.append(node)
        stack.extend(n for n, _ in node.next_functions if n is not None)
    inside, before = {}, {}

    def pre(node):
        before[node] = dict(_kernels.LAUNCHES)

    def post(node):
        for k, v in _kernels.LAUNCHES.items():
            if v > before[node].get(k, 0):
                inside[k] = inside.get(k, 0) + v - before[node].get(k, 0)

    for node in nodes:
        node.register_prehook(lambda grads, node=node: pre(node))
        node.register_hook(lambda grads_in, grads_out, node=node: post(node))
    return inside


def learn_loss_cubed(filters, level: int, mode: str):
    """(e)'s loss as a function of the bank's analysis filters (the two
    that ``wavedec2`` reads) and the data."""
    return lambda fs, t: cubed(ptwt.wavedec2(t, (*fs, *filters[2:]), mode=mode, level=level))


def learn_mixed(x: torch.Tensor, filters, level: int, mode: str) -> tuple:
    """The hypergradient ``d|dL/dx|^2 / dfilters`` under eager autograd
    (the mixed term: the fold instance's filter gradient on KT), with each
    direction's launches."""
    loss = learn_loss_cubed(filters, level, mode)
    fs, xr = [leaf(f) for f in filters[:2]], leaf(x)
    (_, _, mixed), launches = directions(
        lambda: loss(fs, xr),
        lambda value: torch.autograd.grad(value, xr, create_graph=True)[0],
        lambda g: torch.autograd.grad((g**2).sum(), fs),
    )
    return mixed, launches


def learn_pure(x: torch.Tensor, filters, level: int, mode: str) -> tuple:
    """``d|dL/dfilters|^2 / dfilters`` under eager autograd (the pure term:
    KT's VJP on K3/K4), with each direction's launches and those made
    inside KT's VJP."""
    loss = learn_loss_cubed(filters, level, mode)
    fs = [leaf(f) for f in filters[:2]]
    vjp = {}

    def first(value):
        grads = torch.autograd.grad(value, fs, create_graph=True)
        vjp["launches"] = node_launches(grads, "tap_grad")  # filled in by the second backward
        return grads

    (_, _, pure), launches = directions(
        lambda: loss(fs, x), first, lambda gs: torch.autograd.grad(sum((g**2).sum() for g in gs), fs)
    )
    return pure, launches, vjp["launches"]


def learn_func(x: torch.Tensor, filters, level: int, mode: str) -> dict:
    """Both terms under ``torch.func.grad`` of ``torch.func.grad``."""
    loss, grad = learn_loss_cubed(filters, level, mode), torch.func.grad
    return {
        "mixed": counted(grad(lambda fs: (grad(loss, argnums=1)(fs, x) ** 2).sum()), list(filters[:2])),
        "pure": counted(grad(lambda fs: sum((g**2).sum() for g in grad(loss)(fs, x))), list(filters[:2])),
    }


def second_learnable() -> dict:
    """(e): the learnable headline, float32 on the kernel path against the
    float64 plain path with the same taps, autograd against ``torch.func``;
    the hypergradient step's times."""
    name, shape, wavelet, level, mode, seed = SECOND_LEARN
    x = randn(shape, torch.float32, seed)
    filters = [f.detach() for f in learn_bank(wavelet, torch.float32, DEVICE).filter_bank]
    terms = {"mixed": learn_mixed, "pure": learn_pure}
    func = learn_func(x, filters, level, mode)
    out = {}
    for term, run in terms.items():
        got = run(x, filters, level, mode)
        with plain_versions():
            want = run(x.double(), [f.double() for f in filters], level, mode)
        second_launches(f"{name} {term}", got[1], SECOND_KERNELS["learnable"], exact=False)
        row = {"launches": dict(zip(("forward", "first_backward", "second_backward"), got[1])),
               "func_launches": func[term][1],
               "func_vs_autograd": second_check(f"{name} {term}", "torch.func vs autograd",
                                                compile_rel(func[term][0], got[0]), torch.float32),
               "err": second_check(f"{name} {term}", "float32 kernels vs the float64 plain path",
                                   compile_rel(got[0], want[0]), torch.float32)}
        if term == "pure":
            row["kt_vjp_launches"] = got[2]
            if set(got[2]) != {"K3", "K4"}:
                raise AssertionError(f"{name}: KT's VJP launched {got[2]}, expected K3 and K4")
        log(f"  {name} {term}: {row}")
        out[term] = row
        del got, want
    del func
    torch.cuda.empty_cache()
    launches = out["mixed"]["launches"]
    total = {k: sum(c.get(k, 0) for c in launches.values()) for k in ("K3", "K4", "KT")}
    out.update(compile_timing(lambda: learn_mixed(x, filters, level, mode), f"{name} hypergradient step",
                              sum(total.values())))
    log(f"  {name}: hypergradient step device {out['device_ms']!r} ms, events {out['events_ms']!r} ms, "
        f"wall {out['wall_ms']!r} ms")
    return out


def kt_vjp() -> dict:
    """KT's VJP alone (one K3 and one K4 launch) at KT's ``KT_MAIN`` row
    (the headline's level 1 along -2, periodic, 8 taps, float32) against
    autograd through KT's plain version; its two launches' time (``ms``,
    the taps already on the host), the VJP through autograd (events and
    wall, the host read of the cotangent's taps included), its bound and
    that host read alone."""
    name, shape, axis, mode, taps, dtype, _ = KT_MAIN[0]
    x, ct, _ = kt_inputs(shape, axis, mode, taps, dtype)
    ax = axis % x.ndim
    _, period, pad, code = _pallas2._analysis_plan(x.shape[ax], taps, mode)
    c = randn([2, taps], torch.float64, SEED + 2105)
    xl, ctl = leaf(x), leaf(ct)
    out = _pallas2.tap_grad(xl, [ctl[0]], [ctl[1]], ax, taps, period, pad, code)

    def vjp():
        return torch.autograd.grad(out, (xl, ctl), c, retain_graph=True)

    dl, dh = (leaf(randn([taps], dtype, SEED + 2106 + i)) for i in range(2))
    lo, hi = _pallas2.dwt_axis_plain(xl, axis, dl, dh, mode)
    plain_out = torch.autograd.grad((lo * ctl[0]).sum() + (hi * ctl[1]).sum(), (dl, dh), create_graph=True)

    def plain_vjp():
        return torch.autograd.grad(plain_out, (xl, ctl), (c[0].to(dtype), c[1].to(dtype)), retain_graph=True)

    _kernels.reset_launch_counts()
    got = vjp()
    launches = pkt_counts()
    if launches != {"K3": 1, "K4": 1}:
        raise AssertionError(f"KT's VJP launched {launches}, expected one K3 and one K4")
    want = plain_vjp()
    err = max_abs(got, want)
    # over max(1, the largest entry), as the other VJP rows of float32
    check("KT's VJP vs plain", err / max(1.0, max(float(w.abs().max()) for w in want)), TOL[torch.float32])
    nbytes = 2 * (x.numel() + ct.numel()) * x.element_size()
    bound_ms, bound_by = bound(nbytes, 2.0 * taps * (x.numel() + ct.numel()))
    lo_c, hi_c = _kernels.host_taps(c[0]), _kernels.host_taps(c[1])

    def two_launches():  # what the VJP launches, its taps on the host
        _pallas2._analysis_kernel(x, ax, lo_c, hi_c, ct.shape[ax + 1], period, pad, code)
        _pallas2._synthesis_kernel([ct[0]], [ct[1]], ax, lo_c, hi_c, x.shape[ax], pad, False, code, period)

    row = {"shape": list(shape), "launches": launches, "max_abs_err": err, "ms": time_ms(two_launches),
           "plain_ms": time_ms(plain_vjp), "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library_note": "no single call: a convolution and a transposed one",
           "autograd_events_ms": time_ms(vjp), "wall_ms": wall_ms(vjp),
           "host_taps_wall_ms": wall_ms(lambda: _kernels.host_taps(c))}
    log(f"  KT's VJP at {name}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return row


def second_order_times() -> dict:
    """``--second-order-times`` (phase 21, a process of its own): rows
    (a)-(d) in float32 (and :data:`SECOND_F64` in float64), (e) the
    learnable headline, then KT's VJP alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for name, kind, shape, wavelet, level, mode, seed in SECOND_ROWS:
        log(f"  {name}: {list(shape)}, {wavelet}, level {level}, {mode}")
        rows[name] = second_row(name, kind, shape, wavelet, level, mode, seed, torch.float32)
        if name == SECOND_F64:
            rows[f"{name} float64"] = second_row(name, kind, shape, wavelet, level, mode, seed, torch.float64)
    log(f"  {SECOND_LEARN[0]}: {list(SECOND_LEARN[1])}, {SECOND_LEARN[2]}, level {SECOND_LEARN[3]}")
    rows[SECOND_LEARN[0]] = second_learnable()
    return {"rows": rows, "kt_vjp": kt_vjp()}


# ---------------------------------------------------------------------------
# phase 22: the tiled transforms under torch.compile
# ---------------------------------------------------------------------------

#: The row compiled on one rank with inductor besides ``aot_eager``, and
#: under ``mode="reduce-overhead"`` (one rank: no collective runs).
TILED_COMPILE_INDUCTOR = "t2d periodization"
#: One float64 row per kind on one rank, at ``TILED_F64``'s shapes, against
#: the serial float64 plain path.
TILED_COMPILE_F64 = ("t2d reflect", "td1", "td3")
#: Timed calls of each row (after one warm-up: the checks ran it already).
TILED_COMPILE_REPS = 5


def tiled_step(kind: str, wavelet: str, level: int, mode: str, mesh):
    """A row's round trip and the loss, the sum of this rank's squared
    bands: ``(local bands, reconstruction, loss)``, the first two detached
    (the backward runs from the loss alone)."""
    fwd, inv, _, _ = tiled_funcs(kind)

    def step(t):
        coeffs = fwd(t, wavelet, level=level, mesh=mesh, mode=mode)
        rec = inv(coeffs, wavelet, mesh=mesh, mode=mode)
        bands = tiled_leaves(coeffs)
        loss = sum((b.to_local() ** 2).sum() for b in bands)
        return [b.to_local().detach() for b in bands], rec.detach(), loss

    return step


def tiled_timing(run, label: str) -> dict:
    """Device ms (the profiler's busy ms, NCCL's kernels apart: they run on
    their own stream and spin while they wait for the peers), CUDA-event
    ms, wall ms and busy share of one call, NCCL's kernels' ms, and the
    host ms inside the ring's collectives and their waits (the profiler's
    CPU time of ``_c10d_functional`` ops)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ring = 0.0
    device = []
    for evt in prof.key_averages():
        if evt.key.startswith("nccl:"):
            continue  # NCCL's annotation of its own kernel's span, not a second kernel
        if str(evt.device_type).endswith("CUDA"):
            dev = getattr(evt, "self_device_time_total", None)
            device.append(((evt.self_cuda_time_total if dev is None else dev) / 1e3, evt.count, evt.key[:80]))
        elif evt.key.startswith("_c10d_functional::"):
            ring += evt.self_cpu_time_total / 1e3
    device.sort(reverse=True)
    nccl = sum(ms for ms, _, key in device if "nccl" in key.lower())
    busy = sum(ms for ms, _, _ in device) - nccl
    wall = wall_ms(run, warmup=1, reps=TILED_COMPILE_REPS)
    row = {"device_ms": busy, "events_ms": time_ms(run, warmup=1, reps=TILED_COMPILE_REPS), "wall_ms": wall,
           "busy_share": busy / wall, "nccl_ms": nccl, "ring_host_ms": ring}
    log(f"  {label}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
    row["top"] = device[:4]
    log("    top device work: " + "; ".join(f"{ms:.4f} ms x{count} {key}" for ms, count, key in device[:4]))
    return row


def tiled_compile_row(label: str, step, x: torch.Tensor, backend: str, rec_full) -> tuple:
    """One row on this rank, eager and compiled (``fullgraph=True``, static
    shapes, ``backend``): graph breaks and graphs, launches by kernel of the
    round trip, compiled against eager (bands and reconstruction over
    ``max(1, |leaf|)``; the gradient of the loss: its error and this rank's
    largest entry, for the caller to divide), the round trip against ``x``
    (``rec_full`` gathers the reconstruction) and compile seconds.  Returns
    the row and a function that adds its times, eager and compiled, for
    the caller to run once the host is quiet.  Every rank of a mesh calls
    both in step, so that the collectives meet."""
    from torch._dynamo.utils import counters

    xr = leaf(x)
    want_bands, want_rec, want_loss = step(xr)
    (want_grad,) = torch.autograd.grad(want_loss, xr)
    _, eager = counted(step, xr)
    counters.clear()
    compiled = torch.compile(step, fullgraph=True, dynamic=False, backend=backend)
    t0 = time.perf_counter()
    compiled(xr)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    breaks = sum(counters["graph_break"].values())
    graphs = counters["stats"]["unique_graphs"]
    xr = leaf(x)
    (bands, rec, loss), launches = counted(compiled, xr)
    (grad,) = torch.autograd.grad(loss, xr)
    err = compile_err([*bands, rec.to_local()], [*want_bands, want_rec.to_local()])
    full = rec_full(rec).to(x.device)
    round_trip = max_abs(full[tuple(map(slice, x.shape))], x)
    row = {"backend": backend, "graph_breaks": breaks, "graphs": graphs, "compile_s": compile_s,
           "launches": launches, "eager_launches": eager, "err": err, "round_trip_err": round_trip,
           "grad_err": max_abs(grad, want_grad), "grad_scale": float(want_grad.abs().max())}
    log(f"  {label}: {backend} compile {compile_s!r} s, graph breaks {breaks}, graphs {graphs}, launches "
        f"{launches} (eager {eager}), err {err!r}, round trip {round_trip!r}, gradient {row['grad_err']!r} of "
        f"{row['grad_scale']!r}")
    if breaks or graphs != 1 or launches != eager or not eager:
        raise AssertionError(f"{label}: {breaks} graph breaks, {graphs} graphs, launches {launches} (eager {eager})")
    check(f"{label} compiled vs eager (relative)", err, COMPILE_TOL)
    check(f"{label} compiled round trip vs input", round_trip,
          ROUND_TRIP_TOL if x.dtype == torch.float32 else TOL[x.dtype])
    del want_bands, want_rec, want_grad, bands, rec, grad, full

    def times() -> None:
        row["eager"] = tiled_timing(lambda: step(xr), f"{label} eager")
        row["compiled"] = tiled_timing(lambda: compiled(xr), f"{label} compiled ({backend})")

    return row, times


def tiled_round_trip_launches(name: str, world: int) -> dict:
    """``TILED_LAUNCHES``' forward and inverse of a row, summed: one rank's
    launches in one round trip."""
    fwd, inv = TILED_LAUNCHES[name][world]
    return {k: fwd.get(k, 0) + inv.get(k, 0) for k in {*fwd, *inv}}


def tiled_compile_grad(label: str, rows: list) -> float:
    """The compiled gradient against eager's over its largest entry, from
    every rank's ``(grad_err, grad_scale)``."""
    return check(f"{label} compiled gradient vs eager (of the largest entry)",
                 max(r["grad_err"] for r in rows) / max(r["grad_scale"] for r in rows), TRAIN_GRAD_TOL)


def tiled_reduce_overhead(step, x: torch.Tensor, want) -> tuple:
    """The one-rank round trip (no collective, no grad) compiled with
    inductor's ``mode="reduce-overhead"``: no cudagraph skip, the output
    against eager, compile seconds; and a function that adds its times."""
    from torch._dynamo.utils import counters

    counters.clear()
    compiled = torch.compile(lambda t: step(t)[1].to_local(), fullgraph=True, dynamic=False, mode="reduce-overhead")
    t0 = time.perf_counter()
    compiled(x)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    for _ in range(2):  # cudagraph trees record on a later call
        got = compiled(x)
    torch.cuda.synchronize()
    err = compile_err(got, want)
    skips = dict(counters["inductor"]).get("cudagraph_skips", 0)
    log(f"  {TILED_COMPILE_INDUCTOR} reduce-overhead: compile {compile_s!r} s, err {err!r}, cudagraph_skips {skips}")
    if skips:
        raise AssertionError(f"reduce-overhead: {skips} cudagraph skips: {dict(counters['inductor'])}")
    check(f"{TILED_COMPILE_INDUCTOR} reduce-overhead vs eager (relative)", err, COMPILE_TOL)
    row = {"compile_s": compile_s, "err": err, "cudagraph_skips": skips}

    def times() -> None:
        row.update(tiled_timing(lambda: compiled(x), f"{TILED_COMPILE_INDUCTOR} reduce-overhead"))

    return row, times


def tiled_compile_one_rank(ready: "Path | None" = None, go: "Path | None" = None) -> dict:
    """Phase 22 (a): every ``TILED_FULL`` row on one NCCL rank, no
    collective, ``aot_eager`` (t2d periodization also inductor and
    reduce-overhead); one float64 row per kind against the serial float64
    plain path; then the rows' times, after the file ``ready`` appears (the
    four ranks of (b) compile meanwhile and wait), and ``go`` written
    after them (the ranks then time theirs)."""
    out, times = {}, []
    with tiled_world("nccl", 0, 1, tiled_store("compile")), no_p2p():
        for i, (name, kind, shape, wavelet, level, mode, kw) in enumerate(TILED_FULL):
            mesh = tiled_mesh(1, kw)
            x = randn(shape, torch.float32, SEED + 2200 + i)
            step = tiled_step(kind, wavelet, level, mode, mesh)
            backends = ("aot_eager", "inductor") if name == TILED_COMPILE_INDUCTOR else ("aot_eager",)
            for backend in backends:
                label = f"(a) {name} one rank"
                row, row_times = tiled_compile_row(label, step, x, backend, lambda r: r.full_tensor())
                only(row["launches"], tiled_round_trip_launches(name, 1), f"{label} compiled round trip")
                row["grad_rel_err"] = tiled_compile_grad(label, [row])
                out[f"{name} {backend}"] = row
                times.append(row_times)
            if name == TILED_COMPILE_INDUCTOR:
                with torch.no_grad():
                    want = step(x)[1].to_local()
                out[f"{name} reduce-overhead"], row_times = tiled_reduce_overhead(step, x, want)
                times.append(row_times)
        for i, (name, kind, shape, wavelet, level, mode) in enumerate(TILED_F64):
            if name not in TILED_COMPILE_F64:
                continue
            mesh = tiled_mesh(1, {"n_data": 1, "n_spatial": 1})
            x = randn(shape, torch.float64, SEED + 2230 + i)
            compiled = torch.compile(tiled_step(kind, wavelet, level, mode, mesh), fullgraph=True, dynamic=False,
                                     backend="aot_eager")
            bands, rec, _ = compiled(x)
            with plain_versions():
                want, want_rec = tiled_serial(kind, x, wavelet, level, mode)
            out[f"{name} float64"] = {
                "band_err": check(f"(a) {name} float64 {list(shape)} compiled vs the serial plain path", max_abs(bands, want),
                                  TOL[torch.float64]),
                "rec_err": check(f"(a) {name} float64 compiled reconstruction vs the serial plain path",
                                 max_abs(rec.full_tensor(), want_rec), TOL[torch.float64]),
            }
            del x, bands, rec, want, want_rec
        if ready is not None:
            tiled_wait(ready)
        log("  (a) times, one rank (the four ranks of (b) wait)")
        for row_times in times:
            row_times()
    if go is not None:
        go.touch()
    torch._dynamo.reset()
    torch.cuda.empty_cache()
    return out


def tiled_wait(path: Path) -> None:
    """Wait for another process to write ``path``, within the ranks' deadline."""
    deadline = time.monotonic() + TILED_RANKS_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {TILED_RANKS_S} s")
        time.sleep(0.2)


def tiled_compile_rank(rank: int, world: int, store: Path, outdir: Path, backend: str = "gloo",
                       handshake: bool = False) -> None:
    """``--tiled-compile-rank R``: one of phase 22 (b)'s ranks (gloo: every
    rank on card 0, the ring's slabs through host memory; NCCL: rank R on
    card R).  Every ``TILED_FULL`` row on the four-rank mesh, eager and
    compiled with ``aot_eager``; rank 0 gathers every rank's row and checks
    the launches against ``TILED_LAUNCHES`` and the gradient.  Then the
    rows' times; with ``handshake`` (``--handshake``) rank 0 first writes
    ``OUT/ready`` and every rank waits for ``OUT/go``, so that phase 22 (a)
    compiles beside these ranks but times alone, and they after it."""
    global DEVICE
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    if backend == "nccl":
        DEVICE = torch.device("cuda", rank)
    # every row's compiled step is kept until its times (one code object)
    torch._dynamo.config.recompile_limit = 64
    out, times = {}, []
    with tiled_world(backend, rank, world, store):
        meshes = {}
        for i, (name, kind, shape, wavelet, level, mode, kw) in enumerate(TILED_FULL):
            key = json.dumps(kw, sort_keys=True)
            if key not in meshes:
                mesh = tiled_mesh(world, kw)
                groups = [mesh.get_group(n) for n in mesh.mesh_dim_names]
                meshes[key] = (mesh, DeviceMesh.from_group(groups, "cpu", mesh=mesh.mesh,
                                                           mesh_dim_names=mesh.mesh_dim_names)
                               if backend == "gloo" else None)
            mesh, cpu_mesh = meshes[key]
            x = randn(shape, torch.float32, SEED + 2200 + i)  # the whole tensor, on every rank
            label = f"(b) {name} rank {rank} of {world} {backend}"
            row, row_times = tiled_compile_row(label, tiled_step(kind, wavelet, level, mode, mesh), x, "aot_eager",
                                               lambda r, cpu_mesh=cpu_mesh: full_of(r, cpu_mesh))
            rows = [None] * world
            dist.all_gather_object(rows, row)
            if rank == 0:
                for r, each in enumerate(rows):
                    only(each["launches"], tiled_round_trip_launches(name, world), f"{name} rank {r} compiled round trip")
                out[name] = {"grad_rel_err": tiled_compile_grad(f"(b) {name} {world} {backend} ranks", rows)}
            times.append((name, row, row_times))
        if handshake:
            dist.barrier()
            if rank == 0:
                (outdir / "ready").touch()
            tiled_wait(outdir / "go")
        dist.barrier()
        for name, row, row_times in times:
            row_times()
            rows = [None] * world
            dist.all_gather_object(rows, row)
            if rank == 0:
                out[name]["per_rank"] = rows
    (outdir / f"rank{rank}.json").write_text(json.dumps(out))


def tiled_compile_times() -> dict:
    """``--tiled-compile-times`` (phase 22, a process of its own): (a) one
    NCCL rank in this process and (b) four gloo ranks sharing the card,
    compiling side by side; (a) times its rows while (b)'s ranks wait,
    then (b) times its rows."""
    torch._dynamo.config.recompile_limit = 64  # every row's step is kept until its times
    log("  (b) four ranks sharing the card, gloo, the ring's slabs through host memory: started beside (a)")
    procs, outdir, deadline = tiled_spawn(4, "gloo", "--tiled-compile-rank", "--handshake")
    try:
        out = {"one_rank": tiled_compile_one_rank(outdir / "ready", outdir / "go")}
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    out["four_ranks"] = tiled_collect(procs, outdir, deadline)
    return out


# ---------------------------------------------------------------------------
# phase 23: torch.compile over torch.func
# ---------------------------------------------------------------------------

#: Phase 23's row also compiled with inductor (the others: ``aot_eager``).
FUNC_INDUCTOR = "2d periodic grad of grad"
#: Compiled against eager ``torch.func`` on the card, over the result's
#: largest entry; against the float64 plain path: phase 21's limit.
FUNC_TOL = COMPILE_TOL
#: Seconds phase 23's process may take (some 160 s alone on an H100; the
#: script's limit is 1200).
FUNC_TIMEOUT_S = 300
#: Phase 23's rows whose step phase 21 times under eager autograd (for
#: the learnable bank: the mixed term), by phase 21's name.
FUNC_PHASE21 = {**{f"{r[0]} grad of grad": r[0] for r in SECOND_ROWS}, f"{SECOND_LEARN[0]} mixed": SECOND_LEARN[0]}


def func_rows() -> list:
    """Phase 23's rows over phase 21's: ``(name, program, args)``, each
    program a ``torch.func`` composition of the kernel path, float32:
    (a) ``torch.func.grad`` of the periodic headline's ``L`` (the cubed
    coefficients), (d) ``torch.func.vmap`` of it over the headline's batch
    split into samples, (b) grad of grad (phase 21's penalty step) at every
    :data:`SECOND_ROWS` row, (c) the learnable headline's mixed and pure
    hypergradients (:func:`learn_func`'s programs)."""
    grad = torch.func.grad
    name, kind, shape, wavelet, level, mode, seed = SECOND_ROWS[0]
    loss = second_loss(kind, wavelet, level, mode)
    rows = [(f"{name} grad", lambda: (grad(loss), (randn(shape, torch.float32, seed),))),
            (f"{name} vmap of grad",
             lambda: (torch.func.vmap(grad(loss)), (randn(shape, torch.float32, seed).unsqueeze(1),)))]
    for name, kind, shape, wavelet, level, mode, seed in SECOND_ROWS:
        def make(kind=kind, shape=shape, wavelet=wavelet, level=level, mode=mode, seed=seed):
            lss = second_loss(kind, wavelet, level, mode)
            return grad(lambda t: (grad(lss)(t) ** 2).sum()), (randn(shape, torch.float32, seed),)

        rows.append((f"{name} grad of grad", make))
    name, shape, wavelet, level, mode, seed = SECOND_LEARN
    for term in ("mixed", "pure"):
        def make(term=term):
            x = randn(shape, torch.float32, seed)
            filters = [f.detach() for f in learn_bank(wavelet, torch.float32, DEVICE).filter_bank]
            loss = learn_loss_cubed(filters, level, mode)
            if term == "mixed":
                return grad(lambda fs: (grad(loss, argnums=1)(fs, x) ** 2).sum()), (list(filters[:2]),)
            return grad(lambda fs: sum((g**2).sum() for g in grad(loss)(fs, x))), (list(filters[:2]),)

        rows.append((f"{name} {term}", make))
    return rows


def func_double(args):
    """A row's arguments in float64, for the plain path's reference."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.double() if isinstance(t, torch.Tensor) else t, args)


def func_row(name: str, make, backend: str) -> dict:
    """One row: the program eager (``torch.func`` on the kernel path) and
    under ``torch.compile(fullgraph=True, backend=backend)``: one graph,
    no break, the same launches per kernel, within :data:`FUNC_TOL` of
    eager and of the float64 plain path; compile seconds and the compiled
    program's times, and eager ``torch.func``'s where phase 21 times no
    eager step of the row."""
    from torch._dynamo.utils import counters

    program, args = make()
    want, eager = counted(program, *args)
    torch._dynamo.reset()
    counters.clear()
    compiled = torch.compile(program, fullgraph=True, dynamic=False, backend=backend)
    t0 = time.perf_counter()
    compiled(*args)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    got, launches = counted(compiled, *args)
    breaks, graphs = sum(counters["graph_break"].values()), counters["stats"]["unique_graphs"]
    err = compile_rel(got, want)
    log(f"  {name} ({backend}): compile {compile_s!r} s, {graphs} graph(s), {breaks} break(s), "
        f"launches {launches} (eager torch.func {eager}), compiled vs eager {err!r}")
    if breaks or graphs != 1:
        raise AssertionError(f"{name}: {breaks} graph breaks, {graphs} graphs: {dict(counters['graph_break'])}")
    if launches != eager or not eager:
        raise AssertionError(f"{name}: compiled launches {launches}, eager torch.func {eager}")
    if not err <= FUNC_TOL:
        raise AssertionError(f"{name}: compiled against eager {err!r} > {FUNC_TOL!r}")
    del want
    with plain_versions():
        ref = program(*func_double(args))
    plain_err = second_check(name, "compiled float32 kernels vs the float64 plain path", compile_rel(got, ref),
                             torch.float32)
    del got, ref
    torch.cuda.empty_cache()
    total = sum(launches.values())
    row = {"backend": backend, "compile_s": compile_s, "graphs": graphs, "graph_breaks": breaks,
           "launches": launches, "err_vs_eager": err, "err_vs_plain_f64": plain_err,
           "compiled": compile_timing(lambda: compiled(*args), f"{name} compiled ({backend})", total)}
    if name not in FUNC_PHASE21:
        row["eager_func"] = compile_timing(lambda: program(*args), f"{name} eager torch.func", total)
    for tag in [t for t in ("compiled", "eager_func") if t in row]:
        t = row[tag]
        log(f"  {name} {tag}: device {t['device_ms']!r} ms, events {t['events_ms']!r} ms, wall {t['wall_ms']!r} ms, "
            f"busy {t['busy_share']!r}")
    del compiled, program, args
    torch._dynamo.reset()
    torch.cuda.empty_cache()
    return row


def compiled_func_times() -> dict:
    """``--compiled-func-times`` (phase 23, a process of its own): every
    :func:`func_rows` row compiled with ``aot_eager``, then
    :data:`FUNC_INDUCTOR` with inductor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = func_rows()
    out = {name: func_row(name, make, "aot_eager") for name, make in rows}
    out[f"{FUNC_INDUCTOR} inductor"] = func_row(FUNC_INDUCTOR, dict(rows)[FUNC_INDUCTOR], "inductor")
    return {"rows": out}


def copy_bandwidth() -> float:
    """Device-to-device copy rate in GB/s (bytes read + bytes written)."""
    src = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src))
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


#: When ``main`` started, for :func:`phase`.
_T0 = time.perf_counter()


def phase(msg: str) -> None:
    """Log a phase's heading with the seconds since ``main`` started."""
    log(f"{msg} [{time.perf_counter() - _T0:.0f} s]")


def main() -> int:
    global _T0
    _T0 = time.perf_counter()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs one GPU")
        return 1
    # exact float32: no TF32 in the library yardsticks or in K9's plain
    # versions (the package's kernel path runs no matmul or convolution)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 3-11 check the default routes; phase 12 sets the K9 opt-in
    if os.environ.pop(MXU2D_ENV, None) is not None:
        log(f"{MXU2D_ENV} unset for phases 3-11")
    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    # pyramid2d.cu (K5, 36 instances) builds longest: it builds behind
    # phases 3-8, which launch none of its kernels
    pool = concurrent.futures.ThreadPoolExecutor(1)
    late = pool.submit(_kernels.build, ("pyramid2d",))
    seconds = _kernels.build(tuple(s for s in _kernels.SOURCES if s != "pyramid2d"))
    log(f"build: {seconds} (wall {time.perf_counter() - t0:.1f} s); pyramid2d builds behind phases 3-8")

    phase("phase 3: kernels against their plain versions")
    errors = {k: {} for k in (*REPLACES, *VJP_ROWS)}
    check_kernels(errors)
    phase("phase 3b: VJP kernels against their plain versions")
    check_vjps(errors)
    phase("phase 3b: K1/K2 tiles at level 4, haar and coif17 (float64), an odd periodization image")
    check_tiles(errors)

    phase("phase 4: main path")
    x = randn(SHAPE, torch.float32, SEED)
    results = {mode: main_path(x, mode) for mode in ("periodic", "reflect")}
    per = results["periodic"]["counts"]
    for name in ("K1", "K2", "K3", "K4"):
        if per[name] < 1:
            raise AssertionError(f"{name} was not launched by the periodic round trip")
    for name in ("K3", "K4"):
        if results["reflect"]["counts"][name] < 1:
            raise AssertionError(f"{name} was not launched by the reflect round trip")

    phase("phase 5: times")
    gbps = copy_bandwidth()
    log(f"  device copy: {gbps!r} GB/s")
    rows, rows4 = time_kernels(gbps)
    mpix = SHAPE[0] * SHAPE[1] * SHAPE[2] / 1e6
    for mode in ("periodic", "reflect"):
        ms = wall_ms(
            lambda: ptwt.waverec2(
                ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL), WAVELET, mode=mode
            )
        )
        log(f"  round trip {mode}: {ms!r} ms, {mpix / (ms * 1e-3)!r} Mpix/s")
    profile(
        lambda: ptwt.waverec2(
            ptwt.wavedec2(x, WAVELET, mode="periodic", level=LEVEL), WAVELET, mode="periodic"
        ),
        "periodic round trip",
    )
    del x
    phase(f"phase 5: each K3/K4 launch and VJP at the {REFLECT_1} level 1 and the periodic level 2")
    axis_rows = axis_times(full=True)
    for name, row in axis_rows.items():
        log(f"  {name}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
    reflect_dev = reflect_device_ms()
    log(f"  {REFLECT_1} device time: {reflect_dev}")
    if reflect_dev["round_trip_index_kernels"] or reflect_dev["step_index_kernels"]:
        raise AssertionError(f"gather or scatter kernels on the {REFLECT_1} path: {reflect_dev}")
    axis_turns = {}
    if _arg("--parent"):
        phase(f"phase 5: the K3/K4 rows and the {REFLECT_1} device times in turns with {_arg('--parent')}")
        torch.cuda.empty_cache()
        axis_turns = turns(Path(_arg("--parent")).resolve(), "--axis-times")

    phase("phase 6: training at full width")
    y = randn(SHAPE, torch.float32, SEED + 41)
    train = {mode: check_training(mode, y) for mode in ("periodic", "reflect")}
    for mode in ("periodic", "reflect"):
        # each launch of the round trip has one VJP launch of its twin
        want = {VJP_OF[k]: v for k, v in results[mode]["counts"].items() if v}
        check_backward(mode, train[mode]["backward"], want)
    gathers = [key for _, _, key in train["reflect"]["profile"] if index_kernel(key)]
    if gathers:
        raise AssertionError(f"gather or scatter kernels in the reflect step: {gathers}")
    log("  reflect training step: no index_select / index_add kernels")

    phase("phase 7: 1d kernels against their plain versions")
    errors_1d = {name: {} for name in (*KERNELS_1D, *(f"{k} VJP" for k in KERNELS_1D))}
    check_kernels_1d(errors_1d)
    phase("phase 7: the K7/K8 VJP instances against their plain versions")
    check_vjps_1d(errors_1d)
    phase("phase 7: an odd-length bank leaves K6-K8 for the per-level route")
    check_odd_bank(ODD_BANK_1D, (*KERNELS_1D,), "1d")

    phase("phase 8: 1d main path")
    main_1d = {
        name: main_path_1d(name, shape, mode, level, must, SEED + 70 + i)
        for i, (name, shape, mode, level, must) in enumerate(MAIN_1D)
    }
    launches_1d = {
        "K8a": main_1d["d1 periodic"]["counts"]["K8a"],
        "K8b": main_1d["d1 periodic"]["counts"]["K8b"],
        "K6a": main_1d["K6 periodization"]["counts"]["K6a"],
        "K6b": main_1d["K6 periodization"]["counts"]["K6b"],
        "K7a": main_1d["K7 reflect level 1"]["counts"]["K7a"],
        "K7b": main_1d["K7 reflect level 1"]["counts"]["K7b"],
    }

    phase("phase 5, 1d: times")
    rows_1d = time_kernels_1d()
    round_trips_1d()
    turns_1d = {}
    if _arg("--parent"):
        phase(f"phase 5, 1d: every fwt1d.cu instance and the 1d VJPs in turns with {_arg('--parent')}")
        torch.cuda.empty_cache()
        turns_1d = fwt1d_turns(Path(_arg("--parent")).resolve())

    seconds.update(late.result())
    pool.shutdown()
    log(f"build: {seconds} (pyramid2d done at {time.perf_counter() - t0:.1f} s)")
    for log_file in sorted(_kernels.BUILD_DIR.glob("*.log")):
        log(f"ptxas {log_file.name}: " + " | ".join(
            line.strip() for line in log_file.read_text().splitlines() if "registers" in line or "spill" in line
        ))
    phase("phase 3: the repo's frozen 2d goldens (periodization among them runs K5)")
    check_goldens()

    phase("phase 9: K5a/K5b and their VJPs against their plain versions")
    errors_k5 = {name: {} for name in (*KERNELS_K5, "K5a VJP", "K5b VJP")}
    check_k5(errors_k5)
    phase("phase 9: an odd-length bank leaves K5 (and K1/K2) for the per-axis route")
    check_odd_bank(ODD_BANK_2D, (*KERNELS_K5, "K1", "K2"), "2d")

    phase("phase 10: 2d periodization main path")
    main_per = {
        name: main_path_per(name, shape, level, SEED + 200 + i)
        for i, (name, shape, level) in enumerate(PER_2D)
    }

    phase("phase 11: training through the 2d periodization and 1d configurations")
    train_per = {}
    for i, (name, shape, level) in enumerate(PER_2D):
        target = y if shape == SHAPE else randn(shape, torch.float32, SEED + 43 + i)
        res = check_training(
            f"periodization {name}", target,
            make=lambda shape=shape, level=level: GainModel("periodization", shape, level),
            with_profile=name == "headline",
        )
        allowed = KERNELS_K5 if main_per[name]["runs"] else ("K1", "K2")
        check_backward(f"periodization {name}", res["backward"], allowed)
        train_per[name] = res
    del y
    train_1d = {}
    for i, (name, shape, mode, level, allowed) in enumerate(TRAIN_1D):
        target = randn(shape, torch.float32, SEED + 210 + i)
        res = check_training(
            name, target,
            make=lambda shape=shape, mode=mode, level=level: GainModel1d(mode, shape, level),
            with_profile=False,
        )
        check_backward(name, res["backward"], allowed)
        train_1d[name] = res
        del target

    phase("phase 5, 2d periodization and the pyramid VJPs: times")
    rows_k5 = time_k5()
    round_trips_per()
    turns_k5 = {}
    if _arg("--parent"):
        phase(f"phase 5: K5, its VJPs, the per-level route and the periodization device times in turns with {_arg('--parent')}")
        torch.cuda.empty_cache()
        turns_k5 = turns(Path(_arg("--parent")).resolve(), "--k5-times")
    vjp_1d = time_vjps_1d()

    phase(f"phase 12: the tensor-core level K9a/K9b ({MXU2D_ENV}=1 inside this phase only)")
    errors_k9 = {name: {} for name in (*KERNELS_K9, "K9a VJP", "K9b VJP")}
    with mxu2d_opt_in():
        check_k9(errors_k9)
        phase(f"phase 12: each K9 instance at {[list(c[0]) + [c[1], c[2]] for c in K9_EXTRA]}")
        check_k9_launches(errors_k9)
        x = randn(SHAPE, torch.float32, SEED)
        main_k9 = main_path(x, "periodic")
        del x
        counts = main_k9["counts"]
        want = {**{k: v for k, v in per.items() if v}, "K1": per["K1"] - 1, "K2": per["K2"] - 1, "K9a": 1, "K9b": 1}
        only(counts, {k: v for k, v in want.items() if v}, "the opt-in periodic round trip")
        y = randn(SHAPE, torch.float32, SEED + 41)
        train_k9 = check_training("periodic opt-in", y, make=lambda: GainModel("periodic"), with_profile=False)
        del y
        check_backward("periodic opt-in", train_k9["backward"], ("K1", "K2", "K3", "K4", "K9a", "K9b"))
        phase("phase 5, K9: times")
        rows_k9 = time_k9()
        tf32_one_pass = one_pass_tf32()
    phase(f"phase 5, K9: K9 and the K1/K2 route at {[name for name, _ in K9_SHAPES]}, the round trips")
    k9_rows = k9_times()
    for name, value in k9_rows.items():
        log(f"  {name}: {value!r}")
    turns_k9 = {}
    if _arg("--parent"):
        phase(f"phase 5: K9, its VJPs, the K1/K2 route and the opt-in round trip in turns with {_arg('--parent')}")
        torch.cuda.empty_cache()
        turns_k9 = turns(Path(_arg("--parent")).resolve(), "--k9-times")
    if os.environ.get(MXU2D_ENV) == "1":
        raise AssertionError(f"{MXU2D_ENV} leaked out of phase 12")

    phase(f"phase 13: launches past 2^31 outputs, {list(BIG)} float32")
    check_past_2_31()

    phase("phase 14: the 3d and separable main paths (bench.py's d3 and fs2 rows)")
    nd = check_nd()

    phase("phase 15: the stationary and matrix transforms (bench.py's mat1d, mat2d and swt rows)")
    errors_ss = {}
    mat = check_mat(errors_ss)

    phase("phase 16: the wavelet packet trees and the continuous transform (bench.py's wp2d and cwt rows)")
    pkt = check_pkt()
    print(json.dumps({"packets_cwt": pkt}))

    phase("phase 17: learnable filter banks (K3/K4 per axis, the taps' gradient on KT)")
    learn = check_learn()
    print(json.dumps({"learnable": {k: v for k, v in learn.items() if k != "errors"}}))

    phase("phase 18: the tiled multi-device transforms (ptwt_tpu_torch.parallel), K3/K4 and K7 per rank")
    tiled = check_tiled()
    print(json.dumps({"tiled": tiled}))

    phase('phase 19: the reduced-precision mode ("high", "default"): the dense-operator route')
    precision = {name: times_process("--prec-times", name) for name in (*(r[0] for r in PREC_ROWS), "conv")}
    print(json.dumps({"precision": precision}))

    phase("phase 20: torch.compile, torch.func.grad and torch.func.vmap through the ops of the kernels")
    compiled = times_process("--compile-times", timeout=900)
    print(json.dumps({"compile": compiled}))

    phase("phase 21: second derivatives under eager autograd and torch.func at full width")
    second = times_process("--second-order-times")
    print(json.dumps({"second_order": second}))

    phase("phase 22: the tiled transforms under torch.compile (ring steps and edge sums as functional collectives)")
    tiled_compile = times_process("--tiled-compile-times", timeout=900)
    print(json.dumps({"tiled_compile": tiled_compile}))

    phase("phase 23: torch.compile over torch.func (grad, grad of grad, vmap of grad) through the ops of the kernels")
    func = times_process("--compiled-func-times", timeout=FUNC_TIMEOUT_S)
    for name, row in func["rows"].items():
        base = FUNC_PHASE21.get(name.removesuffix(" inductor"))
        if base is not None:  # phase 21's eager autograd step of the same row
            row["phase21_eager"] = {k: second["rows"][base][k] for k in ("device_ms", "events_ms", "wall_ms",
                                                                         "busy_share")}
    print(json.dumps({"compiled_func": func}))

    kernels = []
    for name in ("K1", "K2", "K3", "K4"):
        source, replaces = REPLACES[name]
        row, vjp = rows[name], rows[f"{name} VJP"]
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # per headline round trip; VJPs: per periodic training step
            "launches": per[name],
            "max_abs_err": errors[name][torch.float32],
            "max_abs_err_f64": errors[name][torch.float64],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "copy_bound_ms": row["copy_bound_ms"],
            "vjp_kernel": VJP_OF[name],
            "vjp_launches": train["periodic"]["backward"][VJP_OF[name]],
            "vjp_max_abs_err": errors[f"{name} VJP"][torch.float32],
            "vjp_max_abs_err_f64": errors[f"{name} VJP"][torch.float64],
            "vjp_ms": vjp["ms"],
            "vjp_plain_ms": vjp["plain_ms"],
            "vjp_bound_ms": vjp["bound_ms"],
            "vjp_library_ms": vjp["library_ms"],
        }
        if name in ("K1", "K2"):
            # ms is level 1's; the headline runs each of K1/K2 once at level
            # 1 (1024^2 <-> 4 x 515^2) and once at level 4 (134^2 <-> 4 x 70^2)
            row4, vjp4 = rows4[name], rows4[f"{name} VJP"]
            entry.update(
                ms_level4=row4["ms"],
                plain_ms_level4=row4["plain_ms"],
                bound_ms_level4=row4["bound_ms"],
                library_ms_level4=row4["library_ms"],
                ms_per_round_trip=row["ms"] + row4["ms"],
                bound_ms_per_round_trip=row["bound_ms"] + row4["bound_ms"],
                vjp_ms_level4=vjp4["ms"],
                vjp_plain_ms_level4=vjp4["plain_ms"],
                vjp_bound_ms_level4=vjp4["bound_ms"],
                vjp_library_ms_level4=vjp4["library_ms"],
                vjp_ms_per_step=vjp["ms"] + vjp4["ms"],
            )
        else:
            # ms and vjp_ms: one 2d level of two launches (the periodic
            # level 2, [16, 515, 515]); per_launch: one axis pass each at
            # the reflect level 1 and the periodic level 2
            def mine(k: str, name=name) -> bool:
                # K3 also carries the gather rows and the reflect device times
                return k.startswith(f"{name} ") or (name == "K3" and (k.startswith("gather") or "_ms" in k))

            entry.update(
                ms_is="one 2d level of two launches, periodic level 2",
                vjp_replaces=VJP_REPLACES[name],
                launches_reflect=results[REFLECT_1]["counts"][name],
                vjp_launches_reflect=train[REFLECT_1]["backward"][VJP_OF[name]],
                per_launch={k: v for k, v in axis_rows.items() if mine(k)},
                reflect_device_ms=reflect_dev,
            )
            if axis_turns:
                entry["in_turns"] = {k: v for k, v in axis_turns.items() if mine(k) or (name == "K3" and "index" in k)}
            # phase 14: per round trip and per backward of the d3 and fs2
            # rows, their times, and d3's level-1 launches beside their bound
            entry["nd_main_paths"] = {
                row: {
                    "launches": nd[row]["forward" if name == "K3" else "inverse"],
                    "vjp_launches": nd[row]["backward"][VJP_OF[name]],
                    **nd[row]["times"],
                }
                for row, *_ in ND_FULL
            }
            entry["d3_level1"] = {
                k: v for k, v in nd["d3"]["level1"].items() if k.startswith(name) or (name == "K4" and "route" in k)
            }
            # phase 16: per full expansion / reconstruct() of wp2d, its
            # backward, and the separable tree
            entry["wp2d"] = {
                "launches": pkt["wp2d"]["forward" if name == "K3" else "inverse"][name],
                "vjp_launches": pkt["wp2d"]["backward"][VJP_OF[name]],
                "launches_separable": pkt["wp2d separable"]["forward" if name == "K3" else "inverse"][name],
            }
            # phase 18: each tiled row's launches, one rank and four
            entry["tiled_launches"] = tiled_kernel_launches(tiled, name)
        kernels.append(entry)
    vjp_kernel = {"K5a": "K5b", "K5b": "K5a", "K6a": "K6b", "K6b": "K6a",
                  "K7a": "K7b", "K8a": "K8b", "K7b": "K7a", "K8b": "K8a"}
    per_back = train_per["headline"]["backward"]
    for name in KERNELS_K5:
        source, replaces = REPLACES[name]
        row, small = rows_k5[name]["headline"], rows_k5[name]["small"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # per round trip of the headline periodization configuration
            "launches": main_per["headline"]["counts"][name],
            "max_abs_err": errors_k5[name][torch.float32]["abs"],
            "max_abs_err_f64": errors_k5[name][torch.float64]["abs"],
            "rel_err": errors_k5[name][torch.float32]["rel"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "library_note": row["library_note"],
            "per_level_k1_k2_ms": row["per_level_ms"],
            "per_level_ms": row["per_level_ms"],
            "runs": row["runs"],
            "small": {
                "shape": list(SMALL_SHAPE),
                "launches": main_per["small"]["counts"][name],
                "ms": small["ms"],
                "plain_ms": small["plain_ms"],
                "per_level_k1_k2_ms": small["per_level_ms"],
                "per_level_ms": small["per_level_ms"],
                "bound_ms": small["bound_ms"],
                "vjp_ms": small["vjp_ms"],
                "vjp_bound_ms": small["bound_ms"],
                "runs": small["runs"],
            },
            "in_turns": {k: v for k, v in turns_k5.items() if k.startswith(name) or " busy " in k or " K5 ms " in k
                         or " wall ms " in k or k.startswith("K1 x" if name == "K5a" else "K2 x")
                         or k.startswith("launches")},
            "vjp_kernel": vjp_kernel[name],
            "vjp_launches": per_back[vjp_kernel[name]],
            "vjp_max_abs_err": errors_k5[f"{name} VJP"][torch.float32]["abs"],
            "vjp_max_abs_err_f64": errors_k5[f"{name} VJP"][torch.float64]["abs"],
            "vjp_ms": row["vjp_ms"],
            "vjp_plain_ms": row["vjp_plain_ms"],
            "vjp_bound_ms": row["bound_ms"],
            "vjp_library_ms": None,
        })
    # VJP launches per backward of each 1d kernel's configuration: one
    # launch of the other pyramid kernel per fused run
    cfg_1d = {"K8a": "d1 periodic", "K8b": "d1 periodic", "K6a": "K6 periodization",
              "K6b": "K6 periodization", "K7a": "K7 reflect level 1", "K7b": "K7 reflect level 1"}
    for name in KERNELS_1D:
        source, replaces = REPLACES[name]
        row = rows_1d[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # per round trip of its configuration in phase 8
            "launches": launches_1d[name],
            "max_abs_err": errors_1d[name][torch.float32]["abs"],
            "max_abs_err_f64": errors_1d[name][torch.float64]["abs"],
            "rel_err": errors_1d[name][torch.float32]["rel"],
            "rel_err_f64": errors_1d[name][torch.float64]["rel"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_note": row["library_note"],
        }
        if "per_level_ms" in row:
            entry["per_level_k3_k4_ms"] = row["per_level_ms"]
        cfg = cfg_1d[name]
        back = train_1d[cfg]["backward"][vjp_kernel[name]]
        vjp = vjp_1d[name]
        entry.update(
            vjp_kernel=vjp_kernel[name],
            vjp_launches=back,
            vjp_max_abs_err=vjp["vjp_max_abs_err"],
            vjp_rel_err=vjp["vjp_rel_err"],
            vjp_ms=vjp["vjp_ms"],
            vjp_plain_ms=vjp["vjp_plain_ms"],
            vjp_bound_ms=row["bound_ms"],
            vjp_library_ms=None,
            training_step_ms=train_1d[cfg]["step_ms"],
        )
        if name == "K8a":
            entry["vjp_ms_reflect"] = vjp_1d["K8a reflect"]["vjp_ms"]
            entry["vjp_direct_ms_reflect"] = vjp_1d["K8a reflect"]["vjp_direct_ms"]
        if turns_1d:
            entry["in_turns"] = {
                k: turns_1d[k] for k in (name, f"{name} VJP", f"{name} reflect", f"{name} VJP reflect") if k in turns_1d
            }
        if "vjp_direct_ms" in vjp:
            entry["vjp_direct_ms"] = vjp["vjp_direct_ms"]
        if errors_1d[f"{name} VJP"]:
            # phase 7's VJP check at full width, every padded mode
            entry["vjp_rel_err_full_width"] = errors_1d[f"{name} VJP"][torch.float32]["rel"]
            entry["vjp_max_abs_err_f64"] = errors_1d[f"{name} VJP"][torch.float64]["abs"]
        if "vjp_library_ms" in vjp:
            entry["vjp_library_ms"] = vjp["vjp_library_ms"]
            entry["vjp_library_note"] = vjp["vjp_library_note"]
        if name in ("K7a", "K7b"):
            # phase 16: per full expansion / reconstruct() of wp1d
            entry["wp1d_launches"] = pkt["wp1d"]["forward" if name == "K7a" else "inverse"][name]
            # phase 18: td1's long levels, one rank and four
            entry["tiled_launches"] = tiled_kernel_launches(tiled, name)
        if name in ("K8a", "K8b"):
            # phase 15: the sameshift instance, the interiors of mat1d's
            # fused runs (launches per mat1d analysis or synthesis)
            times = mat["times"][f"sameshift {name}"]
            entry["sameshift"] = {
                "launches": mat["mat1d"]["forward" if name == "K8a" else "inverse"][name],
                "max_abs_err": errors_ss[name][torch.float32]["abs"],
                "max_abs_err_f64": errors_ss[name][torch.float64]["abs"],
                "rel_err": errors_ss[name][torch.float32]["rel"],
                "ms": times["ms"],
                "plain_ms": times["plain_ms"],
                "bound_ms": times["bound_ms"],
                "bound_by": times["bound_by"],
                "library_ms": None,
                "library_note": "no single library call computes four fused levels",
                "mat_main_paths": {k: v for k, v in mat["times"].items() if not k.startswith("sameshift")},
            }
        kernels.append(entry)
    for name in KERNELS_K9:
        source, replaces = REPLACES[name]
        row = rows_k9[name]
        twin = "K9b" if name == "K9a" else "K9a"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # per round trip of the periodic headline with the opt-in
            "launches": counts[name],
            "max_abs_err": errors_k9[name][torch.float32]["abs"],
            "rel_err": errors_k9[name][torch.float32]["rel"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "band_tc_ms": row["band_tc_ms"],
            "library_ms": row["library_ms"],
            "library_note": "F.conv2d (stride 2, circular padding beforehand)" if name == "K9a"
            else "F.conv_transpose2d (stride 2), before the crop",
            "opt_in": f"{MXU2D_ENV}=1",
            "launches_per_step": train_k9["step"][name],
            "one_pass_tf32_rel_err": tf32_one_pass["analysis_rel_err" if name == "K9a" else "synthesis_rel_err"],
            "vjp_kernel": twin,
            "vjp_launches": train_k9["backward"][twin],
            "vjp_max_abs_err": errors_k9[f"{name} VJP"][torch.float32]["abs"],
            "vjp_rel_err": errors_k9[f"{name} VJP"][torch.float32]["rel"],
            "vjp_ms": row["vjp_ms"],
            "vjp_plain_ms": row["vjp_plain_ms"],
            "vjp_bound_ms": row["bound_ms"],
            "vjp_library_ms": row["vjp_library_ms"],
            "k9_times": {k: v for k, v in k9_rows.items() if k.split()[0] in (name, twin, "K1", "K2", "round")},
            "small": {"shape": list(K9_SHAPES[1][1]), "bound_ms": row["bound_ms_small"]},
            "in_turns": {k: v for k, v in turns_k9.items() if k.split()[0] in (name, twin, "K1", "K2", "round")},
        })
    kt = learn["times"]
    kt_errors = learn["errors"]
    kernels.append({
        "name": "KT",
        "route": "cuda",
        "source": KT_SOURCE[0],
        "replaces": KT_SOURCE[1],
        # per SGD step of the learnable periodic headline, phase 17 (b)
        "launches": learn["2d periodic"]["launches_per_step"]["KT"],
        # the worst of every KT case of phase 17, absolute and over the
        # gradient's largest entry
        "max_abs_err": kt_worst(kt_errors, torch.float32, "abs"),
        "max_abs_err_f64": kt_worst(kt_errors, torch.float64, "abs"),
        "rel_err": kt_worst(kt_errors, torch.float32, "rel"),
        "rel_err_f64": kt_worst(kt_errors, torch.float64, "rel"),
        "ms": kt[f"KT {KT_MAIN[0][0]}"]["ms"],
        "plain_ms": kt[f"KT {KT_MAIN[0][0]}"]["plain_ms"],
        "bound_ms": kt[f"KT {KT_MAIN[0][0]}"]["bound_ms"],
        "bound_by": kt[f"KT {KT_MAIN[0][0]}"]["bound_by"],
        "library_ms": kt[f"KT {KT_MAIN[0][0]}"]["library_ms"],
        "library_note": kt[f"KT {KT_MAIN[0][0]}"]["library_note"],
        "ms_is": f"K3's taps at {KT_MAIN[0][0]} (periodic, {list(KT_MAIN[0][1])})",
        "bound_is": "bytes over 3.35 TB/s or float64 multiply-adds over 34 TFLOP/s, the larger",
        "axis_minus_1": kt[f"KT {KT_MAIN[1][0]}"],
        "d1_level_1": kt[f"KT {KT_MAIN[2][0]}"],
        "launches_per_step": {name: learn[name]["launches_per_step"] for name, *_ in LEARN_FULL},
        "example_launches_per_step": learn["example"]["launches_per_step"],
        "steps": {k: v for k, v in kt.items() if not k.startswith("KT")},
        # phase 21: KT's VJP, one K3 and one K4 launch (at KT_MAIN's first
        # row); its launches per pure second backward of (e)
        "vjp_kernels": ["K3", "K4"],
        "vjp_launches": second["rows"][SECOND_LEARN[0]]["pure"]["kt_vjp_launches"],
        "vjp_max_abs_err": second["kt_vjp"]["max_abs_err"],
        "vjp_ms": second["kt_vjp"]["ms"],
        "vjp_plain_ms": second["kt_vjp"]["plain_ms"],
        "vjp_bound_ms": second["kt_vjp"]["bound_ms"],
        "vjp_library_ms": None,
        "vjp_host_taps_wall_ms": second["kt_vjp"]["host_taps_wall_ms"],
    })
    for entry in kernels:  # the custom op (torch.ops.ptwt_tpu_torch) each launch goes through
        entry["op"] = KERNEL_OPS[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    if "--dist-probe-rank" in sys.argv:
        i = sys.argv.index("--dist-probe-rank")
        backend, op, rank, world, store = sys.argv[i + 1 : i + 6]
        dist_probe_rank(backend, op, int(rank), int(world), Path(store))
        sys.exit(0)
    if "--tiled-rank" in sys.argv:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: CUDA is not available")
        tiled_rank(int(_arg("--tiled-rank")), int(_arg("--world")), Path(_arg("--store")), Path(_arg("--out")),
                   _arg("--backend") or "gloo")
        sys.exit(0)
    if "--tiled-compile-rank" in sys.argv:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: CUDA is not available")
        tiled_compile_rank(int(_arg("--tiled-compile-rank")), int(_arg("--world")), Path(_arg("--store")),
                           Path(_arg("--out")), _arg("--backend") or "gloo", "--handshake" in sys.argv)
        sys.exit(0)
    if "--tiled-nccl" in sys.argv:
        # phases 18 (b) and 22 (b) on NCCL, one rank per card: needs that many cards
        world = int(_arg("--tiled-nccl"))
        if torch.cuda.device_count() < world:
            sys.exit(f"chip_smoke: --tiled-nccl {world} needs {world} cards")
        log(f"card: {smi()}; build: {_kernels.build()}")
        print(json.dumps({"tiled_nccl": tiled_ranks(world, "nccl"),
                          "tiled_compile_nccl": tiled_ranks(world, "nccl", "--tiled-compile-rank")}))
        sys.exit(0)
    for flag, times in (("--fwt1d-times", fwt1d_times), ("--axis-times", axis_times), ("--k5-times", k5_times),
                        ("--k9-times", k9_times), ("--nd-times", nd_times_all), ("--mat-times", mat_times),
                        ("--pkt-times", pkt_times), ("--learn-times", learn_times), ("--tiled-times", tiled_times),
                        ("--dist-probe", dist_probe), ("--kt-times", kt_times), ("--kt-sass", kt_sass),
                        ("--prec-times", prec_times), ("--compile-times", compile_times),
                        ("--second-order-times", second_order_times),
                        ("--tiled-compile-times", tiled_compile_times),
                        ("--compiled-func-times", compiled_func_times),
                        ("--kt-turns", lambda: kt_turns(Path(_arg("--kt-turns")).resolve()))):
        if flag in sys.argv:
            if not torch.cuda.is_available():
                sys.exit("chip_smoke: CUDA is not available")
            out = times()
            if flag == "--axis-times":
                out = {**{k: v["ms"] for k, v in out.items()}, **reflect_device_ms()}
            print(json.dumps(out))
            sys.exit(0)
    sys.exit(main())
