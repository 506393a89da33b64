#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one CUDA card, through their
twenty-six hand-written kernels (nine with a bfloat16 entry, K1-K7, K19
and K20, K7's x entry too; K1 with its v1 entry and K15 with its y
entry), and check every result.

    python3 chip_smoke.py        # from the root of a checkout; one card
    python3 chip_smoke.py --profile   # phase 8's steps under torch.profiler
    python3 chip_smoke.py --phase12   # phase 4's kernels print, then phase 12
    python3 chip_smoke.py --phase13   # phase 13 alone (gradients, inverse apps)
    python3 chip_smoke.py --inverse-defaults  # the inverse apps at their
                                              # CLI defaults (~17 min)

Phases (each asserts; a failure exits non-zero and prints no result):

0. The card: CUDA must be available.  Prints the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
1. Build: compiles csrc/*.cu for sm_90a (ptxas register/spill report) and
   prints the build seconds.
2. Each kernel against its plain PyTorch version on the same CUDA tensors,
   float32: K1-K4 at 256^3 with a WAAM mask (plate, two walls, a deposited
   block), 256^3 with a random mask, and 97x203x131, and also at the
   512^3 WAAM mask of phase 3 (K1 and K2: plan-lite x, y and z, the entry
   plan's plan-lite + Neumann x and z, the field plan's coefficient +
   Neumann + Dirichlet x and z; K3; K4; the summary's K1-K4 times), and
   K4 on 8192-row lines (its reduced rows in global memory) and on fields
   of 1 and 3 planes (8192x64x64, 1x512x512, 3x512x512); K5-K8 at
   the 256^3 WAAM mask and 97x203x131, and K6, K7 and K8 (the split-line
   sweeps of the varprop step) also at the 512^3 WAAM mask (the summary's
   times; K5 there too), at 8192x64x64 and on 8192-row lines (64x8192x64 for K7's y,
   64x64x8192 for K8's z), K6 also on fields of 1 and 3 planes
   (1x512x512, 3x512x512), and K19 (h stream, rob_c) at the 512^3 WAAM
   mask at float32 and float64 and on 8192-row z lines (the core's strided
   kernel), T over 20-1500 C with cells exactly at the
   solidus and liquidus, melt_pool_enhanced_k(54, 1420, 1470, 4) and
   apparent_cp(490, 490, 2.7e5, 1420, 1470), emissivity 0.5, h 30.  Max
   |delta| (KERNEL_TOL_ULP float32 ulp of the output's scale;
   KERNEL_TOL_F64 of it at float64), the CUDA-event median time of kernel
   and plain version, and % of 3.35 TB/s under each kernel's byte model.
3. The full step at 512^3 float32 through make_cartesian_engine, kernels
   against reference after 3 steps, on three BC sets: plan-lite (scalar
   h: K4, K1, K2), __graft_entry__'s (scalar h + Neumann flux on z+: K3,
   K1 x2, K2) and the same as per-face coefficient fields (K3, K1 x2,
   K2: z in the natural layout, no permuted copy of the state).  After
   two warm-up steps each step is timed with CUDA events; prints the
   median ms/step and Gcell/s and checks each kernel's launch count.
   Its variable-property part (run after phase 4): the 512^3 float32
   varprop step on two BC sets (the tables + scalar h 30; the tables +
   h 30 + emissivity 0.5): K5, K6, K7, K8 once per step and K1-K4 never
   (float64 states send z through K19 instead of K8, as phase 5 does).
   Each of 3 steps starts the kernels and the reference from the
   reference's state and is held to STEP_TOL, and so is the free-running
   difference after 3 steps.  Kernel steps are timed as above.
4. The WAAM app on a 160x40x40 mm STL box at 0.5 mm (~2.5 M cells), 20
   layers of 3 s, 4 frames, float32, with the kernels and again with the
   reference step: T finite, every solid voxel active at the end,
   Tmax <= --Ts, and the two runs agree.
5. The WAAM app on phase 4's bar with --latent_J_kg 2.7e5
   --melt_k_factor 4 --emissivity 0.5: float64 with the kernels (T finite,
   the solid active, Tmax <= --Ts), then float64 with the kernels and with
   the reference step on a print of 20 layers of SHORT_LAYER_S s
   (agreement within APP_TOL; the whole print's reference took 122 s),
   then float32 with the kernels (T finite, the solid
   active, Tmax <= --Ts), whose final field must differ from phase 4's
   constant-property one by more than 1 K somewhere: the flags reach the
   step.  Why float64 for the comparison: in float32 the apparent cp's
   epsilon ramps are below one ulp at 1420 C, so cp jumps 12x at the
   solidus, and two float32 runs that differ by round-off part at the
   cells that cross it between them (measured on the H100: 0.564 K, 20
   cells above 0.5 K, float32 kernels vs float32 reference after 1702
   sub-steps).  The float32 kernels' distance from the float64 run is
   printed.

6. The cylindrical spiral-tube path.  Its kernel part (run with phase 2):
   K9 (r), K11 (phi, cyclic) and K10 (z) against their plain versions,
   float32, on the plan of a (64, 512, 1024) annular tube (substrate, a
   half-built wall and a partly deposited top layer; Dirichlet bottom
   pins) and of a (37, 203, 131) full disk with a random mask, K9 there
   bit for bit (its march of a thread a line) and also on r lines past
   kK9MarchRows (K9_LONG_SHAPE: the core's strided split kernel, within
   KERNEL_TOL_ULP), K10 also
   on K10_SHAPES (the spiral app's ring at 0.25 mm, the tube at 10x dt,
   8192-row lines past the staging), and K11 also on CYCLIC_SHAPES (the
   spiral app's (32, 720, 200) ring, 4096-row lines on a mild and a stiff
   annulus, lines of 2 and 3 rows): max |delta| in float32 ulp of the
   output's scale (KERNEL_TOL_ULP; K10 and K11 solve split), kernel and
   plain ms, % of 3.35 TB/s at 17 B/cell.  Its step part: the (64, 512, 1024)
   masked-Robin step (bench.py's masked-cylindrical configuration),
   kernels against reference after 3 steps within STEP_TOL, CUDA-event
   ms/step after two warm-up steps, Gcell/s, the plan rebuild's ms on its
   own, and launches of exactly K9, K10 and K11 once per step.  Its app
   part: apps/spiral_tube on a 120 mm tube with an 8 mm wall at 0.25 mm
   ((32, 720, 200) = 4.6 M cells, 20 layers, 600 steps), float32, with the
   kernels and with the reference step: T finite, Tmax <= --Ts, every
   deposited column active at the end, the two runs within APP_TOL.
7. The unmasked cylindrical step.  Its kernel part (run with phase 2):
   K12 (r), K14 (phi, cyclic) and K13 (z) against their plain versions,
   float32, on the coefficient vectors of the step at bench.py's
   cylindrical configuration ((128, 512, 512), r_inner 20 mm, dr = dz =
   0.5 mm, steel, dt 0.02 s, Robin h 300 outside, 400 on the top) and of a
   (37, 203, 131) full disk (odd nphi, stiff axis rings, Dirichlet bottom):
   max |delta| in float32 ulp of the output's scale, kernel and plain ms,
   % of 3.35 TB/s at 8 B/cell, and the time of one PyTorch call computing
   the same function (K12/K13: addmm by the dense inverse of the constant
   per-row matrix, built once, TF32 off; K14: the spectral solve, rfft ->
   divide -> irfft).  K12, K13 and K14 run with the step's tables (each
   built once per dt by its own kernel, K12's and K13's by K13t and K14's
   by K14t: bit for bit their plain versions, their kernel and plain ms,
   no PyTorch call); K12 is bit for bit its plain version on lines it
   marches (up to the source's kK12MarchRows rows), and runs once more on
   r lines past them (K12_LONG_ROWS: the split kernel, within
   KERNEL_TOL_ULP); K13 prints its table's stiffness ratio and K14 the
   share of rings past its own (the source's kK13Stiff and kK14Stiff:
   Thomas order) at both shapes, and K13 runs once more on the disk at a
   dt whose table passes kK13Stiff (bit for bit).
   Its step part: the (128, 512, 512) step through adi_step_cylindrical,
   backward Euler and then Douglas, kernels against reference (thomas +
   FFT) after 3 steps within STEP_TOL, CUDA-event ms/step after two
   warm-up steps, Gcell/s, and launches of exactly K12, K13 and K14 once
   per step, K13t twice a run (K12's r table and K13's z table) and K14t
   once (the tables cached for the dt after the first step).  Its app
   part:
   phase 6's spiral app with --void_mode clamp, kernels and reference: T
   finite, Tmax <= --Ts in every frame, every deposited column active, the
   two runs within APP_TOL, and more than 1 K from phase 6's robin-mode
   field somewhere.

8. The variable-property cylindrical step.  Its kernel part (run with
   phase 2): K15 (r), K16 (phi, cyclic), K8's general form (z), K17 (r,
   and z on the natural streams) and K18 (phi, cyclic) against
   their plain versions on bench.py's cyl_varprop tube ((64, 512, 1024),
   r_inner 20 mm, 0.5 mm cells, the lower half and a partial layer
   deposited) at float32 and on a (37, 203, 131) full disk with a random
   mask and a Dirichlet bottom at float32 and float64, T across 1400-1500
   C with cells exactly at the solidus and liquidus, and K22 on K18's
   rows (the fields tier's); K16, K18 and K22 also on CYCLIC_SHAPES at
   float32 (lines of 3 rows also float64); max |delta| (gates P8_TOL;
   K8's general form, K15, K17, K18 and K22, whose lines are split across
   threads, also within KERNEL_TOL_ULP float32 ulp of the output's scale,
   KERNEL_TOL_F64 of it at float64), kernel and plain ms, % of 3.35 TB/s
   under each byte model.  K8's general form, K17 r and z and K21 on the
   same rows, K18 and K22 on its rows (the fields tier's), also on the
   tube at 10x the step's dt (lines past kK8Stiff, blocks past kOpenStiff
   or kCyclicFieldStiff: Thomas order) and K8's general form (a 64x64x8192
   tube) and K17 on 8192-row lines (8192x64x64 r, 64x64x8192 z), within
   KERNEL_TOL_ULP (K8's general form and K18 also P8_TOL); K15 (the rhs
   T) on a tube of the same kind whose r lines are one row past its
   march's (kK15MarchRows + 1 rows, 512 phi rows, ~2^25 cells: the
   strided split kernel), within KERNEL_TOL_ULP (its distance from P8_TOL
   printed).
   Its step part: bench.py's cyl_varprop configuration at (64, 512, 1024)
   float32 (melt_pool_enhanced_k(54, 1420, 1470, 4), apparent_cp(490,
   490, 2.7e5, 1420, 1470), emissivity 0.5, h 300 outside, 50 inside, 400
   on top, h_void 80, h_front 200, dt 0.02 s, the prebuilt plan), backward
   Euler and then Douglas: each of 3 steps starts kernels and reference
   from the reference's state (STEP_TOL), then the kernels alone, timed
   after two warm-ups; launches K15 = K16 = K8 = 1 per BE step, K17 = 2
   and K18 = 1 per Douglas step.  Its app part: phase 6's spiral app with
   --latent_J_kg 2.7e5 --melt_k_factor 4 --emissivity 0.5 --Ts 1550,
   float32 kernels over the whole print (wall time), then kernels against
   reference at float64 on the first P8_APP_T_TOT s of the print (within
   P8_APP_TOL), once in robin mode, once with --scheme douglas and once
   with --void_mode clamp (Tmax <= --Ts is checked for backward Euler
   only: Douglas-Gunn at theta 0.5 is not monotone).

9. The general boundary conditions of the variable-property step.  Its
   kernel part (run with phase 2): K19 (z, with and without a film
   stream), K7's x entry, K20 (with and without a source), K21 (x, y and
   z entries) and K22 (phi, cyclic) against their plain versions at 384^3
   (the WAAM mask) float32 and on 97x203x131 (a random mask) at float32
   and float64, and K21 on 8192-row lines along x, y and z (8192x64x64,
   64x8192x64, 64x64x8192): K20 bitwise equal (it repeats its plain
   version one rounding at a time), K7x, K19, K21 and K22 (lines split
   across threads) within KERNEL_TOL_ULP float32 ulp of the output's
   scale, KERNEL_TOL_F64 of it at float64; kernel and plain ms, % of 3.35
   TB/s under each byte model.
   Its step part, float32: bench.py's corrected-BC configuration at 384^3
   through make_cartesian_engine (1 mm cells, bench.py's mask at 900 C,
   per-face h 10 + 10*U(0,1) and area scales 0.7 + 0.6*U(0,1) from
   numpy's default_rng(5), emissivity 0.5, the phase 2 tables, dt 0.02 s):
   kernels against reference per step from the reference's state
   (STEP_TOL), launches K5 = K6 = K7 = K19 = 1 per step, K8 never; then
   adi_step_varprop_fused(fuse_theta=False) on the same streams (K5, K20,
   K7's x entry, K7, K19 once each), bitwise equal to the fused step (K6
   and K7x run one kernel with one launch shape, and K6's right-hand
   sides are K20's); the
   varprop engine at 384^3 with __graft_entry__'s BCs (Robin 200, Neumann
   z+ 5e5) and a Dirichlet bottom plane at 600 C (K21 three times per
   step); adi_step_cyl_varprop(implementation="fields") at phase 8's tube,
   backward Euler and Douglas (K21 twice and K22 once per step), each
   against its reference per step.  Its app part: the WAAM app on phase
   4's bar rotated 30 degrees about z (the corrected fields differ from
   --h_side) with --corrected_bc 1, and with --corrected_bc 1 --emissivity
   0.5 --latent_J_kg 2.7e5 --melt_k_factor 4: the whole print with the
   float32 kernels (wall time, Tmax <= --Ts, the solid active), then
   kernels against reference (within APP_TOL) on
   a print of 20 layers of SHORT_LAYER_S s, at float32 and with all the
   varprop flags at float64.
10. The bfloat16 bandwidth mode.  Its kernel part (run with phase 2):
   K23 (film modes const and rad, with and without a source) against its
   plain version at 384^3 (the WAAM mask) and 97x203x131 (a random mask),
   bfloat16 and float32: bitwise; K24 (seeded, and with src_pre), K25
   (seeded) and K26 (split solves) there, and on 8192-row lines along x
   (K24, 8192x64x64), y (K25, 64x8192x64) and z (K26, 64x64x8192, past
   the staging), seeded: within KERNEL_TOL_ULP of the output's scale at
   float32, one bfloat16 ulp of it at bfloat16 and at most P10_SHARE_TOL
   of the cells apart; the bfloat16 entries K1b-K4b at the 256^3 WAAM
   mask, to nearest and seeded: within one bfloat16 ulp of the output's
   scale and P10_SHARE_TOL of the cells apart; kernel and plain ms and %
   of each bound; the kernels' stochastic rounding of 1 + ulp/4 over 128^3 cells (P(up) =
   0.25 +- 0.01, only the two neighbours); the classic varprop tier's
   bfloat16 entries K20b (bit for bit), K5b and K6b, K7xb, K7b and K19b
   (split solves: within one bfloat16 ulp of the output's scale and
   P10_SHARE_TOL of the cells apart; each seeded entry's plain version
   under the next pass's key must part from it at more than
   P10_SHARE_TOL, so that the gate sees a wrong key) at phase 9's 384^3
   (bench.py run_corrected's mask and per-face film streams) and 97x203x131,
   bfloat16 T through the mushy interval, phase 2's tables, to nearest and
   seeded, K7b and K19b also on 8192-row lines (64x8192x64, 64x64x8192),
   each beside its float32 counterpart's time on the same inputs.  Its
   step part: bench.py's main_bf16 case (512^3, 1 mm, Robin 200, dt 0.05
   s) through make_cartesian_engine(dtype=bfloat16,
   stochastic_rounding=True), ms/step and Gcell/s beside the float32 step
   of the same case (launches K4b = K1b = K2b = 1 per step), the same
   with per-face h (K3b = 1, K1b = 2, K2b = 1);
   run_varprop's case at 384^3 bfloat16 (K23 = K24 = K25 = K26 = 1 per
   step, K5-K8 never); the float32 A/B of the g-stream and classic tiers
   on that step (classic, g-streams, g-streams, classic); run_corrected's
   case at 384^3 bfloat16 on the classic tier (K5b = K6b = K7b = K19b = 1
   per step, no other kernel; with fuse_theta=False K20b = K7xb = 1 and
   K6b = 0) beside the float32 step of the same case, both states held to
   float32's within P10_CORR_MAX_TOL K and a mean of P10_CORR_MEAN_TOL K
   over the solid, the mean change of the solid's temperature within
   P10_CORR_COOL_RTOL of float32's; the drift
   gates of tests/test_bf16_drift.py (64x56x48, 900 C, Robin 200, dt 0.002
   s, 30 steps: stochastic rounding within max 21 K and mean 2.5 K of
   float32, round-to-nearest cooling less than half as much, step counters
   decorrelating the rounding).  Its app part: the WAAM app at bfloat16 on
   phase 4's bar (against phase 4's float32 field), with phase 5's varprop
   flags less the latent heat (against a float32 run of those flags), both
   gated at a mean of P10_APP_MEAN_TOL K over the solid, and with all of
   phase 5's flags (against phase 5's float32 field; printed, not gated:
   the stochastically rounded state freezes at the solidus, PERF.md); and
   phase 9's turned bar with --corrected_bc 1 (the classic tier's
   bfloat16 entries) with the varprop flags less the latent heat, gated
   against a float32 print of those flags, and with the latent heat,
   printed only.
11. The last TPU kernels: the v1 field-coefficient sweeps and the tier-2 y
   sweep.  Its kernel part (run with phase 2): K1's v1 entry through the
   public fused_sweep for axes 0, 1 and 2 and through fused_sweep_axis1
   on the natural layout, at the 256^3 WAAM mask and 97x203x131 (a random
   mask), float32 and float64, with the Neumann and Dirichlet folds and
   with pinned codes but no dir_val (the v1 pin rule), within
   KERNEL_TOL_ULP of the plain versions; K15's y entry at the 256^3 and
   512^3 WAAM masks, float32, scalar and radiative film, within
   KERNEL_TOL_ULP too (its lines split across threads).  Its
   path part: one implicit x, y, z pass through fused_sweep at 256^3 with
   __graft_entry__'s BCs and a Dirichlet bottom against the reference
   sweeps (STEP_TOL; K1v1 = 3 launches); phase 3's 512^3 float32 varprop
   step (tables + h 30 + emissivity 0.5) with VP2_Y_DEFAULT off and on from
   a shared state, per step within rtol 2e-5 / atol 5e-3 K (the JAX
   switch test's tolerance), launches K15y = 1 and K7 = 0 per step on, the
   reverse off, and an A/B of ms/step in turns (off, on, on, off); the
   float32 WAAM varprop prints with the switch on: phase 10's print less
   the latent heat within APP_TOL of its switch-off run, and phase 5's
   print with the latent heat against its switch-off run, printed (max,
   mean, the cells above APP_TOL and their distance from the solidus) and
   not gated: it parts by more than APP_TOL at cells near the solidus, as
   the JAX package's two routes do (scripts/vp2_y_solidus.py; PERF.md).
   Each of the four float32 prints is held against the float64 print of
   its flags (max, mean |d| and mean d over the solid; printed).  The
   switch is set back whatever happens.
12. The apps' outputs and the single-track app.  (a) Phase 4's print
   again with the kernels, with --history_t_crit 800,500, --checkpoint,
   --save_vtk 1 and 4 frames: the final T bit for bit phase 4's (tracking
   the history must not touch the field); waam_history.vtk read back:
   T_peak >= T on active cells and at --Ts on the deposited ones, each
   t_above_* 0 where the peak stayed under its threshold, t8/5 >= 0,
   zeros on never-born cells; the checkpoint's T and history equal the
   run's, and --resume from it gives the same peaks.  Wall s beside phase
   4's; the history pass's ms per sub-step (CUDA events) beside one
   sub-step of the engine, on the bar and at 512^3.  (b) The bar with
   --interpass_T 300 and SHORT_LAYER_S layers (P12_DWELL), kernels and
   reference: equal dwell logs, T within APP_TOL.  (c) Phase 6's spiral
   print with the kernels at a fixed speed, to half its --t_tot with
   --checkpoint and --history_t_crit 800,500, then --resume to the full
   --t_tot, against a straight run: T and t_above bit for bit.  (d) The
   single-track app at P12_TRACK (120x240x38, 1.09 M cells), with and
   without --goldak_power 1500, kernels only: T finite, every bead column
   active, Tmax <= --T_track without the torch, the torch's run hotter,
   launches per sub-step K4 = K1 = K2 = 1 (K3 = 1, K1 = 2, K2 = 1 with
   the torch); then P12_TRACK_SMALL with the kernels and the reference
   step, within APP_TOL.
13. Gradients and the inverse tier.  (a) The gradient w.r.t. T0 and dt
   of a seeded weighted sum after P13_STEPS steps of adi_step_fused
   (autograd Functions of solvers/differentiable.py: K4/K3 and K1/K2
   forward, K21 and K3 backward) against autograd through the plain
   adi_step on the same CUDA tensors: the lite plan on phase 2's 256^3
   WAAM mask at float32 and float64, the entry plan (scalar h + Neumann)
   and the field plan (per-face h fields + Neumann + Dirichlet) at 256^3
   float32; the field gradient within GRAD_TOL_ULP float32 ulp of its
   scale per kernel pass of the chain (KERNEL_TOL_F64 of it at float64),
   dt within GRAD_DT_RTOL.  Then forward and forward+backward of the
   512^3 float32 lite step timed with CUDA events, and the K3/K21
   launches the backward adds.  (b) The cylindrical varprop kernels tier
   on phase 8's tube at float64 against the reference tier's autograd:
   backward Euler with phase 8's tables (K15, K16, K8's general form;
   gradient w.r.t. T) and backward Euler and Douglas with k0 + 0.01 T and
   430 + 0.1 T callables (K17, K18; w.r.t. T and k0; JAX
   tests/test_cyl_varprop.py:564), backward on K21 and K22.  (c) The
   inverse apps on the card on the JAX tests' problems (P13_OPT_ARGV,
   P13_CAL_ARGV): optimize_process --var deposit_T (the loss and the t8/5
   spread fall) and calibrate_params --fit h,k --true_h 45 --true_k 38
   (both within P13_FIT_RTOL); at their CLI defaults they take ~16 min
   on the plain steps, so `--inverse-defaults` runs them alone
   (optimize_process's losses within P13_APP_RTOL of the plain CPU run's:
   at its defaults the app does not descend, in JAX either).  (d)
   Printed, not gated:
   compare_implementations (cartesian at --n 256, cyl_varprop at --n 128)
   and StepTimer on the 512^3 lite step.

Each main path is driven with the launch counts set to 0 just before it
and read just after it: phases 3 (constant properties) and 4 for K1-K4,
phases 3 (variable properties) and 5 for K5-K8 and K19, phase 6's step
and app for K9-K11, phase 7's step and app for K12-K14, K13t and K14t, phase
8's steps and apps for K8 and K15-K18, phase 9's steps and apps for K7's
x entry and K19-K22 (beside K1, K3 and K5-K7), then phase 10's steps and
apps for K1b-K7b, K7xb, K19b, K20b and K23-K26 (beside the float32 K1-K8
and K19 of its comparisons), then phase 11's v1 pass, steps and print
for K1v1 and K15y (beside K5-K8, and K19 in its float64 print), then
phase 12's prints for K1-K4 and K9-K11, then phase 13's gradients for
the forward kernels and K3, K21 and K22 in their backward.  The line
before the
last is a JSON summary of the kernels (launches of those runs; each
kernel's time at its main-path shape beside its bound, the least time for
the bytes it must move and the operations it must do, its plain version's
time, and the PyTorch call's time where one exists); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adi_thermal_fields_tpu_torch"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# Tolerances (float32; temperatures up to 1500 C, ulp there = 1.2e-4 K):
KERNEL_TOL_ULP = 8  # one kernel vs its plain version, in float32 ulp of the
#                     largest output (division vs reciprocal-multiply, FMA
#                     contraction; the stencil's R0 of a random field
#                     reaches ~9000 K)
KERNEL_TOL_F64 = 1e-12  # the same at float64, of the output's scale
STEP_TOL = 1e-2     # 3 full steps (3 sweeps + stencil each), ~80 ulp
GRAD_TOL_ULP = KERNEL_TOL_ULP  # a gradient through the kernel path vs
#                     autograd through the plain step, float32: this many
#                     ulp of the gradient's scale per kernel pass of the
#                     chain (the forward's sweeps and stencils and the
#                     backward's transposed solves and stencil passes, each
#                     within KERNEL_TOL_ULP of its plain version); float64:
#                     KERNEL_TOL_F64 of the scale
GRAD_DT_RTOL = {"float32": 1e-2, "float64": 1e-8}  # a scalar gradient (dt,
#                     k0) relative to the plain one: a sum over every cell
#                     of terms of both signs, formed in two orders (the
#                     hand pullback, autograd through thomas); float64 as
#                     JAX's own dt gate (tests/test_pallas_sweeps.py:77),
#                     float32 a check for gross faults only
APP_TOL = 0.5       # ~1700 sub-steps of ulp-level differences, which the
#                     diffusion does not fully damp: 0.03% of the range

# sizes: phase 2 kernel shapes, phase 3 step edge, phase 4 STL box and cell
P2_SHAPES = (("256^3 waam", (256, 256, 256)), ("256^3 random", (256,) * 3),
             ("97x203x131 random", (97, 203, 131)))
# phase 2's K1-K4 rows at the main path's shape (the summary's times)
P2_SWEEP_SHAPE = ("512^3 waam", (512,) * 3)
# K6, K7 and K8 at the main path's shape (the summary's times), K5 and
# K19 there at float32 (K19 also at float64), on many short lines, on
# 8192-row lines (K6 and K7x solve along x, K7 along y, K8 and K19 along
# z: K6's and K7's reduced rows in global memory, K8 with 16 chunks a
# lane, K19 on the core's strided kernel) and K6 on x lines of one and
# three rows
P2_VP_SWEEP_SHAPES = (P2_SWEEP_SHAPE + ("K5 K6 K7 K8 K19", "float32"),
                      P2_SWEEP_SHAPE + ("K19", "float64"),
                      ("8192x64x64 random", (8192, 64, 64), "K6 K7 K8",
                       "float32"),
                      ("64x8192x64 random", (64, 8192, 64), "K7", "float32"),
                      ("64x64x8192 random", (64, 64, 8192), "K8 K19",
                       "float32"),
                      ("1x512x512 random", (1, 512, 512), "K6", "float32"),
                      ("3x512x512 random", (3, 512, 512), "K6", "float32"))
# K4 on lines past its shared memory (the reduced rows in global memory)
# and on fields of one and three planes
P2_K4_SHAPES = (("8192x64x64 random", (8192, 64, 64)),
                ("1x512x512 random", (1, 512, 512)),
                ("3x512x512 random", (3, 512, 512)))
P3_N = 512
P3_WARMUP, P3_STEPS = 2, 3
P4_BOX_MM = (160.0, 40.0, 40.0)
P4_DX_MM = 0.5
P4_LAYERS, P4_LAYER_S = 20, 3.0      # 2 mm beads up the 40 mm height

KERNEL_INFO = {
    "K1": ("sweep_strided", "csrc/sweeps.cu",
           "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:686"),
    "K2": ("sweep_z", "csrc/sweeps.cu",
           "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:950"),
    "K3": ("theta_rhs", "csrc/stencil.cu",
           "adi_thermal_fields_tpu/solvers/pallas_stencil.py:115"),
    "K4": ("fused_theta_sweep", "csrc/theta_sweep.cu",
           "adi_thermal_fields_tpu/solvers/pallas_theta_sweep.py:454"),
    "K5": ("varprop_fields", "csrc/varprop_fields.cu",
           "adi_thermal_fields_tpu/solvers/pallas_varprop.py:1274"),
    "K6": ("varprop_theta_sweep", "csrc/varprop_sweeps.cu",
           "adi_thermal_fields_tpu/solvers/pallas_varprop.py:1066"),
    "K7": ("varprop_sweep_y", "csrc/varprop_sweeps.cu",
           "adi_thermal_fields_tpu/solvers/pallas_varprop.py:718"),
    "K8": ("vp2_sweep_z", "csrc/vp2_sweep.cu",
           "adi_thermal_fields_tpu/solvers/pallas_vp2.py:402"),
    "K9": ("masked_sweep_strided", "csrc/masked.cu",
           "adi_thermal_fields_tpu/solvers/pallas_fields.py:655"),
    "K10": ("masked_sweep_z", "csrc/masked.cu",
            "adi_thermal_fields_tpu/solvers/pallas_fields.py:655"),
    "K11": ("masked_cyclic_phi", "csrc/masked.cu",
            "adi_thermal_fields_tpu/solvers/pallas_fields.py:977"),
    "K12": ("const_sweep_strided", "csrc/const_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:1567"),
    "K13": ("const_sweep_z", "csrc/const_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:1567"),
    "K13t": ("const_sweep_table, K12's and K13's row table",
             "csrc/const_sweeps.cu",
             "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:1567"),
    "K14": ("cyclic_const_phi", "csrc/const_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:1727"),
    "K14t": ("cyclic_const_phi_table, K14's ring table",
             "csrc/const_sweeps.cu",
             "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:1727"),
    "K15": ("vp2_sweep_strided", "csrc/vp2_sweep.cu",
            "adi_thermal_fields_tpu/solvers/pallas_vp2.py:402"),
    "K16": ("vp2_cyclic_phi", "csrc/vp2_cyl.cu",
            "adi_thermal_fields_tpu/solvers/pallas_vp2.py:812"),
    "K17": ("vp_fields_sweep_strided", "csrc/vp_fields.cu",
            "adi_thermal_fields_tpu/solvers/pallas_vpfields.py:190"),
    "K18": ("vp_fields_cyclic_phi", "csrc/vp_fields.cu",
            "adi_thermal_fields_tpu/solvers/pallas_vpfields.py:525"),
    "K7x": ("varprop_sweep_x", "csrc/varprop_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_varprop.py:251"),
    "K19": ("varprop_sweep_z", "csrc/varprop_z.cu",
            "adi_thermal_fields_tpu/solvers/pallas_varprop.py:251"),
    "K20": ("varprop_theta_rhs", "csrc/varprop_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_varprop.py:471"),
    "K21": ("tridiag_fields", "csrc/fields.cu",
            "adi_thermal_fields_tpu/solvers/pallas_fields.py:129"),
    "K22": ("cyclic_fields", "csrc/fields.cu",
            "adi_thermal_fields_tpu/solvers/pallas_fields.py:311"),
    "K23": ("gstream_fields", "csrc/gstreams.cu",
            "adi_thermal_fields_tpu/solvers/pallas_gstreams.py:163"),
    "K24": ("gstream_theta_sweep", "csrc/gstreams.cu",
            "adi_thermal_fields_tpu/solvers/pallas_gstreams.py:839"),
    "K25": ("gstream_sweep_y", "csrc/gstreams.cu",
            "adi_thermal_fields_tpu/solvers/pallas_gstreams.py:575"),
    "K26": ("gstream_sweep_z", "csrc/gstreams.cu",
            "adi_thermal_fields_tpu/solvers/pallas_gstreams.py:376"),
    # the bfloat16 entries of K1-K4 (float32 solves, bfloat16 stores)
    "K1b": ("sweep_strided, bfloat16 entry", "csrc/sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:686"),
    "K2b": ("sweep_z, bfloat16 entry", "csrc/sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:950"),
    "K3b": ("theta_rhs, bfloat16 entry", "csrc/stencil.cu",
            "adi_thermal_fields_tpu/solvers/pallas_stencil.py:115"),
    "K4b": ("fused_theta_sweep, bfloat16 entry", "csrc/theta_sweep.cu",
            "adi_thermal_fields_tpu/solvers/pallas_theta_sweep.py:454"),
    # the bfloat16 entries of the classic varprop tier (float32 fields and
    # solves, bfloat16 stores: K5b to nearest, the others seeded)
    "K5b": ("varprop_fields, bfloat16 entry", "csrc/varprop_fields.cu",
            "adi_thermal_fields_tpu/solvers/pallas_varprop.py:1274"),
    "K6b": ("varprop_theta_sweep, bfloat16 entry", "csrc/varprop_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_varprop.py:1066"),
    "K7b": ("varprop_sweep_y, bfloat16 entry", "csrc/varprop_sweeps.cu",
            "adi_thermal_fields_tpu/solvers/pallas_varprop.py:718"),
    "K7xb": ("varprop_sweep_x, bfloat16 entry", "csrc/varprop_sweeps.cu",
             "adi_thermal_fields_tpu/solvers/pallas_varprop.py:251"),
    "K19b": ("varprop_sweep_z, bfloat16 entry", "csrc/varprop_z.cu",
             "adi_thermal_fields_tpu/solvers/pallas_varprop.py:251"),
    "K20b": ("varprop_theta_rhs, bfloat16 entry", "csrc/varprop_sweeps.cu",
             "adi_thermal_fields_tpu/solvers/pallas_varprop.py:471"),
    # K1's v1 entry (rows 7-8: fused_sweep_axis0 :289, fused_sweep_axis1
    # :215) and K15's y entry (row 23)
    "K1v1": ("fused_sweep, K1's v1 entry", "csrc/sweeps.cu",
             "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:289"),
    "K15y": ("vp2_sweep_y, K15's y entry", "csrc/vp2_sweep.cu",
             "adi_thermal_fields_tpu/solvers/pallas_vp2.py:1029"),
}
# float32 operations per cell of each kernel's main variant, counted from
# its source (adds, multiplies and divides of one row, the back
# substitution, table segments evaluated; an estimate for the bound; K12:
# its march's forward pass and back substitution on the table's factors
# (its split kernel, past the march, does K13's 15); K13: the
# run-and-carry solve's two forward and two backward passes; K13t: per
# row of its table, the factors and the stiffness ratio; K14t: per ring
# and phi row of its table)
OPS_PER_CELL = {"K1": 22, "K2": 22, "K3": 20, "K4": 42, "K5": 140,
                "K6": 45, "K7": 25, "K8": 85, "K9": 20, "K10": 20,
                "K11": 30, "K12": 6, "K13": 15, "K13t": 10, "K14": 15,
                "K14t": 12,
                "K15": 50,
                "K16": 60, "K17": 20, "K18": 30, "K7x": 25, "K19": 25,
                "K20": 25, "K21": 8, "K22": 20, "K23": 110, "K24": 35,
                "K25": 12, "K26": 12, "K1b": 22, "K2b": 22, "K3b": 20,
                "K4b": 42, "K5b": 140, "K6b": 45, "K7b": 25, "K7xb": 25,
                "K19b": 25, "K20b": 25, "K1v1": 22, "K15y": 50}
CONST_KERNELS = ("K1", "K2", "K3", "K4")
VP_KERNELS = ("K5", "K6", "K7", "K8", "K19")
CYL_KERNELS = ("K9", "K10", "K11")
BE_KERNELS = ("K12", "K13", "K14", "K13t", "K14t")
# K9's r lines past kK9MarchRows (the core's strided split kernel): 97 r
# rows (or one past the march, if longer), 512 phi rows, ~2^25 cells, as
# the K15 crossover's shapes (scripts/cyl_be_tune.py)
K9_LONG_ROWS = 97
# K12's r lines past kK12MarchRows (the split kernel): 512 r rows (or one
# past the march, if longer), 512 phi rows, ~2^25 cells
K12_LONG_ROWS = 512
CYL_VP_KERNELS = ("K8", "K15", "K16", "K17", "K18")
# phase 9: the new kernels, and the kernels its routes share with earlier
# phases (the apps' constant-property plans K1-K4, the varprop route
# K5-K7)
GENERAL_KERNELS = ("K7x", "K19", "K20", "K21", "K22")
# of those, the ones on the split-line core (not bitwise with their plain
# versions; K20 is)
SPLIT_GENERAL = ("K7x", "K19", "K21", "K22")
P9_ALSO = CONST_KERNELS + ("K5", "K6", "K7")
# phase 10: the bfloat16 entries, the g-stream tier and the classic
# varprop tier's bfloat16 entries, and the kernels its float32
# comparisons share with earlier phases (the corrected step's K5-K7, K19)
GSTREAM_KERNELS = ("K23", "K24", "K25", "K26")
VP_BF16_KERNELS = ("K5b", "K6b", "K7b", "K7xb", "K19b", "K20b")
BF16_KERNELS = ("K1b", "K2b", "K3b", "K4b") + GSTREAM_KERNELS \
    + VP_BF16_KERNELS
P10_ALSO = CONST_KERNELS + ("K5", "K6", "K7", "K8", "K19")
# phase 11: the v1 sweeps and the tier-2 y sweep, and the varprop kernels
# its switch-off legs and its print share with phase 3
REMAINDER_KERNELS = ("K1v1", "K15y")
P11_ALSO = ("K5", "K6", "K7", "K8", "K19")
# phase 6: the kernels' plans, the step (bench.py's masked-cylindrical
# shape and BCs, dr = dz = 0.5 mm) and the spiral app
CYL_SHAPES = (("64x512x1024 tube", (64, 512, 1024)),
              ("37x203x131 disk", (37, 203, 131)))
CYL_DT = 0.02
# K11's, K16's, K18's and K22's further lines (phases 6 and 8): (label,
# shape, dr, r_inner): the spiral app's ring (720 rows: past the kept rows,
# formed again), 4096-row lines (16-row chunks, the reduced rows in global
# memory) on a 1 m annulus (mild rings: the split solve) and on a 20 mm one
# (stiff rings: the Thomas-order replay), and lines of 2 and 3 rows on full
# disks
CYCLIC_SHAPES = (("32x720x200 app tube", (32, 720, 200), 2.5e-4, 0.052),
                 ("2x4096x64 mild tube", (2, 4096, 64), 5e-4, 1.0),
                 ("2x4096x64 stiff tube", (2, 4096, 64), 5e-4, 0.02),
                 ("8x2x96 disk", (8, 2, 96), 5e-4, 0.0),
                 ("8x3x96 disk", (8, 3, 96), 5e-4, 0.0))
# K10's further lines (phase 6): the spiral app's ring (0.25 mm), the
# tube at 10x dt (float32 lines past kK10Stiff replay in Thomas order) and
# 8192-row lines past the staging (the core's strided kernel): (label,
# shape, dr, r_inner, dt multiple)
K10_SHAPES = (CYCLIC_SHAPES[0][:2] + (2.5e-4, 0.052, 1.0),
              ("64x512x1024 tube, 10x dt", (64, 512, 1024), 5e-4, 0.02,
               10.0),
              ("64x64x8192 lines", (64, 64, 8192), 5e-4, 0.02, 1.0))
P6_APP = ["--R_out", "60", "--wall_thickness", "8", "--height", "40",
          "--z_back", "10", "--nr", "32", "--nphi", "720", "--dz", "0.25",
          "--pitch", "2", "--auto_speed", "--t_tot", "30", "--dt_fixed",
          "0.05", "--out", "", "--nframes", "4"]
# phase 7: bench.py's cylindrical case (annular, neumann0 bottom) and a
# full disk with a Dirichlet bottom, both at 0.5 mm and dt 0.02 s
P7_SHAPES = (("128x512x512 annular", (128, 512, 512)),
             ("37x203x131 disk", (37, 203, 131)))
P7_DT = 0.02
VP_SHAPES = (P2_SHAPES[0], P2_SHAPES[2])
# phase 8: bench.py's cyl_varprop tube and a full disk (0.5 mm, dt 0.02 s)
P8_SHAPES = (("64x512x1024 tube", (64, 512, 1024), "float32"),
             ("37x203x131 disk", (37, 203, 131), "float32"),
             ("37x203x131 disk", (37, 203, 131), "float64"))
P8_DT = 0.02
P8_TOL = {"float32": 1e-3, "float64": 1e-9}   # K, one kernel vs plain
P8_APP_FLAGS = ["--latent_J_kg", "2.7e5", "--melt_k_factor", "4",
                "--emissivity", "0.5", "--Ts", "1550"]
P8_APP_T_TOT = "6"      # s of the print in the float64 comparisons
P8_APP_TOL = 1e-6       # K, float64 kernels vs reference
# K21's and K17's 8192-row lines (phases 8 and 9): along x (K17: r), y and
# z, past the core's shared-memory reduced rows and K17's/K21's z staging
LONG_LINES = ((8192, 64, 64), (64, 8192, 64), (64, 64, 8192))
# K above --Ts that the Douglas print may reach: theta 0.5 is not monotone
# at these Fourier numbers (its first frame, at 1.5 s, reads 2307.7 C on an
# H100 80GB HBM3 at 700 W; the JAX app overshoots alike,
# tests/test_torch_cyl_vp.py).  A loose bound that a diverging run fails.
DOUGLAS_OVERSHOOT = 1000.0
# phase 9: kernel shapes and bench.py's corrected-BC edge
P9_SHAPES = (("384^3 waam", (384,) * 3, "float32"),
             ("97x203x131 random", (97, 203, 131), "float32"),
             ("97x203x131 random", (97, 203, 131), "float64"))
P9_N = 384
# s per layer of the WAAM apps' kernels-vs-reference prints in phases 5
# and 9 (160 sub-steps; the whole print runs 20 x 3 s, 1702 sub-steps)
SHORT_LAYER_S = 0.25
# the varprop physics of phases 2, 3 and 5 (steel, the JAX app's defaults)
SOLIDUS, LIQUIDUS, LATENT = 1420.0, 1470.0, 2.7e5
EMISSIVITY, H_CONV = 0.5, 30.0
# phase 10: K23-K26 shapes, bench.py's bf16 edge (main_bf16), the varprop
# dt of run_varprop, the rounding seed, the edge of the rounding check,
# and the app gate (one bfloat16 quantum at 1500 C)
P10_SHAPES = (("384^3 waam", (384,) * 3), ("97x203x131 random",
                                          (97, 203, 131)))
P10_N = 512
P10_VP_DT = 0.02
P10_SEED = 12345
P10_SR_N = 128
P10_APP_MEAN_TOL = 8.0
# the share of cells at which a bfloat16 entry and its plain version store
# different numbers: both round one float32 value (a few float32 ulp apart)
# under one key, so they part only next to a rounding boundary (at most
# 0.04% of the cells on these shapes, PERF.md section 6); a key that drops
# the seed, takes another pass's offset or hashes a block-local index parts
# at ~25-50% of them, and the seeded entries' plain versions under the next
# offset must part by more than this
P10_SHARE_TOL = 1e-3
# run_corrected's bfloat16 step (stochastic) against float32 after
# P3_WARMUP + P3_STEPS steps, over the solid (measured: max 7.19 K, mean
# 0.05 K, PERF.md section 6), both fuse_theta routes
P10_CORR_MAX_TOL, P10_CORR_MEAN_TOL = 16.0, 0.25
# and the solid's mean change over those steps within this share of
# float32's: the roundings are unbiased, so it stays where a wrong film or
# face term in one sweep would move it
P10_CORR_COOL_RTOL = 0.1
# phase 11: K15y's shapes; the tolerance of the switched step, that of the
# JAX switch test (tests/test_vp2.py:367-368)
P11_Y_SHAPES = (("256^3 waam", (256,) * 3), ("512^3 waam", (512,) * 3))
P11_RTOL, P11_ATOL = 2e-5, 5e-3
# phase 12: the history thresholds; the dwell of the interpass print (one
# 0.25 s increment up to 0.5 s before each layer: a fresh deposit stays
# above 300 C, so every layer dwells the cap); the single-track app at
# full width (0.25 mm, a 3 x 3 mm bead) and at 0.5 mm for the reference
P12_HIST = ["--history_t_crit", "800,500"]
P12_DWELL = ["--interpass_T", "300", "--interpass_dwell_s", "0.25",
             "--interpass_max_dwell_s", "0.5"]
P12_TRACK = ["--dx_mm", "0.25", "--track_w_vox", "12", "--track_h_vox",
             "12", "--out", ""]
P12_TRACK_SMALL = ["--dx_mm", "0.5", "--track_w_vox", "6", "--track_h_vox",
                   "6", "--out", ""]
P12_GOLDAK = ["--goldak_power", "1500"]
P12_KERNELS = CONST_KERNELS + CYL_KERNELS
# phase 13: the gradient checks' edge, the timed edge, steps per loss;
# the inverse apps on the JAX tests' problems: optimize_process on
# tests/test_optimize_process.py:58's wall (4 layers, 40 Adam iterations
# at lr 15; the loss and the t8/5 spread fall) and calibrate_params
# --fit h,k on tests/test_calibrate_params.py:64's 12x10x8 block (48
# steps, 25 L-BFGS iterations).  At their CLI defaults (a 24x16 wall of
# 8 layers, 24 sub-steps a layer, 40 Adam iterations at lr 20; a
# 20x16x12 block over 120 steps, 40 L-BFGS iterations) the two took 522
# and 462 s on the H100, the plain steps' row loops a launch per op: more
# than the script's whole limit, so `--inverse-defaults` runs them alone.
# At its defaults optimize_process does not descend, in the JAX app as in
# the port (Adam at lr 20 overshoots): its initial and final losses are
# held to the plain run on the CPU, `python -m
# adi_thermal_fields_tpu_torch.apps.optimize_process --var deposit_T
# --device cpu` (float64; the JAX app under x64 gives the same to
# 2.2e-14), within P13_APP_RTOL.  The calibration's recovery gate is the
# JAX tests' (tests/test_calibrate_params.py:47-48).
P13_N, P13_TIME_N, P13_STEPS = 256, 512, 2
P13_OPT_ARGV = ["--var", "deposit_T", "--iters", "40", "--lr", "15",
                "--nx", "10", "--ny", "6", "--nz_plate", "3", "--layers",
                "4", "--layer_vox", "1", "--wall_w_vox", "2", "--dx_mm",
                "2.0", "--h", "200", "--n_sub", "8", "--target_t85", "1.5",
                "--dwell_s", "3", "--deposit_T", "1500"]
P13_CAL_ARGV = ["--nx", "12", "--ny", "10", "--nz", "8", "--n_steps", "48",
                "--fit", "h,k", "--true_h", "45", "--true_k", "38",
                "--iters", "25"]
P13_OPT_DEFAULT_ARGV = ["--var", "deposit_T"]
P13_OPT_DEFAULT_REF = (87.21894057177214, 98.51740264356538)
P13_CAL_DEFAULT_ARGV = ["--fit", "h,k", "--true_h", "45", "--true_k", "38"]
P13_APP_RTOL = 1e-9
P13_FIT_RTOL = 1e-6
P13_BWD_KERNELS = ("K3", "K21", "K22")


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def load_port():
    """Import torch and the port from this checkout, or fail."""
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"the package {PKG}/ is not beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a "
             "CUDA card only")
    return torch


def source_constant(name, src):
    """A kernel's ``constexpr`` value ``name`` in the package's csrc/src."""
    import re
    with open(os.path.join(HERE, PKG, "csrc", src)) as f:
        m = re.search(rf"constexpr \w+ {name} = ([0-9.e+]+);", f.read())
    check(m is not None, f"no constexpr {name} in csrc/{src}")
    return float(m.group(1))


def cuda_ms(torch, fn, reps, warm=True):
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call
    (none with ``warm=False``: a plain version that has just computed
    the reference is warm, and its calls are most of phase 2's time)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def waam_mask(torch, shape, device):
    """A build plate, two deposited walls and a deposited block."""
    nx, ny, nz = shape
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    plate = nz // 4
    m[:, :, :plate] = True
    w = max(2, nx // 32)
    m[nx // 8:nx // 8 + w, :, plate:3 * nz // 4] = True
    m[7 * nx // 8 - w:7 * nx // 8, :, plate:3 * nz // 4] = True
    m[3 * nx // 8:5 * nx // 8, 3 * ny // 8:5 * ny // 8,
      plate:plate + nz // 8] = True
    return m


def bound(kname, nbytes, cells):
    """The least time for a kernel's work: the bytes it must move over
    the memory rate, or its operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_CELL[kname] * cells / FP32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def random_field(torch, mask, seed):
    g = torch.Generator(device=mask.device).manual_seed(seed)
    r = torch.rand(mask.shape, generator=g, device=mask.device)
    return torch.where(mask, 20.0 + 1480.0 * r, 20.0).contiguous()


def phase0(torch):
    name = torch.cuda.get_device_name(0)
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    smi = proc.stdout.strip().splitlines()[0]
    print(f"[phase 0] card: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return name, smi


def phase1():
    from adi_thermal_fields_tpu_torch.kernels import (build_library,
                                                      load_library)
    path, secs = build_library(verbose=True)
    load_library()
    print(f"[phase 1] built {os.path.relpath(path, HERE)} in {secs:.1f} s",
          flush=True)
    return secs


def phase2(torch, dev):
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              build_coeff_packs)
    from adi_thermal_fields_tpu_torch.solvers import (
        fused_theta_sweep, fused_theta_sweep_plain, sweep_code,
        sweep_strided, sweep_strided_plain, sweep_z, sweep_z_plain,
        theta_rhs, theta_rhs_plain)
    from adi_thermal_fields_tpu_torch.step.cartesian import step_scalars

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    rows = []
    for label, shape in P2_SHAPES + (P2_SWEEP_SHAPE,) + P2_K4_SHAPES:
        grid = CartesianGrid(*shape, 0.5e-3)
        dt = 2.0 * grid.dx ** 2 / mat.alpha          # the app's dt cap
        dt, inv_d2, tg, c_exp = step_scalars(f32, grid, mat, dt, 0.5)
        rc = [float(torch.tensor(30.0, dtype=f32)
                    * torch.tensor(1.0 / (mat.rho * mat.cp * d), dtype=f32))
              for d in grid.spacing]
        if label.endswith("waam"):
            mask = waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(len(rows) + 1)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        T = random_field(torch, mask, seed=7)
        dirm = torch.zeros_like(mask)
        dirm[:, :, 0] = mask[:, :, 0]
        pk = build_coeff_packs(mask, grid, mat, dtype=f32, robin_h=200.0,
                               neumann={"z+": 5e5}, dirichlet_mask=dirm,
                               dirichlet_value=20.0)

        def nat(axis, dm=None, **kw):
            return sweep_code(mask, dm, axis, **kw).movedim(0, axis) \
                .contiguous()

        c0, c1, c2 = nat(0), nat(1), nat(2)
        c0s = nat(0, stencil_bits=True)
        d0, d1, d2 = nat(0, dirm), nat(1, dirm), nat(2, dirm)
        m_u8 = mask.to(torch.uint8)
        fkw = [dict(coeff=pk.coeff[a], qflux=pk.qflux[a], dir_val=pk.dir_val)
               for a in range(3)]
        variants = [
            ("K1", "lite x", 9,
             lambda: sweep_strided(T, c0, tg[0], dt, 20.0, axis=0,
                                   rob_c=rc[0]),
             lambda: sweep_strided_plain(T, c0, tg[0], dt, 20.0, axis=0,
                                         rob_c=rc[0])),
            ("K1", "lite y", 9,
             lambda: sweep_strided(T, c1, tg[1], dt, 20.0, axis=1,
                                   rob_c=rc[1]),
             lambda: sweep_strided_plain(T, c1, tg[1], dt, 20.0, axis=1,
                                         rob_c=rc[1])),
            ("K1", "field+neumann+dirichlet x", 21,
             lambda: sweep_strided(T, d0, tg[0], dt, 20.0, axis=0, **fkw[0]),
             lambda: sweep_strided_plain(T, d0, tg[0], dt, 20.0, axis=0,
                                         **fkw[0])),
            ("K1", "field+neumann+dirichlet y", 21,
             lambda: sweep_strided(T, d1, tg[1], dt, 20.0, axis=1, **fkw[1]),
             lambda: sweep_strided_plain(T, d1, tg[1], dt, 20.0, axis=1,
                                         **fkw[1])),
            # the entry plan's x: plan-lite with the Neumann field
            ("K1", "lite+neumann x", 13,
             lambda: sweep_strided(T, c0, tg[0], dt, 20.0, axis=0,
                                   rob_c=rc[0], qflux=pk.qflux[0]),
             lambda: sweep_strided_plain(T, c0, tg[0], dt, 20.0, axis=0,
                                         rob_c=rc[0], qflux=pk.qflux[0])),
            ("K2", "lite z", 9,
             lambda: sweep_z(T, c2, tg[2], dt, 20.0, rc[2]),
             lambda: sweep_z_plain(T, c2, tg[2], dt, 20.0, rc[2])),
            ("K2", "lite+neumann z", 13,
             lambda: sweep_z(T, c2, tg[2], dt, 20.0, rc[2],
                             qflux=pk.qflux[2]),
             lambda: sweep_z_plain(T, c2, tg[2], dt, 20.0, rc[2],
                                   qflux=pk.qflux[2])),
            ("K2", "field+neumann+dirichlet z", 21,
             lambda: sweep_z(T, d2, tg[2], dt, 20.0, **fkw[2]),
             lambda: sweep_z_plain(T, d2, tg[2], dt, 20.0, **fkw[2])),
            ("K3", "stencil", 9,
             lambda: theta_rhs(T, m_u8, c_exp, inv_d2),
             lambda: theta_rhs_plain(T, m_u8, c_exp, inv_d2)),
            ("K4", "stencil + lite x", 9,
             lambda: fused_theta_sweep(T, c0s, c_exp, inv_d2, tg[0], dt,
                                       20.0, rc[0]),
             lambda: fused_theta_sweep_plain(T, c0s, c_exp, inv_d2, tg[0],
                                             dt, 20.0, rc[0])),
        ]
        if (label, shape) == P2_SWEEP_SHAPE:
            variants = [v for v in variants
                        if v[1] != "field+neumann+dirichlet y"]
        elif (label, shape) in P2_K4_SHAPES:
            variants = [v for v in variants if v[0] == "K4"]
        cells = mask.numel()
        for kname, vname, bpc, kern, plain in variants:
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{kname} {vname} {label}: non-finite output")
            err = float((got - want).abs().max())
            ulp = torch.finfo(f32).eps * max(1.0, float(want.abs().max()))
            tol = KERNEL_TOL_ULP * ulp
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 1, warm=False)
            pct = 100.0 * cells * bpc / (ms * 1e-3) / HBM_BYTES_PER_S
            rows.append(dict(kernel=kname, variant=vname, shape=label,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bytes_per_cell=bpc, pct_hbm=pct,
                             **bound(kname, cells * bpc, cells)))
            print(f"[phase 2] {kname} {vname:32s} {label:18s} "
                  f"max|d|={err:.3e} K = {err / ulp:.2f} ulp of scale "
                  f"(tol {tol:.1e})  kernel "
                  f"{ms:8.3f} ms  plain {plain_ms:9.3f} ms  {pct:5.1f}% of "
                  f"3.35 TB/s at {bpc} B/cell", flush=True)
            check(err <= tol, f"{kname} {vname} {label}: max|d| "
                  f"{err:.3e} K > {tol:.3e} K")
        del T, mask, pk
        torch.cuda.empty_cache()
    return rows


def phase3(torch, dev):
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.bc.faces import FACES
    from adi_thermal_fields_tpu_torch.solvers import launch_counts

    n = P3_N
    grid = CartesianGrid(n, n, n, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    mask = waam_mask(torch, grid.shape, dev)
    T0 = random_field(torch, mask, seed=11)
    unfused = {"K1": 2, "K2": 1, "K3": 1, "K4": 0}
    plans = {
        "lite (scalar h=30)": (dict(robin_h=30.0),
                               {"K1": 1, "K2": 1, "K3": 0, "K4": 1}),
        # __graft_entry__'s BC set: scalar h, so K1 runs plan-lite with
        # the Neumann fold
        "entry (h=200, q''=5e5 on z+)": (
            dict(robin_h=200.0, neumann={"z+": 5e5}), unfused),
        # the same physics through coefficient fields
        "field (h=200 per-face fields, q''=5e5 on z+)": (
            dict(robin_h={f: 200.0 for f in FACES}, neumann={"z+": 5e5}),
            unfused),
    }
    out = {}
    for pname, (bcs, per_step) in plans.items():
        res = {}
        for impl in ("kernels", "reference"):
            prepare, advance = make_cartesian_engine(
                grid, mat, implementation=impl, device=dev,
                dtype=torch.float32, theta=0.5, t_inf=20.0, **bcs)
            prep = prepare(mask)
            before = launch_counts()
            # warm-up: two steps reach the allocator's steady state (the
            # second step holds one more field than the first)
            advance(T0, prep, dt, P3_WARMUP, 0.0)
            torch.cuda.synchronize()
            T, step_ms = T0, []
            for i in range(P3_STEPS):          # each step timed on its own
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                T = advance(T, prep, dt, 1, i * dt)
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
            ms = statistics.median(step_ms)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            want = {k: (P3_WARMUP + P3_STEPS) * per_step.get(k, 0)
                    if impl == "kernels" else 0 for k in delta}
            check(delta == want, f"phase 3 {pname} {impl}: launches "
                  f"{delta} != expected {want}")
            check(bool(torch.isfinite(T).all()),
                  f"phase 3 {pname} {impl}: non-finite T")
            gcells = grid.ncells / (ms * 1e-3) / 1e9
            res[impl] = (T, ms)
            print(f"[phase 3] {n}^3 f32 {pname} {impl:9s}: "
                  f"{ms:9.3f} ms/step (median; steps "
                  f"{', '.join(f'{s:.3f}' for s in step_ms)})  "
                  f"{gcells:7.3f} Gcell/s  launches {delta}", flush=True)
        err = float((res["kernels"][0] - res["reference"][0]).abs().max())
        print(f"[phase 3] {pname}: max|T_kernels - T_reference| = "
              f"{err:.3e} K after {P3_STEPS} steps", flush=True)
        check(err <= STEP_TOL, f"phase 3 {pname}: {err:.3e} K > {STEP_TOL}")
        out[pname] = dict(ms_kernels=res["kernels"][1],
                          ms_reference=res["reference"][1], max_abs_err=err)
        del res
        torch.cuda.empty_cache()
    return out


def bar_stl(turn_deg=0.0):
    """Phase 4's bar as an STL file, turned ``turn_deg`` about z."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu_torch.geometry.stl import (TriMesh,
                                                           save_stl_binary)

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    stl = os.path.join(work, f"bar_{turn_deg:g}.stl")
    tris = box_mesh(size=P4_BOX_MM,
                    center=tuple(v / 2 for v in P4_BOX_MM)).triangles
    a = np.radians(turn_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                    [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    save_stl_binary(stl, TriMesh(tris @ rot.T))
    return stl


def bar_argv(dev, precision="float32", turn_deg=0.0, layer_s=P4_LAYER_S):
    """Phase 4's WAAM app flags: the bar, 20 layers of ``layer_s`` s."""
    return ["--stl", bar_stl(turn_deg), "--dx_mm", str(P4_DX_MM),
            "--nframes", "4",
            "--layer_times_s", ",".join([str(layer_s)] * P4_LAYERS),
            "--precision", precision, "--device", str(dev)]


def app_phase(torch, dev, phase, extra, precision="float32",
              impls=("kernels", "reference"), turn_deg=0.0,
              layer_s=P4_LAYER_S):
    """The WAAM app on the bar (turned ``turn_deg`` about z, 20 layers of
    ``layer_s`` s) with each of ``impls``; ``extra``: flags added to phase
    4's.  With both implementations, they must agree."""
    from adi_thermal_fields_tpu_torch.apps import waam_from_stl as app
    from adi_thermal_fields_tpu_torch.step.cartesian import round_to_state

    argv = bar_argv(dev, precision, turn_deg, layer_s) + extra
    runs = {}
    for impl in impls:
        args = app.build_argparser().parse_args(
            argv + ["--implementation", impl])
        t0 = time.perf_counter()
        res = app.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[impl] = (res, wall)
        T, active = res["T"], res["active"]
        tmax = float(T[active].max())
        # the deposit temperature as the state stores it (bfloat16 keeps
        # --Ts 1500 as 1504, its nearest value)
        ts = round_to_state(args.Ts, T.dtype)
        print(f"[phase {phase}] app {precision} {impl:9s}: grid "
              f"{res['grid'].shape} "
              f"({res['grid'].ncells / 1e6:.2f} M cells), "
              f"{len(res['layers'])} layers, {res['substeps']} sub-steps, "
              f"wall {wall:.2f} s, Tmax {tmax:.2f} C", flush=True)
        check(len(res["layers"]) == P4_LAYERS,
              f"{len(res['layers'])} layers != {P4_LAYERS}")
        check(bool(torch.isfinite(T).all()), f"app {impl}: non-finite T")
        check(tmax <= ts, f"app {impl}: Tmax {tmax} > Ts {ts}")
        check(all(m <= ts for _, _, m in res["frames"]),
              f"app {impl}: a frame's Tmax exceeds Ts")
    _, solid, _, _ = app.load_voxels(args)
    for impl, (res, _) in runs.items():
        check(bool((res["active"].cpu().numpy() == solid).all()),
              f"app {impl}: the active set at the end is not the solid")
    if "reference" not in runs:
        return dict(wall_kernels=runs["kernels"][1],
                    T_kernels=runs["kernels"][0]["T"],
                    active=runs["kernels"][0]["active"])
    diff = (runs["kernels"][0]["T"] - runs["reference"][0]["T"]).abs()
    err = float(diff.max())
    print(f"[phase {phase}] max|T_kernels - T_reference| = {err:.3e} K "
          f"({int((diff > APP_TOL).sum())} cells above {APP_TOL} K)",
          flush=True)
    check(err <= APP_TOL, f"app: kernels vs reference {err:.3e} K > "
          f"{APP_TOL} K")
    return dict(wall_kernels=runs["kernels"][1],
                wall_reference=runs["reference"][1],
                substeps=runs["kernels"][0]["substeps"], max_abs_err=err,
                T_kernels=runs["kernels"][0]["T"])


def varprop_tables():
    """melt_pool_enhanced_k(54, 1420, 1470, 4), apparent_cp(490, 490,
    2.7e5, 1420, 1470)."""
    from adi_thermal_fields_tpu_torch import apparent_cp, melt_pool_enhanced_k
    return (melt_pool_enhanced_k(54.0, SOLIDUS, LIQUIDUS, 4.0),
            apparent_cp(490.0, 490.0, LATENT, SOLIDUS, LIQUIDUS))


def mushy_field(torch, mask, seed):
    """random_field with cells exactly at the solidus and the liquidus."""
    T = random_field(torch, mask, seed)
    flat = T.view(-1)
    flat[::97] = SOLIDUS
    flat[31::101] = LIQUIDUS
    return T


def vp_scalars(grid, mat, dt, theta=0.5):
    """The float32 step scalars of adi_step_varprop_fused."""
    import numpy as np
    f = np.float32
    dt_s = f(dt)
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    return dict(
        dt=float(dt_s), inv_d2=inv_d2, cw=float(f(1.0 - theta) * dt_s),
        tg=[float(f(theta) * dt_s * f(iv)) for iv in inv_d2],
        sk=[float(dt_s / f(d)) for d in grid.spacing],
        glo=float(f(theta * inv_d2[2])), gs=float(f(1.0 / grid.dz)),
        inv_dtor=float(f(1.0) / (dt_s / f(mat.rho))))


def phase2_varprop(torch, dev):
    """K5-K8 and K19 against their plain versions (float32; K19 also
    float64)."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        varprop_fields, varprop_fields_plain, varprop_sweep_y,
        varprop_sweep_y_plain, varprop_sweep_z, varprop_sweep_z_plain,
        varprop_theta_sweep, varprop_theta_sweep_plain, vp2_sweep_z,
        vp2_sweep_z_plain)
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)

    eps32 = torch.finfo(torch.float32).eps
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = varprop_tables()
    rad = (EMISSIVITY, 20.0, H_CONV)
    rows = []
    shapes = [(lb, sh, "K5 K6 K7 K8", "float32") for lb, sh in VP_SHAPES]
    for label, shape, which, prec in shapes + list(P2_VP_SWEEP_SHAPES):
        dtype = getattr(torch, prec)
        grid = CartesianGrid(*shape, 0.5e-3)
        sc = vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
        if label.endswith("waam"):
            mask = waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(3)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        T = mushy_field(torch, mask, seed=7).to(dtype)
        R = random_field(torch, mask, seed=13).to(dtype)   # a chained rhs
        m8 = mask.to(torch.uint8)
        codes = build_varprop_codes(mask)
        fc, w, h = varprop_fields_plain(T, m8, k_spec=kt, cp_spec=ct,
                                        rho=mat.rho, rad=rad)
        g = torch.Generator(device=dev).manual_seed(5)
        src = torch.where(mask, 1e8 * torch.rand(shape, generator=g,
                                                 device=dev), 0.0).to(dtype)
        fk = dict(k_spec=kt, cp_spec=ct, rho=mat.rho)
        th = (T, codes[0], *fc, w, sc["cw"], sc["inv_d2"], sc["tg"][0],
              sc["sk"][0], 20.0)
        hk = dict(h=h)
        sk = dict(rob_c=H_CONV, src=src, dt=sc["dt"])
        yk = (R, codes[1], fc[1], w, sc["tg"][1], sc["sk"][1], 20.0)
        zk = (R, T, codes[2], sc["glo"], sc["gs"], sc["inv_dtor"])
        zkw = dict(k_spec=kt, cp_spec=ct, h=H_CONV, t_inf=20.0,
                   emissivity=EMISSIVITY)
        z19 = (R, codes[3], fc[2], w, sc["tg"][2], sc["sk"][2], 20.0)
        variants = [
            ("K5", "fields", 21,
             lambda: varprop_fields(T, m8, **fk),
             lambda: varprop_fields_plain(T, m8, **fk)),
            ("K5", "fields + rad", 25,
             lambda: varprop_fields(T, m8, rad=rad, **fk),
             lambda: varprop_fields_plain(T, m8, rad=rad, **fk)),
            ("K6", "theta + x, h stream", 29,
             lambda: varprop_theta_sweep(*th, **hk),
             lambda: varprop_theta_sweep_plain(*th, **hk)),
            ("K6", "theta + x, rob_c + src", 29,
             lambda: varprop_theta_sweep(*th, **sk),
             lambda: varprop_theta_sweep_plain(*th, **sk)),
            ("K7", "y, h stream", 21,
             lambda: varprop_sweep_y(*yk, **hk),
             lambda: varprop_sweep_y_plain(*yk, **hk)),
            ("K7", "y, rob_c", 17,
             lambda: varprop_sweep_y(*yk, rob_c=H_CONV),
             lambda: varprop_sweep_y_plain(*yk, rob_c=H_CONV)),
            ("K8", "z, rad", 13,
             lambda: vp2_sweep_z(*zk, **zkw),
             lambda: vp2_sweep_z_plain(*zk, **zkw)),
            ("K19", "z, h stream", 21,
             lambda: varprop_sweep_z(*z19, **hk),
             lambda: varprop_sweep_z_plain(*z19, **hk)),
            ("K19", "z, rob_c", 17,
             lambda: varprop_sweep_z(*z19, rob_c=H_CONV),
             lambda: varprop_sweep_z_plain(*z19, rob_c=H_CONV)),
        ]
        variants = [v for v in variants if v[0] in which.split()]
        cells = mask.numel()
        where = label if prec == "float32" else f"{label} {prec}"
        esize = T.element_size()
        for kname, vname, bpc4, kern, plain in variants:
            bpc = bpc4 // 4 * esize + bpc4 % 4    # the code stays a byte
            got, want = kern(), plain()
            torch.cuda.synchronize()
            flat = (lambda o: [t for x in (o if isinstance(o, tuple)
                                           else (o,))
                               for t in (x if isinstance(x, tuple)
                                         else (x,))])
            err, ulps = 0.0, 0.0
            for a, b in zip(flat(got), flat(want)):
                check(bool(torch.isfinite(a).all()),
                      f"{kname} {vname} {where}: non-finite output")
                e = float((a - b).abs().max())
                scale = float(b.abs().max())
                err = max(err, e)
                ulps = max(ulps, e / (eps32 * scale) if scale > 0 else 0.0)
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 1, warm=False)
            pct = 100.0 * cells * bpc / (ms * 1e-3) / HBM_BYTES_PER_S
            rows.append(dict(kernel=kname, variant=vname, shape=where,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bytes_per_cell=bpc, pct_hbm=pct,
                             **bound(kname, cells * bpc, cells)))
            # float32: KERNEL_TOL_ULP float32 ulp of the output's scale;
            # float64: 1e-12 of it (KERNEL_TOL_F64)
            tol = (KERNEL_TOL_ULP if prec == "float32" else
                   KERNEL_TOL_F64 / eps32)
            print(f"[phase 2] {kname} {vname:32s} {where:26s} "
                  f"max|d|={err:.3e} ({ulps:.2f} ulp of scale, tol "
                  f"{tol:.4g})  kernel {ms:8.3f} ms  plain "
                  f"{plain_ms:9.3f} ms  {pct:5.1f}% of 3.35 TB/s at {bpc} "
                  f"B/cell", flush=True)
            check(ulps <= tol, f"{kname} {vname} {where}: {ulps:.4g} "
                  f"float32 ulp of the output's scale > {tol:.4g}")
        del T, R, mask, fc, w, h, src
        torch.cuda.empty_cache()
    return rows


def phase3_varprop(torch, dev):
    """The 512^3 float32 varprop step, kernels against reference."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.solvers import launch_counts

    n = P3_N
    grid = CartesianGrid(n, n, n, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    mask = waam_mask(torch, grid.shape, dev)
    T0 = mushy_field(torch, mask, seed=11)
    kt, ct = varprop_tables()
    # float32: z on K8 (K19 takes float64 z, phase 5)
    per_step = {**{k: 0 for k in KERNEL_INFO},
                **{k: 1 for k in ("K5", "K6", "K7", "K8")}}
    plans = {"tables + h 30": dict(robin_h=H_CONV),
             "tables + h 30 + eps 0.5": dict(robin_h=H_CONV,
                                             emissivity=EMISSIVITY)}
    out = {}
    for pname, bcs in plans.items():
        eng = {impl: make_cartesian_engine(
            grid, mat, implementation=impl, device=dev, dtype=torch.float32,
            theta=0.5, t_inf=20.0, k_table=kt, cp_table=ct, **bcs)
            for impl in ("kernels", "reference")}
        prep = {impl: e[0](mask) for impl, e in eng.items()}
        adv_k, adv_r = eng["kernels"][1], eng["reference"][1]
        before = launch_counts()
        # each step: kernels and reference from the reference's state
        T, errs, ref_ms = T0, [], []
        for i in range(P3_STEPS):
            Tk = adv_k(T, prep["kernels"], dt, 1, i * dt)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            Tr = adv_r(T, prep["reference"], dt, 1, i * dt)
            end.record()
            end.synchronize()
            ref_ms.append(start.elapsed_time(end))
            check(bool(torch.isfinite(Tk).all()) and
                  bool(torch.isfinite(Tr).all()),
                  f"phase 3 {pname}: non-finite T")
            errs.append(float((Tk - Tr).abs().max()))
            T = Tr
            del Tk
        # kernels alone: two warm-up steps, then 3 steps from T0 each timed
        adv_k(T0, prep["kernels"], dt, P3_WARMUP, 0.0)
        torch.cuda.synchronize()
        Tf, step_ms = T0, []
        for i in range(P3_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            Tf = adv_k(Tf, prep["kernels"], dt, 1, i * dt)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        free = (Tf - T).abs()
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        want = {k: (2 * P3_STEPS + P3_WARMUP) * v for k, v in per_step.items()}
        check(delta == want, f"phase 3 {pname}: launches {delta} != "
              f"expected {want}")
        ms, rms = statistics.median(step_ms), statistics.median(ref_ms)
        print(f"[phase 3] {n}^3 f32 varprop {pname}: kernels {ms:9.3f} "
              f"ms/step (median; steps "
              f"{', '.join(f'{s:.3f}' for s in step_ms)})  "
              f"{grid.ncells / (ms * 1e-3) / 1e9:7.3f} Gcell/s; reference "
              f"{rms:9.3f} ms/step; launches {delta}", flush=True)
        print(f"[phase 3] {pname}: max|T_kernels - T_reference| per step "
              f"from the reference's state: "
              f"{', '.join(f'{e:.3e}' for e in errs)} K; free-running "
              f"after {P3_STEPS} steps {float(free.max()):.3e} K "
              f"({int((free > STEP_TOL).sum())} cells above {STEP_TOL} K)",
              flush=True)
        check(max(errs) <= STEP_TOL, f"phase 3 {pname}: {max(errs):.3e} K "
              f"> {STEP_TOL}")
        check(float(free.max()) <= STEP_TOL, f"phase 3 {pname}: "
              f"free-running {float(free.max()):.3e} K > {STEP_TOL}")
        out[pname] = dict(ms_kernels=ms, ms_reference=rms,
                          max_abs_err=max(errs),
                          free_running_err=float(free.max()))
        del T, Tf, Tr, free, prep, eng
        torch.cuda.empty_cache()
    return out


def tube_mask(torch, shape, dev):
    """A tube in the making: a substrate (the lower quarter, every
    radius), a half-built wall (the outer half of the radii up to half
    the height) and a top layer deposited over 3/5 of the
    circumference."""
    nr, nphi, nz = shape
    m = torch.zeros(shape, dtype=torch.bool, device=dev)
    m[:, :, :nz // 4] = True
    m[nr // 2:, :, nz // 4:nz // 2] = True
    m[nr // 2:, :(3 * nphi) // 5, nz // 2:nz // 2 + max(1, nz // 16)] = True
    return m


def cyl_plan(torch, grid, mask, kind_bot):
    """The masked-Robin plan of phase 6 (bench.py's BCs: h 300 on the
    radial faces, 400 on the top, 80 on the material/void faces)."""
    from adi_thermal_fields_tpu_torch import (Material, RobinBC, ZFaceBC,
                                              build_masked_robin_plan)
    rob = RobinBC(300.0, 20.0)
    return build_masked_robin_plan(
        grid, Material(7800.0, 490.0, 54.0), mask, robin_outer=rob,
        robin_inner=rob, zbc=ZFaceBC(kind_bot=kind_bot, T_bot=200.0,
                                     kind_top="robin", h_top=400.0),
        h_void=80.0, dtype=torch.float32)


def phase2_cyl(torch, dev):
    """K9-K11 against their plain versions (float32): K9's march bit for
    bit, its lines past kK9MarchRows within the scale's gate."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        masked_cyclic_phi, masked_cyclic_phi_plain, masked_sweep_strided,
        masked_sweep_strided_plain, masked_sweep_z, masked_sweep_z_plain)

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    fac = float(torch.tensor(CYL_DT, dtype=f32)
                * torch.tensor(mat.alpha, dtype=f32))
    rows = []
    for label, shape in CYL_SHAPES:
        tube = label.endswith("tube")
        grid = CylindricalGrid(*shape, 5e-4, 5e-4,
                               r_inner=0.02 if tube else 0.0)
        if tube:
            mask = tube_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(29)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        plan = cyl_plan(torch, grid, mask,
                        "dirichlet" if tube else "neumann0")
        R = random_field(torch, mask, seed=17)
        variants = [
            ("K9", "r", plan.r,
             lambda: masked_sweep_strided(R, *plan.r, fac, 20.0),
             lambda: masked_sweep_strided_plain(R, *plan.r, fac, 20.0)),
            ("K11", "phi (cyclic)", plan.phi,
             lambda: masked_cyclic_phi(R, *plan.phi, fac, 20.0),
             lambda: masked_cyclic_phi_plain(R, *plan.phi, fac, 20.0)),
            ("K10", "z", plan.z,
             lambda: masked_sweep_z(R, *plan.z, fac, 20.0),
             lambda: masked_sweep_z_plain(R, *plan.z, fac, 20.0)),
        ]
        rows += [kernel_row(torch, kname, vname, label, (R, *ins), kern,
                            plain, bitwise=kname == "K9")
                 for kname, vname, ins, kern, plain in variants]
        del R, mask, plan
        torch.cuda.empty_cache()
    # K9 on r lines past its march: the core's strided split kernel
    n = max(K9_LONG_ROWS, int(source_constant("kK9MarchRows",
                                              "masked.cu")) + 1)
    shape = (n, 512, max(8, 2 ** 25 // (512 * n)))
    label = f"{n}x512x{shape[2]} tube"
    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
    mask = tube_mask(torch, shape, dev)
    plan = cyl_plan(torch, grid, mask, "dirichlet")
    R = random_field(torch, mask, seed=17)
    rows.append(kernel_row(
        torch, "K9", "r, split", label, (R, *plan.r),
        lambda: masked_sweep_strided(R, *plan.r, fac, 20.0),
        lambda: masked_sweep_strided_plain(R, *plan.r, fac, 20.0)))
    del R, mask, plan
    torch.cuda.empty_cache()
    for label, shape, dr, r_inner, dtm in K10_SHAPES:     # K10 alone
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        mask = tube_mask(torch, shape, dev)
        plan = cyl_plan(torch, grid, mask, "dirichlet")
        R = random_field(torch, mask, seed=23)
        fz = float(torch.tensor(CYL_DT * dtm, dtype=f32)
                   * torch.tensor(mat.alpha, dtype=f32))
        rows.append(kernel_row(
            torch, "K10", "z", label, (R, *plan.z),
            lambda: masked_sweep_z(R, *plan.z, fz, 20.0),
            lambda: masked_sweep_z_plain(R, *plan.z, fz, 20.0)))
        del R, mask, plan
        torch.cuda.empty_cache()
    for label, shape, dr, r_inner in CYCLIC_SHAPES:        # K11 alone
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        if label.endswith("tube"):
            mask = tube_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(31)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        plan = cyl_plan(torch, grid, mask, "dirichlet")
        R = random_field(torch, mask, seed=23)
        rows.append(kernel_row(
            torch, "K11", "phi (cyclic)", label, (R, *plan.phi),
            lambda: masked_cyclic_phi(R, *plan.phi, fac, 20.0),
            lambda: masked_cyclic_phi_plain(R, *plan.phi, fac, 20.0)))
        del R, mask, plan
        torch.cuda.empty_cache()
    return rows


def kernel_row(torch, kname, vname, where, ins, kern, plain, tol_k=None,
               scale_too=False, bitwise=False):
    """A kernel against its plain version on one input: within tol_k K
    (and, where scale_too, the scale's gate too), or without it within
    KERNEL_TOL_ULP float32 ulp of the output's scale (KERNEL_TOL_F64 of
    it at float64), and where ``bitwise`` bit for bit; its summary row
    (each input read once, the output written once)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()),
          f"{kname} {vname} {where}: non-finite output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ulps = err / (torch.finfo(got.dtype).eps * scale)
    lim = (KERNEL_TOL_F64 if got.dtype == torch.float64 else
           KERNEL_TOL_ULP * torch.finfo(torch.float32).eps) * scale
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, got))
    cells = got.numel()
    ms = cuda_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, plain, 1, warm=False)
    pct = 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
    gate = ("bitwise" if bitwise else f"tol {KERNEL_TOL_ULP}"
            if got.dtype == torch.float32 else
            f"tol {KERNEL_TOL_F64:.0e} of scale")
    tol = gate if tol_k is None else f"tol {tol_k:.0e} K" + (
        f", {gate}" if scale_too else "")
    print(f"[phase 2] {kname} {vname:32s} {where:26s} max|d|={err:.3e} K "
          f"({ulps:.2f} ulp of scale, {tol})  kernel {ms:8.3f} ms  plain "
          f"{plain_ms:9.3f} ms  {pct:5.1f}% of 3.35 TB/s at "
          f"{nbytes / cells:.2f} B/cell", flush=True)
    if bitwise:
        check(torch.equal(got, want), f"{kname} {vname} {where}: max|d| "
              f"{err:.3e} from its plain version, not bitwise")
    if tol_k is None or scale_too:
        check(err <= lim, f"{kname} {vname} {where}: max|d| {err:.3e} from "
              f"its plain version > {lim:.3e} (the scale's gate)")
    if tol_k is not None:
        check(err <= tol_k, f"{kname} {vname} {where}: max|d| {err:.3e} K > "
              f"{tol_k:.0e} K")
    return dict(kernel=kname, variant=vname, shape=where, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bytes_per_cell=nbytes / cells,
                pct_hbm=pct, **bound(kname, nbytes, cells))


def phase6_step(torch, dev):
    """The (64, 512, 1024) float32 masked-Robin step, kernels against
    reference, and the plan rebuild on its own."""
    from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material,
                                              masked_robin_solve)
    from adi_thermal_fields_tpu_torch.solvers import launch_counts

    label, shape = CYL_SHAPES[0]
    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    mask = tube_mask(torch, shape, dev)
    T0 = random_field(torch, mask, seed=19)
    plan_ms = cuda_ms(torch, lambda: cyl_plan(torch, grid, mask, "neumann0"),
                      5)
    plan = cyl_plan(torch, grid, mask, "neumann0")
    per_step = {k: int(k in CYL_KERNELS) for k in KERNEL_INFO}
    res = {}
    for impl in ("kernels", "reference"):
        before = launch_counts()
        T = T0
        for _ in range(P3_WARMUP):
            T = masked_robin_solve(T, plan, grid, mat, dt=CYL_DT,
                                   implementation=impl)
        torch.cuda.synchronize()
        T, step_ms = T0, []
        for _ in range(P3_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            T = masked_robin_solve(T, plan, grid, mat, dt=CYL_DT,
                                   implementation=impl)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        want = {k: (P3_WARMUP + P3_STEPS) * v if impl == "kernels" else 0
                for k, v in per_step.items()}
        check(delta == want, f"phase 6 step {impl}: launches {delta} != "
              f"expected {want}")
        check(bool(torch.isfinite(T).all()), f"phase 6 step {impl}: "
              "non-finite T")
        ms = statistics.median(step_ms)
        res[impl] = (T, ms)
        print(f"[phase 6] {label} f32 masked-Robin step {impl:9s}: "
              f"{ms:9.3f} ms/step (median; steps "
              f"{', '.join(f'{s:.3f}' for s in step_ms)})  "
              f"{grid.ncells / (ms * 1e-3) / 1e9:7.3f} Gcell/s  launches "
              f"{ {k: v for k, v in delta.items() if v} }", flush=True)
    err = float((res["kernels"][0] - res["reference"][0]).abs().max())
    print(f"[phase 6] plan rebuild {plan_ms:.3f} ms (median of 5); "
          f"max|T_kernels - T_reference| = {err:.3e} K after {P3_STEPS} "
          "steps", flush=True)
    check(err <= STEP_TOL, f"phase 6 step: {err:.3e} K > {STEP_TOL}")
    return dict(ms_kernels=res["kernels"][1],
                ms_reference=res["reference"][1], plan_ms=plan_ms,
                max_abs_err=err)


def spiral_app(torch, dev, phase, extra=(), impls=("kernels", "reference"),
               tol=APP_TOL, overshoot=0.0):
    """apps/spiral_tube on the 4.6 M-cell tube with each of ``impls``;
    ``extra``: flags added to P6_APP (later flags override).  With two
    implementations, they must agree within ``tol``.  Tmax must stay at
    or below --Ts + ``overshoot`` K (backward Euler is monotone: 0;
    Douglas-Gunn at theta 0.5 is not, and overshoots at a fresh deposit's
    edges: DOUGLAS_OVERSHOOT)."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.apps import spiral_tube as app

    mode = " ".join(extra) or "--void_mode robin"
    runs = {}
    for impl in impls:
        args = app.build_argparser().parse_args(
            P6_APP + list(extra) + ["--device", str(dev),
                                    "--implementation", impl])
        t0 = time.perf_counter()
        res = app.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[impl] = (res, wall)
        T = res["T"]
        a3 = torch.from_numpy(np.ascontiguousarray(res["active"])).to(dev)
        tmax = float(T[a3[None].expand(T.shape)].max())
        deposited = np.isfinite(res["activation_times"])
        born = res["activation_times"] < res["t"]
        print(f"[phase {phase}] spiral app {mode} {args.precision} "
              f"{impl:9s}: grid {res['grid'].shape} "
              f"({res['grid'].ncells / 1e6:.2f} M cells), {res['steps']} "
              f"steps, {res['plans_built']} plan builds, "
              f"{int(born.sum())} active columns ({int(deposited.sum())} "
              f"deposited by the nozzle), wall {wall:.2f} s, Tmax "
              f"{tmax:.2f} C", flush=True)
        check(bool(torch.isfinite(T).all()), f"spiral app {impl}: "
              "non-finite T")
        t_cap = args.Ts + overshoot
        check(tmax <= t_cap, f"spiral app {impl}: Tmax {tmax} > {t_cap}")
        check(all(float(np.nanmax(np.where(a, f, np.nan))) <= t_cap
                  for _, f, a in res["frames"]),
              f"spiral app {impl}: a frame's Tmax exceeds {t_cap}")
        check(born.any() and bool(res["active"][born].all()),
              f"spiral app {impl}: a deposited column is not active")
    if "reference" not in runs:
        return dict(wall_kernels=runs["kernels"][1],
                    T_kernels=runs["kernels"][0]["T"],
                    active=runs["kernels"][0]["active"])
    diff = (runs["kernels"][0]["T"] - runs["reference"][0]["T"]).abs()
    err = float(diff.max())
    print(f"[phase {phase}] spiral app {mode}: max|T_kernels - "
          f"T_reference| = "
          f"{err:.3e} K ({int((diff > tol).sum())} cells above "
          f"{tol} K)", flush=True)
    check(err <= tol, f"spiral app: kernels vs reference {err:.3e} K "
          f"> {tol} K")
    return dict(wall_kernels=runs["kernels"][1],
                wall_reference=runs["reference"][1], max_abs_err=err,
                T_kernels=runs["kernels"][0]["T"])


def be_case(label, shape):
    """Grid, material and BCs of a phase 7 configuration."""
    from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material,
                                              RobinBC, ZFaceBC)
    annular = label.endswith("annular")
    grid = CylindricalGrid(*shape, 5e-4, 5e-4,
                           r_inner=0.02 if annular else 0.0)
    zbc = ZFaceBC(kind_bot="neumann0" if annular else "dirichlet",
                  T_bot=200.0, kind_top="robin", h_top=400.0, T_inf_top=20.0)
    return grid, Material(7800.0, 490.0, 54.0), RobinBC(300.0, 20.0), zbc


def dense_inverse_call(torch, vecs, axis, R):
    """One PyTorch call computing K12's (axis 0) or K13's (last axis)
    function on R: addmm by the dense inverse of the constant per-row
    matrix (inverted in float64 once, rounded to R's dtype), with the
    inverse applied to radd folded into the bias."""
    a, b, c, radd = (v.double() for v in vecs)
    n = a.numel()
    A = torch.diag(b) + torch.diag(a[1:], -1) + torch.diag(c[:-1], 1)
    inv = torch.linalg.inv(A)
    w = (inv @ radd).to(R.dtype)
    inv = inv.to(R.dtype)
    if axis == 0:
        d2, bias = R.view(n, -1), w[:, None]
        return lambda: torch.addmm(bias, inv, d2)
    d2, bias, inv_t = R.view(-1, n), w[None, :], inv.T.contiguous()
    return lambda: torch.addmm(bias, d2, inv_t)


def phase2_be(torch, dev):
    """K12-K14 against their plain versions (float32), and the PyTorch
    call computing each one's function; K12's and K13's tables (K13t) and
    K14's (K14t) bit for bit their plain versions'; K12 on lines past its
    march."""
    from adi_thermal_fields_tpu_torch.solvers import (
        const_sweep_strided, const_sweep_strided_plain, const_sweep_table,
        const_sweep_table_plain, const_sweep_z,
        const_sweep_z_plain, cyclic_const_phi, cyclic_const_phi_plain,
        cyclic_const_phi_table, cyclic_const_phi_table_plain,
        phi_solve_spectral)
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    f32 = torch.float32
    k12_march = int(source_constant("kK12MarchRows", "const_sweeps.cu"))
    rows = []
    for label, shape in P7_SHAPES:
        grid, mat, rob, zbc = be_case(label, shape)
        R = random_field(torch, torch.ones(shape, dtype=torch.bool,
                                           device=dev), seed=23)
        # the step's own coefficient vectors
        r_vecs = cyl._r_coefficients(grid, mat, rob, None, P7_DT, f32, dev)
        z_vecs, _ = cyl._z_coefficients(grid, mat, zbc, P7_DT, f32, dev)
        fac = cyl._phi_fac(grid, mat, 1.0, P7_DT, f32, dev)
        # K14 with its table, as the step keeps it for its dt; the rings
        # it solves in Thomas order (2 fac past kK14Stiff)
        table = cyl._phi_table(grid, mat, 1.0, P7_DT, f32, dev)
        stiff = source_constant("kK14Stiff", "const_sweeps.cu")
        flagged = int((2.0 * fac > stiff).sum())
        print(f"[phase 2] K14 {label}: {flagged} of {grid.nr} rings past "
              f"2 fac = {stiff:g} ({100.0 * flagged / grid.nr:.1f}%, "
              f"Thomas order; largest 2 fac {float(2.0 * fac.max()):.1f})",
              flush=True)
        rows.append(table_row(torch, "K14t", label, (fac,), fac.numel()
                              * grid.nphi,
                              lambda: cyclic_const_phi_table(fac, grid.nphi),
                              lambda: cyclic_const_phi_table_plain(
                                  fac, grid.nphi)))
        # K13 with its table, as the step keeps it for its dt; past
        # kK13Stiff the lines go to Thomas order
        z_table = cyl._z_table(grid, mat, zbc, P7_DT, f32, dev)
        zs = source_constant("kK13Stiff", "const_sweeps.cu")
        ratio = float(z_table[-1])
        print(f"[phase 2] K13 {label}: its table's stiffness ratio "
              f"{ratio:.3f} ({'past' if ratio > zs else 'below'} "
              f"kK13Stiff = {zs:g}: "
              f"{'Thomas order' if ratio > zs else 'split'})", flush=True)
        rows.append(table_row(torch, "K13t", label, z_vecs[:3], grid.nz,
                              lambda: const_sweep_table(*z_vecs[:3]),
                              lambda: const_sweep_table_plain(
                                  *z_vecs[:3])))
        # K12 with its table, as the step keeps it for its dt (K13t's
        # kernel builds it)
        r_key = (grid, mat, rob, None, P7_DT, f32, dev)
        r_table = cyl._r_table(*r_key)
        rows.append(table_row(torch, "K13t", f"{label} r", r_vecs[:3],
                              grid.nr,
                              lambda: const_sweep_table(*r_vecs[:3]),
                              lambda: const_sweep_table_plain(
                                  *r_vecs[:3])))
        variants = [
            ("K12", "r", (*r_vecs, r_table),
             lambda: const_sweep_strided(R, *r_vecs, r_table),
             lambda: const_sweep_strided_plain(R, *r_vecs),
             dense_inverse_call(torch, r_vecs, 0, R)),
            ("K14", "phi (cyclic)", (fac, table),
             lambda: cyclic_const_phi(R, fac, table),
             lambda: cyclic_const_phi_plain(R, fac),
             lambda: phi_solve_spectral(R, grid, mat, 1.0, P7_DT)),
            ("K13", "z", (*z_vecs, z_table),
             lambda: const_sweep_z(R, *z_vecs, z_table),
             lambda: const_sweep_z_plain(R, *z_vecs),
             dense_inverse_call(torch, z_vecs, 2, R)),
        ]
        for kname, vname, ins, kern, plain, lib in variants:
            # K12 marches (bit for bit) lines of up to kK12MarchRows rows
            bitwise = (kname == "K13" and ratio > zs
                       or kname == "K12" and grid.nr <= k12_march)
            rows.append(be_row(torch, kname, vname, label, R, ins, kern,
                               plain, lib, bitwise))
        del R, variants
        torch.cuda.empty_cache()
    # K12 on r lines past its march (the split kernel): K12_LONG_ROWS rows
    # (or one past the march, if longer), 512 phi rows, ~2^25 cells
    n = max(K12_LONG_ROWS, k12_march + 1)
    shape = (n, 512, max(8, 2 ** 25 // (512 * n)))
    label = f"{n}x512x{shape[2]} annular"
    grid, mat, rob, _ = be_case(label, shape)
    r_key = (grid, mat, rob, None, P7_DT, f32, dev)
    r_vecs, r_table = cyl._r_coefficients(*r_key), cyl._r_table(*r_key)
    R = random_field(torch, torch.ones(shape, dtype=torch.bool, device=dev),
                     seed=23)
    rows.append(be_row(torch, "K12", "r, split", label, R,
                       (*r_vecs, r_table),
                       lambda: const_sweep_strided(R, *r_vecs, r_table),
                       lambda: const_sweep_strided_plain(R, *r_vecs),
                       dense_inverse_call(torch, r_vecs, 0, R), False))
    del R
    torch.cuda.empty_cache()
    # K13 on the disk at a dt whose table passes kK13Stiff (twice it; the
    # ratio grows as dt): Thomas order, bit for bit
    label, shape = P7_SHAPES[1]
    grid, mat, _, zbc = be_case(label, shape)
    zs = source_constant("kK13Stiff", "const_sweeps.cu")
    base, _ = cyl._z_coefficients(grid, mat, zbc, P7_DT, f32, dev)
    dt = P7_DT * 2.0 * zs / float(const_sweep_table(*base[:3])[-1])
    z_vecs, _ = cyl._z_coefficients(grid, mat, zbc, dt, f32, dev)
    z_table = const_sweep_table(*z_vecs[:3])
    check(float(z_table[-1]) > zs, f"K13 {label} at {dt:g} s: its table's "
          f"ratio {float(z_table[-1]):.1f} is not past kK13Stiff")
    R = random_field(torch, torch.ones(shape, dtype=torch.bool, device=dev),
                     seed=23)
    rows.append(kernel_row(
        torch, "K13", "z, Thomas order", f"{label} {dt:.3g} s",
        (R, *z_vecs, z_table), lambda: const_sweep_z(R, *z_vecs, z_table),
        lambda: const_sweep_z_plain(R, *z_vecs), bitwise=True))
    del R
    return rows


def be_row(torch, kname, vname, label, R, ins, kern, plain, lib, bitwise):
    """K12, K13 or K14 on R against its plain version: within
    KERNEL_TOL_ULP float32 ulp of the output's scale, and where
    ``bitwise`` bit for bit; its times, its share of 3.35 TB/s (R read
    once and written once, and ``ins``) and the PyTorch call's time."""
    f32 = torch.float32
    got, want, lib_out = kern(), plain(), lib().view(R.shape)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()),
          f"{kname} {vname} {label}: non-finite output")
    err = float((got - want).abs().max())
    ulps = err / (torch.finfo(f32).eps * float(want.abs().max()))
    lib_err = float((lib_out - want).abs().max())
    cells = R.numel()
    nbytes = 2 * cells * R.element_size() + sum(
        t.numel() * t.element_size() for t in ins)
    ms = cuda_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, plain, 1, warm=False)
    lib_ms = cuda_ms(torch, lib, 10)
    pct = 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
    gate = "bitwise" if bitwise else f"tol {KERNEL_TOL_ULP}"
    print(f"[phase 2] {kname} {vname:32s} {label:20s} "
          f"max|d|={err:.3e} K ({ulps:.2f} ulp of scale, {gate})  kernel "
          f"{ms:8.3f} ms  plain {plain_ms:9.3f} ms  {pct:5.1f}% of 3.35 "
          f"TB/s at {nbytes / cells:.2f} B/cell; PyTorch call "
          f"{lib_ms:8.3f} ms (max|d| {lib_err:.3e} K)", flush=True)
    check(ulps <= KERNEL_TOL_ULP, f"{kname} {vname} {label}: {ulps:.2f} "
          f"float32 ulp of the output's scale > {KERNEL_TOL_ULP}")
    check(not bitwise or torch.equal(got, want), f"{kname} {vname} "
          f"{label}: not bit for bit its plain version")
    return dict(kernel=kname, variant=vname, shape=label, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bytes_per_cell=nbytes / cells, pct_hbm=pct,
                **bound(kname, nbytes, cells))


def table_row(torch, kname, label, ins, cells, kern, plain):
    """A table kernel (K13t, K14t) against its plain version: bit for bit;
    its time once per dt, its bound (``ins`` read, the table written;
    ``cells``: the rows it forms)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"{kname} table {label}: max|d| "
          f"{err:.3e} from its plain version, not bitwise")
    nbytes = (sum(t.numel() for t in ins) + got.numel()) * got.element_size()
    ms = cuda_ms(torch, kern, 10)
    plain_ms = cuda_ms(torch, plain, 1, warm=False)
    b = bound(kname, nbytes, cells)
    print(f"[phase 2] {kname} table {label:20s} bitwise  kernel {ms:8.3f} ms"
          f"  plain {plain_ms:9.3f} ms  bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}); once per dt", flush=True)
    return dict(kernel=kname, variant="table", shape=label,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes_per_cell=nbytes / cells, **b)


def phase7_step(torch, dev):
    """The (128, 512, 512) float32 unmasked step, BE then Douglas, kernels
    against reference."""
    from adi_thermal_fields_tpu_torch import adi_step_cylindrical
    from adi_thermal_fields_tpu_torch.solvers import launch_counts
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    label, shape = P7_SHAPES[0]
    grid, mat, rob, zbc = be_case(label, shape)
    T0 = random_field(torch, torch.ones(shape, dtype=torch.bool, device=dev),
                      seed=31)
    # K12-K14 once a step; their tables once a run: built at the first
    # step, then kept for the dt (K13t's kernel builds K12's r table and
    # K13's z table, K14t's K14's ring table)
    tables = {"K13t": 2, "K14t": 1}
    per_step = {k: int(k in BE_KERNELS and k not in tables)
                for k in KERNEL_INFO}
    out = {}
    for scheme in ("be", "douglas"):
        res = {}
        for impl in ("kernels", "reference"):
            def step(T):
                return adi_step_cylindrical(
                    T, grid, mat, dt=P7_DT, robin_outer=rob, zbc=zbc,
                    scheme=scheme, implementation=impl)
            cyl._phi_table.cache_clear()
            cyl._r_table.cache_clear()
            cyl._z_table.cache_clear()
            before = launch_counts()
            T = T0
            for _ in range(P3_WARMUP):
                T = step(T)
            torch.cuda.synchronize()
            T, step_ms = T0, []
            for _ in range(P3_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                T = step(T)
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            want = {k: (P3_WARMUP + P3_STEPS) * v if impl == "kernels"
                    else 0 for k, v in per_step.items()}
            want.update({k: v * (impl == "kernels")
                         for k, v in tables.items()})
            check(delta == want, f"phase 7 {scheme} {impl}: launches "
                  f"{delta} != expected {want}")
            check(bool(torch.isfinite(T).all()), f"phase 7 {scheme} {impl}: "
                  "non-finite T")
            ms = statistics.median(step_ms)
            res[impl] = (T, ms)
            print(f"[phase 7] {label} f32 {scheme} step {impl:9s}: "
                  f"{ms:9.3f} ms/step (median; steps "
                  f"{', '.join(f'{s:.3f}' for s in step_ms)})  "
                  f"{grid.ncells / (ms * 1e-3) / 1e9:7.3f} Gcell/s  launches "
                  f"{ {k: v for k, v in delta.items() if v} }", flush=True)
        err = float((res["kernels"][0] - res["reference"][0]).abs().max())
        print(f"[phase 7] {scheme}: max|T_kernels - T_reference| = {err:.3e} "
              f"K after {P3_STEPS} steps", flush=True)
        check(err <= STEP_TOL, f"phase 7 {scheme} step: {err:.3e} K > "
              f"{STEP_TOL}")
        out[scheme] = dict(ms_kernels=res["kernels"][1],
                           ms_reference=res["reference"][1],
                           max_abs_err=err)
        del res
        torch.cuda.empty_cache()
    return out


def cylvp_case(torch, label, shape, dtype, dev, dr=5e-4, r_inner=None):
    """Grid, material, mask, z BCs and T^n of a phase 8 configuration:
    bench.py's cyl_varprop tube (the lower half deposited, a layer over
    3/5 of the circumference above it), or a full disk with a random
    mask and a Dirichlet bottom; T across 1400-1500 C on the mask.  The
    tube's inner radius is 20 mm unless ``r_inner`` is given."""
    from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material,
                                              ZFaceBC)
    tube = label.endswith("tube")
    nr, nphi, nz = shape
    if r_inner is None:
        r_inner = 0.02 if tube else 0.0
    grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
    if tube:
        mask = torch.zeros(shape, dtype=torch.bool, device=dev)
        mask[:, :, :nz // 2] = True
        mask[:, :(3 * nphi) // 5, nz // 2:nz // 2 + nz // 8] = True
        zbc = ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0)
    else:
        g = torch.Generator(device=dev).manual_seed(37)
        mask = torch.rand(shape, generator=g, device=dev) > 0.25
        zbc = ZFaceBC(kind_bot="dirichlet", T_bot=1400.0, kind_top="robin",
                      h_top=400.0, T_inf_top=20.0)
    g = torch.Generator(device=dev).manual_seed(41)
    T = torch.where(mask, 1400.0 + 100.0 * torch.rand(
        shape, generator=g, device=dev), 20.0)
    T.view(-1)[::97] = SOLIDUS
    T.view(-1)[31::101] = LIQUIDUS
    return grid, Material(7800.0, 490.0, 54.0), mask, zbc, T.to(dtype)


def k17_streams(torch, grid, mat, mask, T, R, dt, seed=47):
    """K17's r and z streams (rhs, fhi, dw, sink, srhs), natural layout,
    built from T as the stream tier builds them (k(T), dw = dt/(rho
    cp(T)), the hi faces, a film on a fifth of the cells)."""
    from adi_thermal_fields_tpu_torch.solvers.varprop import face_g
    kt, ct = varprop_tables()
    kf = kt(T)
    dw = dt / (mat.rho * ct(T))
    fr = face_g(kf, 0, -1, mask)
    fr_hi = torch.cat([fr[1:], torch.zeros_like(fr[:1])], 0)
    fz = face_g(kf, 2, -1, mask)
    fz_hi = torch.cat([fz[:, :, 1:], torch.zeros_like(fz[:, :, :1])], 2)
    g = torch.Generator(device=T.device).manual_seed(seed)
    film = torch.rand(T.shape, generator=g, device=T.device) < 0.2
    sink = torch.where(film & mask, 80.0 / grid.dz, 0.0).to(T.dtype)
    srhs = sink * 20.0
    return (R, fr_hi, dw, sink, srhs), (R, fz_hi, dw, sink, srhs)


def k17_rows(torch, streams, glo, ghi, axis):
    """The rows K17 forms from its streams along ``axis`` as a/b/c/d
    fields (the plain version's, and the cylindrical ``fields`` tier's
    rows for K21)."""
    from adi_thermal_fields_tpu_torch.bc.faces import shift_in
    rhs, fhi, dw, sink, srhs = streams
    shape = [1] * rhs.dim()
    shape[axis] = -1
    al = glo.view(shape) * shift_in(fhi, axis, -1, fill=0.0)
    ch = ghi.view(shape) * fhi
    return (-dw * al, 1.0 + dw * (al + ch + sink), -dw * ch,
            rhs + dw * srhs)


def k18_rows(torch, streams, geo):
    """The rows K18 forms from its streams along axis 1 as a/b/c/d fields
    (the plain version's, and the cylindrical ``fields`` tier's rows for
    K22)."""
    rhs, flo, dw, sink, srhs = streams
    g3 = geo[:, None, None]
    fhi = torch.roll(flo, -1, 1)
    return (-(dw * (g3 * flo)), 1.0 + dw * (g3 * (flo + fhi) + sink),
            -(dw * (g3 * fhi)), rhs + dw * srhs)


def field_systems(torch, shape, dtype, dev, seed):
    """Diagonally dominant a/b/c fields (the rows of an implicit sweep)
    and a right-hand side over 20-1500: K21's phase 9 inputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = -torch.rand(shape, generator=g, device=dev, dtype=dtype)
    c = -torch.rand(shape, generator=g, device=dev, dtype=dtype)
    b = 1.0 + 2.0 * torch.rand(shape, generator=g, device=dev,
                               dtype=dtype) - a - c
    R = (20.0 + 1480.0 * torch.rand(shape, generator=g, device=dev)
         ).to(dtype)
    return a, b, c, R


def line_streams(torch, shape, axis, dev, seed):
    """Float32 K17 streams on ``shape`` at the tube's scale (coupling
    dw*glo*fhi ~ 2) and a metric column along ``axis``: the 8192-row
    lines of phase 8."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = (lambda *s: torch.rand(s or shape, generator=g, device=dev))
    streams = (20.0 + 1480.0 * rnd(), 54.0 * (1.0 + 3.0 * rnd()),
               2.0 / 216.0 / 4e6 * (0.5 + rnd()), 3e3 * rnd(), 6e4 * rnd())
    return streams, 4e6 * (1.0 + 0.1 * rnd(shape[axis]))


def k8_general_kw(torch, grid, cols):
    """K8's general form's keywords in phase 8: the z columns of the
    cylindrical step (ghi = glo, zero at Dirichlet rows; gsh = gsl), lo
    and hi films of 80 and 200 W/m^2K, the top edge film, radiation."""
    kt, ct = varprop_tables()
    return dict(k_spec=kt, cp_spec=ct, ghi=cols["geo_z"], gsh=cols["gs_z"],
                h=80.0, h_hi=200.0, t_inf=20.0, emissivity=EMISSIVITY,
                edge1=(400.0, 1.0 / grid.dz, 20.0))


def phase2_cylvp(torch, dev):
    """K15, K16, K8's general form, K17 and K18 against their plain
    versions (float32 and float64), and K22 on K18's rows."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.solvers import (
        cyclic_fields, cyclic_fields_plain,
        vp2_cyclic_phi, vp2_cyclic_phi_plain, vp2_sweep_strided,
        vp2_sweep_strided_plain, vp2_sweep_z, vp2_sweep_z_plain,
        vp_fields_cyclic_phi, vp_fields_cyclic_phi_plain,
        vp_fields_sweep_strided, vp_fields_sweep_strided_plain,
        vp_fields_sweep_z, vp_fields_sweep_z_plain)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    kt, ct = varprop_tables()
    rows = []
    for label, shape, prec in P8_SHAPES:
        dtype = getattr(torch, prec)
        f = getattr(np, prec)
        grid, mat, mask, zbc, T = cylvp_case(torch, label, shape, dtype, dev)
        R = random_field(torch, mask, seed=43).to(dtype)
        code_r, code_p, code_z = cvp.build_cyl_vp2_plan(mask, grid, zbc)
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        inv = float(f(1.0) / f(f(P8_DT) / f(mat.rho)))
        r, r_imh, r_iph = cvp._radii(grid)
        dr = grid.dr
        rk = dict(k_spec=kt, cp_spec=ct, h_lo=80.0, h_hi=80.0,
                  tinf_void=20.0, emissivity=EMISSIVITY,
                  edge0=((50.0, r_imh[0] / (r[0] * dr), 20.0)
                         if grid.is_annular else None),
                  edge1=(300.0, r_iph[-1] / (r[-1] * dr), 20.0))
        rc = (cols["glo_r"], cols["ghi_r"], cols["gsl_r"], cols["gsh_r"])
        pk = dict(k_spec=kt, cp_spec=ct, h_void=80.0, tinf_void=20.0,
                  emissivity=EMISSIVITY)
        zk = k8_general_kw(torch, grid, cols)
        # the stream tier's inputs, built from T as the step builds them
        sr, sz = k17_streams(torch, grid, mat, mask, T, R, P8_DT)
        sp = (R, cvp._face_phi(kt(T), mask), *sr[2:])
        ap = k18_rows(torch, sp, cols["geo_p"])
        variants = [
            ("K15", "r", (R, T, code_r),
             lambda: vp2_sweep_strided(R, T, code_r, *rc, inv, **rk),
             lambda: vp2_sweep_strided_plain(R, T, code_r, *rc, inv, **rk)),
            ("K15", "r, rhs is T", (T, code_r),
             lambda: vp2_sweep_strided(None, T, code_r, *rc, inv, **rk),
             lambda: vp2_sweep_strided_plain(None, T, code_r, *rc, inv,
                                             **rk)),
            ("K16", "phi (cyclic)", (R, T, code_p),
             lambda: vp2_cyclic_phi(R, T, code_p, cols["geo_p"],
                                    cols["gs_p"], inv, **pk),
             lambda: vp2_cyclic_phi_plain(R, T, code_p, cols["geo_p"],
                                          cols["gs_p"], inv, **pk)),
            ("K8", "z, cylindrical", (R, T, code_z),
             lambda: vp2_sweep_z(R, T, code_z, cols["geo_z"], cols["gs_z"],
                                 inv, **zk),
             lambda: vp2_sweep_z_plain(R, T, code_z, cols["geo_z"],
                                       cols["gs_z"], inv, **zk)),
            ("K17", "r", sr,
             lambda: vp_fields_sweep_strided(*sr, cols["glo_r"],
                                             cols["ghi_r"]),
             lambda: vp_fields_sweep_strided_plain(*sr, cols["glo_r"],
                                                   cols["ghi_r"])),
            ("K17", "z (natural)", sz,
             lambda: vp_fields_sweep_z(*sz, cols["geo_z"], cols["geo_z"]),
             lambda: vp_fields_sweep_z_plain(*sz, cols["geo_z"],
                                             cols["geo_z"])),
            ("K18", "phi (cyclic)", sp,
             lambda: vp_fields_cyclic_phi(*sp, cols["geo_p"]),
             lambda: vp_fields_cyclic_phi_plain(*sp, cols["geo_p"])),
            ("K22", "phi, fields tier rows", ap,
             lambda: cyclic_fields(*ap, 1),
             lambda: cyclic_fields_plain(*ap, 1)),
        ]
        cells = T.numel()
        tol = P8_TOL[prec]
        where = f"{label} {prec}"
        for kname, vname, ins, kern, plain in variants:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{kname} {vname} {where}: non-finite output")
            err = float((got - want).abs().max())
            ulps = err / (torch.finfo(dtype).eps * float(want.abs().max()))
            # each input read once, the output written once
            nbytes = sum(t.numel() * t.element_size() for t in (*ins, got))
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 1, warm=False)
            pct = 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
            rows.append(dict(kernel=kname, variant=vname, shape=where,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bytes_per_cell=nbytes / cells, pct_hbm=pct,
                             **bound(kname, nbytes, cells)))
            print(f"[phase 2] {kname} {vname:32s} {where:26s} "
                  f"max|d|={err:.3e} K ({ulps:.2f} ulp of scale, tol "
                  f"{tol:.0e} K)  kernel {ms:8.3f} ms  plain "
                  f"{plain_ms:9.3f} ms  {pct:5.1f}% of 3.35 TB/s at "
                  f"{nbytes / cells:.2f} B/cell", flush=True)
            check(err <= tol, f"{kname} {vname} {where}: max|d| "
                  f"{err:.3e} K > {tol:.0e} K")
            if kname in ("K8", "K15", "K17", "K18", "K22"):
                # lines split across threads: also KERNEL_TOL_ULP float32
                # ulp of the output's scale, KERNEL_TOL_F64 of it at
                # float64
                lim = (KERNEL_TOL_ULP * torch.finfo(torch.float32).eps
                       if prec == "float32" else KERNEL_TOL_F64) \
                    * float(want.abs().max())
                check(err <= lim, f"{kname} {vname} {where}: max|d| "
                      f"{err:.3e} from its plain version > {lim:.3e}")
            del got, want
        del T, R, variants, sr, sz, sp, ap
        torch.cuda.empty_cache()
    # K8's general form, K17 and K18 (and K21 and K22 on the same rows,
    # the fields tier's) on the tube at 10x the step's dt (rows past
    # kK8Stiff, kOpenStiff and kCyclicFieldStiff: Thomas order), K8's
    # general form and K17 on 8192-row lines (the core's global reduced
    # rows; z past its staging)
    from adi_thermal_fields_tpu_torch.solvers import (tridiag_fields,
                                                      tridiag_fields_plain)
    label, shape, _ = P8_SHAPES[0]
    grid, mat, mask, zbc, T = cylvp_case(torch, label, shape, torch.float32,
                                         dev)
    R = random_field(torch, mask, seed=43)
    cols = cvp._vp2_columns(grid, zbc, torch.float32, dev)
    sr, sz = k17_streams(torch, grid, mat, mask, T, R, 10.0 * P8_DT)
    where = f"{label} float32, 10x dt"
    f32 = np.float32
    code_z = cvp.build_cyl_vp2_plan(mask, grid, zbc)[2]
    zargs = (R, T, code_z, cols["geo_z"], cols["gs_z"],
             float(f32(1.0) / f32(f32(10.0 * P8_DT) / f32(mat.rho))))
    zk = k8_general_kw(torch, grid, cols)
    rows.append(kernel_row(torch, "K8", "z, cylindrical", where,
                           (R, T, code_z),
                           lambda: vp2_sweep_z(*zargs, **zk),
                           lambda: vp2_sweep_z_plain(*zargs, **zk),
                           tol_k=P8_TOL["float32"], scale_too=True))
    del code_z, zargs
    for vname, st, axis, gl, gh, kern, plain in (
            ("r", sr, 0, cols["glo_r"], cols["ghi_r"],
             vp_fields_sweep_strided, vp_fields_sweep_strided_plain),
            ("z (natural)", sz, 2, cols["geo_z"], cols["geo_z"],
             vp_fields_sweep_z, vp_fields_sweep_z_plain)):
        rows.append(kernel_row(torch, "K17", vname, where, st,
                               lambda: kern(*st, gl, gh),
                               lambda: plain(*st, gl, gh)))
        abcd = k17_rows(torch, st, gl, gh, axis)
        rows.append(kernel_row(
            torch, "K21", f"{'rz'[axis // 2]}, fields tier rows", where,
            abcd, lambda: tridiag_fields(*abcd, axis),
            lambda: tridiag_fields_plain(*abcd, axis)))
        del abcd
    sp = (R, cvp._face_phi(kt(T), mask), *sr[2:])
    rows.append(kernel_row(
        torch, "K18", "phi (cyclic)", where, sp,
        lambda: vp_fields_cyclic_phi(*sp, cols["geo_p"]),
        lambda: vp_fields_cyclic_phi_plain(*sp, cols["geo_p"]),
        tol_k=P8_TOL["float32"], scale_too=True))
    ap = k18_rows(torch, sp, cols["geo_p"])
    rows.append(kernel_row(torch, "K22", "phi, fields tier rows", where, ap,
                           lambda: cyclic_fields(*ap, 1),
                           lambda: cyclic_fields_plain(*ap, 1)))
    del T, R, sr, sz, sp, ap, mask
    torch.cuda.empty_cache()
    # K15 (the rhs T, as the BE step calls it) on a tube whose r lines are
    # one row past kK15MarchRows: the strided split kernel, held to the
    # scale's gate (KERNEL_TOL_ULP), as the split kernels are; its distance
    # from P8_TOL is printed, not gated (on the H100 the split kernel parts
    # from the plain version by 6.2-6.9 float32 ulp of scale, 1.0-1.2e-3 K,
    # on such r lines of 64-256 rows: PERF.md section 6)
    n = int(source_constant("kK15MarchRows", "vp2_sweep.cu")) + 1
    shape = (n, 512, max(8, 2 ** 25 // (512 * n)))
    label = f"{'x'.join(map(str, shape))} tube"
    grid, mat, mask, zbc, T = cylvp_case(torch, label, shape, torch.float32,
                                         dev)
    code_r = cvp.build_cyl_vp2_plan(mask, grid, zbc)[0]
    cols = cvp._vp2_columns(grid, zbc, torch.float32, dev)
    r, r_imh, r_iph = cvp._radii(grid)
    rk = dict(k_spec=kt, cp_spec=ct, h_lo=80.0, h_hi=80.0, tinf_void=20.0,
              emissivity=EMISSIVITY,
              edge0=(50.0, r_imh[0] / (r[0] * grid.dr), 20.0),
              edge1=(300.0, r_iph[-1] / (r[-1] * grid.dr), 20.0))
    rargs = (None, T, code_r, cols["glo_r"], cols["ghi_r"], cols["gsl_r"],
             cols["gsh_r"], float(f32(1.0) / f32(f32(P8_DT) / f32(mat.rho))))
    rows.append(kernel_row(torch, "K15", "r, rhs is T", f"{label} float32",
                           (T, code_r),
                           lambda: vp2_sweep_strided(*rargs, **rk),
                           lambda: vp2_sweep_strided_plain(*rargs, **rk)))
    err = rows[-1]["max_abs_err"]
    print(f"[phase 2] K15 {label} float32 (split kernel): max|d| {err:.3e} "
          f"K, {'within' if err <= P8_TOL['float32'] else 'past'} P8_TOL "
          f"({P8_TOL['float32']:.0e} K; not gated here)", flush=True)
    del T, code_r, rargs, mask
    torch.cuda.empty_cache()
    # K8's general form on the tube's radii and phi at 8192 z rows
    label = f"{'x'.join(map(str, LONG_LINES[2]))} tube"
    grid, mat, mask, zbc, T = cylvp_case(torch, label, LONG_LINES[2],
                                         torch.float32, dev)
    R = random_field(torch, mask, seed=43)
    code_z = cvp.build_cyl_vp2_plan(mask, grid, zbc)[2]
    cols = cvp._vp2_columns(grid, zbc, torch.float32, dev)
    zargs = (R, T, code_z, cols["geo_z"], cols["gs_z"],
             float(f32(1.0) / f32(f32(P8_DT) / f32(mat.rho))))
    zk = k8_general_kw(torch, grid, cols)
    rows.append(kernel_row(torch, "K8", "z, cylindrical",
                           f"{label} float32", (R, T, code_z),
                           lambda: vp2_sweep_z(*zargs, **zk),
                           lambda: vp2_sweep_z_plain(*zargs, **zk),
                           tol_k=P8_TOL["float32"], scale_too=True))
    del T, R, code_z, zargs, mask
    torch.cuda.empty_cache()
    for vname, shape, axis, kern, plain in (
            ("r", LONG_LINES[0], 0, vp_fields_sweep_strided,
             vp_fields_sweep_strided_plain),
            ("z (natural)", LONG_LINES[2], 2, vp_fields_sweep_z,
             vp_fields_sweep_z_plain)):
        st, col = line_streams(torch, shape, axis, dev, 61)
        rows.append(kernel_row(
            torch, "K17", vname, f"{'x'.join(map(str, shape))} float32", st,
            lambda: kern(*st, col, col), lambda: plain(*st, col, col)))
        del st
        torch.cuda.empty_cache()
    # K16, K18 and K22 (on K18's rows) on the further lines (float32;
    # lines of 3 also float64)
    for (label, shape, dr, r_inner), prec in (
            [(c, "float32") for c in CYCLIC_SHAPES]
            + [(CYCLIC_SHAPES[-1], "float64")]):
        dtype = getattr(torch, prec)
        f = getattr(np, prec)
        grid, mat, mask, zbc, T = cylvp_case(torch, label, shape, dtype, dev,
                                             dr, r_inner)
        R = random_field(torch, mask, seed=53).to(dtype)
        code_p = cvp.build_cyl_vp2_plan(mask, grid, zbc)[1]
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        inv = float(f(1.0) / f(f(P8_DT) / f(mat.rho)))
        pk = dict(k_spec=kt, cp_spec=ct, h_void=80.0, tinf_void=20.0,
                  emissivity=EMISSIVITY)
        args = (R, T, code_p, cols["geo_p"], cols["gs_p"], inv)
        rows.append(kernel_row(
            torch, "K16", "phi (cyclic)", f"{label} {prec}", (R, T, code_p),
            lambda: vp2_cyclic_phi(*args, **pk),
            lambda: vp2_cyclic_phi_plain(*args, **pk), tol_k=P8_TOL[prec]))
        sr, _ = k17_streams(torch, grid, mat, mask, T, R, P8_DT)
        sp = (R, cvp._face_phi(kt(T), mask), *sr[2:])
        rows.append(kernel_row(
            torch, "K18", "phi (cyclic)", f"{label} {prec}", sp,
            lambda: vp_fields_cyclic_phi(*sp, cols["geo_p"]),
            lambda: vp_fields_cyclic_phi_plain(*sp, cols["geo_p"]),
            tol_k=P8_TOL[prec], scale_too=True))
        ap = k18_rows(torch, sp, cols["geo_p"])
        rows.append(kernel_row(torch, "K22", "phi, fields tier rows",
                               f"{label} {prec}", ap,
                               lambda: cyclic_fields(*ap, 1),
                               lambda: cyclic_fields_plain(*ap, 1)))
        del T, R, args, sr, sp, ap
        torch.cuda.empty_cache()
    return rows


def phase8_step(torch, dev):
    """bench.py's cyl_varprop step at (64, 512, 1024) float32, BE then
    Douglas: kernels against reference per step from the reference's
    state, then the kernels alone, timed."""
    from adi_thermal_fields_tpu_torch import (RobinBC, adi_step_cyl_varprop,
                                              build_cyl_vp2_plan)

    label, shape, _ = P8_SHAPES[0]
    grid, mat, mask, zbc, T0 = cylvp_case(torch, label, shape, torch.float32,
                                          dev)
    kt, ct = varprop_tables()
    kw = dict(dt=P8_DT, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
              robin_inner=RobinBC(50.0, 20.0), active=mask, h_void=80.0,
              T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
              emissivity=EMISSIVITY)
    plan = build_cyl_vp2_plan(mask, grid, zbc)
    per_step = {"be": {"K8": 1, "K15": 1, "K16": 1},
                "douglas": {"K17": 2, "K18": 1}}
    out = {}
    for scheme, per in per_step.items():
        def step(T, impl, scheme=scheme):
            return adi_step_cyl_varprop(
                T, grid, mat, scheme=scheme, implementation=impl,
                vp2_plan=plan if impl == "kernels" else None, **kw)

        out[scheme] = per_step_check(
            torch, f"[phase 8] {label} f32 varprop {scheme} step",
            lambda T: step(T, "kernels"), lambda T: step(T, "reference"),
            T0, per)
        torch.cuda.empty_cache()
    return out


def phase8_app(torch, dev):
    """The spiral app with the varprop flags: the float32 kernels over
    the whole print, then kernels against reference at float64 on its
    first P8_APP_T_TOT s in robin mode, with --scheme douglas and with
    --void_mode clamp."""
    p32 = spiral_app(torch, dev, 8, P8_APP_FLAGS, impls=("kernels",))
    f64 = P8_APP_FLAGS + ["--precision", "float64", "--t_tot", P8_APP_T_TOT]
    runs = {mode: spiral_app(torch, dev, 8, f64 + extra, tol=P8_APP_TOL,
                             overshoot=DOUGLAS_OVERSHOOT
                             if mode == "douglas" else 0.0)
            for mode, extra in (("robin", []),
                                ("douglas", ["--scheme", "douglas"]),
                                ("clamp", ["--void_mode", "clamp"]))}
    return p32, runs


def phase2_fields(torch, dev):
    """K19, K7's x entry, K20, K21 and K22 against their plain versions
    (float32 and float64): K20 bitwise, K7x, K19, K21 and K22 (the
    split-line core) within KERNEL_TOL_ULP float32 ulp of the output's
    scale, or KERNEL_TOL_F64 of it at float64; K21 also on 8192-row
    lines."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        cyclic_fields, cyclic_fields_plain, sweep_code, tridiag_fields,
        tridiag_fields_plain, varprop_fields_plain, varprop_sweep_x,
        varprop_sweep_x_plain, varprop_sweep_z, varprop_sweep_z_plain,
        varprop_theta_rhs, varprop_theta_rhs_plain)

    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = varprop_tables()
    rows = []
    for label, shape, prec in P9_SHAPES:
        dtype = getattr(torch, prec)
        grid = CartesianGrid(*shape, 0.5e-3)
        sc = vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
        if label.endswith("waam"):
            mask = waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(3)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        T = mushy_field(torch, mask, seed=7).to(dtype)
        R = random_field(torch, mask, seed=13).to(dtype)   # a chained rhs
        m8 = mask.to(torch.uint8)
        fc, w, h = varprop_fields_plain(T, m8, k_spec=kt, cp_spec=ct,
                                        rho=mat.rho,
                                        rad=(EMISSIVITY, 20.0, H_CONV))
        g = torch.Generator(device=dev).manual_seed(5)
        src = torch.where(mask, 1e8 * torch.rand(shape, generator=g,
                                                 device=dev), 0.0).to(dtype)
        # diagonally dominant field systems, the rows of an implicit sweep
        a = -torch.rand(shape, generator=g, device=dev, dtype=dtype)
        c = -torch.rand(shape, generator=g, device=dev, dtype=dtype)
        b = 1.0 + 2.0 * torch.rand(shape, generator=g, device=dev,
                                   dtype=dtype) - a - c
        c0 = sweep_code(mask, None, 0)
        c2 = sweep_code(mask, None, 2).movedim(0, 2).contiguous()
        zr = (sc["tg"][2], sc["sk"][2], 20.0)
        xr = (sc["tg"][0], sc["sk"][0], 20.0)
        th = (T, *fc, w, m8, sc["cw"], sc["inv_d2"])
        variants = [
            ("K19", "z, h stream", (R, c2, fc[2], w, h),
             lambda: varprop_sweep_z(R, c2, fc[2], w, *zr, h=h),
             lambda: varprop_sweep_z_plain(R, c2, fc[2], w, *zr, h=h)),
            ("K19", "z, rob_c", (R, c2, fc[2], w),
             lambda: varprop_sweep_z(R, c2, fc[2], w, *zr, rob_c=H_CONV),
             lambda: varprop_sweep_z_plain(R, c2, fc[2], w, *zr,
                                           rob_c=H_CONV)),
            ("K7x", "x, h stream", (R, c0, fc[0], w, h),
             lambda: varprop_sweep_x(R, c0, fc[0], w, *xr, h=h),
             lambda: varprop_sweep_x_plain(R, c0, fc[0], w, *xr, h=h)),
            ("K20", "rhs", th[:6],
             lambda: varprop_theta_rhs(*th),
             lambda: varprop_theta_rhs_plain(*th)),
            ("K20", "rhs + src", (*th[:6], src),
             lambda: varprop_theta_rhs(*th, src=src, dt=sc["dt"]),
             lambda: varprop_theta_rhs_plain(*th, src=src, dt=sc["dt"])),
            *((("K21", name, (a, b, c, R),
                (lambda ax=ax: tridiag_fields(a, b, c, R, ax)),
                (lambda ax=ax: tridiag_fields_plain(a, b, c, R, ax))))
              for ax, name in enumerate(("x", "y", "z"))),
            ("K22", "phi (axis 1, cyclic)", (a, b, c, R),
             lambda: cyclic_fields(a, b, c, R, 1),
             lambda: cyclic_fields_plain(a, b, c, R, 1)),
        ]
        cells = T.numel()
        where = f"{label} {prec}"
        for kname, vname, ins, kern, plain in variants:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{kname} {vname} {where}: non-finite output")
            err = float((got - want).abs().max())
            nbytes = sum(t.numel() * t.element_size() for t in (*ins, got))
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 1, warm=False)
            pct = 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
            rows.append(dict(kernel=kname, variant=vname, shape=where,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bytes_per_cell=nbytes / cells, pct_hbm=pct,
                             **bound(kname, nbytes, cells)))
            print(f"[phase 2] {kname} {vname:32s} {where:26s} "
                  f"max|d|={err:.3e}  kernel {ms:8.3f} ms  plain "
                  f"{plain_ms:9.3f} ms  {pct:5.1f}% of 3.35 TB/s at "
                  f"{nbytes / cells:.2f} B/cell", flush=True)
            if kname in SPLIT_GENERAL:
                # lines split across threads: KERNEL_TOL_ULP float32 ulp of
                # the output's scale, KERNEL_TOL_F64 of it at float64
                scale = float(want.abs().max())
                tol = (KERNEL_TOL_ULP * torch.finfo(torch.float32).eps
                       if prec == "float32" else KERNEL_TOL_F64) * scale
                check(err <= tol, f"{kname} {vname} {where}: max|d| "
                      f"{err:.3e} from its plain version > {tol:.3e}")
            else:
                check(err == 0.0, f"{kname} {vname} {where}: max|d| "
                      f"{err:.3e} from its plain version, not bitwise")
            del got, want
        del T, R, fc, w, h, src, a, b, c, variants
        torch.cuda.empty_cache()
    # K21 on 8192-row lines along each axis (the core's global reduced
    # rows; z past its staging, on the strided kernel along z)
    for ax, shape in enumerate(LONG_LINES):
        abcd = field_systems(torch, shape, torch.float32, dev, 67 + ax)
        rows.append(kernel_row(
            torch, "K21", "xyz"[ax], f"{'x'.join(map(str, shape))} float32",
            abcd, lambda: tridiag_fields(*abcd, ax),
            lambda: tridiag_fields_plain(*abcd, ax)))
        del abcd
        torch.cuda.empty_cache()
    return rows


def bench_mask(torch, shape, dev):
    """bench.py's build_case mask: a plate over 3/4 of the height and a
    block on it."""
    nx, ny, nz = shape
    zsplit = (3 * nz) // 4
    m = torch.ones(shape, dtype=torch.bool, device=dev)
    m[:, :, zsplit:] = False
    m[nx // 4:3 * nx // 4, ny // 4:3 * ny // 4,
      zsplit:zsplit + nz // 8] = True
    return m


def timed_steps(torch, step, T0, n):
    """CUDA-event ms of ``n`` steps from ``T0``, each timed on its own,
    after two warm-up steps."""
    for _ in range(P3_WARMUP):
        step(T0)
    torch.cuda.synchronize()
    T, out = T0, []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        T = step(T)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    check(bool(torch.isfinite(T).all()), "non-finite T in a timed run")
    return out


def per_step_check(torch, name, kernels, reference, T0, per):
    """Kernels against reference, each of P3_STEPS steps from the
    reference's state (STEP_TOL), then the kernels alone timed; the
    launches are ``per`` step exactly."""
    from adi_thermal_fields_tpu_torch.solvers import launch_counts

    before = launch_counts()
    T, errs, ref_ms = T0, [], []
    for _ in range(P3_STEPS):
        Tk = kernels(T)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        Tr = reference(T)
        end.record()
        end.synchronize()
        ref_ms.append(start.elapsed_time(end))
        check(bool(torch.isfinite(Tk).all()) and
              bool(torch.isfinite(Tr).all()), f"{name}: non-finite T")
        errs.append(float((Tk - Tr).abs().max()))
        T = Tr
        del Tk
    step_ms = timed_steps(torch, kernels, T0, P3_STEPS)
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    n = 2 * P3_STEPS + P3_WARMUP
    want = {k: n * per.get(k, 0) for k in delta}
    check(delta == want, f"{name}: launches {delta} != expected {want}")
    ms, rms = statistics.median(step_ms), statistics.median(ref_ms)
    print(f"{name}: kernels {ms:9.3f} ms/step (median; steps "
          f"{', '.join(f'{s:.3f}' for s in step_ms)}); reference "
          f"{rms:9.3f} ms/step; launches per step "
          f"{ {k: v for k, v in per.items() if v} }", flush=True)
    print(f"{name}: max|T_kernels - T_reference| per step from the "
          f"reference's state: {', '.join(f'{e:.3e}' for e in errs)} K",
          flush=True)
    check(max(errs) <= STEP_TOL, f"{name}: {max(errs):.3e} K > {STEP_TOL}")
    return dict(ms_kernels=ms, ms_reference=rms, max_abs_err=max(errs))


_CORRECTED_FIELDS = {}


def corrected_fields(torch, shape, dev):
    """bench.py's run_corrected fields: per-face h, then per-face radiation
    scales (numpy's generator seeded 5, all h faces drawn first), float32
    on ``dev``.  Drawn once a shape and kept on the host, float32: phases
    2, 9 and 10 share phase 9's."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.bc.faces import FACES

    key = tuple(shape)
    if key not in _CORRECTED_FIELDS:
        rng = np.random.default_rng(5)
        hf = {f: (10.0 + 10.0 * rng.random(shape)).astype(np.float32)
              for f in FACES}
        scale = {f: (0.7 + 0.6 * rng.random(shape)).astype(np.float32)
                 for f in FACES}
        _CORRECTED_FIELDS[key] = (hf, scale)
    on_dev = (lambda d: {f: torch.from_numpy(a).to(dev) for f, a in
                         d.items()})
    return tuple(on_dev(d) for d in _CORRECTED_FIELDS[key])


def phase9_step(torch, dev):
    """The corrected-BC route (and its fuse_theta=False form), the
    Neumann/Dirichlet varprop step and the cylindrical fields tier,
    float32, kernels against reference per step."""
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              RobinBC,
                                              adi_step_cyl_varprop,
                                              adi_step_varprop_fused)
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine

    n = P9_N
    grid = CartesianGrid(n, n, n, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = varprop_tables()
    mask = bench_mask(torch, grid.shape, dev)
    T0 = torch.where(mask, 900.0, 20.0).to(torch.float32)
    dt = 0.02
    hf, scale = corrected_fields(torch, grid.shape, dev)
    common = dict(device=dev, dtype=torch.float32, theta=0.5, t_inf=20.0,
                  k_table=kt, cp_table=ct)
    out = {}

    def engine_case(name, bcs, per):
        eng = {impl: make_cartesian_engine(grid, mat, implementation=impl,
                                           **common, **bcs)
               for impl in ("kernels", "reference")}
        prep = {impl: e[0](mask) for impl, e in eng.items()}
        steps = {impl: (lambda T, impl=impl: eng[impl][1](T, prep[impl], dt,
                                                          1, 0.0))
                 for impl in eng}
        out[name] = per_step_check(torch, f"[phase 9] {n}^3 f32 {name}",
                                   steps["kernels"], steps["reference"], T0,
                                   per)
        return prep["kernels"], steps["kernels"]

    prep_k, fused_step = engine_case(
        "corrected (per-face h + scales, eps 0.5)",
        dict(robin_h=hf, radiation_scale=scale, emissivity=EMISSIVITY),
        {"K5": 1, "K6": 1, "K7": 1, "K19": 1})

    # the same streams through K20 and K7's x entry instead of K6
    def unfused(T):
        return adi_step_varprop_fused(
            T, prep_k[0], prep_k[1], grid, mat, k_table=kt, cp_table=ct,
            dt=dt, theta=0.5, t_inf=20.0, h_axes=prep_k[2],
            emissivity=EMISSIVITY, h_conv=None, fuse_theta=False)

    from adi_thermal_fields_tpu_torch.solvers import launch_counts
    before = launch_counts()
    same = bool(torch.equal(unfused(T0), fused_step(T0)))
    step_ms = timed_steps(torch, unfused, T0, P3_STEPS)
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    per = {"K5": 1, "K20": 1, "K7x": 1, "K7": 1, "K19": 1}
    n_unf = 1 + P3_WARMUP + P3_STEPS
    want = {k: n_unf * per.get(k, 0)
            + (1 if k in ("K5", "K6", "K7", "K19") else 0) for k in delta}
    check(delta == want, f"phase 9 fuse_theta=False: launches {delta} != "
          f"expected {want}")
    ms = statistics.median(step_ms)
    print(f"[phase 9] {n}^3 f32 corrected, fuse_theta=False: kernels "
          f"{ms:9.3f} ms/step (median; steps "
          f"{', '.join(f'{s:.3f}' for s in step_ms)}); bitwise equal to "
          f"the fused step: {same}", flush=True)
    check(same, "phase 9: fuse_theta=False differs from the fused step")
    out["corrected, fuse_theta=False"] = dict(ms_kernels=ms)
    del prep_k, fused_step, hf, scale
    torch.cuda.empty_cache()

    dirm = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    dirm[:, :, 0] = True
    engine_case("entry BCs + Dirichlet bottom",
                dict(robin_h=200.0, neumann={"z+": 5e5},
                     dirichlet_mask=dirm, dirichlet_value=600.0),
                {"K21": 3})
    torch.cuda.empty_cache()

    # the cylindrical fields tier at phase 8's tube
    label, shape, _ = P8_SHAPES[0]
    cgrid, cmat, cmask, zbc, C0 = cylvp_case(torch, label, shape,
                                             torch.float32, dev)
    kw = dict(dt=P8_DT, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
              robin_inner=RobinBC(50.0, 20.0), active=cmask, h_void=80.0,
              T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
              emissivity=EMISSIVITY)
    for scheme in ("be", "douglas"):
        out[f"cyl fields {scheme}"] = per_step_check(
            torch, f"[phase 9] {label} f32 varprop {scheme} fields tier",
            lambda T: adi_step_cyl_varprop(T, cgrid, cmat, scheme=scheme,
                                           implementation="fields", **kw),
            lambda T: adi_step_cyl_varprop(T, cgrid, cmat, scheme=scheme,
                                           implementation="reference", **kw),
            C0, {"K21": 2, "K22": 1})
    torch.cuda.empty_cache()
    return out


def phase9_app(torch, dev):
    """The WAAM app on the turned bar with --corrected_bc, and with the
    varprop flags: the whole print on the float32 kernels, then kernels
    against reference on a short print (float32; float64 with the varprop
    flags); the corrected fields must change the field."""
    vp = ["--emissivity", str(EMISSIVITY), "--latent_J_kg", str(LATENT),
          "--melt_k_factor", "4"]
    cbc = ["--corrected_bc", "1"]
    out = {}
    for name, extra, prec in (("corrected", cbc, "float32"),
                              ("corrected + varprop", cbc + vp, "float64")):
        whole = app_phase(torch, dev, 9, extra, impls=("kernels",),
                          turn_deg=30.0)
        short = app_phase(torch, dev, 9, extra, precision=prec,
                          turn_deg=30.0, layer_s=SHORT_LAYER_S)
        out[name] = dict(wall_kernels_whole=whole["wall_kernels"],
                         **{k: v for k, v in short.items()
                            if k != "T_kernels"})
        if name == "corrected":
            plain = app_phase(torch, dev, 9, [], impls=("kernels",),
                              turn_deg=30.0, layer_s=SHORT_LAYER_S)
            d = float((plain["T_kernels"] - short["T_kernels"]).abs().max())
            print(f"[phase 9] max|T_corrected - T_h_side| (kernels, short "
                  f"print) = {d:.3e} K", flush=True)
            check(d > 1e-3, f"--corrected_bc changed the field by {d:.3e} "
                  "K: the corrected fields do not reach the step")
    return out


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at magnitude ``x`` (> 0)."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def time_row(torch, rows, kname, vname, where, ins, kern, plain, err,
             extra=""):
    """Time a kernel and its plain version, append its summary row and
    print it."""
    got = kern()
    outs = got if isinstance(got, (tuple, list)) else (got,)
    outs = [t for o in outs for t in (o if isinstance(o, tuple) else (o,))
            if t is not None]
    cells = outs[0].numel()
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    ms = cuda_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, plain, 1, warm=False)
    b = bound(kname, nbytes, cells)
    rows.append(dict(kernel=kname, variant=vname, shape=where,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bytes_per_cell=nbytes / cells,
                     pct_hbm=100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S,
                     **b))
    print(f"[phase 2] {kname} {vname:32s} {where:26s} max|d|={err:.3e}"
          f"{extra}  kernel {ms:8.3f} ms  plain {plain_ms:9.3f} ms  "
          f"{100.0 * b['bound_ms'] / ms:5.1f}% of its bound "
          f"({b['bound_ms']:.3f} ms, {nbytes / cells:.2f} B/cell)",
          flush=True)


def share_apart(a, b):
    """The share of cells at which ``a`` and ``b`` differ."""
    return float((a != b).double().mean())


def check_share(name, share, wrong=None):
    """A bfloat16 output against its plain version: at most P10_SHARE_TOL
    of the cells apart; ``wrong``, the share apart from the plain version
    under another rounding key, must pass it (the gate sees a wrong key)."""
    check(share <= P10_SHARE_TOL, f"{name}: {100.0 * share:.4f}% of the "
          f"cells apart from its plain version (> {100.0 * P10_SHARE_TOL}%:"
          " the rounding keys differ)")
    if wrong is not None:
        check(wrong > P10_SHARE_TOL, f"{name}: under the next pass's key "
              f"the plain version parts at only {100.0 * wrong:.4f}% of the "
              "cells: the share gate cannot see a wrong key")


def split_row(torch, rows, kname, vname, where, ins, kern, plain,
              extra="", wrong_key=None):
    """A split solve (K24-K26; K6b, K7xb, K7b, K19b) against its plain
    version: within KERNEL_TOL_ULP float32 ulp of the output's scale at
    float32; at bfloat16 one bfloat16 ulp of it and at most P10_SHARE_TOL
    of the cells apart (``wrong_key``: the plain version under another
    key, which must part by more)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and bool(torch.isfinite(got).all()),
          f"{kname} {vname} {where}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    share = share_apart(got, want)
    wrong = None
    if got.dtype == torch.bfloat16:
        ulps, lim = err / bf16_ulp(scale), 1.0
        unit = "bf16 ulp of scale, tol 1"
        if wrong_key is not None:
            wrong = share_apart(got, wrong_key())
            extra = f"; {100.0 * wrong:.2f}% under the next key{extra}"
    else:
        ulps = err / (torch.finfo(torch.float32).eps * scale)
        lim, unit = KERNEL_TOL_ULP, f"ulp of scale, tol {KERNEL_TOL_ULP}"
    time_row(torch, rows, kname, vname, where, ins, kern, plain, err,
             extra=f" ({ulps:.2f} {unit}, {100.0 * share:.4f}% of cells "
                   f"differ){extra}")
    check(ulps <= lim, f"{kname} {vname} {where}: {ulps:.2f} ({unit}) from "
          "its plain version")
    if got.dtype == torch.bfloat16:
        check_share(f"{kname} {vname} {where}", share, wrong)


def phase2_gstreams(torch, dev):
    """K23-K26 against their plain versions at float32 and bfloat16: K23
    bitwise, K24-K26 (split solves) within KERNEL_TOL_ULP or one bfloat16
    ulp of the output's scale, also on 8192-row lines along x (K24), y (K25)
    and z (K26) (phase 10's kernel part)."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        gstream_fields, gstream_fields_plain, gstream_sweep_y,
        gstream_sweep_y_plain, gstream_sweep_z, gstream_sweep_z_plain,
        gstream_theta_sweep, gstream_theta_sweep_plain)

    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = varprop_tables()
    rows = []
    for label, shape in P10_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            grid = CartesianGrid(*shape, 0.5e-3)
            sc = vp_scalars(grid, mat, P10_VP_DT)
            if label.endswith("waam"):
                mask = waam_mask(torch, shape, dev)
            else:
                g = torch.Generator(device=dev).manual_seed(3)
                mask = torch.rand(shape, generator=g, device=dev) > 0.25
            T = mushy_field(torch, mask, seed=7).to(dtype)
            R = random_field(torch, mask, seed=13).to(dtype)
            m8 = mask.to(torch.uint8)
            g = torch.Generator(device=dev).manual_seed(5)
            src = torch.where(mask, 1e8 * torch.rand(shape, generator=g,
                                                     device=dev),
                              0.0).to(dtype)
            fk = dict(k_spec=kt, cp_spec=ct, rho=mat.rho, dt=sc["dt"],
                      t_inf=20.0)
            const = dict(h_mode="const", hpar=H_CONV)
            rad = dict(h_mode="rad", hpar=EMISSIVITY, h_conv=H_CONV)
            g_lo, g_hi, sw, sp = gstream_fields_plain(
                T, m8, sc["tg"], sc["sk"], src=src, **fk, **rad)
            th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2], g_hi[2],
                  sw[0], 1.0, 20.0)
            seed = dict(rng_seed=P10_SEED)
            variants = [
                ("K23", "fields, const h", (T, m8),
                 lambda: gstream_fields(T, m8, sc["tg"], sc["sk"], **fk,
                                        **const),
                 lambda: gstream_fields_plain(T, m8, sc["tg"], sc["sk"],
                                              **fk, **const)),
                ("K23", "fields, const h + src", (T, m8, src),
                 lambda: gstream_fields(T, m8, sc["tg"], sc["sk"], src=src,
                                        **fk, **const),
                 lambda: gstream_fields_plain(T, m8, sc["tg"], sc["sk"],
                                              src=src, **fk, **const)),
                ("K23", "fields, rad", (T, m8),
                 lambda: gstream_fields(T, m8, sc["tg"], sc["sk"], **fk,
                                        **rad),
                 lambda: gstream_fields_plain(T, m8, sc["tg"], sc["sk"],
                                              **fk, **rad)),
                ("K23", "fields, rad + src", (T, m8, src),
                 lambda: gstream_fields(T, m8, sc["tg"], sc["sk"], src=src,
                                        **fk, **rad),
                 lambda: gstream_fields_plain(T, m8, sc["tg"], sc["sk"],
                                              src=src, **fk, **rad)),
            ]
            splits = [
                ("K24", "theta + x, seeded", th[:8],
                 lambda: gstream_theta_sweep(*th, rng_offset=1, **seed),
                 lambda: gstream_theta_sweep_plain(*th, rng_offset=1,
                                                   **seed)),
                ("K24", "theta + x + src_pre", (*th[:8], sp),
                 lambda: gstream_theta_sweep(*th, src_pre=sp),
                 lambda: gstream_theta_sweep_plain(*th, src_pre=sp)),
                ("K25", "y, seeded", (R, g_lo[1], g_hi[1], sw[1]),
                 lambda: gstream_sweep_y(R, g_lo[1], g_hi[1], sw[1], 20.0,
                                         rng_offset=2, **seed),
                 lambda: gstream_sweep_y_plain(R, g_lo[1], g_hi[1], sw[1],
                                               20.0, rng_offset=2, **seed)),
            ]
            where = f"{label} {str(dtype)[6:]}"
            for kname, vname, ins, kern, plain in variants:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                flat = (lambda o: [t for x in (o if isinstance(o, tuple)
                                               else (o,))
                                   for t in (x if isinstance(x, tuple)
                                             else (x,)) if t is not None])
                err, same = 0.0, True
                for a, b in zip(flat(got), flat(want)):
                    check(a.dtype == dtype and bool(torch.isfinite(a).all()),
                          f"{kname} {vname} {where}: non-finite output")
                    err = max(err, float((a.float() - b.float()).abs()
                                         .max()))
                    same = same and bool(torch.equal(a, b))
                time_row(torch, rows, kname, vname, where, ins, kern, plain,
                         err)
                check(same, f"{kname} {vname} {where}: max|d| {err:.3e} "
                      "from its plain version, not bitwise")
                del got, want
            z = (R, g_lo[2], g_hi[2], sw[2])
            for vname, kw in ((("z", {}),) if dtype == torch.bfloat16
                              else ()) + (("z, seeded", seed),):
                splits.append(
                    ("K26", vname, z,
                     lambda kw=kw: gstream_sweep_z(*z, 20.0, rng_offset=3,
                                                   **kw),
                     lambda kw=kw: gstream_sweep_z_plain(
                         *z, 20.0, rng_offset=3, **kw)))
            for kname, vname, ins, kern, plain in splits:
                split_row(torch, rows, kname, vname, where, ins, kern, plain)
            del T, R, src, g_lo, g_hi, sw, sp, variants, splits, z
            torch.cuda.empty_cache()
    # 8192-row lines: K24 along x, K25 along y (the strided kernel, the
    # reduced rows in global memory), K26 along z (past the staging: the
    # strided kernel)
    for ax, kname in enumerate(("K24", "K25", "K26")):
        shape = LONG_LINES[ax]
        grid = CartesianGrid(*shape, 0.5e-3)
        sc = vp_scalars(grid, mat, P10_VP_DT)
        mask = waam_mask(torch, shape, dev)
        for dtype in (torch.bfloat16, torch.float32):
            T = mushy_field(torch, mask, seed=7).to(dtype)
            R = random_field(torch, mask, seed=13).to(dtype)
            g_lo, g_hi, sw, _ = gstream_fields_plain(
                T, mask.to(torch.uint8), sc["tg"], sc["sk"], k_spec=kt,
                cp_spec=ct, rho=mat.rho, dt=sc["dt"], t_inf=20.0,
                h_mode="rad", hpar=EMISSIVITY, h_conv=H_CONV)
            th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2], g_hi[2],
                  sw[0], 1.0, 20.0)
            ins = th[:8] if ax == 0 else (R, g_lo[ax], g_hi[ax], sw[ax])
            kern, plain = {
                0: (gstream_theta_sweep, gstream_theta_sweep_plain),
                1: (gstream_sweep_y, gstream_sweep_y_plain),
                2: (gstream_sweep_z, gstream_sweep_z_plain)}[ax]
            args = th if ax == 0 else (*ins, 20.0)
            kw = dict(rng_offset=ax + 1, rng_seed=P10_SEED)
            split_row(torch, rows, kname, f"{'xyz'[ax]}, seeded",
                      f"{'x'.join(map(str, shape))} {str(dtype)[6:]}", ins,
                      lambda: kern(*args, **kw), lambda: plain(*args, **kw))
            del T, R, g_lo, g_hi, sw, th, ins, args
            torch.cuda.empty_cache()
    return rows


def phase2_bf16(torch, dev):
    """The bfloat16 entries of K1-K4 against their plain versions at the
    256^3 WAAM mask, rounding to nearest and stochastically: within one
    bfloat16 ulp of the output's scale (the stencil's R0 of a random field
    crosses zero, where a cell's own ulp is tiny); then the kernels'
    stochastic rounding of
    1 + ulp/4 (phase 10's kernel part)."""
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              build_coeff_packs)
    from adi_thermal_fields_tpu_torch.solvers import (
        fused_theta_sweep, fused_theta_sweep_plain, gstream_theta_sweep,
        sweep_code, sweep_strided, sweep_strided_plain, sweep_z,
        sweep_z_plain, theta_rhs, theta_rhs_plain)
    from adi_thermal_fields_tpu_torch.step.cartesian import step_scalars

    bf = torch.bfloat16
    mat = Material(7800.0, 490.0, 54.0)
    label, shape = P2_SHAPES[0]
    grid = CartesianGrid(*shape, 0.5e-3)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    dt, inv_d2, tg, c_exp = step_scalars(bf, grid, mat, dt, 0.5)
    rc = [float(torch.tensor(30.0, dtype=torch.float32)
                * torch.tensor(1.0 / (mat.rho * mat.cp * d),
                               dtype=torch.float32)) for d in grid.spacing]
    mask = waam_mask(torch, shape, dev)
    T = random_field(torch, mask, seed=7).to(bf)
    dirm = torch.zeros_like(mask)
    dirm[:, :, 0] = mask[:, :, 0]
    pk = build_coeff_packs(mask, grid, mat, dtype=bf, robin_h=200.0,
                           neumann={"z+": 5e5}, dirichlet_mask=dirm,
                           dirichlet_value=20.0)

    def nat(axis, dm=None, **kw):
        return sweep_code(mask, dm, axis, **kw).movedim(0, axis) \
            .contiguous()

    c0, c1, c2 = nat(0), nat(1), nat(2)
    c0s, d0, d2 = nat(0, stencil_bits=True), nat(0, dirm), nat(2, dirm)
    m_u8 = mask.to(torch.uint8)
    fkw = dict(coeff=pk.coeff[0], qflux=pk.qflux[0], dir_val=pk.dir_val)
    fkw2 = dict(coeff=pk.coeff[2], qflux=pk.qflux[2], dir_val=pk.dir_val)
    rows = []
    for seeded in (False, True):
        sr = dict(rng_seed=P10_SEED if seeded else None)
        tag = ", seeded" if seeded else ""
        variants = [
            ("K1b", "lite x" + tag, (T, c0),
             lambda: sweep_strided(T, c0, tg[0], dt, 20.0, axis=0,
                                   rob_c=rc[0], rng_offset=1, **sr),
             lambda: sweep_strided_plain(T, c0, tg[0], dt, 20.0, axis=0,
                                         rob_c=rc[0], rng_offset=1, **sr)),
            ("K1b", "lite y" + tag, (T, c1),
             lambda: sweep_strided(T, c1, tg[1], dt, 20.0, axis=1,
                                   rob_c=rc[1], rng_offset=2, **sr),
             lambda: sweep_strided_plain(T, c1, tg[1], dt, 20.0, axis=1,
                                         rob_c=rc[1], rng_offset=2, **sr)),
            ("K1b", "field+neumann+dirichlet x" + tag,
             (T, d0, *fkw.values()),
             lambda: sweep_strided(T, d0, tg[0], dt, 20.0, axis=0,
                                   rng_offset=1, **fkw, **sr),
             lambda: sweep_strided_plain(T, d0, tg[0], dt, 20.0, axis=0,
                                         rng_offset=1, **fkw, **sr)),
            ("K2b", "lite z" + tag, (T, c2),
             lambda: sweep_z(T, c2, tg[2], dt, 20.0, rc[2], rng_offset=3,
                             **sr),
             lambda: sweep_z_plain(T, c2, tg[2], dt, 20.0, rc[2],
                                   rng_offset=3, **sr)),
            ("K2b", "field+neumann+dirichlet z" + tag,
             (T, d2, *fkw2.values()),
             lambda: sweep_z(T, d2, tg[2], dt, 20.0, rng_offset=3, **fkw2,
                             **sr),
             lambda: sweep_z_plain(T, d2, tg[2], dt, 20.0, rng_offset=3,
                                   **fkw2, **sr)),
            ("K3b", "stencil" + tag, (T, m_u8),
             lambda: theta_rhs(T, m_u8, c_exp, inv_d2, **sr),
             lambda: theta_rhs_plain(T, m_u8, c_exp, inv_d2, **sr)),
            ("K4b", "stencil + lite x" + tag, (T, c0s),
             lambda: fused_theta_sweep(T, c0s, c_exp, inv_d2, tg[0], dt,
                                       20.0, rc[0], rng_offset=1, **sr),
             lambda: fused_theta_sweep_plain(T, c0s, c_exp, inv_d2, tg[0],
                                             dt, 20.0, rc[0], rng_offset=1,
                                             **sr)),
        ]
        for kname, vname, ins, kern, plain in variants:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check(got.dtype == bf and bool(torch.isfinite(got).all()),
                  f"{kname} {vname}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            ulps = err / bf16_ulp(float(want.float().abs().max()))
            share = share_apart(got, want)
            time_row(torch, rows, kname, vname, f"{label} bfloat16", ins,
                     kern, plain, err,
                     extra=f" ({ulps:.0f} bf16 ulp of scale, "
                           f"{100.0 * share:.4f}% of cells differ)")
            check(ulps <= 1.0, f"{kname} {vname}: {ulps} bf16 ulp of the "
                  "output's scale from its plain version")
            check_share(f"{kname} {vname}", share)
            del got, want
    del T, mask, pk
    torch.cuda.empty_cache()

    # the kernels' stochastic rounding: d = 1 + 2^-9 = 1 + ulp/4 through
    # K24 with zero couplings and sinks (identity rows, src_pre = 2^-9)
    n = P10_SR_N
    one = torch.ones((n, n, n), dtype=bf, device=dev)
    zero = torch.zeros_like(one)
    sp = torch.full_like(one, 2.0 ** -9)
    args = (one, *([zero] * 7), 1.0, 0.0)
    near = gstream_theta_sweep(*args, src_pre=sp).float()
    out = gstream_theta_sweep(*args, src_pre=sp, rng_seed=P10_SEED,
                              rng_offset=1).float()
    torch.cuda.synchronize()
    up = float((out > 1.0).double().mean())
    vals = sorted(torch.unique(out).tolist())
    print(f"[phase 2] K24 stochastic rounding of 1 + ulp/4 over "
          f"{one.numel()} cells: P(up) = {up:.4f} (want 0.25 +- 0.01), "
          f"values {vals}; to nearest: {sorted(torch.unique(near).tolist())}",
          flush=True)
    check(abs(up - 0.25) < 0.01, f"stochastic rounding P(up) = {up}")
    check(set(vals) <= {1.0, 1.0 + 2.0 ** -7}, f"rounded values {vals}")
    check(bool((near == 1.0).all()), "round to nearest moved 1 + ulp/4")
    del one, zero, sp, out, near
    torch.cuda.empty_cache()
    return rows


def corrected_streams(torch, mask, T, dtype):
    """The step's per-axis film streams of bench.py's run_corrected fields
    at ``T`` (build_face_h_axes at float32, then A + h_rad(T)*B at
    ``dtype``), as adi_step_varprop_fused forms them."""
    from adi_thermal_fields_tpu_torch.bc.radiation import radiative_h
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_face_h_axes)

    hf, scale = corrected_fields(torch, mask.shape, mask.device)
    h_ab = build_face_h_axes(mask, hf, scale, dtype=torch.float32)
    h_rad = radiative_h(T, EMISSIVITY, 20.0, h_conv=0.0)
    return tuple((A + h_rad * B).to(dtype) for A, B in h_ab)


def phase2_vp_bf16(torch, dev):
    """The classic varprop tier's bfloat16 entries against their plain
    versions at phase 9's 384^3 (bench.py run_corrected's mask and film
    streams) and 97x203x131 (a random mask), rounding to nearest and
    seeded: K20b bit for bit, K5b (contracted tables) and the split solves
    K6b, K7xb, K7b and K19b within one bfloat16 ulp of the output's scale;
    K7b and K19b also on 8192-row lines; each main variant at 384^3
    beside its float32 counterpart on the same inputs widened (phase 10's
    kernel part)."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        varprop_fields, varprop_fields_plain, varprop_sweep_x,
        varprop_sweep_x_plain, varprop_sweep_y, varprop_sweep_y_plain,
        varprop_sweep_z, varprop_sweep_z_plain, varprop_theta_rhs,
        varprop_theta_rhs_plain, varprop_theta_sweep,
        varprop_theta_sweep_plain)
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)

    bf = torch.bfloat16
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = varprop_tables()
    rad = (EMISSIVITY, 20.0, H_CONV)
    fk = dict(k_spec=kt, cp_spec=ct, rho=mat.rho)
    seed = dict(rng_seed=P10_SEED)
    rows = []
    cases = [(label, shape, None) for label, shape, _ in P9_SHAPES[:2]] \
        + [(f"{'x'.join(map(str, LONG_LINES[ax]))} random", LONG_LINES[ax],
            ax) for ax in (1, 2)]
    for label, shape, long_ax in cases:
        grid = CartesianGrid(*shape, 1e-3)
        sc = vp_scalars(grid, mat, P10_VP_DT)
        if label.endswith("waam"):
            mask = bench_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(3)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        T = mushy_field(torch, mask, seed=7).to(bf)
        R = random_field(torch, mask, seed=13).to(bf)
        m8 = mask.to(torch.uint8)
        codes = build_varprop_codes(mask)
        g = torch.Generator(device=dev).manual_seed(5)
        src = torch.where(mask, 1e8 * torch.rand(shape, generator=g,
                                                 device=dev), 0.0).to(bf)
        fc, w = varprop_fields_plain(T, m8, **fk)
        if long_ax is None:
            hs = corrected_streams(torch, mask, T, bf)
        else:                   # the long lines: any film streams
            g = torch.Generator(device=dev).manual_seed(11)
            hs = tuple((10.0 + 30.0 * torch.rand(shape, generator=g,
                                                 device=dev)).to(bf)
                       for _ in range(3))
        rhs = (T, *fc, w, m8, sc["cw"], sc["inv_d2"])
        th = (T, codes[0], *fc, w, sc["cw"], sc["inv_d2"], sc["tg"][0],
              sc["sk"][0], 20.0)
        sweeps = [(ax, (R, codes[ax if ax < 2 else 3], fc[ax], w,
                        sc["tg"][ax], sc["sk"][ax], 20.0)) for ax in range(3)]
        exact = [
            ("K5b", "fields", (T, m8),
             lambda: varprop_fields(T, m8, **fk),
             lambda: varprop_fields_plain(T, m8, **fk)),
            ("K5b", "fields + rad", (T, m8),
             lambda: varprop_fields(T, m8, rad=rad, **fk),
             lambda: varprop_fields_plain(T, m8, rad=rad, **fk)),
            ("K20b", "rhs", rhs[:6],
             lambda: varprop_theta_rhs(*rhs),
             lambda: varprop_theta_rhs_plain(*rhs)),
            ("K20b", "rhs, seeded", rhs[:6],
             lambda: varprop_theta_rhs(*rhs, **seed),
             lambda: varprop_theta_rhs_plain(*rhs, **seed)),
            ("K20b", "rhs + src", (*rhs[:6], src),
             lambda: varprop_theta_rhs(*rhs, src=src, dt=sc["dt"]),
             lambda: varprop_theta_rhs_plain(*rhs, src=src, dt=sc["dt"]))]
        split = [
            ("K6b", "theta + x, h stream", (*th[:6], hs[0]),
             varprop_theta_sweep, varprop_theta_sweep_plain, th,
             dict(h=hs[0], rng_offset=1)),
            ("K6b", "theta + x, h stream, seeded", (*th[:6], hs[0]),
             varprop_theta_sweep, varprop_theta_sweep_plain, th,
             dict(h=hs[0], rng_offset=1, **seed)),
            ("K6b", "theta + x, rob_c + src", (*th[:6], src),
             varprop_theta_sweep, varprop_theta_sweep_plain, th,
             dict(rob_c=H_CONV, src=src, dt=sc["dt"]))]
        names = (("K7xb", "x", varprop_sweep_x, varprop_sweep_x_plain),
                 ("K7b", "y", varprop_sweep_y, varprop_sweep_y_plain),
                 ("K19b", "z", varprop_sweep_z, varprop_sweep_z_plain))
        for ax, args in sweeps:
            kname, axn, kern, plain = names[ax]
            split += [(kname, f"{axn}, h stream", (*args[:4], hs[ax]), kern,
                       plain, args, dict(h=hs[ax], rng_offset=ax + 1)),
                      (kname, f"{axn}, h stream, seeded",
                       (*args[:4], hs[ax]), kern, plain, args,
                       dict(h=hs[ax], rng_offset=ax + 1, **seed))]
            if ax > 0:
                split.append((kname, f"{axn}, rob_c", args[:4], kern, plain,
                              args, dict(rob_c=H_CONV, rng_offset=ax + 1)))
        if long_ax is not None:        # the long lines: their sweep only
            exact = []
            split = [r for r in split if r[0] == names[long_ax][0]
                     and r[1].endswith("h stream, seeded")]
        where = f"{label} bfloat16"
        wide = (lambda t: t.float() if torch.is_tensor(t)
                and t.dtype == bf else t)
        # the float32 kernels of the main variants on the same inputs
        # widened (the split solves' below)
        T32, rhs32 = T.float(), tuple(wide(a) for a in rhs)
        f32_exact = {"fields + rad": lambda: varprop_fields(T32, m8, rad=rad,
                                                            **fk),
                     "rhs, seeded": lambda: varprop_theta_rhs(*rhs32)}
        for kname, vname, ins, kern, plain in exact:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            flat = (lambda o: [t for x in (o if isinstance(o, tuple)
                                           else (o,))
                               for t in (x if isinstance(x, tuple)
                                         else (x,)) if t is not None])
            pairs = list(zip(flat(got), flat(want)))
            check(all(a.dtype == bf and bool(torch.isfinite(a).all())
                      for a, _ in pairs),
                  f"{kname} {vname} {where}: non-finite output")
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in pairs)
            if kname == "K20b":         # one rounding per operation
                ulps = 0.0 if all(torch.equal(a, b) for a, b in pairs) \
                    else math.inf
            else:   # K5b: each output within a bf16 ulp of its scale
                ulps = max(float((a.float() - b.float()).abs().max())
                           / bf16_ulp(float(b.float().abs().max()))
                           for a, b in pairs)
            share = max(share_apart(a, b) for a, b in pairs)
            extra, wrong = "", None
            if vname.endswith("seeded"):    # K20b's plain under key 1
                wrong = share_apart(flat(got)[0], varprop_theta_rhs_plain(
                    *rhs, rng_offset=1, **seed))
                extra = f"; {100.0 * wrong:.2f}% under the next key"
            if label.endswith("waam") and vname in f32_exact:
                ms32 = cuda_ms(torch, f32_exact[vname], 20)
                extra += f" (float32 {ms32:.3f} ms)"
            time_row(torch, rows, kname, vname, where, ins, kern, plain, err,
                     extra=f" ({ulps:.2f} bf16 ulp of scale, "
                           f"{100.0 * share:.4f}% of cells differ){extra}")
            check(ulps <= (0.0 if kname == "K20b" else 1.0),
                  f"{kname} {vname} {where}: {ulps} bf16 ulp of the "
                  "output's scale from its plain version")
            check_share(f"{kname} {vname} {where}", share, wrong)
            del got, want, pairs
        for kname, vname, ins, kern, plain, args, kw in split:
            extra = ""
            if long_ax is None and label.endswith("waam") \
                    and vname.endswith("h stream, seeded"):
                # the float32 kernel on the same inputs widened
                a32 = tuple(wide(a) for a in args)
                k32 = {k: wide(v) for k, v in kw.items()
                       if k not in ("rng_seed", "rng_offset")}
                ms32 = cuda_ms(torch, lambda: kern(*a32, **k32), 20)
                extra = f" (float32 {ms32:.3f} ms)"
            wrong_key = None
            if "rng_seed" in kw:        # the plain version, the next key
                wk = dict(kw, rng_offset=kw["rng_offset"] + 1)
                wrong_key = (lambda: plain(*args, **wk))
            split_row(torch, rows, kname, vname, where, ins,
                      lambda: kern(*args, **kw), lambda: plain(*args, **kw),
                      extra=extra, wrong_key=wrong_key)
        del T, R, src, fc, w, hs, exact, split, sweeps, rhs, th, T32, rhs32
        torch.cuda.empty_cache()
    return rows


def timed_seq(torch, step, T0, n, warmup=P3_WARMUP):
    """CUDA-event ms of each of ``n`` steps ``step(T, i)`` after
    ``warmup`` steps, the step index running on (the engine's counter)."""
    T = T0
    for i in range(warmup):
        T = step(T, i)
    torch.cuda.synchronize()
    out = []
    for i in range(warmup, warmup + n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        T = step(T, i)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    check(bool(torch.isfinite(T).all()), "non-finite T in a timed run")
    return T, out


def phase10_step(torch, dev):
    """bench.py's bf16 case (plan-lite, and the field plan) at 512^3 and
    run_varprop's and run_corrected's configurations at 384^3 through
    make_cartesian_engine(dtype=bfloat16, stochastic_rounding=True) (the
    corrected one on the classic tier's bfloat16 entries, also with
    fuse_theta=False); the float32 g-stream A/B; the drift gates of
    tests/test_bf16_drift.py on the card."""
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              adi_step_varprop_fused,
                                              build_varprop_codes)
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.bc.faces import FACES
    from adi_thermal_fields_tpu_torch.solvers import launch_counts
    from adi_thermal_fields_tpu_torch.step.cartesian import round_to_state

    bf, f32 = torch.bfloat16, torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    out = {}

    def engine_run(name, grid, mask, T0, dtype, dt, per, **bcs):
        prepare, advance = make_cartesian_engine(
            grid, mat, implementation="kernels", device=dev, dtype=dtype,
            theta=0.5, t_inf=20.0, stochastic_rounding=dtype == bf, **bcs)
        prep = prepare(mask)
        before = launch_counts()
        # sub-step i from t0 = i*dt: the step counter (the seed) is i
        T, step_ms = timed_seq(
            torch, lambda T, i: advance(T, prep, dt, 1, i * dt), T0,
            P3_STEPS)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        want = {k: (P3_WARMUP + P3_STEPS) * per.get(k, 0) for k in delta}
        check(delta == want, f"phase 10 {name}: launches {delta} != "
              f"expected {want}")
        ms = statistics.median(step_ms)
        print(f"[phase 10] {name}: {ms:9.3f} ms/step (median; steps "
              f"{', '.join(f'{s:.3f}' for s in step_ms)})  "
              f"{grid.ncells / (ms * 1e-3) / 1e9:7.3f} Gcell/s; launches per "
              f"step { {k: v for k, v in per.items() if v} }", flush=True)
        out[name] = dict(ms=ms, gcells=grid.ncells / (ms * 1e-3) / 1e9)
        return T

    # bench.py main_bf16: build_case(512), Robin 200, dt 0.05, theta 0.5
    n = P10_N
    grid = CartesianGrid(n, n, n, 1e-3)
    mask = bench_mask(torch, grid.shape, dev)
    T0 = torch.where(mask, 900.0, 20.0)
    lite = dict(robin_h=200.0)
    field = dict(robin_h={f: 200.0 for f in FACES})
    names = (f"{n}^3 bf16 lite (bench main_bf16)",
             f"{n}^3 f32 lite (the same case)")
    Tb = engine_run(names[0], grid, mask, T0.to(bf), bf, 0.05,
                    {"K4b": 1, "K1b": 1, "K2b": 1}, **lite)
    Tf = engine_run(names[1], grid, mask, T0.to(f32), f32, 0.05,
                    {"K4": 1, "K1": 1, "K2": 1}, **lite)
    d = (Tb.float() - Tf)[mask].abs()
    print(f"[phase 10] {n}^3 lite after {P3_WARMUP + P3_STEPS} steps: "
          f"|T_bf16 - T_f32| max {float(d.max()):.3f} K, mean "
          f"{float(d.mean()):.4f} K over the solid; bf16/f32 time "
          f"{out[names[0]]['ms'] / out[names[1]]['ms']:.3f}", flush=True)
    check(float(d.max()) < 16.0, f"phase 10 lite: bf16 {float(d.max())} K "
          "from float32")
    engine_run(f"{n}^3 bf16 field plan (per-face h 200)", grid, mask,
               T0.to(bf), bf, 0.05, {"K3b": 1, "K1b": 2, "K2b": 1},
               **field)
    del Tb, Tf, d, T0, mask
    torch.cuda.empty_cache()

    # bench.py run_varprop at 384^3 bf16: robin 15, emissivity 0.5, the
    # phase 2 tables, dt 0.02
    n = P9_N
    grid = CartesianGrid(n, n, n, 1e-3)
    mask = bench_mask(torch, grid.shape, dev)
    T0 = torch.where(mask, 900.0, 20.0)
    kt, ct = varprop_tables()
    vp = dict(robin_h=15.0, emissivity=EMISSIVITY, k_table=kt, cp_table=ct)
    engine_run(f"{n}^3 bf16 varprop (bench run_varprop, g-streams)", grid,
               mask, T0.to(bf), bf, P10_VP_DT,
               {"K23": 1, "K24": 1, "K25": 1, "K26": 1}, **vp)
    # float32 A/B of the two tiers on the same step (JAX's keep-or-kill
    # A/B, cartesian_varprop.py:55-67): classic, g-streams, g-streams,
    # classic
    codes = build_varprop_codes(mask)
    m8 = mask.to(torch.uint8)
    T32 = T0.to(f32)
    kw = dict(k_table=kt, cp_table=ct, dt=P10_VP_DT, theta=0.5, t_inf=20.0,
              robin_h=15.0, emissivity=EMISSIVITY, h_conv=15.0)
    tiers = {
        "classic": lambda T, i: adi_step_varprop_fused(
            T, m8, codes, grid, mat, gstreams=False, **kw),
        "g-streams": lambda T, i: adi_step_varprop_fused(
            T, m8, codes, grid, mat, gstreams=True, **kw)}
    a, b = tiers["classic"](T32, 0), tiers["g-streams"](T32, 0)
    rel = float((a - b).abs().max() / b.abs().max())
    times = {"classic": [], "g-streams": []}
    for name in ("classic", "g-streams", "g-streams", "classic"):
        _, ms = timed_seq(torch, tiers[name], T32, P3_STEPS)
        times[name].append(statistics.median(ms))
    print(f"[phase 10] {n}^3 f32 varprop A/B (classic / g-streams / "
          f"g-streams / classic): {times['classic'][0]:.3f} / "
          f"{times['g-streams'][0]:.3f} / {times['g-streams'][1]:.3f} / "
          f"{times['classic'][1]:.3f} ms/step; one step apart by "
          f"{rel:.2e} (relative)", flush=True)
    check(rel < 1e-5, f"phase 10 A/B: the tiers differ by {rel:.2e}")
    out["f32 A/B"] = times
    del a, b, T32, codes, m8
    torch.cuda.empty_cache()

    # bench.py run_corrected at 384^3: per-face film fields and radiation
    # scales take the classic tier, at bfloat16 its bfloat16 entries;
    # beside the float32 step of the same case, and held to its state
    hf, scale = corrected_fields(torch, grid.shape, dev)
    cbc = dict(robin_h=hf, radiation_scale=scale, emissivity=EMISSIVITY,
               k_table=kt, cp_table=ct)
    names = (f"{n}^3 bf16 corrected (bench run_corrected, classic tier)",
             f"{n}^3 f32 corrected (the same case)")
    Tb = engine_run(names[0], grid, mask, T0.to(bf), bf, P10_VP_DT,
                    {"K5b": 1, "K6b": 1, "K7b": 1, "K19b": 1}, **cbc)
    Tf = engine_run(names[1], grid, mask, T0.to(f32), f32, P10_VP_DT,
                    {"K5": 1, "K6": 1, "K7": 1, "K19": 1}, **cbc)
    cool32 = float((T0 - Tf)[mask].mean())

    def held_to_f32(route, T):
        """The bfloat16 state against float32's: max and mean over the
        solid, and the solid's mean change (unbiased rounding keeps it)."""
        d = (T.float() - Tf)[mask].abs()
        cool = float((T0 - T.float())[mask].mean())
        print(f"[phase 10] {n}^3 corrected{route} after "
              f"{P3_WARMUP + P3_STEPS} steps: |T_bf16 - T_f32| max "
              f"{float(d.max()):.3f} K (gate {P10_CORR_MAX_TOL}), mean "
              f"{float(d.mean()):.4f} K (gate {P10_CORR_MEAN_TOL}) over the "
              f"solid; the solid cooled {cool:.5f} K on average (float32 "
              f"{cool32:.5f} K, gate {P10_CORR_COOL_RTOL} of it)", flush=True)
        check(float(d.max()) <= P10_CORR_MAX_TOL
              and float(d.mean()) <= P10_CORR_MEAN_TOL,
              f"phase 10 corrected{route}: bf16 max {float(d.max()):.3f} K, "
              f"mean {float(d.mean()):.4f} K from float32")
        check(cool32 > 0.0 and abs(cool - cool32) <= P10_CORR_COOL_RTOL
              * cool32, f"phase 10 corrected{route}: the solid cooled "
              f"{cool:.5f} K on average, float32 {cool32:.5f} K")

    held_to_f32("", Tb)
    print(f"[phase 10] {n}^3 corrected: bf16/f32 time "
          f"{out[names[0]]['ms'] / out[names[1]]['ms']:.3f}", flush=True)
    # the same step with fuse_theta=False: K20b, then K7's x entry
    prepare, _ = make_cartesian_engine(
        grid, mat, implementation="kernels", device=dev, dtype=bf, theta=0.5,
        t_inf=20.0, stochastic_rounding=True, **cbc)
    m8, codes, h_ab = prepare(mask)
    before = launch_counts()
    Tu, step_ms = timed_seq(torch, lambda T, i: adi_step_varprop_fused(
        T, m8, codes, grid, mat, k_table=kt, cp_table=ct, dt=P10_VP_DT,
        theta=0.5, t_inf=20.0, h_axes=h_ab, emissivity=EMISSIVITY,
        h_conv=None, fuse_theta=False, rng_seed=i), T0.to(bf), P3_STEPS)
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    per = {"K5b": 1, "K20b": 1, "K7xb": 1, "K7b": 1, "K19b": 1}
    want = {k: (P3_WARMUP + P3_STEPS) * per.get(k, 0) for k in delta}
    check(delta == want, f"phase 10 corrected, fuse_theta=False: launches "
          f"{delta} != expected {want}")
    ms = statistics.median(step_ms)
    print(f"[phase 10] {n}^3 bf16 corrected, fuse_theta=False: {ms:9.3f} "
          f"ms/step (median; steps {', '.join(f'{s:.3f}' for s in step_ms)})"
          f"; launches per step {per}", flush=True)
    held_to_f32(", fuse_theta=False", Tu)
    out["bf16 corrected, fuse_theta=False"] = dict(ms=ms)
    del Tb, Tf, Tu, hf, scale, cbc, m8, codes, h_ab, T0, mask
    torch.cuda.empty_cache()

    # the drift gates of tests/test_bf16_drift.py: 64x56x48 at 900 C,
    # Robin 200, dt 0.002 (at the state dtype, as that test passes it),
    # 30 steps
    grid = CartesianGrid(64, 56, 48, 1e-3)
    mask = torch.ones(grid.shape, dtype=torch.bool, device=dev)

    def cooling(dtype, sr, t0=0.0, steps=30, g=grid, m=mask):
        prepare, advance = make_cartesian_engine(
            g, mat, implementation="kernels", device=dev, dtype=dtype,
            theta=0.5, t_inf=20.0, robin_h=200.0, stochastic_rounding=sr)
        T = torch.full(g.shape, 900.0, dtype=dtype, device=dev)
        return advance(T, prepare(m), round_to_state(0.002, dtype), steps,
                       t0).double()

    ref, sr, rtn = (cooling(f32, False), cooling(bf, True),
                    cooling(bf, False))
    drift = (sr - ref).abs()
    cooled = {k: 900.0 - float(v.mean()) for k, v in
              (("f32", ref), ("sr", sr), ("rtn", rtn))}
    print(f"[phase 10] drift gates (64x56x48, 30 steps): SR vs f32 max "
          f"{float(drift.max()):.3f} K (< 21), mean {float(drift.mean()):.4f}"
          f" K (< 2.5); cooled f32 {cooled['f32']:.3f} K, SR "
          f"{cooled['sr']:.3f} K, nearest {cooled['rtn']:.3f} K "
          f"(< half of f32: the freeze)", flush=True)
    check(float(drift.max()) < 21.0 and float(drift.mean()) < 2.5,
          "phase 10: stochastic rounding outside the drift envelope")
    # the float32 run cools ~0.3 K on average in these 30 steps (the JAX
    # test's "> 0.5 K" bound is above what this configuration cools): it
    # must cool, and round-to-nearest less than half as much
    check(cooled["f32"] > 0.1 and cooled["rtn"] < 0.5 * cooled["f32"],
          "phase 10: the round-to-nearest freeze was not detected")
    g32 = CartesianGrid(32, 32, 32, 1e-3)
    m32 = torch.ones(g32.shape, dtype=torch.bool, device=dev)
    x = cooling(bf, True, 0.0, 1, g32, m32)
    y = cooling(bf, True, 1000 * 0.002, 1, g32, m32)
    same = cooling(bf, True, 0.0, 1, g32, m32)
    print(f"[phase 10] seeds: same counter identical "
          f"{bool(torch.equal(x, same))}, other counter differs at "
          f"{int((x != y).sum())} cells", flush=True)
    check(bool(torch.equal(x, same)) and bool((x != y).any()),
          "phase 10: the step counter does not decorrelate the rounding")
    out["drift"] = dict(max=float(drift.max()), mean=float(drift.mean()),
                        cooled=cooled)
    return out


def phase10_app(torch, dev, p4, p5_32):
    """The WAAM app on phase 4's bar with --precision bfloat16, with phase
    5's varprop flags (the g-stream tier), and with those flags less the
    latent heat, over the whole print on the kernels, against float32
    fields of the same flags (phases 4 and 5; a float32 run here); then on
    phase 9's turned bar with --corrected_bc 1 and the varprop flags (the
    classic tier's bfloat16 entries): less the latent heat against a
    float32 print of the same flags here, with it printed only."""
    vp_flags = ["--latent_J_kg", str(LATENT), "--melt_k_factor", "4",
                "--emissivity", str(EMISSIVITY)]
    no_latent = vp_flags[2:]
    cbc = ["--corrected_bc", "1"]
    p_nl = app_phase(torch, dev, 10, no_latent, impls=("kernels",))
    p_cnl = app_phase(torch, dev, 10, cbc + no_latent, impls=("kernels",),
                      turn_deg=30.0)
    out = {}
    for name, extra, f32_run, gated, turn in (
            ("constant", [], p4, True, 0.0),
            ("varprop without latent heat", no_latent, p_nl, True, 0.0),
            ("varprop", vp_flags, p5_32, False, 0.0),
            ("corrected varprop without latent heat", cbc + no_latent,
             p_cnl, True, 30.0),
            ("corrected varprop", cbc + vp_flags, None, False, 30.0)):
        res = app_phase(torch, dev, 10, extra, precision="bfloat16",
                        impls=("kernels",), turn_deg=turn)
        if f32_run is None:     # printed only: no float32 print of these
            T = res["T_kernels"].float()[res["active"]]
            print(f"[phase 10] app {name}: bf16 over the solid max "
                  f"{float(T.max()):.3f} C, mean {float(T.mean()):.4f} C "
                  f"(not gated: the solidus freeze, PERF.md); wall "
                  f"{res['wall_kernels']:.2f} s", flush=True)
            out[name] = dict(wall=res["wall_kernels"])
            continue
        Tb, T32 = res["T_kernels"].float(), f32_run["T_kernels"].float()
        d = (Tb - T32)[res["active"]].abs()
        print(f"[phase 10] app {name}: |T_bf16 - T_f32| over the solid max "
              f"{float(d.max()):.3f} K, mean {float(d.mean()):.4f} K"
              + (f" (gate {P10_APP_MEAN_TOL} K)" if gated else
                 " (not gated: the solidus freeze, PERF.md)")
              + f"; wall {res['wall_kernels']:.2f} s", flush=True)
        if gated:
            check(float(d.mean()) < P10_APP_MEAN_TOL, f"phase 10 app "
                  f"{name}: mean {float(d.mean()):.3f} K > "
                  f"{P10_APP_MEAN_TOL} K")
        out[name] = dict(wall=res["wall_kernels"], max=float(d.max()),
                         mean=float(d.mean()))
    out["float32 varprop without latent heat"] = p_nl
    return out


def max_over_tol(a, b, rtol, atol):
    """max(|a - b| - (atol + rtol*|b|)): <= 0 when a is within the
    tolerance of b at every cell (numpy's allclose)."""
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def phase2_remainder(torch, dev):
    """K1's v1 entry (the public v1 sweeps) and K15's y entry against
    their plain versions."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        build_vp2_code, fused_sweep, fused_sweep_axis1,
        fused_sweep_axis1_plain, fused_sweep_plain, sweep_code, vp2_sweep_y,
        vp2_sweep_y_plain)

    mat = Material(7800.0, 490.0, 54.0)
    rows = []

    def compare(kname, vname, label, dtype, kern, plain, ins):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"{kname} {vname} {label}: non-finite output")
        err = float((got - want).abs().max())
        ulps = err / (torch.finfo(dtype).eps * float(want.abs().max()))
        cells = got.numel()
        # each input read once, the output written once
        nbytes = sum(t.numel() * t.element_size() for t in (*ins, got))
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, 1, warm=False)
        pct = 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
        rows.append(dict(kernel=kname, variant=vname, shape=label,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bytes_per_cell=nbytes / cells, pct_hbm=pct,
                         **bound(kname, nbytes, cells)))
        print(f"[phase 2] {kname} {vname:32s} {label:26s} max|d|={err:.3e} "
              f"({ulps:.2f} ulp of scale, tol {KERNEL_TOL_ULP})  kernel "
              f"{ms:8.3f} ms  plain {plain_ms:9.3f} ms  {pct:5.1f}% of 3.35 "
              f"TB/s at {nbytes / cells:.2f} B/cell", flush=True)
        check(ulps <= KERNEL_TOL_ULP, f"{kname} {vname} {label}: "
              f"{ulps:.2f} ulp of the output's scale > {KERNEL_TOL_ULP}")

    # K1v1: every axis, the Neumann and Dirichlet folds and pinned codes
    # without dir_val, float32 and float64
    for label, shape in (P2_SHAPES[0], P2_SHAPES[2]):
        grid = CartesianGrid(*shape, 0.5e-3)
        if label.endswith("waam"):
            mask = waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(3)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        dirm = torch.zeros_like(mask)
        dirm[:, :, 0] = mask[:, :, 0]
        dirm[:, 0, :] |= mask[:, 0, :]
        T32 = random_field(torch, mask, seed=7)
        g = torch.Generator(device=dev).manual_seed(9)
        rnd = (lambda: torch.rand(shape, generator=g, device=dev))
        fields32 = dict(coeff=torch.where(mask & (rnd() > 0.5), 0.3, 0.0),
                        qflux=torch.where(mask, 5e3 * rnd(), 0.0),
                        dir_val=20.0 + 580.0 * rnd())
        dt = 2.0 * grid.dx ** 2 / mat.alpha
        tg = 0.5 * dt * mat.alpha / grid.dx ** 2
        codes = [sweep_code(mask, dirm, a) for a in range(3)]
        code1 = codes[1].movedim(0, 1).contiguous()
        for dtype in (torch.float32, torch.float64):
            dn = "f32" if dtype == torch.float32 else "f64"
            T = T32.to(dtype)
            fl = {k: v.to(dtype) for k, v in fields32.items()}
            for case, kw in (("pinned, no dir_val",
                              dict(coeff=fl["coeff"])),
                             ("neumann+dirichlet", fl)):
                ins = (T, codes[0], *kw.values())
                for axis in range(3):
                    args = (T, codes[axis], kw["coeff"], tg, dt, 20.0, axis)
                    extra = {k: v for k, v in kw.items() if k != "coeff"}
                    compare("K1v1", f"{'xyz'[axis]}, {case}",
                            f"{label} {dn}", dtype,
                            lambda: fused_sweep(*args, **extra),
                            lambda: fused_sweep_plain(*args, **extra), ins)
                # the axis-1 form on the natural layout (n = 203 at the
                # random shape: not a multiple of 32)
                args = (T, code1, kw["coeff"], tg, dt, 20.0)
                extra = {k: v for k, v in kw.items() if k != "coeff"}
                compare("K1v1", f"axis-1 form, {case}", f"{label} {dn}",
                        dtype, lambda: fused_sweep_axis1(*args, **extra),
                        lambda: fused_sweep_axis1_plain(*args, **extra), ins)
            del T, fl
        del T32, mask, dirm, fields32, codes, code1
        torch.cuda.empty_cache()

    # K15y at the WAAM mask, float32, scalar and radiative film: its lines
    # split across threads (the core's strided kernel), the split gate
    kt, ct = varprop_tables()
    for label, shape in P11_Y_SHAPES:
        grid = CartesianGrid(*shape, 0.5e-3)
        sc = vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
        glo = float(torch.tensor(0.5 / grid.dy ** 2, dtype=torch.float32))
        gs = float(torch.tensor(1.0 / grid.dy, dtype=torch.float32))
        mask = waam_mask(torch, shape, dev)
        T = mushy_field(torch, mask, seed=7)
        R = random_field(torch, mask, seed=13)
        code = build_vp2_code(mask, 1, edge_exposed=True)
        for vname, eps, h in (("y, h 30", 0.0, H_CONV),
                              ("y, rad", EMISSIVITY, H_CONV)):
            kw = dict(k_spec=kt, cp_spec=ct, h=h, t_inf=20.0, emissivity=eps)
            args = (R, T, code, glo, gs, sc["inv_dtor"])
            compare("K15y", vname, f"{label} f32", torch.float32,
                    lambda: vp2_sweep_y(*args, **kw),
                    lambda: vp2_sweep_y_plain(*args, **kw), (R, T, code))
        del T, R, mask, code
        torch.cuda.empty_cache()
    return rows


def phase11_step(torch, dev, p5_32, p_nl, p5):
    """The v1 sweeps' path, and the 512^3 varprop step and the WAAM
    varprop prints with VP2_Y_DEFAULT on (K15's y entry) against the same
    with it off (``p5_32``, and ``p_nl`` without the latent heat; ``p5``:
    the float64 print, which takes K7 either way); the switch is set back
    whatever happens."""
    import adi_thermal_fields_tpu_torch.step.cartesian_varprop as cv
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              build_coeff_packs)
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.solvers import (fused_sweep,
                                                      launch_counts,
                                                      sweep_code)
    from adi_thermal_fields_tpu_torch.step.cartesian import implicit_sweep

    mat = Material(7800.0, 490.0, 54.0)
    out = {}
    # the v1 path: one implicit x, y, z pass through the public v1 entry
    # on the 256^3 WAAM mask with __graft_entry__'s BCs and a Dirichlet
    # bottom, against the reference sweeps
    n = P2_SHAPES[0][1][0]
    grid = CartesianGrid(n, n, n, 0.5e-3)
    mask = waam_mask(torch, grid.shape, dev)
    dirm = torch.zeros_like(mask)
    dirm[:, :, 0] = mask[:, :, 0]
    pk = build_coeff_packs(mask, grid, mat, dtype=torch.float32,
                           robin_h=200.0, neumann={"z+": 5e5},
                           dirichlet_mask=dirm, dirichlet_value=600.0)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    tg = 0.5 * dt * mat.alpha / grid.dx ** 2
    codes = [sweep_code(mask, dirm, a) for a in range(3)]
    before = launch_counts()
    U = W = random_field(torch, mask, seed=19)
    for axis in range(3):
        U = fused_sweep(U, codes[axis], pk.coeff[axis], tg, dt, 20.0, axis,
                        qflux=pk.qflux[axis], dir_val=pk.dir_val)
        W = implicit_sweep(W, mask, pk.coeff[axis], dirm, pk.dir_val,
                           pk.qflux[axis], tg, dt, 20.0, axis)
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    err = float((U - W).abs().max())
    print(f"[phase 11] v1 pass x, y, z at {n}^3 f32 (h 200, q'' 5e5 on z+, "
          f"600 C bottom): max|fused_sweep - implicit_sweep| = {err:.3e} K; "
          f"launches {delta}", flush=True)
    check(delta == {k: 3 if k == "K1v1" else 0 for k in delta},
          f"phase 11 v1 pass: launches {delta}")
    check(err <= STEP_TOL, f"phase 11 v1 pass: {err:.3e} K > {STEP_TOL}")
    out["v1_pass_err"] = err
    del mask, dirm, pk, codes, U, W
    torch.cuda.empty_cache()

    # phase 3's 512^3 float32 varprop step (the tables + h 30 + eps 0.5)
    n = P3_N
    grid = CartesianGrid(n, n, n, 0.5e-3)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    mask = waam_mask(torch, grid.shape, dev)
    T0 = mushy_field(torch, mask, seed=11)
    kt, ct = varprop_tables()
    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device=dev, dtype=torch.float32,
        theta=0.5, t_inf=20.0, k_table=kt, cp_table=ct, robin_h=H_CONV,
        emissivity=EMISSIVITY)
    y_k = {False: "K7", True: "K15y"}
    saved = cv.VP2_Y_DEFAULT
    try:
        # the codes as the engine builds them under each setting (the vp2
        # y code only with the switch on)
        preps = {}
        for flag in (False, True):
            cv.VP2_Y_DEFAULT = flag
            preps[flag] = prepare(mask)
        # each of 3 steps: off and on from the switch-off run's state
        T, errs = T0, []
        for _ in range(P3_STEPS):
            res = {}
            for flag in (False, True):
                cv.VP2_Y_DEFAULT = flag
                before = launch_counts()
                res[flag] = advance(T, preps[flag], dt, 1, 0.0)
                delta = {k: v - before[k] for k, v in launch_counts().items()}
                want = {k: 1 if k in ("K5", "K6", "K8", y_k[flag]) else 0
                        for k in delta}
                check(delta == want, f"phase 11 step, VP2_Y_DEFAULT={flag}: "
                      f"launches {delta} != {want}")
            check(bool(torch.isfinite(res[True]).all()),
                  "phase 11 step: non-finite T")
            errs.append((float((res[True] - res[False]).abs().max()),
                         max_over_tol(res[True], res[False], P11_RTOL,
                                      P11_ATOL)))
            T = res[False]
        print(f"[phase 11] {n}^3 f32 varprop step (tables + h 30 + eps 0.5)"
              f", y on K15y vs K7 per step from a shared state: max|d| "
              f"{', '.join(f'{e:.3e}' for e, _ in errs)} K (rtol "
              f"{P11_RTOL}, atol {P11_ATOL} K); launches per step K5 = K6 "
              f"= K8 = 1 and K15y = 1, K7 = 0 (on) / K7 = 1, K15y = 0 (off)",
              flush=True)
        check(max(o for _, o in errs) <= 0.0, "phase 11 step: K15y vs K7 "
              f"outside rtol {P11_RTOL} / atol {P11_ATOL}: {errs}")
        # the A/B, in turns: off, on, on, off
        ab = []
        for flag in (False, True, True, False):
            cv.VP2_Y_DEFAULT = flag
            ab.append((flag, statistics.median(timed_steps(
                torch, lambda T, f=flag: advance(T, preps[f], dt, 1, 0.0),
                T0, P3_STEPS))))
        ms = {f: statistics.mean(m for g, m in ab if g == f)
              for f in (False, True)}
        print(f"[phase 11] A/B ms/step (off / on / on / off): "
              f"{' / '.join(f'{m:.3f}' for _, m in ab)}; on/off "
              f"{ms[True] / ms[False]:.3f}", flush=True)
        out.update(ab=ab, step_errs=errs)
        del T, T0, res, preps, mask
        torch.cuda.empty_cache()
        # the float32 varprop prints with the switch on: without the latent
        # heat (gated) and with it (printed)
        cv.VP2_Y_DEFAULT = True
        vp_flags = ["--latent_J_kg", str(LATENT), "--melt_k_factor", "4",
                    "--emissivity", str(EMISSIVITY)]
        runs = [(name, app_phase(torch, dev, 11, flags, impls=("kernels",)),
                 off) for name, flags, off in (
                     ("without latent heat", vp_flags[2:], p_nl),
                     ("with latent heat", vp_flags, p5_32))]
    finally:
        cv.VP2_Y_DEFAULT = saved
    # the float64 prints (y on K7 under either setting): phase 5's with the
    # latent heat, and one without it
    ref64 = {"without latent heat": app_phase(
        torch, dev, 11, vp_flags[2:], precision="float64",
        impls=("kernels",))["T_kernels"],
        "with latent heat": p5["T_kernels"]}
    for name, on, off in runs:
        T_on, T_off = on["T_kernels"], off["T_kernels"]
        solid = on["active"]
        diff = (T_on - T_off).abs()
        far = diff > APP_TOL
        err = float(diff.max())
        # where they part: distance from the solidus, in either run
        near = torch.minimum((T_on - SOLIDUS).abs(), (T_off - SOLIDUS).abs())
        print(f"[phase 11] app varprop {name} f32, y on K15y vs K7: max|d| "
              f"= {err:.3e} K, mean {float(diff[solid].mean()):.3e} K"
              f" over the solid; {int(far.sum())} cells above {APP_TOL} K"
              + (f", each within {float(near[far].max()):.3f} K of the "
                 f"solidus in one run" if bool(far.any()) else "")
              + f"; wall {on['wall_kernels']:.2f} s (off: "
              f"{off['wall_kernels']:.2f} s)"
              + ("" if name == "without latent heat" else
                 f" (not gated: above the {APP_TOL} K asked, PERF.md)"),
              flush=True)
        # each float32 print against the float64 one, over the solid
        for key, t in (("on", T_on), ("off", T_off)):
            e = (t.double() - ref64[name])[solid]
            print(f"[phase 11] app varprop {name}, switch {key}: T_float32 "
                  f"- T_float64 over the solid: max|d| "
                  f"{float(e.abs().max()):.3e} K, mean|d| "
                  f"{float(e.abs().mean()):.3e} K, mean d "
                  f"{float(e.mean()):+.3e} K", flush=True)
        out[f"app_err {name}"] = err
        if name == "without latent heat":
            check(err <= APP_TOL, f"phase 11 app {name}: {err:.3e} K > "
                  f"{APP_TOL} K")
    return out


def profile_phase8(torch, dev, steps=5):
    """``--profile``: torch.profiler over ``steps`` kernel steps of phase
    8's BE and Douglas steps (after two warm-ups): the device time of each
    operation per step, and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    from adi_thermal_fields_tpu_torch import (RobinBC, adi_step_cyl_varprop,
                                              build_cyl_vp2_plan)

    label, shape, _ = P8_SHAPES[0]
    grid, mat, mask, zbc, T0 = cylvp_case(torch, label, shape, torch.float32,
                                          dev)
    kt, ct = varprop_tables()
    kw = dict(dt=P8_DT, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
              robin_inner=RobinBC(50.0, 20.0), active=mask, h_void=80.0,
              T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
              emissivity=EMISSIVITY,
              vp2_plan=build_cyl_vp2_plan(mask, grid, zbc))
    for scheme in ("be", "douglas"):
        T = T0
        for _ in range(P3_WARMUP):
            T = adi_step_cyl_varprop(T, grid, mat, scheme=scheme, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            T = T0
            for _ in range(steps):
                T = adi_step_cyl_varprop(T, grid, mat, scheme=scheme, **kw)
            end.record()
            end.synchronize()
        window_ms = start.elapsed_time(end)

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        # the device's own rows (kernels, copies): the operators above
        # them repeat their kernels' time
        ops = sorted((e for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")
                      and dev_us(e) > 0), key=dev_us, reverse=True)
        busy_ms = sum(dev_us(e) for e in ops) / 1e3
        print(f"[profile] {label} f32 {scheme} step: {window_ms / steps:.3f} "
              f"ms/step over {steps} steps (CUDA events), device busy "
              f"{busy_ms / steps:.3f} ms/step, idle "
              f"{100.0 * max(0.0, 1.0 - busy_ms / window_ms):.1f}%",
              flush=True)
        for e in ops[:14]:
            print(f"[profile]   {dev_us(e) / 1e3 / steps:8.3f} ms/step "
                  f"{100.0 * dev_us(e) / 1e3 / busy_ms:5.1f}%  "
                  f"{e.count // steps:4d}x  {e.key[:90]}", flush=True)


def history_ms(torch, dev, label, shape, mask):
    """The history pass's ms per sub-step (history_update on (T_peak,
    t_above) for 800 and 500 C) beside one float32 sub-step of the
    engine's plan-lite step (h 30), without and with the history."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import (
        history_update, make_cartesian_engine)

    grid = CartesianGrid(*shape, P4_DX_MM * 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    T = random_field(torch, mask, 71)
    dt = 0.02
    ms = {}
    for hist in (None, (800.0, 500.0)):
        prep, adv = make_cartesian_engine(
            grid, mat, implementation="kernels", device=dev,
            dtype=torch.float32, robin_h=30.0, t_inf=20.0,
            history_t_crit=hist)
        p = prep(mask)
        if hist is None:
            ms["step"] = cuda_ms(torch, lambda: adv(T, p, dt, 1), 5)
        else:
            pk = T.clone()
            ta = torch.zeros((2,) + tuple(shape), dtype=torch.float32,
                             device=dev)
            ms["step + history"] = cuda_ms(
                torch, lambda: adv(T, p, dt, 1, 0.0, (pk, ta)), 5)
            tc = torch.tensor(hist, dtype=torch.float32, device=dev)
            ms["history"] = cuda_ms(
                torch, lambda: history_update(pk, ta, T, dt, tc, True), 5)
        del p
    nbytes = 28 * mask.numel()     # T read, T_peak and 2 t_above r/w
    bnd = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[phase 12] {label}: history pass {ms['history']:.3f} ms per "
          f"sub-step (bound {bnd:.3f}, 28 B/cell), the engine's sub-step "
          f"{ms['step']:.3f} ms, with the history {ms['step + history']:.3f}"
          f" ms ({100 * ms['history'] / ms['step']:.1f}% of the step)",
          flush=True)
    return ms


def phase12_bar(torch, dev, p4):
    """(a) Phase 4's print with the history, its VTK files and its
    checkpoint, then a resume from that checkpoint."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.apps import waam_from_stl as app
    from adi_thermal_fields_tpu_torch.io.checkpoint import load_checkpoint
    from adi_thermal_fields_tpu_torch.io.vtk import (
        read_vtk_structured_points)

    work = os.path.join(HERE, "build", "chip_smoke")
    ck = os.path.join(work, "ck.npz")
    outdir = os.path.join(work, "vtk")
    shutil.rmtree(outdir, ignore_errors=True)
    argv = bar_argv(dev) + P12_HIST + [
        "--implementation", "kernels", "--checkpoint", ck, "--save_vtk", "1",
        "--outdir", outdir]
    t0 = time.perf_counter()
    res = app.run(app.build_argparser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[phase 12] bar with history, 4 VTK frames and checkpoints: "
          f"{res['substeps']} sub-steps, wall {wall:.2f} s (phase 4's "
          f"kernels: {p4['wall_kernels']:.2f} s)", flush=True)
    T = res["T"]
    check(torch.equal(T, p4["T_kernels"]), "phase 12: the history changed "
          "the field: T differs from phase 4's kernels T")
    pk, ta = res["history"]
    check(ta.shape == (2,) + tuple(T.shape) and ta.dtype == torch.float32,
          f"phase 12: t_above {tuple(ta.shape)} {ta.dtype}")
    names = sorted(os.listdir(outdir))
    check(len(names) == 5 and "waam_history.vtk" in names,
          f"phase 12: VTK files {names}")
    h = read_vtk_structured_points(os.path.join(outdir, "waam_history.vtk"))
    check(sorted(h) == ["Mask", "T_peak", "t_above_500", "t_above_800"],
          f"phase 12: history fields {sorted(h)}")
    a = h["Mask"] > 0.5
    T_np = T.cpu().numpy()
    check(bool((a == res["active"].cpu().numpy()).all()),
          "phase 12: the history file's mask is not the active set")
    ts = float(np.float32(1500.0))
    check(bool((h["T_peak"][a] >= T_np[a]).all()),
          "phase 12: T_peak < T on an active cell")
    check(bool((h["T_peak"][a] == ts).all()), "phase 12: a deposited "
          "cell's peak is not --Ts (the bar is all deposit)")
    for tc in (800, 500):
        f = h[f"t_above_{tc}"]
        check(bool((f >= 0).all()) and not f[a & (h["T_peak"] <= tc)].any(),
              f"phase 12: t_above_{tc} nonzero where the peak stayed under "
              "it, or negative")
    t85 = h["t_above_500"] - h["t_above_800"]
    check(bool((t85 >= 0).all()), "phase 12: t8/5 < 0")
    check(not any(h[k][~a].any() for k in h), "phase 12: a never-born cell "
          "carries history")
    st = load_checkpoint(ck)
    check(st.t == res["t"] and np.array_equal(st.T, T_np)
          and np.array_equal(st.meta["history_peak"], pk.cpu().numpy())
          and np.array_equal(st.meta["history_above"], ta.cpu().numpy()),
          "phase 12: the checkpoint is not the run's state")
    print(f"[phase 12] waam_history.vtk: {int(a.sum())} active cells, "
          f"T_peak {float(h['T_peak'][a].min()):.1f}-"
          f"{float(h['T_peak'][a].max()):.1f} C, t_above_800 max "
          f"{float(h['t_above_800'].max()):.3f} s, t8/5 max "
          f"{float(t85.max()):.3f} s, mean {float(t85[a].mean()):.3f} s",
          flush=True)
    back = app.run(app.build_argparser().parse_args(argv + ["--resume",
                                                            ck]))
    check(torch.equal(back["T"], T) and torch.equal(back["history"][0], pk)
          and torch.equal(back["history"][1], ta),
          "phase 12: --resume does not give the run's field and peaks")
    bar_mask = res["active"].contiguous()
    del res, back, T, pk, ta
    torch.cuda.empty_cache()
    return dict(wall=wall, bar_mask=bar_mask)


def phase12_history_ms(torch, dev, bar_mask):
    """The history pass against the engine's sub-step on the bar and at
    512^3 (after the main path's counts are read)."""
    out = {"bar": history_ms(torch, dev, f"bar {tuple(bar_mask.shape)}",
                             tuple(bar_mask.shape), bar_mask)}
    big = waam_mask(torch, (P3_N,) * 3, dev)
    out[f"{P3_N}^3"] = history_ms(torch, dev, f"{P3_N}^3 waam",
                                  (P3_N,) * 3, big)
    del big
    torch.cuda.empty_cache()
    return out


def phase12_dwell(torch, dev):
    """(b) The bar with interpass dwell control, kernels and reference."""
    from adi_thermal_fields_tpu_torch.apps import waam_from_stl as app

    runs = {}
    for impl in ("kernels", "reference"):
        t0 = time.perf_counter()
        res = app.run(app.build_argparser().parse_args(
            bar_argv(dev, layer_s=SHORT_LAYER_S) + P12_DWELL
            + ["--implementation", impl]))
        torch.cuda.synchronize()
        runs[impl] = res
        log = res["dwell_log"] or []
        print(f"[phase 12] interpass bar {impl:9s}: {res['substeps']} "
              f"sub-steps, {len(log)} dwells, "
              f"{sum(d for _, d in log):.2f} s of dwell, wall "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    k, r = runs["kernels"], runs["reference"]
    check(k["dwell_log"] == r["dwell_log"] and len(k["dwell_log"] or [])
          == P4_LAYERS - 1, f"phase 12: dwell logs {k['dwell_log']} != "
          f"{r['dwell_log']}")
    check(k["substeps"] == r["substeps"], "phase 12: dwell sub-steps differ")
    err = float((k["T"] - r["T"]).abs().max())
    print(f"[phase 12] interpass bar: max|T_kernels - T_reference| = "
          f"{err:.3e} K", flush=True)
    check(err <= APP_TOL, f"phase 12 interpass: {err:.3e} K > {APP_TOL} K")


def phase12_spiral(torch, dev):
    """(c) Phase 6's spiral print interrupted at half its --t_tot and
    resumed, against the straight print, with the history."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.apps import spiral_tube as app

    # phase 6's print at the fixed speed its --auto_speed chooses (a
    # schedule that does not depend on --t_tot): 20 layers of 1.5 s at the
    # wall's mid-radius
    argv = [a for a in P6_APP if a != "--auto_speed"]
    i = argv.index("--t_tot")
    t_tot = float(argv[i + 1])
    del argv[i:i + 2]
    a = app.build_argparser().parse_args(P6_APP)
    r_mid = a.R_out - 0.5 * a.wall_thickness
    n_layers = round(a.height / a.pitch)
    speed = 2 * np.pi * r_mid / (t_tot / n_layers)
    ck = os.path.join(HERE, "build", "chip_smoke", "spiral_ck.npz")
    argv += ["--speed", repr(speed), "--device", str(dev),
             "--implementation", "kernels", "--history_out", ""] + P12_HIST
    runs = {}
    for name, extra in (("half", ["--t_tot", repr(t_tot / 2),
                                  "--checkpoint", ck]),
                        ("resumed", ["--t_tot", repr(t_tot), "--resume",
                                     ck]),
                        ("straight", ["--t_tot", repr(t_tot)])):
        t0 = time.perf_counter()
        res = app.run(app.build_argparser().parse_args(argv + extra))
        torch.cuda.synchronize()
        runs[name] = res
        print(f"[phase 12] spiral {name:8s}: {res['steps_run']} steps, wall "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    r, s = runs["resumed"], runs["straight"]
    dT = float((r["T"] - s["T"]).abs().max())
    dta = float(np.abs(r["history"]["t_above"]
                       - s["history"]["t_above"]).max())
    dpk = float(np.abs(r["history"]["peak"] - s["history"]["peak"]).max())
    print(f"[phase 12] spiral resumed vs straight: max|dT| = {dT:.3e} K, "
          f"max|d t_above| = {dta:.3e} s, max|d T_peak| = {dpk:.3e} K",
          flush=True)
    check(runs["half"]["steps_run"] + r["steps_run"] == s["steps_run"],
          "phase 12: the resumed spiral's steps do not add up")
    check(torch.equal(r["T"], s["T"]) and dta == 0.0 and dpk == 0.0,
          "phase 12: the resumed spiral is not bit for bit the straight "
          "print")
    check(float(s["history"]["t_above"].max()) > 0.0,
          "phase 12: the spiral's history stayed empty")


def phase12_track(torch, dev):
    """(d) The single-track app at full width, with and without the
    torch, then at 0.5 mm with the kernels and the reference step."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.apps import single_track as app
    from adi_thermal_fields_tpu_torch.solvers import (launch_counts,
                                                      reset_launch_counts)

    per_step = {"birth": dict(K4=1, K1=1, K2=1),
                "torch": dict(K3=1, K1=2, K2=1)}
    total = {}

    def counted(argv):
        """One run of the app, its launches added to ``total``."""
        reset_launch_counts()
        t0 = time.perf_counter()
        r = app.run(app.build_argparser().parse_args(argv))
        torch.cuda.synchronize()
        got = launch_counts()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return r, got, time.perf_counter() - t0

    res = {}
    for name, extra in (("birth", []), ("torch", P12_GOLDAK)):
        r, got, wall = counted(P12_TRACK + extra + ["--device", str(dev)])
        n = r["substeps"]
        want = {k: per_step[name].get(k, 0) * n for k in got}
        check(got == want, f"phase 12 track {name}: launches {got} != "
              f"{want}")
        T, active, act = r["T"], r["active"], r["activation_times"]
        bead = torch.isfinite(act)
        tmax = float(T[active].max())
        print(f"[phase 12] single track {name:5s}: grid {r['grid'].shape} "
              f"({r['grid'].ncells / 1e6:.2f} M cells), "
              f"{int(bead.any(dim=2).any(dim=0).sum())} bead columns, "
              f"{n} sub-steps, wall {wall:.2f} s, Tmax {tmax:.2f} C, "
              "launches per sub-step "
              + ", ".join(f"{k} {got[k] / n:g}" for k in CONST_KERNELS),
              flush=True)
        check(n > 1000, f"track {name}: {n} sub-steps")
        check(bool(torch.isfinite(T).all()), f"track {name}: non-finite T")
        check(bool(active[bead].all()), f"track {name}: a bead column is "
              "not active at the end")
        res[name] = r
    check(float(res["birth"]["T"][res["birth"]["active"]].max()) <= 1500.0,
          "track: Tmax above --T_track without the torch")
    a = res["birth"]["active"]
    hot = float(res["torch"]["T"][a].mean())
    cold = float(res["birth"]["T"][a].mean())
    print(f"[phase 12] single track: mean T over the part {cold:.2f} C "
          f"(birth), {hot:.2f} C (torch)", flush=True)
    check(hot > cold + 5.0, "track: the torch's run is not hotter")
    small = {}
    for impl in ("kernels", "reference"):
        small[impl], _, wall = counted(
            P12_TRACK_SMALL + P12_GOLDAK + ["--device", str(dev),
                                            "--implementation", impl])
        print(f"[phase 12] single track 0.5 mm {impl:9s}: "
              f"{small[impl]['substeps']} sub-steps, wall {wall:.2f} s",
              flush=True)
    err = float((small["kernels"]["T"] - small["reference"]["T"]).abs()
                .max())
    print(f"[phase 12] single track 0.5 mm: max|T_kernels - T_reference| = "
          f"{err:.3e} K", flush=True)
    check(err <= APP_TOL, f"track: kernels vs reference {err:.3e} K")
    return total


def grad_gate(torch, name, got, want, passes=1):
    """A gradient of the kernel path against autograd through the plain
    path: a field within ``passes`` x GRAD_TOL_ULP float32 ulp of its
    scale (KERNEL_TOL_F64 of it at float64), a scalar within
    GRAD_DT_RTOL of itself."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    dname = str(want.dtype).split(".")[-1]
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite gradient")
    if want.numel() == 1:
        rel = err / max(scale, 1e-300)
        lim = GRAD_DT_RTOL[dname]
        print(f"[phase 13] {name}: {float(got):.9e} against "
              f"{float(want):.9e} (relative {rel:.3e}, tol {lim:.0e})",
              flush=True)
        check(rel <= lim, f"{name}: relative {rel:.3e} > {lim:.0e}")
        return rel
    eps = torch.finfo(want.dtype).eps
    lim = (KERNEL_TOL_F64 if want.dtype == torch.float64 else
           passes * GRAD_TOL_ULP * eps) * scale
    print(f"[phase 13] {name}: max|d| = {err:.3e} of scale {scale:.3e} "
          f"({err / (eps * scale):.2f} ulp of scale; tol "
          f"{lim / (eps * scale):.0f})", flush=True)
    check(err <= lim, f"{name}: max|d| {err:.3e} > {lim:.3e}")
    return err / (eps * scale)


def lite_const(grid, mat, h, dtype):
    """The engine's plan-lite constant h/(rho cp d) per axis, in the op
    order of build_coeff_packs."""
    import numpy as np
    f = np.float32 if dtype == "float32" else np.float64
    return tuple(float(f(h) * f(1.0 / (mat.rho * mat.cp * d)))
                 for d in grid.spacing)


def cart_grad(torch, step, T0, dt0, w, steps=P13_STEPS):
    """(loss, dL/dT0, dL/ddt) of ``sum(w * T)`` after ``steps`` steps."""
    T = T0.clone().requires_grad_(True)
    dt = torch.tensor(dt0, dtype=T0.dtype, device=T0.device,
                      requires_grad=True)
    X = T
    for _ in range(steps):
        X = step(X, dt)
    loss = (w * X).sum()
    gT, gdt = torch.autograd.grad(loss, (T, dt))
    return loss.detach(), gT, gdt


def phase13_cartesian(torch, dev, n=P13_N, time_n=P13_TIME_N, rows=()):
    """(a) adi_step_fused's gradient against the plain adi_step's, the
    512^3 forward and forward+backward times, and (d) StepTimer."""
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              adi_step_cartesian,
                                              adi_step_fused,
                                              build_coeff_packs,
                                              build_sweep_plan)
    from adi_thermal_fields_tpu_torch.bc.faces import FACES
    from adi_thermal_fields_tpu_torch.io.profiling import StepTimer
    from adi_thermal_fields_tpu_torch.solvers import launch_counts

    def case(n, dtype, kind):
        grid = CartesianGrid(n, n, n, 0.5e-3)
        mat = Material(7800.0, 490.0, 54.0)
        mask = waam_mask(torch, grid.shape, dev)
        dname = str(dtype).split(".")[-1]
        if kind == "lite":
            packs = build_coeff_packs(mask, grid, mat, dtype=dtype,
                                      robin_h=30.0)
            plan = build_sweep_plan(mask, None, has_neumann=False,
                                    has_dirichlet=False,
                                    robin_const=lite_const(grid, mat, 30.0,
                                                           dname))
        elif kind == "entry":
            packs = build_coeff_packs(mask, grid, mat, dtype=dtype,
                                      robin_h=200.0, neumann={"z+": 5e5})
            plan = build_sweep_plan(mask, packs, has_neumann=True,
                                    has_dirichlet=False,
                                    robin_const=lite_const(grid, mat, 200.0,
                                                           dname))
        else:
            dirm = torch.zeros_like(mask)
            dirm[:, :, 0] = mask[:, :, 0]
            packs = build_coeff_packs(
                mask, grid, mat, dtype=dtype,
                robin_h={f: 200.0 for f in FACES}, neumann={"z+": 5e5},
                dirichlet_mask=dirm, dirichlet_value=77.0)
            plan = build_sweep_plan(mask, packs, has_neumann=True,
                                    has_dirichlet=True)
        T0 = random_field(torch, mask, seed=13).to(dtype)
        g = torch.Generator(device=dev).manual_seed(17)
        w = torch.rand(grid.shape, generator=g, device=dev).to(dtype)
        dt0 = 2.0 * grid.dx ** 2 / mat.alpha
        kw = dict(theta=0.5, t_inf=20.0)
        fused = (lambda X, dt: adi_step_fused(X, plan, grid, mat, dt=dt,
                                              **kw))
        plain = (lambda X, dt: adi_step_cartesian(X, mask, packs, grid, mat,
                                                  dt=dt, **kw))
        return fused, plain, T0, dt0, w

    fwd = {"lite": {"K4": 1, "K1": 1, "K2": 1},
           "entry": {"K3": 1, "K1": 2, "K2": 1}}
    fwd["field"] = fwd["entry"]
    # per step backward: three transposed solves on K21, K3 on the
    # cotangent and three unit-Laplacian K3 passes for c_exp's cotangent
    bwd = {"K21": 3, "K3": 4}
    out = {}
    for kind, dtype in (("lite", torch.float32), ("lite", torch.float64),
                        ("entry", torch.float32), ("field", torch.float32)):
        fused, plain, T0, dt0, w = case(n, dtype, kind)
        dname = str(dtype).split(".")[-1]
        name = f"{n}^3 {dname} {kind} plan"
        before = launch_counts()
        Lk, gTk, gdtk = cart_grad(torch, fused, T0, dt0, w)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        want = {k: P13_STEPS * (fwd[kind].get(k, 0) + bwd.get(k, 0))
                for k in delta}
        check(delta == want, f"[phase 13] {name}: launches {delta} != "
              f"expected {want}")
        Lp, gTp, gdtp = cart_grad(torch, plain, T0, dt0, w)
        print(f"[phase 13] {name}: loss {float(Lk):.9e} (plain "
              f"{float(Lp):.9e}); launches of forward + backward "
              f"{ {k: v for k, v in delta.items() if v} }", flush=True)
        passes = P13_STEPS * (sum(fwd[kind].values()) + 4)
        out[name] = dict(
            ulp_T=grad_gate(torch, f"{name} dL/dT0", gTk, gTp, passes),
            rel_dt=grad_gate(torch, f"{name} dL/ddt", gdtk, gdtp))
        del gTk, gTp
        torch.cuda.empty_cache()

    # the 512^3 float32 lite step: forward alone, forward + backward
    fused, _, T0, dt0, w = case(time_n, torch.float32, "lite")

    def forward():
        with torch.no_grad():
            X = T0
            for _ in range(P13_STEPS):
                X = fused(X, dt0)
        return X

    before = launch_counts()
    cart_grad(torch, fused, T0, dt0, w)
    mid = launch_counts()
    forward()
    after = launch_counts()
    added = {k: (mid[k] - before[k]) - (after[k] - mid[k])
             for k in P13_BWD_KERNELS}
    def grad_T_only():
        T = T0.clone().requires_grad_(True)
        X = T
        for _ in range(P13_STEPS):
            X = fused(X, dt0)
        return torch.autograd.grad((w * X).sum(), T)

    f_ms = cuda_ms(torch, forward, 5)
    fb_ms = cuda_ms(torch, lambda: cart_grad(torch, fused, T0, dt0, w), 5)
    fbT_ms = cuda_ms(torch, grad_T_only, 5)
    print(f"[phase 13] {time_n}^3 f32 lite, {P13_STEPS} steps: forward "
          f"{f_ms:.3f} ms, forward + backward (dL/dT0, dL/ddt) "
          f"{fb_ms:.3f} ms ({fb_ms / f_ms:.2f}x), dL/dT0 alone "
          f"{fbT_ms:.3f} ms ({fbT_ms / f_ms:.2f}x); the backward adds "
          f"launches {added}", flush=True)
    out["time"] = dict(forward_ms=f_ms, forward_backward_ms=fb_ms,
                       grad_T_ms=fbT_ms, backward_launches=added)
    # where the forward + backward's device time goes (torch.profiler
    # through io/profiling.trace; printed, not gated)
    from adi_thermal_fields_tpu_torch.io.profiling import trace
    with trace(os.path.join(HERE, "build", "trace_phase13")) as prof:
        cart_grad(torch, fused, T0, dt0, w)
        torch.cuda.synchronize()
    dev_us = (lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
    # the device's own rows (kernels, copies): each aten op's row counts
    # its kernels' time again
    kern = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kern) / 1e3
    print(f"[phase 13] profile of one forward + backward: device busy "
          f"{busy:.3f} ms; kernels by device time: " + "; ".join(
              f"{e.key.split('<')[0][:48]} {dev_us(e) / 1e3:.3f} ms "
              f"x{e.count}" for e in kern[:10]) + "; aten ops: "
          + "; ".join(f"{e.key} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                      for e in ops[:8]), flush=True)

    # (d) StepTimer's slope on the same step, beside phase 2's kernels
    timer = StepTimer()
    per, _ = timer.time_steps(lambda X: fused(X, dt0), T0, n_steps=20)
    mine = {r["kernel"]: r["ms"] for r in rows
            if r["shape"] == P2_SWEEP_SHAPE[0] and r["variant"] in
            ("stencil + lite x", "lite y", "lite z")}
    print(f"[phase 13] StepTimer {time_n}^3 f32 lite step: "
          f"{per * 1e3:.3f} ms/step (slope of 5 and 20 steps); phase 2's "
          f"K4 + K1 + K2 = {sum(mine.values()):.3f} ms {mine}", flush=True)
    out["step_timer_ms"] = per * 1e3
    torch.cuda.empty_cache()
    return out


def phase13_cyl(torch, dev, shape=None):
    """(b) The cylindrical varprop kernels tier's gradient against the
    reference tier's autograd at float64 on phase 8's tube."""
    from adi_thermal_fields_tpu_torch import RobinBC, adi_step_cyl_varprop

    label, shape8, _ = P8_SHAPES[0]
    grid, mat, mask, zbc, T0 = cylvp_case(torch, label, shape or shape8,
                                          torch.float64, dev)
    kt, ct = varprop_tables()
    kw = dict(dt=P8_DT, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
              robin_inner=RobinBC(50.0, 20.0), active=mask, h_void=80.0,
              T_inf_void=20.0, h_front=200.0, emissivity=EMISSIVITY)
    g = torch.Generator(device=dev).manual_seed(19)
    w = torch.rand(grid.shape, generator=g, device=dev,
                   dtype=torch.float64)

    def grads(impl, scheme, tables):
        T = T0.clone().requires_grad_(True)
        if tables:
            props, ins = dict(k_table=kt, cp_table=ct), (T,)
        else:
            k0 = torch.tensor(30.0, dtype=torch.float64, device=dev,
                              requires_grad=True)
            props = dict(k_table=lambda t: k0 + 0.01 * t,
                         cp_table=lambda t: 430.0 + 0.1 * t)
            ins = (T, k0)
        out = adi_step_cyl_varprop(T, grid, mat, scheme=scheme,
                                   implementation=impl, **props, **kw)
        return torch.autograd.grad((w * out).sum(), ins)

    from adi_thermal_fields_tpu_torch.solvers import launch_counts
    res = {}
    for scheme, tables, fwd in (("be", True, "K15 K16 K8"),
                                ("be", False, "K17 K18"),
                                ("douglas", False, "K17 K18")):
        name = (f"{label} f64 {scheme} "
                f"{'tables' if tables else 'k0 + 0.01 T'} ({fwd})")
        before = launch_counts()
        gk = grads("kernels", scheme, tables)
        delta = {k: v - before[k] for k, v in launch_counts().items() if
                 v - before[k]}
        gp = grads("reference", scheme, tables)
        print(f"[phase 13] {name}: launches of forward + backward {delta}",
              flush=True)
        check(delta.get("K21", 0) == 2 and delta.get("K22", 0) == 1,
              f"{name}: the backward's launches {delta}")
        res[name] = grad_gate(torch, f"{name} dL/dT", gk[0], gp[0])
        if not tables:
            grad_gate(torch, f"{name} dL/dk0", gk[1], gp[1])
        del gk, gp
        torch.cuda.empty_cache()
    return res


def phase13_apps(torch, dev, defaults=False):
    """(c) The inverse apps on the card: on the JAX tests' problems, or
    with ``defaults`` at their CLI defaults (``--inverse-defaults``)."""
    from adi_thermal_fields_tpu_torch.apps import (calibrate_params,
                                                   optimize_process)

    spread = (lambda v: max(v) - min(v))
    argv = P13_OPT_DEFAULT_ARGV if defaults else P13_OPT_ARGV
    t0 = time.perf_counter()
    r = optimize_process.main(argv + ["--device", str(dev)])
    s0, s1 = spread(r["t85_initial"]), spread(r["t85_final"])
    losses = (r["loss_initial"], r["loss_final"])
    print(f"[phase 13] optimize_process {' '.join(argv)}: loss "
          f"{losses[0]!r} -> {losses[1]!r}, t8/5 spread {s0:.4g} -> "
          f"{s1:.4g} s ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(all(math.isfinite(v) for v in r["history"] + list(losses)),
          f"optimize_process {argv}: a loss is not finite")
    if defaults:
        errs = [abs(a - b) / abs(b)
                for a, b in zip(losses, P13_OPT_DEFAULT_REF)]
        print(f"[phase 13] optimize_process at its defaults against the "
              f"plain CPU run {P13_OPT_DEFAULT_REF}: relative {errs} (tol "
              f"{P13_APP_RTOL:.0e})", flush=True)
        check(max(errs) <= P13_APP_RTOL,
              f"optimize_process: losses {losses} against the CPU run's "
              f"{P13_OPT_DEFAULT_REF}")
    else:
        check(losses[1] < losses[0] and s1 < s0,
              "optimize_process: the loss or the t8/5 spread did not fall")
    argv = P13_CAL_DEFAULT_ARGV if defaults else P13_CAL_ARGV
    t0 = time.perf_counter()
    r = calibrate_params.main(argv + ["--device", str(dev)])
    errs = {k: abs(r["fitted"][k] - r["truth"][k]) / r["truth"][k]
            for k in ("h", "k")}
    print(f"[phase 13] calibrate_params {' '.join(argv)}: "
          f"{r['fitted']} against "
          f"{r['truth']} (relative {errs}, tol {P13_FIT_RTOL:.0e}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    check(max(errs.values()) <= P13_FIT_RTOL,
          f"calibrate_params: relative errors {errs} > {P13_FIT_RTOL}")


def phase13_compare(torch, dev):
    """(d) compare_implementations, printed."""
    from adi_thermal_fields_tpu_torch.apps import compare_implementations

    for argv in (["--n", "256"], ["--case", "cyl_varprop", "--n", "128"]):
        r = compare_implementations.main(argv + ["--device", str(dev)])
        print(f"[phase 13] compare_implementations {' '.join(argv)}: "
              f"{r}", flush=True)


def phase13(torch, dev, rows=()):
    """Phase 13; returns its launch counts."""
    from adi_thermal_fields_tpu_torch.solvers import (launch_counts,
                                                      reset_launch_counts)

    reset_launch_counts()
    t0 = time.perf_counter()
    phase13_cartesian(torch, dev, rows=rows)
    phase13_cyl(torch, dev)
    counts = launch_counts()
    check(all(counts[k] > 0 for k in CONST_KERNELS + P13_BWD_KERNELS
              + ("K8", "K15", "K16", "K17", "K18")),
          f"phase 13's launches: {counts}")
    print(f"[phase 13] gradients: {time.perf_counter() - t0:.1f} s; "
          f"launches {({k: v for k, v in counts.items() if v})}",
          flush=True)
    t0 = time.perf_counter()
    phase13_apps(torch, dev)
    phase13_compare(torch, dev)
    print(f"[phase 13] inverse apps and compare_implementations: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def main():
    torch = load_port()
    if sys.argv[1:] == ["--profile"]:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase0(torch)
        phase1()
        profile_phase8(torch, dev)
        return
    if sys.argv[1:] == ["--phase13"]:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase0(torch)
        phase1()
        phase13(torch, dev)
        return
    if sys.argv[1:] == ["--inverse-defaults"]:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase0(torch)
        phase1()
        phase13_apps(torch, dev, defaults=True)
        return
    if sys.argv[1:] == ["--phase12"]:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        phase0(torch)
        phase1()
        p4 = app_phase(torch, dev, 4, [], impls=("kernels",))
        p12 = phase12_bar(torch, dev, p4)
        phase12_dwell(torch, dev)
        phase12_spiral(torch, dev)
        phase12_track(torch, dev)
        phase12_history_ms(torch, dev, p12["bar_mask"])
        return
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_last = [time.perf_counter()]

    def lap(label):
        """Print the seconds a stretch of the script took."""
        now = time.perf_counter()
        print(f"[time] {label}: {now - t_last[0]:.1f} s", flush=True)
        t_last[0] = now

    name, _ = phase0(torch)
    phase1()
    lap("phases 0-1 (the build)")
    rows = phase2(torch, dev) + phase2_varprop(torch, dev) \
        + phase2_cyl(torch, dev) + phase2_be(torch, dev) \
        + phase2_cylvp(torch, dev) + phase2_fields(torch, dev) \
        + phase2_gstreams(torch, dev) + phase2_bf16(torch, dev) \
        + phase2_vp_bf16(torch, dev) + phase2_remainder(torch, dev)
    lap("phase 2")

    from adi_thermal_fields_tpu_torch.solvers import (launch_counts,
                                                      reset_launch_counts)
    # each main path: counts set to 0 just before it, read just after it
    # (phase 2's comparison launches are excluded)
    reset_launch_counts()
    phase3(torch, dev)
    p4 = app_phase(torch, dev, 4, [])
    counts_c = launch_counts()
    lap("phases 3-4")
    reset_launch_counts()
    phase3_varprop(torch, dev)
    vp_flags = ["--latent_J_kg", str(LATENT), "--melt_k_factor", "4",
                "--emissivity", str(EMISSIVITY)]
    p5 = app_phase(torch, dev, 5, vp_flags, precision="float64",
                   impls=("kernels",))
    app_phase(torch, dev, 5, vp_flags, precision="float64",
              layer_s=SHORT_LAYER_S)
    p5_32 = app_phase(torch, dev, 5, vp_flags, impls=("kernels",))
    counts_v = launch_counts()
    lap("phases 3 (varprop) and 5")
    reset_launch_counts()
    phase6_step(torch, dev)
    p6 = spiral_app(torch, dev, 6)
    counts_y = launch_counts()
    lap("phase 6")
    reset_launch_counts()
    phase7_step(torch, dev)
    p7 = spiral_app(torch, dev, 7, ("--void_mode", "clamp"))
    counts_b = launch_counts()
    lap("phase 7")
    reset_launch_counts()
    phase8_step(torch, dev)
    p8, _ = phase8_app(torch, dev)
    counts_8 = launch_counts()
    lap("phase 8")
    reset_launch_counts()
    phase9_step(torch, dev)
    phase9_app(torch, dev)
    counts_9 = launch_counts()
    lap("phase 9")
    reset_launch_counts()
    phase10_step(torch, dev)
    p10 = phase10_app(torch, dev, p4, p5_32)
    counts_10 = launch_counts()
    lap("phase 10")
    reset_launch_counts()
    phase11_step(torch, dev, p5_32,
                 p10["float32 varprop without latent heat"], p5)
    counts_11 = launch_counts()
    lap("phase 11")
    reset_launch_counts()
    p12 = phase12_bar(torch, dev, p4)
    phase12_dwell(torch, dev)
    phase12_spiral(torch, dev)
    counts_12 = launch_counts()
    for k, v in phase12_track(torch, dev).items():
        counts_12[k] += v
    phase12_history_ms(torch, dev, p12["bar_mask"])
    lap("phase 12")
    phase13(torch, dev, rows)
    lap("phase 13")
    d32 = float((p5_32["T_kernels"].double() - p5["T_kernels"]).abs().max())
    print(f"[phase 5] max|T_float32 - T_float64| (kernels) = {d32:.3e} K",
          flush=True)
    for path, counts_p, mine in (("constant-property", counts_c,
                                  CONST_KERNELS),
                                 ("variable-property", counts_v, VP_KERNELS),
                                 ("cylindrical", counts_y, CYL_KERNELS),
                                 ("unmasked cylindrical", counts_b,
                                  BE_KERNELS),
                                 ("cylindrical varprop", counts_8,
                                  CYL_VP_KERNELS)):
        check(all(counts_p[k] > 0 if k in mine else counts_p[k] == 0
                  for k in KERNEL_INFO),
              f"the {path} path's launches: {counts_p}")
    check(all(counts_9[k] > 0 if k in GENERAL_KERNELS else
              k in P9_ALSO or counts_9[k] == 0 for k in KERNEL_INFO),
          f"the general-BC path's launches: {counts_9}")
    check(all(counts_10[k] > 0 if k in BF16_KERNELS else
              k in P10_ALSO or counts_10[k] == 0 for k in KERNEL_INFO),
          f"the bfloat16 path's launches: {counts_10}")
    check(all(counts_11[k] > 0 if k in REMAINDER_KERNELS else
              k in P11_ALSO or counts_11[k] == 0 for k in KERNEL_INFO),
          f"the v1 sweeps' and tier-2 y path's launches: {counts_11}")
    check(all(counts_12[k] > 0 if k in P12_KERNELS else counts_12[k] == 0
              for k in KERNEL_INFO),
          f"the apps' outputs and single-track path's launches: "
          f"{counts_12}")
    print("[phase 12] launches of its prints: "
          + ", ".join(f"{k} {counts_12[k]}" for k in P12_KERNELS),
          flush=True)
    d45 = float((p5_32["T_kernels"] - p4["T_kernels"]).abs().max())
    print(f"[phase 5] max|T_varprop - T_constant| = {d45:.3e} K", flush=True)
    check(d45 > 1.0, "the varprop flags changed the app's field by "
          f"{d45:.3e} K <= 1 K: they do not reach the step")
    d67 = float((p7["T_kernels"] - p6["T_kernels"]).abs().max())
    print(f"[phase 7] max|T_clamp - T_robin| (kernels) = {d67:.3e} K",
          flush=True)
    check(d67 > 1.0, "--void_mode clamp changed the spiral app's field by "
          f"{d67:.3e} K <= 1 K: the flag does not reach the step")
    d86 = float((p8["T_kernels"] - p6["T_kernels"]).abs().max())
    print(f"[phase 8] max|T_varprop - T_robin| (kernels, float32) = "
          f"{d86:.3e} K", flush=True)
    check(d86 > 1.0, "the varprop flags changed the spiral app's field by "
          f"{d86:.3e} K <= 1 K: they do not reach the step")
    counts = {**{k: counts_c[k] for k in CONST_KERNELS},
              **{k: counts_v[k] for k in VP_KERNELS},
              **{k: counts_y[k] for k in CYL_KERNELS},
              **{k: counts_b[k] for k in BE_KERNELS},
              **{k: counts_8[k] for k in CYL_VP_KERNELS},
              **{k: counts_9[k] for k in GENERAL_KERNELS},
              **{k: counts_10[k] for k in BF16_KERNELS},
              **{k: counts_11[k] for k in REMAINDER_KERNELS}}
    counts["K8"] = counts_v["K8"] + counts_8["K8"]
    counts["K19"] = counts_v["K19"] + counts_9["K19"]

    main_variant = {"K1": "lite y", "K2": "lite z", "K3": "stencil",
                    "K4": "stencil + lite x", "K5": "fields + rad",
                    "K6": "theta + x, h stream", "K7": "y, h stream",
                    "K8": "z, rad", "K9": "r", "K10": "z",
                    "K11": "phi (cyclic)", "K12": "r", "K13": "z",
                    "K14": "phi (cyclic)", "K13t": "table", "K14t": "table",
                    "K15": "r",
                    "K16": "phi (cyclic)",
                    "K17": "r", "K18": "phi (cyclic)", "K7x": "x, h stream",
                    "K19": "z, h stream", "K20": "rhs", "K21": "x",
                    "K22": "phi (axis 1, cyclic)", "K23": "fields, rad",
                    "K24": "theta + x, seeded", "K25": "y, seeded",
                    "K26": "z, seeded", "K1b": "lite y, seeded",
                    "K2b": "lite z, seeded", "K3b": "stencil, seeded",
                    "K4b": "stencil + lite x, seeded",
                    "K5b": "fields + rad", "K20b": "rhs, seeded",
                    "K6b": "theta + x, h stream, seeded",
                    "K7xb": "x, h stream, seeded",
                    "K7b": "y, h stream, seeded",
                    "K19b": "z, h stream, seeded",
                    "K1v1": "x, pinned, no dir_val", "K15y": "y, rad"}
    summary = []
    for k, (fn, src, replaces) in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == k]
        shape = (CYL_SHAPES[0][0] if k in CYL_KERNELS else P7_SHAPES[0][0]
                 if k in BE_KERNELS else f"{P8_SHAPES[0][0]} float32"
                 if k in ("K15", "K16", "K17", "K18") else
                 f"{P9_SHAPES[0][0]} float32" if k in GENERAL_KERNELS
                 else f"{P10_SHAPES[0][0]} bfloat16"
                 if k in GSTREAM_KERNELS + VP_BF16_KERNELS
                 else f"{P2_SHAPES[0][0]} bfloat16" if k in BF16_KERNELS
                 else f"{P2_SHAPES[0][0]} f32" if k == "K1v1"
                 else f"{P11_Y_SHAPES[1][0]} f32" if k == "K15y"
                 else P2_SWEEP_SHAPE[0]
                 if k in CONST_KERNELS + ("K6", "K7", "K8")
                 else P2_SHAPES[0][0])
        ref = next(r for r in mine if r["variant"] == main_variant[k]
                   and r["shape"] == shape)
        # K1-K11, K13t, K14t, K15-K26 and their entries: no PyTorch call
        # computes these masked, variable-coefficient or field-coefficient
        # (cyclic) tridiagonal solves, stencils or table passes:
        # library_ms is null
        summary.append({"name": f"{k} {fn}", "route": "cuda",
                        "source": f"{PKG}/{src}", "replaces": replaces,
                        "launches": counts[k],
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": ref["ms"], "plain_ms": ref["plain_ms"],
                        "bound_ms": ref["bound_ms"],
                        "bound_by": ref["bound_by"],
                        "library_ms": ref.get("library_ms")})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
