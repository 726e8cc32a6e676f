#!/usr/bin/env python3
"""Smoke test of swnerf_torch on one NVIDIA card: build the CUDA kernels,
hold each against its plain PyTorch twin, render test views of the trained
vanilla NeRF, T-NeRF and D-NeRF and resume their training through the real
CLIs, train a MultiRes D-NeRF from scratch through its CLI, drive the
fields' kernel routes (the eager steps, renders with no eval pass), extract
meshes from the trained vanilla NeRF and solve their metric scale, render
and train MultiRes on the render kernels, run the resample merge and the
deformation MLP's input cotangents, time the kernels, hold K training
steps per dispatch (CUDA-graph replays) to one step a dispatch, and run the
forward-facing LLFF path (NDC rays, the ray pool, the spiral) at fern's
shape and on the LLFF quality recipe, export the renderers as torch.export
programs (the fused ones calling the kernels as ops), load a fern-sized
JPEG capture and find ArUco markers in JPEG twins, and run the 2-D
encoding study.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from swnerf_torch/csrc (nvcc, sm_90a); the
     tensor-core kernels' and the SIMT train-mode forwards' (mm_ring)
     registers and spill bytes from build.log (a spill fails);
  3. B2 sample_pdf vs its twin at N=160,000, M=63, S=128: bit-exact
     (torch.equal); its time through the wrapper and queued behind a sleep
     (the device alone) per frame, per 32,768-ray chunk and per training
     step (1,024 / 500 rays), and the wrapper's host microseconds a call;
  4. B3 render_pass vs its twin with the 010000.tar weights (D=8, W=256) on
     4,096 rays of test view 0, S=64 and S=192: fp32 atol 1e-4 (rgb, acc),
     rtol 1e-4 (depth); bf16 max |drgb| <= 1e-2, mean <= 1e-3;
  5. the main path: ``run_nerf --render_only --render_test --testskip 5``
     on benchmarks/full_scale (5 test frames, 400x400, 64+128 samples,
     bf16 kernels), launch counts, PSNR/SSIM, and frame 0 re-rendered by the
     plain twins in fp32 (|dPSNR| <= 0.1 dB);
  6. each kernel against its twin again at the main path's chunk shape
     (32,768 rays, bf16), its time there beside its bound and a per-stage
     breakdown of one frame; B3's composite and heads' shares of its blocks'
     clock cycles (csrc/tc_chunk.cuh::g_prof);
  7. B1 render_loss vs its twin with the 010000.tar weights on 1024 seeded
     pixels of train view r_0 (coarse S=64 jittered, fine S=192 from a B2
     pass), noise std 1: fp32 rgb/acc within 1e-4, depth and sqerr rtol
     1e-4 (atol 1e-5 / 1e-7), gradients rel L2 1e-4 (or, on ReLU ties, no
     further from the float64 twin than twice the fp32 twin, PERF.md); bf16
     rgb max 1e-2 / mean 1e-3, gradients rel L2 1e-2; bit-equal repeats;
     bf16 B1's time beside its bound, its device time by kernel family
     (the SIMT forward, the reverse sweep's tensor-core products, the split
     reductions, the SIMT heads; torch.profiler) and the sweep's large
     products as bf16 torch.matmul calls (cuBLAS, summed: the yardstick);
  8. the kernel train step vs the eager autograd step from the same state
     and draws: fp32 loss rel 1e-5, gradients as in 7 (float64 eager step as
     the reference); bf16 loss rel 1e-2;
  9. the training main path: ``run_nerf`` resumed from 010000.tar for 200
     full-width bf16 steps (train PSNR >= 30 dB at every print, checkpoints
     010100/010200 with Adam step 10200, B1 and B2 launch counts), ms per
     step, rays/s, samples/s and a per-stage breakdown of one step, B1's
     stages beside their bounds;
 10. test frame 0 rendered from 010200.tar through the serving path:
     >= 30 dB and within 0.5 dB of phase 5's frame 0;
 11. the T-NeRF scene: the dynamic 400x400 textured Blender scene the
     round-5 800000.tar was trained on (seed 0, 100/5/25 views, 128 GT
     samples), written by the port's writer on the card;
 12. B4 against its twin with the 800000.tar weights (D=8, W=128): forward
     on 4,096 rays of test view 0 at its frame time, S=64 (fp32 rgb/acc atol
     1e-4, depth rtol 1e-4; bf16, on the tensor cores, max |drgb| <= 1e-2,
     mean <= 1e-3); train mode on 500 seeded pixels of a train view, noise
     std 1 (fp32 sqerr rtol 1e-4, gradients rel L2 1e-4 with the float64
     fallback of phase 7 on mask ties; bf16, its reverse sweep on the tensor
     cores, gradients rel L2 1e-2; bit-equal repeats); B4's times at the main
     paths' shapes, the train launch's device time by kernel family (its SIMT
     forward, the sweep's tensor-core products, ...) and the sweep's large
     products as bf16 torch.matmul calls (as phase 7); the forward beside
     B3 on a seeded vanilla field of the same width, depth and rows (ReLU,
     no time columns) and its composite and heads' shares of the cycles;
 13. the kernel T-NeRF step against the eager step, same state and draws:
     fp32 loss rel 1e-5, gradients as in 12; bf16 loss rel 1e-2;
 14. the T-NeRF serving main path: ``run_tnerf --render_only --render_test``
     from a copy of 800000.tar (25 frames, 400x400, 64 samples, bf16 B4):
     ms per frame, PSNR/SSIM (mean >= 20.5 dB on the reference evaluator's
     scale, see unit_range_psnr), frame 0 by the fp32 twin within 0.1 dB,
     the B4 launch count, a per-stage breakdown of a frame;
 15. the T-NeRF training main path: ``run_tnerf`` resumed from that copy for
     1,000 bf16 steps (train PSNR >= 19 dB at every print, 800500.tar and
     801000.tar with their Adam steps, 1,000 B4 train launches), ms per
     step, rays/s, samples/s and a per-stage breakdown of a step;
 16. test frame 0 from 801000.tar through the serving path: >= 20 dB (the
     reference evaluator's scale) and within 0.5 dB of phase 14's frame 0;
 17. B6 (the D-NeRF deformation MLP, forward and backward) against its twin
     with the round-5 D-NeRF 800000.tar weights on the coarse (S=64) and
     fine (S=192) points of 500 seeded pixels of a train view of phase 11's
     scene: fp32 dx atol 1e-5, gradients rel L2 1e-4 (the float64 fallback
     of phase 7, which also admits the distance a perturbation of fp32 size
     moves the float64 twin: the ReLUs tie, check_fp32_grads); bf16 dx
     max 1e-2, gradients rel L2 1e-2; bit-equal repeats; B6's backward at
     the TV pair's rows beside its bound, by kernel family and against its
     sweep's products on cuBLAS (as phase 7);
 18. B3's pts mode and B5 against their twins on pts + dx of those rays,
     noise std 1: outputs as in phase 7, gradients and dpts as in phase 17,
     bf16 1e-2, bit-equal repeats; then B6 and B3's pts mode against their
     twins at the serving path's chunk shape (32,768 rays), and the times;
     B6's head share and B3's composite share there (as in phase 6); B5's
     S=192 launch (its reverse sweep and demb on the tensor cores) by kernel
     family and against its sweep's products on cuBLAS (as phase 7); B5's
     bf16 forward (rgb, acc, depth, weights) bit-equal to B3's ordered pts
     launch at S=64 and 192, and its SIMT forward's ms against its SIMT
     bound (the fp32 FMA rate at the max SM clock nvidia-smi reports);
 19. the kernel D-NeRF step against the eager step from the same state and
     draws (TV on): fp32 loss rel 1e-5 (or phase 17's fallback), gradients as
     in phase 17 (the float64 eager step on the CPU as the reference); bf16
     loss rel 1e-2;
 20. the D-NeRF serving main path: ``run_dnerf --render_only --render_test
     --testskip 5`` from a copy of 800000.tar (test frames 0/5/10/15/20,
     400x400, 64 + 128 samples, bf16): ms per frame, rays/s, samples/s, the
     B6/B3/B2 launch counts; each frame, rendered again at the reference
     evaluator's 32 + 32 samples, within 0.5 dB of the reference's
     per-frame PSNR on its scale, and at 64 + 128 no more than 0.5 dB
     below it; frame 5 by the fp32 twins within 0.1 dB; a per-stage
     breakdown of a frame;
 21. the D-NeRF training main path: ``run_dnerf`` resumed from that copy for
     200 bf16 steps with the config's flags (train PSNR >= 34 dB at every
     print, 800100.tar and 800200.tar with Adam step 800200, the B5 and B6
     launch counts), ms per step, rays/s, samples/s, a per-stage breakdown
     (the backward's stage beside B6's backward bound);
 22. test frame 5 from 800200.tar through the serving path, within 0.5 dB
     of phase 20's;
 23. MultiRes: B7 (the field trunk on embedded inputs, forward and backward
     with the position embedding's cotangent) and the widened B6 against
     their twins at the per-level widths of configs/multires/lego.txt (D=8,
     W=256; (20, 8, 20), (10, 4, 10), identity; seeded weights) on 500
     seeded pixels of a train view of phase 11's scene, 64 jittered samples:
     fp32 raw atol 1e-4 / rtol 1e-4 and dx atol 1e-5, gradients (and demb)
     at phase 17's bar; bf16 raw within 1e-2 of its largest value, dx 1e-2,
     gradients rel L2 1e-2; bit-equal repeats; the forward-only launches
     (the test render's) at the same bars and bit-equal to the train-mode
     ones, but for B7's in bf16 (the tensor cores): at the bf16 raw bar and
     bit-equal to a repeat; B7's bf16 backward (with demb) runs its sweep on
     the tensor cores; the last 500 rays of the test render's 2.1M-row
     chunk against the twins at the bf16 bars; then their times at each
     level's rows, B6's and B7's backward at level 0 as in phase 17; B7's
     bf16 train-mode raw at level 0 bit-equal to trunk_ordered at 32,000
     and 65,536 rows, its SIMT forward against its SIMT bound (phase 18);
 24. one phase-1 step (level 0) and one phase-2 step (all four levels) on
     the kernel route against the plain route, same weights and draws: fp32
     loss rel 1e-5, gradients at phase 17's bar; bf16 loss rel 2e-2;
 25. the MultiRes main path: ``run_multires --config configs/multires/lego.txt``
     on phase 11's scene (200x200 after half_res) from scratch with
     --raw_noise_std 1 (live densities), 100 phase-1 steps per level and
     100 phase-2 steps with the global term from iteration 100 on, the test
     set reconstructed at 200: each level's phase-1 loss falls from its
     first print to its last, the phase-2 loss moves, the global PSNR is
     finite, 000100.tar and 000200.tar carry the per-level keys, B6 and B7
     launched; ms per phase-1 step (per level), per phase-2 step and per
     reconstructed test frame; test frames 0/5/10/15/20 from 000200.tar
     reconstructed by the bf16 kernels within 0.1 dB (mean PSNR) of the fp32
     plain route, and not equal to it; a digest of 000200.tar (every tensor's
     bytes, the keys in order: two runs on one card print the same one), and
     the pyramid reconstruction's backward at phase 2's patch sizes bit-equal
     across two launches (F.interpolate's own, atomic backward: whether its
     two launches differ, printed); B7's bf16 train-mode raw on 000200.tar's
     level-0 field at 65,536 rows bit-equal to trunk_ordered;
 26. B7' (the ELU T-NeRF trunk on embedded inputs) against its twin with the
     800000.tar weights on one eager step's rows (500 seeded pixels of a
     train view x 64 jittered samples = 32,000 rows): fp32 raw within 1e-5
     of its largest value, the gradients and the embeddings' cotangents at
     phase 17's bar, the forward-only launch bit-equal to the train-mode
     one; bf16 (on the tensor cores: its forward-only launch, its
     train-mode forward at the config's W=128, its backward's products)
     raw within 1e-2 of its largest value, gradients rel L2
     1e-2, bit-equal repeats, the forward-only launch bit-equal to a
     repeat; the serving chunk's last 32,000 rows at the bf16 bar; times at
     32,000 rows (train-mode forward, backward) and at the 2.1M-row chunk
     (forward only), each with its share of the bound and its large
     products on cuBLAS;
 27. B8 (the trunk with the encode in the kernel) against its twin with
     010000.tar's fine weights on 1024 rays x 192 jittered samples, the
     same bars (its bf16 forward-only launch, on the tensor cores, at the
     bf16 raw bar and bit-equal to a repeat), d pts and d viewdirs at the
     fp32 bar; times at 32,000 rows (its SIMT train-mode forward against
     its SIMT bound, as phase 18); the forward-only launch at one mesh
     tile (2,048 points x 100 views = 204,800 rows) within 1e-2 of the
     twin's largest raw, and its time;
 28. the fields' kernel routes through the CLIs: run_nerf resumed from
     010000.tar for 200 eager steps (SWNERF_FUSED_STEP=0: B7), then again
     under SWNERF_FUSED_RAW=1 (B8), >= 30 dB at every print; test frame 0
     through the fields (SWNERF_FUSED_EVAL=0) within 0.1 dB of phase 5's
     B3 frame; run_tnerf resumed from 800000.tar for 200 eager steps (B7'),
     >= 19 dB at every print and no B4 launch; run_tnerf --render_only
     --testskip 5 through B4 and through B7' (SWNERF_FUSED_EVAL=0), mean
     PSNRs within 0.1 dB; the B7' frame's ms and the eager T-NeRF step's
     median beside B4's (its eval pass, phase 15's kernel step); run_dnerf
     for 10 steps under SWNERF_FUSED=0: the fp32 plain route, no field
     kernel launched;
 29. the SW mesh chain at the drill recipe: extract_mesh on 010000.tar,
     128^3 points x 100 views over [-2, 2]^3, threshold 25, through B7
     (bf16, the default), B8 (SWNERF_FUSED_RAW=1) and the plain fp32 route
     (SWNERF_FUSED=0): each kernel mesh's vertex and face counts within 2%
     of the plain mesh's, bounding boxes within one voxel (4/127), the
     symmetric mean nearest-vertex distance under 0.25 voxel; ms for the
     sweep and for marching + OBJ write, 1,024 launches per kernel sweep;
     B7's time at the sweep's tile; the B7 sweep's device ms split per tile
     with CUDA events (encode, weight packing, embedding copy, B7, rest);
 30. the metric-scale solve without cv2: a 0.5-unit square marker
     projected into the capture's train poses, calculate_3d_corners ->
     marker_edge_lengths -> scale -> alignment_matrix -> transform_mesh on
     the B7 mesh: the scale real_length / 0.5 within 1e-4 relative, the
     marker normal onto +z within 1e-6;
 31. B3's pts mode at the MultiRes widths (levels 0-2: 123 / 123 and 63 / 63
     columns on 128-row pads) and B9 (the external-cotangent backward of the
     fused phase 2; levels 0-2 wide, the identity level narrow) against
     their twins with 000200.tar's per-level weights on 1,024 seeded pixels
     x 64 jittered samples of train view 37, noise std 1, seeded non-zero
     cotangents of rgb, acc and depth: fp32 outputs at phase 18's bars,
     gradients and d pts at phase 17's; bf16 outputs within 1e-2, gradients
     rel L2 1e-2; bit-equal repeats; B9's recomputed forward bit-equal to
     the B3 launch; B3 wide at the test render's 32,768-ray chunk (level 0,
     000200.tar's and seeded weights, whose rgb does not saturate) at the
     same bars (bf16 depth atol and rtol 1e-2); times there and at phase 2's level-0
     rows (1,024 x 64); B9's gradients on seeded level-0 weights beside the
     bf16 twin's own distance from itself summed on the CPU (printed); B9
     wide at level 0 and narrow at the identity level (phase 2's 16 x 64
     rows and 1,024 x 64) by kernel family and against its sweep's products
     on cuBLAS (as phase 7), B9 wide's SIMT forward against its SIMT bound
     (as phase 18);
 32. the MultiRes test render of 000200.tar through render_testset on test
     frames 0/5/10/15/20: levels 0-2 through the D-NeRF eval pass, level 3
     through its fields, against SWNERF_FUSED_EVAL=0 (every level through
     its fields): each of levels 0-2's frames within max 1e-2, mean 1e-3,
     mean PSNR of the reconstructions within 0.1 dB, 20 B3-wide launches,
     ms per reconstructed frame on both routes;
 33. the fused phase 2: one step over the four levels with fused=True
     against the field-route step, same weights (phase 24's seeded ones:
     000200.tar's saturated levels give noise gradients) and draws: fp32
     loss rel 1e-5, gradients at phase 17's bar; bf16 loss rel 2e-2; then
     run_multires resumed from 000200.tar for 100 phase-2 steps under
     SWNERF_FUSED_MULTIRES=1 and under the default: the loss moves, the
     global PSNR is finite, B9 once per level per step; in 000300.tar every
     level's weights moved, its Adam first moment is more than 10 times what
     stale momentum alone leaves, and the two routes' moves are within
     2-fold at each level whose fp32 routes agree within 0.1 (rel L2) on
     000200.tar's weights (at least one does); ms per phase-2 step on both
     routes and their idle shares (torch.profiler);
 34. B10 at phase 3's shape on 010000.tar's coarse weights: bit-equal to
     B2 + torch.sort for linspace and sorted random uniforms, the twin
     bit-equal, B2's unsorted rows counted; run_nerf --render_only under
     SWNERF_PDF_MERGE=1 with phase 5's PSNRs exactly; 50 vanilla and 50
     D-NeRF kernel steps under the switch at phases 9 / 21's floors; B10's
     time beside B2 + torch.sort, and queued behind a sleep (the device
     alone, without the host's time to issue each launch);
 35. B11 (fused_time_net_pts with input cotangents) against its twin with
     the D-NeRF 800000.tar deformation weights on phase 17's points and at
     MultiRes level 0's widths: dx bit-equal to B6's forward, fp32
     gradients, d pts and d times at phase 17's bar, bf16 (its products
     and demb on the tensor cores, at the 96- and 144-column pads) rel L2
     1e-2;
     times; then the [tc] lines: each bf16 tensor-core launch's TFLOP/s and
     share of its bound (B3, B6, B7 and B8 at the mesh tile, B7 at the
     MultiRes test chunk), B3's composite and the heads' shares of the
     blocks' cycles, the vanilla and D-NeRF ms per frame, the mesh sweep;
 36. K steps per dispatch: run_nerf, run_tnerf and run_dnerf each resumed
     twice from their checkpoints for 60 steps (print 20, save 60), at
     SWNERF_STEPS_PER_DISPATCH=1 and at 20 (CUDA-graph replays): the saved
     parameters, Adam's moments and counts, metrics.jsonl's values at every
     print, the checkpoint iterations and the launch counts bit-equal, one
     capture at K = 20 (its pool's size printed) and none at K = 1; both
     runs' median ms per step, and the kernel step's host microseconds a
     step, ms a step and idle share over 20 steps (torch.profiler); then
     run_nerf from scratch for 30 steps under
     SWNERF_FUSED_DTYPE_SCHEDULE=f32@10: no B1 launch in steps 1-10 (B7's
     fp32 launches there), B1 twice in every later step, finite losses, a
     graph for each step;
 37. the fern shape: write_llff_scene(n_images=20, size=504, n_samples=192,
     scene="textured") on the card, then configs/nerf/fern.txt (its paths
     and --factor 1 aside) through run_nerf from scratch for 1,000 steps at
     K = 20 (NDC rays inside the captured pool step): the loss at the last
     print below the first's, B1 at S = 64 and 128 and B2 once a step, ms
     per step, host us per step and the idle share; K = 20 against K = 1
     over 40 steps, bit-equal; --render_only --render_test from
     001000.tar over the 3 holdout views (B3, B2, B3 once per 32,768-ray
     chunk): ms per frame, PSNR at data_range 1 within 0.1 dB (mean) of the
     fp32 plain route's, a per-stage breakdown; the 120-view spiral at
     --render_factor 4 (120 PNG frames); 20 steps under SWNERF_PDF_MERGE=1
     (B10, no B2);
 38. B1, B3, B2 and B10 against their twins at the NDC shapes, with
     001000.tar's weights: B1 on 1,024 seeded pixels of a train view at S =
     64 and 128 (phase 7's bars, no background), B3 at S = 64 and 128 on
     every chunk of a 254,016-ray holdout frame (phase 4's bars; fp32 on
     the first chunk), B2 at 63 bins -> 64 samples bit-equal to its twin,
     B10 at Mz = 64, S = 64 bit-equal to B2 + torch.sort and to its twin;
     their times beside their bounds;
 39. the LLFF quality recipe (PARITY_TORCH.md, round 4): the port's
     write_llff_scene(n_images=24, size=64, scene="textured"), run_nerf
     from scratch on benchmarks/parity_vs_torch.py's llff flags for 5,000
     steps (seed 0, K = 20), --render_only --render_test of views 0, 8 and
     16: mean test PSNR at data_range 1 >= 28.0 dB, the fp32 plain route
     within 0.1 dB; ms per step;
 40. what the trainers save, log and check, at the flagship shape (the
     config of phase 9: D=8, W=256, 1,024 rays x (64 + 64+128), bf16
     kernels, K = 20, resumed from a copy of 010000.tar): run_nerf for 40
     steps with SWNERF_CKPT_FORMAT=both, --i_weights 20, SWNERF_DEBUG_NANS=1
     and SWNERF_PROFILE_DIR, bit-equal (parameters, Adam, metrics.jsonl) to
     the same 40 steps with the switches off; the .tar and the .msgpack of
     steps 20 and 40 bit-equal; the Chrome trace names B1's and B2's
     kernels; 20 more steps resumed from the .msgpack alone bit-equal to
     the resume from the .tar (the profiler on in one, its cost a step
     from the two); a NaN planted in one weight of the snapshot raises
     FloatingPointError in the first chunk; --render_only --render_test
     (every run of the phase loads the test split at --testskip 5) with
     SWNERF_LPIPS_DIR on seeded weights in the torchvision / lpips
     layouts: LPIPS within 1e-4 of the same frames scored on the CPU; eval_dirs on that directory against its ground
     truth; the spiral through write_video (a GIF without cv2); the native
     snapshot's save and load ms, LPIPS's ms a frame; one
     --do_half_precision D-NeRF step on the plain route (SWNERF_FUSED=0)
     and the plain field held to a float64 reference with bf16-rounded
     matmul inputs;
 41. export: export_model run as a user runs it, five processes together:
     010000.tar plain (--export_platforms cpu,cuda) and fused (B7), fused
     under SWNERF_FUSED_RAW=1 (B8), and the round-5 T-NeRF (B7') and
     D-NeRF (B6, B7) 800000.tar fused, at 32,768 rays, and beside them a
     plain artifact at 256 rays (cpu,cuda) exported in this process; every
     artifact with a fine pass calls B2 as swnerf::sample_pdf; test frame 0 in 5 tiles (the last padded from the frame's
     first rays) through the fused artifact bit-equal (NaN where NaN) to
     the eager kernel route and within 0.1 dB of the plain artifact; the
     raw-route artifact's tile bit-equal to the eager raw route; the
     256-ray cpu,cuda artifact on the card and on the CPU within 1e-4; a
     T-NeRF and a D-NeRF tile bit-equal to their eager routes; each
     export's process wall and bytes, the frames' ms (host clock), the
     swnerf:: launches (added to the forward-only entries of B7, B8, B7'
     and B6, and to B2's);
 42. a 20-view 4032 x 3024 JPEG LLFF capture (cv2.imencode, quality 95)
     through load_llff_data at factor 8, the minify included, timed; its
     images_8/ PNG cache of two views equal to area_resize of the decoded
     JPEG; a 0.5-unit DICT_4X4_1000 marker warped into 13 of phase 30's
     poses as 1600 x 1600 JPEG images_ori twins through cal_scale (the
     port's detect_marker_corners): the scale within 2%
     (tests/test_mesh_pipeline.py:297); a cv2 without aruco fails;
 43. pos2d on a 256 x 256 JPEG for 3 epochs on the card: the PSNR rises,
     the .npz and the metrics.csv row are written; s per epoch;
 44. data parallelism, one rank over NCCL: run_nerf resumed from 010000.tar
     for 80 bf16 steps at K = 20 in two processes (no group, then a
     one-rank NCCL world through SWNERF_COORDINATOR): the checkpoint,
     metrics.jsonl, the last metrics and the launch counts bit-equal to
     the first run's; the NCCL run calls all_reduce twice, the
     uncaptured warm-up step and once inside the capture (the replays run
     it from the graph), the runs with no group never; the NCCL kernels the
     device ran in the replays under torch.profiler (an in-place sum over
     one rank launches none); ms per step (CUDA events), host us per step
     and idle share, as phase 36 measures them (saves at 10020 and 10080,
     outside the windows);
 45. data parallelism, two gloo ranks sharing the card (each brings its
     own group through a file store, then calls the trainers' CLIs at
     K = 1): the fp32 kernel step at full width on 1,024 rays split 512 +
     512 against one process on the global batch (loss rel 1e-5, gradients
     rel L2 1e-4); 20 bf16 vanilla steps (train PSNR >= 30 dB, the ranks'
     parameters bit-identical, rank 1 writes no file); --render_only of
     test frame 0 bit-equal to phase 5's; 5 steps each of T-NeRF (B4) and
     D-NeRF (B6, B3's pts mode, B5, B2), and one MultiRes fused phase-2
     step with the global term from the replicated start (B6, B3's pts
     mode, B9; each level's patch split by rows and assembled for the
     reconstruction), each checkpoint within rtol 1e-5, atol 1e-6 of one
     process's (MultiRes: its moments; its weights, one Adam update from
     the shared start, are lr * g / (|g| + eps), which any summation order
     moves by up to lr where |g| is near eps: printed, not held); every
     run's kernels counted. Then, in the same two ranks, tensor
     parallelism on a (rays 1, model 2) grid (SWNERF_TENSOR_PARALLEL=2,
     K = 1): the fp32 eager step (the plain fields, B2) at full width on
     512 rays against one process (loss rel 1e-5; the gathered
     gradients at check_fp32_grads's bar: the row layers' partial sums
     are another summation order, which can flip a ReLU mask), B2
     counted; run_nerf resumed from 010000.tar and at W=512 from scratch,
     T-NeRF and D-NeRF from their 800000.tar, 2 steps each (128 rays a
     step but for T-NeRF's 500: gloo carries each row layer's activations
     through host memory, ~0.5 GB/s between two ranks here) on the fp32
     plain route (SWNERF_FUSED=0 here and in the one-process references),
     each gathered checkpoint against one process's (W=512, one step from
     scratch: its first moments, rel L2 1e-3, decide); MultiRes's joint
     step with every level cut, called directly on phase 33's inputs: in
     float64 each level's gathered gradients within rel L2 1e-8 of one
     process's, in fp32 within rel L2 1e-5 of a control, one process
     summing each cut layer's products as the grid does (level 0 encodes
     positions at 2^19 frequencies, so any other fp32 order parts it by
     ~1e-1): either fails on a wrong gradient of any level; MultiRes's CLI
     one joint step, every tensor of its checkpoint within rel L2 1e-5 of
     the control's CLI run, the JAX test's bars too (weights atol 6e-3, the
     loss rel 2e-2); in every run the
     replicated parameters bit-identical across
     the two ranks and the bytes of parameters + Adam a rank holds equal
     to the assignment's; --render_only of test frame 0 over the two ranks
     (the loaded fields: a render cuts nothing; vanilla B3, T-NeRF B4,
     D-NeRF B6 and B3's pts mode) and the vanilla frame from fields cut and
     gathered (render_fields, the trainers' test renders), each bit-equal
     to one process's; then the JSON lines.

The training phases (9, 15, 21, 28, 34, 37, 39, 40) run at the card's default of 20
steps a dispatch: their launch counts are the graphs' replays' (each
replay adds what its capture recorded).

Exits non-zero without a CUDA device, and when the package is missing.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FULL = ROOT / "benchmarks" / "full_scale"
CONFIG = FULL / "full_nerf_200k.txt"
DATADIR = FULL / "data_nerf_400"
CKPT = FULL / "logs" / "full_nerf_200k" / "010000.tar"
TNERF_DIR = ROOT / "benchmarks" / "round5_artifacts" / "full_tnerf_800k"
TNERF_CONFIG = TNERF_DIR / "config.txt"
TNERF_CKPT = TNERF_DIR / "800000.tar"
TNERF_SIZE = 400  # the frame size of the scene 800000.tar was trained on
DNERF_DIR = ROOT / "benchmarks" / "round5_artifacts" / "full_dnerf_800k"
DNERF_CONFIG = DNERF_DIR / "config.txt"
DNERF_CKPT = DNERF_DIR / "800000.tar"  # trained on the same scene as the T-NeRF one
DNERF_RESULT = ROOT / "benchmarks" / "round5_artifacts" / "result_full_dnerf_800k.json"
DNERF_FRAMES = (0, 5, 10, 15, 20)  # the test frames --testskip 5 keeps

# H100 SXM data sheet, dense: HBM bandwidth and peak rates by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """As cuda_ms, with the launches queued behind a ~0.1 s sleep kernel: the
    device's time for ``fn()`` alone, without the host's time to issue it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per ``fn()``: the wall time to issue ``reps`` calls,
    with no synchronize inside the loop, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def b2_times(dev, bins, weights, g) -> None:
    """B2's time through the wrapper and queued behind a sleep (the device
    alone) at phase 3's 160,000-ray frame and a 32,768-ray chunk of it
    (linspace u, as serving draws it), and at the training steps' 1,024 and
    500 rays (random u, as a step draws it); the wrapper's host microseconds
    a call at 1,024 rays, and the same with the launcher's ctypes signature
    set on every call, as the wrapper once did."""
    import ctypes

    import torch

    from swnerf_torch.ops.kernels import build
    from swnerf_torch.ops.kernels import sample_pdf as b2

    n, s = bins.shape[0], 128
    u = torch.linspace(0.0, 1.0, s, device=dev).expand(n, s)
    cases = {"frame (160,000 rays)": (bins, weights, u),
             "chunk (32,768 rays)": (bins[:32768], weights[:32768], u[:32768])}
    for nr in (1024, 500):
        cases[f"step ({nr:,} rays)"] = (bins[:nr], weights[:nr], torch.rand((nr, s), generator=g, device=dev))
    times = {k: (cuda_ms(lambda: b2.sample_pdf(*a), 50), queued_ms(lambda: b2.sample_pdf(*a), 50))
             for k, a in cases.items()}
    print("[3 B2 times] ms through the wrapper / queued behind a sleep (the device alone): " + ", ".join(
        f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items()))
    step = cases["step (1,024 rays)"]
    fn = build.load("sample_pdf").sample_pdf_f32
    sig = [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def each_call():
        fn.restype, fn.argtypes = ctypes.c_int, sig
        return b2.sample_pdf(*step)

    once, each = host_us(lambda: b2.sample_pdf(*step)), host_us(each_call)
    print(f"[3 B2 host] at 1,024 rays: {once:.1f} us a call with the signature set once, {each:.1f} us set on "
          f"every call; the device alone {1e3 * times['step (1,024 rays)'][1]:.1f} us")


# The bf16 tensor-core launches (csrc/tc_chunk.cuh) and what the run learns
# of them, printed together before the JSON lines: registers and spills
# from build.log, TFLOP/s and share of bound per launch, B3's composite and
# the narrow heads' share of the blocks' cycles, the frames' ms.
TC_LAUNCHES = ("render_pass[S=64]", "render_pass[S=192]", "render_pass[tnerf,S=64]", "render_pass[pts,S=64]",
               "render_pass[pts,S=192]",
               "render_pass[pts,wide]", "time_net", "time_net[multires]", "trunk[mesh]", "trunk[raw,mesh]",
               "trunk[tnerf,render]")
TC_SUMMARY: dict = {}
TNERF_STEP_MS: dict = {}  # the T-NeRF step's median ms by route: B4's kernel step (phase 15), B7''s eager (28)


def tc_ptxas(libs) -> None:
    """Registers and spill bytes of the tensor-core kernels (the bf16 B6
    forward, B3's body, B1's and B4's train-mode forward on it, B7 / B8's
    forward-only launch, the weight-image packer, the reverse sweep's dW and
    dH products) and of the SIMT train-mode forwards on mm_ring
    (trunk_fwd_kernel, render_loss_fwd_kernel) from each library's
    build.log; fails on a spill."""
    import re

    for name in ("time_net", "render_pass", "render_loss", "trunk"):
        entry_name = None
        for line in (libs[name].parent / "build.log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry_name = line.split("'")[1] if "'" in line else line
                continue
            tc_names = (r"time_net_tc_kernel|trunk_tc_kernel|tc13render_kernel|tc21render_loss_tc_kernel|"
                        r"tc11pack_kernel|sweep_d[wh]_kernel|trunk_fwd_kernel|render_loss_fwd_kernel")
            if not entry_name or not re.search(tc_names, entry_name):
                continue
            kernel = re.sub(r"^.*?(time_net_tc_kernel|trunk_tc_kernel|render_loss_tc_kernel|render_kernel|pack_kernel|"
                            r"sweep_d[wh]_kernel|trunk_fwd_kernel|render_loss_fwd_kernel)", r"\1", entry_name)[:60]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                print(f"[2 tc ptxas {name}] {kernel}: {m.group(1)} / {m.group(2)} bytes spill stores / loads")
                if int(m.group(1)) or int(m.group(2)):
                    fail(f"{name}: {kernel} spills")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                note = ("two warpgroups, every thread copies and both multiply" if kernel.startswith("sweep") else
                        "setmaxnreg: mm_ring's producer warpgroup gives its registers to the consumers"
                        if "fwd_kernel" in kernel else
                        "setmaxnreg: 72 for the producer warpgroup, 216 for the consumers"
                        if kernel.startswith("render_loss_tc") else
                        "setmaxnreg: 56 for the producer warpgroup, 224 for the consumers")
                print(f"[2 tc ptxas {name}] {kernel}: {m.group(1)} registers at launch ({note})")


def tc_shares(lib_name: str, fn) -> tuple:
    """B3's composite and the narrow heads' shares of the blocks' clock
    cycles during one ``fn()`` of a tensor-core kernel of ``lib_name``
    (``<lib>_profile``: tc_chunk.cuh::g_prof, per block the cycles of the
    first composite thread, which overlaps the products, and of warpgroup
    1's first thread in the heads and in all)."""
    import ctypes

    import torch

    from swnerf_torch.ops.kernels import build

    hook = getattr(build.load(lib_name), f"{lib_name}_profile")
    hook.restype, hook.argtypes = None, [ctypes.c_void_p]
    buf = torch.zeros(3 * torch.cuda.get_device_properties(0).multi_processor_count, dtype=torch.int64,
                      device="cuda")
    hook(buf.data_ptr())
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        hook(None)
    comp, head, total = buf.view(-1, 3).sum(0).tolist()
    return comp / total, head / total


def tc_summary(kernels) -> None:
    for k in kernels:
        if k["name"] in TC_LAUNCHES and k["bound_by"] == "operations":
            share = k["bound_ms"] / k["ms"]
            print(f"[tc] {k['name']}: {k['ms']:.3f} ms/launch, {share * PEAK_FLOPS['bf16'] / 1e12:.1f} TFLOP/s, "
                  f"{100 * share:.2f}% of its bound ({k['bound_ms']:.4f} ms)")
    for key, value in TC_SUMMARY.items():
        print(f"[tc] {key}: {value}")


def load_models(dev):
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    ckpt = load_tar(str(CKPT))
    cfg = VanillaNeRFConfig()
    coarse, fine = VanillaNeRF(cfg, device=dev, fused=False), VanillaNeRF(cfg, device=dev, fused=False)
    coarse.load_state_dict(vanilla_state_dict(ckpt["network_fn_state_dict"]))
    fine.load_state_dict(vanilla_state_dict(ckpt["network_fine_state_dict"]))
    return cfg, coarse.eval(), fine.eval()


def view0_rays(dev):
    import numpy as np

    from swnerf_torch.render.core import make_rays_from_camera

    with open(DATADIR / "transforms_test.json") as f:
        meta = json.load(f)
    c2w = np.array(meta["frames"][0]["transform_matrix"], np.float32)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return make_rays_from_camera(H, W, K, c2w[:3, :4], 2.0, 6.0, device=dev)


def pass_inputs(rays, cfg, n_samples):
    """Inputs of one B3 pass as the eval pass forms them."""
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.render.fused_eval import _dists_scaled

    o, d = rays.origins.contiguous(), rays.directions.contiguous()
    ve = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
    z = sample_along_rays(rays.near, rays.far, n_samples, 0.0).contiguous()
    return o, d, ve, z, _dists_scaled(z, d)


def fine_z(z64, w64, n_importance=128):
    import torch

    from swnerf_torch.ops.kernels.sample_pdf import sample_pdf_plain
    from swnerf_torch.ops.sampling import merge_z_vals

    n = z64.shape[0]
    z_mid = 0.5 * (z64[:, 1:] + z64[:, :-1])
    u = torch.linspace(0.0, 1.0, n_importance, device=z64.device).expand(n, n_importance)
    return merge_z_vals(z64, sample_pdf_plain(z_mid, w64[:, 1:-1], u))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in true fp32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 versions] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    from swnerf_torch.ops.kernels import build, launches
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[2 build] {len(libs)} libraries in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process each)")
    for name, path in libs.items():
        log = (path.parent / "build.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 ptxas {name}] {line.strip()}")
    tc_ptxas(libs)

    # ---- 3. B2 vs plain at a full frame of rays
    n, m, s = 160_000, 63, 128
    g = torch.Generator(device=dev).manual_seed(0)
    z64 = torch.linspace(2.0, 6.0, m + 1, device=dev).expand(n, m + 1)
    bins = (0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous()
    w64 = torch.rand((n, m + 1), generator=g, device=dev)
    w64[: n // 4, 10:] = 0.0  # empty space: the denom < 1e-5 guard
    weights = w64[:, 1:-1]  # strided, as the eval pass passes it
    b2_err = 0.0
    for mode in ("det", "random"):
        u = (torch.linspace(0.0, 1.0, s, device=dev).expand(n, s) if mode == "det"
             else torch.rand((n, s), generator=g, device=dev))
        got, ref = b2.sample_pdf(bins, weights, u), b2.sample_pdf_plain(bins, weights, u)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        b2_err = max(b2_err, err)
        print(f"[3 B2 {mode}] N={n} M={m} S={s} bit_exact={torch.equal(got, ref)} max|d|={err:.3e}")
        if not torch.equal(got, ref):
            fail(f"B2 {mode}: not bit-equal to its twin (max |d| {err})")
    b2_times(dev, bins, weights, g)

    # ---- 4. B3 vs plain, real weights, 4096 rays of test view 0
    cfg, coarse, fine = load_models(dev)
    rays = view0_rays(dev)
    idx = torch.arange(4096, device=dev) * 39  # spread over the frame: object and background
    rays4k = type(rays)(*(None if x is None else x[idx] for x in rays))
    b3_err = {}
    o, d, ve, z, dist = pass_inputs(rays4k, cfg, 64)
    p32 = b3.pack_params(coarse.state_dict(), cfg, torch.float32)
    w_plain = b3.render_pass_plain(p32, o, d, ve, z, dist, None, True).weights
    zf = fine_z(z, w_plain).contiguous()
    cases = {64: (coarse, z), 192: (fine, zf)}
    for S, (model, zz) in cases.items():
        distz = b3_dists(zz, d)
        for dtype in (torch.float32, torch.bfloat16):
            packed = b3.pack_params(model.state_dict(), cfg, dtype)
            got = b3.render_pass(packed, o, d, ve, zz, distz, None, True)
            ref = b3.render_pass_plain(packed, o, d, ve, zz, distz, None, True)
            torch.cuda.synchronize()
            drgb = (got.rgb - ref.rgb).abs()
            dacc = (got.acc - ref.acc).abs().max().item()
            ddep = (got.depth - ref.depth).abs().max().item()
            # rtol 1e-4 on depth, with atol 1e-5 for the background rays
            # whose depth (= sum w*z with acc ~ 0) is ~0.
            depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
            dw = (got.weights - ref.weights).abs().max().item()
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"[4 B3 {tag} S={S}] max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} "
                  f"max|dacc|={dacc:.3e} max|ddepth|={ddep:.3e} depth_within_rtol={depth_ok} max|dw|={dw:.3e}")
            if dtype == torch.float32:
                if drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok:
                    fail(f"B3 fp32 S={S} outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
            else:
                b3_err[S] = drgb.max().item()
                if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
                    fail(f"B3 bf16 S={S}: max |drgb| > 1e-2 or mean > 1e-3")

    # ---- 5. main path through the CLI
    from swnerf_torch.pipelines import run_nerf

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        argv = [
            "--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "5", "--device", "cuda",
            "--basedir", str(tmp), "--datadir", str(DATADIR), "--ft_path", str(CKPT),
        ]
        launches.clear()
        t0 = time.perf_counter()
        with recorded_frames() as p5_frames:
            savedir = Path(run_nerf.main(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
        frame0 = p5_frames[0]  # phase 45 holds the 2-rank render to it
        metrics = json.loads((savedir / "metrics.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[5 main] launches {json.dumps(counts, sort_keys=True)} (5 frames), CLI wall {wall:.2f} s")
    for key in ("render_pass[S=64]", "render_pass[S=192]", "sample_pdf"):
        if counts.get(key, 0) <= 0:
            fail(f"the main path launched no {key}")
    secs = metrics["seconds_per_frame"]
    timed = secs[1:]  # frame 0 is the warm-up
    per_frame = sum(timed) / len(timed)
    rays_per_frame = 400 * 400
    print(f"[5 main] seconds per frame {[round(x, 4) for x in secs]}")
    print(f"[5 main] after warm-up: {per_frame * 1e3:.1f} ms/frame, {rays_per_frame / per_frame:.4g} rays/s, "
          f"{rays_per_frame * (64 + 192) / per_frame:.4g} samples/s")
    TC_SUMMARY["vanilla serving (phase 5)"] = f"{per_frame * 1e3:.1f} ms per frame"
    for i, (p, q) in enumerate(zip(metrics["psnr"], metrics["ssim"])):
        print(f"[5 main] frame {i}: PSNR {p:.3f} dB SSIM {q:.4f}")
    mean_psnr = sum(metrics["psnr"]) / len(metrics["psnr"])
    print(f"[5 main] mean PSNR {mean_psnr:.3f} dB")
    if not mean_psnr >= 30.0:
        fail(f"mean PSNR {mean_psnr} < 30 dB")

    # frame 0 again, plain twins in fp32 on the card
    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.render.core import RenderConfig, render_image
    from swnerf_torch.render.fused_eval import make_vanilla_eval_pass
    from swnerf_torch.utils.config import config_parser
    from swnerf_torch.utils.metrics import calculate_metrics

    args = config_parser().parse_args(argv)
    scene = load_scene(args)
    rcfg = RenderConfig(n_samples=64, n_importance=128, white_bkgd=True)
    plain = make_vanilla_eval_pass(cfg, compute_dtype=torch.float32, plain=True)
    out = render_image(coarse, rays, rcfg, chunk=8192, fine_model=fine, eval_pass=plain)
    psnr_plain = calculate_metrics(scene.images[scene.i_test[0]], out["rgb"].reshape(400, 400, 3).cpu().numpy())[0]
    dpsnr = abs(psnr_plain - metrics["psnr"][0])
    print(f"[5 plain fp32] frame 0 PSNR {psnr_plain:.3f} dB, |dPSNR| vs bf16 kernels {dpsnr:.4f} dB")
    if dpsnr > 0.1:
        fail(f"|dPSNR| {dpsnr} > 0.1 dB")
    del out

    # ---- 6. each kernel against its twin and timed at the main path's
    # shapes (the first 32768-ray chunk of view 0, bf16 operands)
    chunk = rays.slice(0, args.chunk)
    o, d, ve, z, dist = pass_inputs(chunk, cfg, 64)
    pc, pf = b3.pack_params(coarse.state_dict(), cfg), b3.pack_params(fine.state_dict(), cfg)
    res_c = b3.render_pass(pc, o, d, ve, z, dist, None, True)
    n = z.shape[0]
    z_mid = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
    u = torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128)
    wsl = res_c.weights[:, 1:-1]
    zs = b2.sample_pdf(z_mid, wsl, u)
    zs_plain = b2.sample_pdf_plain(z_mid, wsl, u)
    err = (zs - zs_plain).abs().max().item()
    print(f"[6 check] sample_pdf N={n}: bit_exact={torch.equal(zs, zs_plain)} max|d|={err:.3e}")
    if not torch.equal(zs, zs_plain):
        fail(f"B2 at the main path's shape: not bit-equal to its twin (max |d| {err})")
    b2_err = max(b2_err, err)
    from swnerf_torch.ops.sampling import merge_z_vals

    zf = merge_z_vals(z, zs)
    distf = b3_dists(zf, d)
    kernels = []

    b2_bytes = 4 * (z_mid.numel() + n * 62 + 128 + n * 128)  # det u: one row
    b2_ops = n * (128 * (6 + 7) + 3 * 62)  # a sample's 6 search steps and 7 lerp operations, a ray's scan
    kernels.append(entry(
        "sample_pdf", "swnerf_torch/csrc/sample_pdf.cu", "swnerf_tpu/ops/pallas/sample_pdf.py:37",
        counts.get("sample_pdf", 0), b2_err,
        cuda_ms(lambda: b2.sample_pdf(z_mid, wsl, u), 50),
        cuda_ms(lambda: b2.sample_pdf_plain(z_mid, wsl, u), 5),
        b2_bytes, b2_ops, "fp32",
    ))
    for S, packed, zz, dd in ((64, pc, z, dist), (192, pf, zf, distf)):
        got = b3.render_pass(packed, o, d, ve, zz, dd, None, True)
        ref = b3.render_pass_plain(packed, o, d, ve, zz, dd, None, True)
        drgb = (got.rgb - ref.rgb).abs()
        print(f"[6 check] render_pass[S={S}] bf16 N={n}: max|drgb|={drgb.max().item():.3e} "
              f"mean|drgb|={drgb.mean().item():.3e}")
        if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
            fail(f"B3 bf16 S={S} at the main path's shape: max |drgb| > 1e-2 or mean > 1e-3")
        del got, ref
        comp, head = tc_shares("render_pass", lambda: b3.render_pass(packed, o, d, ve, zz, dd, None, True))
        TC_SUMMARY[f"render_pass[S={S}] at the serving chunk"] = (
            f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
            "of the blocks' cycles")
        flops = 2 * packed.macs_per_sample * n * S
        nbytes = 4 * (6 * n + ve.numel() + 2 * zz.numel() + 5 * n + zz.numel()) + packed.weights.numel() * 2
        kernels.append(entry(
            f"render_pass[S={S}]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            counts.get(f"render_pass[S={S}]", 0), max(b3_err[S], drgb.max().item()),
            cuda_ms(lambda: b3.render_pass(packed, o, d, ve, zz, dd, None, True), 3),
            cuda_ms(lambda: b3.render_pass_plain(packed, o, d, ve, zz, dd, None, True), 2),
            nbytes, flops, "bf16",
        ))
        lib, macs = library_sweep_ms(zz.numel(), forward_products(packed.W, packed.D, packed.skip, packed.cin_pad,
                                                                  packed.cv_pad), dev)
        print(f"[6 kernel] render_pass[S={S}]: its forward's large products at {zz.numel()} rows as bf16 torch.matmul "
              f"calls (cuBLAS, summed) {lib:.3f} ms (bound {2 * macs / PEAK_FLOPS['bf16'] * 1e3:.4f} ms)")
        TC_SUMMARY[f"render_pass[S={S}] bf16, the forward's products on cuBLAS"] = f"{lib:.3f} ms"
        torch.cuda.empty_cache()
    for k in kernels:
        print(f"[6 kernel] {k['name']}: {k['ms']:.3f} ms/launch (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the bound, "
              f"{k['launches']} launches in 5 frames")
    # The fp32 parity mode (not on the main path) against the fp32 SIMT peak.
    pf32 = b3.pack_params(fine.state_dict(), cfg, torch.float32)
    ms32 = cuda_ms(lambda: b3.render_pass(pf32, o, d, ve, zf, distf, None, True), 3)
    bound32 = 2 * pf32.macs_per_sample * zf.numel() / PEAK_FLOPS["fp32"] * 1e3
    print(f"[6 kernel] render_pass[S=192] fp32 operands: {ms32:.3f} ms/launch, fp32 bound {bound32:.3f} ms "
          f"-> {100 * bound32 / ms32:.2f}% of the bound")

    # per-stage breakdown of one frame (device time by stage, events per chunk)
    stages, first = frame_breakdown(rays, cfg, pc, pf, args.chunk)
    total = sum(stages.values())
    print("[6 breakdown] frame 0, device ms by stage (second pass): " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[6 breakdown] stage sum {total:.1f} ms vs timed frame {per_frame * 1e3:.1f} ms; the first pass, "
          f"right after empty_cache: sum {sum(first.values()):.1f} ms, " + ", ".join(
              f"{k} {v:.2f}" for k, v in first.items()))
    del pc, pf, res_c, zf, distf
    torch.cuda.empty_cache()

    # ---- 7. B1 against its twin; 8. the kernel step against the eager step
    b1_rows = phase7_b1(dev, cfg, coarse, fine)
    phase8_steps(dev, cfg, coarse, fine)

    # ---- 9. the training main path; 10. the trained checkpoint serves
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        train_counts, ckpt = phase9_train(dev, cfg, coarse, fine, tmp)
        phase10_serve(tmp, ckpt, metrics["psnr"][0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels[0]["launches"] += train_counts.get("sample_pdf", 0)  # B2 runs on both main paths
    for S, row in b1_rows.items():
        kernels.append(entry(
            f"render_loss[S={S}]", "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            train_counts.get(f"render_loss[S={S}]", 0), *row,
        ))
    for k in kernels[len(kernels) - len(b1_rows):]:
        print(f"[6 kernel] {k['name']}: {k['ms']:.3f} ms/launch (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the bound, "
              f"{k['launches']} launches in 200 train steps")

    # ---- 11-16. T-NeRF: scene, B4 against its twin, the kernel step, the
    # serving and training main paths, and the trained checkpoint serves
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tnerf_"))
    try:
        kernels += tnerf_phases(dev, tmp)
        # ---- 17-22. D-NeRF on the same scene: B6, B3's pts mode and B5
        # against their twins, the kernel step, serving, training, and the
        # trained checkpoint serves
        kernels += dnerf_phases(dev, tmp, tmp / "data_dyn_400")
        # ---- 23-25. MultiRes on the same scene: B7 and the widened B6
        # against their twins, the steps against the plain route, the CLI
        kernels += multires_phases(dev, tmp, tmp / "data_dyn_400")
        # ---- 26-30. B7' and B8 against their twins, the fields' kernel
        # routes through the CLIs, the SW mesh chain and its metric scale
        kernels += field_phases(dev, tmp, tmp / "data_dyn_400", metrics["psnr"][0])
        # ---- 31-35. MultiRes on the render kernels (B3's pts mode at its
        # widths, B9: the test render and the fused phase 2), B10, B11
        kernels += render_kernel_phases(dev, tmp, tmp / "data_dyn_400", metrics["psnr"])
        # ---- 36. K steps per dispatch: the CUDA-graph replays against one
        # step a dispatch in each trainer, and the fp32 warm start
        t0 = time.perf_counter()
        phase36_dispatch(dev, tmp, tmp / "data_dyn_400")
        print(f"[36 done] in {time.perf_counter() - t0:.1f} s")
        # ---- 37-39. the forward-facing LLFF path: the fern shape through
        # run_nerf, the kernels against their twins on its NDC rays, and
        # the LLFF quality recipe
        kernels += llff_phases(dev, tmp)
        # ---- 40. what the trainers save, log and check: the native
        # snapshot, the debug-NaN switch, the step profiler, LPIPS,
        # eval_dirs, the video writer and --do_half_precision
        p40 = phase40_tools(dev, tmp, tmp / "data_dyn_400")
        for k in kernels:
            k["launches"] += p40.get(k["name"], 0)
        # ---- 41. export: the renderers as torch.export programs calling B2,
        # the fused ones B6, B7, B7' and B8 too, as swnerf:: ops; 42. captures in
        # JPEG; 43. the 2-D encoding study
        t0 = time.perf_counter()
        p41 = phase41_export(dev, tmp, tmp / "data_dyn_400")
        rows = {"trunk[mesh]": "trunk", "trunk[raw,mesh]": "trunk[raw]", "trunk[tnerf,render]": "trunk[tnerf]",
                "time_net": "time_net", "sample_pdf": "sample_pdf"}  # the forward-only rows of B7, B8, B7', B6; B2
        for k in kernels:
            k["launches"] += p41.get(rows.get(k["name"], ""), 0)
        phase42_jpeg(dev, tmp)
        phase43_pos2d(dev, tmp)
        print(f"[41-43 done] in {time.perf_counter() - t0:.1f} s")
        # ---- 44. a one-rank NCCL world against no group at K = 20 (the
        # all-reduce captured with the step); 45. two gloo ranks on the card
        # against one process, each trainer and the sharded test render
        p44 = phase44_nccl(tmp)
        p45 = phase45_gloo(dev, tmp, tmp / "data_dyn_400", frame0)
        for k in kernels:
            k["launches"] += p44.get(k["name"], 0) + p45.get(k["name"], 0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tc_summary(kernels)
    simt_summary()
    print(f"[chip_smoke] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def b3_dists(z, d):
    from swnerf_torch.render.fused_eval import _dists_scaled

    return _dists_scaled(z, d).contiguous()


def bound(nbytes, ops, kind):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, kind):
    bound_ms, bound_by = bound(nbytes, ops, kind)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


# B1's and B6's backward by kernel family (kernel_split): the forward (SIMT,
# or on the tensor cores: render_loss_tc_kernel, time_net_tc_kernel,
# trunk_tc_kernel's forward-only launches), the
# reverse sweep's tensor-core products (csrc/tc_gemm.cuh), the split
# reductions, the SIMT heads and narrow products.
SWEEP_FAMILIES = (("forward", ("render_loss_fwd", "render_loss_tc", "time_net_fwd", "time_net_tc", "trunk_fwd",
                              "trunk_tc")),
                  ("tensor-core products", ("sweep_dw", "sweep_dh")),
                  ("split reductions", ("reduce_kernel", "colsum")),
                  ("SIMT products and heads", ("gemm_kernel", "head_bwd", "round_cotangent")))


def kernel_split(fn, families=SWEEP_FAMILIES, names=None):
    """Device ms of one ``fn()`` by kernel family (torch.profiler's CUDA
    activity, after a warm-up), or None when it records no device time;
    with ``names`` (a dict), each family's kernels' short names go there.
    Thirty-two short spin kernels open the profiled window and are left out
    of the sums: late in this script's run, profiles without them lost their
    first few device records (B5's and B9's SIMT forwards in phases 18 and
    31 were missing from the families; one long spin did not help)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(100_000)
        fn()
        torch.cuda.synchronize()
    by = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us and str(evt.device_type).endswith("CUDA") and "spin_kernel" not in evt.key:
            fam = next((f for f, keys in families if any(k in evt.key for k in keys)), "other")
            by[fam] += us / 1e3
            if names is not None:
                short = next((k for _, keys in families for k in keys if k in evt.key), evt.key[:40])
                names.setdefault(fam, set()).add(short)
    return by if sum(by.values()) > 0 else None


SIMT_FORWARDS: dict = {}  # the SIMT train-mode forwards' times against their SIMT bounds, summed up at the end


def sm_clocks() -> tuple:
    """(current, max) SM clock in MHz, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cur, top = (int(x) for x in out.split(","))
    return cur, top


def simt_forward(tag, name, fn, flops):
    """The SIMT train-mode forward's own device ms in one ``fn()``
    (trunk_fwd_kernel or render_loss_fwd_kernel: mm_ring, fp32 FMAs in
    order; torch.profiler), against its SIMT bound: ``flops`` at the card's
    fp32 FMA rate, SMs x 128 lanes x 2 x the max SM clock nvidia-smi
    reports (66.9 TFLOP/s at 132 SMs and 1,980 MHz). The tensor cores
    (989 TFLOP/s) cannot keep these forwards' fp32 order, so this is their
    bound. Prints the SM clock read right after the window beside it."""
    import torch

    split = kernel_split(fn, (("forward", ("trunk_fwd_kernel", "render_loss_fwd_kernel")),))
    cur, top = sm_clocks()
    if not split or not split["forward"]:
        fail(f"{name}: no SIMT train-mode forward in the profile")
    ms = split["forward"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 128 * 2 * top * 1e6
    bound = flops / rate * 1e3
    SIMT_FORWARDS[name] = (ms, bound, cur, top)
    print(f"[{tag} simt] {name}: forward {ms:.3f} ms, {100 * bound / ms:.1f}% of its SIMT bound {bound:.4f} ms "
          f"({flops / 1e9:.2f} GFLOP at {rate / 1e12:.1f} TFLOP/s: {sms} SMs x 128 lanes x 2 x {top} MHz, the max SM "
          f"clock); the SM clock after the window {cur} MHz")


def ordered_check(tag, name, packed, emb, vemb):
    """B7's bf16 train-mode raw bit-equal to trunk_ordered, the kernel's
    order in torch ops (tests/test_torch_ordered_twin.py proves the two
    agree where each FMA's product is exact)."""
    import torch

    from swnerf_torch.ops.kernels import trunk as b7

    raw = b7._launch_fwd(packed, emb, vemb, b7._scratch(packed, emb.shape[0], emb.device))
    ref = b7.trunk_ordered(packed, emb, vemb)
    torch.cuda.synchronize()
    same = torch.equal(raw, ref)
    print(f"[{tag} ordered] {name}, {emb.shape[0]} rows: B7's bf16 train-mode raw bit-equal to trunk_ordered={same} "
          f"(max|d| {(raw - ref).abs().max().item():.3e})")
    if not same:
        fail(f"{name}: B7's bf16 train-mode raw differs from trunk_ordered")


def simt_summary() -> None:
    for name, (ms, bound, cur, top) in SIMT_FORWARDS.items():
        print(f"[simt] {name}: {ms:.3f} ms, {100 * bound / ms:.1f}% of its SIMT bound ({bound:.4f} ms at {top} MHz; "
              f"{cur} MHz read after it)")


def sweep_products(W, D, skip, cin_pad, cv_pad=None, demb=False):
    """The reverse sweep's large products, as ("dw", in, out) for dW = X^T
    dZ and ("dh", out, in) for dH = dZ W^T: per trunk layer its dW and
    (above layer 0) its dH, the embedding rows' dW at layer 0 and the skip
    layer (with demb, B5, B7, B9, also dz W_emb^T there); with cv_pad (B1,
    B4, B5, B7, B9) first the view layer's two dW, d feat, the feature dW
    and the top layer's dH."""
    out = []
    if cv_pad is not None:
        out += [("dw", W, W // 2), ("dw", cv_pad, W // 2), ("dh", W // 2, W), ("dw", W, W), ("dh", W, W)]
    for i in range(D - 1, -1, -1):
        if i in (0, skip + 1):
            out.append(("dw", cin_pad, W))
            if demb:
                out.append(("dh", W, cin_pad))
        if i > 0:
            out += [("dw", W, W), ("dh", W, W)]
    return out


def forward_products(W, D, skip, cin_pad, cv_pad=None):
    """The field forward's large products, as ("fw", in, out) for X [P,
    in] @ W [in, out]: the trunk (the embedding rows at layer 0 and the
    skip layer) and, with cv_pad (a field, not B6's trunk), the feature
    layer and the view layer's two (the narrow alpha and rgb heads, and
    B6's 3-wide head, left out, as sweep_products leaves them out)."""
    out = []
    for i in range(D):
        if i in (0, skip + 1):
            out.append(("fw", cin_pad, W))
        if i > 0:
            out.append(("fw", W, W))
    return out if cv_pad is None else out + [("fw", W, W), ("fw", W, W // 2), ("fw", cv_pad, W // 2)]


def library_sweep_ms(P, products, dev):
    """The products at P rows as bf16 torch.matmul calls (cuBLAS) on seeded
    operands, each timed with CUDA events: (sum of ms, multiply-adds). The
    port never calls them; they are the yardstick of the sweep's (and of
    the forward's: forward_products) products."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    total, macs = 0.0, 0
    for kind, a, b in products:
        if kind == "dw":  # [a, P] @ [P, b]: both operands row-major over P, as the spills are
            x = torch.randn((P, a), generator=g, device=dev).bfloat16()
            z = torch.randn((P, b), generator=g, device=dev).bfloat16()
            total += cuda_ms(lambda: torch.matmul(x.t(), z), 5)
        elif kind == "fw":  # [P, a] @ [a, b]: the packed [in][out] matrix as it is
            x = torch.randn((P, a), generator=g, device=dev).bfloat16()
            w = torch.randn((a, b), generator=g, device=dev).bfloat16()
            total += cuda_ms(lambda: torch.matmul(x, w), 5)
        else:  # [P, a] @ [a, b]: the packed [b][a] matrix, transposed
            z = torch.randn((P, a), generator=g, device=dev).bfloat16()
            w = torch.randn((b, a), generator=g, device=dev).bfloat16()
            total += cuda_ms(lambda: torch.matmul(z, w.t()), 5)
        macs += P * a * b
    return total, macs


def report_library(tag, name, P, products, ms, dev, what="forward"):
    """Prints, and keeps for the [tc] lines, a launch's large products
    (forward_products or sweep_products) at P rows as bf16 torch.matmul
    calls on cuBLAS, summed, beside the launch's ms: PERF.md's library
    column where no one PyTorch call computes the kernel. Returns the sum."""
    lib, macs = library_sweep_ms(P, products, dev)
    print(f"[{tag} library] {name}: the {what}'s {len(products)} large products at {P} rows as bf16 torch.matmul "
          f"calls (cuBLAS, summed) {lib:.3f} ms (their bound {2 * macs / PEAK_FLOPS['bf16'] * 1e3:.4f} ms) beside its "
          f"{ms:.3f} ms")
    TC_SUMMARY[f"{name}, the {what}'s products on cuBLAS"] = f"{lib:.3f} ms beside the launch's {ms:.3f} ms"
    return lib


def report_sweep(tag, name, fn, ms, bound_ms, P, products, dev, fwd=None):
    """Prints a bf16 train-mode launch's (B1, B4, B5, B9) or backward's
    (B6, B7) time beside its bound, its device time by kernel family (with
    the forward's kernels named) and its sweep's large products on cuBLAS;
    with ``fwd`` (forward_products), the forward's too. Returns (family
    split or None, the sweep's cuBLAS sum)."""
    names = {}
    split = kernel_split(fn, names=names)
    lib, macs = library_sweep_ms(P, products, dev)
    parts = ("not measured (torch.profiler recorded no device time)" if split is None
             else ", ".join(f"{k} {v:.3f}" + (f" ({'/'.join(sorted(names[k]))})" if k == "forward" and k in names
                                               else "") for k, v in split.items() if v))
    text = (f"[{tag} sweep] {name}: {ms:.3f} ms per launch, bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.2f}%); "
            f"device ms by family: {parts}; its {len(products)} large products at {P} rows: bound "
            f"{2 * macs / PEAK_FLOPS['bf16'] * 1e3:.4f} ms, as bf16 torch.matmul calls (cuBLAS, summed) {lib:.3f} ms")
    TC_SUMMARY[f"{name}, the sweep's products on cuBLAS"] = f"{lib:.3f} ms beside the launch's {ms:.3f} ms"
    if fwd is not None:
        flib, fmacs = library_sweep_ms(P, fwd, dev)
        text += (f"; the forward's {len(fwd)} large products: bound {2 * fmacs / PEAK_FLOPS['bf16'] * 1e3:.4f} ms, "
                 f"on cuBLAS {flib:.3f} ms")
        TC_SUMMARY[f"{name}, the forward's products on cuBLAS"] = f"{flib:.3f} ms"
    print(text)
    return split, lib


def frame_breakdown(rays, cfg, pc, pf, chunk, n_importance=128):
    """Device milliseconds of each eval-pass stage over one frame (64 +
    ``n_importance`` samples), chunk by chunk as render_image runs it (CUDA
    events around each stage), twice: returns the second pass's stages,
    then the first's. The first pass runs
    right after the allocator's cache was emptied; where the host falls
    behind and the device drains, the idle time lands in the stage that
    waits (B2's, there), which the second pass does not see."""
    import torch

    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.sampling import merge_z_vals

    names = ("rays+z", "coarse B3", "B2", "sort merge", "fine B3", "disp")
    reps = [dict.fromkeys(names, 0.0) for _ in range(2)]
    n_all = rays.origins.shape[0]
    for acc in reps:
        for start in range(0, n_all, chunk):
            tile = rays.slice(start, min(n_all, start + chunk))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            o, d, ve, z, dist = pass_inputs(tile, cfg, 64)
            ev[1].record()
            res = b3.render_pass(pc, o, d, ve, z, dist, None, True)
            ev[2].record()
            n = z.shape[0]
            z_mid = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
            u = torch.linspace(0.0, 1.0, n_importance, device=z.device).expand(n, n_importance)
            zs = b2.sample_pdf(z_mid, res.weights[:, 1:-1], u)
            ev[3].record()
            zf = merge_z_vals(z, zs)
            ev[4].record()
            res = b3.render_pass(pf, o, d, ve, zf, b3_dists(zf, d), None, True)
            ev[5].record()
            _ = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
            ev[6].record()
            torch.cuda.synchronize()
            for i, k in enumerate(names):
                acc[k] += ev[i].elapsed_time(ev[i + 1])
    return reps[1], reps[0]


# ---------------------------------------------------------------- training phases


def train_view_rays(dev, n, seed):
    """``n`` seeded random pixels of train view r_0: rays (``build_rays``)
    and the white-composited target colours."""
    import numpy as np
    import torch

    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.render.core import build_rays
    from swnerf_torch.utils.png import read_png

    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    frame = meta["frames"][0]
    img = read_png(str(DATADIR / (frame["file_path"] + ".png"))).astype(np.float32) / 255.0
    img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    H, W = img.shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    g = torch.Generator(device=dev).manual_seed(seed)
    pix = torch.stack([torch.randint(0, H, (n,), generator=g, device=dev),
                       torch.randint(0, W, (n,), generator=g, device=dev)], -1)
    c2w = torch.tensor(frame["transform_matrix"], dtype=torch.float32, device=dev)[:3, :4]
    o, d = get_rays_at(pix, H, W, K, c2w)
    target = torch.as_tensor(img, device=dev)[pix[:, 0], pix[:, 1]].contiguous()
    return build_rays(o, d, 2.0, 6.0), target


def rel_l2(got, ref):
    """Per-tensor ||got - ref|| / ||ref||, in float64."""
    return {k: ((got[k].double().cpu() - ref[k].double().cpu()).norm()
                / ref[k].double().cpu().norm().clamp_min(1e-300)).item() for k in ref}


def check_fp32_grads(tag, kern, ref32, ref64, ref64p=None):
    """The fp32 gradient bar: each tensor within rel L2 1e-4 of the fp32
    reference, or, where the two fp32 computations disagree on a ReLU mask,
    no further from the float64 reference than twice the fp32 reference is.
    At D=8 a few of the ~1e8 trunk pre-activations can sit within fp32
    rounding of 0; two summation orders then disagree on those masks and the
    lower trunk's gradients move by far more than 1e-4 (ROADMAP.md Queue C).
    With ``ref64p`` (the float64 reference on weights perturbed at fp32's
    size, see jitter) the fallback also admits twice the distance that
    perturbation moves the float64 reference: the D-NeRF deformation MLP's
    ReLUs tie often enough that two fp32 orders land ~1e-3 apart."""
    r32, rk, rr = rel_l2(kern, ref32), rel_l2(kern, ref64), rel_l2(ref32, ref64)
    rp = rel_l2(ref64p, ref64) if ref64p is not None else dict.fromkeys(rr, 0.0)
    print(f"[{tag}] rel L2 vs fp32 reference: max {max(r32.values()):.3e} ({max(r32, key=r32.get)}), "
          f"heads max {max(v for k, v in r32.items() if 'pts_linears' not in k):.3e}")
    print(f"[{tag}] rel L2 vs float64 reference: kernel max {max(rk.values()):.3e}, "
          f"fp32 reference max {max(rr.values()):.3e}"
          + (f", float64 under an fp32-sized perturbation max {max(rp.values()):.3e}" if ref64p is not None else ""))
    bad = {k: (r32[k], rk[k], rr[k], rp[k]) for k in rk if r32[k] > 1e-4 and rk[k] > 2.0 * max(rr[k], rp[k])}
    if bad:
        fail(f"{tag}: gradients off the fp32 reference and further from the float64 one than fp32 moves it: {bad}")


def check_tc_forward(tag, got, fwd):
    """B1's / B4's bf16 train-mode forward runs B3's tensor-core body
    (render_loss_tc_kernel): its rgb, acc, depth and weights must equal the
    bf16 render_pass launch's on the same inputs bit for bit."""
    import torch

    same = {k: torch.equal(getattr(got, k), getattr(fwd, k)) for k in ("rgb", "acc", "depth", "weights")}
    print(f"[{tag}] outputs bit-equal to the bf16 tensor-core render_pass launch: {same}")
    if not all(same.values()):
        fail(f"{tag}: the train-mode forward differs from the bf16 render_pass launch: {same}")


def phase7_b1(dev, cfg, coarse, fine):
    """B1 against its twin on the main path's shapes; returns, per S, the
    [6 kernel] row fields (max_abs_err, ms, plain_ms, bytes, ops, kind)."""
    return hold_b1("7", dev, cfg, coarse, fine, *train_view_rays(dev, 1024, seed=0), n_importance=128)


def hold_b1(tag, dev, cfg, coarse, fine, rays, target, n_importance, white=True):
    """B1 against its twin on ``rays`` (a train step's, with their target
    colours): the coarse pass at 64 jittered samples, the fine pass at 64 +
    ``n_importance`` from a B2 pass, noise std 1, on a white background or
    (``white`` False) none, at phase 7's bars (fp32
    and bf16 outputs and gradients, bit-equal repeats, the bf16 forward
    bit-equal to the render_pass launch); times, the family split and the
    products on cuBLAS. Returns, per S, the [kernel] row fields."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays

    n = rays.origins.shape[0]
    scale = 1.0 / (3 * n)
    g = torch.Generator(device=dev).manual_seed(1)
    o, d = rays.origins, rays.directions
    ve = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
    z64 = sample_along_rays(rays.near, rays.far, 64, 1.0, generator=g).contiguous()
    noise64 = torch.randn(z64.shape, generator=g, device=dev)  # std 1: the sigma > 0 mask is exercised
    pc32 = b3.pack_params(coarse.state_dict(), cfg, torch.float32)
    w64 = b1.render_loss_plain(pc32, o, d, ve, z64, b3_dists(z64, d), noise64, target, white, scale)[0].weights
    u = torch.rand((n, n_importance), generator=g, device=dev)
    zf = merge_z_vals(z64, b2.sample_pdf((0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous(), w64[:, 1:-1], u))
    zf = zf.contiguous()
    noise_f = torch.randn(zf.shape, generator=g, device=dev)
    rows = {}
    for S, model, zz, nz in ((64, coarse, z64, noise64), (zf.shape[1], fine, zf, noise_f)):
        args = (o, d, ve, zz, b3_dists(zz, d), nz, target)
        sd = model.state_dict()
        # fp32 operands: kernel vs twin, the float64 twin as the conditioning reference
        p32 = b3.pack_params(sd, cfg, torch.float32)
        got, gk = b1.render_loss(p32, *args, white, scale)
        ref, gr = b1.render_loss_plain(p32, *args, white, scale)
        p64 = b3.pack_params(sd, cfg, torch.float64)
        _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), white, scale)
        torch.cuda.synchronize()
        drgb = (got.rgb - ref.rgb).abs().max().item()
        dacc = (got.acc - ref.acc).abs().max().item()
        depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
        # sqerr: rel 1e-4, with atol 1e-7 for the rays whose error is ~0
        sq_ok = torch.allclose(got.sqerr, ref.sqerr, rtol=1e-4, atol=1e-7)
        print(f"[{tag} B1 fp32 S={S}] max|drgb|={drgb:.3e} max|dacc|={dacc:.3e} "
              f"max|ddepth|={(got.depth - ref.depth).abs().max().item():.3e} depth_within_rtol={depth_ok} "
              f"max|dsqerr|={(got.sqerr - ref.sqerr).abs().max().item():.3e} sqerr_within_rtol={sq_ok} "
              f"max|dw|={(got.weights - ref.weights).abs().max().item():.3e}")
        if drgb > 1e-4 or dacc > 1e-4 or not depth_ok or not sq_ok:
            fail(f"{tag} B1 fp32 S={S} outputs outside rgb/acc 1e-4, depth and sqerr rtol 1e-4 (atol 1e-5 / 1e-7)")
        check_fp32_grads(f"{tag} B1 fp32 S={S}", b1.unpack_grads(gk, p32), b1.unpack_grads(gr, p32),
                         b1.unpack_grads(g64, p64))
        _, gk2 = b1.render_loss(p32, *args, white, scale)
        torch.cuda.synchronize()
        if not (torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])):
            fail(f"{tag} B1 fp32 S={S}: two launches gave different gradients")
        del gr, g64, gk2
        # bf16 operands (the main path's): kernel vs the bf16 twin
        p16 = b3.pack_params(sd, cfg, torch.bfloat16)
        got, gk = b1.render_loss(p16, *args, white, scale)
        ref, gr = b1.render_loss_plain(p16, *args, white, scale)
        _, gk2 = b1.render_loss(p16, *args, white, scale)
        torch.cuda.synchronize()
        diff = (got.rgb - ref.rgb).abs()
        rel = rel_l2(b1.unpack_grads(gk, p16), b1.unpack_grads(gr, p16))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        print(f"[{tag} B1 bf16 S={S}] max|drgb|={diff.max().item():.3e} mean|drgb|={diff.mean().item():.3e} "
              f"grads max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}")
        if diff.max().item() > 1e-2 or diff.mean().item() > 1e-3 or max(rel.values()) > 1e-2 or not same:
            fail(f"{tag} B1 bf16 S={S}: rgb max > 1e-2, mean > 1e-3, gradient rel L2 > 1e-2 or repeats differ")
        check_tc_forward(f"{tag} B1 bf16 S={S}", got, b3.render_pass(p16, o, d, ve, zz, b3_dists(zz, d), nz, white))
        nbytes = (4 * (6 * n + ve.numel() + 3 * zz.numel() + 3 * n) + 2 * p16.weights.numel() + 4 * p16.biases.numel()
                  + 4 * (4 * n + zz.numel()) + 4 * (p16.weights.numel() + p16.biases.numel()))
        flops = 2 * b1.train_macs_per_sample(p16) * zz.numel()
        ms = cuda_ms(lambda: b1.render_loss(p16, *args, white, scale), 5)
        plain_ms = cuda_ms(lambda: b1.render_loss_plain(p16, *args, white, scale), 2)
        rows[S] = (diff.max().item(), ms, plain_ms, nbytes, flops, "bf16")
        report_sweep(tag, f"render_loss[S={S}] bf16", lambda: b1.render_loss(p16, *args, white, scale), ms,
                     bound(nbytes, flops, "bf16")[0], zz.numel(),
                     sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), dev,
                     fwd=forward_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad))
        del gk, gr, gk2, got, ref
        torch.cuda.empty_cache()
    return rows


def _fresh_state(cfg, coarse, fine, device, dtype=None, graphs=False):
    from swnerf_torch.models import VanillaNeRF
    from swnerf_torch.train.loop import init_train_state

    def copy(model):
        m = VanillaNeRF(cfg, device=device, fused=False)  # the eager step's reference: plain torch
        m.load_state_dict(model.state_dict())
        return m.to(dtype) if dtype is not None else m

    return init_train_state(copy(coarse), copy(fine), 5e-4, 500, step=10000, graphs=graphs)


def _grads(state):
    return {f"{net}.{k}": p.grad.detach().clone() for net, m in (("coarse", state.coarse), ("fine", state.fine))
            for k, p in m.named_parameters()}


def phase8_steps(dev, cfg, coarse, fine):
    """The kernel step (B1, B2) against the eager autograd step, same state
    and draws; the eager step in float64 on the CPU is the reference for the
    gradient bar of check_fp32_grads."""
    import torch

    from swnerf_torch.render.core import Draws, RenderConfig, Rays, make_draws
    from swnerf_torch.train.fused_step import make_fused_train_step
    from swnerf_torch.train.loop import make_train_step

    rays, target = train_view_rays(dev, 1024, seed=2)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    draws = make_draws(rcfg, 1024, torch.Generator(device=dev).manual_seed(3), dev)
    sk, se = _fresh_state(cfg, coarse, fine, dev), _fresh_state(cfg, coarse, fine, dev)
    mk = make_fused_train_step(cfg, rcfg, fcfg=cfg, compute_dtype=torch.float32)(sk, rays, target, draws=draws)
    me = make_train_step(rcfg)(se, rays, target, draws=draws)
    torch.cuda.synchronize()
    s64 = _fresh_state(cfg, coarse, fine, "cpu", torch.float64)
    cpu64 = lambda x: None if x is None else x.detach().cpu().double()  # noqa: E731
    make_train_step(rcfg)(s64, Rays(*(cpu64(x) for x in rays)), cpu64(target), draws=Draws(*(cpu64(x) for x in draws)))
    dloss = abs(mk["total_loss"].item() - me["total_loss"].item()) / me["total_loss"].item()
    print(f"[8 step fp32] total_loss kernel {mk['total_loss'].item():.7f} eager {me['total_loss'].item():.7f} "
          f"rel {dloss:.3e}; psnr {mk['psnr'].item():.4f} vs {me['psnr'].item():.4f}")
    if dloss > 1e-5:
        fail(f"kernel step loss rel {dloss} > 1e-5")
    check_fp32_grads("8 step fp32", _grads(sk), _grads(se), _grads(s64))
    sb = _fresh_state(cfg, coarse, fine, dev)
    mb = make_fused_train_step(cfg, rcfg, fcfg=cfg, compute_dtype=torch.bfloat16)(sb, rays, target, draws=draws)
    dl16 = abs(mb["total_loss"].item() - me["total_loss"].item()) / me["total_loss"].item()
    print(f"[8 step bf16] total_loss kernel {mb['total_loss'].item():.7f} vs fp32 eager: rel {dl16:.3e}")
    if dl16 > 1e-2:
        fail(f"bf16 kernel step loss rel {dl16} > 1e-2")
    del sk, se, s64, sb
    torch.cuda.empty_cache()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def phase9_train(dev, cfg, coarse, fine, tmp):
    """The training main path through the CLI: 200 steps resumed from
    010000.tar. Returns its launch counts and the last checkpoint's path."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_nerf
    from swnerf_torch.train.checkpoint import load_tar

    argv = [
        "--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(tmp), "--datadir", str(DATADIR),
        "--device", "cuda", "--i_print", "50", "--i_weights", "100",
    ]
    os.environ["SWNERF_MAX_ITERS"] = "10201"
    buf = io.StringIO()
    try:
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_nerf.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        os.environ.pop("SWNERF_MAX_ITERS", None)
    out = buf.getvalue()
    exp = tmp / "full_nerf_200k"
    print(f"[9 train] launches {json.dumps(counts, sort_keys=True)} (200 steps), CLI wall {wall:.2f} s")
    if f"Reloading from {CKPT}" not in out or "kernel train step" not in out or min(res["step_ms"]) != 10001:
        fail("the training run did not resume from 010000.tar at 10000 on the kernel step")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], r["psnr"]) for r in recs if "psnr" in r]
    print(f"[9 train] train PSNR at the prints: {psnrs}")
    if len(psnrs) != 4 or min(p for _, p in psnrs) < 30.0:
        fail(f"train PSNR below 30 dB at a print (or not 4 prints): {psnrs}")
    for i in (10100, 10200):
        ck = load_tar(str(exp / f"{i:06d}.tar"))
        steps = {int(e["step"]) for e in ck["optimizer_state_dict"]["state"].values()}
        keys = set(ck)
        print(f"[9 train] {i:06d}.tar keys {sorted(keys)} Adam step {steps}")
        if keys != {"global_step", "network_fn_state_dict", "network_fine_state_dict", "optimizer_state_dict"} \
                or steps != {i} or ck["global_step"] != i:
            fail(f"{i:06d}.tar: keys {keys}, Adam steps {steps}")
    b1_count = counts.get("render_loss[S=64]", 0) + counts.get("render_loss[S=192]", 0)
    if b1_count < 400 or counts.get("sample_pdf", 0) < 200:
        fail(f"the training main path launched B1 {b1_count} and B2 {counts.get('sample_pdf', 0)} times")
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % 50 and (i - 1) % 50}
    med = statistics.median(quiet.values())
    spr = 1024 * (64 + 192)
    print(f"[9 train] ms per step, median of {len(quiet)} steps that neither print nor save (CUDA events): "
          f"{med:.3f} ms (min {min(quiet.values()):.3f}, max {max(quiet.values()):.3f}); "
          f"{1024 / med * 1e3:.4g} rays/s, {spr / med * 1e3:.4g} samples/s")
    stages = step_breakdown(dev, cfg, coarse, fine)
    total = sum(stages.values())
    print("[9 breakdown] one step, device ms by stage: " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[9 breakdown] stage sum {total:.2f} ms vs median step {med:.2f} ms")
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3

    macs = b1.train_macs_per_sample(b3.pack_params(fine.state_dict(), cfg))
    print("[9 breakdown] " + ", ".join(
        f"{k} {stages[k]:.3f} ms against its bound {2 * macs * 1024 * s / PEAK_FLOPS['bf16'] * 1e3:.4f} ms"
        for k, s in (("coarse B1", 64), ("fine B1", 192))))
    return counts, exp / "010200.tar"


def step_breakdown(dev, cfg, coarse, fine):
    """Device milliseconds of each stage of one kernel train step (bf16, the
    CLI's step), CUDA events between stages, after one warm-up step. The
    stages are those of train/fused_step.py, written out here."""
    import numpy as np
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.pipelines.common import ImageSampler, Scene
    from swnerf_torch.render.core import RenderConfig, build_rays, make_draws
    from swnerf_torch.train.fused_step import _set_grads

    rays, _ = train_view_rays(dev, 1, seed=0)
    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"][:1]], np.float32)
    scene = Scene(images=np.zeros((1, H, W, 3), np.float32), poses=poses, render_poses=poses, H=H, W=W, focal=focal,
                  K=K, near=2.0, far=6.0, i_train=np.arange(1), i_val=np.arange(0), i_test=np.arange(0))
    images = torch.rand((1, H, W, 3), device=dev)
    poses_dev = torch.as_tensor(poses[:, :3, :4], device=dev)
    sampler = ImageSampler(scene, 1024, 0, 0.5)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True)
    state = _fresh_state(cfg, coarse, fine, dev, graphs=True)  # the trainer's Adam
    g = torch.Generator(device=dev).manual_seed(0)
    names = ("host sampler", "rays + z", "pack coarse", "coarse B1", "B2", "sort", "pack fine", "fine B1",
             "unpack + Adam")
    acc = dict.fromkeys(names, 0.0)
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        img_i, pixels = sampler.next(20000)
        pixels = torch.as_tensor(pixels, device=dev)
        ev[1].record()
        o, d = get_rays_at(pixels, H, W, K, poses_dev[img_i])
        target = images[img_i][pixels[:, 0], pixels[:, 1]].contiguous()
        r = build_rays(o, d, 2.0, 6.0)
        draws = make_draws(rcfg, 1024, g, dev)
        z = sample_along_rays(r.near, r.far, 64, 1.0, t_rand=draws.t_rand).contiguous()
        ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
        ev[2].record()
        state.zero_grad()
        pk = b3.pack_params(state.coarse.state_dict(), cfg, torch.bfloat16)
        ev[3].record()
        oc, gc = b1.render_loss(pk, r.origins, r.directions, ve, z, b3_dists(z, r.directions), None, target, True,
                                1.0 / 3072)
        ev[4].record()
        zs = b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), oc.weights[:, 1:-1], draws.u)
        ev[5].record()
        zf = merge_z_vals(z, zs).contiguous()
        ev[6].record()
        pkf = b3.pack_params(state.fine.state_dict(), cfg, torch.bfloat16)
        ev[7].record()
        _, gf = b1.render_loss(pkf, r.origins, r.directions, ve, zf, b3_dists(zf, r.directions), None, target, True,
                               1.0 / 3072)
        ev[8].record()
        _set_grads(state.coarse, b1.unpack_grads(gc, pk))
        _set_grads(state.fine, b1.unpack_grads(gf, pkf))
        state.apply_update()
        ev[9].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                acc[k] = ev[i].elapsed_time(ev[i + 1])
    return acc


def phase10_serve(tmp, ckpt, psnr_before):
    """Test frame 0 rendered from the trained checkpoint by the serving CLI."""
    from swnerf_torch.pipelines import run_nerf

    argv = [
        "--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "25", "--device", "cuda",
        "--basedir", str(tmp / "serve"), "--datadir", str(DATADIR), "--ft_path", str(ckpt),
    ]
    metrics = json.loads((Path(run_nerf.main(argv)) / "metrics.json").read_text())
    psnr = metrics["psnr"][0]
    print(f"[10 serve] frame 0 from {ckpt.name}: PSNR {psnr:.3f} dB SSIM {metrics['ssim'][0]:.4f}; "
          f"from 010000.tar {psnr_before:.3f} dB (delta {psnr - psnr_before:+.3f} dB)")
    if not psnr >= 30.0 or abs(psnr - psnr_before) > 0.5:
        fail(f"frame 0 from {ckpt.name}: {psnr} dB (< 30 dB or more than 0.5 dB from {psnr_before})")


# ---------------------------------------------------------------- T-NeRF phases


def tnerf_phases(dev, tmp):
    """Phases 11-16. Returns the [kernel] rows of B4 in its two modes."""
    import torch

    from swnerf_torch.models import TNeRF, TNeRFConfig
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    data = phase11_scene(dev, tmp / "data_dyn_400")
    cfg = TNeRFConfig()
    model = TNeRF(cfg, device=dev, fused=False)
    model.load_state_dict(tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"]))
    model.eval()
    rows = phase12_b4(dev, cfg, model, data)
    phase13_step(dev, cfg, model, data)
    del model
    torch.cuda.empty_cache()
    exp = tmp / "logs" / "full_tnerf_800k"  # the config's expname: the copy is the newest .tar there
    exp.mkdir(parents=True)
    shutil.copy(TNERF_CKPT, exp / "800000.tar")
    serve_counts, psnr0 = phase14_serve(dev, cfg, tmp, data)
    train_counts = phase15_train(dev, cfg, tmp, data)
    phase16_serve(tmp, data, psnr0)
    rows["render_pass"]["launches"] = serve_counts.get("render_pass[tnerf,S=64]", 0)
    rows["render_loss"]["launches"] = train_counts.get("render_loss[tnerf,S=64]", 0)
    for k in rows.values():
        print(f"[12 kernel] {k['name']}: {k['ms']:.3f} ms/launch (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the bound, "
              f"{k['launches']} launches on its main path")
    return list(rows.values())


def tnerf_args(tmp, data, *extra):
    return ["--config", str(TNERF_CONFIG), "--basedir", str(tmp / "logs"), "--datadir", str(data),
            "--device", "cuda", *extra]


def phase11_scene(dev, root):
    """The scene of benchmarks/tpu_full_scale.py:115-129, written by the
    port: write_blender_scene(n_train=100, n_val=5, n_test=25, size=400,
    dynamic=True, scene="textured", white_bkgd=True), seed 0, 128 samples."""
    import torch

    from swnerf_torch.data.synthetic import write_blender_scene

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_blender_scene(str(root), n_train=100, n_val=5, n_test=25, size=TNERF_SIZE, dynamic=True,
                        scene="textured", white_bkgd=True, device=dev)
    torch.cuda.synchronize()
    print(f"[11 scene] dynamic textured {TNERF_SIZE}x{TNERF_SIZE}, 100/5/25 views, 128 GT samples: written in "
          f"{time.perf_counter() - t0:.2f} s")
    return root


def gt_image(data, split, index):
    """(frame metadata, white-composited image [H, W, 3]) of one view of the
    written scene."""
    import numpy as np

    from swnerf_torch.utils.png import read_png

    with open(data / f"transforms_{split}.json") as f:
        meta = json.load(f)
    frame = meta["frames"][index]
    img = read_png(str(data / (frame["file_path"] + ".png"))).astype(np.float32) / 255.0
    return meta, frame, img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])


def unit_range_psnr(psnrs, data):
    """The CLI's per-test-frame PSNRs (metrics.json: skimage's, whose data
    range is the ground truth's max - min) on the scale of the evaluator that
    logged the reference's 21.60 dB (benchmarks/parity_vs_torch.py:445,
    data_range=1.0). The MSE is the same, so the two differ by
    -20 log10(max - min): about 1.1 dB on this scene, whose darkest colour
    is sigmoid(-2) = 0.12. T-NeRF's colours lie in [0, 1], so the
    evaluator's clip changes nothing."""
    import math

    out = []
    for i, p in enumerate(psnrs):
        img = gt_image(data, "test", i)[2]
        out.append(p - 20.0 * math.log10(float(img.max() - img.min())))
    return out


def frame_rays(dev, data, split, index):
    """All rays of one view of the written scene at its frame time, and its
    white-composited image [H*W, 3]."""
    import numpy as np
    import torch

    from swnerf_torch.render.core import make_rays_from_camera

    meta, frame, img = gt_image(data, split, index)
    H, W = img.shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = np.array(frame["transform_matrix"], np.float32)[:3, :4]
    rays = make_rays_from_camera(H, W, K, c2w, 2.0, 6.0, device=dev, time=float(frame["time"]))
    return rays, torch.as_tensor(img.reshape(-1, 3), device=dev)


def tnerf_pass_inputs(rays, cfg, z):
    from swnerf_torch.ops.embedding import positional_encoding

    o, d = rays.origins.contiguous(), rays.directions.contiguous()
    ve = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
    return o, d, ve, z.contiguous(), b3_dists(z, d), rays.times.reshape(-1).contiguous()


def phase12_b4(dev, cfg, model, data):
    """B4 against its twin in both modes and operand types, and its times at
    the main paths' shapes. Returns the two [kernel] rows (launches filled
    in by the main paths)."""
    import torch

    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.sampling import sample_along_rays

    sd = model.state_dict()
    rays, _ = frame_rays(dev, data, "test", 0)
    idx = torch.arange(4096, device=dev) * (TNERF_SIZE**2 // 4096)  # spread over the frame: objects and background
    r4k = type(rays)(*(x[idx] for x in rays))
    o, d, ve, z, dist, t = tnerf_pass_inputs(r4k, cfg, sample_along_rays(r4k.near, r4k.far, 64, 0.0))
    fwd_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        packed = b3.pack_tnerf_params(sd, cfg, dtype)
        got = b3.render_pass(packed, o, d, ve, z, dist, None, True, t)
        ref = b3.render_pass_plain(packed, o, d, ve, z, dist, None, True, t)
        torch.cuda.synchronize()
        drgb = (got.rgb - ref.rgb).abs()
        dacc = (got.acc - ref.acc).abs().max().item()
        depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
        tag = "fp32" if dtype == torch.float32 else "bf16"
        print(f"[12 B4 fwd {tag}] N=4096 S=64 t={float(t[0]):.3f}: max|drgb|={drgb.max().item():.3e} "
              f"mean|drgb|={drgb.mean().item():.3e} max|dacc|={dacc:.3e} "
              f"max|ddepth|={(got.depth - ref.depth).abs().max().item():.3e} depth_within_rtol={depth_ok} "
              f"max|dw|={(got.weights - ref.weights).abs().max().item():.3e}")
        if dtype == torch.float32:
            if drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok:
                fail("B4 forward fp32 outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
        else:
            fwd_err = drgb.max().item()
            if fwd_err > 1e-2 or drgb.mean().item() > 1e-3:
                fail("B4 forward bf16: max |drgb| > 1e-2 or mean > 1e-3")

    # train mode: 500 seeded pixels of train view 37 at its frame time, noise std 1
    n, scale = 500, 1.0 / 1500
    rays, img = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(0)
    sel = torch.randint(0, img.shape[0], (n,), generator=g, device=dev)
    r500 = type(rays)(*(x[sel] for x in rays))
    target = img[sel].contiguous()
    z = sample_along_rays(r500.near, r500.far, 64, 1.0, generator=g)
    noise = torch.randn(z.shape, generator=g, device=dev)
    o, d, ve, z, dist, t = tnerf_pass_inputs(r500, cfg, z)
    args = (o, d, ve, z, dist, noise, target)
    p32 = b3.pack_tnerf_params(sd, cfg, torch.float32)
    got, gk = b1.render_loss(p32, *args, True, scale, t)
    ref, gr = b1.render_loss_plain(p32, *args, True, scale, t)
    p64 = b3.pack_tnerf_params(sd, cfg, torch.float64)
    _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), True, scale, t.double())
    torch.cuda.synchronize()
    drgb = (got.rgb - ref.rgb).abs().max().item()
    sq_ok = torch.allclose(got.sqerr, ref.sqerr, rtol=1e-4, atol=1e-7)
    depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
    print(f"[12 B4 train fp32] N=500 S=64 t={float(t[0]):.4f}: max|drgb|={drgb:.3e} "
          f"max|dsqerr|={(got.sqerr - ref.sqerr).abs().max().item():.3e} sqerr_within_rtol={sq_ok} "
          f"depth_within_rtol={depth_ok}")
    if drgb > 1e-4 or not sq_ok or not depth_ok:
        fail("B4 train fp32 outputs outside rgb 1e-4, sqerr rtol 1e-4 (atol 1e-7), depth rtol 1e-4")
    check_fp32_grads("12 B4 train fp32", b1.unpack_tnerf_grads(gk, p32), b1.unpack_tnerf_grads(gr, p32),
                     b1.unpack_tnerf_grads(g64, p64))
    _, gk2 = b1.render_loss(p32, *args, True, scale, t)
    torch.cuda.synchronize()
    if not (torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])):
        fail("B4 train fp32: two launches gave different gradients")
    p16 = b3.pack_tnerf_params(sd, cfg, torch.bfloat16)
    got, gk = b1.render_loss(p16, *args, True, scale, t)
    ref, gr = b1.render_loss_plain(p16, *args, True, scale, t)
    _, gk2 = b1.render_loss(p16, *args, True, scale, t)
    torch.cuda.synchronize()
    diff = (got.rgb - ref.rgb).abs()
    rel = rel_l2(b1.unpack_tnerf_grads(gk, p16), b1.unpack_tnerf_grads(gr, p16))
    same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
    print(f"[12 B4 train bf16] max|drgb|={diff.max().item():.3e} mean|drgb|={diff.mean().item():.3e} "
          f"grads max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}")
    if diff.max().item() > 1e-2 or diff.mean().item() > 1e-3 or max(rel.values()) > 1e-2 or not same:
        fail("B4 train bf16: rgb max > 1e-2, mean > 1e-3, gradient rel L2 > 1e-2 or repeats differ")
    check_tc_forward("12 B4 train bf16", got, b3.render_pass(p16, o, d, ve, z, dist, noise, True, t))
    train_ms = cuda_ms(lambda: b1.render_loss(p16, *args, True, scale, t), 20)
    train_row = entry(
        "render_loss[tnerf,S=64]", "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
        0, diff.max().item(), train_ms,
        cuda_ms(lambda: b1.render_loss_plain(p16, *args, True, scale, t), 5),
        4 * (7 * n + ve.numel() + 3 * z.numel() + 3 * n) + 2 * p16.weights.numel() + 4 * p16.biases.numel()
        + 4 * (4 * n + z.numel()) + 4 * (p16.weights.numel() + p16.biases.numel()),
        2 * b1.train_macs_per_sample(p16) * z.numel(), "bf16",
    )
    report_sweep("12", "render_loss[tnerf,S=64] bf16", lambda: b1.render_loss(p16, *args, True, scale, t), train_ms,
                 train_row["bound_ms"], z.numel(), sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), dev,
                 fwd=forward_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad))

    # forward at the serving path's shape: the first 32,768-ray chunk of test view 0
    rays, _ = frame_rays(dev, data, "test", 0)
    chunk = rays.slice(0, 32768)
    o, d, ve, z, dist, t = tnerf_pass_inputs(chunk, cfg, sample_along_rays(chunk.near, chunk.far, 64, 0.0))
    got = b3.render_pass(p16, o, d, ve, z, dist, None, True, t)
    ref = b3.render_pass_plain(p16, o, d, ve, z, dist, None, True, t)
    drgb = (got.rgb - ref.rgb).abs()
    print(f"[12 check] render_pass[tnerf,S=64] bf16 N=32768: max|drgb|={drgb.max().item():.3e} "
          f"mean|drgb|={drgb.mean().item():.3e}")
    if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
        fail("B4 forward bf16 at the serving shape: max |drgb| > 1e-2 or mean > 1e-3")
    del got, ref
    nc = z.shape[0]
    fwd_row = entry(
        "render_pass[tnerf,S=64]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
        0, max(fwd_err, drgb.max().item()),
        cuda_ms(lambda: b3.render_pass(p16, o, d, ve, z, dist, None, True, t), 10),
        cuda_ms(lambda: b3.render_pass_plain(p16, o, d, ve, z, dist, None, True, t), 3),
        4 * (7 * nc + ve.numel() + 2 * z.numel() + 5 * nc + z.numel()) + 2 * p16.weights.numel(),
        2 * p16.macs_per_sample * z.numel(), "bf16",
    )
    comp, head = tc_shares("render_pass", lambda: b3.render_pass(p16, o, d, ve, z, dist, None, True, t))
    TC_SUMMARY["render_pass[tnerf,S=64] at the serving chunk"] = (
        f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
        "of the blocks' cycles")
    # the same body on a seeded vanilla field of the same width and depth
    # (ReLU, no time columns, 63 input columns: one atom) at the same rows
    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig

    vcfg = VanillaNeRFConfig(netdepth=8, netwidth=128)
    pv = b3.pack_params(VanillaNeRF(vcfg, device=dev, generator=torch.Generator().manual_seed(0),
                                    fused=False).state_dict(), vcfg, torch.bfloat16)
    vms = cuda_ms(lambda: b3.render_pass(pv, o, d, ve, z, dist, None, True), 10)
    print(f"[12 times] B4 forward (bf16, tensor cores) at the serving chunk: {fwd_row['ms']:.3f} ms "
          f"({2 * p16.macs_per_sample * z.numel() / fwd_row['ms'] / 1e9:.2f} TFLOP/s); B3 on a vanilla field at the "
          f"same W=128, D=8 and rows (ReLU, no time columns, {pv.cin} input columns): {vms:.3f} ms "
          f"({2 * pv.macs_per_sample * z.numel() / vms / 1e9:.2f} TFLOP/s)")
    del pv
    torch.cuda.empty_cache()
    return {"render_pass": fwd_row, "render_loss": train_row}


def phase13_step(dev, cfg, model, data):
    """The kernel T-NeRF step (B4) against the eager autograd step from the
    same state and draws; the eager step in float64 on the CPU is the
    gradient reference of check_fp32_grads."""
    import torch

    from swnerf_torch.models import TNeRF
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_tnerf_step
    from swnerf_torch.train.loop import init_train_state, make_train_step

    rays, img = frame_rays(dev, data, "train", 61)
    g = torch.Generator(device=dev).manual_seed(2)
    sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
    rays = Rays(*(x[sel] for x in rays))
    target = img[sel].contiguous()
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    draws = make_draws(rcfg, 500, torch.Generator(device=dev).manual_seed(3), dev)

    def fresh(device, dtype=torch.float32):
        m = TNeRF(cfg, device=device, fused=False)  # the eager step's reference: plain torch
        m.load_state_dict(model.state_dict())
        return init_train_state(m.to(dtype), None, 5e-4, 500, step=800000)

    def grads(st):
        return {k: p.grad.detach().clone() for k, p in st.coarse.named_parameters()}

    sk, se, s64 = fresh(dev), fresh(dev), fresh("cpu", torch.float64)
    mk = make_fused_tnerf_step(cfg, rcfg, compute_dtype=torch.float32)(sk, rays, target, draws=draws)
    me = make_train_step(rcfg)(se, rays, target, draws=draws)
    cpu64 = lambda x: None if x is None else x.detach().cpu().double()  # noqa: E731
    make_train_step(rcfg)(s64, Rays(*(cpu64(x) for x in rays)), cpu64(target), draws=Draws(*(cpu64(x) for x in draws)))
    torch.cuda.synchronize()
    dloss = abs(mk["loss"].item() - me["loss"].item()) / me["loss"].item()
    print(f"[13 step fp32] loss kernel {mk['loss'].item():.7f} eager {me['loss'].item():.7f} rel {dloss:.3e}; "
          f"psnr {mk['psnr'].item():.4f} vs {me['psnr'].item():.4f}")
    if dloss > 1e-5:
        fail(f"kernel T-NeRF step loss rel {dloss} > 1e-5")
    check_fp32_grads("13 step fp32", grads(sk), grads(se), grads(s64))
    sb = fresh(dev)
    mb = make_fused_tnerf_step(cfg, rcfg, compute_dtype=torch.bfloat16)(sb, rays, target, draws=draws)
    dl16 = abs(mb["loss"].item() - me["loss"].item()) / me["loss"].item()
    print(f"[13 step bf16] loss kernel {mb['loss'].item():.7f} vs fp32 eager: rel {dl16:.3e}")
    if dl16 > 1e-2:
        fail(f"bf16 kernel T-NeRF step loss rel {dl16} > 1e-2")
    del sk, se, s64, sb
    torch.cuda.empty_cache()


def phase14_serve(dev, cfg, tmp, data):
    """The serving main path through run_tnerf: 25 test frames at their
    times. Returns its launch counts and frame 0's PSNR."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_tnerf
    from swnerf_torch.render.core import RenderConfig, render_image
    from swnerf_torch.render.fused_eval import make_tnerf_eval_pass
    from swnerf_torch.utils.metrics import calculate_metrics

    launches.clear()
    t0 = time.perf_counter()
    savedir = Path(run_tnerf.main(tnerf_args(tmp, data, "--render_only", "--render_test")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    metrics = json.loads((savedir / "metrics.json").read_text())
    print(f"[14 main] launches {json.dumps(counts, sort_keys=True)} (25 frames), CLI wall {wall:.2f} s")
    if counts.get("render_pass[tnerf,S=64]", 0) <= 0:
        fail("the T-NeRF serving path launched no render_pass[tnerf,S=64]")
    secs = metrics["seconds_per_frame"]
    per_frame = sum(secs[1:]) / len(secs[1:])  # frame 0 is the warm-up
    print(f"[14 main] seconds per frame {[round(x, 4) for x in secs]}")
    n_rays = TNERF_SIZE**2
    print(f"[14 main] frames 1-24: {per_frame * 1e3:.2f} ms/frame, {n_rays / per_frame:.4g} rays/s, "
          f"{n_rays * 64 / per_frame:.4g} samples/s")
    unit = unit_range_psnr(metrics["psnr"], data)
    for i, (p, u, q) in enumerate(zip(metrics["psnr"], unit, metrics["ssim"])):
        print(f"[14 main] frame {i}: PSNR {p:.3f} dB (data range 1: {u:.3f} dB) SSIM {q:.4f}")
    mean_psnr, mean_unit = sum(metrics["psnr"]) / len(unit), sum(unit) / len(unit)
    print(f"[14 main] mean PSNR {mean_psnr:.3f} dB (data range 1: {mean_unit:.3f} dB; the reference run logged "
          f"21.596), mean SSIM {sum(metrics['ssim']) / len(unit):.4f} over {len(unit)} frames")
    if len(unit) != 25 or not mean_unit >= 20.5:
        fail(f"mean PSNR {mean_unit} (data range 1) < 20.5 dB (or not 25 frames)")

    # frame 0 again, the fp32 twin on the card
    from swnerf_torch.models import TNeRF
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    model = TNeRF(cfg, device=dev, fused=False)
    model.load_state_dict(tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"]))
    rays, img = frame_rays(dev, data, "test", 0)
    plain = make_tnerf_eval_pass(cfg, compute_dtype=torch.float32, plain=True)
    out = render_image(model, rays, RenderConfig(n_samples=64, white_bkgd=True), chunk=8192, eval_pass=plain)
    hw3 = (TNERF_SIZE, TNERF_SIZE, 3)
    psnr_plain = calculate_metrics(img.reshape(hw3).cpu().numpy(), out["rgb"].reshape(hw3).cpu().numpy())[0]
    dpsnr = abs(psnr_plain - metrics["psnr"][0])
    print(f"[14 plain fp32] frame 0 PSNR {psnr_plain:.3f} dB, |dPSNR| vs bf16 B4 {dpsnr:.4f} dB")
    if dpsnr > 0.1:
        fail(f"|dPSNR| {dpsnr} > 0.1 dB")
    del out

    stages = tnerf_frame_breakdown(dev, cfg, model, rays)
    total = sum(stages.values())
    print("[14 breakdown] frame 0, device ms by stage: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[14 breakdown] stage sum {total:.2f} ms vs timed frame {per_frame * 1e3:.2f} ms")
    del model
    torch.cuda.empty_cache()
    return counts, unit[0]


def tnerf_frame_breakdown(dev, cfg, model, rays, chunk=32768):
    """Device milliseconds of each stage of the T-NeRF eval pass over one
    frame, chunk by chunk as render_image runs it (after one warm-up)."""
    import torch

    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.sampling import sample_along_rays

    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.bfloat16)
    names = ("rays + z + view embedding", "B4", "disp")
    acc = dict.fromkeys(names, 0.0)
    n_all = rays.origins.shape[0]
    for rep in range(2):
        for start in range(0, n_all, chunk):
            tile = rays.slice(start, min(n_all, start + chunk))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            o, d, ve, z, dist, t = tnerf_pass_inputs(tile, cfg, sample_along_rays(tile.near, tile.far, 64, 0.0))
            ev[1].record()
            res = b3.render_pass(packed, o, d, ve, z, dist, None, True, t)
            ev[2].record()
            _ = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
            ev[3].record()
            torch.cuda.synchronize()
            if rep:
                for i, k in enumerate(names):
                    acc[k] += ev[i].elapsed_time(ev[i + 1])
    return acc


def phase15_train(dev, cfg, tmp, data):
    """The training main path through run_tnerf: 1,000 bf16 steps resumed
    from the copy of 800000.tar. Returns its launch counts."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_tnerf
    from swnerf_torch.train.checkpoint import load_tar

    os.environ["SWNERF_MAX_ITERS"] = "801001"
    buf = io.StringIO()
    try:
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_tnerf.main(tnerf_args(tmp, data, "--i_print", "100", "--i_weights", "500"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        os.environ.pop("SWNERF_MAX_ITERS", None)
    out = buf.getvalue()
    exp = tmp / "logs" / "full_tnerf_800k"
    print(f"[15 train] launches {json.dumps(counts, sort_keys=True)} (1000 steps), CLI wall {wall:.2f} s")
    if "Reloading from" not in out or "kernel T-NeRF train step" not in out or min(res["step_ms"]) != 800001:
        fail("the T-NeRF training run did not resume from 800000.tar at 800000 on the kernel step")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    print(f"[15 train] train PSNR at the prints: {psnrs}")
    if len(psnrs) != 10 or min(p for _, p in psnrs) < 19.0:
        fail(f"train PSNR below 19 dB at a print (or not 10 prints): {psnrs}")
    for i in (800500, 801000):
        ck = load_tar(str(exp / f"{i:06d}.tar"))
        steps = {int(e["step"]) for e in ck["optimizer_state_dict"]["state"].values()}
        print(f"[15 train] {i:06d}.tar keys {sorted(ck)} Adam step {steps} "
              f"({len(ck['optimizer_state_dict']['state'])} entries)")
        if set(ck) != {"global_step", "network_fn_state_dict", "optimizer_state_dict"} or steps != {i} \
                or ck["global_step"] != i:
            fail(f"{i:06d}.tar: keys {set(ck)}, Adam steps {steps}")
    if counts.get("render_loss[tnerf,S=64]", 0) != 1000:
        fail(f"the T-NeRF training path launched B4 {counts.get('render_loss[tnerf,S=64]', 0)} times, not 1000")
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % 100 and (i - 1) % 100}
    med = statistics.median(quiet.values())
    TNERF_STEP_MS["B4 kernel step (phase 15)"] = med
    print(f"[15 train] ms per step, median of {len(quiet)} steps that neither print nor save (CUDA events): "
          f"{med:.4f} ms (min {min(quiet.values()):.4f}, max {max(quiet.values()):.4f}); "
          f"{500 / med * 1e3:.4g} rays/s, {500 * 64 / med * 1e3:.4g} samples/s")
    stages = tnerf_step_breakdown(dev, cfg, data)
    total = sum(stages.values())
    print("[15 breakdown] one step, device ms by stage: " + ", ".join(
        f"{k} {v:.4f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[15 breakdown] stage sum {total:.3f} ms vs median step {med:.3f} ms")
    return counts


def tnerf_step_breakdown(dev, cfg, data):
    """Device milliseconds of each stage of one kernel T-NeRF step (bf16, the
    CLI's step), CUDA events between stages, after one warm-up step. The
    stages are those of train/fused_step.py::make_fused_tnerf_step and
    pipelines/common.py::make_time_image_step, written out here."""
    import numpy as np
    import torch

    from swnerf_torch.models import TNeRF
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.pipelines.common import ImageSampler, Scene
    from swnerf_torch.render.core import RenderConfig, build_rays, make_draws
    from swnerf_torch.train.fused_step import _set_grads
    from swnerf_torch.train.loop import init_train_state

    with open(data / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = TNERF_SIZE
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"]], np.float32)
    n_views = poses.shape[0]
    scene = Scene(images=np.zeros((n_views, 1, 1, 3), np.float32), poses=poses, render_poses=poses, H=H, W=W,
                  focal=focal, K=K, near=2.0, far=6.0, i_train=np.arange(n_views), i_val=np.arange(0),
                  i_test=np.arange(0))
    images = torch.rand((n_views, H, W, 3), device=dev)
    poses_dev = torch.as_tensor(poses[:, :3, :4], device=dev)
    times = torch.linspace(0, 1, n_views, device=dev)
    sampler = ImageSampler(scene, 500, 0, 0.5)
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    state = init_train_state(TNeRF(cfg, device=dev, fused=False), None, 5e-4, 500, graphs=True)
    g = torch.Generator(device=dev).manual_seed(0)
    names = ("host sampler + pixel upload", "rays + z + draws", "pack weights", "B4 train", "unpack + Adam")
    acc = dict.fromkeys(names, 0.0)
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        img_i, pixels = sampler.next(1000)
        pixels = torch.as_tensor(pixels, device=dev)
        ev[1].record()
        o, d = get_rays_at(pixels, H, W, K, poses_dev[img_i])
        target = images[img_i][pixels[:, 0], pixels[:, 1]].contiguous()
        r = build_rays(o, d, 2.0, 6.0, times=times[img_i].reshape(1, 1).expand(500, 1).contiguous())
        draws = make_draws(rcfg, 500, g, dev)
        z = sample_along_rays(r.near, r.far, 64, 1.0, t_rand=draws.t_rand).contiguous()
        ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
        ev[2].record()
        state.zero_grad()
        pk = b3.pack_tnerf_params(state.coarse.state_dict(), cfg, torch.bfloat16)
        ev[3].record()
        _, gr = b1.render_loss(pk, r.origins, r.directions, ve, z, b3_dists(z, r.directions),
                               draws.noise0.contiguous(), target, True, 1.0 / 1500, r.times.reshape(-1).contiguous())
        ev[4].record()
        _set_grads(state.coarse, b1.unpack_tnerf_grads(gr, pk))
        state.apply_update()
        ev[5].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                acc[k] = ev[i].elapsed_time(ev[i + 1])
    return acc


def phase16_serve(tmp, data, psnr_before):
    """Test frame 0 rendered from the trained 801000.tar by the serving CLI
    (--testskip 25 keeps test frame 0 only)."""
    from swnerf_torch.pipelines import run_tnerf

    savedir = Path(run_tnerf.main(tnerf_args(tmp, data, "--render_only", "--render_test", "--testskip", "25")))
    metrics = json.loads((savedir / "metrics.json").read_text())
    psnr = unit_range_psnr(metrics["psnr"], data)[0]
    print(f"[16 serve] frame 0 from 801000.tar ({savedir.name}): PSNR {psnr:.3f} dB on data range 1 "
          f"({metrics['psnr'][0]:.3f} dB in metrics.json) SSIM {metrics['ssim'][0]:.4f}; from 800000.tar "
          f"{psnr_before:.3f} dB (delta {psnr - psnr_before:+.3f} dB)")
    if savedir.name != "renderonly_test_801000" or not psnr >= 20.0 or abs(psnr - psnr_before) > 0.5:
        fail(f"frame 0 from 801000.tar: {psnr} dB (< 20 dB or more than 0.5 dB from {psnr_before})")


# ---------------------------------------------------------------- D-NeRF phases


def dnerf_phases(dev, tmp, data):
    """Phases 17-22 on phase 11's scene. Returns the [kernel] rows of B6
    (forward, backward), B3's pts mode and B5."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.pipelines.run_dnerf import _model_config
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.utils.config import config_parser_dnerf

    args = config_parser_dnerf().parse_args(["--config", str(DNERF_CONFIG)])
    cfg = _model_config(args, args.netdepth, args.netwidth)  # D=8, W=256, skip 4, multires 10/4
    model = DirectTemporalNeRF(cfg, device=dev)
    model.load_state_dict(dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"]))
    model.eval()
    inputs = dnerf_train_inputs(dev, cfg, model.state_dict(), data)
    rows = phase17_b6(dev, cfg, model.state_dict(), inputs)
    rows.update(phase18_pts(dev, cfg, model.state_dict(), inputs, data))
    phase19_step(dev, cfg, model, data)
    del model, inputs
    torch.cuda.empty_cache()
    exp = tmp / "logs" / "full_dnerf_800k"  # the config's expname: the copy is the newest .tar there
    exp.mkdir(parents=True)
    shutil.copy(DNERF_CKPT, exp / "800000.tar")
    serve_counts, psnr5 = phase20_serve(dev, cfg, tmp, data)
    train_counts = phase21_train(dev, cfg, tmp, data)
    phase22_serve(tmp, data, psnr5)
    for k, row in rows.items():
        row["launches"] = serve_counts.get(k, 0) + train_counts.get(k, 0)
        print(f"[18 kernel] {row['name']}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} -> {100 * row['bound_ms'] / row['ms']:.2f}% of the "
              f"bound, {serve_counts.get(k, 0)} launches serving 5 frames, {train_counts.get(k, 0)} in 200 steps")
    return list(rows.values())


def dnerf_args(tmp, data, *extra):
    return ["--config", str(DNERF_CONFIG), "--basedir", str(tmp / "logs"), "--datadir", str(data),
            "--device", "cuda", *extra]


def jitter(w, seed=0):
    """w * (1 + 2^-20 N(0, 1)): a perturbation of the size of the rounding
    that an fp32 dot product of length 256 accumulates (2^-24 sqrt(256))."""
    import torch

    g = torch.Generator(device=w.device).manual_seed(seed)
    return w * (1 + 2.0**-20 * torch.randn(w.shape, generator=g, device=w.device, dtype=w.dtype))


def dnerf_train_inputs(dev, cfg, sd, data):
    """500 seeded pixels of train view 37 at its frame time: the coarse
    points (S=64, jittered), the fine points (S=192, from a B2 pass on the
    fp32 twins' coarse weights), their dx by the fp32 B6 twin, noise std 1,
    the view embedding and the target colours."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.render.fused_eval import canonical_params

    n = 500
    rays, img = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(0)
    sel = torch.randint(0, img.shape[0], (n,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    o, d = r.origins, r.directions
    t = r.times.reshape(-1).contiguous()
    ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
    tn32 = b6.pack_time_params(sd, cfg, torch.float32)
    canon32 = b3.pack_params(canonical_params(sd), cfg, torch.float32)
    z64 = sample_along_rays(r.near, r.far, 64, 1.0, generator=g).contiguous()
    noise64 = torch.randn(z64.shape, generator=g, device=dev)
    pts_c = (o[:, None, :] + d[:, None, :] * z64[..., None]).contiguous()
    dx_c = b6.time_net_plain(tn32, pts_c, t)
    w64 = b3.render_pass_plain(canon32, None, None, ve, z64, b3_dists(z64, d), noise64, True, None,
                               (pts_c + dx_c).contiguous()).weights
    u = torch.rand((n, 128), generator=g, device=dev)
    zf = merge_z_vals(z64, b2.sample_pdf((0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous(), w64[:, 1:-1], u))
    zf = zf.contiguous()
    noise192 = torch.randn(zf.shape, generator=g, device=dev)
    pts_f = (o[:, None, :] + d[:, None, :] * zf[..., None]).contiguous()
    return {
        "times": t, "ve": ve, "d": d, "target": img[sel].contiguous(),
        64: (pts_c, dx_c, z64, noise64), 192: (pts_f, b6.time_net_plain(tn32, pts_f, t), zf, noise192),
    }


def phase17_b6(dev, cfg, sd, inputs):
    """B6 against its twin on the coarse and fine points; its times (forward
    at the serving chunk's fine shape, backward at the TV pair's 2 x 500 x
    192 rows). Returns its two [kernel] rows."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import time_net as b6

    t = inputs["times"]
    g = torch.Generator(device=dev).manual_seed(4)
    err16 = 0.0
    for S in (64, 192):
        pts = inputs[S][0]
        cot = torch.randn(pts.shape, generator=g, device=dev)
        p32 = b6.pack_time_params(sd, cfg, torch.float32)
        dx, gk = b6.time_net_fwd_bwd(p32, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p32, pts, t, cot)
        ref = b6.time_net_plain(p32, pts, t)
        gr = b6.time_net_plain_bwd(p32, pts, t, cot)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        g64 = b6.time_net_plain_bwd(p64, pts.double(), t.double(), cot.double())
        g64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), pts.double(),
                                     t.double(), cot.double())
        torch.cuda.synchronize()
        ddx = (dx - ref).abs().max().item()
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        print(f"[17 B6 fp32 S={S}] rows {pts.shape[0] * S}: max|ddx|={ddx:.3e} (max|dx| "
              f"{ref.abs().max().item():.3e}) repeat bit-equal={same}")
        if ddx > 1e-5 or not same:
            fail(f"B6 fp32 S={S}: max |ddx| {ddx} > 1e-5 or repeats differ")
        check_fp32_grads(f"17 B6 fp32 S={S}", *(b6.unpack_time_grads(x, p32) for x in (gk, gr, g64, g64p)))
        p16 = b6.pack_time_params(sd, cfg, torch.bfloat16)
        dx, gk = b6.time_net_fwd_bwd(p16, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p16, pts, t, cot)
        ref, gr = b6.time_net_plain(p16, pts, t), b6.time_net_plain_bwd(p16, pts, t, cot)
        torch.cuda.synchronize()
        ddx = (dx - ref).abs().max().item()
        rel = rel_l2(b6.unpack_time_grads(gk, p16), b6.unpack_time_grads(gr, p16))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        print(f"[17 B6 bf16 S={S}] max|ddx|={ddx:.3e} grads max rel L2={max(rel.values()):.3e} "
              f"({max(rel, key=rel.get)}) repeat bit-equal={same}")
        if ddx > 1e-2 or max(rel.values()) > 1e-2 or not same:
            fail(f"B6 bf16 S={S}: max |ddx| > 1e-2, gradient rel L2 > 1e-2 or repeats differ")
        err16 = max(err16, ddx)
        del gk, gk2, gr, g64, g64p
    torch.cuda.empty_cache()

    # the backward at the TV pair's shape: the fine points at t and at a neighbour time
    p16 = b6.pack_time_params(sd, cfg, torch.bfloat16)
    pts = inputs[192][0]
    pair = torch.cat([pts, pts]).contiguous()
    t2 = torch.cat([t, torch.full_like(t, 0.41)]).contiguous()
    m = pair.shape[0] * pair.shape[1]
    cot = torch.randn((m, 3), generator=g, device=dev)
    scratch = b6._scratch(p16, m, dev)
    b6._launch_fwd(p16, pair, t2, scratch)
    bwd_ms = cuda_ms(lambda: b6._launch_bwd(p16, m, cot, scratch), 10)
    bwd_plain = cuda_ms(lambda: b6.time_net_plain_bwd(p16, pair, t2, cot), 2)
    bwd_row = entry(
        "time_net[bwd]", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:480", 0, err16,
        bwd_ms, bwd_plain, 4 * (3 * m + 3 * m + pair.shape[0]) + 2 * p16.weights.numel() + 4 * p16.weights.numel(),
        2 * p16.bwd_macs_per_row * m, "bf16",
    )
    report_sweep("17", "time_net[bwd] bf16, the TV pair", lambda: b6._launch_bwd(p16, m, cot, scratch), bwd_ms,
                 bwd_row["bound_ms"], m, sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad), dev)
    del scratch
    torch.cuda.empty_cache()
    return {"time_net[bwd]": bwd_row}


def phase18_pts(dev, cfg, sd, inputs, data):
    """B3's pts mode and B5 against their twins on pts + dx of the phase 17
    rays; then B6 and B3's pts mode at the serving chunk's shapes. Returns
    the [kernel] rows of B6's forward, B3's pts mode (S=64, 192) and B5."""
    import dataclasses

    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.render.fused_eval import canonical_params

    n, scale = 500, 1.0 / 1500
    ve, d, target = inputs["ve"], inputs["d"], inputs["target"]
    canon = canonical_params(sd)
    fwd_err, rows = {}, {}
    for S in (64, 192):
        pts, dx, z, noise = inputs[S]
        warped = (pts + dx).contiguous()
        dist = b3_dists(z, d)
        for dtype in (torch.float32, torch.bfloat16):
            packed = b3.pack_params(canon, cfg, dtype)
            got = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, warped)
            ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, warped)
            torch.cuda.synchronize()
            drgb = (got.rgb - ref.rgb).abs()
            dacc = (got.acc - ref.acc).abs().max().item()
            depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"[18 B3 pts {tag} S={S}] max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} "
                  f"max|dacc|={dacc:.3e} depth_within_rtol={depth_ok}")
            if dtype == torch.float32:
                if drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok:
                    fail(f"B3 pts fp32 S={S} outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
            else:
                fwd_err[S] = drgb.max().item()
                if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
                    fail(f"B3 pts bf16 S={S}: max |drgb| > 1e-2 or mean > 1e-3")

        args = (ve, z, dist, noise, target)
        p32 = b3.pack_params(canon, cfg, torch.float32)
        got, gk, dk = b1.render_loss_pts(p32, warped, *args, True, scale)
        ref, gr, dr = b1.render_loss_pts_plain(p32, warped, *args, True, scale)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        a64 = tuple(x.double() for x in args)
        _, g64, d64 = b1.render_loss_pts_plain(p64, warped.double(), *a64, True, scale)
        _, g64p, d64p = b1.render_loss_pts_plain(dataclasses.replace(p64, weights=jitter(p64.weights)),
                                                 warped.double(), *a64, True, scale)
        _, gk2, dk2 = b1.render_loss_pts(p32, warped, *args, True, scale)
        torch.cuda.synchronize()
        drgb = (got.rgb - ref.rgb).abs().max().item()
        sq_ok = torch.allclose(got.sqerr, ref.sqerr, rtol=1e-4, atol=1e-7)
        depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        print(f"[18 B5 fp32 S={S}] max|drgb|={drgb:.3e} max|dsqerr|={(got.sqerr - ref.sqerr).abs().max().item():.3e} "
              f"sqerr_within_rtol={sq_ok} depth_within_rtol={depth_ok} max|ddpts|={(dk - dr).abs().max().item():.3e} "
              f"(max|dpts| {dr.abs().max().item():.3e}) repeat bit-equal={same}")
        if drgb > 1e-4 or not sq_ok or not depth_ok or not same:
            fail(f"B5 fp32 S={S}: outputs outside rgb 1e-4, sqerr/depth rtol 1e-4, or repeats differ")
        check_fp32_grads(f"18 B5 fp32 S={S}", *(dict(b1.unpack_grads(gg, pp), dpts=dd) for gg, dd, pp in (
            (gk, dk, p32), (gr, dr, p32), (g64, d64, p64), (g64p, d64p, p64))))
        del g64, g64p, gr, gk2
        p16 = b3.pack_params(canon, cfg, torch.bfloat16)
        got, gk, dk = b1.render_loss_pts(p16, warped, *args, True, scale)
        ref, gr, dr = b1.render_loss_pts_plain(p16, warped, *args, True, scale)
        _, gk2, dk2 = b1.render_loss_pts(p16, warped, *args, True, scale)
        torch.cuda.synchronize()
        diff = (got.rgb - ref.rgb).abs()
        rel = rel_l2(dict(b1.unpack_grads(gk, p16), dpts=dk), dict(b1.unpack_grads(gr, p16), dpts=dr))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        print(f"[18 B5 bf16 S={S}] max|drgb|={diff.max().item():.3e} mean|drgb|={diff.mean().item():.3e} "
              f"grads and dpts max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}")
        if diff.max().item() > 1e-2 or diff.mean().item() > 1e-3 or max(rel.values()) > 1e-2 or not same:
            fail(f"B5 bf16 S={S}: rgb max > 1e-2, mean > 1e-3, gradient rel L2 > 1e-2 or repeats differ")
        ordered = b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped, ordered=True)
        torch.cuda.synchronize()
        fwd_same = all(torch.equal(getattr(got, k), getattr(ordered, k)) for k in ("rgb", "acc", "depth", "weights"))
        print(f"[18 B5 bf16 S={S}] forward (rgb, acc, depth, weights) bit-equal to B3's ordered pts launch={fwd_same}")
        if not fwd_same:
            fail(f"B5 bf16 S={S}: its forward differs from B3's ordered pts launch")
        del ordered
        if S == 192:  # the training main path's B5 launch: shared model, fine pass only
            simt_forward("18", "B5 (render_loss[pts]) 500 x 192", lambda: b1.render_loss_pts(p16, warped, *args, True,
                                                                                             scale),
                         2 * p16.macs_per_sample * z.numel())
            nbytes = (4 * (3 * warped.numel() // 3 * 3 + ve.numel() + 3 * z.numel() + 3 * n)
                      + 2 * p16.weights.numel() + 4 * p16.biases.numel()
                      + 4 * (4 * n + z.numel() + warped.numel()) + 4 * (p16.weights.numel() + p16.biases.numel()))
            rows["render_loss[pts,S=192]"] = entry(
                "render_loss[pts,S=192]", "swnerf_torch/csrc/render_loss.cu",
                "swnerf_tpu/ops/pallas/render_fused.py:276", 0, diff.max().item(),
                cuda_ms(lambda: b1.render_loss_pts(p16, warped, *args, True, scale), 20),
                cuda_ms(lambda: b1.render_loss_pts_plain(p16, warped, *args, True, scale), 5),
                nbytes, 2 * b1.pts_train_macs_per_sample(p16) * z.numel(), "bf16",
            )
            row = rows["render_loss[pts,S=192]"]
            report_sweep("18", "render_loss[pts,S=192] bf16",
                         lambda: b1.render_loss_pts(p16, warped, *args, True, scale), row["ms"], row["bound_ms"],
                         z.numel(), sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad, demb=True), dev)
        del gk, gk2, gr, got, ref
        torch.cuda.empty_cache()

    # the serving path's chunk: the first 32,768 rays of test frame 5 at its time, bf16
    rays, _ = frame_rays(dev, data, "test", 5)
    chunk = rays.slice(0, 32768)
    o, d = chunk.origins.contiguous(), chunk.directions.contiguous()
    t = chunk.times.reshape(-1).contiguous()
    ve = positional_encoding(chunk.viewdirs, cfg.nf_views).contiguous()
    tn16, c16 = b6.pack_time_params(sd, cfg), b3.pack_params(canon, cfg)
    z = sample_along_rays(chunk.near, chunk.far, 64, 0.0).contiguous()
    nc = z.shape[0]
    serve = {}
    for S in (64, 192):
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        dx = b6.time_net(tn16, pts, t)
        ddx = (dx - b6.time_net_plain(tn16, pts, t)).abs().max().item()
        warped = (pts + dx).contiguous()
        dist = b3_dists(z, d)
        got = b3.render_pass(c16, None, None, ve, z, dist, None, True, None, warped)
        ref = b3.render_pass_plain(c16, None, None, ve, z, dist, None, True, None, warped)
        drgb = (got.rgb - ref.rgb).abs()
        print(f"[18 check] time_net bf16 rows {pts.shape[0] * S}: max|ddx|={ddx:.3e}; render_pass[pts,S={S}] bf16 "
              f"N={nc}: max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e}")
        if ddx > 1e-2 or drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
            fail(f"B6 / B3 pts bf16 S={S} at the serving shape: max |ddx| > 1e-2, max |drgb| > 1e-2 or mean > 1e-3")
        serve[S] = (pts, warped, z, dist, max(fwd_err[S], drgb.max().item()), ddx)
        if S == 64:
            u = torch.linspace(0.0, 1.0, 128, device=dev).expand(nc, 128)
            zs = b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), got.weights[:, 1:-1], u)
            z = merge_z_vals(z, zs).contiguous()
        del got, ref
    for S, (pts, warped, zz, dist, err, _) in serve.items():
        rows[f"render_pass[pts,S={S}]"] = entry(
            f"render_pass[pts,S={S}]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            0, err, cuda_ms(lambda: b3.render_pass(c16, None, None, ve, zz, dist, None, True, None, warped), 3),
            cuda_ms(lambda: b3.render_pass_plain(c16, None, None, ve, zz, dist, None, True, None, warped), 2),
            4 * (warped.numel() + ve.numel() + 2 * zz.numel() + 5 * nc + zz.numel()) + 2 * c16.weights.numel(),
            2 * c16.macs_per_sample * zz.numel(), "bf16",
        )
        torch.cuda.empty_cache()
    pts, _, _, _, _, ddx = serve[192]
    _, head = tc_shares("time_net", lambda: b6.time_net(tn16, pts, t))
    TC_SUMMARY["time_net at the serving chunk's fine rows"] = f"head {100 * head:.2f}% of the blocks' cycles"
    pts64, warped64, z64, dist64 = serve[64][:4]
    comp, head = tc_shares("render_pass", lambda: b3.render_pass(c16, None, None, ve, z64, dist64, None, True, None,
                                                                 warped64))
    TC_SUMMARY["render_pass[pts,S=64] at the serving chunk"] = (
        f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
            "of the blocks' cycles")
    del pts64, warped64, z64, dist64
    m = pts.shape[0] * pts.shape[1]
    rows["time_net"] = entry(
        "time_net", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:470", 0, ddx,
        cuda_ms(lambda: b6.time_net(tn16, pts, t), 3), cuda_ms(lambda: b6.time_net_plain(tn16, pts, t), 2),
        4 * (3 * m + nc + 3 * m) + 2 * tn16.weights.numel(), 2 * tn16.macs_per_row * m, "bf16",
    )
    report_library("18", "time_net bf16 forward, the serving chunk's fine rows", m,
                   forward_products(tn16.W, tn16.D, tn16.skip, tn16.cin_pad), rows["time_net"]["ms"], dev)
    del serve
    torch.cuda.empty_cache()
    return rows


def phase19_step(dev, cfg, model, data):
    """The kernel D-NeRF step (B6, B3's pts mode, B5, B2; shared model, TV
    on, noise std 1) against the eager autograd step from the same state and
    draws; the eager step in float64 on the CPU (and once more on weights
    perturbed at fp32's size) is the reference of the fallbacks."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_dnerf_step
    from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step

    rays, img = frame_rays(dev, data, "train", 61)
    g = torch.Generator(device=dev).manual_seed(2)
    sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
    rays = Rays(*(x[sel] for x in rays))
    target = img[sel].contiguous()
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0,
                        coarse_contributes=False)
    draws = make_draws(rcfg, 500, torch.Generator(device=dev).manual_seed(3), dev)
    t_n, tv_w = 0.41, 1e-4  # a neighbour time between frames; the config's TV weight

    def fresh(device=dev, dtype=torch.float32, perturb=False):  # the plain route: the eager step is the reference
        m = DirectTemporalNeRF(cfg, device=device, fused=False)
        m.load_state_dict(model.state_dict())
        m = m.to(dtype)
        if perturb:
            with torch.no_grad():
                for p in m.parameters():
                    p.copy_(jitter(p))
        return init_train_state(m, None, 5e-4, 500, step=800000)

    def grads(st):
        return {k: p.grad.detach().clone() for k, p in st.coarse.named_parameters()}

    def eager(st, device=dev, dtype=torch.float32):
        cast = lambda x: None if x is None else x.to(device=device, dtype=dtype)  # noqa: E731
        return make_dnerf_train_step(rcfg, True, tv_w)(st, Rays(*(cast(x) for x in rays)), cast(target), t_n,
                                                       draws=Draws(*(cast(x) for x in draws)))

    # the float64 references run on the CPU: B2 (which the eager step reaches on the card) takes fp32
    sk, se = fresh(), fresh()
    s64, s64p = fresh("cpu", torch.float64), fresh("cpu", torch.float64, True)
    launches.clear()
    mk = make_fused_dnerf_step(cfg, rcfg, add_tv_loss=True, tv_loss_weight=tv_w, compute_dtype=torch.float32)(
        sk, rays, target, t_n, draws=draws)
    counts = dict(launches)
    me, m64, m64p = eager(se), eager(s64, "cpu", torch.float64), eager(s64p, "cpu", torch.float64)
    torch.cuda.synchronize()
    lk, le, l64, l64p = (m["total_loss"].item() for m in (mk, me, m64, m64p))
    dloss = abs(lk - le) / le
    print(f"[19 step fp32] launches {json.dumps(counts, sort_keys=True)}; total_loss kernel {lk:.8f} eager {le:.8f} "
          f"rel {dloss:.3e}; float64 eager {l64:.8f} (perturbed {l64p:.8f}); tv kernel {mk['tv'].item():.4e} eager "
          f"{me['tv'].item():.4e}; psnr {mk['psnr'].item():.4f} vs {me['psnr'].item():.4f}")
    if dloss > 1e-5 and abs(lk - l64) > 2 * max(abs(le - l64), abs(l64p - l64)):
        fail(f"kernel D-NeRF step loss rel {dloss} > 1e-5, and further from the float64 step than fp32 moves it")
    check_fp32_grads("19 step fp32", grads(sk), grads(se), grads(s64), grads(s64p))
    del sk, s64, s64p
    sb = fresh()
    mb = make_fused_dnerf_step(cfg, rcfg, add_tv_loss=True, tv_loss_weight=tv_w, compute_dtype=torch.bfloat16)(
        sb, rays, target, t_n, draws=draws)
    dl16 = abs(mb["total_loss"].item() - le) / le
    print(f"[19 step bf16] total_loss kernel {mb['total_loss'].item():.8f} vs fp32 eager: rel {dl16:.3e}")
    if dl16 > 1e-2:
        fail(f"bf16 kernel D-NeRF step loss rel {dl16} > 1e-2")
    del se, sb
    torch.cuda.empty_cache()


def dnerf_unit_psnr(psnrs, data, frames):
    """unit_range_psnr for the test frames ``frames`` (``--testskip`` keeps a
    stride of the test split)."""
    import math

    out = []
    for p, i in zip(psnrs, frames):
        img = gt_image(data, "test", i)[2]
        out.append(p - 20.0 * math.log10(float(img.max() - img.min())))
    return out


def phase20_serve(dev, cfg, tmp, data):
    """The D-NeRF serving main path through run_dnerf: test frames 0, 5,
    10, 15 and 20 at their times. Returns its launch counts and frame 5's
    PSNR (data range 1)."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_dnerf
    from swnerf_torch.render.core import RenderConfig, render_image
    from swnerf_torch.render.fused_eval import make_dnerf_eval_pass
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.utils.metrics import calculate_metrics

    launches.clear()
    t0 = time.perf_counter()
    savedir = Path(run_dnerf.main(dnerf_args(tmp, data, "--render_only", "--render_test", "--testskip", "5")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    metrics = json.loads((savedir / "metrics.json").read_text())
    print(f"[20 main] launches {json.dumps(counts, sort_keys=True)} (5 frames), CLI wall {wall:.2f} s")
    for key in ("time_net", "render_pass[pts,S=64]", "render_pass[pts,S=192]", "sample_pdf"):
        if counts.get(key, 0) <= 0:
            fail(f"the D-NeRF serving path launched no {key}")
    secs = metrics["seconds_per_frame"]
    per_frame = sum(secs[1:]) / len(secs[1:])  # frame 0 is the warm-up
    n_rays = TNERF_SIZE**2
    print(f"[20 main] seconds per frame {[round(x, 4) for x in secs]}")
    print(f"[20 main] frames 5-20: {per_frame * 1e3:.2f} ms/frame, {n_rays / per_frame:.4g} rays/s, "
          f"{n_rays * (64 + 192) / per_frame:.4g} samples/s (canonical samples)")
    TC_SUMMARY["D-NeRF serving (phase 20)"] = f"{per_frame * 1e3:.2f} ms per frame"
    ref = json.loads(DNERF_RESULT.read_text())["test_frames"]
    unit = dnerf_unit_psnr(metrics["psnr"], data, DNERF_FRAMES)
    for i, p, u, q in zip(DNERF_FRAMES, metrics["psnr"], unit, metrics["ssim"]):
        print(f"[20 main] test frame {i}: PSNR {p:.3f} dB (data range 1: {u:.3f} dB; the reference {ref[i]:.3f}, "
              f"delta {u - ref[i]:+.3f}) SSIM {q:.4f}")
    print(f"[20 main] mean PSNR (data range 1) {sum(unit) / len(unit):.3f} dB over frames {DNERF_FRAMES}; the "
          f"reference's mean over them {sum(ref[i] for i in DNERF_FRAMES) / 5:.3f} dB")

    model = DirectTemporalNeRF(cfg, device=dev)
    model.load_state_dict(dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"]))
    model.eval()
    # The reference's per-frame values were taken at its evaluator's own sample counts
    # (benchmarks/parity_vs_torch.py::eval_ckpt, PARITY_SAMPLES = 32: 32 + 32): the like-for-like
    # render, through the same bf16 eval pass, is held within 0.5 dB of them; the CLI's 64 + 128
    # samples must not fall more than 0.5 dB below them.
    ep16 = make_dnerf_eval_pass(cfg)
    at32 = []
    for i in DNERF_FRAMES:
        rays, img = frame_rays(dev, data, "test", i)
        out = render_image(model, rays, RenderConfig(n_samples=32, n_importance=32, white_bkgd=True), chunk=32768,
                           eval_pass=ep16)
        hw3 = (TNERF_SIZE, TNERF_SIZE, 3)
        at32.append(calculate_metrics(img.reshape(hw3).cpu().numpy(), out["rgb"].reshape(hw3).cpu().numpy())[0])
    at32 = dnerf_unit_psnr(at32, data, DNERF_FRAMES)
    print(f"[20 main] at 32 + 32 samples (the reference evaluator's), data range 1: "
          f"{[round(x, 3) for x in at32]} vs the reference {[round(ref[i], 3) for i in DNERF_FRAMES]} "
          f"(deltas {[round(x - ref[i], 3) for x, i in zip(at32, DNERF_FRAMES)]})")
    bad = [i for i, u, a in zip(DNERF_FRAMES, unit, at32) if not (abs(a - ref[i]) <= 0.5 and u >= ref[i] - 0.5)]
    if len(unit) != 5 or bad:
        fail(f"test frames {bad}: at 32 + 32 samples more than 0.5 dB from the reference's PSNR, or at 64 + 128 "
             f"more than 0.5 dB below it")

    # frame 5 again, the fp32 twins on the card
    rays, img = frame_rays(dev, data, "test", 5)
    plain = make_dnerf_eval_pass(cfg, compute_dtype=torch.float32, plain=True)
    out = render_image(model, rays, RenderConfig(n_samples=64, n_importance=128, white_bkgd=True), chunk=8192,
                       eval_pass=plain)
    hw3 = (TNERF_SIZE, TNERF_SIZE, 3)
    psnr_plain = calculate_metrics(img.reshape(hw3).cpu().numpy(), out["rgb"].reshape(hw3).cpu().numpy())[0]
    dpsnr = abs(psnr_plain - metrics["psnr"][1])
    print(f"[20 plain fp32] test frame 5 PSNR {psnr_plain:.3f} dB, |dPSNR| vs the bf16 kernels {dpsnr:.4f} dB")
    if dpsnr > 0.1:
        fail(f"|dPSNR| {dpsnr} > 0.1 dB")
    del out
    torch.cuda.empty_cache()
    stages = dnerf_frame_breakdown(dev, cfg, model, rays)
    total = sum(stages.values())
    print("[20 breakdown] test frame 5, device ms by stage: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[20 breakdown] stage sum {total:.2f} ms vs timed frame {per_frame * 1e3:.2f} ms")
    del model
    torch.cuda.empty_cache()
    return counts, unit[1]


def dnerf_frame_breakdown(dev, cfg, model, rays, chunk=32768):
    """Device milliseconds of each stage of the D-NeRF eval pass
    (render/fused_eval.py::DNeRFEvalPass, written out) over one frame, chunk
    by chunk as render_image runs it, after one warm-up."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.render.fused_eval import canonical_params

    sd = model.state_dict()
    canon, tnet = b3.pack_params(canonical_params(sd), cfg), b6.pack_time_params(sd, cfg)
    names = ("rays + z + view embedding", "coarse B6", "coarse mask + warp", "coarse B3 pts", "B2", "sort merge",
             "fine B6", "fine mask + warp", "fine B3 pts", "disp")
    acc = dict.fromkeys(names, 0.0)
    n_all = rays.origins.shape[0]
    for rep in range(2):
        for start in range(0, n_all, chunk):
            tile = rays.slice(start, min(n_all, start + chunk))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            o, d = tile.origins.contiguous(), tile.directions.contiguous()
            ve = positional_encoding(tile.viewdirs, cfg.nf_views).contiguous()
            t = tile.times.reshape(-1).contiguous()
            z = sample_along_rays(tile.near, tile.far, 64, 0.0).contiguous()
            ev[1].record()

            def one(zz, k):  # B6, the t == 0 mask and the warp, B3's pts mode; events k, k + 1, k + 2
                pts = (o[:, None, :] + d[:, None, :] * zz[..., None]).contiguous()
                dx = b6.time_net(tnet, pts, t)
                ev[k].record()
                warped = (pts + torch.where((t == 0.0)[:, None, None], torch.zeros_like(dx), dx)).contiguous()
                ev[k + 1].record()
                res = b3.render_pass(canon, None, None, ve, zz, b3_dists(zz, d), None, True, None, warped)
                ev[k + 2].record()
                return res

            res = one(z, 2)
            n = z.shape[0]
            u = torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128)
            zs = b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), res.weights[:, 1:-1], u)
            ev[5].record()
            zf = merge_z_vals(z, zs).contiguous()
            ev[6].record()
            res = one(zf, 7)
            _ = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
            ev[10].record()
            torch.cuda.synchronize()
            if rep:
                for i, k in enumerate(names):
                    acc[k] += ev[i].elapsed_time(ev[i + 1])
    return acc


def phase21_train(dev, cfg, tmp, data):
    """The D-NeRF training main path through run_dnerf: 200 bf16 steps
    resumed from the copy of 800000.tar with the config's flags. Returns its
    launch counts."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_dnerf
    from swnerf_torch.train.checkpoint import load_tar

    os.environ["SWNERF_MAX_ITERS"] = "800201"
    buf = io.StringIO()
    try:
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_dnerf.main(dnerf_args(tmp, data, "--i_print", "50", "--i_weights", "100"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        os.environ.pop("SWNERF_MAX_ITERS", None)
    out = buf.getvalue()
    exp = tmp / "logs" / "full_dnerf_800k"
    print(f"[21 train] launches {json.dumps(counts, sort_keys=True)} (200 steps), CLI wall {wall:.2f} s")
    if "Reloading from" not in out or "kernel D-NeRF train step" not in out or min(res["step_ms"]) != 800001:
        fail("the D-NeRF training run did not resume from 800000.tar at 800000 on the kernel step")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], round(r["psnr"], 3), r["tv"]) for r in recs if "psnr" in r]
    print(f"[21 train] (step, train PSNR, TV term) at the prints: {psnrs}")
    if len(psnrs) != 4 or min(p for _, p, _ in psnrs) < 34.0:
        fail(f"train PSNR below 34 dB at a print (or not 4 prints): {psnrs}")
    for i in (800100, 800200):
        ck = load_tar(str(exp / f"{i:06d}.tar"))
        steps = {int(e["step"]) for e in ck["optimizer_state_dict"]["state"].values()}
        print(f"[21 train] {i:06d}.tar keys {sorted(ck)} Adam step {steps} "
              f"({len(ck['optimizer_state_dict']['state'])} entries)")
        if set(ck) != {"global_step", "network_fn_state_dict", "optimizer_state_dict"} or steps != {i} \
                or ck["global_step"] != i:
            fail(f"{i:06d}.tar: keys {set(ck)}, Adam steps {steps}")
    want = {"render_loss[pts,S=192]": 200, "time_net[bwd]": 200, "render_pass[pts,S=64]": 200, "time_net": 400,
            "sample_pdf": 200}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        fail(f"the D-NeRF training path's launches {counts} are not {want}")
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % 50 and (i - 1) % 50}
    med = statistics.median(quiet.values())
    print(f"[21 train] ms per step, median of {len(quiet)} steps that neither print nor save (CUDA events): "
          f"{med:.3f} ms (min {min(quiet.values()):.3f}, max {max(quiet.values()):.3f}); "
          f"{500 / med * 1e3:.4g} rays/s, {500 * (64 + 192) / med * 1e3:.4g} samples/s (canonical samples)")
    stages = dnerf_step_breakdown(dev, cfg, data)
    total = sum(stages.values())
    print("[21 breakdown] one step, device ms by stage: " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[21 breakdown] stage sum {total:.2f} ms vs median step {med:.2f} ms")
    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import time_net as b6

    p6 = b6.pack_time_params(DirectTemporalNeRF(cfg, device=dev).state_dict(), cfg)
    bwd = [k for k in stages if k.startswith("backward")]
    print(f"[21 breakdown] {bwd[0]} {stages[bwd[0]]:.3f} ms; B6's backward over the TV pair's 2 x 500 x 192 rows "
          f"at its bound: {2 * p6.bwd_macs_per_row * 192000 / PEAK_FLOPS['bf16'] * 1e3:.4f} ms")
    return counts


def dnerf_step_breakdown(dev, cfg, data):
    """Device milliseconds of each stage of one kernel D-NeRF step (bf16,
    the CLI's step: train/fused_step.py::make_fused_dnerf_step for the shared
    model with the TV loss, written out), CUDA events between stages, after
    one warm-up step."""
    import dataclasses

    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import sample_along_rays, sample_pdf_merge
    from swnerf_torch.render.core import RenderConfig, make_draws
    from swnerf_torch.render.fused_eval import canonical_params
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.train.loop import init_train_state

    rays, img = frame_rays(dev, data, "train", 37)
    model = DirectTemporalNeRF(cfg, device=dev)
    model.load_state_dict(dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"]))
    state = init_train_state(model, None, 5e-4, 500, step=800000, graphs=True)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0,
                        coarse_contributes=False)
    g = torch.Generator(device=dev).manual_seed(0)
    names = ("pixels + rays", "z + draws + view embedding", "pack (autograd)", "coarse B6", "coarse B3 pts",
             "B2 + sort", "B6 pair (train)", "B5", "TV + loss", "backward (B6 bwd, packing)", "Adam")
    acc = dict.fromkeys(names, 0.0)
    bf = torch.bfloat16
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
        r = type(rays)(*(x[sel] for x in rays))
        target = img[sel].contiguous()
        o, d = r.origins, r.directions
        t = r.times.reshape(-1).contiguous()
        ev[1].record()
        draws = make_draws(rcfg, 500, g, dev)
        z = sample_along_rays(r.near, r.far, 64, 1.0, t_rand=draws.t_rand).contiguous()
        ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
        ev[2].record()
        state.zero_grad()
        params = dict(state.coarse.named_parameters())
        canon = b3.pack_params(canonical_params(params), cfg, torch.float32)
        tnet = b6.pack_time_params(params, cfg, torch.float32)
        ev[3].record()
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        run = dataclasses.replace(tnet, weights=tnet.weights.detach().to(bf), biases=tnet.biases.detach())
        dx = b6.time_net(run, pts, t)
        ev[4].record()
        c16 = dataclasses.replace(canon, weights=canon.weights.detach().to(bf), biases=canon.biases.detach())
        out = b3.render_pass(c16, None, None, ve, z, b3_dists(z, d), draws.noise0.contiguous(), True, None,
                             (pts + dx).contiguous())
        ev[5].record()
        zf = sample_pdf_merge(z, out.weights, 128, det=False, u=draws.u).contiguous()
        ev[6].record()
        pf = (o[:, None, :] + d[:, None, :] * zf[..., None]).contiguous()
        t2 = torch.cat([t, torch.full_like(t, 0.41)])
        dx2 = b6.time_net_autograd(tnet, bf, torch.cat([pf, pf]), t2)
        ev[7].record()
        loss, _ = b1.render_loss_pts_autograd(canon, bf, (pf + dx2[:500]).contiguous(), ve, zf, b3_dists(zf, d),
                                              draws.noise1.contiguous(), target, True, 1.0 / 1500)
        ev[8].record()
        loss = loss + torch.sum((dx2[:500] - dx2[500:]) ** 2) * 1e-4
        ev[9].record()
        loss.backward()
        ev[10].record()
        state.apply_update()
        ev[11].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                acc[k] = ev[i].elapsed_time(ev[i + 1])
    del state, model
    torch.cuda.empty_cache()
    return acc


def phase22_serve(tmp, data, psnr_before):
    """Test frame 5 rendered from the trained 800200.tar by the serving CLI
    (--testskip 5: frames 0, 5, 10, 15, 20)."""
    from swnerf_torch.pipelines import run_dnerf

    savedir = Path(run_dnerf.main(dnerf_args(tmp, data, "--render_only", "--render_test", "--testskip", "5")))
    metrics = json.loads((savedir / "metrics.json").read_text())
    unit = dnerf_unit_psnr(metrics["psnr"], data, DNERF_FRAMES)
    print(f"[22 serve] from 800200.tar ({savedir.name}), data range 1: frames {DNERF_FRAMES} "
          f"{[round(u, 3) for u in unit]}; test frame 5 {unit[1]:.3f} dB vs {psnr_before:.3f} dB from 800000.tar "
          f"(delta {unit[1] - psnr_before:+.3f} dB)")
    if savedir.name != "renderonly_test_800200" or abs(unit[1] - psnr_before) > 0.5:
        fail(f"test frame 5 from 800200.tar: {unit[1]} dB, more than 0.5 dB from {psnr_before}")


# ---------------------------------------------------------------- MultiRes phases

MULTIRES_CONFIG = ROOT / "configs" / "multires" / "lego.txt"
MR_FRAMES = (0, 5, 10, 15, 20)  # test frames held to the fp32 plain route in phase 25
MR_NOISE = ("--raw_noise_std", "1")  # phase 25's one change to the config: live densities (phase25_train)


def multires_phases(dev, tmp, data):
    """Phases 23-25 on phase 11's scene. Returns the [kernel] rows of B7
    and of B6's MultiRes instantiation (forward, backward), with the launch
    counts of the MultiRes main path."""
    rows = phase23_kernels(dev, data)
    phase24_steps(dev, data)
    counts = phase25_train(dev, tmp, data)
    counter = {"time_net[multires]": "time_net", "time_net[multires,bwd]": "time_net[bwd]",
               "trunk[multires]": "trunk", "trunk[multires,bwd]": "trunk[bwd]"}
    for k, row in rows.items():
        row["launches"] = counts.get(counter.get(k, k), 0)
        print(f"[23 kernel] {row['name']}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} -> {100 * row['bound_ms'] / row['ms']:.2f}% of the "
              f"bound, {row['launches']} launches on the MultiRes main path")
    return list(rows.values())


def mr_args(*extra):
    from swnerf_torch.utils.config import config_parser_dnerf

    return config_parser_dnerf().parse_args(["--config", str(MULTIRES_CONFIG), *extra])


def mr_level_model(dev, level, seed, **kw):
    """A MultiRes level's field at the config's full width (D=8, W=256, skip
    4) with seeded weights."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.pipelines import run_multires as mr

    cfg = mr._level_cfg(mr_args(), mr.CHANNEL_LIST[level])
    return DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), **kw)


def phase23_kernels(dev, data):
    """B7 and the widened B6 against their twins at each level's widths on
    the phase-1 shape (500 rays x 64 samples = 32,000 rows), then their
    times at each level's rows. Returns B7's two [kernel] rows."""
    import dataclasses

    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.sampling import sample_along_rays

    rays, _ = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(0)
    sel = torch.randint(0, rays.origins.shape[0], (1024,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g)
    pts_all = (r.origins[:, None, :] + r.directions[:, None, :] * z[..., None]).contiguous()  # up to 65,536 rows
    t_all = r.times.reshape(-1).contiguous()
    pts, t = pts_all[:500], t_all[:500]  # the checks: the phase-1 shape
    P = pts.shape[0] * pts.shape[1]
    err16 = {"time_net": 0.0, "trunk": 0.0}
    cases = {}
    for level in (0, 1, 3):
        model = mr_level_model(dev, level, seed=level)
        cfg, sd, occ = model.cfg, model.state_dict(), model._occ.state_dict()
        cot = torch.randn(pts.shape, generator=g, device=dev)
        # B6 at the level's (Lx, Lt)
        p32 = b6.pack_time_params(sd, cfg, torch.float32)
        dx, gk = b6.time_net_fwd_bwd(p32, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p32, pts, t, cot)
        ref, gr = b6.time_net_plain(p32, pts, t), b6.time_net_plain_bwd(p32, pts, t, cot)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        g64 = b6.time_net_plain_bwd(p64, pts.double(), t.double(), cot.double())
        g64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), pts.double(), t.double(),
                                     cot.double())
        dxf = b6.time_net(p32, pts, t)  # the forward-only launch the test render runs
        torch.cuda.synchronize()
        ddx = (dx - ref).abs().max().item()
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        fwd_same = torch.equal(dxf, dx)
        print(f"[23 B6 fp32 level {level}] input {p32.cin} of {p32.cin_pad} rows: max|ddx|={ddx:.3e} "
              f"(max|dx| {ref.abs().max().item():.3e}) repeat bit-equal={same}; forward-only launch max|ddx|="
              f"{(dxf - ref).abs().max().item():.3e}, bit-equal to train mode={fwd_same}")
        if ddx > 1e-5 or not same or not fwd_same:
            fail(f"B6 fp32 level {level}: max |ddx| {ddx} > 1e-5, repeats differ or the forward-only launch differs "
                 "from the train-mode one")
        check_fp32_grads(f"23 B6 fp32 level {level}", *(b6.unpack_time_grads(x, p32) for x in (gk, gr, g64, g64p)))
        p16 = b6.pack_time_params(sd, cfg, torch.bfloat16)
        dx16, gk = b6.time_net_fwd_bwd(p16, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p16, pts, t, cot)
        ref16, gr = b6.time_net_plain(p16, pts, t), b6.time_net_plain_bwd(p16, pts, t, cot)
        dxf = b6.time_net(p16, pts, t)
        torch.cuda.synchronize()
        ddx = (dx16 - ref16).abs().max().item()
        rel = rel_l2(b6.unpack_time_grads(gk, p16), b6.unpack_time_grads(gr, p16))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        fwd_same = torch.equal(dxf, dx16)
        print(f"[23 B6 bf16 level {level}] max|ddx|={ddx:.3e} grads max rel L2={max(rel.values()):.3e} "
              f"({max(rel, key=rel.get)}) repeat bit-equal={same}; forward-only launch max|ddx|="
              f"{(dxf - ref16).abs().max().item():.3e}, bit-equal to train mode={fwd_same}")
        if ddx > 1e-2 or max(rel.values()) > 1e-2 or not same or not fwd_same:
            fail(f"B6 bf16 level {level}: max |ddx| > 1e-2, gradient rel L2 > 1e-2, repeats differ or the forward-only "
                 "launch differs from the train-mode one")
        err16["time_net"] = max(err16["time_net"], ddx)
        del gk, gk2, gr, g64, g64p

        # B7 at the embedded warped positions and the view embedding
        emb = positional_encoding((pts + ref).reshape(P, 3), cfg.nf_pts).contiguous()
        vemb = positional_encoding(r.viewdirs[:500], cfg.nf_views)[:, None, :].expand(500, 64, -1).reshape(P, -1)
        vemb = vemb.contiguous()
        graw = torch.randn((P, 4), generator=g, device=dev)
        c32 = b7.pack_trunk_params(occ, cfg, torch.float32)
        raw, gk, dk, _ = b7.trunk_fwd_bwd(c32, emb, vemb, graw)
        _, gk2, dk2, _ = b7.trunk_fwd_bwd(c32, emb, vemb, graw)
        rref = b7.trunk_plain(c32, emb, vemb)
        gr, dr, _ = b7.trunk_plain_bwd(c32, emb, vemb, graw)
        c64 = dataclasses.replace(c32, weights=c32.weights.double())
        g64, d64, _ = b7.trunk_plain_bwd(c64, emb.double(), vemb.double(), graw.double())
        g64p, d64p, _ = b7.trunk_plain_bwd(dataclasses.replace(c64, weights=jitter(c64.weights)), emb.double(),
                                           vemb.double(), graw.double())
        rawf = b7.trunk(c32, emb, vemb)  # the forward-only launch the test render runs
        torch.cuda.synchronize()
        draw = (raw - rref).abs().max().item()
        raw_ok = torch.allclose(raw, rref, atol=1e-4, rtol=1e-4)
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        fwd_same = torch.equal(rawf, raw)
        print(f"[23 B7 fp32 level {level}] emb {c32.cin} of 128, vemb {c32.input_ch_views} of 128: "
              f"max|draw|={draw:.3e} (max|raw| {rref.abs().max().item():.3e}) within atol/rtol 1e-4={raw_ok} "
              f"max|ddemb|={(dk - dr).abs().max().item():.3e} repeat bit-equal={same}; forward-only launch "
              f"max|draw|={(rawf - rref).abs().max().item():.3e}, bit-equal to train mode={fwd_same}")
        if not raw_ok or not same or not fwd_same:
            fail(f"B7 fp32 level {level}: raw outside atol/rtol 1e-4, repeats differ or the forward-only launch "
                 "differs from the train-mode one")
        check_fp32_grads(f"23 B7 fp32 level {level}", *(dict(b7.unpack_trunk_grads(gg, pp), demb=dd) for gg, dd, pp in (
            (gk, dk, c32), (gr, dr, c32), (g64, d64, c64), (g64p, d64p, c64))))
        del gk, gk2, gr, g64, g64p
        c16 = b7.pack_trunk_params(occ, cfg, torch.bfloat16)
        raw, gk, dk, _ = b7.trunk_fwd_bwd(c16, emb, vemb, graw)
        _, gk2, dk2, _ = b7.trunk_fwd_bwd(c16, emb, vemb, graw)
        rref = b7.trunk_plain(c16, emb, vemb)
        gr, dr, _ = b7.trunk_plain_bwd(c16, emb, vemb, graw)
        rawf, rawf2 = b7.trunk(c16, emb, vemb), b7.trunk(c16, emb, vemb)  # the tensor-core launch
        torch.cuda.synchronize()
        draw = (raw - rref).abs().max().item()
        drawf = (rawf - rref).abs().max().item()
        scale = rref.abs().max().item()
        rel = rel_l2(dict(b7.unpack_trunk_grads(gk, c16), demb=dk), dict(b7.unpack_trunk_grads(gr, c16), demb=dr))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        fwd_same = torch.equal(rawf, rawf2)
        print(f"[23 B7 bf16 level {level}] max|draw|={draw:.3e} (max|raw| {scale:.3e}) grads and demb max rel "
              f"L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}; forward-only launch "
              f"(tensor cores) max|draw|={drawf:.3e}, repeat bit-equal={fwd_same}")
        if max(draw, drawf) > 1e-2 * scale or max(rel.values()) > 1e-2 or not same or not fwd_same:
            fail(f"B7 bf16 level {level}: raw (train mode or forward only) beyond 1e-2 of its largest value, "
                 "gradient rel L2 > 1e-2 or repeats differ")
        err16["trunk"] = max(err16["trunk"], draw, drawf)
        cases[level] = (p16, c16, cfg)
        del gk, gk2, gr
        torch.cuda.empty_cache()

    # times, bf16 (the main path's operands): every level's phase-1 rows
    # (32,000) and its phase-2 patch rows (32^2, 16^2, 8^2, 4^2 rays x 64),
    # on the sample positions (unwarped) of the 1,024 rays
    rows = {}
    vd_all = r.viewdirs
    for level, (p16, c16, cfg) in cases.items():
        emb_all = positional_encoding(pts_all.reshape(-1, 3), cfg.nf_pts).contiguous()
        vemb_all = positional_encoding(vd_all, cfg.nf_views)[:, None, :].expand(1024, 64, -1).reshape(65536, -1)
        vemb_all = vemb_all.contiguous()
        graw_all = torch.randn((65536, 4), generator=g, device=dev)
        cot_all = torch.randn((65536, 3), generator=g, device=dev)
        for n_rows in sorted({P, (32 >> level) ** 2 * 64}):
            e, v, gg = emb_all[:n_rows], vemb_all[:n_rows], graw_all[:n_rows]
            sc = b7._scratch(c16, n_rows, dev)
            fwd = cuda_ms(lambda: b7._launch_fwd(c16, e, v, sc), 10)
            bwd = cuda_ms(lambda: b7._launch_bwd(c16, n_rows, gg, sc, True, False), 10)
            if level == 0:  # phase 1's 32,000 rows and phase 2's 65,536
                ordered_check("23", "level 0, seeded weights", c16, e, v)
                if n_rows == P:
                    simt_forward("23", f"B7 (trunk[multires]) train mode, level 0, {n_rows:,} rows",
                                 lambda: b7._launch_fwd(c16, e, v, sc), 2 * c16.macs_per_row * n_rows)
            n_rays = n_rows // 64
            pp, tt, cc = pts_all[:n_rays], t_all[:n_rays], cot_all[:n_rows]
            sc6 = b6._scratch(p16, n_rows, dev)
            f6 = cuda_ms(lambda: b6._launch_fwd(p16, pp, tt, sc6), 10)
            b6ms = cuda_ms(lambda: b6._launch_bwd(p16, n_rows, cc, sc6), 10)
            print(f"[23 times level {level}] {n_rows} rows, bf16: B7 forward (train mode) {fwd:.3f} ms, backward "
                  f"(with demb) {bwd:.3f} ms; B6 forward (train mode) {f6:.3f} ms, backward {b6ms:.3f} ms")
            if level == 0 and n_rows == P:  # the [kernel] rows: level 0, phase 1
                nw, nb = c16.weights.numel(), c16.biases.numel()
                rows["trunk[multires]"] = entry(
                    "trunk[multires]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:435", 0,
                    err16["trunk"], fwd, cuda_ms(lambda: b7.trunk_plain(c16, e, v), 3),
                    4 * (e.numel() + v.numel() + 4 * n_rows) + 2 * nw + 4 * nb, 2 * c16.macs_per_row * n_rows, "bf16")
                rows["trunk[multires,bwd]"] = entry(
                    "trunk[multires,bwd]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:446", 0,
                    err16["trunk"], bwd, cuda_ms(lambda: b7.trunk_plain_bwd(c16, e, v, gg), 3),
                    4 * (4 * n_rows + e.numel()) + 2 * nw + 4 * (nw + nb), 2 * c16.bwd_macs_per_row() * n_rows, "bf16")
                report_sweep("23", "trunk[multires,bwd] bf16 (with demb), level 0",
                             lambda: b7._launch_bwd(c16, n_rows, gg, sc, True, False), bwd,
                             rows["trunk[multires,bwd]"]["bound_ms"], n_rows,
                             sweep_products(c16.W, c16.D, c16.skip, c16.cin_pad, c16.cv_pad, demb=True), dev)
                report_library("23", "trunk[multires] bf16 train-mode forward, level 0", n_rows,
                               forward_products(c16.W, c16.D, c16.skip, c16.cin_pad, c16.cv_pad), fwd, dev)
                # B6's MultiRes rows: its 144-row instantiation at the same
                # rows; the D-NeRF rows keep the 96-row code at its shapes
                nw6, nb6 = p16.weights.numel(), p16.biases.numel()
                rows["time_net[multires]"] = entry(
                    "time_net[multires]", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:470", 0,
                    err16["time_net"], f6, cuda_ms(lambda: b6.time_net_plain(p16, pp, tt), 3),
                    4 * (3 * n_rows + n_rays + 3 * n_rows) + 2 * nw6 + 4 * nb6, 2 * p16.macs_per_row * n_rows, "bf16")
                rows["time_net[multires,bwd]"] = entry(
                    "time_net[multires,bwd]", "swnerf_torch/csrc/time_net.cu",
                    "swnerf_tpu/ops/pallas/raymarch.py:480", 0, err16["time_net"], b6ms,
                    cuda_ms(lambda: b6.time_net_plain_bwd(p16, pp, tt, cc), 3),
                    4 * (3 * n_rows + 3 * n_rows + n_rays) + 2 * nw6 + 4 * (nw6 + nb6),
                    2 * p16.bwd_macs_per_row * n_rows, "bf16")
                report_sweep("23", "time_net[multires,bwd] bf16, level 0",
                             lambda: b6._launch_bwd(p16, n_rows, cc, sc6), b6ms,
                             rows["time_net[multires,bwd]"]["bound_ms"], n_rows,
                             sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad), dev)
                report_library("23", "time_net[multires] bf16 train-mode forward, level 0", n_rows,
                               forward_products(p16.W, p16.D, p16.skip, p16.cin_pad), f6, dev)
                print(f"[23 B6 level 0] {p16.macs_per_row} / {p16.bwd_macs_per_row} MACs per row: forward "
                      f"{2 * p16.macs_per_row * n_rows / f6 / 1e9:.2f} TFLOP/s, backward "
                      f"{2 * p16.bwd_macs_per_row * n_rows / b6ms / 1e9:.2f} TFLOP/s; B7 {c16.macs_per_row} / "
                      f"{c16.bwd_macs_per_row()} MACs per row: forward {2 * c16.macs_per_row * n_rows / fwd / 1e9:.2f}"
                      f" TFLOP/s, backward {2 * c16.bwd_macs_per_row() * n_rows / bwd / 1e9:.2f} TFLOP/s")
            del sc, sc6
        torch.cuda.empty_cache()
    # the test render's chunk at level 0, forward only: 32,768 rays x 64 samples
    p16, c16, cfg0 = cases[0]
    big_pts = pts_all.repeat(32, 1, 1).contiguous()
    big_t = t_all.repeat(32).contiguous()
    big_emb = positional_encoding(big_pts.reshape(-1, 3), cfg0.nf_pts).contiguous()
    big_vemb = positional_encoding(vd_all, cfg0.nf_views)[:, None, :].expand(1024, 64, -1).reshape(65536, -1)
    big_vemb = big_vemb.repeat(32, 1).contiguous()
    # the chunk's last 500 rays (the last blocks of the launch) against the
    # twins, at the bf16 bars above, before the times
    raw_big, dx_big = b7.trunk(c16, big_emb, big_vemb)[-P:], b6.time_net(p16, big_pts, big_t)[-500:]
    rref = b7.trunk_plain(c16, big_emb[-P:], big_vemb[-P:])
    dref = b6.time_net_plain(p16, big_pts[-500:], big_t[-500:])
    torch.cuda.synchronize()
    draw, ddx = (raw_big - rref).abs().max().item(), (dx_big - dref).abs().max().item()
    print(f"[23 check level 0] the test render's chunk, forward only, bf16, its last {P} rows against the twins: B7 "
          f"max|draw|={draw:.3e} (max|raw| {rref.abs().max().item():.3e}), B6 max|ddx|={ddx:.3e}")
    if draw > 1e-2 * rref.abs().max().item() or ddx > 1e-2:
        fail("B7 or B6 at the test render's chunk: raw beyond 1e-2 of its largest value or max |ddx| > 1e-2")
    del raw_big, dx_big, rref, dref
    f7 = cuda_ms(lambda: b7.trunk(c16, big_emb, big_vemb), 3)
    f6 = cuda_ms(lambda: b6.time_net(p16, big_pts, big_t), 3)
    report_library("23", "trunk[multires] forward only, the test render's chunk", big_emb.shape[0],
                   forward_products(c16.W, c16.D, c16.skip, c16.cin_pad, c16.cv_pad), f7, dev)
    report_library("23", "time_net[multires] forward only, the test render's chunk", big_emb.shape[0],
                   forward_products(p16.W, p16.D, p16.skip, p16.cin_pad), f6, dev)
    bound7 = 2 * c16.macs_per_row * big_emb.shape[0] / PEAK_FLOPS["bf16"] * 1e3
    TC_SUMMARY["trunk[multires] forward only at the test render's chunk (wide pads)"] = (
        f"{f7:.3f} ms/launch, {2 * c16.macs_per_row * big_emb.shape[0] / f7 / 1e9:.1f} TFLOP/s, "
        f"{100 * bound7 / f7:.2f}% of its bound ({bound7:.4f} ms)")
    # the slow path of sinf/cosf: B6 at level 0 against the same launch with the encode's arguments small
    small = (big_pts * 2.0**-19).contiguous()
    f6s = cuda_ms(lambda: b6.time_net(p16, small, big_t), 3)
    print(f"[23 times level 0] the test render's chunk, {big_emb.shape[0]} rows, forward only, bf16: B7 {f7:.3f} ms "
          f"({2 * c16.macs_per_row * big_emb.shape[0] / f7 / 1e9:.2f} TFLOP/s), B6 {f6:.3f} ms; B6 on the same rows "
          f"scaled by 2^-19 (the encode's arguments below 1 rad, sinf/cosf's fast path): {f6s:.3f} ms, so the slow "
          f"path of the 2^19 arguments costs {f6 - f6s:.3f} ms ({100 * (f6 - f6s) / f6:.1f}%)")
    del big_emb, big_vemb, cases
    torch.cuda.empty_cache()
    return rows


def phase24_steps(dev, data):
    """One phase-1 step at level 0 (500 rays, TV on) and one phase-2 step over
    the four levels (patches of 32/16/8/4 pixels at the centre, the global
    term on) on the kernel route against the plain route, from the same
    weights and draws; the plain route in float64 (and on weights perturbed
    at fp32's size) as the reference of check_fp32_grads' fallback. The
    deformation heads are scaled by 1e-3: at level 0 the encode reaches
    2^19 |x|, and a dx of O(1) would carry its fp32 rounding into the
    canonical input as ~0.05 rad, a difference of conditioning, not of the
    kernels (tests/test_torch_multires.py); dx of O(1e-3) leaves the
    comparison well conditioned."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import load_scene, make_time_image_step
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step

    args = mr_args("--datadir", str(data), "--device", "cuda")
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True)

    def models(dtype=torch.float32):
        """Per level: (kernel route, plain route fp32, plain float64, plain
        float64 perturbed), from one seeded set of weights."""
        out = []
        for level in range(4):
            kern = mr_level_model(dev, level, seed=10 + level, compute_dtype=dtype)
            with torch.no_grad():
                kern._time_out.weight.mul_(1e-3)
                kern._time_out.bias.mul_(1e-3)
            plains = []
            for pdt, perturb in ((torch.float32, False), (torch.float64, False), (torch.float64, True)):
                m = DirectTemporalNeRF(kern.cfg, device=dev, fused=False)
                m.load_state_dict(kern.state_dict())
                m = m.to(pdt)
                if perturb:
                    with torch.no_grad():
                        for p in m.parameters():
                            p.copy_(jitter(p))
                plains.append(m)
            out.append((kern, *plains))
        return out

    def grads(st):
        return {k: p.grad.detach().clone() for k, p in st.coarse.named_parameters()}

    # phase 1, level 0: the CLI's step on 500 pixels of train view 37
    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    times = torch.as_tensor(scene.times, device=dev)
    pix = torch.randint(0, scene.H, (500, 2), generator=torch.Generator().manual_seed(1)).numpy()

    def phase1(model, dtype):
        st = init_train_state(model, None, 5e-4, 250)
        gen = torch.Generator(device=dev).manual_seed(3)
        cast = lambda x: None if x is None else x.to(dtype)  # noqa: E731

        def step(s, rays, target, nt, generator):  # the float64 step takes the fp32 rays, cast
            draws = make_draws(rcfg, rays.origins.shape[0], generator, dev)
            return make_dnerf_train_step(rcfg, True, 1e-3)(s, Rays(*(cast(x) for x in rays)), cast(target), nt,
                                                           draws=Draws(*(cast(x) for x in draws)))

        m = make_time_image_step(step, rcfg, scene, pass_neighbor=True)(st, images, poses, times, 37, pix, 0.41, gen)
        return m["total_loss"].item(), grads(st)

    sets = models()
    (lk, gk), (lp, gp), (l64, g64), (l64p, g64p) = (phase1(m, dt) for m, dt in zip(
        sets[0], (torch.float32, torch.float32, torch.float64, torch.float64)))
    torch.cuda.synchronize()
    dl = abs(lk - lp) / lp
    print(f"[24 phase 1 fp32 level 0] total_loss kernel route {lk:.8f} plain {lp:.8f} rel {dl:.3e}; float64 {l64:.8f}"
          f" (perturbed {l64p:.8f})")
    if dl > 1e-5 and abs(lk - l64) > 2 * max(abs(lp - l64), abs(l64p - l64)):
        fail(f"phase-1 step loss rel {dl} > 1e-5, and further from the float64 step than fp32 moves it")
    check_fp32_grads("24 phase 1 fp32 level 0", gk, gp, g64, g64p)
    # bf16: 2e-2, five of bf16's unit roundoffs (2^-8); a broken operand path
    # lands O(1) away. On these seeded weights level 0 measures 1.35e-2 on an
    # H100 (PERF.md): its 123- and 140-column encodings round to bf16 at
    # every layer.
    l16, _ = phase1(models(torch.bfloat16)[0][0], torch.float32)
    print(f"[24 phase 1 bf16 level 0] total_loss {l16:.8f} vs the fp32 plain route: rel {abs(l16 - lp) / lp:.3e}")
    if abs(l16 - lp) / lp > 2e-2:
        fail(f"bf16 phase-1 step loss rel {abs(l16 - lp) / lp} > 2e-2")

    # phase 2: every level's centre patch of train view 37, global weight 1
    L = 4
    pyr_hwf = [[scene.H // 2**l, scene.W // 2**l, scene.focal / 2**l] for l in range(L)]
    patch_sizes = [32, 16, 8, 4]
    coords = [(10 << (L - 1 - l), 10 << (L - 1 - l)) for l in range(L)]  # (80, 80) at level 0 .. (10, 10)
    with torch.no_grad():
        lap = generate_laplacian_pyramid(images[37:38], levels=L)
    pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev), torch.arange(x, x + ps, device=dev),
                                         indexing="ij"), -1).reshape(-1, 2) for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][0, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    full = images[37, 80:112, 80:112]
    gen = torch.Generator(device=dev).manual_seed(4)
    draws = [make_draws(rcfg, ps * ps, gen, dev) for ps in patch_sizes]
    step = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far)
    sets = models()  # fresh weights: each phase-1 step above applied its own Adam update

    def phase2(ms, dtype):
        states = [init_train_state(m, None, 5e-4, 250) for m in ms]
        cast = lambda x: x.to(dtype)  # noqa: E731
        m = step(states, pixels, [cast(x) for x in targets], cast(full), cast(poses[37]), float(scene.times[37]), 1.0,
                 draws=[Draws(cast(d.t_rand), None, None, None) for d in draws])
        return m, [grads(s) for s in states]

    (mk, gk), (mp, gp), (m64, g64), (m64p, g64p) = (phase2([s[i] for s in sets], dt) for i, dt in enumerate(
        (torch.float32, torch.float32, torch.float64, torch.float64)))
    torch.cuda.synchronize()
    lk, lp, l64, l64p = (m["total_loss"].item() for m in (mk, mp, m64, m64p))
    dl = abs(lk - lp) / lp
    print(f"[24 phase 2 fp32] total_loss kernel route {lk:.8f} plain {lp:.8f} rel {dl:.3e} (global loss "
          f"{mk['global_loss'].item():.6f} vs {mp['global_loss'].item():.6f}); float64 {l64:.8f} (perturbed {l64p:.8f})")
    if dl > 1e-5 and abs(lk - l64) > 2 * max(abs(lp - l64), abs(l64p - l64)):
        fail(f"phase-2 step loss rel {dl} > 1e-5, and further from the float64 step than fp32 moves it")
    for l in range(L):
        check_fp32_grads(f"24 phase 2 fp32 level {l}", gk[l], gp[l], g64[l], g64p[l])
    m16, _ = phase2([s[0] for s in models(torch.bfloat16)], torch.float32)
    d16 = abs(m16["total_loss"].item() - lp) / lp
    print(f"[24 phase 2 bf16] total_loss {m16['total_loss'].item():.8f} vs the fp32 plain route: rel {d16:.3e}")
    if d16 > 2e-2:
        fail(f"bf16 phase-2 step loss rel {d16} > 2e-2")
    del sets
    torch.cuda.empty_cache()


def phase25_train(dev, tmp, data):
    """The MultiRes main path through run_multires (module docstring, phase
    25). Returns its launch counts."""
    import numpy as np
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.ops.pyramid import reconstruct_from_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import load_scene, render_path
    from swnerf_torch.train.loop import mse_to_psnr

    # --raw_noise_std 1 (MR_NOISE): without density noise every level's loss
    # on this scene stopped within 20 steps at the all-white render's, a
    # density below zero takes no gradient through its ReLU, and the
    # quality bars below compared two white images.
    argv = ["--config", str(MULTIRES_CONFIG), "--basedir", str(tmp / "mr_logs"), "--datadir", str(data),
            "--device", "cuda", "--global_optimization_epoch", "100", "--i_testset", "200", "--i_weights", "100",
            *MR_NOISE]
    env = dict(SWNERF_PHASE1_ITERS="100", SWNERF_MAX_ITERS="201")
    os.environ.update(env)
    try:
        launches.clear()
        t0 = time.perf_counter()
        res = mr.train(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        for k in env:
            os.environ.pop(k, None)
    exp = tmp / "mr_logs" / "lego"
    print(f"[25 train] launches {json.dumps(counts, sort_keys=True)}, CLI wall {wall:.2f} s")
    for k in ("time_net", "time_net[bwd]", "trunk", "trunk[bwd]"):
        if counts.get(k, 0) <= 0:
            fail(f"the MultiRes main path launched no {k}")
    for level in range(4):
        losses = res["phase1_loss"][level]
        ms = res["phase1_step_ms"][level]
        quiet = [v for i, v in ms.items() if i % 20 and (i - 1) % 20]
        print(f"[25 phase 1 level {level}] loss at the prints {[round(x, 6) for x in losses]}; ms per step, median of "
              f"{len(quiet)} steps that do not print (CUDA events): {statistics.median(quiet):.3f} "
              f"(min {min(quiet):.3f}, max {max(quiet):.3f})")
        if not losses[-1] < losses[0]:
            fail(f"level {level}'s phase-1 loss did not fall: {losses}")
    quiet = [v for i, v in res["phase2_step_ms"].items() if i % 20 and (i - 1) % 20 and i % 100 and (i - 1) % 100]
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    gpsnr = [(r["step"], round(r["global_psnr"], 3)) for r in recs if "global_psnr" in r]
    totals = [(r["step"], r["total_loss"]) for r in recs if "total_loss" in r]
    print(f"[25 phase 2] ms per step, median of {len(quiet)} steps that neither print nor save: "
          f"{statistics.median(quiet):.3f} (min {min(quiet):.3f}, max {max(quiet):.3f}); 87,040 rows a step; global "
          f"PSNR at the prints {gpsnr}; total loss at the prints {[(i, round(v, 6)) for i, v in totals]}")
    if not gpsnr or not all(np.isfinite(p) for _, p in gpsnr):
        fail(f"the global PSNR is not finite: {gpsnr}")
    if len({v for _, v in totals}) < 2:
        fail(f"the phase-2 loss did not move: {totals}")
    print(f"[25 test set] {res['test_frame_ms']:.1f} ms per reconstructed test frame (every level's 64-sample render, "
          "levels 0-2 through the eval pass: B6 + B3's pts mode, level 3 through B6 + B7, and the reconstruction, "
          "25 frames)")
    for i in (100, 200):
        ck = torch.load(str(exp / f"{i:06d}.tar"), map_location="cpu", weights_only=True)
        keys = sorted(ck)
        steps = {l: {int(e["step"]) for e in ck[f"optimizer_{l}"]["state"].values()} for l in range(4)}
        print(f"[25 train] {i:06d}.tar keys {keys}, Adam steps per level {steps}")
        if set(ck) != {"global_step", *(f"{k}_{l}" for k in ("network_fn", "optimizer") for l in range(4))} or \
                any(s != {100 + i} for s in steps.values()):
            fail(f"{i:06d}.tar: keys {keys}, Adam steps {steps}")

    # 000200.tar reconstructed by the bf16 kernels and by the fp32 plain route
    args = mr_args("--datadir", str(data), "--basedir", str(tmp / "mr_logs"), "--device", "cuda", *MR_NOISE)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    _, states, pyr_hwf, rcfg, start = mr.create_multires(args, scene, dev)
    # B7's bf16 train-mode raw on 000200.tar's level-0 canonical field at
    # phase 2's 65,536 rows, against its ordered twin
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7

    occ, cfg0 = states[0].coarse._occ, states[0].coarse.cfg
    g25 = torch.Generator(device=dev).manual_seed(25)
    x25 = torch.rand((65536, 3), generator=g25, device=dev) * 2 - 1
    v25 = torch.nn.functional.normalize(torch.randn((65536, 3), generator=g25, device=dev), dim=-1)
    ordered_check("25", "000200.tar's level 0", b7.pack_trunk_params(occ.state_dict(), cfg0, torch.bfloat16),
                  positional_encoding(x25, cfg0.nf_pts).contiguous(),
                  positional_encoding(v25, cfg0.nf_views).contiguous())
    del x25, v25
    idx = scene.i_test[list(MR_FRAMES)]
    psnr, recons, renders = {}, {}, {}
    for route in ("bf16 kernels", "fp32 plain"):
        levels = []
        for l, st in enumerate(states):
            model = st.coarse
            if route == "fp32 plain":
                model = DirectTemporalNeRF(st.coarse.cfg, device=dev, fused=False)
                model.load_state_dict(st.coarse.state_dict())
            rgbs, _, _ = render_path(model, None, scene.poses[idx], mr.level_scene(scene, pyr_hwf[l]), rcfg, args.chunk,
                                     times=scene.times[idx])
            levels.append(torch.as_tensor(rgbs))
        renders[route] = levels
        recons[route] = reconstruct_from_pyramid(levels).clamp(0.0, 1.0)
        gt = torch.as_tensor(scene.images[idx])
        psnr[route] = [mse_to_psnr(torch.mean((recons[route][k] - gt[k]) ** 2).item()) for k in range(len(idx))]
    mean = {k: sum(v) / len(v) for k, v in psnr.items()}
    d = abs(mean["bf16 kernels"] - mean["fp32 plain"])
    dlev = [(a - b).abs().max().item() for a, b in zip(renders["bf16 kernels"], renders["fp32 plain"])]
    drec = (recons["bf16 kernels"] - recons["fp32 plain"]).abs()
    print(f"[25 test set] from {start:06d}.tar, test frames {MR_FRAMES} at 200x200, reconstructed PSNR (data range "
          f"1): bf16 kernels {[round(x, 3) for x in psnr['bf16 kernels']]} (mean {mean['bf16 kernels']:.4f} dB), fp32 "
          f"plain route {[round(x, 3) for x in psnr['fp32 plain']]} (mean {mean['fp32 plain']:.4f} dB): |delta| "
          f"{d:.4f} dB; max |bf16 - fp32| per level's render {[f'{x:.3e}' for x in dlev]}, in the reconstruction "
          f"{drec.max().item():.3e} (mean {drec.mean().item():.3e})")
    if start != 200 or d > 0.1:
        fail(f"the bf16 reconstruction of 000200.tar is {d} dB from the fp32 plain route (> 0.1 dB)")
    if drec.max().item() == 0.0:
        fail("the bf16 and fp32 reconstructions are equal: the 0.1 dB bar saw no bf16 error (saturated frames)")
    print(f"[25 digest] 000200.tar: {ckpt_digest(exp / '000200.tar')} (sha256 of every tensor's bytes, keys in order; "
          "000100.tar: " + ckpt_digest(exp / "000100.tar") + ")")
    pyramid_repeats(dev)
    multires_breakdown(dev, scene, states, pyr_hwf, rcfg, args)
    del states
    torch.cuda.empty_cache()
    return counts


def ckpt_digest(path) -> str:
    """sha256 over a checkpoint's contents: every tensor's dtype, shape and
    bytes and every other value's repr, walking the keys in sorted order."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(key, v):
        h.update(str(key).encode())
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(k, v[k])
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(i, x)
        else:
            h.update(repr(v).encode())

    walk("", torch.load(str(path), map_location="cpu", weights_only=True))
    return h.hexdigest()[:16]


def pyramid_repeats(dev):
    """The pyramid reconstruction's backward at phase 2's patch sizes (32,
    16, 8, 4; ops/pyramid.py's fixed-order backward) launched twice on one
    seeded cotangent: bit-equal, and the forward bit-equal to F.interpolate's.
    Beside it, the same with F.interpolate's own backward (atomics), whose
    two launches may differ: printed, not held."""
    import torch

    from swnerf_torch.ops import pyramid as tp

    g = torch.Generator(device=dev).manual_seed(0)
    bands = [torch.rand((1, 32 >> l, 32 >> l, 3), generator=g, device=dev) for l in range(4)]
    ct = torch.randn((1, 32, 32, 3), generator=g, device=dev)

    def grads(resize):
        saved, tp._resize = tp._resize, resize
        try:
            bb = [b.clone().requires_grad_(True) for b in bands]
            out = tp.reconstruct_from_pyramid(bb)
            (out * ct).sum().backward()
            torch.cuda.synchronize()
            return out.detach(), [b.grad for b in bb]
        finally:
            tp._resize = saved

    (o1, g1), (o2, g2) = grads(tp._resize), grads(tp._resize)
    (o3, g3), (_, g4) = grads(tp._interpolate), grads(tp._interpolate)
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    atomic_same = all(torch.equal(a, b) for a, b in zip(g3, g4))
    dmax = max((a - b).abs().max().item() for a, b in zip(g1, g3))
    print(f"[25 pyramid] the reconstruction at phase 2's patches: forward bit-equal to F.interpolate's="
          f"{torch.equal(o1, o3) and torch.equal(o1, o2)}; fixed-order backward, two launches bit-equal={same}; "
          f"F.interpolate's own backward, two launches bit-equal={atomic_same}; the two backwards max|d|={dmax:.3e}")
    if not same or not torch.equal(o1, o3):
        fail("the pyramid's fixed-order backward differs between two launches, or its forward from F.interpolate's")
    if dmax > 1e-5:
        fail(f"the pyramid's fixed-order backward is {dmax} from F.interpolate's (> 1e-5)")


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def multires_breakdown(dev, scene, states, pyr_hwf, rcfg, args):
    """Device time by kernel family over 10 phase-1 steps at level 0 and 10
    phase-2 steps (the CLI's steps on 000200.tar's levels, after 3 warm-up
    steps each), from torch.profiler's CUDA activity, against the host
    clock around the steps (synchronized): the device's idle share."""
    import numpy as np
    import torch

    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import ImageSampler, make_time_image_step, pick_neighbor_time
    from swnerf_torch.train.loop import make_dnerf_train_step

    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    times = torch.as_tensor(scene.times, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(7)
    lscene = mr.level_scene(scene, pyr_hwf[0], scene.images)
    sampler = ImageSampler(lscene, args.N_rand, 0, 0.5)
    p1 = make_time_image_step(make_dnerf_train_step(rcfg, True, args.tv_loss_weight), rcfg, lscene,
                              pass_neighbor=True)

    def phase1(i):
        img_i, pix = sampler.next(i)
        p1(states[0], images, poses, times, img_i, pix, pick_neighbor_time(rng, scene.times, img_i), gen)

    with torch.no_grad():
        lap = generate_laplacian_pyramid(images, levels=4)
    patch_sizes = [32, 16, 8, 4]
    p2 = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far)

    def phase2(i):
        coords = mr.initialize_patches(rng, pyr_hwf, i)
        img_i = int(rng.choice(scene.i_train))
        pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev), torch.arange(x, x + ps, device=dev),
                                             indexing="ij"), -1).reshape(-1, 2)
                  for (y, x), ps in zip(coords, patch_sizes)]
        targets = [lap[l][img_i, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
        y0, x0 = coords[0]
        p2(states, pixels, targets, images[img_i, y0 : y0 + 32, x0 : x0 + 32], poses[img_i],
           float(scene.times[img_i]), 1.0, gen)

    families = (("B7 forward", ("trunk_fwd", "trunk_tc")), ("B6 forward", ("time_net_fwd", "time_net_tc")),
                ("B6/B7 backward, tensor-core products", ("sweep_dw", "sweep_dh")),
                ("B6/B7 backward SIMT GEMMs and reductions", ("gemm_kernel", "reduce_kernel", "colsum", "head_bwd",
                                                              "cotangent_kernel", "round_cotangent")))
    for name, step in (("phase 1, level 0", phase1), ("phase 2", phase2)):
        profile_steps("25", name, step, families)


def profile_steps(tag, name, step, families):
    """Device time by kernel family (``families``: (name, key substrings))
    over 10 calls of ``step(i)`` after 3 warm-up calls, from torch.profiler's
    CUDA activity, against the host clock around the calls (synchronized):
    prints the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        step(1000 + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10):
            step(2000 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
    by = dict.fromkeys([f for f, _ in families] + ["other device work (PyTorch)"], 0.0)
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not us or not str(evt.device_type).endswith("CUDA"):  # kernels only, not the ops that launch them
            continue
        fam = next((f for f, keys in families if any(k in evt.key for k in keys)), "other device work (PyTorch)")
        by[fam] += us / 1e3 / 10
    busy = sum(by.values())
    if busy == 0.0:
        print(f"[{tag} breakdown] {name}: torch.profiler recorded no device time; wall {wall:.3f} ms per step")
        return
    print(f"[{tag} breakdown] {name}, device ms per step by kernel family (torch.profiler, 10 steps): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / busy:.1f}%)" for k, v in by.items()) + f"; busy {busy:.3f} of {wall:.3f} ms "
        f"wall per step: idle share {100 * (1 - busy / wall):.1f}%")


# ---------------------------------------------------------------- the fields' kernel routes and the mesh chain


@contextlib.contextmanager
def env(**values):
    """os.environ with ``values`` set (None: unset) inside the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def field_phases(dev, tmp, data, psnr_b3_frame0):
    """Phases 26-30. Returns the [kernel] rows of B7' and B8, and B7's at
    the mesh sweep's shape, with their main paths' launch counts."""
    rows = phase26_b7p(dev, data)
    rows.update(phase27_b8(dev))
    counts = phase28_routes(dev, tmp, data, psnr_b3_frame0)
    mesh_rows, mesh_counts = phase29_mesh(dev, tmp)
    rows.update(mesh_rows)
    # launches: B7' on the eager T-NeRF step (train mode, its backward) and
    # the T-NeRF render with no eval pass (forward only); B8 on the eager
    # vanilla step under SWNERF_FUSED_RAW=1 and in the B8 mesh sweep; B7 in
    # the default mesh sweep
    src = {"trunk[tnerf]": counts["tnerf step"], "trunk[tnerf,bwd]": counts["tnerf step"],
           "trunk[tnerf,render]": counts["tnerf render"], "trunk[raw]": counts["vanilla step B8"],
           "trunk[raw,bwd]": counts["vanilla step B8"], "trunk[raw,mesh]": mesh_counts["B8"],
           "trunk[mesh]": mesh_counts["B7"]}
    key = {"trunk[tnerf,render]": "trunk[tnerf]", "trunk[raw,mesh]": "trunk[raw]", "trunk[mesh]": "trunk"}
    for name, row in rows.items():
        row["launches"] = src[name].get(key.get(name, name), 0)
        print(f"[30 kernel] {name}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} -> {100 * row['bound_ms'] / row['ms']:.2f}% of the "
              f"bound, {row['launches']} launches on its main path")
    return list(rows.values())


def hold_to_twin(tag, packed, x, xv, graw, raw):
    """One field trunk kernel (B7' on embeddings, or B8 on positions and
    view directions: ``raw``) against its twin on the same inputs: fp32 raw
    within 1e-5 of its largest value (the trained densities reach the
    hundreds, where fp32's ulp is ~6e-5), the gradients and both input cotangents
    at check_fp32_grads' bar (float64 twin, and on weights perturbed at fp32's
    size); bf16 raw within 1e-2 of its largest value and the gradients within
    rel L2 1e-2; bit-equal repeats; in fp32 the forward-only launch
    bit-equal to the train-mode one, in bf16 (the tensor cores, whose sum
    order is not the SIMT train-mode forward's) held to the twin at the
    bf16 bar and to a second launch bit for bit instead. ``packed``
    is fp32; returns (the bf16 packing, max |d raw| in bf16, both
    launches)."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import trunk as b7

    fwd_bwd = b7.field_raw_fwd_bwd if raw else b7.trunk_fwd_bwd
    fwd = b7.field_raw if raw else b7.trunk
    plain = b7.field_raw_plain if raw else b7.trunk_plain
    plain_bwd = b7.field_raw_plain_bwd if raw else b7.trunk_plain_bwd
    names = ("dpts", "dviewdirs") if raw else ("demb", "dvemb")

    def gdict(grads, pk, d0, d1):
        return dict(b7.unpack_trunk_grads(grads, pk), **{names[0]: d0, names[1]: d1})

    err16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        pk = dataclasses.replace(packed, weights=packed.weights.to(dtype))
        out, gk, d0, d1 = fwd_bwd(pk, x, xv, graw, True, True)
        _, gk2, d02, d12 = fwd_bwd(pk, x, xv, graw, True, True)
        ref = plain(pk, x, xv)
        gr, r0, r1 = plain_bwd(pk, x, xv, graw, True, True)
        outf, outf2 = fwd(pk, x, xv), fwd(pk, x, xv)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in ((gk[0], gk2[0]), (gk[1], gk2[1]), (d0, d02), (d1, d12)))
        # the bf16 forward-only launch runs on the tensor cores: held to the
        # twin at the bf16 bar, and to itself bit for bit, instead
        tc = dtype == torch.bfloat16
        fwd_same = torch.equal(outf, outf2) if tc else torch.equal(outf, out)
        draw = (out - ref).abs().max().item()
        if tc:
            draw = max(draw, (outf - ref).abs().max().item())
        scale = ref.abs().max().item()
        kind = "fp32" if dtype == torch.float32 else "bf16"
        if dtype == torch.float32:
            print(f"[{tag} {kind}] max|draw|={draw:.3e} (max|raw| {scale:.3e}: {draw / scale:.2e} of it) repeat "
                  f"bit-equal={same}; forward-only launch bit-equal to train mode={fwd_same}")
            if draw > 1e-5 * scale or not same or not fwd_same:
                fail(f"{tag} fp32: raw beyond 1e-5 of its largest value, repeats differ or the forward-only launch "
                     "differs from the train-mode one")
            p64 = dataclasses.replace(packed, weights=packed.weights.double())
            g64 = plain_bwd(p64, x.double(), xv.double(), graw.double(), True, True)
            g64p = plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), x.double(), xv.double(),
                             graw.double(), True, True)
            check_fp32_grads(f"{tag} {kind}", gdict(gk, pk, d0, d1), gdict(gr, pk, r0, r1),
                             gdict(g64[0], p64, *g64[1:]), gdict(g64p[0], p64, *g64p[1:]))
        else:
            rel = rel_l2(gdict(gk, pk, d0, d1), gdict(gr, pk, r0, r1))
            err16 = draw
            what = "forward-only launch (tensor cores) repeat bit-equal" if tc else \
                "forward-only launch bit-equal to train mode"
            print(f"[{tag} {kind}] max|draw|={draw:.3e} (max|raw| {scale:.3e}{', both launches' if tc else ''}) grads "
                  f"and input cotangents max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat "
                  f"bit-equal={same}; {what}={fwd_same}")
            if draw > 1e-2 * scale or max(rel.values()) > 1e-2 or not same or not fwd_same:
                fail(f"{tag} bf16: raw beyond 1e-2 of its largest value, gradient rel L2 > 1e-2, repeats differ or "
                     f"the {what} check failed")
            pk16 = pk
        del gk, gk2, gr
        torch.cuda.empty_cache()
    return pk16, err16


def trunk_rows(prefix, pk16, x, xv, graw, raw, err, source_line, bwd_line):
    """The forward and backward [kernel] rows of one field trunk kernel at
    the rows of x (bf16, train-mode forward as the eager steps run it), and
    both launches' large products on cuBLAS beside their times."""
    from swnerf_torch.ops.kernels import trunk as b7

    n = x.shape[0]
    sc = b7._scratch(pk16, n, x.device, raw)
    fwd = cuda_ms(lambda: b7._launch_fwd(pk16, x, xv, sc, raw), 10)
    if raw:  # B8's train mode runs trunk_fwd_kernel (B7''s at W=128, the tensor cores)
        simt_forward(prefix, f"B8 ({prefix}) train mode, {n:,} rows", lambda: b7._launch_fwd(pk16, x, xv, sc, raw),
                     2 * pk16.macs_per_row * n)
    bwd = cuda_ms(lambda: b7._launch_bwd(pk16, n, graw, sc, False, False, (x, xv) if raw else None), 10)
    plain, plain_bwd = (b7.field_raw_plain, b7.field_raw_plain_bwd) if raw else (b7.trunk_plain, b7.trunk_plain_bwd)
    nw, nb = pk16.weights.numel(), pk16.biases.numel()
    in_bytes = 4 * (x.numel() + xv.numel())
    bwd_name = f"{prefix[:-1]},bwd]"  # trunk[tnerf] -> trunk[tnerf,bwd]
    rows = {
        prefix: entry(prefix, "swnerf_torch/csrc/trunk.cu", f"swnerf_tpu/ops/pallas/raymarch.py:{source_line}", 0, err,
                      fwd, cuda_ms(lambda: plain(pk16, x, xv), 3), in_bytes + 16 * n + 2 * nw + 4 * nb,
                      2 * pk16.macs_per_row * n, "bf16"),
        bwd_name: entry(bwd_name, "swnerf_torch/csrc/trunk.cu", f"swnerf_tpu/ops/pallas/raymarch.py:{bwd_line}", 0,
                        err, bwd, cuda_ms(lambda: plain_bwd(pk16, x, xv, graw, False, False), 3),
                        in_bytes + 16 * n + 2 * nw + 4 * (nw + nb), 2 * pk16.bwd_macs_per_row(False, False) * n,
                        "bf16"),
    }
    report_library(prefix, f"{bwd_name} bf16", n, sweep_products(pk16.W, pk16.D, pk16.skip, pk16.cin_pad,
                                                                  pk16.cv_pad), bwd, x.device, "backward")
    report_library(prefix, f"{prefix} bf16 train-mode forward", n,
                   forward_products(pk16.W, pk16.D, pk16.skip, pk16.cin_pad, pk16.cv_pad), fwd, x.device)
    del sc
    return rows


def b7p_inputs(rays, cfg, z):
    """B7''s inputs at rays x the samples z [n, s]: the embedding [embed(x)
    | embed(t)] and the view embedding, [n * s, .] each."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding

    n, s = z.shape
    pts = rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]
    t = rays.times.reshape(n, 1, 1).expand(n, s, 1)
    emb = torch.cat([positional_encoding(pts, cfg.nf_pts), positional_encoding(t, cfg.nf_time)], -1)
    vemb = positional_encoding(rays.viewdirs, cfg.nf_views)[:, None, :].expand(n, s, cfg.dir_feat)
    return emb.reshape(n * s, -1).contiguous(), vemb.reshape(n * s, -1).contiguous()


def b7p_rows(dev, data, cfg):
    """Phase 26's rows, one eager T-NeRF step's: 500 seeded pixels of train
    view 61 of phase 11's scene at its frame time x 64 jittered samples
    (32,000 rows). Returns emb, vemb, a seeded cotangent of raw [32,000, 4]
    and the training path's loss arguments for tc_model.composite (z,
    dists, noise std 1, white, the pixels' colours, 1 / (3 * 500)), drawn
    after the cotangent."""
    import torch

    from swnerf_torch.ops.sampling import sample_along_rays

    rays, img = frame_rays(dev, data, "train", 61)
    g = torch.Generator(device=dev).manual_seed(8)
    sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g)
    emb, vemb = b7p_inputs(r, cfg, z)
    graw = torch.randn((emb.shape[0], 4), generator=g, device=dev)
    noise = torch.randn(z.shape, generator=g, device=dev)
    return emb, vemb, graw, (z, b3_dists(z, r.directions), noise, True, img[sel], 1.0 / (3 * 500))


def phase26_b7p(dev, data):
    """B7' against its twin with the round-5 T-NeRF 800000.tar weights on
    one eager step's rows (500 seeded pixels of train view 61 at its frame
    time x 64 jittered samples = 32,000 rows): hold_to_twin's bars. Then its
    times there (train-mode forward, backward) and forward only at the
    serving chunk (32,768 rays x 64 samples = 2.1M rows)."""
    import torch

    from swnerf_torch.models import TNeRF, TNeRFConfig
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    cfg = TNeRFConfig()
    model = TNeRF(cfg, device=dev, fused=False)
    model.load_state_dict(tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"]))
    p32 = b7.pack_tnerf_trunk_params(model.state_dict(), cfg, torch.float32)
    emb, vemb, graw, _ = b7p_rows(dev, data, cfg)
    print(f"[26 B7'] {emb.shape[0]} rows, emb {p32.cin} of 128, vemb {p32.input_ch_views} of 128, D={p32.D}, "
          f"W={p32.W}; colour logits > 0: {(b7.trunk_plain(p32, emb, vemb)[:, :3] > 0).float().mean().item():.3f}")
    p16, err = hold_to_twin("26 B7'", p32, emb, vemb, graw, False)
    rows = trunk_rows("trunk[tnerf]", p16, emb, vemb, graw, False, err, 435, 446)
    rays, _ = frame_rays(dev, data, "test", 0)
    chunk = rays.slice(0, 32768)
    big, bigv = b7p_inputs(chunk, cfg, sample_along_rays(chunk.near, chunk.far, 64, 0.0))
    out, ref = b7.trunk(p16, big[-32000:], bigv[-32000:]), b7.trunk_plain(p16, big[-32000:], bigv[-32000:])
    draw = (out - ref).abs().max().item()
    print(f"[26 B7' check] the serving chunk's last 32,000 rows, forward only, bf16: max|draw|={draw:.3e} "
          f"(max|raw| {ref.abs().max().item():.3e})")
    if draw > 1e-2 * ref.abs().max().item():
        fail("B7' bf16 at the serving chunk: raw beyond 1e-2 of its largest value")
    n = big.shape[0]
    nw, nb = p16.weights.numel(), p16.biases.numel()
    rows["trunk[tnerf,render]"] = entry(
        "trunk[tnerf,render]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:435", 0, draw,
        cuda_ms(lambda: b7.trunk(p16, big, bigv), 3), cuda_ms(lambda: b7.trunk_plain(p16, big, bigv), 2),
        4 * (big.numel() + bigv.numel()) + 16 * n + 2 * nw + 4 * nb, 2 * p16.macs_per_row * n, "bf16")
    report_library("26", "trunk[tnerf,render] bf16 forward only, the serving chunk", n,
                   forward_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), rows["trunk[tnerf,render]"]["ms"],
                   dev)
    for k, row in rows.items():
        print(f"[26 times] {k}: {row['ms']:.3f} ms, {100 * row['bound_ms'] / row['ms']:.2f}% of the bf16 bound "
              f"({p16.macs_per_row} MACs per row forward, {p16.bwd_macs_per_row(False, False)} backward)")
    del big, bigv, model
    torch.cuda.empty_cache()
    return rows


def phase27_b8(dev):
    """B8 against its twin with 010000.tar's fine weights on 1024 rays of
    train view r_0 x 192 jittered samples (196,608 rows; d pts and d
    viewdirs at the fp32 bar): hold_to_twin's bars. Then its times at
    32,000 rows (train-mode forward, backward), and the forward-only launch
    at one mesh tile (2,048 points x 100 views = 204,800 rows) held to its
    twin (raw within 1e-2 of its largest value) and timed."""
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.pipelines.extract_mesh import fibonacci_sphere
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    cfg = VanillaNeRFConfig()
    fine = VanillaNeRF(cfg, device=dev, fused=False)
    fine.load_state_dict(vanilla_state_dict(load_tar(str(CKPT))["network_fine_state_dict"]))
    p32 = b7.pack_trunk_params(fine.state_dict(), cfg, torch.float32)
    rays, _ = train_view_rays(dev, 1024, seed=9)
    g = torch.Generator(device=dev).manual_seed(9)
    z = sample_along_rays(rays.near, rays.far, 192, 1.0, generator=g)
    pts = (rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
    vd = rays.viewdirs[:, None, :].expand(1024, 192, 3).reshape(-1, 3).contiguous()
    graw = torch.randn((pts.shape[0], 4), generator=g, device=dev)
    print(f"[27 B8] {pts.shape[0]} rows, encoded in the kernel at {p32.n_freqs} frequencies ({p32.cin} and "
          f"{p32.input_ch_views} columns), D={p32.D}, W={p32.W}")
    p16, err = hold_to_twin("27 B8", p32, pts, vd, graw, True)
    rows = trunk_rows("trunk[raw]", p16, pts[:32000].contiguous(), vd[:32000].contiguous(), graw[:32000].contiguous(),
                      True, err, 556, 569)
    # one mesh tile: 2,048 grid points x 100 fibonacci directions
    ax = torch.linspace(-2.0, 2.0, 128, device=dev)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)[64 * 128 * 128:][:2048]
    dirs = torch.as_tensor(fibonacci_sphere(100), device=dev)
    tp = grid[None].expand(100, 2048, 3).reshape(-1, 3).contiguous()
    tv = dirs[:, None, :].expand(100, 2048, 3).reshape(-1, 3).contiguous()
    n = tp.shape[0]
    out, ref = b7.field_raw(p16, tp, tv), b7.field_raw_plain(p16, tp, tv)
    draw = (out - ref).abs().max().item()
    print(f"[27 B8 check] one mesh tile ({n} rows), forward only (tensor cores), bf16: max|draw|={draw:.3e} (max|raw| "
          f"{ref.abs().max().item():.3e})")
    if draw > 1e-2 * ref.abs().max().item():
        fail("B8 bf16 at the mesh tile: raw beyond 1e-2 of its largest value")
    del out, ref
    nw, nb = p16.weights.numel(), p16.biases.numel()
    rows["trunk[raw,mesh]"] = entry(
        "trunk[raw,mesh]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:556", 0, draw,
        cuda_ms(lambda: b7.field_raw(p16, tp, tv), 5), cuda_ms(lambda: b7.field_raw_plain(p16, tp, tv), 2),
        4 * (tp.numel() + tv.numel()) + 16 * n + 2 * nw + 4 * nb, 2 * p16.macs_per_row * n, "bf16")
    for k, row in rows.items():
        print(f"[27 times] {k}: {row['ms']:.3f} ms, {100 * row['bound_ms'] / row['ms']:.2f}% of the bf16 bound")
    del fine
    torch.cuda.empty_cache()
    return rows


def _cli(run, argv, envs, tee=False):
    """One CLI call under ``envs`` with the launch counts cleared just
    before it: (its result, its output, its launch counts, wall seconds)."""
    import torch

    from swnerf_torch.ops.kernels import launches

    buf = io.StringIO()
    with env(**envs):
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf) if tee else buf):
            res = run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    return res, buf.getvalue(), counts, wall


def _train_cli(run, argv, envs, exp, prints, floor, tag):
    """One trainer CLI run under ``envs``: its output, launch counts, train
    PSNRs at the prints (each >= ``floor``) and its median step (ms) over
    the steps that neither print nor save. Returns (launch counts, that
    median)."""
    res, out, counts, wall = _cli(run, argv, envs, tee=True)
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    every = int(argv[argv.index("--i_print") + 1])
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % every and (i - 1) % every}
    med = statistics.median(quiet.values())
    print(f"[{tag}] launches {json.dumps(counts, sort_keys=True)}, CLI wall {wall:.2f} s; train PSNR at the prints "
          f"{psnrs}; ms per step, median of {len(quiet)} steps that do not print (CUDA events): {med:.3f}")
    if "eager autograd train step" not in out:
        fail(f"{tag}: the run did not take the eager step")
    if len(psnrs) != prints or min(p for _, p in psnrs) < floor:
        fail(f"{tag}: train PSNR below {floor} dB at a print (or not {prints} prints): {psnrs}")
    return counts, med


def phase28_routes(dev, tmp, data, psnr_b3_frame0):
    """The fields' kernel routes through the CLIs:
    - run_nerf resumed from 010000.tar for 200 eager steps
      (SWNERF_FUSED_STEP=0: B7 in the fields), then again under
      SWNERF_FUSED_RAW=1 (B8), each >= 30 dB at every print;
    - run_nerf --render_only, test frame 0 with SWNERF_FUSED_EVAL=0 (the
      fields through B7), within 0.1 dB of phase 5's frame 0 (the B3 eval
      pass);
    - run_tnerf resumed from 800000.tar for 200 eager steps (B7'), >= 19 dB
      at every print, B4 not launched;
    - run_tnerf --render_only --testskip 5 with the eval pass (B4) and with
      SWNERF_FUSED_EVAL=0 (B7'): mean PSNRs within 0.1 dB;
    - run_dnerf resumed from its 800000.tar for 10 steps under SWNERF_FUSED=0:
      the fp32 plain route, no field kernel launched (B2, sample_pdf, has
      its own switch in the JAX package, SWNERF_PALLAS_SAMPLE_PDF).
    Returns the launch counts of the paths that run B7' and B8."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_dnerf, run_nerf, run_tnerf

    counts = {}
    for tag, extra in (("vanilla step B7", {}), ("vanilla step B8", {"SWNERF_FUSED_RAW": "1"})):
        base = tmp / tag.replace(" ", "_")
        argv = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(base), "--datadir", str(DATADIR),
                "--device", "cuda", "--i_print", "50", "--i_weights", "100000"]
        c, _ = _train_cli(run_nerf.main, argv, dict(SWNERF_FUSED_STEP="0", SWNERF_MAX_ITERS="10201", **extra),
                       base / "full_nerf_200k", 4, 30.0, f"28 {tag}")
        kern, kern_bwd, other = ("trunk[raw]", "trunk[raw,bwd]", "trunk") if extra else ("trunk", "trunk[bwd]",
                                                                                         "trunk[raw]")
        if c.get(kern, 0) < 400 or c.get(kern_bwd, 0) < 400 or c.get(other, 0) or \
                any(k.startswith("render_loss") for k in c):
            fail(f"28 {tag}: launches {c}")
        counts[tag] = c
    argv = ["--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "25", "--device", "cuda",
            "--basedir", str(tmp / "serve_b7"), "--datadir", str(DATADIR), "--ft_path", str(CKPT)]
    with env(SWNERF_FUSED_EVAL="0"):
        launches.clear()
        t0 = time.perf_counter()
        savedir = Path(run_nerf.main(argv))
        torch.cuda.synchronize()
        c = dict(launches)
    m = json.loads((savedir / "metrics.json").read_text())
    d = m["psnr"][0] - psnr_b3_frame0
    print(f"[28 vanilla render B7] test frame 0 through the fields (SWNERF_FUSED_EVAL=0): PSNR {m['psnr'][0]:.3f} dB, "
          f"the B3 eval pass {psnr_b3_frame0:.3f} dB (delta {d:+.4f}); {m['seconds_per_frame'][0]:.3f} s for the "
          f"frame; launches {json.dumps(c, sort_keys=True)}; wall {time.perf_counter() - t0:.2f} s")
    if abs(d) > 0.1 or c.get("trunk", 0) <= 0 or any(k.startswith("render_pass") for k in c):
        fail(f"28 vanilla render B7: |dPSNR| {abs(d)} > 0.1 dB, or launches {c}")

    base = tmp / "tnerf_eager"
    argv = ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--basedir", str(base), "--datadir", str(data),
            "--device", "cuda", "--i_print", "50", "--i_weights", "100000"]
    c, TNERF_STEP_MS["B7' eager step (phase 28)"] = _train_cli(
        run_tnerf.main, argv, dict(SWNERF_FUSED_STEP="0", SWNERF_MAX_ITERS="800201"), base / "full_tnerf_800k", 4,
        19.0, "28 tnerf step B7'")
    if c.get("trunk[tnerf]", 0) < 200 or c.get("trunk[tnerf,bwd]", 0) < 200 or c.get("render_loss[tnerf,S=64]", 0):
        fail(f"28 tnerf step B7': launches {c}")
    counts["tnerf step"] = c
    psnr, frame_ms = {}, {}
    for tag, envs in (("B4 eval pass", {}), ("B7' (SWNERF_FUSED_EVAL=0)", {"SWNERF_FUSED_EVAL": "0"})):
        argv = ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--basedir", str(tmp / "tnerf_serve"),
                "--datadir", str(data), "--device", "cuda", "--render_only", "--render_test", "--testskip", "5"]
        with env(**envs):
            launches.clear()
            savedir = Path(run_tnerf.main(argv))
            torch.cuda.synchronize()
            c = dict(launches)
        m = json.loads((savedir / "metrics.json").read_text())
        psnr[tag] = m["psnr"]
        secs = m["seconds_per_frame"]
        frame_ms[tag] = 1e3 * sum(secs[1:]) / len(secs[1:])
        print(f"[28 tnerf render {tag}] PSNR {[round(p, 4) for p in m['psnr']]} (mean {sum(m['psnr']) / len(secs):.4f}"
              f" dB), {1e3 * sum(secs[1:]) / len(secs[1:]):.2f} ms per frame after the first; launches "
              f"{json.dumps(c, sort_keys=True)}")
        if envs:
            counts["tnerf render"] = c
            if c.get("trunk[tnerf]", 0) <= 0 or any(k.startswith("render_pass") for k in c):
                fail(f"28 tnerf render B7': launches {c}")
    means = [sum(v) / len(v) for v in psnr.values()]
    print(f"[28 tnerf render] mean PSNR B4 {means[0]:.4f} dB, B7' {means[1]:.4f} dB: |delta| "
          f"{abs(means[0] - means[1]):.4f} dB")
    steps = "; ".join(f"{k} {v:.3f}" for k, v in TNERF_STEP_MS.items())
    fms = list(frame_ms.values())
    print(f"[28 tnerf routes] ms per frame after the first: B7' {fms[1]:.2f}, B4 eval pass {fms[0]:.2f}; ms per "
          f"step, median: {steps}")
    TC_SUMMARY["T-NeRF frame through B7' (phase 28)"] = f"{fms[1]:.2f} ms per frame (B4's eval pass {fms[0]:.2f})"
    TC_SUMMARY["T-NeRF step, median (phases 15, 28)"] = steps
    if abs(means[0] - means[1]) > 0.1 or len(psnr["B4 eval pass"]) != 5:
        fail("28 tnerf render: B7''s mean PSNR more than 0.1 dB from the B4 eval pass's (or not 5 frames)")

    base = tmp / "dnerf_plain"
    argv = ["--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--basedir", str(base), "--datadir",
            str(data), "--device", "cuda", "--i_print", "5", "--i_weights", "100000"]
    buf = io.StringIO()
    with env(SWNERF_FUSED="0", SWNERF_MAX_ITERS="800011"):
        launches.clear()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_dnerf.main(argv)
        torch.cuda.synchronize()
        c = dict(launches)
    print(f"[28 dnerf SWNERF_FUSED=0] 10 steps, launches {json.dumps(c, sort_keys=True)} (B2 follows its own switch, "
          f"as the JAX package's Pallas sample_pdf does), last metrics {res['metrics']}")
    if set(c) - {"sample_pdf"} or "eager autograd train step" not in buf.getvalue():
        fail(f"28 dnerf SWNERF_FUSED=0: the plain route launched {c} or did not take the eager step")
    return counts


MESH_BOUNDS = "[[-2.0,2.0],[-2.0,2.0],[-2.0,2.0]]"  # the drill recipe's (benchmarks/tpu_sw_chain.py:158-160)
MESH_VOXEL = 4.0 / 127


def phase29_mesh(dev, tmp):
    """The SW mesh chain at the drill recipe (benchmarks/tpu_sw_chain.py):
    extract_mesh on 010000.tar's fine network, 128^3 points x 100 views
    over [-2, 2]^3, threshold 25, three times: the B7 route (bf16, the
    default), the B8 route (SWNERF_FUSED_RAW=1) and the plain fp32 route
    (SWNERF_FUSED=0). Each kernel mesh against the plain one: vertex and
    face counts within 2%, bounding boxes within one voxel, the symmetric
    mean nearest-vertex distance under 0.25 voxel. Then the metric-scale
    solve without cv2 on the B7 mesh (phase 30's checks). Returns B7's mesh
    [kernel] row and the launch counts by route."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import extract_mesh
    from swnerf_torch.utils.mesh import load_obj

    routes = {"B7": {}, "B8": {"SWNERF_FUSED_RAW": "1"}, "plain fp32": {"SWNERF_FUSED": "0"}}
    meshes, counts = {}, {}
    for name, envs in routes.items():
        argv = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(tmp / f"mesh_{len(meshes)}"),
                "--device", "cuda", "--resolution", "128", "--threshold", "25"]
        with env(SWNERF_MESH_BOUNDS=MESH_BOUNDS, SWNERF_MESH_VIEWS="100", **envs):
            launches.clear()
            res = extract_mesh.main(argv)
            counts[name] = dict(launches)
        v, f, _ = load_obj(res["path"])
        meshes[name] = (v, f, res)
        print(f"[29 mesh {name}] {res['verts']} vertices, {res['faces']} faces; sweep {1e3 * res['sweep_s']:.1f} ms "
              f"(128^3 x 100 = {128**3 * 100} rows, synchronized), marching {1e3 * res['march_s']:.1f} ms + OBJ write "
              f"{1e3 * res['write_s']:.1f} ms; launches {json.dumps(counts[name], sort_keys=True)}")
    if counts["B7"] != {"trunk": 1024} or counts["B8"] != {"trunk[raw]": 1024} or counts["plain fp32"]:
        fail(f"29 mesh: the sweeps' launches {counts} (want 1,024 B7 tiles, 1,024 B8 tiles, none)")
    pv, pf, _ = meshes["plain fp32"]
    tree = cKDTree(pv)
    for name in ("B7", "B8"):
        v, f, _ = meshes[name]
        dn, df = abs(len(v) - len(pv)) / len(pv), abs(len(f) - len(pf)) / len(pf)
        dbox = max(np.abs(v.min(0) - pv.min(0)).max(), np.abs(v.max(0) - pv.max(0)).max())
        near = 0.5 * (tree.query(v)[0].mean() + cKDTree(v).query(pv)[0].mean())
        print(f"[29 mesh {name} vs plain fp32] vertices {len(v)} vs {len(pv)} ({100 * dn:.3f}%), faces {len(f)} vs "
              f"{len(pf)} ({100 * df:.3f}%), bounding boxes within {dbox:.4e} ({dbox / MESH_VOXEL:.3f} voxel), "
              f"symmetric mean nearest-vertex distance {near:.4e} ({near / MESH_VOXEL:.4f} voxel)")
        if len(pv) < 1000 or dn > 0.02 or df > 0.02 or dbox > MESH_VOXEL or near > 0.25 * MESH_VOXEL:
            fail(f"29 mesh {name}: outside the bars against the plain fp32 mesh")
    phase30_scale(meshes["B7"][2]["path"], tmp)

    # B7 at the sweep's tile, forward only (bf16): 2,048 points x 100 views
    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    cfg = VanillaNeRFConfig()
    fine = VanillaNeRF(cfg, device=dev, fused=False)
    fine.load_state_dict(vanilla_state_dict(load_tar(str(CKPT))["network_fine_state_dict"]))
    p16 = b7.pack_trunk_params(fine.state_dict(), cfg, torch.bfloat16)
    ax = torch.linspace(-2.0, 2.0, 128, device=dev)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)[64 * 128 * 128:][:2048]
    dirs = torch.as_tensor(extract_mesh.fibonacci_sphere(100), device=dev)
    emb = positional_encoding(grid, cfg.nf_pts)[None].expand(100, 2048, cfg.input_ch).reshape(-1, cfg.input_ch)
    vemb = positional_encoding(dirs, cfg.nf_views)[:, None, :].expand(100, 2048, cfg.input_ch_views)
    emb, vemb = emb.contiguous(), vemb.reshape(-1, cfg.input_ch_views).contiguous()
    out, ref = b7.trunk(p16, emb, vemb), b7.trunk_plain(p16, emb, vemb)
    draw = (out - ref).abs().max().item()
    print(f"[29 B7 check] one mesh tile (204,800 rows), forward only, bf16: max|draw|={draw:.3e} "
          f"(max|raw| {ref.abs().max().item():.3e})")
    if draw > 1e-2 * ref.abs().max().item():
        fail("B7 bf16 at the mesh tile: raw beyond 1e-2 of its largest value")
    n = emb.shape[0]
    nw, nb = p16.weights.numel(), p16.biases.numel()
    row = entry("trunk[mesh]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:435", 0, draw,
                cuda_ms(lambda: b7.trunk(p16, emb, vemb), 5), cuda_ms(lambda: b7.trunk_plain(p16, emb, vemb), 2),
                4 * (emb.numel() + vemb.numel()) + 16 * n + 2 * nw + 4 * nb, 2 * p16.macs_per_row * n, "bf16")
    report_library("29", "trunk[mesh] bf16 forward only, one tile", n,
                   forward_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), row["ms"], dev)
    sweep_bound = 1024 * row["bound_ms"]
    print(f"[29 times] trunk[mesh]: {row['ms']:.3f} ms per tile, {100 * row['bound_ms'] / row['ms']:.2f}% of the bf16 "
          f"bound ({p16.macs_per_row} MACs per row); 1,024 tiles at the bound: {sweep_bound:.1f} ms, measured sweep "
          f"{1e3 * meshes['B7'][2]['sweep_s']:.1f} ms")
    del emb, vemb
    torch.cuda.empty_cache()
    split, wall = sweep_split(fine, cfg)
    total = sum(split.values())
    print(f"[29 sweep split] the B7 sweep's 1,024 tiles as query_views runs them, weights packed at every tile (as "
          f"apply_field does outside trunk.packed_once; sample_grid packs once): device ms by step, CUDA events per "
          f"tile: " + ", ".join(
              f"{k} {v:.1f} ({100 * v / total:.1f}%)" for k, v in split.items()) + f"; sum {total:.1f} ms, host clock "
          f"{1e3 * wall:.1f} ms; the sweep through extract_mesh (one packing) "
          f"{1e3 * meshes['B7'][2]['sweep_s']:.1f} ms")
    TC_SUMMARY["B7 mesh sweep (phase 29)"] = (
        f"{1e3 * meshes['B7'][2]['sweep_s']:.1f} ms for 1,024 tiles through extract_mesh; per tile "
        f"{split['B7 launch'] / 1024:.3f} ms in the B7 launch, {split['weight packing'] / 1024:.3f} ms packing when "
        "packed per tile")
    del fine
    torch.cuda.empty_cache()
    return {"trunk[mesh]": row}, counts


def sweep_split(fine, cfg):
    """The B7 mesh sweep of phase 29 (128^3 points over [-2, 2]^3 x 100 views
    in 2,048-point tiles, bf16) split per tile with CUDA events, in the steps
    VanillaNeRF.query_views and trunk.apply_field take: the encode of the
    points and the directions, the weight packing (pack_trunk_params at
    every tile), the copy of the broadcast embeddings to contiguous rows, the
    B7 launch, and the rest (the mean over the views, the store, and the
    device's idle time between the steps). Returns (device ms by step, summed
    over the tiles; the host clock's seconds for the loop)."""
    import numpy as np
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.pipelines.extract_mesh import fibonacci_sphere

    dev = next(fine.parameters()).device
    ax = np.linspace(-2.0, 2.0, 128)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.as_tensor(np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32), device=dev)
    dirs = torch.as_tensor(fibonacci_sphere(100), device=dev)
    V, C = dirs.shape[0], 2048
    params = dict(fine.named_parameters())
    out = torch.empty((pts.shape[0], 4), device=dev)
    steps = ("encode", "weight packing", "embedding copy", "B7 launch")
    tiles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for start in range(0, pts.shape[0], C):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            pe, ve = positional_encoding(pts[start : start + C], cfg.nf_pts), positional_encoding(dirs, cfg.nf_views)
            ev[1].record()
            packed = b7.pack_trunk_params(params, cfg, torch.bfloat16)
            ev[2].record()
            x = pe[None].expand(V, C, pe.shape[-1]).reshape(-1, pe.shape[-1])
            xv = ve[:, None, :].expand(V, C, ve.shape[-1]).reshape(-1, ve.shape[-1]).contiguous()
            ev[3].record()
            raw = b7.trunk(packed, x, xv)
            ev[4].record()
            out[start : start + C] = raw.reshape(V, C, 4).mean(0)
            tiles.append(ev)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: sum(ev[i].elapsed_time(ev[i + 1]) for ev in tiles) for i, k in enumerate(steps)}
    split["rest"] = tiles[0][0].elapsed_time(end) - sum(split.values())
    return split, wall


def phase30_scale(mesh_path, tmp):
    """The metric-scale solve without cv2 (transform_mesh after detection):
    a 0.5-unit square marker on the z = 0 plane, its corners projected
    exactly into the capture's train poses (pinhole, zero distortion; the
    OpenGL poses turned to +z forward as benchmarks/tpu_sw_chain.py:67-71
    does), then calculate_3d_corners -> marker_edge_lengths -> scale ->
    alignment_matrix -> transform_mesh on the B7 mesh: the scale is
    real_length / 0.5 within 1e-4 relative, the marker normal maps to +z
    within 1e-6, and the transformed mesh is the mesh scaled and turned."""
    import numpy as np

    from swnerf_torch.pipelines import transform_mesh as tm
    from swnerf_torch.utils.mesh import load_obj

    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    e = 0.5
    world = np.array([[-e / 2, e / 2, 0.0], [e / 2, e / 2, 0.0], [e / 2, -e / 2, 0.0], [-e / 2, -e / 2, 0.0]])
    flip = np.diag([1.0, -1.0, -1.0])
    info = []
    for fr in meta["frames"]:
        c2w_gl = np.array(fr["transform_matrix"], np.float64)
        R, t = c2w_gl[:3, :3] @ flip, c2w_gl[:3, 3]
        cam = (world - t) @ R  # R^T (p - t), row-wise
        if (cam[:, 2] <= 1e-6).any():
            continue
        px = focal * cam[:, :2] / cam[:, 2:] + np.array([W / 2.0, H / 2.0])
        if px.min() < 8 or px.max() > W - 8:
            continue
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        info.append({"frame": {"transform_matrix": c2w.tolist()}, "id": 7, "corners": px})
    real = 0.05
    t0 = time.perf_counter()
    corners = tm.calculate_3d_corners(info, (focal, focal, W / 2.0, H / 2.0, 0.0, 0.0, 0.0, 0.0))
    mean_len, lengths = tm.marker_edge_lengths(corners)
    scale = real / mean_len
    T = tm.alignment_matrix(corners)
    out = str(tmp / "transformed_mesh.obj")
    tm.transform_mesh(mesh_path, out, scale, T)
    wall = time.perf_counter() - t0
    normal = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    n2 = T[:3, :3] @ (normal / np.linalg.norm(normal))
    v, _, _ = load_obj(mesh_path)
    v2, _, _ = load_obj(out)
    moved = np.abs(v2 - (scale * v.astype(np.float64)) @ T[:3, :3].T).max()
    rel = abs(scale - real / e) / (real / e)
    print(f"[30 scale] {len(info)} of {len(meta['frames'])} train poses see the marker; corners "
          f"{np.round(corners, 6).tolist()}; edges {[round(x, 8) for x in lengths]}; scale {scale:.8f} (want "
          f"{real / e}: rel {rel:.2e}); marker normal -> {np.round(n2, 9).tolist()}; transformed mesh within "
          f"{moved:.2e} of T (s v); solve + transform {1e3 * wall:.1f} ms")
    if len(info) < 3 or rel > 1e-4 or np.abs(n2 - [0.0, 0.0, 1.0]).max() > 1e-6 or moved > 1e-5 * max(1.0, scale):
        fail("30 scale: the metric-scale solve missed the known scale, the +z alignment or the transform")


# ---------------------------------------------------------------- MultiRes on the render kernels; B10; B11

MR_CKPT_ITER = 200  # phase 25's last checkpoint, 000200.tar


def render_kernel_phases(dev, tmp, data, psnr5):
    """Phases 31-35 on phase 25's 000200.tar (the MultiRes run from scratch,
    live densities), phase 11's scene and phase 5's PSNRs. Returns the
    [kernel] rows of B3's pts mode at the MultiRes widths, B9 (wide and
    narrow), B10 and B11, with their paths' launch counts."""
    import torch

    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import load_scene

    args = mr_args("--datadir", str(data), "--basedir", str(tmp / "mr_logs"), "--device", "cuda", *MR_NOISE)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    _, states, pyr_hwf, rcfg, start = mr.create_multires(args, scene, dev)
    if start != MR_CKPT_ITER:
        fail(f"phases 31-33 need {MR_CKPT_ITER:06d}.tar, found {start}")
    t0 = time.perf_counter()

    def done(phase):
        nonlocal t0
        print(f"[{phase} done] in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    rows = phase31_b3w_b9(dev, data, states)
    done(31)
    serve = phase32_testset(dev, args, scene, states, pyr_hwf, rcfg)
    done(32)
    del states
    torch.cuda.empty_cache()
    train = phase33_fused(dev, tmp, data, scene, pyr_hwf)
    done(33)
    rows.update(phase34_b10(dev, tmp, data, psnr5))
    done(34)
    rows.update(phase35_b11(dev, data))
    done(35)
    rows["render_pass[pts,wide]"]["launches"] = serve.get("render_pass[pts,wide,S=64]", 0) + \
        train.get("render_pass[pts,wide,S=64]", 0)
    rows["render_loss[ext,wide]"]["launches"] = train.get("render_loss[ext,wide,S=64]", 0)
    rows["render_loss[ext]"]["launches"] = train.get("render_loss[ext,S=64]", 0)
    for name, row in rows.items():
        print(f"[35 kernel] {name}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms"
              + (f", library {row['library_ms']:.3f} ms" if row["library_ms"] is not None else "")
              + f"), bound {row['bound_ms']:.4f} ms by {row['bound_by']} -> "
              f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound, {row['launches']} launches on its path")
    return list(rows.values())


def mr_inputs(dev, data, states, n=1024, seed=0):
    """``n`` seeded pixels of train view 37 at its frame time x 64 jittered
    samples, noise std 1, a seeded per-ray cotangent of (rgb, acc, depth)
    (all non-zero), and per level of ``states``: the warped positions
    (pts + dx by the level's fp32 B6 twin, the t == 0 mask) and the view
    embedding."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import sample_along_rays

    rays, _ = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(seed)
    sel = torch.randint(0, rays.origins.shape[0], (n,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g).contiguous()
    pts = (r.origins[:, None, :] + r.directions[:, None, :] * z[..., None]).contiguous()
    t = r.times.reshape(-1).contiguous()
    noise = torch.randn(z.shape, generator=g, device=dev)
    gct = torch.randn((n, 5), generator=g, device=dev)
    levels = []
    for st in states:
        cfg = st.coarse.cfg
        dx = b6.time_net_plain(b6.pack_time_params(st.coarse.state_dict(), cfg, torch.float32), pts, t)
        if cfg.zero_canonical:
            dx = torch.where((t == 0.0)[:, None, None], torch.zeros_like(dx), dx)
        levels.append(((pts + dx).contiguous(), positional_encoding(r.viewdirs, cfg.nf_views).contiguous()))
    return {"z": z, "dist": b3_dists(z, r.directions), "noise": noise, "gct": gct, "pts": pts, "times": t,
            "levels": levels}


def phase31_b3w_b9(dev, data, states):
    """B3's pts mode at the MultiRes widths (levels 0-2) and B9 (levels 0-3,
    narrow at the identity level) against their twins with 000200.tar's
    per-level weights on 1,024 pixels x 64 samples; then their times at the
    test render's chunk (32,768 rays x 64, level 0) and phase 2's level-0
    rows (1,024 x 64). Returns the [kernel] rows."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.render.fused_eval import canonical_params

    inp = mr_inputs(dev, data, states)
    z, dist, noise, gct = inp["z"], inp["dist"], inp["noise"], inp["gct"]
    err16 = {"b3": 0.0, "b9": 0.0, "b9n": 0.0}
    packs = {}
    for level, st in enumerate(states):
        cfg = st.coarse.cfg
        canon = canonical_params(st.coarse.state_dict())
        warped, ve = inp["levels"][level]
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            packed = b3.pack_params(canon, cfg, dtype)
            packs[(level, tag)] = (packed, warped, ve)
            got = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, warped)
            if level < 3:  # B3 at the wide widths: the test render's levels
                ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, warped)
                torch.cuda.synchronize()
                drgb = (got.rgb - ref.rgb).abs()
                dacc = (got.acc - ref.acc).abs().max().item()
                depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
                print(f"[31 B3 wide {tag} level {level}] {packed.cin} / {packed.input_ch_views} of {packed.cin_pad} / "
                      f"{packed.cv_pad} rows: max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} "
                      f"max|dacc|={dacc:.3e} depth_within_rtol={depth_ok}")
                if dtype == torch.float32 and (drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok):
                    fail(f"B3 wide fp32 level {level} outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
                if dtype == torch.bfloat16:
                    err16["b3"] = max(err16["b3"], drgb.max().item())
                    if drgb.max().item() > 1e-2:
                        fail(f"B3 wide bf16 level {level}: max |drgb| > 1e-2")
                del ref
            # the training path's B3 launch (bf16: the SIMT body, as B9 recomputes it)
            train = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, warped, ordered=True)
            fwd, gk, dk = b1.render_loss_ext(packed, warped, ve, z, dist, noise, gct, True)
            _, gk2, dk2 = b1.render_loss_ext(packed, warped, ve, z, dist, noise, gct, True)
            _, gr, dr = b1.render_loss_ext_plain(packed, warped, ve, z, dist, noise, gct, True)
            torch.cuda.synchronize()
            same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
            fwd_same = all(torch.equal(getattr(fwd, k), getattr(train, k)) for k in ("rgb", "acc", "depth", "weights"))
            print(f"[31 B9 {tag} level {level}] wide={packed.wide}: recomputed forward bit-equal to the training "
                  f"path's B3 launch={fwd_same}, repeat bit-equal={same}, max|ddpts|={(dk - dr).abs().max().item():.3e} "
                  f"(max|dpts| {dr.abs().max().item():.3e})")
            if not same or not fwd_same:
                fail(f"B9 {tag} level {level}: repeats differ or its forward differs from the B3 launch")
            if dtype == torch.float32:
                p64 = dataclasses.replace(packed, weights=packed.weights.double())
                a64 = [x.double() for x in (ve, z, dist, noise)]
                _, g64, d64 = b1.render_loss_ext_plain(p64, warped.double(), *a64, gct.double(), True)
                _, g64p, d64p = b1.render_loss_ext_plain(dataclasses.replace(p64, weights=jitter(p64.weights)),
                                                         warped.double(), *a64, gct.double(), True)
                check_fp32_grads(f"31 B9 fp32 level {level}", *(
                    dict(b1.unpack_grads(gg, pp), dpts=dd)
                    for gg, dd, pp in ((gk, dk, packed), (gr, dr, packed), (g64, d64, p64), (g64p, d64p, p64))))
                del g64, g64p
            else:
                rel = rel_l2(dict(b1.unpack_grads(gk, packed), dpts=dk), dict(b1.unpack_grads(gr, packed), dpts=dr))
                drgb = (fwd.rgb - b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None,
                                                       warped).rgb).abs().max().item()
                print(f"[31 B9 bf16 level {level}] max|drgb|={drgb:.3e} grads and dpts max rel L2="
                      f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})")
                if drgb > 1e-2 or max(rel.values()) > 1e-2:
                    fail(f"B9 bf16 level {level}: rgb beyond 1e-2 or gradient rel L2 > 1e-2")
                key = "b9n" if level == 3 else "b9"
                err16[key] = max(err16[key], drgb)
            del gk, gk2, gr, fwd, got, train
            torch.cuda.empty_cache()

    # B9's bf16 gradients on seeded, unsaturated weights (levels 0, 1 and the
    # identity level; 000200.tar's level 0 saturates) held at the bar, beside
    # the twin's distance from itself summed in another order (the same bf16
    # twin on the CPU): the gradients' sensitivity to fp32 summation order
    # (PERF.md §6)
    n9 = 256
    for level in (0, 1, 3):
        model = mr_level_model(dev, level, seed=10, fused=False)
        pk = b3.pack_params(canonical_params(model.state_dict()), model.cfg, torch.bfloat16)
        warped_l, ve_l = inp["levels"][level]
        args = [x[:n9].contiguous() for x in (warped_l, ve_l, z, dist, noise, gct)]
        _, gk, dk = b1.render_loss_ext(pk, *args, True)
        _, gr, dr = b1.render_loss_ext_plain(pk, *args, True)
        pkc = dataclasses.replace(pk, weights=pk.weights.cpu(), biases=pk.biases.cpu())
        _, gc, dc = b1.render_loss_ext_plain(pkc, *(x.cpu() for x in args), True)
        ref = dict(b1.unpack_grads(gr, pk), dpts=dr)
        kern = rel_l2(dict(b1.unpack_grads(gk, pk), dpts=dk), ref)
        twin = rel_l2(dict(b1.unpack_grads(gc, pkc), dpts=dc), ref)
        print(f"[31 B9 bf16 seeded level {level}] {n9} x 64 rows: the kernel's gradients and d pts within max rel L2 "
              f"{max(kern.values()):.3e} ({max(kern, key=kern.get)}) of the CUDA twin (bar 1e-2); the same twin "
              f"summed on the CPU within {max(twin.values()):.3e} ({max(twin, key=twin.get)})")
        if max(kern.values()) > 1e-2:
            fail(f"B9 bf16 on seeded level-{level} weights: gradient rel L2 > 1e-2")
        del gk, gr, gc, pk, pkc, model
        torch.cuda.empty_cache()

    # B3 wide at the test render's chunk (level 0, 32,768 rays x 64: 32
    # copies of the 1,024 rays) against its twin, on 000200.tar's weights and
    # on seeded ones (mr_level_model, seed 10), whose outputs do not saturate
    # as 000200.tar's do (ROADMAP Queue C); then the times, bf16: B3 there,
    # B9 at phase 2's rows
    p16, warped, ve = packs[(0, "bf16")]
    big = [x.repeat(32, *([1] * (x.dim() - 1))).contiguous() for x in (warped, ve, z, dist)]
    nb = big[2].numel()
    seeded = canonical_params(mr_level_model(dev, 0, seed=10, fused=False).state_dict())
    for weights, canon in (("000200.tar", canonical_params(states[0].coarse.state_dict())), ("seeded", seeded)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            pk = b3.pack_params(canon, states[0].coarse.cfg, dtype)
            got = b3.render_pass(pk, None, None, big[1], big[2], big[3], None, True, None, big[0])
            ref = b3.render_pass_plain(pk, None, None, big[1], big[2], big[3], None, True, None, big[0])
            torch.cuda.synchronize()
            drgb = (got.rgb - ref.rgb).abs()
            dacc = (got.acc - ref.acc).abs().max().item()
            depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4 if tag == "fp32" else 1e-2,
                                      atol=1e-5 if tag == "fp32" else 1e-2)
            live = ((ref.rgb > 1e-3) & (ref.rgb < 1 - 1e-3)).float().mean().item()
            print(f"[31 B3 wide {tag} level 0, {weights}] the test render's chunk (32,768 x 64): max|drgb|="
                  f"{drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} max|dacc|={dacc:.3e} "
                  f"depth_within_rtol={depth_ok}; share of rgb values inside (1e-3, 1 - 1e-3): {live:.4f}")
            bar = 1e-4 if tag == "fp32" else 1e-2
            if drgb.max().item() > bar or dacc > bar or not depth_ok:
                fail(f"B3 wide {tag} at the test render's chunk ({weights}): rgb or acc beyond {bar}, or depth "
                     f"beyond {'rtol 1e-4' if tag == 'fp32' else 'atol and rtol 1e-2'}")
            if tag == "bf16":
                err16["b3"] = max(err16["b3"], drgb.max().item(), dacc)
            if weights == "seeded" and live < 0.1:
                fail(f"31: the seeded weights' rgb is saturated ({live:.4f} of it live): the comparison sees nothing")
            if tag == "bf16":  # the training path's launch, on the SIMT body
                got = b3.render_pass(pk, None, None, big[1], big[2], big[3], None, True, None, big[0], ordered=True)
                du = (got.rgb - ref.rgb).abs()
                print(f"[31 B3 wide bf16 level 0, {weights}, ordered] max|drgb|={du.max().item():.3e} "
                      f"mean|drgb|={du.mean().item():.3e}")
                if du.max().item() > 1e-2 or du.mean().item() > 1e-3:
                    fail(f"B3 wide bf16, ordered, at the test render's chunk ({weights}): max |drgb| > 1e-2 or "
                         "mean > 1e-3")
                err16["b3"] = max(err16["b3"], du.max().item())
            del got, ref
    torch.cuda.empty_cache()
    rows = {}
    b3ms = cuda_ms(lambda: b3.render_pass(p16, None, None, big[1], big[2], big[3], None, True, None, big[0]), 5)
    b3plain = cuda_ms(lambda: b3.render_pass_plain(p16, None, None, big[1], big[2], big[3], None, True, None,
                                                   big[0]), 2)
    comp, head = tc_shares("render_pass", lambda: b3.render_pass(p16, None, None, big[1], big[2], big[3], None,
                                                                 True, None, big[0]))
    TC_SUMMARY["render_pass[pts,wide] at the test render's chunk"] = (
        f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
            "of the blocks' cycles")
    b3ms_o = cuda_ms(lambda: b3.render_pass(p16, None, None, big[1], big[2], big[3], None, True, None, big[0],
                                            ordered=True), 3)
    small = b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped)
    b3small = cuda_ms(lambda: b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped), 20)
    b3small_o = cuda_ms(lambda: b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped,
                                               ordered=True), 20)
    nw, nbias = p16.weights.numel(), p16.biases.numel()
    rows["render_pass[pts,wide]"] = entry(
        "render_pass[pts,wide]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
        0, err16["b3"], b3ms, b3plain,
        4 * (3 * nb + big[1].numel() + 2 * nb + 5 * big[2].shape[0] + nb) + 2 * nw + 4 * nbias,
        2 * p16.macs_per_sample * nb, "bf16")
    del big, small
    torch.cuda.empty_cache()
    report_library("31", "render_pass[pts,wide] bf16, the test render's chunk", nb,
                   forward_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), b3ms, dev)
    print(f"[31 times] B3 wide level 0 ({p16.macs_per_sample} MACs per sample): the test render's chunk "
          f"(32,768 x 64) {b3ms:.3f} ms ({2 * p16.macs_per_sample * nb / b3ms / 1e9:.2f} TFLOP/s); phase 2's "
          f"1,024 x 64 rows {b3small:.3f} ms; the training path's ordered launch (SIMT) {b3ms_o:.3f} "
          f"and {b3small_o:.3f} ms")
    # B9 at phase 2's rows (wide at level 0, narrow at the identity level),
    # and narrow at level 0's 1,024 x 64 too; each with its sweep by kernel
    # family and the sweep's products on cuBLAS
    for key, level, n_rays in (("render_loss[ext,wide]", 0, 1024), ("render_loss[ext]", 3, 16), (None, 3, 1024)):
        pk, wp, vv = packs[(level, "bf16")]
        args = (pk, wp[:n_rays].contiguous(), vv[:n_rays].contiguous(), z[:n_rays].contiguous(),
                dist[:n_rays].contiguous(), noise[:n_rays].contiguous(), gct[:n_rays].contiguous(), True)
        ms = cuda_ms(lambda: b1.render_loss_ext(*args), 20)
        plain = cuda_ms(lambda: b1.render_loss_ext_plain(*args), 5)
        rows_n = n_rays * 64
        if key == "render_loss[ext,wide]":
            simt_forward("31", f"B9 wide (render_loss[ext,wide]) level 0, {n_rays:,} x 64",
                         lambda: b1.render_loss_ext(*args), 2 * pk.macs_per_sample * rows_n)
        macs = b1.pts_train_macs_per_sample(pk)
        nbytes = (4 * (3 * rows_n + args[2].numel() + 3 * rows_n + 5 * n_rays) + 2 * pk.weights.numel()
                  + 4 * pk.biases.numel() + 4 * (5 * n_rays + rows_n + 3 * rows_n)
                  + 4 * (pk.weights.numel() + pk.biases.numel()))
        if key is not None:
            rows[key] = entry(key, "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
                              0, err16["b9n" if level == 3 else "b9"], ms, plain, nbytes, 2 * macs * rows_n, "bf16")
        print(f"[31 times] B9 level {level} ({macs} MACs per sample), {n_rays} x 64 rows: {ms:.3f} ms "
              f"({2 * macs * rows_n / ms / 1e9:.2f} TFLOP/s); twin {plain:.3f} ms")
        report_sweep("31", f"render_loss[ext{',wide' if pk.wide else ''},S=64] bf16, level {level}, {n_rays} x 64",
                     lambda: b1.render_loss_ext(*args), ms, bound(nbytes, 2 * macs * rows_n, "bf16")[0], rows_n,
                     sweep_products(pk.W, pk.D, pk.skip, pk.cin_pad, pk.cv_pad, demb=True), dev)
    return rows


def phase32_testset(dev, args, scene, states, pyr_hwf, rcfg):
    """The MultiRes test render of 000200.tar through run_multires'
    render_testset on test frames 0/5/10/15/20 (phase 25's CLI render ran
    all 25 through the eval pass): levels 0-2 through the D-NeRF eval pass
    (B6, then B3's pts mode at the MultiRes widths), level 3 through its
    fields; then again with SWNERF_FUSED_EVAL=0 (every level through its
    fields, the route the eval pass replaces). Levels 0-2's frames before the reconstruction
    within max 1e-2, mean 1e-3 (phase 4's bf16 bars); mean PSNR within 0.1
    dB; B3-wide launches; ms per reconstructed frame. Returns the eval-pass
    render's launch counts."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.train.loop import mse_to_psnr

    scene = dataclasses.replace(scene, i_test=scene.i_test[list(MR_FRAMES)])
    gt = torch.as_tensor(scene.images[scene.i_test])
    n = len(MR_FRAMES)
    out, counts = {}, {}
    for route, fused_eval in (("eval pass", "1"), ("fields", "0")):
        with env(SWNERF_FUSED_EVAL=fused_eval):
            passes = mr.make_level_eval_passes(states, dev)
            launches.clear()
            recon, ms, frames = mr.render_testset(args, scene, states, pyr_hwf, rcfg, MR_CKPT_ITER, passes)
            torch.cuda.synchronize()
            counts[route] = dict(launches)
        rec = torch.as_tensor(recon)
        psnr = [mse_to_psnr(torch.mean((rec[k] - gt[k]) ** 2).item()) for k in range(n)]
        out[route] = (rec, psnr, ms, [p is not None for p in passes], frames)
        print(f"[32 test set] {route}: eval passes per level {out[route][3]}; launches "
              f"{json.dumps(counts[route], sort_keys=True)} ({n} frames); {ms:.1f} ms per reconstructed frame; "
              f"frames {MR_FRAMES} reconstructed PSNR {[round(x, 3) for x in psnr]} (mean {sum(psnr) / len(psnr):.4f})")
    (ra, pa, ma, la, fa), (rb, pb, mb, lb, fb) = out["eval pass"], out["fields"]
    for level in range(3):  # each eval-pass level's frames before the reconstruction: bf16 B3 wide against B7
        dl = (fa[level] - fb[level]).abs()
        live = ((fb[level] > 1e-3) & (fb[level] < 1 - 1e-3)).float().mean().item()
        print(f"[32 test set] level {level} frames {tuple(fa[level].shape)}, eval pass against the fields: max|d|="
              f"{dl.max().item():.3e} mean|d|={dl.mean().item():.3e}; share of values inside (1e-3, 1 - 1e-3): "
              f"{live:.4f}")
        if dl.max().item() > 1e-2 or dl.mean().item() > 1e-3:
            fail(f"32: level {level}'s frames through the eval pass beyond max 1e-2 / mean 1e-3 of its fields'")
    d = abs(sum(pa) / len(pa) - sum(pb) / len(pb))
    drec = (ra - rb).abs()
    n_wide = counts["eval pass"].get("render_pass[pts,wide,S=64]", 0)
    print(f"[32 test set] eval pass against the fields: |delta mean PSNR| {d:.4f} dB, max |delta| in the "
          f"reconstruction {drec.max().item():.3e} (mean {drec.mean().item():.3e}); {ma:.1f} against {mb:.1f} ms per "
          f"reconstructed frame; B3 wide launched {n_wide} times")
    if la != [True, True, True, False] or any(lb) or d > 0.1:
        fail(f"32: eval passes {la} / {lb}, or the reconstructions {d} dB apart (> 0.1)")
    if n_wide != n * 4 or counts["fields"].get("render_pass[pts,wide,S=64]", 0) or \
            counts["eval pass"].get("trunk", 0) != n:
        fail(f"32: B3 wide launched {n_wide} times (want {n * 4}: 2 + 1 + 1 chunks a frame), or level 3 did not "
             "render through its fields alone (B7 once a frame)")
    return counts["eval pass"]


def mr_phase2_inputs(dev, scene):
    """One joint step's inputs on train view 37 at its frame time: each
    level's aligned patch (32 pixels at level 0, halved a level, corners
    (80, 80) doubled down from (10, 10)) with its Laplacian band, the
    full-resolution patch, noise std 1 and jitter, the draws of one seeded
    generator. Returns (rcfg, patch sizes, pixels, targets, full, pose, t,
    draws)."""
    import torch

    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.render.core import RenderConfig, make_draws

    rcfg = RenderConfig(n_samples=64, perturb=1.0, raw_noise_std=1.0, white_bkgd=True)
    images = torch.as_tensor(scene.images, device=dev)
    L, patch_sizes = 4, [32, 16, 8, 4]
    coords = [(10 << (L - 1 - l), 10 << (L - 1 - l)) for l in range(L)]
    with torch.no_grad():
        lap = generate_laplacian_pyramid(images[37:38], levels=L)
    pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev), torch.arange(x, x + ps, device=dev),
                                         indexing="ij"), -1).reshape(-1, 2) for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][0, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = [make_draws(rcfg, ps * ps, gen, dev) for ps in patch_sizes]
    pose = torch.as_tensor(scene.poses[37, :3, :4], device=dev)
    return rcfg, patch_sizes, pixels, targets, images[37, 80:112, 80:112], pose, float(scene.times[37]), draws


def mr_phase2_models(dev, fused_route, dtype=None, perturb=False, compute_dtype=None):
    """Phase 24's weights for the four levels: per level seeded (10 +
    level), the deformation head scaled by 1e-3, in ``dtype`` (fp32 by
    default), with ``perturb`` each weight jittered. On 000200.tar's
    saturated levels (ROADMAP Queue C) the fp32 deformation gradients of
    level 0 are noise: on an H100 both routes' worst tensor lay 300-600
    times its norm from the float64 step's, so a bar would compare noise."""
    import torch

    out = []
    for l in range(4):
        m = mr_level_model(dev, l, seed=10 + l, fused=fused_route, compute_dtype=compute_dtype or torch.float32)
        with torch.no_grad():
            m._time_out.weight.mul_(1e-3)
            m._time_out.bias.mul_(1e-3)
        m = m.to(dtype or torch.float32)
        if perturb:
            with torch.no_grad():
                for p in m.parameters():
                    p.copy_(jitter(p))
        out.append(m)
    return out


def phase33_fused(dev, tmp, data, scene, pyr_hwf):
    """The fused phase 2: one step over the four levels with fused=True (B6,
    B3's pts mode, B9) against the field-route step (B6, B7), from the same
    weights (phase 24's) and draws (the plain route in float64 the
    reference of the fallback); then run_multires resumed from 000200.tar
    for 100 phase-2 steps under SWNERF_FUSED_MULTIRES=1 and under the
    default (the field route), each through the CLI: every level's weights
    move and its Adam sees gradients (level_moves), and the two routes move
    each level by norms within 2-fold of each other where the level's
    gradients are signal (its fp32 routes agree within 0.1 on 000200.tar's
    weights); and the device's idle share of each step from
    torch.profiler. Returns the fused run's launch counts."""
    import numpy as np
    import torch

    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.render.core import Draws
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.train.loop import init_train_state

    ckpt = load_tar(str(tmp / "mr_logs" / "lego" / f"{MR_CKPT_ITER:06d}.tar"))
    rcfg, patch_sizes, pixels, targets, full, pose, t, draws = mr_phase2_inputs(dev, scene)
    L = len(patch_sizes)
    models = functools.partial(mr_phase2_models, dev)

    def step(ms, fused, device=dev, dtype=torch.float32, compute_dtype=None):
        states = [init_train_state(m, None, 5e-4, 250) for m in ms]
        cast = lambda x: None if x is None else x.to(device=device, dtype=dtype)  # noqa: E731
        fn = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far, fused=fused,
                                 compute_dtype=compute_dtype)
        m = fn(states, [p.to(device) for p in pixels], [cast(x) for x in targets], cast(full), cast(pose), t, 1.0,
               draws=[Draws(cast(d.t_rand), cast(d.noise0), None, None) for d in draws])
        return m, [{k: p.grad.detach().clone() for k, p in s.coarse.named_parameters()} for s in states]

    from swnerf_torch.ops.kernels import launches

    launches.clear()
    mk, gk = step(models(False), True, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    one = dict(launches)
    mf, gf = step(models(None), False)
    m64, g64 = step(models(False, torch.float64), False, dtype=torch.float64)
    m64p, g64p = step(models(False, torch.float64, perturb=True), False, dtype=torch.float64)
    torch.cuda.synchronize()
    lk, lf, l64, l64p = (m["total_loss"].item() for m in (mk, mf, m64, m64p))
    dl = abs(lk - lf) / lf
    print(f"[33 step fp32] launches of the fused step {json.dumps(one, sort_keys=True)}; total_loss fused {lk:.8f} "
          f"field route {lf:.8f} rel {dl:.3e} (global {mk['global_loss'].item():.6f} vs "
          f"{mf['global_loss'].item():.6f}); float64 plain {l64:.8f} (perturbed {l64p:.8f})")
    if one.get("render_loss[ext,wide,S=64]", 0) != 3 or one.get("render_loss[ext,S=64]", 0) != 1:
        fail(f"33: the fused step launched B9 {one} (want once per level)")
    if dl > 1e-5 and abs(lk - l64) > 2 * max(abs(lf - l64), abs(l64p - l64)):
        fail(f"33: fused step loss rel {dl} > 1e-5, and further from the float64 step than fp32 moves it")
    for l in range(L):
        check_fp32_grads(f"33 step fp32 level {l}", gk[l], gf[l], g64[l], g64p[l])
    del gk, gf, g64, g64p
    m16, _ = step(models(False), True)  # the card's default operands: bf16
    d16 = abs(m16["total_loss"].item() - lf) / lf
    print(f"[33 step bf16] total_loss {m16['total_loss'].item():.8f} vs the fp32 field route: rel {d16:.3e}")
    if d16 > 2e-2:
        fail(f"33: bf16 fused step loss rel {d16} > 2e-2")

    # On 000200.tar's own weights the two fp32 routes agree only at the
    # levels whose gradients are signal: at a saturated level they are
    # rounding noise (ROADMAP Queue C), and so are the CLI runs' moves there.
    def tar_models(fused_route):
        out = []
        for l in range(L):
            m = mr_level_model(dev, l, seed=0, fused=fused_route, compute_dtype=torch.float32)
            m.load_state_dict(dnerf_state_dict(ckpt[f"network_fn_{l}"]))
            out.append(m)
        return out

    _, gk = step(tar_models(False), True, compute_dtype=torch.float32)
    _, gf = step(tar_models(None), False)
    agree = [sum((gk[l][k].double() - gf[l][k].double()).norm().item() ** 2 for k in gf[l]) ** 0.5
             / sum(gf[l][k].double().norm().item() ** 2 for k in gf[l]) ** 0.5 for l in range(L)]
    print(f"[33 step fp32, 000200.tar] per level, the fused step's gradients from the field route's (rel L2 over the "
          f"level): {[f'{a:.3e}' for a in agree]}")
    del gk, gf
    torch.cuda.empty_cache()

    # the CLI, resumed from 000200.tar for 100 phase-2 steps (phase 1 skipped), each route from its own copy
    def level_moves(lego):
        """Per level: the L2 norm of the parameters' move from 000200.tar to
        000300.tar, and the norm of Adam's first moment at 000300.tar over
        0.9^100 times its norm at 000200.tar (1 if no gradient came: the
        resumed optimizer state would still move the weights)."""
        a, b = (load_tar(str(lego / f"{i:06d}.tar")) for i in (MR_CKPT_ITER, MR_CKPT_ITER + 100))
        out = []
        for l in range(L):
            pa, pb = a[f"network_fn_{l}"], b[f"network_fn_{l}"]
            move = sum(((pb[k].double() - pa[k].double()) ** 2).sum().item() for k in pa) ** 0.5
            m = [sum((x["exp_avg"].double() ** 2).sum().item() for x in c[f"optimizer_{l}"]["state"].values()) ** 0.5
                 for c in (a, b)]
            out.append((move, m[1] / (0.9**100 * m[0])))
        return out

    res, moves = {}, {}
    for route, mode in (("fused", "1"), ("field", "0")):
        base = tmp / f"mr33_{route}"
        (base / "lego").mkdir(parents=True)
        shutil.copy(tmp / "mr_logs" / "lego" / f"{MR_CKPT_ITER:06d}.tar", base / "lego")
        argv = ["--config", str(MULTIRES_CONFIG), "--basedir", str(base), "--datadir", str(data), "--device",
                "cuda", "--global_optimization_epoch", "100", "--i_testset", "100000", "--i_video", "100000",
                "--i_weights", "100", *MR_NOISE]
        with env(SWNERF_FUSED_MULTIRES=mode, SWNERF_PHASE1_ITERS="0", SWNERF_MAX_ITERS=str(MR_CKPT_ITER + 101)):
            launches.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
                r = mr.train(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(launches)
        recs = [json.loads(line) for line in (base / "lego" / "metrics.jsonl").read_text().splitlines()]
        gpsnr = [(x["step"], round(x["global_psnr"], 3)) for x in recs if "global_psnr" in x]
        totals = [(x["step"], x["total_loss"]) for x in recs if "total_loss" in x]
        quiet = [v for i, v in r["phase2_step_ms"].items() if i % 20 and (i - 1) % 20 and i % 100 and (i - 1) % 100]
        res[route] = (counts, statistics.median(quiet), buf.getvalue())
        print(f"[33 train {route}] launches {json.dumps(counts, sort_keys=True)}, CLI wall {wall:.2f} s; ms per "
              f"phase-2 step, median of {len(quiet)} steps that neither print nor save: {statistics.median(quiet):.3f}"
              f" (min {min(quiet):.3f}, max {max(quiet):.3f}); global PSNR at the prints {gpsnr}; total loss {totals}")
        if not gpsnr or not all(np.isfinite(p) for _, p in gpsnr) or len({v for _, v in totals}) < 2:
            fail(f"33 {route}: the global PSNR is not finite or the loss did not move: {gpsnr}, {totals}")
        if not (base / "lego" / f"{MR_CKPT_ITER + 100:06d}.tar").exists():
            fail(f"33 {route}: no {MR_CKPT_ITER + 100:06d}.tar")
        moves[route] = level_moves(base / "lego")
        print(f"[33 train {route}] per level, |params(300) - params(200)| and Adam's first moment at 300 over the "
              f"0.9^100 of 200's that stale momentum alone leaves: "
              f"{[(f'{mv:.4e}', f'{mo:.3e}') for mv, mo in moves[route]]}")
        if not all(mv > 0 and mo > 10 for mv, mo in moves[route]):
            fail(f"33 {route}: a level did not move, or no gradient reached its Adam: {moves[route]}")
    ratio = [f[0] / g[0] for f, g in zip(moves["fused"], moves["field"])]
    signal = [a < 0.1 for a in agree]
    print(f"[33 train] per level, the fused run's move over the field route's: {[round(r, 4) for r in ratio]}; "
          f"held to 2-fold at the levels whose fp32 routes agree within 0.1 on 000200.tar: {signal}")
    if not any(signal) or not all(0.5 <= r <= 2.0 for r, sg in zip(ratio, signal) if sg):
        fail(f"33: the fused and field runs moved a level with signal gradients by norms more than 2-fold apart, "
             f"or no level has them: {ratio}, {agree}")
    counts = res["fused"][0]
    if "fused phase 2 on levels [0, 1, 2, 3]" not in res["fused"][2] or counts.get("render_loss[ext,wide,S=64]", 0) \
            != 300 or counts.get("render_loss[ext,S=64]", 0) != 100 or res["field"][0].get("render_loss[ext,S=64]"):
        fail(f"33: the fused run launched B9 {counts} (want 300 wide + 100 narrow: once per level per step)")
    print(f"[33 train] ms per phase-2 step: fused {res['fused'][1]:.3f}, field route {res['field'][1]:.3f}")
    phase2_profile(dev, scene, pyr_hwf, ckpt)
    return counts


def phase2_profile(dev, scene, pyr_hwf, ckpt):
    """Device time by kernel family over 10 phase-2 steps on each route
    (after 3 warm-up steps), from torch.profiler, against the host clock
    around the steps: the device's idle share (multires_breakdown's)."""
    import numpy as np
    import torch

    from swnerf_torch.models import make_dnerf_model
    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.render.core import RenderConfig
    from swnerf_torch.train.checkpoint import dnerf_state_dict
    from swnerf_torch.train.loop import init_train_state

    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    rcfg = RenderConfig(n_samples=64, perturb=1.0, raw_noise_std=1.0, white_bkgd=True)
    with torch.no_grad():
        lap = generate_laplacian_pyramid(images, levels=4)
    patch_sizes = [32, 16, 8, 4]
    families = (("B9 forward", ("render_loss_fwd",)), ("B3 wide / B3 pts forward", ("render_pass_kernel", "render_kernel<")),
                ("B7 forward", ("trunk_fwd", "trunk_tc")), ("B6 forward", ("time_net_fwd", "time_net_tc")),
                ("backward tensor-core products (B6, B7, B9)", ("sweep_dw", "sweep_dh")),
                ("backward SIMT GEMMs and reductions", ("gemm_kernel", "reduce_kernel", "colsum", "head_bwd",
                                                        "cotangent_kernel", "round_cotangent", "encode_bwd")))
    for route in (True, False):
        states = []
        for l in range(4):
            cfg = mr._level_cfg(mr_args(), mr.CHANNEL_LIST[l])
            m = make_dnerf_model("direct_temporal", cfg, dev)
            m.load_state_dict(dnerf_state_dict(ckpt[f"network_fn_{l}"]))
            states.append(init_train_state(m, None, 5e-4, 250))
        fn = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far, fused=route)
        rng = np.random.default_rng(7)
        gen = torch.Generator(device=dev).manual_seed(7)

        def one(i):
            coords = mr.initialize_patches(rng, pyr_hwf, i)
            img_i = int(rng.choice(scene.i_train))
            pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev),
                                                 torch.arange(x, x + ps, device=dev), indexing="ij"), -1).reshape(-1, 2)
                      for (y, x), ps in zip(coords, patch_sizes)]
            targets = [lap[l][img_i, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
            y0, x0 = coords[0]
            fn(states, pixels, targets, images[img_i, y0 : y0 + 32, x0 : x0 + 32], poses[img_i],
               float(scene.times[img_i]), 1.0, gen)

        profile_steps("33", f"phase 2, {'fused' if route else 'field route'}", one, families)
        del states
        torch.cuda.empty_cache()


def phase34_b10(dev, tmp, data, psnr5):
    """B10 at phase 3's shape (160,000 rays of test view 0, 63 bins, 128
    samples) on 010000.tar's coarse weights (the coarse B3 pass's): bit-equal
    to B2 + torch.sort for linspace and for sorted random uniforms, the twin
    bit-equal to the kernel, B2's unsorted rows counted; then the serving
    main path under SWNERF_PDF_MERGE=1 (PSNRs equal to phase 5's), 50
    vanilla and 50 D-NeRF kernel steps under the switch (train PSNR at
    phases 9 / 21's floors), and B10's time beside B2 + torch.sort. Returns
    B10's [kernel] row with its launches there."""
    import torch

    from swnerf_torch.ops import sampling
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.pipelines import run_dnerf, run_nerf

    cfg, coarse, _ = load_models(dev)
    rays = view0_rays(dev)
    pc = b3.pack_params(coarse.state_dict(), cfg)
    ws, zs = [], []
    for start in range(0, 160_000, 32768):
        o, d, ve, z, dist = pass_inputs(rays.slice(start, min(160_000, start + 32768)), cfg, 64)
        ws.append(b3.render_pass(pc, o, d, ve, z, dist, None, True).weights)
        zs.append(z)
    w64, z64 = torch.cat(ws), torch.cat(zs).contiguous()
    del ws, zs
    n = z64.shape[0]
    bins = (0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous()
    wsl = w64[:, 1:-1]
    err = 0.0
    for mode in ("det", "sorted random"):
        u = (torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128) if mode == "det"
             else sampling.sorted_uniforms(n, 128, torch.Generator(device=dev).manual_seed(3), dev))
        got = b2.sample_pdf_merge(z64, bins, wsl, u)
        samples = b2.sample_pdf(bins, wsl, u)
        ref = torch.sort(torch.cat([z64, samples], -1), -1).values
        twin = b2.sample_pdf_merge_plain(z64, bins, wsl, u)
        torch.cuda.synchronize()
        unsorted = int((samples[:, 1:] < samples[:, :-1]).any(-1).sum().item())
        print(f"[34 B10 {mode}] N={n} M=63 S=128: bit-equal to B2 + torch.sort={torch.equal(got, ref)}, twin "
              f"bit-equal={torch.equal(twin, got)}; B2 rows not sorted for sorted u: {unsorted} of {n}")
        if not torch.equal(got, ref) or not torch.equal(twin, got):
            fail(f"B10 {mode}: differs from B2 + torch.sort or from its twin")
        err = max(err, (got - ref).abs().max().item())
    u = torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128)
    frame_ms = cuda_ms(lambda: b2.sample_pdf_merge(z64, bins, wsl, u), 20)
    frame_lib = cuda_ms(lambda: torch.sort(torch.cat([z64, b2.sample_pdf(bins, wsl, u)], -1), -1).values, 20)
    chunk = slice(0, 32768)
    zc, bc, wc, uc = z64[chunk], bins[chunk], wsl[chunk], u[chunk]
    ms = cuda_ms(lambda: b2.sample_pdf_merge(zc, bc, wc, uc), 50)
    plain = cuda_ms(lambda: b2.sample_pdf_merge_plain(zc, bc, wc, uc), 5)
    lib = cuda_ms(lambda: torch.sort(torch.cat([zc, b2.sample_pdf(bc, wc, uc)], -1), -1).values, 50)
    step_rows = {}
    for name, nr in (("vanilla step", 1024), ("D-NeRF step", 500)):
        uu = sampling.sorted_uniforms(nr, 128, torch.Generator(device=dev).manual_seed(4), dev)
        a = (z64[:nr], bins[:nr], wsl[:nr], uu)
        step_rows[name] = (cuda_ms(lambda: b2.sample_pdf_merge(*a), 50),
                           cuda_ms(lambda: torch.sort(torch.cat([a[0], b2.sample_pdf(*a[1:])], -1), -1).values, 50),
                           queued_ms(lambda: b2.sample_pdf_merge(*a), 50))
    alone = (queued_ms(lambda: b2.sample_pdf_merge(z64, bins, wsl, u), 20),
             queued_ms(lambda: b2.sample_pdf_merge(zc, bc, wc, uc), 50))
    print(f"[34 times] B10 per frame (160,000 rays, one launch) {frame_ms:.3f} ms against B2 + torch.sort "
          f"{frame_lib:.3f} ms; per 32,768-ray chunk {ms:.4f} against {lib:.4f} ms (twin {plain:.3f}); per step "
          + ", ".join(f"{k} {a:.4f} against {b:.4f} ms" for k, (a, b, _) in step_rows.items())
          + f"; queued behind a sleep (the device alone): frame {alone[0]:.4f}, chunk {alone[1]:.4f}, "
          + ", ".join(f"{k} {c:.4f}" for k, (_, _, c) in step_rows.items()) + " ms")
    nc = zc.shape[0]
    row = entry("sample_pdf_merge", "swnerf_torch/csrc/sample_pdf.cu", "swnerf_tpu/ops/pallas/sample_pdf.py:155",
                0, err, ms, plain, 4 * (nc * 63 + nc * 62 + 128 + nc * 64 + nc * 192), nc * 128 * 63, "fp32")
    row["library_ms"] = lib
    del z64, bins, w64, u
    torch.cuda.empty_cache()

    # the serving main path under the switch: det uniforms make z_all, and so every PSNR, bit-equal
    base = tmp / "pdf_merge"
    argv = ["--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "5", "--device", "cuda",
            "--basedir", str(base), "--datadir", str(DATADIR), "--ft_path", str(CKPT)]
    with env(SWNERF_PDF_MERGE="1"):
        launches.clear()
        metrics = json.loads((Path(run_nerf.main(argv)) / "metrics.json").read_text())
        serve = dict(launches)
    print(f"[34 serve] SWNERF_PDF_MERGE=1: launches {json.dumps(serve, sort_keys=True)} (5 frames); PSNR "
          f"{metrics['psnr']} against phase 5's {psnr5}")
    if metrics["psnr"] != psnr5 or serve.get("sample_pdf_merge", 0) != 25 or serve.get("sample_pdf", 0):
        fail("34: the PSNRs under SWNERF_PDF_MERGE=1 differ from phase 5's, or B10 did not replace B2 (25 launches)")
    # 50 vanilla and 50 D-NeRF kernel steps under the switch
    counts = {}
    with env(SWNERF_PDF_MERGE="1", SWNERF_MAX_ITERS="10051"):
        launches.clear()
        res = run_nerf.main(["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(base), "--datadir",
                             str(DATADIR), "--device", "cuda", "--i_print", "25", "--i_weights", "100000"])
        counts["vanilla"] = dict(launches)
    recs = [json.loads(x) for x in (base / "full_nerf_200k" / "metrics.jsonl").read_text().splitlines()]
    pv = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    exp = base / "logs" / "full_dnerf_800k"
    exp.mkdir(parents=True)
    shutil.copy(DNERF_CKPT, exp / "800000.tar")
    with env(SWNERF_PDF_MERGE="1", SWNERF_MAX_ITERS="800051"):
        launches.clear()
        res_d = run_dnerf.main(["--config", str(DNERF_CONFIG), "--basedir", str(base / "logs"), "--datadir",
                                str(data), "--device", "cuda", "--i_print", "25", "--i_weights", "100000"])
        counts["dnerf"] = dict(launches)
    recs = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    pd = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    med = {k: statistics.median(v for i, v in r["step_ms"].items() if i % 25 and (i - 1) % 25)
           for k, r in (("vanilla", res), ("dnerf", res_d))}
    print(f"[34 train] SWNERF_PDF_MERGE=1: vanilla launches {json.dumps(counts['vanilla'], sort_keys=True)}, train "
          f"PSNR {pv}, {med['vanilla']:.3f} ms per step; D-NeRF launches {json.dumps(counts['dnerf'], sort_keys=True)}"
          f", train PSNR {pd}, {med['dnerf']:.3f} ms per step")
    if len(pv) != 2 or min(p for _, p in pv) < 30.0 or len(pd) != 2 or min(p for _, p in pd) < 34.0:
        fail(f"34: train PSNR under SWNERF_PDF_MERGE=1 below the floors (30 / 34 dB): {pv}, {pd}")
    if any(c.get("sample_pdf_merge", 0) != 50 or c.get("sample_pdf", 0) for c in counts.values()):
        fail(f"34: the steps under SWNERF_PDF_MERGE=1 launched B10 / B2 {counts} (want 50 B10 each, no B2)")
    row["launches"] = serve["sample_pdf_merge"] + sum(c["sample_pdf_merge"] for c in counts.values())
    return {"sample_pdf_merge": row}


def phase35_b11(dev, data):
    """B11 (fused_time_net_pts with input cotangents) against its twin with
    the D-NeRF 800000.tar deformation weights on phase 17's points (500
    rays x 64 and x 192) and at MultiRes level 0's widths (seeded weights,
    500 rays x 64): dx bit-equal to B6's forward; fp32 gradients, d pts and
    d times at phase 17's bar; bf16 rel L2 1e-2; times. Its entry point has
    no product caller: this phase drives it, each point set once, and those
    launches are its row's. Returns B11's [kernel] row."""
    import dataclasses

    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.pipelines.run_dnerf import _model_config
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.utils.config import config_parser_dnerf

    args = config_parser_dnerf().parse_args(["--config", str(DNERF_CONFIG)])
    cfg = _model_config(args, args.netdepth, args.netwidth)
    sd = dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"])
    sd = {k: v.to(dev) for k, v in sd.items()}
    inputs = dnerf_train_inputs(dev, cfg, sd, data)
    lvl0 = mr_level_model(dev, 0, seed=35, fused=False)
    g = torch.Generator(device=dev).manual_seed(11)
    rays, _ = frame_rays(dev, data, "train", 37)
    sel = torch.randint(0, rays.origins.shape[0], (500,), generator=g, device=dev)
    from swnerf_torch.ops.sampling import sample_along_rays

    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g)
    cases = [(f"D-NeRF S={S}", cfg, sd, inputs[S][0], inputs["times"]) for S in (64, 192)]
    cases.append(("MultiRes level 0", lvl0.cfg, lvl0.state_dict(),
                  (r.origins[:, None, :] + r.directions[:, None, :] * z[..., None]).contiguous(),
                  r.times.reshape(-1).contiguous()))
    cots = [torch.randn(c[3].shape, generator=g, device=dev) for c in cases]

    def drive(packed, pts, times, cot, dtype):
        leaf = dataclasses.replace(packed, weights=packed.weights.detach().float().clone().requires_grad_(True),
                                   biases=packed.biases.detach().clone().requires_grad_(True))
        p, t = pts.clone().requires_grad_(True), times.clone().requires_grad_(True)
        dx = b6.fused_time_net_pts(leaf, p, t, need_input_grads=True, dtype=dtype)
        (dx * cot).sum().backward()
        return dx.detach(), (leaf.weights.grad, leaf.biases.grad), p.grad, t.grad

    launches.clear()  # the path: the entry point, once per point set (bf16, the card's operands)
    for (_, c, s, pts, times), cot in zip(cases, cots):
        drive(b6.pack_time_params(s, c, torch.float32), pts, times, cot, torch.bfloat16)
    torch.cuda.synchronize()
    path = dict(launches)
    print(f"[35 B11 path] launches {json.dumps(path, sort_keys=True)}")
    if path.get("time_net[pts,bwd]", 0) != 3 or path.get("time_net", 0) != 3 or path.get("time_net[bwd]", 0):
        fail(f"35: fused_time_net_pts launched {path} (want B6's forward and B11's backward 3 times each)")

    def named(grads, dpts, dtimes, pk):
        return dict(b6.unpack_time_grads(grads, pk), dpts=dpts, dtimes=dtimes)

    err16, row = 0.0, None
    for (tag, c, s, pts, times), cot in zip(cases, cots):
        p32 = b6.pack_time_params(s, c, torch.float32)
        dx, gk, dpk, dtk = drive(p32, pts, times, cot, torch.float32)
        dx2, gk2, dpk2, dtk2 = drive(p32, pts, times, cot, torch.float32)
        ref = b6.time_net_plain_bwd(p32, pts, times, cot, True)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        r64 = b6.time_net_plain_bwd(p64, pts.double(), times.double(), cot.double(), True)
        r64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), pts.double(),
                                     times.double(), cot.double(), True)
        torch.cuda.synchronize()
        fwd_same = torch.equal(dx, b6.time_net(p32, pts, times))
        same = all(torch.equal(a, b) for a, b in zip((*gk, dpk, dtk), (*gk2, dpk2, dtk2)))
        print(f"[35 B11 fp32 {tag}] {p32.cin} of {p32.cin_pad} rows: dx bit-equal to B6's forward={fwd_same}, "
              f"repeat bit-equal={same}, max|ddpts|={(dpk - ref[1]).abs().max().item():.3e} (max|dpts| "
              f"{ref[1].abs().max().item():.3e}), max|ddtimes|={(dtk - ref[2]).abs().max().item():.3e} (max|dtimes| "
              f"{ref[2].abs().max().item():.3e})")
        if not fwd_same or not same:
            fail(f"B11 fp32 {tag}: dx differs from B6's forward or repeats differ")
        check_fp32_grads(f"35 B11 fp32 {tag}", named(gk, dpk, dtk, p32), named(*ref, p32), named(*r64, p64),
                         named(*r64p, p64))
        del r64, r64p
        p16 = b6.pack_time_params(s, c, torch.bfloat16)
        dx16, gk, dpk, dtk = drive(p16, pts, times, cot, torch.bfloat16)
        ref = b6.time_net_plain_bwd(p16, pts, times, cot, True)
        torch.cuda.synchronize()
        rel = rel_l2(named(gk, dpk, dtk, p16), named(*ref, p16))
        print(f"[35 B11 bf16 {tag}] max|ddx|={(dx16 - b6.time_net_plain(p16, pts, times)).abs().max().item():.3e} "
              f"grads, dpts, dtimes max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)})")
        if max(rel.values()) > 1e-2:
            fail(f"B11 bf16 {tag}: gradient rel L2 > 1e-2")
        err16 = max(err16, (dx16 - b6.time_net_plain(p16, pts, times)).abs().max().item())
        if tag == "D-NeRF S=192":  # the row: the TV pair's rows of the D-NeRF step, as B6's backward row
            M = pts.shape[0] * pts.shape[1]
            sc = b6._din_scratch(p16, M, dev)
            b6._launch_fwd(p16, pts, times, sc)
            g2 = cot.reshape(M, 3).contiguous()
            ms = cuda_ms(lambda: b6._launch_bwd_din(p16, pts, times, g2, sc), 10)
            b6ms = cuda_ms(lambda: b6._launch_bwd(p16, M, g2, sc), 10)
            plain = cuda_ms(lambda: b6.time_net_plain_bwd(p16, pts, times, cot, True), 3)
            nw, nb = p16.weights.numel(), p16.biases.numel()
            row = entry("time_net[pts,bwd]", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:519",
                        0, err16, ms, plain, 4 * (3 * M + pts.shape[0] + 3 * M) + 2 * nw + 4 * (nw + nb + 3 * M
                                                                                              + pts.shape[0]),
                        2 * p16.din_macs_per_row * M, "bf16")
            print(f"[35 times] B11 backward, {M} rows ({p16.din_macs_per_row} MACs per row): {ms:.3f} ms "
                  f"({2 * p16.din_macs_per_row * M / ms / 1e9:.2f} TFLOP/s) against B6's backward {b6ms:.3f} ms "
                  f"(no input cotangent); twin {plain:.3f} ms")
            report_library("35", "time_net[pts,bwd] bf16 (d pts, d times)", M,
                           sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad, demb=True), ms, dev, "backward")
            del sc
        torch.cuda.empty_cache()
    row["launches"] = path["time_net[pts,bwd]"]
    row["max_abs_err"] = err16
    return {"time_net[pts,bwd]": row}



# ---------------------------------------------------------------- K steps per dispatch
DISPATCH_PRINT, DISPATCH_STEPS = 20, 60  # phase 36's print cadence, run length and save cadence


def dispatch_trainers(data):
    """Phase 36's trainers: (name, CLI module, argv without --basedir, the
    iteration it resumes at, its expname)."""
    from swnerf_torch.pipelines import run_dnerf, run_nerf, run_tnerf

    every = ["--device", "cuda", "--i_print", str(DISPATCH_PRINT), "--i_weights", str(DISPATCH_STEPS)]
    return (
        ("vanilla", run_nerf, ["--config", str(CONFIG), "--ft_path", str(CKPT), "--datadir", str(DATADIR), *every],
         10000, "full_nerf_200k"),
        ("tnerf", run_tnerf, ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--datadir", str(data),
                              *every], 800000, "full_tnerf_800k"),
        ("dnerf", run_dnerf, ["--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--datadir", str(data),
                              *every], 800000, "full_dnerf_800k"),
    )


def clock_free_records(exp):
    """metrics.jsonl without its clock fields (the time and the rates)."""
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("t", "steps_per_sec", "ray_samples_per_sec_per_chip")}
            for r in recs]


def window_timer(module, start, every=DISPATCH_PRINT):
    """The trainer's StepTimer with two windows of ``every`` steps inside
    the CLI run (phase 36: prints at start + 20, 40, 60): steps
    start+every+1..start+2*every on the host's clock, from the end of the
    print before them to the enqueue of the last (the host's time to draw
    and dispatch a step); steps start+2*every+1..start+3*every under
    torch.profiler, from the end of the print before them to the
    synchronization of the print that ends them (device busy time against
    that wall, and the launches the device ran). Returns (the class, the
    dict it fills)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from swnerf_torch.ops.kernels import launches, traced_launches

    win = {}

    class WindowTimer(module.StepTimer):
        def record(self, i):
            super().record(i)
            self.last = i
            if i == start + 2 * every and "t0" in win:
                win["host_us"] = (time.perf_counter() - win.pop("t0")) / every * 1e6

        def collect(self):
            super().collect()
            if self.last == start + every:
                win["t0"] = time.perf_counter()
            elif self.last == start + 2 * every and "prof" not in win:
                win["counted"] = collections.Counter(launches)
                win["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                win["prof"].__enter__()
                win["p0"] = time.perf_counter()
            elif self.last == start + 3 * every and "p0" in win:
                torch.cuda.synchronize()
                win["pwall"] = (time.perf_counter() - win.pop("p0")) / every * 1e3
                prof = win["prof"]
                prof.__exit__(None, None, None)
                avg = prof.key_averages()
                win["busy"] = sum(_device_us(e) for e in avg if str(e.device_type).endswith("CUDA")) / 1e3 / \
                    every
                win["traced"] = traced_launches(avg)
                counted = collections.Counter(launches)
                counted.subtract(win["counted"])
                win["counted"] = +counted

    return WindowTimer, win


def phase36_dispatch(dev, tmp, data):
    """K steps per dispatch (CUDA-graph replays): each trainer resumed twice
    from its checkpoint for 60 steps (print 20, save 60: one checkpoint, on
    the multiple of 60 inside the run), at
    SWNERF_STEPS_PER_DISPATCH=1 and 20: the saved parameters, Adam's moments
    and counts, metrics.jsonl's values at every print, the checkpoint
    iterations and the launch counts bit-equal (torch.equal, ==); the K = 20
    run captures once, the K = 1 run never. In each run (window_timer):
    the median ms per step over steps start+1..start+40 that neither start
    a chunk nor print (CUDA events), the host's microseconds a step over
    start+21..start+40, and over start+41..start+60 under torch.profiler
    the device's idle share and the port's kernels the device ran, by
    name, which must be the same at K = 20 (graph replays, counted from the
    capture) as at K = 1 (each launch counted where it happens) and at
    least the launches counted. Then phase36_warm_start."""
    import torch

    from swnerf_torch.train.checkpoint import load_tar

    for name, module, argv, start, expname in dispatch_trainers(data):
        # the cadences count from iteration 0: 010020.tar, 800040.tar
        saved = next(f"{i:06d}.tar" for i in range(start + 1, start + DISPATCH_STEPS + 1) if i % DISPATCH_STEPS == 0)
        runs = {}
        for k in (1, 20):
            base = tmp / f"dispatch_{name}_k{k}"
            timer, win = window_timer(module, start)
            plain_timer, module.StepTimer = module.StepTimer, timer
            try:
                res, out, counts, _ = _cli(module.main, argv + ["--basedir", str(base)], {
                    "SWNERF_STEPS_PER_DISPATCH": str(k), "SWNERF_MAX_ITERS": str(start + DISPATCH_STEPS + 1)})
            finally:
                module.StepTimer = plain_timer
            exp = base / expname
            quiet = {i: ms for i, ms in res["step_ms"].items()
                     if i % DISPATCH_PRINT and (i - 1) % DISPATCH_PRINT and i <= start + 2 * DISPATCH_PRINT}
            runs[k] = dict(counts=counts, tars=sorted(p.name for p in exp.glob("*.tar")),
                           tar=load_tar(str(exp / saved)), recs=clock_free_records(exp),
                           med=statistics.median(quiet.values()), metrics=res["metrics"], win=win,
                           captured=[ln for ln in out.splitlines() if ln.startswith("Captured")])
        a, b = runs[1], runs[20]
        nets = [key for key in a["tar"] if key.startswith("network")]
        adam_a, adam_b = (list(r["tar"]["optimizer_state_dict"]["state"].values()) for r in (a, b))
        wa, wb = a["win"], b["win"]
        same = {
            "checkpoint iterations": a["tars"] == b["tars"] == [saved],
            "parameters": all(torch.equal(v, b["tar"][key][n]) for key in nets for n, v in a["tar"][key].items()),
            "Adam moments and counts": len(adam_a) == len(adam_b) > 0 and all(
                set(x) == set(y) and all(torch.equal(torch.as_tensor(x[f]), torch.as_tensor(y[f])) for f in x)
                for x, y in zip(adam_a, adam_b)),
            "metrics.jsonl at the prints": a["recs"] == b["recs"] and [r["step"] for r in a["recs"] if "psnr" in r]
            == [start + DISPATCH_PRINT * j for j in (1, 2, 3)],
            "last metrics": a["metrics"] == b["metrics"],
            "launch counts": a["counts"] == b["counts"] and sum(a["counts"].values()) > 0,
            "kernels the device ran": wa["traced"] == wb["traced"] and sum(wa["counted"].values()) > 0
            and wa["counted"] == wb["counted"] and sum(wb["traced"].values()) >= sum(wb["counted"].values()),
        }
        per_step = {n: c / DISPATCH_PRINT for n, c in sorted(wb["traced"].items())}
        print(f"[36 {name}] K=20 against K=1, 60 steps from {start}: " + ", ".join(
            f"{k} {'equal' if v else 'DIFFER'}" for k, v in same.items()) + f"; launches {json.dumps(b['counts'], sort_keys=True)}")
        print(f"[36 {name}] over 20 steps under torch.profiler: launches counted {dict(wb['counted'])} (K=1: "
              f"{dict(wa['counted'])}); the port's kernels the device ran per step at K=20 {per_step} (K=1 "
              f"{'the same' if wa['traced'] == wb['traced'] else dict(wa['traced'])})")
        print(f"[36 {name}] K=20: {b['captured']}")
        if not all(same.values()) or a["captured"] or len(b["captured"]) != 1:
            fail(f"36 {name}: K=20 differs from K=1 ({same}), or the captures {a['captured']} / {b['captured']}")
        for k, r in runs.items():
            w = r["win"]
            idle = f"idle share {100 * (1 - w['busy'] / w['pwall']):.1f}% (busy {w['busy']:.3f} of " \
                f"{w['pwall']:.3f} ms)" if w["busy"] else "torch.profiler recorded no device time"
            print(f"[36 {name} K={k}] CLI median {r['med']:.3f} ms per step (CUDA events, steps 1-40 of the "
                  f"60-step run); host {w['host_us']:.1f} us per step to draw and dispatch (steps 21-40); under "
                  f"torch.profiler (steps 41-60) {idle}")
        torch.cuda.empty_cache()
    phase36_warm_start(tmp)


def phase36_warm_start(tmp):
    """run_nerf from scratch (the config's widths, seeded weights) for 30
    steps under SWNERF_FUSED_DTYPE_SCHEDULE=f32@10, print 10, at the default
    K: no B1 launch in steps 1-10 (the eager step with fp32 field operands:
    B7's fp32 launches), B1 twice in every step after, finite losses, two
    captures (the warm graph and the kernel step's)."""
    import math

    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_nerf

    per_step = {}

    class CountingTimer(run_nerf.StepTimer):
        def record(self, i):
            super().record(i)
            per_step[i] = dict(launches)

    base = tmp / "dispatch_warm"
    argv = ["--config", str(CONFIG), "--datadir", str(DATADIR), "--basedir", str(base), "--device", "cuda",
            "--i_print", "10", "--i_weights", "100000"]
    buf = io.StringIO()
    plain_timer, run_nerf.StepTimer = run_nerf.StepTimer, CountingTimer
    try:
        with env(SWNERF_FUSED_DTYPE_SCHEDULE="f32@10", SWNERF_MAX_ITERS="31"):
            launches.clear()
            with contextlib.redirect_stdout(buf):
                res = run_nerf.main(argv)
            torch.cuda.synchronize()
    finally:
        run_nerf.StepTimer = plain_timer
    out = buf.getvalue()

    def step_launches(i):
        return {k: v - per_step[i - 1].get(k, 0) for k, v in per_step[i].items() if v - per_step[i - 1].get(k, 0)}

    b1 = {i: sum(v for k, v in step_launches(i).items() if k.startswith("render_loss")) for i in range(1, 31)}
    b7 = {i: step_launches(i).get("trunk", 0) for i in range(1, 11)}
    losses = [r["total_loss"] for r in clock_free_records(base / "full_nerf_200k") if "total_loss" in r]
    captured = [ln for ln in out.splitlines() if ln.startswith("Captured")]
    print(f"[36 warm start] f32@10 from scratch, 30 steps: B1 launches per step {list(b1.values())}; B7 (fp32) "
          f"launches in steps 1-10 {list(b7.values())}; total_loss at 10/20/30 {losses}; {captured}")
    if "Precision warm-start: f32 autodiff step through iter 10" not in out or any(b1[i] for i in range(1, 11)) or \
            any(b1[i] != 2 for i in range(11, 31)) or not all(b7.values()) or len(losses) != 3 or \
            not all(math.isfinite(x) for x in losses + list(res["metrics"].values())) or len(captured) != 2:
        fail("36 warm start: B1 ran in the warm steps or not in every later one, the loss is not finite, or the "
             "run did not capture both steps")


# ---------------------------------------------------------------- the forward-facing LLFF path (NDC)
FERN_CONFIG = ROOT / "configs" / "nerf" / "fern.txt"
FERN_SIZE, FERN_IMAGES = 504, 20  # the width of fern's factor-8 frames, and its image count
FERN_STEPS, FERN_PRINT = 1000, 100
QUALITY_STEPS = 5000
QUALITY_VIEWS = (0, 8, 16)  # llffhold 8 on 24 views


def llff_phases(dev, tmp):
    """Phases 37-39. Returns the [kernel] rows of B1, B3, B2 and B10 at the
    NDC path's shapes, with their launches on its main paths."""
    t0 = time.perf_counter()
    data, ckpt, counts = phase37_fern(dev, tmp)
    rows = phase38_holds(dev, data, ckpt, counts)
    phase39_quality(tmp)
    print(f"[39 done] phases 37-39 in {time.perf_counter() - t0:.1f} s")
    return rows


def fern_args(data, base, *extra):
    """configs/nerf/fern.txt unchanged but for the capture, the log
    directory and factor 1 (the capture holds images_1/)."""
    return ["--config", str(FERN_CONFIG), "--datadir", str(data), "--basedir", str(base), "--expname", "fern_test",
            "--factor", "1", "--device", "cuda", *extra]


def unit_psnrs(psnrs, gts):
    """metrics.json's PSNRs (skimage's data range: the ground truth's max -
    min) at data_range 1, as the LLFF references were scored."""
    import math

    return [p - 20.0 * math.log10(float(g.max() - g.min())) for p, g in zip(psnrs, gts)]


def _render_test(argv, envs):
    """``--render_only --render_test``: (metrics.json, launches, wall s)."""
    from swnerf_torch.pipelines import run_nerf

    savedir, _, counts, wall = _cli(run_nerf.main, argv + ["--render_only", "--render_test"], envs)
    return json.loads((Path(savedir) / "metrics.json").read_text()), counts, wall


def phase37_fern(dev, tmp):
    """The fern shape: write_llff_scene(n_images=20, size=504,
    n_samples=192, scene="textured") on the card, then fern.txt through
    run_nerf from scratch for 1,000 steps at the card's K = 20 (print 100):
    the loss at the last print below the first's, B1 at S = 64 and 128 and
    B2 once a step, one capture; ms per step (CUDA events), host us per step
    and the idle share (window_timer: steps 101-200 and 201-300). K = 20
    against K = 1 over 40 steps: parameters, Adam, metrics.jsonl and launch
    counts bit-equal. --render_only --render_test from 001000.tar over the 3
    holdout views (B3, B2, B3 on NDC rays): ms per frame, PSNR, the fp32
    plain route (SWNERF_FUSED=0) within 0.1 dB mean, a per-stage breakdown;
    the 120-view spiral at --render_factor 4 (120 PNG frames, wall time);
    20 steps under SWNERF_PDF_MERGE=1 (B10, no B2). Returns (the capture,
    001000.tar, the launch counts of the training, serving, spiral and B10
    runs)."""
    import torch

    from swnerf_torch.data.synthetic import write_llff_scene
    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.pipelines import run_nerf
    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.render.core import make_rays_from_camera
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict
    from swnerf_torch.utils.config import config_parser
    from swnerf_torch.utils.png import read_png

    data = tmp / "fern_504"
    t0 = time.perf_counter()
    write_llff_scene(str(data), n_images=FERN_IMAGES, size=FERN_SIZE, n_samples=192, scene="textured", device=dev)
    torch.cuda.synchronize()
    print(f"[37 scene] forward-facing textured {FERN_SIZE}x{FERN_SIZE}, {FERN_IMAGES} views, 192 GT samples: "
          f"written in {time.perf_counter() - t0:.2f} s")

    # 1,000 steps from scratch at K = 20
    base = tmp / "fern"
    timer, win = window_timer(run_nerf, 0, every=FERN_PRINT)
    plain_timer, run_nerf.StepTimer = run_nerf.StepTimer, timer
    try:
        res, out, train, wall = _cli(run_nerf.main, fern_args(data, base, "--i_print", str(FERN_PRINT), "--i_weights",
                                                              str(FERN_STEPS)), {"SWNERF_MAX_ITERS": str(FERN_STEPS + 1)},
                                     tee=True)
    finally:
        run_nerf.StepTimer = plain_timer
    exp = base / "fern_test"
    recs = [r for r in clock_free_records(exp) if "total_loss" in r]
    losses = [(r["step"], round(r["total_loss"], 6)) for r in recs]
    captured = [ln for ln in out.splitlines() if ln.startswith("Captured")]
    print(f"[37 train] launches {json.dumps(train, sort_keys=True)} ({FERN_STEPS} steps), CLI wall {wall:.2f} s; "
          f"total_loss at the prints {losses}; {captured}")
    want = {"render_loss[S=64]": FERN_STEPS, "render_loss[S=128]": FERN_STEPS, "sample_pdf": FERN_STEPS}
    if "kernel train step" not in out or len(captured) != 1 or any(train.get(k) != v for k, v in want.items()):
        fail(f"37: the fern run did not take the captured kernel step with {want} launches: {train}, {captured}")
    if len(losses) != FERN_STEPS // FERN_PRINT or not losses[-1][1] < losses[0][1]:
        fail(f"37: the loss at the last print is not below the first's: {losses}")
    quiet = [ms for i, ms in res["step_ms"].items() if i > 20 and i % 20 and (i - 1) % 20]
    med = statistics.median(quiet)
    idle = (f"idle share {100 * (1 - win['busy'] / win['pwall']):.1f}% (busy {win['busy']:.3f} of "
            f"{win['pwall']:.3f} ms a step)" if win.get("busy") else "torch.profiler recorded no device time")
    spr = 1024 * (64 + 128)
    print(f"[37 train] median {med:.3f} ms per step over {len(quiet)} steps that neither start a chunk nor print "
          f"(CUDA events; {1024 / med * 1e3:.4g} rays/s, {spr / med * 1e3:.4g} samples/s); host "
          f"{win['host_us']:.1f} us per step to draw and dispatch (steps 101-200); steps 201-300 under "
          f"torch.profiler: {idle}")

    # K = 20 against K = 1 over the first 40 steps
    runs = {}
    for k in (1, 20):
        b = tmp / f"fern_k{k}"
        res_k, out_k, counts_k, _ = _cli(run_nerf.main, fern_args(data, b, "--i_print", "20", "--i_weights", "40"),
                                         {"SWNERF_STEPS_PER_DISPATCH": str(k), "SWNERF_MAX_ITERS": "41"})
        runs[k] = dict(tar=load_tar(str(b / "fern_test" / "000040.tar")), recs=clock_free_records(b / "fern_test"),
                       metrics=res_k["metrics"], counts=counts_k,
                       captured=[ln for ln in out_k.splitlines() if ln.startswith("Captured")])
    a, b = runs[1], runs[20]
    adam_a, adam_b = (list(r["tar"]["optimizer_state_dict"]["state"].values()) for r in (a, b))
    same = {
        "parameters": all(torch.equal(v, b["tar"][key][n]) for key in a["tar"] if key.startswith("network")
                          for n, v in a["tar"][key].items()),
        "Adam moments and counts": len(adam_a) == len(adam_b) > 0 and all(
            set(x) == set(y) and all(torch.equal(torch.as_tensor(x[f]), torch.as_tensor(y[f])) for f in x)
            for x, y in zip(adam_a, adam_b)),
        "metrics.jsonl at the prints": a["recs"] == b["recs"] and [r["step"] for r in a["recs"] if "psnr" in r]
        == [20, 40],
        "last metrics": a["metrics"] == b["metrics"],
        "launch counts": a["counts"] == b["counts"] and a["counts"].get("render_loss[S=128]") == 40,
    }
    print(f"[37 dispatch] K=20 against K=1, 40 steps from scratch: " + ", ".join(
        f"{k} {'equal' if v else 'DIFFER'}" for k, v in same.items()) + f"; K=20: {b['captured']}")
    if not all(same.values()) or a["captured"] or len(b["captured"]) != 1:
        fail(f"37: K=20 differs from K=1 on the NDC pool step ({same}), or the captures {a['captured']} / "
             f"{b['captured']}")

    # the holdout views from 001000.tar, kernels and the fp32 plain route
    ckpt = exp / f"{FERN_STEPS:06d}.tar"
    argv = fern_args(data, tmp / "fern_serve", "--ft_path", str(ckpt))
    metrics, serve, wall = _render_test(argv, {})
    plain, _, _ = _render_test(fern_args(data, tmp / "fern_serve_plain", "--ft_path", str(ckpt)), {"SWNERF_FUSED": "0"})
    scene = load_scene(config_parser().parse_args(argv + ["--render_test"]))
    gts = scene.images[scene.i_test]
    ours, ref = unit_psnrs(metrics["psnr"], gts), unit_psnrs(plain["psnr"], gts)
    mean_k, mean_p = sum(ours) / len(ours), sum(ref) / len(ref)
    per_frame = statistics.mean(metrics["seconds_per_frame"][1:]) * 1e3
    print(f"[37 serve] launches {json.dumps(serve, sort_keys=True)} ({len(ours)} holdout views, "
          f"{FERN_SIZE}x{FERN_SIZE}, 64 + 64 samples), CLI wall {wall:.2f} s; seconds per frame "
          f"{[round(x, 4) for x in metrics['seconds_per_frame']]}: {per_frame:.1f} ms per frame after the first, "
          f"{FERN_SIZE ** 2 / per_frame * 1e3:.4g} rays/s")
    print(f"[37 serve] PSNR at data_range 1, views {list(scene.i_test)}: kernels {[round(x, 3) for x in ours]} "
          f"(mean {mean_k:.3f} dB), fp32 plain route {[round(x, 3) for x in ref]} (mean {mean_p:.3f} dB), "
          f"|d mean| {abs(mean_k - mean_p):.4f} dB; SSIM {[round(x, 4) for x in metrics['ssim']]}")
    chunks = len(ours) * -(-FERN_SIZE ** 2 // 32768)
    if abs(mean_k - mean_p) > 0.1 or any(serve.get(k) != chunks for k in
                                         ("render_pass[S=64]", "render_pass[S=128]", "sample_pdf")):
        fail(f"37: the holdout views' mean PSNR differs from the fp32 plain route's by more than 0.1 dB, or the "
             f"render did not run B3, B2, B3 once per chunk ({chunks}): {serve}")
    cfg = VanillaNeRFConfig()
    ck = load_tar(str(ckpt))
    models = []
    for key in ("network_fn_state_dict", "network_fine_state_dict"):
        m = VanillaNeRF(cfg, device=dev, fused=False)
        m.load_state_dict(vanilla_state_dict(ck[key]))
        models.append(m.eval())
    pc, pf = (b3.pack_params(m.state_dict(), cfg) for m in models)
    rays = make_rays_from_camera(scene.H, scene.W, scene.K, scene.poses[scene.i_test[0]][:3, :4], 0.0, 1.0,
                                 ndc=True, device=dev)
    stages, first = frame_breakdown(rays, cfg, pc, pf, 32768, n_importance=64)
    total = sum(stages.values())
    print(f"[37 breakdown] holdout view {scene.i_test[0]}, device ms by stage (second pass): " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()) + f"; sum {total:.1f} ms against the "
        f"timed {per_frame:.1f} ms; the first pass {sum(first.values()):.1f} ms")
    del pc, pf, models, rays

    # the spiral path at --render_factor 4
    spiral, _, spiral_counts, wall = _cli(run_nerf.main, argv + ["--render_only", "--render_factor", "4"], {})
    frames = sorted(Path(spiral).glob("*.png"))
    shape = read_png(str(frames[0])).shape if frames else None
    print(f"[37 spiral] {len(frames)} PNG frames of {shape} at --render_factor 4 in {wall:.2f} s "
          f"({wall / max(len(frames), 1) * 1e3:.1f} ms a frame, CLI wall); launches "
          f"{json.dumps(spiral_counts, sort_keys=True)}")
    side = FERN_SIZE // 4
    if len(frames) != 120 or shape != (side, side, 3) or spiral_counts.get("render_pass[S=128]", 0) != 120:
        fail(f"37: the spiral wrote {len(frames)} frames of {shape} (want 120 of {side}x{side})")

    # B10 on the NDC step: 20 steps from 001000.tar under SWNERF_PDF_MERGE=1
    _, _, merge, _ = _cli(run_nerf.main, fern_args(data, tmp / "fern_merge", "--ft_path", str(ckpt), "--i_print", "20",
                                                   "--i_weights", "100000"),
                          {"SWNERF_PDF_MERGE": "1", "SWNERF_MAX_ITERS": str(FERN_STEPS + 21)})
    print(f"[37 merge] 20 steps under SWNERF_PDF_MERGE=1: launches {json.dumps(merge, sort_keys=True)}")
    if merge.get("sample_pdf_merge") != 20 or merge.get("sample_pdf"):
        fail(f"37: under SWNERF_PDF_MERGE=1 the NDC step launched B10 / B2 {merge} (want 20 B10, no B2)")
    TC_SUMMARY["fern shape (phase 37)"] = (f"{med:.3f} ms per train step, {per_frame:.1f} ms per {FERN_SIZE}x"
                                           f"{FERN_SIZE} frame")
    return data, ckpt, dict(train=train, serve=serve, spiral=spiral_counts, merge=merge)


def phase38_holds(dev, data, ckpt, counts):
    """The kernels against their twins at the NDC path's shapes, with
    001000.tar's weights (phase 37) on the fern-shaped capture: B1 on 1,024
    seeded pixels of its first train view (the step's rays: S = 64 jittered,
    S = 128 from a B2 pass at 63 bins -> 64 samples) at phase 7's bars; B3
    at S = 64 and 128 on every chunk of holdout view 0 (254,016 rays: 7
    chunks of 32,768 and a ragged one of 24,640) at phase 4's bars (fp32 on
    the first chunk); B2 at 63 bins -> 64 samples over the frame, bit-equal
    to its twin (linspace and random u); B10 at Mz = 64, S = 64, bit-equal
    to B2 + torch.sort and to its twin. Times at the step's and the serving
    chunk's shapes beside their bounds. Returns the [kernel] rows."""
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops import sampling
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.render.core import build_rays, make_rays_from_camera
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict
    from swnerf_torch.utils.config import config_parser

    scene = load_scene(config_parser().parse_args(fern_args(data, data.parent / "unused")))
    cfg = VanillaNeRFConfig()
    ck = load_tar(str(ckpt))
    coarse, fine = (VanillaNeRF(cfg, device=dev, fused=False) for _ in range(2))
    coarse.load_state_dict(vanilla_state_dict(ck["network_fn_state_dict"]))
    fine.load_state_dict(vanilla_state_dict(ck["network_fine_state_dict"]))
    H, W = scene.H, scene.W

    # B1: a train step's rays
    view = int(scene.i_train[0])
    g = torch.Generator(device=dev).manual_seed(0)
    pix = torch.stack([torch.randint(0, H, (1024,), generator=g, device=dev),
                       torch.randint(0, W, (1024,), generator=g, device=dev)], -1)
    c2w = torch.as_tensor(scene.poses[view][:3, :4], device=dev)
    o, d = get_rays_at(pix, H, W, scene.K, c2w)
    rays = build_rays(o, d, 0.0, 1.0, ndc=True, H=H, W=W, focal=scene.focal)
    target = torch.as_tensor(scene.images[view], device=dev)[pix[:, 0], pix[:, 1]].contiguous()
    b1_rows = hold_b1("38", dev, cfg, coarse, fine, rays, target, n_importance=64, white=False)

    # B3 over holdout view 0, chunk by chunk; B2 and B10 on its coarse weights
    frame = make_rays_from_camera(H, W, scene.K, scene.poses[scene.i_test[0]][:3, :4], 0.0, 1.0, ndc=True,
                                  device=dev)
    n_all = frame.origins.shape[0]
    pc, pf = b3.pack_params(coarse.state_dict(), cfg), b3.pack_params(fine.state_dict(), cfg)
    worst = {64: [0.0, 0.0], 128: [0.0, 0.0]}
    zs64, ws64 = [], []
    for start in range(0, n_all, 32768):
        o, d, ve, z, dist = pass_inputs(frame.slice(start, min(n_all, start + 32768)), cfg, 64)
        n = z.shape[0]
        if start == 0:  # fp32 operands on the first chunk
            for S, model in ((64, coarse), (128, fine)):
                p32 = b3.pack_params(model.state_dict(), cfg, torch.float32)
                if S == 64:
                    zz, dd = z, dist
                else:
                    w = b3.render_pass_plain(b3.pack_params(coarse.state_dict(), cfg, torch.float32), o, d, ve, z,
                                             dist, None, False).weights
                    zz = fine_z(z, w, 64).contiguous()
                    dd = b3_dists(zz, d)
                got = b3.render_pass(p32, o, d, ve, zz, dd, None, False)
                ref = b3.render_pass_plain(p32, o, d, ve, zz, dd, None, False)
                torch.cuda.synchronize()
                drgb, dacc = (got.rgb - ref.rgb).abs().max().item(), (got.acc - ref.acc).abs().max().item()
                depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
                print(f"[38 B3 fp32 S={S}] chunk 0 ({n} NDC rays): max|drgb|={drgb:.3e} max|dacc|={dacc:.3e} "
                      f"depth_within_rtol={depth_ok}")
                if drgb > 1e-4 or dacc > 1e-4 or not depth_ok:
                    fail(f"38: B3 fp32 S={S} on NDC rays outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
                del got, ref
        res = b3.render_pass(pc, o, d, ve, z, dist, None, False)
        zf = sampling.merge_z_vals(z, b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), res.weights[:, 1:-1],
                                                    torch.linspace(0.0, 1.0, 64, device=dev).expand(n, 64)))
        zf = zf.contiguous()
        for S, packed, zz, dd in ((64, pc, z, dist), (128, pf, zf, b3_dists(zf, d))):
            got = res if S == 64 else b3.render_pass(packed, o, d, ve, zz, dd, None, False)
            ref = b3.render_pass_plain(packed, o, d, ve, zz, dd, None, False)
            diff = (got.rgb - ref.rgb).abs()
            worst[S][0] = max(worst[S][0], diff.max().item())
            worst[S][1] = max(worst[S][1], diff.mean().item())
        zs64.append(z)
        ws64.append(res.weights)
        if start + 32768 >= n_all:
            print(f"[38 B3 bf16] holdout view {scene.i_test[0]}, {n_all} NDC rays in chunks of 32,768 (the last "
                  f"{n}): " + ", ".join(f"S={S} worst chunk max|drgb|={a:.3e} mean|drgb|={b:.3e}"
                                        for S, (a, b) in worst.items()))
    if any(a > 1e-2 or b > 1e-3 for a, b in worst.values()):
        fail(f"38: B3 bf16 on NDC rays: max |drgb| > 1e-2 or mean > 1e-3 in a chunk ({worst})")
    z64, w64 = torch.cat(zs64).contiguous(), torch.cat(ws64)
    del zs64, ws64
    bins = (0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous()
    wsl = w64[:, 1:-1]
    b2_err = b10_err = 0.0
    gu = torch.Generator(device=dev).manual_seed(5)
    for mode in ("det", "random"):
        u = (torch.linspace(0.0, 1.0, 64, device=dev).expand(n_all, 64) if mode == "det"
             else torch.rand((n_all, 64), generator=gu, device=dev))
        got, ref = b2.sample_pdf(bins, wsl, u), b2.sample_pdf_plain(bins, wsl, u)
        us = u if mode == "det" else sampling.sorted_uniforms(n_all, 64, gu, dev)
        merged = b2.sample_pdf_merge(z64, bins, wsl, us)
        chain = torch.sort(torch.cat([z64, b2.sample_pdf(bins, wsl, us)], -1), -1).values
        twin = b2.sample_pdf_merge_plain(z64, bins, wsl, us)
        torch.cuda.synchronize()
        b2_err = max(b2_err, (got - ref).abs().max().item())
        b10_err = max(b10_err, (merged - chain).abs().max().item())
        print(f"[38 B2 {mode}] N={n_all} M=63 S=64: bit-equal to its twin {torch.equal(got, ref)}; B10 Mz=64 S=64: "
              f"bit-equal to B2 + torch.sort {torch.equal(merged, chain)}, to its twin {torch.equal(twin, merged)}")
        if not (torch.equal(got, ref) and torch.equal(merged, chain) and torch.equal(twin, merged)):
            fail(f"38 {mode}: B2 differs from its twin, or B10 from B2 + torch.sort or from its twin")

    # times at the serving chunk's shapes (B3 at S = 64 and 128, B2, B10) beside their bounds
    o, d, ve, z, dist = pass_inputs(frame.slice(0, 32768), cfg, 64)
    n = z.shape[0]
    zc, bc, wc = z64[:n], bins[:n], wsl[:n]
    uc = torch.linspace(0.0, 1.0, 64, device=dev).expand(n, 64)
    zf = sampling.merge_z_vals(z, b2.sample_pdf(bc, wc, uc)).contiguous()
    rows = {}
    for S, packed, zz in ((64, pc, z), (128, pf, zf)):
        dd = b3_dists(zz, d)
        nbytes = 4 * (6 * n + ve.numel() + 2 * zz.numel() + 5 * n + zz.numel()) + packed.weights.numel() * 2
        rows[f"render_pass[ndc,S={S}]"] = entry(
            f"render_pass[ndc,S={S}]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            counts["serve"].get(f"render_pass[S={S}]", 0) + counts["spiral"].get(f"render_pass[S={S}]", 0),
            worst[S][0], cuda_ms(lambda: b3.render_pass(packed, o, d, ve, zz, dd, None, False), 5),
            cuda_ms(lambda: b3.render_pass_plain(packed, o, d, ve, zz, dd, None, False), 2), nbytes,
            2 * packed.macs_per_sample * zz.numel(), "bf16")
    b2_launches = sum(c.get("sample_pdf", 0) for k, c in counts.items() if k != "merge")
    rows["sample_pdf[ndc,S=64]"] = entry(
        "sample_pdf[ndc,S=64]", "swnerf_torch/csrc/sample_pdf.cu", "swnerf_tpu/ops/pallas/sample_pdf.py:37",
        b2_launches, b2_err, cuda_ms(lambda: b2.sample_pdf(bc, wc, uc), 50),
        cuda_ms(lambda: b2.sample_pdf_plain(bc, wc, uc), 5), 4 * (bc.numel() + n * 62 + 64 + n * 64),
        n * (64 * (6 + 7) + 3 * 62), "fp32")
    row = entry("sample_pdf_merge[ndc,S=64]", "swnerf_torch/csrc/sample_pdf.cu",
                "swnerf_tpu/ops/pallas/sample_pdf.py:155", counts["merge"].get("sample_pdf_merge", 0), b10_err,
                cuda_ms(lambda: b2.sample_pdf_merge(zc, bc, wc, uc), 50),
                cuda_ms(lambda: b2.sample_pdf_merge_plain(zc, bc, wc, uc), 5),
                4 * (n * 64 + n * 63 + n * 62 + 64 + n * 128), n * 64 * 63, "fp32")
    row["library_ms"] = cuda_ms(lambda: torch.sort(torch.cat([zc, b2.sample_pdf(bc, wc, uc)], -1), -1).values, 50)
    rows[row["name"]] = row
    for S, fields in b1_rows.items():
        rows[f"render_loss[ndc,S={S}]"] = entry(
            f"render_loss[ndc,S={S}]", "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            counts["train"].get(f"render_loss[S={S}]", 0), *fields)
    for k in rows.values():
        print(f"[38 kernel] {k['name']}: {k['ms']:.4f} ms/launch (plain {k['plain_ms']:.3f} ms"
              + (f", B2 + torch.sort {k['library_ms']:.4f} ms" if k["library_ms"] is not None else "")
              + f"), bound {k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the "
              f"bound, {k['launches']} launches on the NDC main paths")
        if not k["launches"]:
            fail(f"38: {k['name']} was not launched on the NDC main paths")
    del z64, w64, bins, frame, pc, pf
    torch.cuda.empty_cache()
    return list(rows.values())


def phase39_quality(tmp):
    """The LLFF quality recipe (PARITY_TORCH.md, round 4): the port's
    write_llff_scene(n_images=24, size=64, scene="textured"), trained from
    scratch by run_nerf on benchmarks/parity_vs_torch.py's llff flags (D=8,
    W=256, multires 10 / 4, N_rand 128, 32 + 32 samples, lrate 5e-4, decay
    250, raw_noise_std 1, factor 1, llffhold 8, black background,
    use_viewdirs, batching) for 5,000 steps at seed 0 and the card's K = 20;
    --render_only --render_test of views 0, 8, 16 by the kernels and by the
    fp32 plain route: mean PSNR at data_range 1 >= 28.0 dB, the two within
    0.1 dB; ms per step and the phase's wall time."""
    from swnerf_torch.data.synthetic import write_llff_scene
    from swnerf_torch.pipelines import run_nerf
    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.utils.config import config_parser

    t_phase = time.perf_counter()
    data = tmp / "llff_quality"
    write_llff_scene(str(data), n_images=24, size=64, scene="textured", device="cuda")
    base = tmp / "llff_quality_logs"
    argv = ["--expname", "llff", "--basedir", str(base), "--datadir", str(data), "--dataset_type", "llff",
            "--factor", "1", "--llffhold", "8", "--use_viewdirs", "--netdepth", "8", "--netwidth", "256",
            "--netdepth_fine", "8", "--netwidth_fine", "256", "--multires", "10", "--multires_views", "4",
            "--N_rand", "128", "--N_samples", "32", "--N_importance", "32", "--lrate", "5e-4", "--lrate_decay", "250",
            "--raw_noise_std", "1e0", "--chunk", "8192", "--precrop_iters", "0", "--i_weights", str(QUALITY_STEPS),
            "--i_print", "500", "--i_video", "10000000", "--i_testset", "10000000", "--device", "cuda"]
    res, out, counts, wall = _cli(run_nerf.main, argv, {"SWNERF_MAX_ITERS": str(QUALITY_STEPS + 1),
                                                        "SWNERF_SEED": "0"})
    med = statistics.median(ms for i, ms in res["step_ms"].items() if i > 20 and i % 20 and (i - 1) % 20)
    psnrs = [(r["step"], round(r["psnr"], 2)) for r in clock_free_records(base / "llff") if "psnr" in r]
    print(f"[39 train] {QUALITY_STEPS} steps from scratch: CLI wall {wall:.2f} s, median {med:.3f} ms per step "
          f"(CUDA events); launches {json.dumps(counts, sort_keys=True)}; train PSNR at the prints {psnrs}")
    if "kernel train step" not in out or counts.get("render_loss[S=64]") != QUALITY_STEPS:
        fail(f"39: the quality run did not take the kernel step ({counts})")
    metrics, serve, swall = _render_test(argv, {})
    plain, _, _ = _render_test(argv, {"SWNERF_FUSED": "0"})
    scene = load_scene(config_parser().parse_args(argv + ["--render_test"]))
    gts = scene.images[scene.i_test]
    ours, ref = unit_psnrs(metrics["psnr"], gts), unit_psnrs(plain["psnr"], gts)
    mean_k, mean_p = sum(ours) / len(ours), sum(ref) / len(ref)
    print(f"[39 quality] test PSNR at data_range 1, views {list(scene.i_test)}: kernels {[round(x, 3) for x in ours]} "
          f"(mean {mean_k:.3f} dB), fp32 plain route on the same checkpoint {[round(x, 3) for x in ref]} (mean "
          f"{mean_p:.3f} dB); SSIM {[round(x, 4) for x in metrics['ssim']]}; render launches "
          f"{json.dumps(serve, sort_keys=True)}; phase wall {time.perf_counter() - t_phase:.1f} s")
    if list(scene.i_test) != list(QUALITY_VIEWS) or not mean_k >= 28.0 or abs(mean_k - mean_p) > 0.1:
        fail(f"39: mean test PSNR {mean_k:.3f} dB below 28.0, or {abs(mean_k - mean_p):.4f} dB from the fp32 plain "
             f"route's (views {list(scene.i_test)})")
    TC_SUMMARY["LLFF quality (phase 39)"] = f"{med:.3f} ms per train step, mean test PSNR {mean_k:.3f} dB"



# ---------------------------------------------------------------- what the trainers save, log and check
P40_STEPS, P40_SAVE = 40, 20  # phase 40's run length and its save and print cadence (K = 20 chunks)


def write_lpips_weights(d, seed=0):
    """Seeded LPIPS weights in the layouts SWNERF_LPIPS_DIR takes: the
    torchvision backbones (alexnet.pth, vgg16.pth: features.N.*,
    He-scaled) and the lpips heads (alex.pth, vgg.pth: linN.model.1.weight,
    non-negative)."""
    import torch

    from swnerf_torch.utils import lpips as lpips_torch

    g = torch.Generator().manual_seed(seed)
    for net, (convs, feature_idx, taps, _) in lpips_torch.NETS.items():
        sd = {}
        for (cin, cout, k, _, _), fi in zip(convs, feature_idx):
            sd[f"features.{fi}.weight"] = torch.randn((cout, cin, k, k), generator=g) * (2.0 / (cin * k * k)) ** 0.5
            sd[f"features.{fi}.bias"] = torch.randn((cout,), generator=g) * 0.01
        heads = {f"lin{i}.model.1.weight": torch.rand((1, convs[t][1], 1, 1), generator=g) for i, t in enumerate(taps)}
        backbone, head = lpips_torch.NET_FILES[net]
        torch.save(sd, str(d / backbone))
        torch.save(heads, str(d / head))


def snapshot_tensors(path):
    """Every weight, Adam moment and count of a vanilla .tar or .msgpack as
    {(where, name): CPU tensor}, in the port's layout."""
    import torch

    from swnerf_torch.train import checkpoint as ck
    from swnerf_torch.utils import msgpack

    out = {}
    if path.suffix == ".tar":
        ckpt = ck.load_tar(str(path))
        for net in ("network_fn_state_dict", "network_fine_state_dict"):
            out.update({(net, k): v for k, v in ckpt[net].items()})
        opt = ckpt["optimizer_state_dict"]
    else:
        state = msgpack.unpackb(path.read_bytes())["state"]
        for net, key in (("network_fn_state_dict", "coarse"), ("network_fine_state_dict", "fine")):
            out.update({(net, k): v for k, v in ck.params_from_jax(state["params"][key]).items()})
        opt = ck.adam_to_torch_dict(state["opt_state"]["0"], state["params"])
    for idx, ent in opt["state"].items():
        for f in ("exp_avg", "exp_avg_sq"):
            out[("adam", idx, f)] = ent[f]
        out[("adam", idx, "step")] = torch.as_tensor(float(ent["step"]))
    return out


def same_tensors(a, b):
    import torch

    return set(a) == set(b) and len(a) > 0 and all(torch.equal(a[k], b[k]) for k in a)


def phase40_tools(dev, tmp, dyn_data):
    """Phase 40 (the module docstring). Returns its launch counts: the
    40-step run's and the test render's."""
    import numpy as np
    import torch

    from swnerf_torch.ops.kernels import _TRACE_NAME
    from swnerf_torch.pipelines import common, eval_dirs, run_dnerf, run_nerf
    from swnerf_torch.train import checkpoint as ck
    from swnerf_torch.utils import msgpack
    from swnerf_torch.utils.config import config_parser
    from swnerf_torch.utils.metrics import lpips
    from swnerf_torch.utils.png import write_png_bytes

    t_phase = time.perf_counter()
    start, expname = 10000, "full_nerf_200k"
    end = start + P40_STEPS

    def argv(base, *extra):
        return ["--config", str(CONFIG), "--datadir", str(DATADIR), "--basedir", str(base), "--device", dev.type,
                "--i_print", str(P40_SAVE), "--i_weights", str(P40_SAVE), "--testskip", "5", *extra]

    def fresh(name, files=()):
        """A log directory holding a copy of 010000.tar, or of ``files``."""
        exp = tmp / name / expname
        exp.mkdir(parents=True)
        for f in files or (CKPT,):
            shutil.copy(f, exp / Path(f).name)
        return tmp / name

    # -- 40 steps with every switch on, and with every switch off
    prof_dir = tmp / "p40_profile"
    on, off = fresh("p40_on"), fresh("p40_off")
    switches = {"SWNERF_CKPT_FORMAT": "both", "SWNERF_DEBUG_NANS": "1", "SWNERF_PROFILE_DIR": str(prof_dir),
                "SWNERF_MAX_ITERS": str(end + 1)}
    res_on, out_on, counts, wall_on = _cli(run_nerf.main, argv(on), switches)
    res_off, _, counts_off, wall_off = _cli(run_nerf.main, argv(off), {"SWNERF_MAX_ITERS": str(end + 1)})
    exp_on, exp_off = on / expname, off / expname
    saves = [f"{i:06d}" for i in range(start + P40_SAVE, end + 1, P40_SAVE)]
    listing = sorted(p.name for p in exp_on.iterdir() if p.suffix in (".tar", ".msgpack"))
    checks = {
        "both formats at every save": listing == sorted([f"{start:06d}.tar"] + [f"{i}{x}" for i in saves
                                                                               for x in (".msgpack", ".tar")]),
        ".tar = .msgpack": all(same_tensors(snapshot_tensors(exp_on / f"{i}.tar"),
                                            snapshot_tensors(exp_on / f"{i}.msgpack")) for i in saves),
        "switches on = off": same_tensors(snapshot_tensors(exp_on / f"{end:06d}.tar"),
                                          snapshot_tensors(exp_off / f"{end:06d}.tar")),
        "metrics.jsonl": clock_free_records(exp_on) == clock_free_records(exp_off)
        and len(clock_free_records(exp_on)) > 0,
        "launches": counts == counts_off and counts.get("render_loss[S=192]") == P40_STEPS,
        "one capture": sum(ln.startswith("Captured") for ln in out_on.splitlines()) == 1,
    }
    traces = sorted(prof_dir.glob("trace_*.json"))
    names = collections.Counter()
    if traces:
        for e in json.loads(traces[0].read_text())["traceEvents"]:
            m = _TRACE_NAME.match(e.get("name", "")) if e.get("cat") == "kernel" else None
            if m:
                names[m.group(1) or m.group(2)] += 1
    checks["trace names B1 and B2"] = len(traces) == 1 and names["sample_pdf_kernel"] > 0 and (
        names["render_loss_tc_kernel"] + names["render_loss_fwd_kernel"]) > 0
    print(f"[40 switches] {P40_STEPS} steps from {start} with SWNERF_CKPT_FORMAT=both, SWNERF_DEBUG_NANS=1, "
          f"SWNERF_PROFILE_DIR (CLI wall {wall_on:.2f} s) against none (CLI wall {wall_off:.2f} s): " + ", ".join(
              f"{k} {'yes' if v else 'NO'}" for k, v in checks.items()) + f"; launches {json.dumps(counts, sort_keys=True)}")
    print(f"[40 trace] {[t.name for t in traces]} ({sum(t.stat().st_size for t in traces) / 2**20:.1f} MiB): the "
          f"port's kernels by name over the traced chunk {dict(sorted(names.items()))}")
    if not all(checks.values()):
        fail(f"40: {checks}")

    # -- 20 more steps from the .msgpack alone (the profiler on) and from the .tar
    last = exp_on / f"{end:06d}"
    resumed = {}
    for fmt, envs in (("msgpack", {"SWNERF_PROFILE_DIR": str(tmp / "p40_profile_resume")}), ("tar", {})):
        base = fresh(f"p40_resume_{fmt}", [last.with_suffix("." + fmt)])
        res, out, _, wall = _cli(run_nerf.main, argv(base), {"SWNERF_MAX_ITERS": str(end + P40_SAVE + 1), **envs})
        if f"Reloading from {base / expname / (last.name + '.' + fmt)}" not in out:
            fail(f"40: the resume did not read the {fmt}")
        steps = [ms for i, ms in res["step_ms"].items() if i > end + 2]  # the replays after the capture
        resumed[fmt] = (snapshot_tensors(base / expname / f"{end + P40_SAVE:06d}.tar"), clock_free_records(base / expname),
                        statistics.median(steps), wall)
    (ta, ra, ma, wa), (tb, rb, mb, wb) = resumed["msgpack"], resumed["tar"]
    print(f"[40 resume] {P40_SAVE} steps from {last.name}.msgpack alone against {last.name}.tar: parameters and Adam "
          f"{'equal' if same_tensors(ta, tb) else 'DIFFER'}, metrics.jsonl {'equal' if ra == rb and ra else 'DIFFER'}")
    print(f"[40 profiler] its cost a step: median {ma:.3f} ms per step over the replays with the profiler on (the "
          f"msgpack resume), {mb:.3f} ms without (CUDA events): {ma - mb:+.3f} ms; CLI wall {wa:.2f} s against "
          f"{wb:.2f} s for {P40_SAVE} steps: {(wa - wb) / P40_SAVE * 1e3:+.1f} ms a step")
    if not (same_tensors(ta, tb) and ra == rb and ra):
        fail("40: the resume from the .msgpack differs from the resume from the .tar")

    # -- a NaN planted in one weight of the snapshot
    raw = msgpack.unpackb(last.with_suffix(".msgpack").read_bytes())
    raw["state"]["params"]["coarse"]["pts_linears"]["1"]["w"][7, 11] = np.nan
    nan_base = tmp / "p40_nan"
    (nan_base / expname).mkdir(parents=True)
    (nan_base / expname / f"{end:06d}.msgpack").write_bytes(msgpack.packb(raw))
    try:
        _cli(run_nerf.main, argv(nan_base), {"SWNERF_DEBUG_NANS": "1", "SWNERF_MAX_ITERS": str(end + P40_SAVE + 1)})
    except FloatingPointError as e:
        # B1's ReLU (fmaxf) maps the NaN pre-activations to 0, so the loss can
        # stay finite: then the check names the parameter after the chunk
        print(f"[40 debug nans] a NaN in coarse pts_linears.1.w[7, 11] of {end:06d}.msgpack: {e}")
        if f"iteration {end + 1} " not in str(e) and f"iterations {end + 1}-{end + P40_SAVE}" not in str(e):
            fail(f"40: the NaN was not caught in the first chunk ({end + 1}-{end + P40_SAVE}): {e}")
    else:
        fail("40: a NaN in the weights did not raise FloatingPointError under SWNERF_DEBUG_NANS=1")
    torch.cuda.empty_cache()

    # -- the native snapshot's save and load at full width
    args = config_parser().parse_args(argv(on))
    state = run_nerf.create_vanilla(args, dev)[0]
    snap = tmp / "p40_snapshot.msgpack"
    save_ms, load_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_native(str(snap), ck.native_state(state), {"global_step": end})
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        saved, _ = ck.load_native(str(snap), ck.native_state(state), {"global_step": 0})
        ck.restore_native_state(state, saved, end)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    n_values = sum(p.numel() for m in state.modules() for p in m.parameters()) * 3
    print(f"[40 snapshot] {snap.stat().st_size / 1e6:.2f} MB ({n_values:,} fp32 values: params, mu, nu of the two "
          f"nets): save {statistics.median(save_ms):.1f} ms, load + restore {statistics.median(load_ms):.1f} ms "
          f"(median of 5, card to host and back; host clock)")
    del state

    # -- the test views with LPIPS on seeded weights, against the CPU
    lp_dir = tmp / "p40_lpips"
    lp_dir.mkdir()
    write_lpips_weights(lp_dir)
    frames = []
    scored = common.calculate_metrics

    def recording(gt, pred, device="cpu"):
        frames.append((gt, pred))
        return scored(gt, pred, device=device)

    common.calculate_metrics = recording
    try:
        savedir, _, serve, wall = _cli(run_nerf.main, argv(on, "--render_only", "--render_test"),
                                       {"SWNERF_LPIPS_DIR": str(lp_dir)})
    finally:
        common.calculate_metrics = scored
    metrics = json.loads((Path(savedir) / "metrics.json").read_text())
    with env(SWNERF_LPIPS_DIR=str(lp_dir)):
        cpu = [lpips(g, p, device="cpu") for g, p in frames]
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lpips(*frames[0], device=dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    got = metrics["lpips"]
    err = max(abs(a - b) for a, b in zip(got, cpu)) if None not in got and got else float("inf")
    print(f"[40 lpips] {len(got)} test frames (400x400) through B3: LPIPS(alex) on the card {[round(x, 6) for x in got]}"
          f", the CPU's max |d| {err:.3e}; {statistics.median(ms[1:]):.2f} ms a frame on the card (LPIPS alone, "
          f"host clock, median of 5 after one); PSNR {[round(x, 3) for x in metrics['psnr']]}; 'lpips_note' "
          f"{'present' if 'lpips_note' in metrics else 'absent'}; launches {json.dumps(serve, sort_keys=True)}")
    if len(got) != 5 or err > 1e-4 or "lpips_note" in metrics or serve.get("render_pass[S=192]", 0) <= 0:
        fail(f"40: LPIPS {got} against the CPU {cpu}, or the render did not run B3")
    for k, v in serve.items():
        counts[k] = counts.get(k, 0) + v

    # -- eval_dirs on that directory against its ground truth
    scene = common.load_scene(config_parser().parse_args(argv(on)))
    gt_dir, ev_dir = tmp / "p40_gt", tmp / "p40_eval"
    gt_dir.mkdir()
    for i, img in enumerate(scene.images[scene.i_test]):
        write_png_bytes(str(gt_dir / f"{i:03d}.png"), (255 * np.clip(img, 0, 1)).astype(np.uint8))
    with env(SWNERF_LPIPS_DIR=str(lp_dir)):
        ev = eval_dirs.main(["--pred", savedir, "--gt", str(gt_dir), "--out", str(ev_dir), "--device", dev.type])
    print(f"[40 eval_dirs] {savedir} against the ground truth's PNGs: mean {ev['mean']}")
    if len(ev["frames"]) != 5 or ev["mean"]["lpips"] is None or not ev["mean"]["psnr"] > 25.0:
        fail(f"40: eval_dirs gave {ev['mean']}")

    # -- the spiral through write_video
    spiral, _, _, wall = _cli(run_nerf.main, argv(on, "--render_only", "--render_factor", "4"), {})
    videos = sorted(p.name for p in Path(spiral).iterdir() if p.stem == "video")
    try:
        import cv2

        want, writer = ["video.mp4"], f"cv2 {cv2.__version__} imports here: mp4v"
    except ImportError:
        want, writer = ["video.gif"], "no cv2 here: the port's GIF"
    head = (Path(spiral) / want[0]).read_bytes()[:6] if videos == want else b""
    print(f"[40 video] the spiral at --render_factor 4: {videos} in {spiral} ({writer}; CLI wall {wall:.2f} s)")
    if videos != want or (want == ["video.gif"] and head != b"GIF89a"):
        fail(f"40: the spiral's video is {videos}, not {want}")

    # -- --do_half_precision on the plain route
    half_precision_hold(dev)
    dn_base = tmp / "p40_half"
    _, out, dn_counts, _ = _cli(run_dnerf.main, [
        "--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--datadir", str(dyn_data), "--basedir",
        str(dn_base), "--device", dev.type, "--do_half_precision", "--i_print", "1", "--i_weights", "100000"],
        {"SWNERF_FUSED": "0", "SWNERF_MAX_ITERS": "800002"})
    rec = [r for r in clock_free_records(dn_base / "full_dnerf_800k") if "loss" in r]
    field_kernels = {k: v for k, v in dn_counts.items() if k.startswith(("time_net", "trunk"))}
    print(f"[40 half precision] one run_dnerf --do_half_precision step under SWNERF_FUSED=0 from 800000.tar: {rec}, "
          f"field kernel launches {field_kernels}")
    if len(rec) != 1 or not all(np.isfinite(v) for v in rec[0].values()) or field_kernels:
        fail("40: the --do_half_precision step did not run on the plain route or its loss is not finite")
    print(f"[40 done] phase 40 in {time.perf_counter() - t_phase:.1f} s")
    return counts


def half_precision_hold(dev):
    """D-NeRF's plain field at the config's widths (D=8, W=256, multires 10
    / 4, seeded weights) with half_precision on 500 rays x 64 points on the
    card: every dense layer within 1e-5 (relative L2) of float64 on its
    input and weight rounded to bf16; over the whole forward the float64
    chain parts from the fp32 one wherever an activation lies within
    rounding of a bf16 boundary (on the CPU at these widths: dx 1.1e-4,
    raw 1.4e-3), so dx within 1e-3 and raw within 5e-3 of it, and the
    fp32 field at least 5 times further."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, common, dnerf, vanilla
    from swnerf_torch.ops.embedding import positional_encoding

    cfg = dict(netdepth=8, netwidth=256, skips=(4,), multires=10, multires_views=4, use_viewdirs=True,
               output_ch=4, zero_canonical=False)
    g = torch.Generator(device=dev).manual_seed(0)
    half = DirectTemporalNeRF(DNeRFConfig(**cfg, half_precision=True), device=dev, generator=g, fused=False)
    full = DirectTemporalNeRF(DNeRFConfig(**cfg), device=dev, fused=False)
    full.load_state_dict(half.state_dict())
    pts = torch.rand((500, 64, 3), generator=g, device=dev) * 3.0 - 1.5
    vd = torch.nn.functional.normalize(torch.randn((500, 3), generator=g, device=dev), dim=-1)
    t = torch.rand((500, 1), generator=g, device=dev)

    def b16(x):
        return x.detach().float().to(torch.bfloat16).double()

    def rel(a, b):
        return float(torch.linalg.norm(a.detach().double() - b) / torch.linalg.norm(b))

    errs = []

    def checked(layer, x, flag=False):
        out = common.dense(layer, x, flag)
        errs.append(rel(out, b16(x) @ b16(layer.weight).T + layer.bias.detach().double()))
        return out

    saved = vanilla.dense, dnerf.dense
    vanilla.dense = dnerf.dense = checked
    try:
        with torch.no_grad():
            raw, extras = half(pts, vd, t)
    finally:
        vanilla.dense, dnerf.dense = saved
    with torch.no_grad():
        raw32, _ = full(pts, vd, t)

    def ref_dense(lyr, x):
        return b16(x) @ b16(lyr.weight).T + lyr.bias.detach().double()

    # the encodings as the field computes them (fp32), then float64
    te = t[..., None, :].expand(500, 64, 1)
    pe = positional_encoding(pts, cfg["multires"]).double()
    h = torch.cat([pe, positional_encoding(te, cfg["multires"]).double()], -1)
    for i, lyr in enumerate(half._time):
        h = torch.relu(ref_dense(lyr, h))
        h = torch.cat([pe, h], -1) if i in cfg["skips"] else h
    dx = ref_dense(half._time_out, h)
    emb = positional_encoding(pts + dx.float(), cfg["multires"]).double()
    occ, h = half._occ, emb
    for i, lyr in enumerate(occ.pts_linears):
        h = torch.relu(ref_dense(lyr, h))
        h = torch.cat([emb, h], -1) if i in cfg["skips"] else h
    alpha = ref_dense(occ.alpha_linear, h)
    ve = positional_encoding(vd, cfg["multires_views"]).double()[:, None, :].expand(500, 64, -1)
    h = torch.cat([ref_dense(occ.feature_linear, h), ve], -1)
    for lyr in occ.views_linears:
        h = torch.relu(ref_dense(lyr, h))
    ref = torch.cat([ref_dense(occ.rgb_linear, h), alpha], -1)
    e_dx, e_raw, e_32 = rel(extras["dx"], dx), rel(raw, ref), rel(raw32, ref)
    print(f"[40 half precision] D-NeRF plain field, W=256, 32,000 points on the card: the {len(errs)} dense layers "
          f"within {max(errs):.2e} of float64 on bf16-rounded inputs and weights; dx {e_dx:.2e}, raw {e_raw:.2e} "
          f"from the float64 chain (the fp32 field {e_32:.2e})")
    if len(errs) != 21 or max(errs) > 1e-5 or e_dx > 1e-3 or e_raw > 5e-3 or not e_32 > 5 * e_raw:
        fail("40: the --do_half_precision field is outside its bars")


# ---------------------------------------------------------------- export, JPEG captures, the 2-D encoding study

P41_RAYS = 32768  # the artifacts' ray batch: the serving chunk of phase 5
P41_SMALL = 256  # the cpu,cuda artifact run on both devices
P42_VIEWS, P42_W, P42_H, P42_FACTOR = 20, 4032, 3024, 8  # fern's capture: 20 views of 4032 x 3024, factor 8
P43_EPOCHS = 3


def _same_bits(a, b) -> bool:
    """Bit-equal, NaN where the other is NaN (0 / 0 disparities)."""
    import torch

    return a.shape == b.shape and bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def _tiles(rays, n_rays):
    """The rays in tiles of ``n_rays`` as render_image cuts them, the last one
    padded from the frame's first rays; yields (tile, live rows)."""
    import torch

    from swnerf_torch.render.core import Rays

    n = rays.origins.shape[0]
    for start in range(0, n, n_rays):
        live = min(n_rays, n - start)
        yield Rays(*(None if x is None else torch.cat([x[start : start + live], x[: n_rays - live]])
                     for x in rays)), live


def _serve(call, rays, n_rays):
    """(rgb, disp, acc, depth) of all ``rays`` through ``call(tile)``, tiled."""
    import torch

    outs = [[r[:live] for r in call(tile)] for tile, live in _tiles(rays, n_rays)]
    return [torch.cat(parts) for parts in zip(*outs)]


def _eager(coarse, fine, rcfg):
    """The eager route's render of a tile (the fields as they are built)."""
    import torch

    from swnerf_torch.render.core import render_rays

    def call(tile):
        with torch.no_grad():
            out = render_rays(coarse, tile, rcfg.eval_mode(), fine_model=fine)
        return out["rgb"], out["disp"], out["acc"], out["depth"]

    return call


def _artifact(art, params):
    def call(tile):
        return art(params, tile.origins, tile.directions, tile.viewdirs, tile.near, tile.far,
                   *(() if tile.times is None else (tile.times,)))

    return call


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _export_jobs(dyn_data):
    """Phase 41's export_model runs: (artifact, argv, extra environment).
    Each loads its checkpoint on the CPU (``--device cpu``: the program is
    traced there either way) and names the devices its artifact runs on."""
    vanilla = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--datadir", str(DATADIR)]

    def dyn(config, ckpt, mode):
        return ["--config", str(config), "--ft_path", str(ckpt), "--datadir", str(dyn_data), "--export_mode", mode,
                "--export_fused", "--export_platforms", "cuda"]

    rays = ["--export_rays", str(P41_RAYS)]
    fused = ["--export_fused", "--export_platforms", "cuda"]
    return [
        ("vanilla_plain.pt2", vanilla + rays + ["--export_platforms", "cpu,cuda"], {}),
        ("vanilla_fused.pt2", vanilla + rays + fused, {}),
        ("vanilla_fused_raw.pt2", vanilla + rays + fused, {"SWNERF_FUSED_RAW": "1"}),
        ("tnerf_fused.pt2", dyn(TNERF_CONFIG, TNERF_CKPT, "tnerf") + rays, {}),
        ("dnerf_fused.pt2", dyn(DNERF_CONFIG, DNERF_CKPT, "dnerf") + rays, {}),
    ]


def phase41_export(dev, tmp, dyn_data):
    """Phase 41 (the module docstring). Returns the swnerf:: ops' launches
    by ``launches`` key, the artifacts' calls alone."""
    import threading

    import numpy as np
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import export_model
    from swnerf_torch.pipelines.run_dnerf import create_dnerf
    from swnerf_torch.pipelines.run_nerf import create_vanilla
    from swnerf_torch.pipelines.run_tnerf import create_tnerf
    from swnerf_torch.utils.config import config_parser, config_parser_dnerf
    from swnerf_torch.utils.export import export_renderer, kernel_ops, load_renderer
    from swnerf_torch.utils.metrics import psnr as psnr_of
    from swnerf_torch.utils.png import read_png

    t_phase = time.perf_counter()
    base = tmp / "p41"
    base.mkdir()
    counts = collections.Counter()

    def params_of(coarse, fine):
        return {k: None if f is None else {n: p.detach() for n, p in f.named_parameters()}
                for k, f in (("coarse", coarse), ("fine", fine))}

    # -- the exports: export_model as a user runs it, one process each, together
    procs, walls = {}, {}
    t0 = time.perf_counter()
    for name, argv, extra in _export_jobs(dyn_data):
        with open(base / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "swnerf_torch.pipelines.export_model", "--export_out", str(base / name),
                 "--basedir", str(base / "logs"), "--device", "cpu", *argv],
                cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1", **extra}, stdout=log,
                stderr=subprocess.STDOUT)

    arts, loads, one_load = {}, {}, threading.Lock()

    def waiter(name, proc):
        """The process's wall; then its artifact loaded and moved to the
        card (one at a time) while the other exports run."""
        proc.wait()
        walls[name] = time.perf_counter() - t0
        if proc.returncode == 0:
            with one_load:
                t1 = time.perf_counter()
                arts[name] = load_renderer((base / name).read_bytes())
                arts[name].program("cuda")
                loads[name] = time.perf_counter() - t1

    threads = [threading.Thread(target=waiter, args=item) for item in procs.items()]
    for t in threads:
        t.start()
    try:
        # -- meanwhile, the eager kernel routes: 010000.tar, and the T-NeRF
        # and D-NeRF 800000.tar on a tile of their test frame 0
        argv = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(base / "eager"), "--datadir",
                str(DATADIR), "--device", dev.type]
        state, rcfg, _, _ = create_vanilla(config_parser().parse_args(argv), dev)
        coarse, fine = state.coarse.eval(), state.fine.eval()
        if not (coarse.fused and fine.fused):
            fail("41: the vanilla fields are not on their kernel route")
        params = params_of(coarse, fine)
        rays = view0_rays(dev)
        tile = next(_tiles(rays, P41_RAYS))[0]
        with env(SWNERF_FUSED_RAW="1"):
            want_r = _eager(coarse, fine, rcfg)(tile)
        frame_tile = next(_tiles(frame_rays(dev, dyn_data, "test", 0)[0], P41_RAYS))[0]
        dynamic = {}
        for name, config, ckpt, create in (("tnerf", TNERF_CONFIG, TNERF_CKPT, create_tnerf),
                                           ("dnerf", DNERF_CONFIG, DNERF_CKPT, create_dnerf)):
            dargv = ["--config", str(config), "--ft_path", str(ckpt), "--basedir", str(base / "eager"), "--datadir",
                     str(dyn_data), "--device", dev.type]
            dstate, drcfg = create(config_parser_dnerf().parse_args(dargv), dev)[:2]
            dstate.coarse.eval()
            dynamic[name] = (params_of(dstate.coarse, dstate.fine), _eager(dstate.coarse, dstate.fine, drcfg)(frame_tile))
            del dstate
        # and the cpu,cuda plain artifact at 256 rays, exported in this process
        t1 = time.perf_counter()
        plain_c, plain_f = export_model.export_fields(coarse, fine, False, dev)
        small = load_renderer(export_renderer(plain_c, params, rcfg, P41_SMALL, fine_field=plain_f,
                                              platforms=["cpu", "cuda"]))
        small_s = time.perf_counter() - t1
        del plain_c, plain_f
        for t in threads:
            t.join(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        out = (base / f"{name}.log").read_text()
        if proc.returncode != 0 or name not in loads:
            fail(f"41: export_model for {name} exited with {proc.returncode}:\n{out[-3000:]}")
        said = [ln for ln in out.splitlines() if ln.startswith("Exported")]
        print(f"[41 export] {name}: process wall {walls[name]:.2f} s ({len(procs)} together), {said[-1]}; "
              f"load_renderer + the move to the card {loads[name]:.2f} s, platforms {arts[name].meta['platforms']}, "
              f"swnerf ops {kernel_ops(arts[name].program('cuda'))}")
    print(f"[41 export] the {len(procs)} exports together: {max(walls.values()):.1f} s of wall")
    b2 = {"swnerf.sample_pdf.default": 1}  # the fine pass's resample
    want_ops = {"vanilla_plain.pt2": b2, "vanilla_fused.pt2": {"swnerf.trunk.default": 2, **b2},
                "vanilla_fused_raw.pt2": {"swnerf.trunk.default": 2, **b2},
                "tnerf_fused.pt2": {"swnerf.trunk.default": 1},
                "dnerf_fused.pt2": {"swnerf.time_net.default": 2, "swnerf.trunk.default": 2, **b2}}
    for name, want in want_ops.items():
        if kernel_ops(arts[name].program("cuda")) != want:
            fail(f"41: {name} calls {kernel_ops(arts[name].program('cuda'))}, not {want}")

    def served(art, rays, params, envs=None):
        """The artifact's outputs over ``rays`` and their ms (host clock),
        after a first tile (the program moved to the card and warmed); its
        launches counted."""
        call = _artifact(art, params)
        with env(**(envs or {})):
            call(next(_tiles(rays, P41_RAYS))[0])
            before = collections.Counter(launches)
            out, ms = _timed(lambda: _serve(call, rays, P41_RAYS))
        counts.update(collections.Counter(launches) - before)
        return out, ms

    # -- test frame 0 through the eager route, the fused and the plain artifact
    _eager(coarse, fine, rcfg)(tile)
    eager, eager_ms = _timed(lambda: _serve(_eager(coarse, fine, rcfg), rays, P41_RAYS))
    got_f, fused_ms = served(arts["vanilla_fused.pt2"], rays, params)
    got_p, plain_ms = served(arts["vanilla_plain.pt2"], rays, params)
    same = [_same_bits(a, b) for a, b in zip(got_f, eager)]
    with open(DATADIR / "transforms_test.json") as f:
        frame = json.load(f)["frames"][0]
    img = read_png(str(DATADIR / (frame["file_path"] + ".png"))).astype(np.float32) / 255.0
    gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    psnr = {k: psnr_of(gt, v[0].reshape(400, 400, 3).cpu().numpy())  # skimage's data range, as metrics.json
            for k, v in (("fused", got_f), ("plain", got_p), ("eager", eager))}
    print(f"[41 vanilla] test frame 0 in {(rays.origins.shape[0] + P41_RAYS - 1) // P41_RAYS} tiles of {P41_RAYS}: "
          f"fused artifact {fused_ms:.1f} ms, plain artifact (fp32) {plain_ms:.1f} ms, eager kernel route "
          f"{eager_ms:.1f} ms (host clock, synchronized); fused = eager bit for bit (rgb, disp, acc, depth) {same}; "
          f"PSNR fused {psnr['fused']:.4f}, plain {psnr['plain']:.4f}, eager {psnr['eager']:.4f} dB")
    if not all(same) or abs(psnr["fused"] - psnr["plain"]) > 0.1:
        fail("41: the fused artifact's frame is not the eager route's, or not within 0.1 dB of the plain artifact")
    # -- B8: the raw route's artifact on the first tile against the eager raw route
    got_r, raw_ms = served(arts["vanilla_fused_raw.pt2"], tile, params, envs={"SWNERF_FUSED_RAW": "1"})
    same_r = [_same_bits(a, b) for a, b in zip(got_r, want_r)]
    print(f"[41 vanilla raw] one tile under SWNERF_FUSED_RAW=1 (B8): {raw_ms:.1f} ms, = the eager raw route {same_r}")
    if not all(same_r):
        fail("41: the fused raw-route artifact's tile is not the eager raw route's")
    # -- the cpu,cuda artifact on both devices (the plain route at 256 rays)
    first = rays.slice(0, P41_SMALL)
    on_card = _artifact(small, params)(first)
    cpu_params = {k: {n: t.cpu() for n, t in v.items()} for k, v in params.items()}
    on_cpu = _artifact(small, cpu_params)(type(first)(*(None if x is None else x.cpu() for x in first)))
    d_rgb = (on_card[0].cpu() - on_cpu[0]).abs().max().item()
    d_acc = (on_card[2].cpu() - on_cpu[2]).abs().max().item()
    print(f"[41 platforms] a cpu,cuda plain artifact ({P41_SMALL} rays; export_renderer + load_renderer in this "
          f"process {small_s:.2f} s, beside the exports) on the card and on the CPU: max |drgb| {d_rgb:.2e}, max "
          f"|dacc| {d_acc:.2e}")
    if not (d_rgb <= 1e-4 and d_acc <= 1e-4):
        fail("41: the cpu,cuda artifact's two devices disagree")
    del state, coarse, fine, params, eager, got_f, got_p, small

    # -- the T-NeRF and D-NeRF artifacts on their tile
    for name, (params, want) in dynamic.items():
        got, ms = served(arts[f"{name}_fused.pt2"], frame_tile, params)
        same = [_same_bits(a, b) for a, b in zip(got, want)]
        print(f"[41 {name}] one tile of test frame 0 at its time through the fused artifact: {ms:.1f} ms, "
              f"= the eager kernel route {same}")
        if not all(same):
            fail(f"41: the {name} fused artifact's tile is not the eager route's")
    del dynamic
    torch.cuda.empty_cache()
    print(f"[41 launches] the artifacts' swnerf:: ops launched {dict(counts)}")
    for key in ("trunk", "trunk[raw]", "trunk[tnerf]", "time_net", "sample_pdf"):
        if counts.get(key, 0) <= 0:
            fail(f"41: no {key} launch through the exported programs")
    print(f"[41 done] phase 41 in {time.perf_counter() - t_phase:.1f} s")
    return counts


def _pattern(H, W):
    """A smooth, textured 8-bit BGR picture (for cv2) of H x W."""
    import numpy as np

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    r = 127.5 + 127.5 * np.sin(xs * 0.004 + ys * 0.003)
    g = 127.5 + 127.5 * np.cos(ys * 0.005 - xs * 0.002) * np.cos(xs * 0.03)
    b = 127.5 + 127.5 * np.sin((xs + ys) * 0.0015) * np.cos(ys * 0.02)
    return np.stack([b, g, r], -1).astype(np.uint8)


P42_CHECKED = (0, 19)  # the views whose cache is held to area_resize of the decoded JPEG
P42_ORI, P42_POSE_STRIDE = 1600, 8  # the marker twins' size, and every 8th of phase 30's 100 poses


def phase42_jpeg(dev, tmp):
    """Phase 42 (the module docstring)."""
    import cv2
    import numpy as np

    from swnerf_torch.data.llff import load_llff_data
    from swnerf_torch.data.synthetic import write_llff_scene
    from swnerf_torch.pipelines import transform_mesh as tm
    from swnerf_torch.utils.images import area_resize, list_images, read_images

    t_phase = time.perf_counter()
    root = tmp / "p42_fern"
    write_llff_scene(str(root), n_images=P42_VIEWS, size=8, n_samples=8, device=dev)  # the poses
    shutil.rmtree(root / "images")
    shutil.rmtree(root / "images_1")
    (root / "images").mkdir()
    base = _pattern(P42_H, P42_W)
    t0 = time.perf_counter()
    for k in range(P42_VIEWS):
        ok, buf = cv2.imencode(".jpg", np.roll(base, 97 * k, axis=1), [cv2.IMWRITE_JPEG_QUALITY, 95])
        if not ok:
            fail("42: cv2.imencode could not write a JPEG")
        buf.tofile(str(root / "images" / f"IMG_{k:04d}.JPG"))
    write_s = time.perf_counter() - t0
    del base
    size = sum(p.stat().st_size for p in (root / "images").iterdir())
    t0 = time.perf_counter()
    imgs = load_llff_data(str(root), factor=P42_FACTOR)[0]
    load_s = time.perf_counter() - t0
    cache = read_images(list_images(str(root / f"images_{P42_FACTOR}")))
    srcs = list_images(str(root / "images"))
    t0 = time.perf_counter()
    decoded = read_images([srcs[k] for k in P42_CHECKED])
    decode_s = (time.perf_counter() - t0) / len(P42_CHECKED)
    size2 = (P42_W // P42_FACTOR, P42_H // P42_FACTOR)
    same = [np.array_equal(cache[k], area_resize(img, size2)) for k, img in zip(P42_CHECKED, decoded)]
    print(f"[42 fern JPEG] {P42_VIEWS} views of {P42_W} x {P42_H} written by cv2.imencode (quality 95, "
          f"{size / 2**20:.1f} MiB) in {write_s:.2f} s; load_llff_data(factor={P42_FACTOR}), the minify included, "
          f"{load_s:.2f} s (host clock, warm file cache) -> images {tuple(imgs.shape)}; one JPEG's decode alone "
          f"{decode_s:.3f} s; the images_{P42_FACTOR}/ PNG cache of views {list(P42_CHECKED)} = area_resize of the "
          f"decoded JPEG: {same}")
    if imgs.shape != (P42_VIEWS, P42_H // P42_FACTOR, P42_W // P42_FACTOR, 3) or not all(same):
        fail("42: the JPEG capture's factor-8 images are not the area resize of its decoded views")
    del imgs, cache, decoded

    # -- JPEG images_ori marker twins (phase 30's geometry) through detect_marker_corners
    if not hasattr(cv2, "aruco"):
        fail(f"42: cv2 {cv2.__version__} has no aruco module: the marker detection cannot run")
    cap = tmp / "p42_marker"
    (cap / "images_ori").mkdir(parents=True)
    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = P42_ORI  # the twins at 4 x the scene's 400 x 400, as images_ori/ holds the originals
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    e, msize = 0.5, 240
    world = np.array([[-e / 2, e / 2, 0.0], [e / 2, e / 2, 0.0], [e / 2, -e / 2, 0.0], [-e / 2, -e / 2, 0.0]])
    marker = cv2.aruco.generateImageMarker(cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_1000), 7, msize)
    src = np.array([[0, 0], [msize - 1, 0], [msize - 1, msize - 1], [0, msize - 1]], np.float32)
    flip = np.diag([1.0, -1.0, -1.0])
    frames = []
    for k, fr in enumerate(meta["frames"][::P42_POSE_STRIDE]):
        c2w_gl = np.array(fr["transform_matrix"], np.float64)
        R, t = c2w_gl[:3, :3] @ flip, c2w_gl[:3, 3]
        cam = (world - t) @ R
        if (cam[:, 2] <= 1e-6).any():
            continue
        px = focal * cam[:, :2] / cam[:, 2:] + np.array([W / 2.0, H / 2.0])
        if px.min() < 32 or px.max() > W - 32:
            continue
        Hm, _ = cv2.findHomography(src, px.astype(np.float32))
        canvas = cv2.warpPerspective(marker, Hm, (W, H), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                                     borderValue=255)
        ok, buf = cv2.imencode(".jpg", canvas, [cv2.IMWRITE_JPEG_QUALITY, 95])
        buf.tofile(str(cap / "images_ori" / f"r_{k}.jpg"))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        frames.append({"file_path": f"images/r_{k}.jpg", "transform_matrix": c2w.tolist()})
    (cap / "transforms.json").write_text(json.dumps({"fl_x": focal, "fl_y": focal, "cx": W / 2.0, "cy": H / 2.0,
                                                     "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "frames": frames}))
    real = 0.05
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        scale, _ = tm.cal_scale(str(cap), real, "c2w")  # detect_marker_corners, then the solve
    solve_ms = 1e3 * (time.perf_counter() - t0)
    found = log.getvalue().splitlines()[0]  # "find ID: 7, in total N frames"
    rel = abs(scale - real / e) / (real / e)
    print(f"[42 marker] cv2 {cv2.__version__} with aruco on {len(frames)} JPEG images_ori twins ({W} x {H}, "
          f"quality 95): {found}; scale {scale:.6f} (want {real / e}: rel {rel:.2e}, bar 0.02); detection + solve "
          f"{solve_ms:.1f} ms")
    if not found.startswith("find ID: 7,") or rel > 0.02:
        fail("42: the marker twins in JPEG did not give the scale within 2%")
    print(f"[42 done] phase 42 in {time.perf_counter() - t_phase:.1f} s")


def phase43_pos2d(dev, tmp):
    """Phase 43 (the module docstring)."""
    import cv2

    from swnerf_torch.experiments import pos2d

    t_phase = time.perf_counter()
    pic = tmp / "p43_picture.jpg"
    ok, buf = cv2.imencode(".jpg", _pattern(2048, 2048)[::8, ::8], [cv2.IMWRITE_JPEG_QUALITY, 95])
    buf.tofile(str(pic))
    out, ck = tmp / "p43" / "result", tmp / "p43" / "ckpt"
    metrics = pos2d.main(["-pd", str(pic), "--L", "10", "--layer_num", "4", "--epochs", str(P43_EPOCHS), "-od", str(out),
                          "-cs", str(ck), "--device", dev.type])
    secs = metrics["seconds"]
    rows = (tmp / "p43" / "metrics.csv").read_text().strip().splitlines()
    print(f"[43 pos2d] a 256 x 256 JPEG, L 10, 4 layers, {P43_EPOCHS} epochs of 128 steps on the card: gray PSNR "
          f"{[round(p, 3) for p in metrics['PSNR']]}; s per epoch {[round(s, 4) for s in secs]} (median after the "
          f"first {statistics.median(secs[1:]):.4f}); checkpoint {sorted(p.name for p in ck.iterdir())}, metrics.csv "
          f"{rows}, reconstructions {sorted(p.name for p in out.iterdir())}")
    if not metrics["PSNR"][-1] > metrics["PSNR"][0] or not list(ck.glob("*.npz")) or len(rows) != 1:
        fail("43: pos2d's PSNR did not rise, or its checkpoint or metrics.csv row is missing")
    print(f"[43 done] phase 43 in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- 44-45. data parallelism over ranks

P44_START, P44_STEPS, P44_EVERY, P44_SAVE = 10000, 80, 20, 60  # phase 44: from 10000, 80 steps, print 20, save 60
P44_ORDER = ("none", "nccl")  # the runs, once each: no group, then a one-rank NCCL world
P45_VANILLA_STEPS, P45_STEPS = 20, 5  # phase 45: the vanilla run's steps, the other trainers'
# phase 45's tensor-parallel legs: each trainer's steps (a divisor of 10000
# and 800000, so the last is a save), the vanilla and D-NeRF legs' rays a
# step (gloo carries each row layer's activations through host memory) and
# the fp32 step's
P45_TP_STEPS, P45_TP_RAYS, P45_TP_STEP_RAYS = 2, 128, 256
P45_KERNELS = {  # the launch keys (prefixes) each of phase 45's runs must count
    "vanilla": ("render_loss[S=64]", "render_loss[S=192]", "sample_pdf"),
    "render": ("render_pass[S=64]", "render_pass[S=192]", "sample_pdf"),
    "tnerf": ("render_loss[tnerf",),
    "dnerf": ("time_net", "time_net[bwd]", "render_pass[pts", "render_loss[pts", "sample_pdf"),
    "multires": ("time_net", "time_net[bwd]", "render_pass[pts,wide", "render_loss[ext,wide", "render_loss[ext,S"),
    # the tensor-parallel legs: the eager step's B2 where there is a fine
    # pass, the --render_only legs' eval passes
    "tp_vanilla": ("sample_pdf",),
    "tp_w512": ("sample_pdf",),
    "tp_render": ("render_pass[S=64]", "render_pass[S=192]", "sample_pdf"),
    "tp_tnerf": (),
    "tp_tnerf_render": ("render_pass[tnerf",),
    "tp_dnerf": ("sample_pdf",),
    "tp_dnerf_render": ("time_net", "render_pass[pts", "sample_pdf"),
    "tp_multires": (),
}


@contextlib.contextmanager
def recorded_frames():
    """Every frame ``render_path`` renders (``pipelines.common``'s
    ``render_image``), its rgb kept on the host, in the list the block gets."""
    import swnerf_torch.pipelines.common as common

    frames, render_image = [], common.render_image

    def recording(*a, **kw):
        out = render_image(*a, **kw)
        frames.append(out["rgb"].detach().cpu())
        return out

    common.render_image = recording
    try:
        yield frames
    finally:
        common.render_image = render_image


def _run_child(spec, envs, log, timeout):
    """``chip_smoke.py --rank-child <spec>`` in one process under ``envs``;
    its output to ``log``. Fails on a non-zero exit."""
    spec_path = Path(str(log) + ".json")
    spec_path.write_text(json.dumps(spec))
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--rank-child", str(spec_path)],
                            env=dict(os.environ, **envs), stdout=f, stderr=subprocess.STDOUT, timeout=timeout).returncode
    if rc != 0:
        print(Path(log).read_text()[-6000:])
        fail(f"{spec['task']} child exited {rc}")


def _digest(states) -> str:
    """sha256 of the states' parameters, in order (the ranks' replicas)."""
    import hashlib

    h = hashlib.sha256()
    for st in states if isinstance(states, (list, tuple)) else [states]:
        for m in st.modules():
            for p in m.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def p44_child(spec):
    """Phase 44's run (in its own process): run_nerf resumed from
    010000.tar for P44_STEPS bf16 steps at K = 20, with window_timer's
    windows; every all_reduce call recorded with whether a CUDA graph was
    being captured, and the kernels the device ran under torch.profiler."""
    import torch
    import torch.distributed as dist

    from swnerf_torch.pipelines import run_nerf

    calls, all_reduce = [], dist.all_reduce

    def recording(*a, **kw):
        calls.append(torch.cuda.is_current_stream_capturing())
        return all_reduce(*a, **kw)

    dist.all_reduce = recording
    timer, win = window_timer(run_nerf, P44_START, P44_EVERY)
    run_nerf.StepTimer = timer
    argv = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", spec["basedir"], "--datadir", str(DATADIR),
            "--device", "cuda", "--i_print", str(P44_EVERY), "--i_weights", str(P44_SAVE)]
    res, out, counts, wall = _cli(run_nerf.main, argv, {"SWNERF_MAX_ITERS": str(P44_START + P44_STEPS + 1)})
    avg = win["prof"].key_averages()
    device = {e.key: _device_us(e) for e in avg if str(e.device_type).endswith("CUDA")}
    quiet = {i: ms for i, ms in res["step_ms"].items()
             if i % P44_EVERY and (i - 1) % P44_EVERY and i <= P44_START + 2 * P44_EVERY}
    lines = out.splitlines()
    Path(spec["out"]).write_text(json.dumps(dict(
        counts=counts, med=statistics.median(quiet.values()), host_us=win["host_us"], busy=win["busy"],
        pwall=win["pwall"], nccl={k: v for k, v in device.items() if "nccl" in k.lower()},
        nccl_cpu=[e.key for e in avg if "nccl" in e.key.lower() and not str(e.device_type).endswith("CUDA")],
        calls=calls, wall=wall, captured=[ln for ln in lines if ln.startswith("Captured")],
        sharding=[ln for ln in lines if ln.startswith("Data parallelism")], metrics=res["metrics"])))


def phase44_nccl(tmp):
    """Phase 44 (the module docstring). Returns the NCCL runs' launch
    counts (the first)."""
    import torch

    from swnerf_torch.train.checkpoint import load_tar

    t_phase = time.perf_counter()
    runs = []
    for j, tag in enumerate(P44_ORDER):
        base = tmp / f"p44_{j}_{tag}"
        envs = {"SWNERF_STEPS_PER_DISPATCH": "20"}
        if tag == "nccl":  # a one-rank world: initialize_from_env joins it over NCCL
            envs.update(SWNERF_COORDINATOR=f"file://{tmp}/p44_store_{j}", SWNERF_NUM_PROCESSES="1",
                        SWNERF_PROCESS_ID="0")
        _run_child({"task": "p44", "basedir": str(base), "out": str(base) + ".out.json"}, envs,
                   str(base) + ".log", 300)
        r = json.loads(Path(str(base) + ".out.json").read_text())
        r["tag"], r["exp"] = tag, base / "full_nerf_200k"
        runs.append(r)
    last = f"{P44_START + P44_STEPS:06d}.tar"
    ref = runs[0]
    ref_tar = load_tar(str(ref["exp"] / last))
    for r in runs:
        tar = load_tar(str(r["exp"] / last))
        tensors = dict(_flat_tensors(tar))
        same_tar = tensors.keys() == dict(_flat_tensors(ref_tar)).keys() and all(
            torch.equal(v, dict(_flat_tensors(ref_tar))[k]) for k, v in tensors.items())
        same = dict(checkpoint=same_tar, metrics_jsonl=clock_free_records(r["exp"]) == clock_free_records(ref["exp"]),
                    launches=r["counts"] == ref["counts"], last_metrics=r["metrics"] == ref["metrics"])
        idle = 100 * (1 - r["busy"] / r["pwall"]) if r["busy"] else float("nan")
        print(f"[44 {r['tag']}] {P44_STEPS} steps from {P44_START} at K=20: median {r['med']:.3f} ms per step (CUDA "
              f"events, steps 1-40 that neither start a chunk nor print), host {r['host_us']:.1f} us per step "
              f"(steps 21-40), idle share {idle:.1f}% (steps 41-60 under torch.profiler); against the first run: "
              + ", ".join(f"{k} {'equal' if v else 'DIFFER'}" for k, v in same.items()))
        print(f"[44 {r['tag']}] {r['sharding']} {r['captured']}; all_reduce calls (True: inside a capture) "
              f"{r['calls']}; NCCL kernels the device ran in steps 41-60 (replays): {r['nccl'] or 'none'}; NCCL "
              f"host events there: {sorted(set(r['nccl_cpu'])) or 'none'}")
        if not all(same.values()) or len(r["captured"]) != 1:
            fail(f"44 {r['tag']}: not bit-equal to the run with no group ({same}) or not one capture")
        for key in ("render_loss[S=64]", "render_loss[S=192]", "sample_pdf"):
            if r["counts"].get(key, 0) <= 0:
                fail(f"44 {r['tag']}: the run launched no {key}")
        if r["tag"] == "nccl" and (r["calls"] != [False, True] or not r["sharding"]):
            fail(f"44: the NCCL run's all_reduce calls {r['calls']} are not [warm-up step, the capture]")
        if r["tag"] == "none" and (r["calls"] or r["sharding"]):
            fail(f"44: the run with no group called all_reduce {r['calls']} or sharded {r['sharding']}")
    meds = {tag: [r["med"] for r in runs if r["tag"] == tag] for tag in ("none", "nccl")}
    host = {tag: [r["host_us"] for r in runs if r["tag"] == tag] for tag in ("none", "nccl")}
    print(f"[44 summary] ms per step: no group {meds['none']}, one-rank NCCL {meds['nccl']} (difference of the "
          f"means {statistics.mean(meds['nccl']) - statistics.mean(meds['none']):+.4f} ms); host us per step: "
          f"no group {[round(x, 1) for x in host['none']]}, NCCL {[round(x, 1) for x in host['nccl']]}")
    print(f"[44 done] phase 44 in {time.perf_counter() - t_phase:.1f} s")
    return next(r for r in runs if r["tag"] == "nccl")["counts"]


def _flat_tensors(x, prefix=""):
    import torch

    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _flat_tensors(v, f"{prefix}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _flat_tensors(v, f"{prefix}/{i}")


def p45_legs(base, data):
    """Phase 45's trainer runs: (name, CLI module, argv, env, the last
    checkpoint under ``base``)."""
    from swnerf_torch.pipelines import run_dnerf, run_multires, run_nerf, run_tnerf

    k1 = {"SWNERF_STEPS_PER_DISPATCH": "1"}
    every = ["--device", "cuda", "--basedir", str(base)]
    s = P45_STEPS
    return (
        ("vanilla", run_nerf, ["--config", str(CONFIG), "--ft_path", str(CKPT), "--datadir", str(DATADIR), *every,
                               "--i_print", "10", "--i_weights", str(P45_VANILLA_STEPS)],
         dict(k1, SWNERF_MAX_ITERS=str(P44_START + P45_VANILLA_STEPS + 1)),
         f"full_nerf_200k/{P44_START + P45_VANILLA_STEPS:06d}.tar"),
        ("render", run_nerf, ["--config", str(CONFIG), "--ft_path", str(CKPT), "--datadir", str(DATADIR), *every,
                              "--render_only", "--render_test", "--testskip", "25"], {}, None),
        ("tnerf", run_tnerf, ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--datadir", str(data),
                              *every, "--i_print", str(s), "--i_weights", str(s)],
         dict(k1, SWNERF_MAX_ITERS=str(800000 + s + 1)), f"full_tnerf_800k/{800000 + s:06d}.tar"),
        ("dnerf", run_dnerf, ["--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--datadir", str(data),
                              *every, "--i_print", str(s), "--i_weights", str(s)],
         dict(k1, SWNERF_MAX_ITERS=str(800000 + s + 1)), f"full_dnerf_800k/{800000 + s:06d}.tar"),
        # MultiRes: one fused phase-2 step with the global term from the
        # replicated start (phase 1 left out: its summation order would move
        # the deformation's last bits, which level 0's 2^19-frequency
        # encoding turns into gradients past the bar)
        ("multires", run_multires, ["--config", str(MULTIRES_CONFIG), "--datadir", str(data), *every,
                                    "--global_optimization_epoch", "1", "--i_testset", "100000", "--i_weights", "1",
                                    "--i_print", "1", *MR_NOISE],
         dict(SWNERF_PHASE1_ITERS="0", SWNERF_MAX_ITERS="2", SWNERF_FUSED_MULTIRES="1"), "lego/000001.tar"),
    )


def p45_tp_legs(base, data):
    """Phase 45's tensor-parallel runs: (name, CLI module, argv, env, the
    last checkpoint under ``base``). The training legs run the fp32 plain
    route (SWNERF_FUSED=0: the eager step, the plain fields, B2), which is
    the route tensor parallelism takes and the one the one-process
    references take; the --render_only legs render the loaded fields on
    the kernel route (the eval passes)."""
    from swnerf_torch.pipelines import run_dnerf, run_multires, run_nerf, run_tnerf

    plain = {"SWNERF_STEPS_PER_DISPATCH": "1", "SWNERF_FUSED": "0"}
    every = ["--device", "cuda", "--basedir", str(base)]
    s = P45_TP_STEPS
    saves = ["--i_print", str(s), "--i_weights", str(s), "--N_rand", str(P45_TP_RAYS)]
    few = ["--testskip", "200"]  # the vanilla scene's test and val splits: their first view
    return (
        ("tp_vanilla", run_nerf, ["--config", str(CONFIG), "--ft_path", str(CKPT), "--datadir", str(DATADIR), *every,
                                  *saves, *few], dict(plain, SWNERF_MAX_ITERS=str(P44_START + s + 1)),
         f"full_nerf_200k/{P44_START + s:06d}.tar"),
        ("tp_w512", run_nerf, ["--config", str(CONFIG), "--expname", "w512", "--netwidth", "512", "--netwidth_fine",
                               "512", "--no_reload", "--datadir", str(DATADIR), *every, *saves, *few, "--i_weights",
                               "1"], dict(plain, SWNERF_MAX_ITERS="2"), "w512/000001.tar"),
        ("tp_render", run_nerf, ["--config", str(CONFIG), "--ft_path", str(CKPT), "--datadir", str(DATADIR), *every,
                                 "--render_only", "--render_test", *few], {}, None),
        ("tp_tnerf", run_tnerf, ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--datadir", str(data),
                                 *every, *saves[:4]], dict(plain, SWNERF_MAX_ITERS=str(800000 + s + 1)),
         f"full_tnerf_800k/{800000 + s:06d}.tar"),
        ("tp_tnerf_render", run_tnerf, ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--datadir",
                                        str(data), *every, "--render_only", "--render_test", "--testskip", "25"], {},
         None),
        ("tp_dnerf", run_dnerf, ["--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--datadir", str(data),
                                 *every, *saves], dict(plain, SWNERF_MAX_ITERS=str(800000 + s + 1)),
         f"full_dnerf_800k/{800000 + s:06d}.tar"),
        ("tp_dnerf_render", run_dnerf, ["--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--datadir",
                                        str(data), *every, "--render_only", "--render_test", "--testskip", "25"], {},
         None),
        ("tp_multires", run_multires, ["--config", str(MULTIRES_CONFIG), "--datadir", str(data), *every,
                                       "--global_optimization_epoch", "1", "--i_testset", "100000", "--i_weights", "1",
                                       "--i_print", "1", *MR_NOISE],
         dict(plain, SWNERF_PHASE1_ITERS="0", SWNERF_MAX_ITERS="2"), "lego/000001.tar"),
    )


def p45_tp_step(dev, tp, f64=False):
    """One eager step (the plain fields, B2) at full width on
    P45_TP_STEP_RAYS seeded pixels of train view r_0 from 010000.tar,
    jitter and noise on, the draws of one seeded generator: with ``tp`` on
    the shards of a (rays 1, model 2) grid, else in one process; with
    ``f64`` in float64 on the CPU (check_fp32_grads's reference). Returns (metrics, whole gradients on
    the host, B2 launches, this rank's replicated parameters' digest or
    None)."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.parallel import tensor as T
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.loop import make_train_step

    cfg, coarse, fine = load_models(dev)
    rays, target = train_view_rays(dev, P45_TP_STEP_RAYS, seed=2)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    draws = make_draws(rcfg, P45_TP_STEP_RAYS, torch.Generator(device=dev).manual_seed(3), dev)
    if f64:
        cpu64 = lambda x: None if x is None else x.detach().cpu().double()  # noqa: E731
        rays, target, draws = Rays(*(cpu64(x) for x in rays)), cpu64(target), Draws(*(cpu64(x) for x in draws))
        state = _fresh_state(cfg, coarse, fine, "cpu", torch.float64)
    else:
        state = _fresh_state(cfg, coarse, fine, dev)
    group = mesh = None
    if tp:
        mesh, _, state = T.tensor_parallel_setup(state, P45_TP_STEP_RAYS, 2, quiet=True)
        group = mesh.rays
    launches.clear()
    m = make_train_step(rcfg, group=group)(state, rays, target, draws=draws)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    b2 = launches.get("sample_pdf", 0)
    if mesh is None:
        grads, digest = _grads(state), None
    else:
        grads = T.gathered(mesh.model, {"coarse": state.coarse, "fine": state.fine}, grads=True)
        digest = _replicated_digest(state)
    out = {k: float(v) for k, v in m.items()}, {k: g.cpu() for k, g in grads.items()}, b2, digest
    del state, coarse, fine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def grid_sums(n_model=2):
    """One process summing every cut layer's products as a (rays 1, model
    ``n_model``) grid does: a column layer as ``n_model`` products of its
    output slices side by side, a row layer as the sum of ``n_model``
    partial products over its input slices and then its bias. The layers
    are those of the states given to the block's ``register``, or to
    ``replicate`` (which every trainer calls on its fields once built).
    Phase 45's control: MultiRes's level 0 encodes positions at 2^19
    frequencies, so in fp32 any other order of the sums parts its
    gradients by ~1e-1."""
    import torch

    from swnerf_torch.models import common
    from swnerf_torch.parallel import tensor as T

    kinds, linear, replicate = {}, common.linear, T.replicate

    def register(states):
        for st in states if isinstance(states, (list, tuple)) else [states]:
            for field in (f for f in (st.coarse, st.fine) if f is not None):
                kinds.update((id(field.get_submodule(n).weight), k) for n, k in T.mlp_param_specs(field, n_model).items())

    def grid_linear(x, w, b, half=False):
        kind = kinds.get(id(w))
        if kind == T.COLUMN:
            return torch.cat([linear(x, wm.contiguous(), bm.contiguous(), half)
                              for wm, bm in zip(w.chunk(n_model, 0), b.chunk(n_model, 0))], -1)
        if kind == T.ROW:
            parts = [linear(xm.contiguous(), wm.contiguous(), None, half)
                     for xm, wm in zip(x.chunk(n_model, -1), w.chunk(n_model, 1))]
            return functools.reduce(torch.add, parts) + b
        return linear(x, w, b, half)

    def replicating(group, states):
        register(states)
        return replicate(group, states)

    common.linear, T.replicate = grid_linear, replicating
    try:
        yield register
    finally:
        common.linear, T.replicate = linear, replicate


def p45_tp_mr_step(dev, scene, tp, dtype=None, control=False):
    """MultiRes's joint step (the field route, the global term on) at the
    config's full width on phase 33's inputs and weights (mr_phase2_inputs,
    mr_phase2_models) in ``dtype`` (fp32 by default): with ``tp`` every
    level cut over a (rays 1, model 2) grid, else in one process, with
    ``control`` under grid_sums. Returns (metrics, each level's whole
    gradients on the host)."""
    import torch

    from swnerf_torch.parallel import tensor as T
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.render.core import Draws
    from swnerf_torch.train.loop import init_train_state

    dtype = dtype or torch.float32
    rcfg, patch_sizes, pixels, targets, full, pose, t, draws = mr_phase2_inputs(dev, scene)
    states = [init_train_state(m, None, 5e-4, 250) for m in mr_phase2_models(dev, False, dtype)]
    mesh = group = None
    if tp:
        mesh, _, states = T.tensor_parallel_setup_multires(states, min(patch_sizes) ** 2, 2, quiet=True)
        group = mesh.rays
    pyr_hwf = [[scene.H // 2**l, scene.W // 2**l, scene.focal / 2**l] for l in range(len(patch_sizes))]
    cast = lambda x: x.to(dtype)  # noqa: E731
    fn = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far, fused=False, group=group)
    with grid_sums() if control else contextlib.nullcontext(lambda states: None) as register:
        register(states)
        m = fn(states, pixels, [cast(x) for x in targets], cast(full), cast(pose), t, 1.0,
               draws=[Draws(cast(d.t_rand), cast(d.noise0), None, None) for d in draws])
    if mesh is None:
        grads = [{k: p.grad.detach().cpu() for k, p in st.coarse.named_parameters()} for st in states]
    else:
        grads = [{k: g.cpu() for k, g in T.gathered(mesh.model, {"": st.coarse}, grads=True).items()}
                 for st in states]
    out = {k: float(v) for k, v in m.items()}, grads
    del states
    torch.cuda.empty_cache()
    return out


def p45_gathered_frame(dev, base, data):
    """run_nerf's --render_only of tp_render's checkpoint (010000.tar) from
    fields cut over a (rays 1, model 2) grid and gathered again
    (``render_fields``: the trainers' test renders under tensor
    parallelism), the frames' chunks shared over the world. Returns test
    frame 0 on the host."""
    from swnerf_torch.parallel import tensor as T
    from swnerf_torch.pipelines import run_nerf
    from swnerf_torch.pipelines.common import load_scene

    (_, _, argv, _, _), = [leg for leg in p45_tp_legs(base, data) if leg[0] == "tp_render"]
    args = run_nerf.config_parser().parse_args(argv)
    state, rcfg, eval_pass, _ = run_nerf.create_vanilla(args, dev, fused=False)
    mesh, _, state = T.tensor_parallel_setup(state, 0, 2, quiet=True)
    with recorded_frames() as frames:
        run_nerf.render_only(*T.render_fields(mesh, state), load_scene(args), rcfg, args, state.step,
                             eval_pass=eval_pass, group=mesh.world)
    return frames[0]


def p45_mr_scene(data):
    """The MultiRes scene phase 45's direct steps read (the config's)."""
    from swnerf_torch.pipelines.common import load_scene

    args = mr_args("--datadir", str(data))
    args.dataset_type = "blender_dnerf"
    return load_scene(args)


@contextlib.contextmanager
def captured(name, into):
    """``parallel/tensor.py``'s ``name`` (``replicate``,
    ``tensor_parallel_setup``, ...), which the trainers reach through
    ``parallel_setup``, with each call's (arguments, result) appended to
    ``into``."""
    from swnerf_torch.parallel import tensor as T

    fn = getattr(T, name)

    def call(*a, **kw):
        into.append((a, fn(*a, **kw)))
        return into[-1][1]

    setattr(T, name, call)
    try:
        yield
    finally:
        setattr(T, name, fn)


def _replicated_digest(states) -> str:
    """sha256 of the replicated (whole) parameters a tensor-parallel rank
    holds, in order: the same bits on every model rank."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for st in states if isinstance(states, (list, tuple)) else [states]:
        for m in st.modules():
            for name, p in m.named_parameters():
                if isinstance(m.get_submodule(name.rpartition(".")[0]), torch.nn.Linear):
                    h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def p45_vanilla_step(dev, group):
    """One fp32 kernel step (B1, B2) at full width on 1,024 seeded pixels
    of train view r_0 from 010000.tar, jitter and noise on, its draws from
    one seeded generator: this rank's rows with ``group``, the whole batch
    without. Returns (metrics, gradients) on the host."""
    import torch

    from swnerf_torch.render.core import RenderConfig
    from swnerf_torch.train.fused_step import make_fused_train_step

    cfg, coarse, fine = load_models(dev)
    rays, target = train_view_rays(dev, 1024, seed=2)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    state = _fresh_state(cfg, coarse, fine, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    m = make_fused_train_step(cfg, rcfg, fcfg=cfg, compute_dtype=torch.float32, group=group)(state, rays, target, gen)
    torch.cuda.synchronize()
    out = {k: float(v) for k, v in m.items()}, {k: g.cpu() for k, g in _grads(state).items()}
    del state, coarse, fine
    torch.cuda.empty_cache()
    return out


def p45_child(spec):
    """A rank of phase 45: bring its own gloo group (the file store of
    ``parallel/dryrun.py::launch``) on the one card, then the fp32 step and
    every trainer run of p45_legs, each with its launch counts, the digest
    of this rank's parameters after it and the frames it rendered."""
    import datetime

    import torch
    import torch.distributed as dist

    from swnerf_torch.parallel import make_mesh

    rank = int(os.environ["SWNERF_PROCESS_ID"])
    dist.init_process_group("gloo", init_method=os.environ["SWNERF_COORDINATOR"], rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    out = {"step": p45_vanilla_step(dev, make_mesh())}
    for name, module, argv, envs, _ in p45_legs(Path(spec["base"]) / f"rank{rank}", spec["data"]):
        calls = []
        with captured("replicate", calls), recorded_frames() as frames:
            res, log, counts, wall = _cli(module.main, argv, envs)
        step_ms = res.get("step_ms") if isinstance(res, dict) else None
        out[name] = dict(counts=counts, wall=wall, digest=_digest(calls[-1][0][1]), frames=frames[:1],
                         sharding=[ln for ln in log.splitlines() if ln.startswith("Data parallelism")],
                         med=statistics.median(list(step_ms.values())[1:]) if step_ms else None)
        dist.barrier()
    from swnerf_torch.parallel import tensor as T

    t0 = time.perf_counter()
    out["tp_step"] = p45_tp_step(dev, True)
    out["tp_step_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    scene = p45_mr_scene(spec["data"])
    out["tp_mr_step"] = {str(dt): p45_tp_mr_step(dev, scene, True, dt) for dt in (torch.float32, torch.float64)}
    out["tp_mr_step_s"] = time.perf_counter() - t1
    del scene
    out["tp_gathered_frame"] = p45_gathered_frame(dev, Path(spec["base"]) / f"tp_rank{rank}", spec["data"])
    for name, module, argv, envs, _ in p45_tp_legs(Path(spec["base"]) / f"tp_rank{rank}", spec["data"]):
        grids = []
        with captured("tensor_parallel_setup", grids), captured("tensor_parallel_setup_multires", grids), \
                recorded_frames() as frames:
            res, log, counts, wall = _cli(module.main, argv, dict(envs, SWNERF_TENSOR_PARALLEL="2"))
        step_ms = res.get("step_ms") if isinstance(res, dict) else None
        out[name] = dict(counts=counts, wall=wall, frames=frames[:1], rep_digest=None, bytes=None,
                         grid=[ln for ln in log.splitlines() if ln.startswith("Tensor parallelism")],
                         eager=any(line in log for line in ("eager autograd train step", "fused phase 2 on levels []")),
                         med=statistics.median(list(step_ms.values())[1:]) if step_ms and len(step_ms) > 1 else None)
        if grids:  # a training leg: the states it cut (a --render_only leg cuts nothing)
            _, specs, st = grids[-1][1]
            sts, specs = (st, specs) if isinstance(st, list) else ([st], [specs])
            out[name].update(rep_digest=_replicated_digest(sts), bytes=sum(T.local_bytes(x) for x in sts),
                             expected=sum(T.expected_local_bytes(p, x, 2) for p, x in zip(specs, sts)),
                             whole=sum(T.expected_local_bytes(p, x, 1) for p, x in zip(specs, sts)))
        dist.barrier()
    out["tp_wall"] = time.perf_counter() - t0
    torch.save(out, spec["out"].replace("RANK", str(rank)))


def torch_allclose(g, r, rtol, atol):
    return ((g.double() - r.double()).abs() <= atol + rtol * r.double().abs()).all().item()


def phase45_gloo(dev, tmp, data, frame0):
    """Phase 45 (the module docstring). Returns rank 0's launch counts by
    kernel, summed over its trainer runs."""
    import torch

    from swnerf_torch.parallel.dryrun import launch
    from swnerf_torch.train.checkpoint import load_tar

    t_phase = time.perf_counter()
    base = tmp / "p45"
    base.mkdir(parents=True, exist_ok=True)
    spec = base / "spec.json"
    out_tpl = str(base / "rankRANK.pt")
    spec.write_text(json.dumps({"task": "p45", "base": str(base), "data": str(data), "out": out_tpl}))
    t0 = time.perf_counter()
    logs = launch([sys.executable, str(ROOT / "chip_smoke.py"), "--rank-child", str(spec)], 2, str(base),
                  timeout=600, threads=4)
    world_s = time.perf_counter() - t0
    ranks = [torch.load(out_tpl.replace("RANK", str(r)), weights_only=False) for r in range(2)]
    print(f"[45 world] 2 gloo ranks on one card, every run in {world_s:.1f} s; rank 0's sharding lines "
          f"{sorted(set(ln for leg in ranks[0].values() if isinstance(leg, dict) and 'sharding' in leg for ln in leg['sharding']))}")
    # (a) the fp32 step against one process on the global batch
    m1, g1 = p45_vanilla_step(dev, None)
    for r, (m2, g2) in enumerate(x["step"] for x in ranks):
        dl = abs(m2["total_loss"] - m1["total_loss"]) / m1["total_loss"]
        errs = rel_l2(g2, g1)
        worst = max(errs, key=errs.get)
        print(f"[45 step fp32 rank {r}] total_loss {m2['total_loss']:.7f} vs one process {m1['total_loss']:.7f}: rel "
              f"{dl:.3e}; gradients rel L2 worst {worst} {errs[worst]:.3e}")
        if dl > 1e-5 or errs[worst] > 1e-4:
            fail(f"45: rank {r}'s fp32 step is not the one-process step (loss rel {dl}, gradient {errs[worst]})")
    # (b) the runs: the ranks' replicas bit-identical, the kernels launched
    for name in ("vanilla", "render", "tnerf", "dnerf", "multires"):
        a, b = ranks[0][name], ranks[1][name]
        med = f"; median ms per step after the first (CUDA events, rank 0) {a['med']:.3f}" if a["med"] else ""
        print(f"[45 {name}] launches (rank 0) {json.dumps(a['counts'], sort_keys=True)}; CLI wall {a['wall']:.2f} / "
              f"{b['wall']:.2f} s; the ranks' parameters {'bit-identical' if a['digest'] == b['digest'] else 'DIFFER'}"
              f"{med}")
        missing = [key for key in P45_KERNELS[name] if not any(c.startswith(key) for c in a["counts"])]
        if a["digest"] != b["digest"] or missing or len(a["sharding"]) != 1:
            fail(f"45 {name}: the ranks' parameters differ, or it launched no {missing}, or no sharding line")
    exp = base / "rank0" / "full_nerf_200k"
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(rec["step"], round(rec["psnr"], 3)) for rec in recs if "psnr" in rec]
    print(f"[45 vanilla] {P45_VANILLA_STEPS} bf16 steps at K = 1 over 2 gloo ranks: train PSNR at the prints {psnrs}")
    if len(psnrs) != 2 or min(p for _, p in psnrs) < 30.0:
        fail(f"45: train PSNR below 30 dB at a print (or not 2 prints): {psnrs}")
    if (base / "rank1").exists() and any(p.is_file() for p in (base / "rank1").rglob("*")):
        fail("45: rank 1 wrote files")
    for r in range(2):
        f = ranks[r]["render"]["frames"][0]
        print(f"[45 render rank {r}] test frame 0 over 2 ranks against phase 5's: torch.equal {torch.equal(f, frame0)}, "
              f"max |d| {(f - frame0).abs().max().item():.3e}")
        if not torch.equal(f, frame0):
            fail("45: the 2-rank frame 0 is not bit-equal to phase 5's")
    # (c) T-NeRF, D-NeRF and MultiRes against one process
    single = tmp / "p45_single"
    for name, module, argv, envs, ckpt in p45_legs(single, data):
        if name not in ("tnerf", "dnerf", "multires"):
            continue
        _cli(module.main, argv, envs)
        got, ref = dict(_flat_tensors(load_tar(str(base / "rank0" / ckpt)))), dict(_flat_tensors(load_tar(str(single / ckpt))))
        if got.keys() != ref.keys():
            fail(f"45 {name}: the checkpoints' tensors differ in name")
        dist = {k: (got[k].double() - v.double()).abs().max().item() for k, v in ref.items() if v.numel()}
        rel = {k: d / max(ref[k].double().abs().max().item(), 1e-30) for k, d in dist.items()}
        worst = max(rel, key=rel.get)
        bad = [k for k, v in ref.items() if not torch_allclose(got[k], v, 1e-5, 1e-6)]
        print(f"[45 {name}] over 2 ranks against one process, {ckpt}: {len(bad)} of {len(ref)} tensors outside rtol "
              f"1e-5, atol 1e-6 {bad[:6]}; max |d| {max(dist.values()):.3e}, worst relative {worst} {rel[worst]:.3e}")
        if name == "multires":
            # One Adam update from the replicated start: a weight moves by
            # lr * g / (|g| + eps), which any summation order moves by up to
            # lr where |g| is near eps, so the moments (the gradients' own
            # record) decide; the weights are printed above
            bad = [k for k in bad if "/state/" in k]
        if bad:
            fail(f"45 {name}: the 2-rank run is not the one-process run within the bar")
    phase45_tp(dev, tmp, data, frame0, base, ranks)
    print(f"[45 done] phase 45 in {time.perf_counter() - t_phase:.1f} s")
    counts = collections.Counter()
    for leg in ranks[0].values():
        if isinstance(leg, dict) and "counts" in leg:
            counts.update(leg["counts"])
    return dict(counts)


def _within(got, ref, rtol, atol):
    """Tensors of ``ref`` (``_flat_tensors`` keys) outside the bar, and the
    largest distance."""
    bad = [k for k, v in ref.items() if not torch_allclose(got[k], v, rtol, atol)]
    worst = max(((got[k].double() - v.double()).abs().max().item() for k, v in ref.items() if v.numel()), default=0.0)
    return bad, worst


def phase45_tp(dev, tmp, data, frame0, base, ranks):
    """Phase 45's tensor-parallel legs (the module docstring), read from the
    ranks' results against one process here."""
    import torch

    from swnerf_torch.parallel import tensor as T
    from swnerf_torch.train.checkpoint import load_tar

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    # (a) the fp32 eager step on the shards against one process: the loss
    # rel 1e-5, the gathered gradients at check_fp32_grads's bar (the row
    # layers' partial sums are another summation order, which can flip a
    # ReLU mask where a pre-activation sits within fp32 rounding of 0)
    t_step = time.perf_counter()
    m1, g1, b2_1, _ = p45_tp_step(dev, False)
    _, g64, _, _ = p45_tp_step(dev, False, f64=True)
    print(f"[45 tp step] the one-process fp32 and float64 references in {time.perf_counter() - t_step:.1f} s")
    for r, x in enumerate(ranks):
        m2, g2, b2, _ = x["tp_step"]
        dl = abs(m2["total_loss"] - m1["total_loss"]) / m1["total_loss"]
        print(f"[45 tp step fp32 rank {r}] total_loss {m2['total_loss']:.7f} vs one process {m1['total_loss']:.7f}: "
              f"rel {dl:.3e}; B2 launches {b2} (one process {b2_1}); the rank's step with its set-up "
              f"{x['tp_step_s']:.1f} s")
        if dl > 1e-5 or b2 <= 0 or g2.keys() != g1.keys():
            fail(f"45 tp: rank {r}'s fp32 step is not the one-process step (loss rel {dl}, B2 launches {b2})")
        check_fp32_grads(f"45 tp step fp32 rank {r}", g2, g1, g64)
    if ranks[0]["tp_step"][3] != ranks[1]["tp_step"][3]:
        fail("45 tp: the replicated parameters differ between the model ranks after the fp32 step")
    # MultiRes's joint step, every level cut: in float64 against one
    # process, in fp32 against one process summing as the grid does
    # (grid_sums); either fails on a wrong gradient of any level
    t_step = time.perf_counter()
    scene = p45_mr_scene(data)
    one = {str(dt): p45_tp_mr_step(dev, scene, False, dt) for dt in (torch.float32, torch.float64)}
    ctl_m, ctl_g = p45_tp_mr_step(dev, scene, False, control=True)
    del scene
    print(f"[45 tp multires step] one process's fp32 and float64 steps and the grid-sums control in "
          f"{time.perf_counter() - t_step:.1f} s")
    worst = lambda got, ref: [max(rel_l2(g, w).values()) for g, w in zip(got, ref)]  # noqa: E731
    fmt = lambda errs: [f"{e:.3e}" for e in errs]  # noqa: E731
    for r, x in enumerate(ranks):
        (m64, g64), (m32, g32) = x["tp_mr_step"]["torch.float64"], x["tp_mr_step"]["torch.float32"]
        l64 = abs(m64["total_loss"] - one["torch.float64"][0]["total_loss"]) / one["torch.float64"][0]["total_loss"]
        l32 = abs(m32["total_loss"] - ctl_m["total_loss"]) / ctl_m["total_loss"]
        e64, e32 = worst(g64, one["torch.float64"][1]), worst(g32, ctl_g)
        print(f"[45 tp multires step rank {r}] float64 against one process: total_loss rel {l64:.3e}, each level's "
              f"worst gradient rel L2 {fmt(e64)} (bar 1e-8); fp32 against the grid-sums control: total_loss rel "
              f"{l32:.3e} (bar 1e-5), each level's worst {fmt(e32)} (bar 1e-5); fp32 against one process (read): "
              f"{fmt(worst(g32, one['torch.float32'][1]))}, the control's {fmt(worst(ctl_g, one['torch.float32'][1]))}; "
              f"the rank's steps with their set-up {x['tp_mr_step_s']:.1f} s")
        if l64 > 1e-10 or max(e64) > 1e-8 or l32 > 1e-5 or max(e32) > 1e-5:
            fail(f"45 tp: rank {r}'s MultiRes joint step over the grid is not one process's")
    # (b) the trainers under SWNERF_TENSOR_PARALLEL=2 against one process
    single = tmp / "p45_tp_single"
    for name, module, argv, envs, ckpt in p45_tp_legs(single, data):
        a, b = ranks[0][name], ranks[1][name]
        train = ckpt is not None
        med = f"; median ms per step after the first (CUDA events, rank 0) {a['med']:.3f}" if a["med"] else ""
        held = (f"; replicated parameters {'bit-identical' if a['rep_digest'] == b['rep_digest'] else 'DIFFER'}; "
                f"parameter + Adam bytes a rank holds {a['bytes']} / {b['bytes']} (by the assignment {a['expected']}, "
                f"whole {a['whole']})") if train else " (render only: nothing cut)"
        print(f"[45 {name}] launches (rank 0) {json.dumps(a['counts'], sort_keys=True)}; CLI wall {a['wall']:.2f} / "
              f"{b['wall']:.2f} s; {a['grid']}{held}{med}; {smi}")
        missing = [key for key in P45_KERNELS[name] if not any(c.startswith(key) for c in a["counts"])]
        if (a["rep_digest"] != b["rep_digest"] or missing or len(a["grid"]) != 1
                or (train and not (a["eager"] and a["bytes"] == a["expected"] == b["bytes"]))):
            fail(f"45 {name}: the replicated parameters differ, it launched no {missing}, no grid line, not the eager "
                 "step, or a rank holds other bytes than its shards'")
        if not train:  # test frame 0 over the 2 ranks against one process's
            ref = frame0
            if name != "tp_render":
                with recorded_frames() as frames:
                    _cli(module.main, argv, envs)
                ref = frames[0]
            shown = [(f"{name} rank {r}", "the loaded fields", ranks[r][name]["frames"][0]) for r in range(2)]
            if name == "tp_render":
                shown += [(f"tp gathered rank {r}", "fields cut and gathered (render_fields)",
                           ranks[r]["tp_gathered_frame"]) for r in range(2)]
            for tag, what, f in shown:
                print(f"[45 {tag}] test frame 0 from {what} over 2 ranks against one process's"
                      f"{' (phase 5)' if name == 'tp_render' else ''}: torch.equal {torch.equal(f, ref)}, max |d| "
                      f"{(f - ref).abs().max().item():.3e}")
                if not torch.equal(f, ref):
                    fail(f"45 {tag}: the frame over 2 ranks is not bit-equal to one process's")
            continue
        calls = []
        t_leg = time.perf_counter()
        with captured("replicate", calls):
            _cli(module.main, argv, envs)
        st = calls[-1][0][1]
        one = sum(T.local_bytes(x) for x in (st if isinstance(st, list) else [st]))
        del calls, st
        got, ref = dict(_flat_tensors(load_tar(str(base / "tp_rank0" / ckpt)))), dict(_flat_tensors(load_tar(str(single / ckpt))))
        if got.keys() != ref.keys() or any(got[k].shape != v.shape for k, v in ref.items()):
            fail(f"45 {name}: the gathered checkpoint's tensors differ from one process's in name or shape")
        # phase 45's bar above, rtol 1e-5, atol 1e-6, is read; the holds are the JAX
        # tests' (tests/test_tensor_parallel.py:161-302): Adam normalises a
        # gradient entry near 0 (its second moment is near 0 even in a
        # resumed state), so the row layers' summation order moves such a
        # weight by up to the learning rate: atol 2e-4; MultiRes's weights
        # atol 6e-3 (printed; its moments decide, below)
        if name in ("tp_w512", "tp_multires"):
            # one Adam update from a shared start: each weight moves by
            # lr * g / (|g| + eps), so an entry near 0 moves by up to lr
            # either way and the weights against one process cannot show a
            # wrong gradient; the first moments (0.1 g) decide. W=512: rel
            # L2 1e-3 against one process (fp32 summation orders part by
            # 1.8e-4 where a ReLU mask flips, the step above). MultiRes
            # (level 0's 2^19 frequencies part any two fp32 orders by
            # ~1e-1): every tensor, weights and moments, rel L2 1e-5 against
            # the CLI run of one process summing as the grid does
            ctl = {}
            if name == "tp_multires":
                with grid_sums():
                    _cli(module.main, [a if a != str(single) else str(tmp / "p45_tp_control") for a in argv], envs)
                ctl = dict(_flat_tensors(load_tar(str(tmp / "p45_tp_control" / ckpt))))
                errs = rel_l2(got, ctl)
                off = {k: e for k, e in errs.items() if e > 1e-5}
                print(f"[45 {name}] every tensor against the grid-sums control's CLI run: worst rel L2 "
                      f"{max(errs.values()):.3e} ({max(errs, key=errs.get)}), {len(off)} of {len(errs)} past 1e-5")
                if off:
                    fail(f"45 {name}: the tensor-parallel step is not one process's summing as the grid does: {off}")
            opts = sorted({k.split("/")[1] for k in ref if k.startswith("/optimizer")})
            for opt in opts:
                for moment in ("exp_avg", "exp_avg_sq"):
                    keys = [k for k in ref if k.startswith(f"/{opt}/") and k.endswith(f"/{moment}")]
                    err = max(rel_l2({k: got[k] for k in keys}, {k: ref[k] for k in keys}).values())
                    held = moment == "exp_avg" and not ctl
                    moved = max(rel_l2({k: ctl[k] for k in keys}, {k: ref[k] for k in keys}).values()) if ctl else None
                    print(f"[45 {name}] {opt}'s {moment} against one process: worst rel L2 {err:.3e}"
                          + (f", the grid-sums control's {moved:.3e}" if ctl else "") + (" (bar 1e-3)" if held else " (read)"))
                    if held and err > 1e-3:
                        fail(f"45 {name}: {opt}'s first moments are not one process's")
        if name == "tp_w512":
            ref = {k: v for k, v in ref.items() if not k.startswith("/network_")}  # the moments, the counts
        if name == "tp_multires":
            ref = {k: v for k, v in ref.items() if k.startswith("/network_fn_")}
        tight, worst = _within(got, ref, 1e-5, 1e-6)
        atol = 2 * 6 * 5e-4 if name == "tp_multires" else 2e-4
        bad, _ = _within(got, ref, 0.0, atol)
        print(f"[45 {name}] gathered checkpoint {ckpt} against one process's: {len(tight)} of {len(ref)} tensors "
              f"outside rtol 1e-5, atol 1e-6 {tight[:6]}, {len(bad)} outside atol {atol:g}; max |d| {worst:.3e}; one "
              f"process holds {one} bytes of parameters + Adam, a rank {a['bytes']} ({a['bytes'] / one:.3f}); one "
              f"process's CLI wall {time.perf_counter() - t_leg:.2f} s")
        if bad:
            fail(f"45 {name}: the tensor-parallel run is not the one-process run within the bar")
        if name == "tp_multires":
            recs = [[json.loads(line) for line in (d / "lego" / "metrics.jsonl").read_text().splitlines()
                     if "global_loss" in line] for d in (base / "tp_rank0", single)]
            rel = abs(recs[0][0]["global_loss"] - recs[1][0]["global_loss"]) / recs[1][0]["global_loss"]
            print(f"[45 tp_multires] the joint step's global loss {recs[0][0]['global_loss']:.6f} vs one process "
                  f"{recs[1][0]['global_loss']:.6f}: rel {rel:.3e} (bar 2e-2)")
            if rel > 2e-2:
                fail("45 tp_multires: the joint step's loss is not one process's")
    if (base / "tp_rank1").exists() and any(p.is_file() for p in (base / "tp_rank1").rglob("*")):
        fail("45 tp: rank 1 wrote files")
    print(f"[45 tp done] the tensor-parallel legs in {ranks[0]['tp_wall']:.1f} s in the ranks and "
          f"{time.perf_counter() - t0:.1f} s here; {smi}")


def rank_child(spec_path) -> int:
    """``chip_smoke.py --rank-child <spec.json>``: one process of phase 44
    or 45."""
    import torch

    # main()'s settings: the one-process references run in main()'s process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    {"p44": p44_child, "p45": p45_child}[spec["task"]](spec)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-child":
        sys.exit(rank_child(sys.argv[2]))
    sys.exit(main())
